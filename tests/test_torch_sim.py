"""The port's simulator and word helpers against the JAX package.

``simulate_batched`` with its host cross-check must make the decisions
the reference's ``simulate_batched`` makes; the workload generator must
give the same jobs; the int32 word helpers must match numpy's uint32
arithmetic on edge words.  Exact equality.
"""

import numpy as np
import pytest
import torch

from repro.core import timeline as ref_tl
from repro.sim import WorkloadParams as RefParams
from repro.sim import generate as ref_generate
from repro.sim import simulate_batched as ref_simulate_batched
from repro_torch.core import words as pt_words
from repro_torch.core.batch import StreamStats
from repro_torch.core.types import Policy
from repro_torch.sim import WorkloadParams, generate, generate_filtered
from repro_torch.sim import simulate, simulate_batched

SMALL = dict(u_low=2.0, u_med=4.0, u_hi=6.0)
EDGE = np.array([0, 1, 2, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555,
                 0xAAAAAAAA, 0x00010000, 0xDEADBEEF, 1 << 31 | 1],
                dtype=np.uint32)


def test_generate_matches_reference():
    for kw in (dict(n_jobs=200, seed=3), dict(n_jobs=150, seed=9, **SMALL,
                                             arrival_factor=1.5)):
        fields = ("t_a", "t_r", "t_du", "t_dl", "n_pe", "demand")
        ours = [tuple(getattr(j, f) for f in fields)
                for j in generate(WorkloadParams(**kw))]
        theirs = [tuple(getattr(j, f) for f in fields)
                  for j in ref_generate(RefParams(**kw))]
        assert ours == theirs


@pytest.mark.parametrize("policy", [Policy.PE_W, Policy.PEDU_B])
def test_simulate_batched_matches_reference(policy):
    params = dict(n_jobs=250, n_pe=64, seed=3, **SMALL)
    jobs = generate_filtered(WorkloadParams(**params), max_pe=64)
    stats = StreamStats()
    ours = simulate_batched(jobs, 64, policy, capacity=16, cross_check=True,
                            device="cpu", stats=stats)
    ref_jobs = [j for j in ref_generate(RefParams(**params)) if j.n_pe <= 64]
    theirs = ref_simulate_batched(ref_jobs, 64, policy, capacity=16)
    assert ours.decisions == theirs.decisions
    assert ours.slowdowns == theirs.slowdowns
    assert ours.busy_area == theirs.busy_area
    assert 0.0 < ours.acceptance_rate < 1.0
    # one "anything due?" read per step and per release pass; per
    # attempt the batch and the overflow latch; per growth the two
    # high-water marks; at the end the decisions (two fields)
    attempts = stats.growths + 1
    assert stats.host_syncs == (stats.steps + stats.release_passes
                                + 2 * attempts + 2 * stats.growths + 2)


def test_device_engine_event_loop_matches_host():
    jobs = generate_filtered(WorkloadParams(n_jobs=60, n_pe=64, seed=2),
                             max_pe=64)
    a = simulate(jobs, 64, Policy.PE_W, engine="host", record_decisions=True)
    b = simulate(jobs, 64, Policy.PE_W, engine="device",
                 engine_kwargs={"capacity": 16}, record_decisions=True,
                 device="cpu")
    assert a.decisions == b.decisions
    assert a.slowdowns == b.slowdowns


def test_run_policies_matches_reference():
    from repro.core.types import ALL_POLICIES as REF_POLICIES
    from repro.sim import run_policies as ref_run_policies
    from repro_torch.core.types import ALL_POLICIES
    from repro_torch.sim import run_policies
    params = dict(n_jobs=120, n_pe=64, seed=4, **SMALL)
    jobs = generate_filtered(WorkloadParams(**params), max_pe=64)
    ref_jobs = [j for j in ref_generate(RefParams(**params)) if j.n_pe <= 64]
    ours = run_policies(jobs, 64, ALL_POLICIES, engine="host")
    theirs = ref_run_policies(ref_jobs, 64, REF_POLICIES)
    for a, b in zip(ours, theirs):
        assert (a.policy, a.n_accepted, a.slowdowns, a.busy_area) == (
            b.policy, b.n_accepted, b.slowdowns, b.busy_area)


def test_word_helpers_on_edge_words():
    x = torch.from_numpy(pt_words.to_int32(EDGE))
    assert x.dtype == torch.int32
    np.testing.assert_array_equal(pt_words.popcount(x).numpy(),
                                  np.bitwise_count(EDGE).astype(np.int32))
    for k in (0, 1, 7, 16, 31):
        np.testing.assert_array_equal(
            pt_words.to_uint32(pt_words.shr(x, k).numpy()), EDGE >> k)
    np.testing.assert_array_equal(
        pt_words.to_uint32((~x).numpy()), ~EDGE)
    rng = np.random.default_rng(0)
    for n in (1, 2, 5, 8, 13):
        rows = rng.integers(0, 2**32, (n, 3), dtype=np.uint64).astype(
            np.uint32)
        rows[0, 0] = 0xFFFFFFFF
        np.testing.assert_array_equal(
            pt_words.to_uint32(pt_words.or_reduce(
                torch.from_numpy(pt_words.to_int32(rows)), 0).numpy()),
            np.bitwise_or.reduce(rows, axis=0))
    assert pt_words.or_reduce(torch.zeros((0, 4), dtype=torch.int32),
                              0).tolist() == [0, 0, 0, 0]
    bits = rng.integers(0, 2, (3, 96)).astype(np.uint32)
    bits[0, 31] = bits[1, 63] = 1
    packed = pt_words.pack_bits(torch.from_numpy(bits.astype(np.int64)))
    want = np.asarray(ref_tl.pack_bits(bits))
    np.testing.assert_array_equal(pt_words.to_uint32(packed.numpy()), want)
    np.testing.assert_array_equal(
        pt_words.unpack_bits(packed, 90).numpy(),
        np.asarray(ref_tl.unpack_bits(want, 90)))
