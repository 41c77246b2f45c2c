"""The port's fused admission against the JAX package, bit for bit.

Whole streams through ``admit_stream_grow`` (with growth), a step with
more due releases than one release pass takes, and a state handed from
the JAX package to the port half-way through a stream.  Every
``Decision`` field and the final state must be equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import batch as ref_batch
from repro.core import timeline as ref_tl
from repro.core.types import ALL_POLICIES, ARRequest as RefRequest, Policy
from repro.sim import WorkloadParams, generate_filtered
from repro_torch.core import batch as pt_batch
from repro_torch.core import timeline as pt_tl
from repro_torch.core import words as pt_words
from repro_torch.core.types import ARRequest

N_PE = 64
SMALL = dict(u_low=2.0, u_med=4.0, u_hi=6.0)


def _jobs(n, seed):
    jobs = generate_filtered(WorkloadParams(n_jobs=n, n_pe=N_PE, seed=seed,
                                            **SMALL), max_pe=N_PE)
    return sorted(jobs, key=lambda j: j.t_a)


def _port_jobs(jobs):
    return [ARRequest(j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe) for j in jobs]


def ref_state_arrays(st):
    return dict(
        times=np.asarray(st.tl.times), occ=np.asarray(st.tl.occ),
        pend_ts=np.asarray(st.pend_ts), pend_te=np.asarray(st.pend_te),
        pend_mask=np.asarray(st.pend_mask),
        n_accepted=np.asarray(st.n_accepted),
        n_released=np.asarray(st.n_released),
        overflow=np.asarray(st.overflow),
        hw_records=np.asarray(st.hw_records),
        hw_pending=np.asarray(st.hw_pending))


def assert_state_equal(port_state, ref_state):
    got = pt_tl.state_to_numpy(port_state)
    want = ref_state_arrays(ref_state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def assert_decisions_equal(port_dec, ref_dec):
    for f in ref_batch.Decision._fields:
        got = getattr(port_dec, f).numpy()
        want = np.asarray(getattr(ref_dec, f))
        if f == "pe_mask":
            got = pt_words.to_uint32(got)
        np.testing.assert_array_equal(got, want, err_msg=f)


def _run_both(jobs, policy, capacity, pending, use_kernel=True):
    ref_state = ref_tl.init_state(capacity, N_PE, pending)
    ref_out, ref_dec = ref_batch.admit_stream_grow(
        ref_state, ref_batch.requests_to_batch(jobs), policy, n_pe=N_PE)
    stats = pt_batch.StreamStats()
    port_state = pt_tl.init_state(capacity, N_PE, pending, device="cpu")
    port_out, port_dec = pt_batch.admit_stream_grow(
        port_state, pt_batch.requests_to_batch(_port_jobs(jobs), "cpu"),
        policy, n_pe=N_PE, use_kernel=use_kernel, stats=stats)
    return (port_out, port_dec, stats), (ref_out, ref_dec)


@pytest.fixture(scope="module")
def stream():
    return _jobs(300, seed=5)


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_admit_stream_grow_matches_reference(stream, policy):
    (p_out, p_dec, stats), (r_out, r_dec) = _run_both(stream, policy, 8, 8)
    assert stats.growths >= 1                  # capacity 8 must grow
    assert p_out.tl.capacity == r_out.tl.capacity > 8
    assert (stats.capacity, stats.pending_capacity) == (
        p_out.tl.capacity, p_out.pending_capacity)
    assert_decisions_equal(p_dec, r_dec)
    assert_state_equal(p_out, r_out)


@pytest.mark.parametrize("policy", [Policy.PE_W, Policy.FF])
def test_plain_search_path_matches_reference(stream, policy):
    (p_out, p_dec, _), (r_out, r_dec) = _run_both(stream[:150], policy, 64,
                                                  64, use_kernel=False)
    assert_decisions_equal(p_dec, r_dec)
    assert_state_equal(p_out, r_out)


def test_step_with_more_due_releases_than_one_pass():
    # 12 one-PE reservations end at t=10; the job arriving at t=100
    # releases all of them first (two RELEASE_CHUNK passes)
    jobs = [RefRequest(t_a=0, t_r=0, t_du=10, t_dl=10, n_pe=1)
            for _ in range(12)]
    jobs.append(RefRequest(t_a=100, t_r=100, t_du=5, t_dl=105, n_pe=N_PE))
    (p_out, p_dec, stats), (r_out, r_dec) = _run_both(jobs, Policy.FF, 64,
                                                      16)
    assert stats.release_passes == 2
    assert int(p_out.n_released) == 12
    assert bool(p_dec.accepted[-1])
    assert_decisions_equal(p_dec, r_dec)
    assert_state_equal(p_out, r_out)


@pytest.mark.parametrize("policy", [Policy.PE_W, Policy.DU_B])
def test_state_carried_from_reference_mid_stream(stream, policy):
    first, second = stream[:150], stream[150:]
    ref_state = ref_tl.init_state(64, N_PE, 64)
    ref_half, _ = ref_batch.admit_stream_grow(
        ref_state, ref_batch.requests_to_batch(first), policy, n_pe=N_PE)
    arrays = ref_state_arrays(ref_half)
    port_half = pt_tl.state_from_numpy(arrays, device="cpu")
    assert_state_equal(port_half, ref_half)
    ref_end, r_dec = ref_batch.admit_stream_grow(
        ref_half, ref_batch.requests_to_batch(second), policy, n_pe=N_PE)
    port_end, p_dec = pt_batch.admit_stream_grow(
        port_half, pt_batch.requests_to_batch(_port_jobs(second), "cpu"),
        policy, n_pe=N_PE)
    assert_decisions_equal(p_dec, r_dec)
    assert_state_equal(port_end, ref_end)


def test_admit_one_matches_reference():
    from repro.core.scheduler import DeviceScheduler
    from repro_torch.core.scheduler import DeviceEngine
    ref = DeviceScheduler(16, capacity=4, pending_capacity=1)
    port = DeviceEngine(16, capacity=4, pending_capacity=1, device="cpu")
    for i in range(6):     # piling reservations: both structures grow
        r = RefRequest(t_a=i, t_r=i, t_du=5000, t_dl=i + 5000, n_pe=1)
        a = ref.admit(r, Policy.FF)
        b = port.admit(ARRequest(i, i, 5000, i + 5000, 1), Policy.FF)
        assert (a.t_s, a.t_e, a.pe_ids) == (b.t_s, b.t_e, b.pe_ids)
        assert dataclasses.astuple(a.rectangle) == \
            dataclasses.astuple(b.rectangle)
    assert port.tl.capacity == ref.tl.capacity > 4
    assert_state_equal(port.state, ref.state)
    assert port.records() == ref.records()
    np.testing.assert_array_equal(
        pt_batch.mask32_to_ids(torch.tensor([5, -1], dtype=torch.int32)),
        ref_batch.mask32_to_ids(jnp.asarray([5, 2**32 - 1], jnp.uint32)))
