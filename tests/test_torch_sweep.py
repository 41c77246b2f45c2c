"""The port's ``simulate_grid`` against the JAX package's, cell by cell.

The same ``GridSpec`` runs through both packages' grids: every cell's
``(accepted, t_s)`` trace and its ``n_accepted`` / ``n_jobs`` must be
equal exactly; ``acceptance``, ``slowdown`` and ``utilization`` are
float32 sums whose reduction order differs between XLA and PyTorch, so
they are compared with ``rtol=1e-6``.  On a 7-policy x 3-load grid every
cell is decision-identical to the port's host event loop
(``cross_check``) and the grid reproduces the paper's ordering (PE-Worst-
Fit highest acceptance, First-Fit lowest slowdown); the policy x backfill
grid's EASY dominates ``none`` and conservative equals it.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.core.types import Policy as RefPolicy
from repro.sim import GridSpec as RefGridSpec
from repro.sim import WorkloadParams as RefParams
from repro.sim import pad_streams as ref_pad_streams
from repro.sim import simulate_grid as ref_simulate_grid
from repro.sim.workload import generate_filtered as ref_generate_filtered
from repro_torch.core import batch as pt_batch
from repro_torch.core import timeline as pt_tl
from repro_torch.core import words as pt_words
from repro_torch.core.types import ALL_POLICIES, ARRequest, Policy
from repro_torch.sim import (GridSpec, WorkloadParams, generate_filtered,
                             pad_streams, simulate_grid)
from repro_torch.sim.metrics import (GridResult, grid_reductions, mean_ci95,
                                     nanmean_safe)

# float32 metric sums: XLA and PyTorch sum in different orders
RTOL = 1e-6
SIZES = dict(u_low=2.0, u_med=4.0, u_hi=6.0)
# the backfill grid: a small machine and wide jobs, so fragmentation
# gives the EASY displacement holes to fill
BF_SIZES = dict(u_low=2.0, u_med=3.0, u_hi=4.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are thousands of small ops, which
    extra threads only slow when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(kw, base, **run):
    """The port's and the reference's grid of one spec."""
    ours = simulate_grid(GridSpec(base=WorkloadParams(**base), **kw),
                         device="cpu", **run)
    ref_kw = dict(kw)
    if "policies" in ref_kw:
        ref_kw["policies"] = tuple(RefPolicy(p.value)
                                   for p in kw["policies"])
    run.pop("cross_check", None)
    theirs = ref_simulate_grid(RefGridSpec(base=RefParams(**base), **ref_kw),
                               **run)
    return ours, theirs


def assert_grid_equal(ours, theirs):
    assert ours.acceptance.shape == theirs.acceptance.shape
    np.testing.assert_array_equal(ours.n_accepted, theirs.n_accepted)
    np.testing.assert_array_equal(ours.n_jobs, theirs.n_jobs)
    for f in ("acceptance", "slowdown", "utilization"):
        np.testing.assert_allclose(getattr(ours, f), getattr(theirs, f),
                                   rtol=RTOL, err_msg=f)
    assert (ours.policies, ours.backfill_modes) == (theirs.policies,
                                                   theirs.backfill_modes)
    if theirs.decisions is not None:
        assert ours.decisions == theirs.decisions


@pytest.fixture(scope="module")
def paper_grid():
    """7 policies x 3 loads, cross-checked per cell against the port's
    host event loop (``simulate_grid`` raises on divergence) and held
    against the reference's grid."""
    ours, theirs = _grids(dict(
        policies=ALL_POLICIES, arrival_factors=(1.0, 1.5, 2.0), seeds=(0,),
        flex_factors=(3.0,), n_pe=64, n_jobs=150), SIZES, capacity=64,
        cross_check=True, record_decisions=True)
    assert_grid_equal(ours, theirs)
    return ours


@pytest.fixture(scope="module")
def backfill_grid():
    """7 policies x {none, easy, conservative} as one ensemble."""
    ours, theirs = _grids(dict(
        policies=ALL_POLICIES, arrival_factors=(2.5,), seeds=(3,),
        flex_factors=(3.0,), backfill_modes=("none", "easy", "conservative"),
        n_pe=16, n_jobs=120, park_capacity=8), BF_SIZES, capacity=64,
        record_decisions=True)
    assert_grid_equal(ours, theirs)
    return ours


def test_grid_shape_and_counts(paper_grid):
    assert paper_grid.acceptance.shape == (7, 1, 3, 1, 1)
    assert paper_grid.n_cells == 21
    assert paper_grid.backfill_modes == ("none",)
    assert (paper_grid.n_jobs > 0).all()
    assert (paper_grid.n_accepted <= paper_grid.n_jobs).all()
    assert (paper_grid.n_jobs == paper_grid.n_jobs[:1]).all()
    m = paper_grid.metrics
    assert m["lanes"] == 21 and m["one_shot_scans"] == 1
    assert m["offered"] == int(paper_grid.n_jobs.sum())


def test_grid_reproduces_pe_worst_fit_highest_acceptance(paper_grid):
    acc = paper_grid.policy_acceptance()
    assert acc[Policy.PE_W.value] >= max(acc.values()) - 0.01


def test_grid_reproduces_ff_lowest_slowdown(paper_grid):
    sd = paper_grid.policy_slowdown()
    assert sd[Policy.FF.value] == min(sd.values())


def test_grid_acceptance_degrades_with_load(paper_grid):
    pe_w = list(paper_grid.policies).index(Policy.PE_W.value)
    by_load = np.nanmean(paper_grid.acceptance[pe_w, 0], axis=(1, 2))
    assert by_load[0] > by_load[-1]


def test_grid_decisions_recorded(paper_grid):
    cell = paper_grid.decisions[0][0][0][0][0]
    assert len(cell) == int(paper_grid.n_jobs[0, 0, 0, 0, 0])
    assert all(isinstance(a, bool) and isinstance(t, int) for a, t in cell)
    assert "cells/s" in paper_grid.summary()


def test_pad_streams_matches_reference_and_never_admits():
    params = dict(n_jobs=40, n_pe=64, **SIZES)
    a = generate_filtered(WorkloadParams(**params), max_pe=64)
    ref_a = ref_generate_filtered(RefParams(**params), max_pe=64)
    for extra, tn in ((0, False), (2, True)):
        streams = [a, a[:17], []]
        batch, valid = pad_streams(streams, 64, with_tenant=tn,
                                   extra_demand=extra, device="cpu")
        ref_b, ref_v = ref_pad_streams([ref_a, ref_a[:17], []], 64,
                                       with_tenant=tn, extra_demand=extra)
        np.testing.assert_array_equal(valid, ref_v)
        for f in ("t_a", "t_r", "t_du", "t_dl", "n_pe", "tenant", "demand"):
            got, want = getattr(batch, f), getattr(ref_b, f)
            assert (got is None) == (want is None), f
            if got is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert batch.t_a.shape == (3, len(a))
    assert valid.sum(axis=1).tolist() == [len(a), 17, 0]
    assert (batch.n_pe.numpy()[~valid] == 65).all()
    assert (batch.t_a.numpy()[1, 17:] >= a[16].t_a).all()
    lanes = [i % 3 for i in range(10)]
    sb, sv, slots = pt_batch.scatter_streams(a[:10], lanes, 3, 64,
                                             device="cpu")
    assert slots[:4] == [(0, 0), (1, 0), (2, 0), (0, 1)]
    assert sv.sum() == 10 and int(sb.t_a[slots[5]]) == a[5].t_a


def test_grid_flex_axis_raises_acceptance():
    ours, theirs = _grids(dict(
        policies=(Policy.PE_W,), arrival_factors=(1.5,), seeds=(0, 1),
        flex_factors=(1.0, 5.0), n_pe=64, n_jobs=120), SIZES, capacity=64)
    assert_grid_equal(ours, theirs)
    acc = np.nanmean(ours.acceptance[0, 0, 0], axis=0)
    assert acc[1] > acc[0]


def test_grid_kernel_path_matches_plain_path():
    kw = dict(policies=(Policy.PE_W, Policy.FF), arrival_factors=(1.0,),
              seeds=(0,), flex_factors=(3.0,), n_pe=32, n_jobs=40)
    base = WorkloadParams(**SIZES)
    kern = simulate_grid(GridSpec(base=base, **kw), capacity=64,
                         record_decisions=True, device="cpu")
    plain = simulate_grid(GridSpec(base=base, **kw), capacity=64,
                          record_decisions=True, use_kernel=False,
                          device="cpu")
    np.testing.assert_array_equal(kern.n_accepted, plain.n_accepted)
    assert kern.decisions == plain.decisions


@pytest.mark.parametrize("donate", [True, False])
def test_grid_cell_overflow_grows_collectively(donate):
    """From a tiny shared capacity the busier cells overflow; the
    grow-once re-run keeps every cell host-identical and equal to the
    reference, growths and capacities included."""
    ours, theirs = _grids(dict(
        policies=(Policy.FF, Policy.PE_W), arrival_factors=(1.0,),
        seeds=(0,), flex_factors=(3.0,), n_pe=64, n_jobs=60), SIZES,
        capacity=8, pending_capacity=4, cross_check=True,
        record_decisions=True, donate=donate)
    assert_grid_equal(ours, theirs)
    assert (ours.n_accepted > 0).all()
    assert ours.metrics["growths"] >= 1 and ours.metrics["capacity"] > 8


def test_backfill_grid_modes_dominate_none(backfill_grid):
    acc = backfill_grid.mode_policy_acceptance()
    for p in backfill_grid.policies:
        assert acc["easy"][p] > acc["none"][p], p
        assert acc["conservative"][p] == acc["none"][p], p
    b = {m: i for i, m in enumerate(backfill_grid.backfill_modes)}
    for f in ("acceptance", "slowdown"):
        arr = getattr(backfill_grid, f)
        np.testing.assert_array_equal(arr[:, b["conservative"]],
                                      arr[:, b["none"]], err_msg=f)
    assert backfill_grid.decisions[0][b["conservative"]] == \
        backfill_grid.decisions[0][b["none"]]


def test_backfill_grid_keeps_policy_orderings(backfill_grid):
    acc = backfill_grid.mode_policy_acceptance()
    sd = backfill_grid.mode_policy_slowdown()
    for m in backfill_grid.backfill_modes:
        assert acc[m][Policy.PE_W.value] >= max(acc[m].values()) - 0.01
        assert sd[m][Policy.FF.value] == min(sd[m].values())


def test_backfill_grid_single_dispatch_no_per_mode_recompile():
    """Permuting the backfill-mode axis permutes the cells and nothing
    else: identical per-mode metrics."""
    kw = dict(policies=(Policy.PE_W, Policy.FF), arrival_factors=(2.0,),
              seeds=(3,), flex_factors=(3.0,),
              backfill_modes=("none", "easy", "conservative"), n_pe=16,
              n_jobs=40, park_capacity=4)
    base = WorkloadParams(**BF_SIZES)
    r1 = simulate_grid(GridSpec(base=base, **kw), capacity=64, device="cpu")
    r2 = simulate_grid(GridSpec(base=base, **kw), capacity=64, device="cpu",
                       backfill_modes=("easy", "conservative", "none"))
    for m in ("none", "easy", "conservative"):
        np.testing.assert_array_equal(
            r1.acceptance[:, r1.backfill_modes.index(m)],
            r2.acceptance[:, r2.backfill_modes.index(m)])
    assert r1.metrics["park_capacity"] == 4


def test_backfill_grid_cross_check_against_host_oracle():
    ours, theirs = _grids(dict(
        policies=(Policy.PE_W, Policy.DU_B, Policy.FF),
        arrival_factors=(2.0,), seeds=(3,), flex_factors=(3.0,),
        backfill_modes=("none", "easy", "conservative"), n_pe=16,
        n_jobs=60, park_capacity=4), BF_SIZES, capacity=64,
        cross_check=True, record_decisions=True)
    assert_grid_equal(ours, theirs)
    assert (ours.n_accepted > 0).all()


def test_zero_acceptance_cell_is_nan_safe():
    """A cell accepting nothing reduces to NaN slowdown with no warning;
    an all-padding cell also to NaN utilization."""
    n_pe = 8
    jobs = [ARRequest(t_a=i, t_r=i, t_du=10, t_dl=i + 100, n_pe=16)
            for i in range(5)]
    state = pt_tl.init_state(16, n_pe, 8, device="cpu")
    batch = pt_batch.requests_to_batch(jobs, "cpu")
    _, dec = pt_batch.admit_stream_grow(state, batch, Policy.PE_W,
                                        n_pe=n_pe)
    stacked = pt_batch.Decision(*(f[None] for f in dec))
    sb = pt_batch.RequestBatch(*(getattr(batch, f)[None]
                                 for f in pt_batch.REQ_FIELDS))
    valid = np.ones((1, len(jobs)), bool)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        n_acc, n_val, rate, slowdown, util = grid_reductions(
            stacked, sb, valid, n_pe)
        assert n_acc.tolist() == [0] and rate.tolist() == [0.0]
        assert np.isnan(slowdown).all()
        r = GridResult(
            policies=("PE_W",), arrival_factors=(1.0,), seeds=(0,),
            flex_factors=(3.0,), backfill_modes=("none",),
            acceptance=rate.reshape(1, 1, 1, 1, 1),
            slowdown=slowdown.reshape(1, 1, 1, 1, 1),
            utilization=util.reshape(1, 1, 1, 1, 1),
            n_jobs=n_val.reshape(1, 1, 1, 1, 1).astype(int),
            n_accepted=n_acc.reshape(1, 1, 1, 1, 1).astype(int))
        assert np.isnan(r.policy_slowdown()["PE_W"])
        assert np.isnan(r.mode_policy_slowdown()["none"]["PE_W"])
        assert r.policy_acceptance()["PE_W"] == 0.0
        assert "PE_W" in r.summary()
        _, _, _, _, util = grid_reductions(
            stacked, sb, np.zeros((1, len(jobs)), bool), n_pe)
        assert np.isnan(util).all()
    assert np.isnan(nanmean_safe([np.nan, np.nan]))
    assert nanmean_safe([1.0, np.nan]) == 1.0
    assert mean_ci95([]) != mean_ci95([])      # NaNs
    mean, hw = mean_ci95([1.0, 2.0, 3.0])
    assert mean == 2.0 and hw == pytest.approx(1.96 / np.sqrt(3))


def test_grid_reductions_match_reference_on_paper_scale_cells():
    """The reductions themselves, on padded paper-width cells with
    large areas: counts exact, rates within RTOL."""
    import jax.numpy as jnp
    from repro.core import batch as ref_batch
    from repro.sim.metrics import grid_reductions as ref_reductions

    rng = np.random.default_rng(7)
    C, N = 4, 300
    fields = {f: rng.integers(0, 10**5, (C, N)).astype(np.int32)
              for f in ("t_a", "t_r", "t_du")}
    fields["t_a"] = np.sort(fields["t_a"], axis=1)
    fields["t_du"] += 1
    fields["n_pe"] = rng.integers(1, 1025, (C, N)).astype(np.int32)
    fields["t_dl"] = fields["t_r"] + 10**6
    acc = rng.random((C, N)) < 0.7
    acc[3] = False
    t_s = np.where(acc, fields["t_r"] + rng.integers(0, 500, (C, N)),
                   -1).astype(np.int32)
    valid = rng.random((C, N)) < 0.9
    valid[2] = False
    W = 32
    pe_mask = np.zeros((C, N, W), np.int32)
    zeros = np.zeros((C, N), np.int32)
    dec = pt_batch.Decision(
        torch.from_numpy(acc), torch.from_numpy(t_s),
        torch.from_numpy(t_s), torch.from_numpy(pe_mask),
        *(torch.from_numpy(zeros) for _ in range(3)),
        torch.from_numpy(np.zeros((C, N), bool)))
    ref_dec = ref_batch.Decision(
        jnp.asarray(acc), jnp.asarray(t_s), jnp.asarray(t_s),
        jnp.asarray(pt_words.to_uint32(pe_mask)),
        *(jnp.asarray(zeros) for _ in range(3)),
        jnp.asarray(np.zeros((C, N), bool)))
    batch = pt_batch.RequestBatch(*(torch.from_numpy(fields[f])
                                    for f in pt_batch.REQ_FIELDS))
    ref_b = ref_batch.RequestBatch(*(jnp.asarray(fields[f])
                                     for f in ref_batch.REQ_FIELDS))
    got = grid_reductions(dec, batch, valid, 1024)
    want = ref_reductions(ref_dec, ref_b, valid, 1024)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=RTOL)
        assert g.dtype == np.asarray(w).dtype
