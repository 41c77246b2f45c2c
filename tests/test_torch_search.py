"""The port's search and the kernels' plain versions against the JAX package.

Candidate enumeration, availability rectangles, integer keys and
selection, full ``search`` for all seven policies, and the plain
``availscan`` / ``availscan_select`` against the Pallas kernels run in
interpret mode (``repro.kernels.ops`` on the CPU).  Exact equality.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import policies as ref_pol
from repro.core import search as ref_search
from repro.core import timeline as ref_tl
from repro.core.types import T_INF
from repro.kernels import availscan as ref_kernels
from repro.kernels import ops as ref_ops
from repro_torch.core import policies as pt_pol
from repro_torch.core import search as pt_search
from repro_torch.core import timeline as pt_tl
from repro_torch.core import words as pt_words
from repro_torch.core.resources import ResourceSpec
from repro_torch.kernels import cases as pt_cases
from repro_torch.kernels import ops as pt_ops

N_POLICIES = 7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are thousands of small ops, which
    extra threads only slow when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_timeline(rng, n_pe, capacity, n_jobs):
    tl = ref_tl.empty(capacity, n_pe)
    t = 0
    for _ in range(n_jobs):
        t_s = t + int(rng.integers(0, 10))
        t_e = t_s + int(rng.integers(1, 30))
        ids = rng.choice(n_pe, size=int(rng.integers(1, n_pe // 2 + 1)),
                         replace=False)
        bits = np.zeros(tl.words * 32, np.uint32)
        bits[ids] = 1
        mask = ref_tl.pack_bits(bits[None, :])[0]
        tl, overflow = ref_tl.update(tl, t_s, t_e, mask, is_add=True)
        assert not bool(overflow)
        t = t_s
    return tl


def to_port(tl):
    return pt_tl.Timeline(
        times=torch.from_numpy(np.asarray(tl.times).copy()),
        occ=torch.from_numpy(pt_words.to_int32(np.asarray(tl.occ))))


def _request(rng):
    t_r = int(rng.integers(0, 40))
    t_du = int(rng.integers(1, 40))
    t_dl = t_r + t_du + int(rng.integers(0, 80))
    return t_r, t_du, t_dl


CASES = [(n_pe, cap) for n_pe in (8, 40, 100, 200) for cap in (32, 64)]


@pytest.mark.parametrize("n_pe,capacity", CASES)
def test_rectangles_and_pallas_match(n_pe, capacity):
    """candidate_starts, the plain availscan, the kernel-backed entry on
    the CPU and the Pallas kernel (interpret mode) agree element-wise."""
    rng = np.random.default_rng(n_pe * 1000 + capacity)
    ref = _random_timeline(rng, n_pe, capacity, n_jobs=capacity // 4)
    port = to_port(ref)
    for _ in range(3):
        t_r, t_du, t_dl = _request(rng)
        ref_starts = ref_search.candidate_starts(
            ref, jnp.int32(t_r), jnp.int32(t_du), jnp.int32(t_dl))
        starts = pt_search.candidate_starts(port, t_r, t_du, t_dl)
        np.testing.assert_array_equal(starts.numpy(), np.asarray(ref_starts))
        t_now = t_r - int(rng.integers(0, 5))
        want = ref_search.availability_rectangles(
            ref, ref_starts, jnp.int32(t_du), jnp.int32(t_now), n_pe)
        pallas = ref_ops.availability_rectangles(
            ref, ref_starts, jnp.int32(t_du), jnp.int32(t_now), n_pe)
        for got in (pt_search.availability_rectangles(
                        port, starts, t_du, t_now, n_pe),
                    pt_ops.availability_rectangles(
                        port, starts, t_du, t_now, n_pe)):
            for f in ("n_free", "t_begin", "t_end", "valid"):
                np.testing.assert_array_equal(
                    getattr(got, f).numpy(), np.asarray(getattr(want, f)))
                np.testing.assert_array_equal(
                    getattr(got, f).numpy(), np.asarray(getattr(pallas, f)))


def _pallas_select_row(tl, starts, t_du, t_now, n_req, policy_id, n_pe):
    """The Pallas availscan_select result row, built as ops.search_select
    builds its operands."""
    occ_bits, times, nxt, n_pe_pad = ref_ops._padded_operands(tl, n_pe)
    a = jnp.minimum(starts, T_INF - t_du)
    scalars = jnp.asarray([policy_id, n_req, t_now, n_pe_pad - n_pe],
                          jnp.int32)
    return np.asarray(ref_kernels.availscan_select(
        occ_bits, times, nxt, starts, a, a + t_du, scalars,
        starts < T_INF, interpret=True))


@pytest.mark.parametrize("n_pe,capacity", CASES)
def test_select_row_matches_pallas_all_policies(n_pe, capacity):
    rng = np.random.default_rng(7 + n_pe + capacity)
    ref = _random_timeline(rng, n_pe, capacity, n_jobs=capacity // 4)
    port = to_port(ref)
    t_r, t_du, t_dl = _request(rng)
    starts = pt_search.candidate_starts(port, t_r, t_du, t_dl)
    ref_starts = jnp.asarray(starts.numpy())
    for pid in range(N_POLICIES):
        n_req = int(rng.integers(1, n_pe + 1))
        want = _pallas_select_row(ref, ref_starts, t_du, t_r, n_req, pid,
                                  n_pe)
        got = pt_ops.search_select(port, starts, t_du, t_r, n_req, pid,
                                   n_pe)
        row = pt_ops._ref.availscan_select_ref(
            port.times, port.occ, starts, t_du, t_r, n_req, pid, n_pe)
        np.testing.assert_array_equal(row.numpy(), want, err_msg=str(pid))
        assert (bool(got["found"]), int(got["best"])) == (
            bool(want[7]), int(want[3]))


# the CUDA select kernels' candidates per block
PER_BLOCK = 8
# (kind, P): P spans several 128-candidate Pallas tiles and many blocks
SEAM_CASES = [("tie", 300), ("tie spread", 300), ("infeasible", 384),
              ("many tiles", 513)]


def seam_case(kind, rng, spec, live, capacity, P):
    """One :mod:`repro_torch.kernels.cases` input of ``kind``; the first
    live candidate of an infeasible case sits on a Pallas tile boundary,
    where the Pallas kernel also names the lowest live index."""
    if kind.startswith("tie"):
        return pt_cases.tie_case(rng, spec, live, capacity, P, PER_BLOCK,
                                 spread=kind == "tie spread")
    if kind == "infeasible":
        return pt_cases.infeasible_case(rng, spec, live, capacity, P,
                                        first_live=256)
    return pt_cases.many_tiles_case(rng, spec, live, capacity, P)


def check_seam_row(kind, case, row):
    """What each kind of case pins down about the winning row."""
    best, feasible = int(row[3]), int(row[7])
    last_block = (case.starts.shape[0] - 1) // PER_BLOCK * PER_BLOCK
    if kind == "tie":
        assert feasible and best >= last_block
    elif kind == "tie spread":
        assert feasible and best < last_block
    elif kind == "infeasible":
        assert (feasible, best) == (0, 256)
    if feasible:
        assert int(row[2]) == int(case.starts[best])


@pytest.mark.parametrize("kind,P", SEAM_CASES)
def test_select_row_matches_pallas_across_blocks(kind, P):
    """Ties, all-infeasible rows and many tiles: the plain select equals
    the Pallas kernel's row under every policy."""
    n_pe = 100
    rng = np.random.default_rng(P + len(kind))
    case = seam_case(kind, rng, ResourceSpec((n_pe,)), None, 64, P)
    ref = ref_tl.Timeline(times=jnp.asarray(case.times),
                          occ=jnp.asarray(case.occ))
    times = torch.from_numpy(case.times)
    occ = torch.from_numpy(pt_words.to_int32(case.occ))
    starts = torch.from_numpy(case.starts)
    for pid in range(N_POLICIES):
        want = _pallas_select_row(ref, jnp.asarray(case.starts), case.t_du,
                                  case.t_now, case.n_req, pid, n_pe)
        row = pt_ops._ref.availscan_select_ref(
            times, occ, starts, case.t_du, case.t_now, case.n_req, pid,
            n_pe)
        np.testing.assert_array_equal(row.numpy(), want,
                                      err_msg=f"{case.label} policy {pid}")
        check_seam_row(kind, case, row)


def test_integer_keys_and_select_match_reference():
    rng = np.random.default_rng(3)
    P = 50
    n_free = rng.integers(0, 2048, P).astype(np.int32)
    dur = rng.integers(0, 2**31 - 1, P).astype(np.int32)
    dur[:5] = [0, 1, 65535, 65536, 2**31 - 1]
    starts = np.sort(rng.integers(0, 1000, P)).astype(np.int32)
    feasible = rng.random(P) < 0.5
    n_free[10:14] = n_free[9]          # ties on the primary key
    dur[10:14] = dur[9]
    for pid in range(N_POLICIES):
        k1, k2 = pt_pol.integer_keys(pid, torch.from_numpy(n_free),
                                     torch.from_numpy(dur))
        r1, r2 = ref_pol.integer_keys(jnp.int32(pid), jnp.asarray(n_free),
                                      jnp.asarray(dur))
        np.testing.assert_array_equal(k1.numpy(), np.asarray(r1))
        np.testing.assert_array_equal(k2.numpy(), np.asarray(r2))
        for feas in (feasible, np.zeros(P, bool)):
            best, found = pt_pol.select(
                pid, torch.from_numpy(n_free), torch.from_numpy(dur),
                torch.from_numpy(starts), torch.from_numpy(feas))
            r_best, r_found = ref_pol.select(
                jnp.int32(pid), jnp.asarray(n_free), jnp.asarray(dur),
                jnp.asarray(starts), jnp.asarray(feas))
            assert (int(best), bool(found)) == (int(r_best), bool(r_found))


def test_policy_score_matches_reference():
    from repro.core import types as ref_types
    from repro_torch.core import types as pt_types
    for rect in ((5, 0, 30, 12), (7, 3, T_INF, 1), (0, 0, 1, 0)):
        for ours, theirs in zip(pt_types.ALL_POLICIES,
                                ref_types.ALL_POLICIES):
            assert ours.value == theirs.value
            assert pt_types.policy_score(ours, pt_types.Rectangle(*rect)) \
                == ref_types.policy_score(theirs,
                                          ref_types.Rectangle(*rect))


def _assert_result_equal(got, want, ctx):
    for f in ("found", "t_s", "t_e", "n_free", "t_begin", "t_end"):
        assert int(getattr(got, f)) == int(getattr(want, f)), (ctx, f)
    np.testing.assert_array_equal(
        pt_words.to_uint32(got.pe_mask.numpy()), np.asarray(want.pe_mask),
        err_msg=str(ctx))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("n_pe", [40, 100])
def test_search_matches_reference_all_policies(n_pe, use_kernel):
    rng = np.random.default_rng(n_pe + int(use_kernel))
    ref = _random_timeline(rng, n_pe, 32, n_jobs=8)
    port = to_port(ref)
    for pid in range(N_POLICIES):
        t_r, t_du, t_dl = _request(rng)
        n_req = int(rng.integers(1, n_pe + 1))
        want = ref_search.find_allocation(
            ref, jnp.int32(t_r), jnp.int32(t_du), jnp.int32(t_dl),
            jnp.int32(n_req), jnp.int32(pid), jnp.int32(t_r), n_pe=n_pe)
        got = pt_search.search(port, t_r, t_du, t_dl, n_req, pid, t_r,
                               n_pe=n_pe, use_kernel=use_kernel)
        _assert_result_equal(got, want, (pid, use_kernel))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_empty_timeline_and_infeasible_request(use_kernel):
    n_pe = 40
    ref = ref_tl.empty(16, n_pe)
    port = pt_tl.empty(16, n_pe, "cpu")
    # empty timeline: the whole machine, unbounded rectangle
    got = pt_search.search(port, 3, 5, 20, 40, 2, 0, n_pe=n_pe,
                           use_kernel=use_kernel)
    assert bool(got.found) and int(got.n_free) == n_pe
    assert int(got.t_end) == T_INF and int(got.t_s) == 3
    # infeasible request: rejected, candidate 0's rectangle reported
    rng = np.random.default_rng(11)
    ref = _random_timeline(rng, n_pe, 32, n_jobs=8)
    port = to_port(ref)
    for pid in range(N_POLICIES):
        want = ref_search.find_allocation(
            ref, jnp.int32(2), jnp.int32(7), jnp.int32(60),
            jnp.int32(n_pe + 1), jnp.int32(pid), jnp.int32(0), n_pe=n_pe,
            use_kernel=True)
        got = pt_search.search(port, 2, 7, 60, n_pe + 1, pid, 0, n_pe=n_pe,
                               use_kernel=use_kernel)
        assert not bool(got.found)
        _assert_result_equal(got, want, pid)
        rects = pt_search.availability_rectangles(
            port, pt_search.candidate_starts(port, 2, 7, 60), 7, 0, n_pe)
        assert (int(got.n_free), int(got.t_begin), int(got.t_end)) == (
            int(rects.n_free[0]), int(rects.t_begin[0]),
            int(rects.t_end[0]))
