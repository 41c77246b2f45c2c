"""The port's availability index against the JAX package's, bit for bit.

Twins of ``tests/test_availindex.py``: the tile summaries after random
update / update_many / grow walks (R = 1 and R = 4); ``summary_reject``
and ``prune_candidates`` element for element; indexed streams (every
``Decision`` field) against the index-free port and the reference's
indexed stream, for all seven policies, at several tiles and on a
saturated stream; the bucketed search view; and the pruned-start
inputs of ``repro_torch.kernels.cases`` through the plain select
against the reference's ``policies.select``.  The reference runs its
jnp path (``use_kernel=False``); the port runs its kernel path, which
on the CPU is the kernels' plain versions and prunes candidates.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import availindex as ref_ai
from repro.core import batch as ref_batch
from repro.core import policies as ref_policies
from repro.core import search as ref_search
from repro.core import timeline as ref_tl
from repro.core.resources import ResourceSpec as RefSpec
from repro.core.scheduler import DeviceEngine as RefEngine
from repro.core.types import ARRequest as RefRequest
from repro_torch.core import availindex as pt_ai
from repro_torch.core import batch as pt_batch
from repro_torch.core import search as pt_search
from repro_torch.core import timeline as pt_tl
from repro_torch.core import words as pt_words
from repro_torch.core.resources import ResourceSpec, device_layout
from repro_torch.core.scheduler import DeviceEngine
from repro_torch.core.types import ALL_POLICIES, ARRequest, Policy, T_INF
from repro_torch.kernels import cases
from repro_torch.kernels import ref as pt_ref

CPU = torch.device("cpu")
DEC_FIELDS = ("accepted", "t_s", "t_e", "pe_mask", "n_free", "t_begin",
              "t_end", "parked")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are thousands of small ops, which
    extra threads only slow when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(t):
    return pt_words.to_uint32(t.cpu().numpy())


def _i32(a):
    return torch.from_numpy(pt_words.to_int32(np.asarray(a)))


def assert_index_equal(port_tl, ref_tl_):
    """Rows and all three summaries equal (and canonical on both)."""
    np.testing.assert_array_equal(port_tl.times.numpy(),
                                  np.asarray(ref_tl_.times))
    np.testing.assert_array_equal(_u32(port_tl.occ), np.asarray(ref_tl_.occ))
    got = (_u32(port_tl.idx_occ), port_tl.idx_minfree.numpy(),
           port_tl.idx_maxfree.numpy())
    want = [np.asarray(x) for x in (ref_tl_.idx_occ, ref_tl_.idx_minfree,
                                    ref_tl_.idx_maxfree)]
    canon = pt_ai.build_summaries(port_tl.times, port_tl.occ, port_tl.ispec)
    for name, g, w, c in zip(("idx_occ", "idx_minfree", "idx_maxfree"),
                             got, want, canon):
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(
            g, _u32(c) if name == "idx_occ" else c.numpy(), err_msg=name)


LAYOUTS = {1: (40,), 4: (40, 6, 3, 40)}


def _layout(R):
    units = LAYOUTS[R]
    if R == 1:
        return units[0], None, None, pt_words.n_words(units[0])
    spec, ref_spec = ResourceSpec(units), RefSpec(units)
    return units[0], spec, ref_spec, spec.total_words


def _random_mask(rng, units, W):
    """uint32[W]: random units of every plane (at least one PE)."""
    bits = np.zeros(W * 32, np.uint8)
    off = 0
    for r, u in enumerate(units):
        k = rng.randint(1 if r == 0 else 0, max(1, u // 3))
        for i in rng.sample(range(u), k):
            bits[off + i] = 1
        off += 32 * pt_words.n_words(u)
    return np.packbits(bits, bitorder="little").view("<u4").copy()


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_summaries_match_reference_on_random_walks(seed, R):
    """Adds, deletes, batched adds/deletes, a malformed (T_INF) update
    and a growth: the rows and summaries equal the reference's after
    every step."""
    rng = random.Random(seed)
    n_pe, spec, ref_spec, W = _layout(R)
    units = LAYOUTS[R]
    port = pt_tl.empty(32, n_pe, "cpu", words=W,
                       ispec=pt_ai.make_index_spec(8, n_pe, spec))
    ref = ref_tl.empty(32, n_pe, words=W,
                       ispec=ref_ai.make_index_spec(8, n_pe, ref_spec))
    live = []
    for step in range(24):
        op = rng.random()
        if step == 12:
            port, ref = pt_tl.grow(port, 64), ref_tl.grow(ref, 64)
        elif step == 17:
            m = _random_mask(rng, units, W)
            port, _ = pt_tl.update(port, 5, T_INF, _i32(m), is_add=True)
            ref, _ = ref_tl.update(ref, jnp.int32(5), jnp.int32(T_INF),
                                   jnp.asarray(m), is_add=True)
        elif op < 0.3 and live:
            s, e, m = live.pop(rng.randrange(len(live)))
            port, _ = pt_tl.update(port, s, e, _i32(m), is_add=False)
            ref, _ = ref_tl.update(ref, jnp.int32(s), jnp.int32(e),
                                   jnp.asarray(m), is_add=False)
        elif op < 0.5 and len(live) >= 2:
            k = rng.randint(1, min(3, len(live)))
            gone = [live.pop(rng.randrange(len(live))) for _ in range(k)]
            ts = np.array([g[0] for g in gone] + [0], np.int32)
            te = np.array([g[1] for g in gone] + [0], np.int32)
            ms = np.stack([g[2] for g in gone] + [np.zeros(W, np.uint32)])
            act = np.array([True] * k + [False])
            port, _ = pt_tl.update_many(
                port, torch.from_numpy(ts), torch.from_numpy(te), _i32(ms),
                torch.from_numpy(act), is_add=False)
            ref, _ = ref_tl.update_many(
                ref, jnp.asarray(ts), jnp.asarray(te), jnp.asarray(ms),
                jnp.asarray(act), is_add=False)
        else:
            k = rng.randint(1, 3)
            new = []
            for _ in range(k):
                s = rng.randint(0, 200)
                new.append((s, s + rng.randint(1, 40),
                            _random_mask(rng, units, W)))
            # adds of one batch may overlap each other, so they go one
            # by one unless the batch is a single interval
            if k == 1:
                s, e, m = new[0]
                port, _ = pt_tl.update_many(
                    port, torch.tensor([s], dtype=torch.int32),
                    torch.tensor([e], dtype=torch.int32), _i32(m[None]),
                    torch.tensor([True]), is_add=True)
                ref, _ = ref_tl.update_many(
                    ref, jnp.asarray([s], jnp.int32),
                    jnp.asarray([e], jnp.int32), jnp.asarray(m[None]),
                    jnp.asarray([True]), is_add=True)
            else:
                for s, e, m in new:
                    port, _ = pt_tl.update(port, s, e, _i32(m), is_add=True)
                    ref, _ = ref_tl.update(ref, jnp.int32(s), jnp.int32(e),
                                           jnp.asarray(m), is_add=True)
            live += new
        assert_index_equal(port, ref)


def test_index_spec_and_empty_summaries_match_reference():
    for tile, n_pe, units in ((8, 33, None), (16, 40, (40, 6, 3, 40))):
        spec = None if units is None else ResourceSpec(units)
        ref_spec = None if units is None else RefSpec(units)
        ours = pt_ai.make_index_spec(tile, n_pe, spec)
        theirs = ref_ai.make_index_spec(tile, n_pe, ref_spec)
        assert (ours.tile, ours.units, ours.words_per, ours.R,
                ours.total_words, ours.word_offsets) == (
            theirs.tile, theirs.units, theirs.words_per, theirs.R,
            theirs.total_words, theirs.word_offsets)
        got = pt_ai.empty_summaries(64, ours, CPU)
        want = ref_ai.empty_summaries(64, theirs)
        np.testing.assert_array_equal(_u32(got[0]), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if spec is not None:
            lane = spec.valid_mask_np((33, 6, 2, 40))
            np.testing.assert_array_equal(
                pt_ai.plane_deficit(ours, torch.from_numpy(lane),
                                    CPU).numpy(),
                np.asarray(ref_ai.plane_deficit(theirs, jnp.asarray(
                    pt_words.to_uint32(lane)))))
    with pytest.raises(ValueError, match="power of two"):
        pt_ai.IndexSpec(tile=12, units=(8,), words_per=(1,))
    with pytest.raises(ValueError, match="divisible"):
        pt_tl.init_state(24, 8, 8, device="cpu", index_tile=16)
    st = pt_tl.init_state(64, 8, 8, device="cpu", index_tile=8)
    assert st.tl.idx_occ.shape == (8, 1) and st.tl.ispec.tile == 8
    grown = pt_tl.grow_state(st, new_capacity=128)
    assert grown.tl.idx_minfree.shape == (16, 1)
    # no index: the timeline carries no summaries
    assert pt_tl.init_state(64, 8, 8, device="cpu").tl.idx_occ is None


def _busy_pair(seed, n_pe=32, capacity=64, tile=8, saturated=False):
    """The same busy timeline in both packages (index attached)."""
    rng = random.Random(seed)
    port = pt_tl.empty(capacity, n_pe, "cpu",
                       ispec=pt_ai.make_index_spec(tile, n_pe))
    ref = ref_tl.empty(capacity, n_pe,
                       ispec=ref_ai.make_index_spec(tile, n_pe))
    W = port.words
    if saturated:
        # rows each leaving one rotating unit free: every tile over the
        # busy span has maxfree == 1
        ivs = [(4 * k, 4 * k + 4, [i for i in range(n_pe)
                                   if i != k % n_pe]) for k in range(30)]
    else:
        ivs = []
        for _ in range(14):
            s = rng.randint(0, 150)
            ivs.append((s, s + rng.randint(1, 40), sorted(
                rng.sample(range(n_pe), rng.randint(1, n_pe)))))
    for s, e, ids in ivs:
        m = np.asarray(ref_tl.ids_to_mask32(ids, W))
        # overlapping random adds may double-book units; update ORs
        # bits, so both sides stay equal all the same
        port, _ = pt_tl.update(port, s, e, _i32(m), is_add=True)
        ref, _ = ref_tl.update(ref, jnp.int32(s), jnp.int32(e),
                               jnp.asarray(m), is_add=True)
    assert_index_equal(port, ref)
    return port, ref


@pytest.mark.parametrize("saturated", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_summary_reject_and_prune_match_reference(seed, saturated):
    n_pe = 32
    port, ref = _busy_pair(seed, n_pe=n_pe, saturated=saturated)
    bare = ref_tl.Timeline(times=ref.times, occ=ref.occ)
    rng = random.Random(100 + seed)
    zero = torch.zeros(1, dtype=torch.int32)
    n_rej = n_pruned = 0
    for _ in range(40):
        tr = rng.randint(0, 180)
        du = rng.randint(1, 50)
        dl = tr + du + rng.randint(0, 40)
        dem = rng.randint(1, n_pe)
        d_pt = torch.tensor([dem], dtype=torch.int32)
        d_ref = jnp.asarray([dem], jnp.int32)
        rej = pt_search.summary_reject(port, tr, du, dl, d_pt, zero)
        want = ref_search.summary_reject(
            ref, jnp.int32(tr), jnp.int32(du), jnp.int32(dl), d_ref,
            jnp.zeros((1,), jnp.int32))
        assert bool(rej) == bool(want), (tr, du, dl, dem)
        assert bool(rej) == bool(pt_search.index_reject(port, tr, du, dl,
                                                        dem))
        n_rej += bool(rej)
        starts = ref_search.candidate_starts(bare, jnp.int32(tr),
                                             jnp.int32(du), jnp.int32(dl))
        got = pt_search.prune_candidates(
            port, torch.from_numpy(np.array(starts)), du, d_pt, zero)
        exp = ref_search.prune_candidates(ref, starts, jnp.int32(du), d_ref,
                                          jnp.zeros((1,), jnp.int32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
        n_pruned += int(((got == T_INF).numpy()
                         & (np.asarray(starts) < T_INF)).sum())
    if saturated:
        assert n_rej > 0 and n_pruned > 0, (n_rej, n_pruned)


def _jobs(n, n_pe, seed, du_max=30, slack_max=40):
    rng = random.Random(seed)
    jobs, t = [], 0
    for _ in range(n):
        t += rng.randint(0, 5)
        tr = t + rng.randint(0, 3)
        du = rng.randint(1, du_max)
        jobs.append(ARRequest(t, tr, du, tr + du + rng.randint(0, slack_max),
                              rng.randint(1, n_pe)))
    return jobs


def _saturated_jobs(n_fill, n_probe, n_pe=64):
    """The reference's fill-then-reject stream (``saturated_jobs`` of
    ``benchmarks/bench_index.py``): fills of 20..31 PEs (of 64) over
    ``[1000 + 2k, 1004 + 2k)``, all admitted, then zero-slack probes of
    48 PEs inside the filled horizon, none of which fits."""
    u = n_pe // 64
    jobs, t = [], 0
    for k in range(n_fill):
        t_r = 1000 + 2 * k
        jobs.append(ARRequest(t, t_r, 4, t_r + 4, (20 + k % 12) * u))
        t += 1
    span = max(2 * n_fill - 200, 100)
    for k in range(n_probe):
        t_r = 1100 + (k * 7) % span
        jobs.append(ARRequest(t, t_r, 8, t_r + 8, 48 * u))
        t += 1
    return jobs


def _port_stream(jobs, policy, tile, n_pe, capacity, use_kernel=True,
                 stats=None):
    st = pt_tl.init_state(capacity, n_pe, 256, device="cpu",
                          index_tile=tile)
    st, dec = pt_batch.admit_stream_grow(
        st, pt_batch.requests_to_batch(jobs, "cpu"), policy, n_pe=n_pe,
        use_kernel=use_kernel, stats=stats)
    if tile is not None:
        canon = pt_ai.build_summaries(st.tl.times, st.tl.occ, st.tl.ispec)
        for got, want in zip((st.tl.idx_occ, st.tl.idx_minfree,
                              st.tl.idx_maxfree), canon):
            assert torch.equal(got, want)
    return st, dec


def _ref_stream(jobs, policy, tile, n_pe, capacity):
    st = ref_tl.init_state(capacity, n_pe, 256, index_tile=tile)
    batch = ref_batch.requests_to_batch(
        [RefRequest(j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe) for j in jobs])
    return ref_batch.admit_stream_grow(st, batch, policy, n_pe=n_pe)


def assert_decisions_equal(port_dec, ref_dec, ctx=""):
    for f in DEC_FIELDS:
        got = getattr(port_dec, f).numpy()
        want = np.asarray(getattr(ref_dec, f))
        if f == "pe_mask":
            got = pt_words.to_uint32(got)
        np.testing.assert_array_equal(got, want, err_msg=f"{ctx}:{f}")


@pytest.mark.parametrize("policy", ALL_POLICIES, ids=lambda p: p.value)
def test_indexed_stream_matches_reference_every_policy(policy):
    jobs = _jobs(70, 32, seed=7)
    _, off = _port_stream(jobs, policy, None, 32, 64)
    st, on = _port_stream(jobs, policy, 16, 32, 64)
    ref_st, ref_dec = _ref_stream(jobs, policy, 16, 32, 64)
    assert_decisions_equal(off, ref_dec, "index off")
    assert_decisions_equal(on, ref_dec, "index on")
    assert_index_equal(st.tl, ref_st.tl)


@pytest.mark.parametrize("tile", [1, 16, 64])
def test_indexed_stream_matches_reference_tiles(tile):
    """Tiles of one record, 16, and the whole timeline, on the kernel
    path (pruned) and the plain path."""
    jobs = _jobs(70, 32, seed=tile, du_max=60)
    ref_st, ref_dec = _ref_stream(jobs, Policy.PE_W, tile, 32, 64)
    for use_kernel in (True, False):
        st, dec = _port_stream(jobs, Policy.PE_W, tile, 32, 64,
                               use_kernel=use_kernel)
        assert_decisions_equal(dec, ref_dec, f"tile={tile} {use_kernel}")
        assert st.tl.capacity == ref_st.tl.capacity


def test_saturated_stream_takes_the_early_reject():
    """Every Decision field, the rejected requests' rectangle included,
    equals the index-free run and the reference's; at least 90 % of the
    probes take the early reject."""
    jobs = _saturated_jobs(120, 60)
    stats = pt_batch.StreamStats(count_candidates=True)
    _, on = _port_stream(jobs, Policy.FF, 16, 64, 64, stats=stats)
    plain = pt_batch.StreamStats()
    _, off = _port_stream(jobs, Policy.FF, None, 64, 64, stats=plain)
    _, ref_dec = _ref_stream(jobs, Policy.FF, 16, 64, 64)
    assert_decisions_equal(on, ref_dec, "on")
    assert_decisions_equal(off, ref_dec, "off")
    assert int(on.accepted.sum()) == 120
    assert stats.early_rejects >= 54, stats
    live, pruned = (int(x) for x in stats.candidates)
    assert live > 0 and 0 <= pruned <= live
    # the reject predicate rides on the release check's read: an
    # indexed step costs the same reads as an index-free one
    assert stats.host_syncs == plain.host_syncs
    # without auto-release each step reads the predicate on its own
    st = pt_tl.init_state(256, 64, 256, device="cpu", index_tile=16)
    lone = pt_batch.StreamStats()
    _, dec = pt_batch.admit_stream(
        st, pt_batch.requests_to_batch(jobs, "cpu"), Policy.FF, n_pe=64,
        auto_release=False, stats=lone)
    assert lone.host_syncs == 1 + len(jobs)
    assert lone.early_rejects == 60


def test_multires_indexed_stream_matches_reference():
    units = (32, 4, 6)
    spec, ref_spec = ResourceSpec(units), RefSpec(units)
    rng = random.Random(9)
    jobs = []
    for j in _jobs(60, 32, seed=9):
        d = (j.n_pe,) + tuple(rng.randint(0, u) for u in units[1:])
        jobs.append(ARRequest(j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe,
                              demand=d))
    st = pt_tl.init_state(64, 32, 256, device="cpu", rspec=spec,
                          index_tile=8)
    st, dec = pt_batch.admit_stream_grow(
        st, pt_batch.requests_to_batch(jobs, "cpu", extra_demand=2),
        Policy.PE_B, n_pe=32)
    rst = ref_tl.init_state(64, 32, 256, rspec=ref_spec, index_tile=8)
    rst, rdec = ref_batch.admit_stream_grow(
        rst, ref_batch.requests_to_batch(
            [RefRequest(j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe,
                        demand=j.demand) for j in jobs], extra_demand=2),
        Policy.PE_B, n_pe=32)
    assert_decisions_equal(dec, rdec, "mr")
    assert_index_equal(st.tl, rst.tl)
    got = pt_tl.state_to_numpy(st)
    for k in ("idx_occ", "idx_minfree", "idx_maxfree"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(rst.tl, k)))
    back = pt_tl.state_from_numpy(got, device="cpu", rspec=spec,
                                  ispec=st.tl.ispec)
    assert all(torch.equal(a, b) for a, b in zip(back.tl[:5], st.tl[:5]))


def test_bucketed_search_view_matches_reference():
    """A bucket that is a whole number of tiles keeps the sliced index;
    a shorter one is searched without it.  Finds equal the reference's
    bucketed engine either way."""
    jobs = _jobs(40, 16, seed=21)
    for tile in (8, 64):
        eng = DeviceEngine(16, capacity=128, device="cpu", index_tile=tile)
        ref = RefEngine(16, capacity=128, bucketing=True, index_tile=tile)
        for req in jobs:
            view, rview = eng._search_view(), ref._search_view()
            assert view.capacity == rview.capacity
            assert (view.ispec is None) == (rview.ispec is None)
            if view.ispec is not None:
                assert_index_equal(view, rview)
            a = eng.find_allocation(req, Policy.PE_W)
            b = ref.find_allocation(
                RefRequest(req.t_a, req.t_r, req.t_du, req.t_dl, req.n_pe),
                Policy.PE_W)
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.t_s, a.pe_ids, dataclasses.astuple(a.rectangle)) \
                    == (b.t_s, b.pe_ids, dataclasses.astuple(b.rectangle))
                eng.add_allocation(a.t_s, a.t_e, a.pe_ids)
                ref.add_allocation(b.t_s, b.t_e, list(b.pe_ids))
        assert eng.records() == ref.records()


@pytest.mark.parametrize("units", [(64,), (64, 8, 4, 16)],
                         ids=["R1", "R4"])
def test_pruned_start_cases_match_reference_select(units):
    """The pruned-start inputs: the plain select kernels name the
    reference's ``policies.select`` winner (index 0 when nothing is
    feasible) and the plain rectangle kernels equal the reference's
    rectangles, P = 1 included."""
    spec, ref_spec = ResourceSpec(units), RefSpec(units)
    rng = np.random.default_rng(len(units))
    lay = device_layout(spec, CPU)
    for case in cases.pruned_cases(rng, spec, None, 64):
        tl = ref_tl.Timeline(times=jnp.asarray(case.times),
                             occ=jnp.asarray(case.occ))
        starts = jnp.asarray(case.starts)
        rs = ref_spec if len(units) > 1 else None
        tail = jnp.asarray(case.demand_tail, jnp.int32)
        rects = ref_search.availability_rectangles(
            tl, starts, jnp.int32(case.t_du), jnp.int32(case.t_now),
            units[0], rspec=rs)
        feas = rects.valid & (rects.n_free >= case.n_req)
        if rs is not None:
            feas = feas & jnp.all(rects.n_free_tail >= tail[None], axis=1)
        times = torch.from_numpy(case.times)
        occ = _i32(case.occ)
        st = torch.from_numpy(case.starts)
        if rs is None:
            n_free, t_begin, t_end = pt_ref.availscan_ref(
                times, occ, st, case.t_du, case.t_now, units[0])
        else:
            n_free, ntail, t_begin, t_end = pt_ref.availscan_mr_ref(
                times, occ, st, lay.valid_mask, lay.plane_of_word, spec.R,
                case.t_du, case.t_now)
            np.testing.assert_array_equal(ntail.numpy(),
                                          np.asarray(rects.n_free_tail))
        for g, w in zip((n_free, t_begin, t_end),
                        (rects.n_free, rects.t_begin, rects.t_end)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=case.label)
        for pid in range(7):
            best, found = ref_policies.select(
                jnp.int32(pid), rects.n_free, rects.t_end - rects.t_begin,
                rects.starts, feas)
            if rs is None:
                row = pt_ref.availscan_select_ref(
                    times, occ, st, case.t_du, case.t_now, case.n_req, pid,
                    units[0])
            else:
                row = pt_ref.availscan_select_mr_ref(
                    times, occ, st, lay.valid_mask, lay.plane_of_word,
                    torch.tensor(case.demand_tail, dtype=torch.int32),
                    case.t_du, case.t_now, case.n_req, pid)
            assert (int(row[3]), bool(row[7])) == (int(best), bool(found)), \
                (case.label, pid)
            assert int(row[4]) == int(rects.n_free[int(best)])


@pytest.mark.parametrize("mode", ["easy", "conservative"])
def test_backfill_indexed_stream_matches_reference(mode):
    """Backfilling on an indexed timeline (after
    ``tests/test_availindex.py``): every Decision field and the queue
    equal the index-free run's and the reference's indexed run's."""
    jobs = _jobs(80, 32, seed=7, slack_max=80)
    runs = {}
    for tile in (None, 16):
        st = pt_tl.init_state(64, 32, 256, device="cpu", park_capacity=8,
                              index_tile=tile)
        runs[tile] = pt_batch.admit_stream_grow(
            st, pt_batch.requests_to_batch(jobs, "cpu"), Policy.PE_W,
            n_pe=32, backfill=mode)
    rst = ref_tl.init_state(64, 32, 256, park_capacity=8, index_tile=16)
    rst, rdec = ref_batch.admit_stream_grow(
        rst, ref_batch.requests_to_batch(
            [RefRequest(j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe)
             for j in jobs]), Policy.PE_W, n_pe=32, backfill=mode)
    assert_decisions_equal(runs[16][1], rdec, "on")
    assert_decisions_equal(runs[None][1], rdec, "off")
    np.testing.assert_array_equal(runs[16][1].parked.numpy(),
                                  np.asarray(rdec.parked))
    assert pt_batch.parked_entries(runs[16][0]) == \
        pt_batch.parked_entries(runs[None][0]) == \
        ref_batch.parked_entries(rst)
    assert_index_equal(runs[16][0].tl, rst.tl)
    assert int(runs[16][0].n_parked) > 0


def test_early_rejected_request_admitted_by_displacement():
    """With one-record tiles the index proves the last request
    infeasible, yet EASY admits it by displacing a parked entry: the
    early reject must not skip the transaction."""
    jobs = [ARRequest(t_a=0, t_r=0, t_du=10, t_dl=30, n_pe=4),
            ARRequest(t_a=1, t_r=1, t_du=5, t_dl=40, n_pe=4),
            ARRequest(t_a=2, t_r=2, t_du=5, t_dl=60, n_pe=4),
            ARRequest(t_a=3, t_r=3, t_du=5, t_dl=20, n_pe=4)]
    decs = {}
    for tile in (None, 1):
        stats = pt_batch.StreamStats()
        st = pt_tl.init_state(16, 4, 16, device="cpu", park_capacity=4,
                              index_tile=tile)
        out, dec = pt_batch.admit_stream_grow(
            st, pt_batch.requests_to_batch(jobs, "cpu"), Policy.FF, n_pe=4,
            backfill="easy", stats=stats)
        decs[tile] = dec
        assert dec.accepted.tolist() == [True] * 4
        assert dec.t_s.tolist() == [0, 10, 15, 15]
        assert int(out.n_moved) == 1
        assert stats.displacements == 1
    assert stats.early_rejects == 1 and stats.reject_displacements == 1
    rst = ref_tl.init_state(16, 4, 16, park_capacity=4, index_tile=1)
    rst, rdec = ref_batch.admit_stream_grow(
        rst, ref_batch.requests_to_batch(
            [RefRequest(j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe)
             for j in jobs]), Policy.FF, n_pe=4, backfill="easy")
    assert_decisions_equal(decs[1], rdec, "on")
    assert_decisions_equal(decs[None], rdec, "off")
    assert pt_batch.parked_entries(out) == ref_batch.parked_entries(rst)
