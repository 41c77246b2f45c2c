"""The port's multi-resource timeline against the JAX package, bit for bit.

``ResourceSpec``; the plain versions of the ``_mr`` kernels against the
Pallas kernels in interpret mode; ``search`` and ``admit_stream_grow``
with ``rspec`` against the reference's plain path (growth included, the
final state with ``lane_valid``); R = 1 parity with the single-resource
path; and the port's host oracles against the reference's.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import batch as ref_batch
from repro.core import hostsched as ref_host
from repro.core import resources as ref_res
from repro.core import search as ref_search
from repro.core import timeline as ref_tl
from repro.core.types import ARRequest as RefRequest
from repro.kernels import ops as ref_ops
from repro_torch.core import batch as pt_batch
from repro_torch.core import hostsched as pt_host
from repro_torch.core import search as pt_search
from repro_torch.core import timeline as pt_tl
from repro_torch.core import words as pt_words
from repro_torch.core.resources import ResourceSpec, device_layout
from repro_torch.core.types import ARRequest, Policy, T_INF
from repro_torch.kernels import cases as pt_cases
from repro_torch.kernels import ops as pt_ops
from repro_torch.kernels import ref as pt_ref

CPU = torch.device("cpu")
N_POLICIES = 7

# (units, live_units): the layouts the kernel tests cover
SPECS = [((32, 4, 8), None), ((40,), (33,)), ((64, 6, 3, 40), None)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are thousands of small ops, which
    extra threads only slow when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_jobs(n, rspec, seed=0, horizon=2000):
    """The reference suite's generator (tests/test_multires.py)."""
    rng = random.Random(seed)
    jobs, t = [], 0
    for _ in range(n):
        t += rng.randint(0, 6)
        n_pe = rng.randint(1, rspec.n_pe)
        du = rng.randint(1, 40)
        slack = rng.randint(0, 60)
        tail = tuple(rng.randint(0, u) for u in rspec.units[1:])
        tr = t + rng.randint(0, 5)
        jobs.append(ARRequest(
            t_a=t, t_r=tr, t_du=du, t_dl=tr + du + slack, n_pe=n_pe,
            demand=(n_pe,) + tail))
    return jobs


def _ref_jobs(jobs):
    return [RefRequest(j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe,
                       demand=j.demand) for j in jobs]


def _random_mr_timeline(rng, spec, live, capacity, n_jobs, hold=None):
    """Reference timeline of random reservations on the live units of
    every plane; ``hold`` = (plane, t_end) also keeps one unit of that
    plane busy over ``[0, t_end)``."""
    tl = ref_tl.empty(capacity, spec.n_pe, words=spec.total_words)
    valid = ref_res.ResourceSpec(spec.units).valid_bits_np(live)

    def add(tl, t_s, t_e, ids):
        bits = np.zeros(spec.total_bits, np.uint32)
        bits[ids] = 1
        tl, overflow = ref_tl.update(tl, t_s, t_e,
                                     ref_tl.pack_bits(bits[None, :])[0],
                                     is_add=True)
        assert not bool(overflow)
        return tl

    t = 0
    for _ in range(n_jobs):
        t_s = t + int(rng.integers(0, 10))
        t_e = t_s + int(rng.integers(1, 30))
        ids = []
        for r in range(spec.R):
            live_r = np.nonzero(valid[spec.bit_offset(r):
                                      spec.bit_offset(r + 1)
                                      if r + 1 < spec.R else None])[0]
            k = int(rng.integers(0, max(1, live_r.size // 2) + 1))
            ids += list(spec.bit_offset(r) + rng.choice(live_r, k,
                                                        replace=False))
        if ids:
            tl = add(tl, t_s, t_e, ids)
        t = t_s
    if hold is not None:
        plane, t_end = hold
        o = spec.bit_offset(plane)
        row = np.asarray(ref_tl.window_busy(tl, 0, t_end))
        bits = np.unpackbits(row.view(np.uint8), bitorder="little")
        free = [u for u in range(o, o + spec.units[plane]) if not bits[u]]
        tl = add(tl, 0, t_end, [free[0]])
    return tl


def _to_port(tl):
    return pt_tl.Timeline(
        times=torch.from_numpy(np.asarray(tl.times).copy()),
        occ=torch.from_numpy(pt_words.to_int32(np.asarray(tl.occ))))


def _layout(units, live):
    spec = ResourceSpec(units)
    ref_spec = ref_res.ResourceSpec(units)
    valid = torch.from_numpy(spec.valid_mask_np(live))
    ref_valid = jnp.asarray(ref_spec.valid_mask_np(live))
    return spec, ref_spec, valid, ref_valid


# ---------------------------------------------------------------------------
# ResourceSpec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("units,live", [
    ((33, 4, 64), (16, 2, 64)), ((64,), (40,)), ((1024, 128, 64, 256), None),
    ((2048, 14336), (2000, 14336)), ((1, 1, 1), None)])
def test_resource_spec_layout_matches_reference(units, live):
    ours, theirs = ResourceSpec(units), ref_res.ResourceSpec(units)
    for attr in ("units", "R", "n_pe", "words_per", "word_offsets",
                 "total_words", "total_bits"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    for r in range(ours.R):
        assert ours.plane_slice(r) == theirs.plane_slice(r)
        assert ours.bit_offset(r) == theirs.bit_offset(r)
    for lu in (None, live):
        np.testing.assert_array_equal(ours.valid_bits_np(lu),
                                      theirs.valid_bits_np(lu))
        got = ours.valid_mask_np(lu)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(pt_words.to_uint32(got),
                                      theirs.valid_mask_np(lu))
    np.testing.assert_array_equal(
        ours.plane_of_word_np(),
        np.concatenate([np.full(w, r) for r, w in
                        enumerate(theirs.words_per)]))
    full = tuple(units)
    for demand, n_pe in ((None, 1), (full, units[0]),
                         ((units[0],) + (0,) * (len(units) - 1), units[0])):
        assert ours.demand_tail(demand, n_pe) == theirs.demand_tail(
            demand, n_pe)


@pytest.mark.parametrize("call", [
    lambda m: m.ResourceSpec(()),
    lambda m: m.ResourceSpec((8, 0)),
    lambda m: m.ResourceSpec((8, 4)).valid_bits_np((8,)),
    lambda m: m.ResourceSpec((8, 4)).valid_bits_np((9, 4)),
    lambda m: m.ResourceSpec((8, 4)).valid_bits_np((8, 0)),
    lambda m: m.ResourceSpec((8, 4)).demand_tail((4, 2), 3),
    lambda m: m.ResourceSpec((8, 4)).demand_tail((3,), 3),
    lambda m: m.ResourceSpec((8, 4)).demand_tail((3, 5), 3),
    lambda m: m.ResourceSpec((8, 4)).demand_tail((3, -1), 3),
])
def test_resource_spec_validation_matches_reference(call):
    with pytest.raises(ValueError) as theirs:
        call(ref_res)
    from repro_torch.core import resources as pt_res
    with pytest.raises(ValueError) as ours:
        call(pt_res)
    assert str(ours.value) == str(theirs.value)


def test_arrequest_demand_validation():
    for kw in (dict(demand=(3, 1)), dict(demand=(2, -1)), dict(demand=())):
        with pytest.raises(ValueError):
            RefRequest(t_a=0, t_r=0, t_du=1, t_dl=2, n_pe=2, **kw)
        with pytest.raises(ValueError):
            ARRequest(t_a=0, t_r=0, t_du=1, t_dl=2, n_pe=2, **kw)
    r = ARRequest(t_a=0, t_r=0, t_du=1, t_dl=2, n_pe=2, demand=[2, 1])
    assert r.demand == (2, 1)
    # demand is keyword-only: a sixth positional argument is an error
    with pytest.raises(TypeError):
        ARRequest(0, 0, 1, 2, 2, (2, 1))


@pytest.mark.parametrize("units,live", SPECS)
def test_init_state_lane_valid_matches_reference(units, live):
    spec, ref_spec, _, _ = _layout(units, live)
    ours = pt_tl.init_state(16, spec.n_pe, 8, device="cpu", rspec=spec,
                            live_units=None if live is None
                            else live + spec.units[1:])
    theirs = ref_tl.init_state(16, spec.n_pe, 8, rspec=ref_spec,
                               live_units=None if live is None
                               else live + spec.units[1:])
    got = pt_tl.state_to_numpy(ours)
    want = _ref_state_arrays(theirs)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    back = pt_tl.state_from_numpy(got, device="cpu", rspec=spec)
    assert back.rspec == spec and torch.equal(back.lane_valid,
                                              ours.lane_valid)
    grown = pt_tl.grow_state(ours, 32, 16)
    assert grown.rspec == spec and torch.equal(grown.lane_valid,
                                               ours.lane_valid)
    assert grown.tl.occ.shape == (32, spec.total_words)
    with pytest.raises(ValueError, match="must equal n_pe"):
        pt_tl.init_state(16, spec.n_pe + 1, device="cpu", rspec=spec)
    with pytest.raises(ValueError, match="requires rspec"):
        pt_tl.init_state(16, spec.n_pe, device="cpu", live_units=(1,))


# ---------------------------------------------------------------------------
# the _mr kernels' plain versions against Pallas (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("units,live", SPECS)
def test_mr_plain_versions_match_pallas(units, live):
    spec, ref_spec, valid, ref_valid = _layout(
        units, None if live is None else live + units[1:])
    rng = np.random.default_rng(sum(units))
    ref = _random_mr_timeline(rng, spec, None if live is None
                              else live + units[1:], 32, 10,
                              hold=(spec.R - 1, 400) if spec.R > 1 else None)
    port = _to_port(ref)
    lay = device_layout(spec, CPU)
    t_r, t_du, t_dl = 3, 9, 90
    starts = pt_search.candidate_starts(port, t_r, t_du, t_dl)
    ref_starts = jnp.asarray(starts.numpy())
    want = ref_ops.availability_rectangles(
        ref, ref_starts, jnp.int32(t_du), jnp.int32(t_r - 2), spec.n_pe,
        rspec=ref_spec, valid_mask=ref_valid)
    got = pt_ops.availability_rectangles(port, starts, t_du, t_r - 2,
                                         spec.n_pe, rspec=spec,
                                         valid_mask=valid)
    for f in ("n_free", "t_begin", "t_end", "valid", "n_free_tail"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    # the jnp reference path agrees too (the Pallas form has no other
    # semantics)
    jnp_want = ref_search.availability_rectangles(
        ref, ref_starts, jnp.int32(t_du), jnp.int32(t_r - 2), spec.n_pe,
        rspec=ref_spec, valid_mask=ref_valid)
    np.testing.assert_array_equal(got.n_free_tail.numpy(),
                                  np.asarray(jnp_want.n_free_tail))
    demands = [tuple(int(rng.integers(0, u + 1)) for u in units[1:])
               for _ in range(N_POLICIES)]
    if spec.R > 1:
        # the held unit makes the full last plane infeasible everywhere
        demands.append(tuple(units[1:]))
    for i, tail in enumerate(demands):
        pid = i % N_POLICIES
        n_req = int(rng.integers(1, spec.n_pe // 2 + 1))
        tail_t = torch.tensor(tail, dtype=torch.int32)
        want = ref_ops.search_select(
            ref, ref_starts, jnp.int32(t_du), jnp.int32(t_r),
            jnp.int32(n_req), jnp.int32(pid), spec.n_pe, rspec=ref_spec,
            demand_tail=jnp.asarray(tail, jnp.int32), valid_mask=ref_valid)
        row = pt_ref.availscan_select_mr_ref(
            port.times, port.occ, starts, valid, lay.plane_of_word, tail_t,
            t_du, t_r, n_req, pid)
        sel = pt_ops.search_select(port, starts, t_du, t_r, n_req, pid,
                                   spec.n_pe, rspec=spec,
                                   demand_tail=tail_t, valid_mask=valid)
        assert torch.equal(sel["found"], row[7] > 0)
        assert (bool(row[7]), int(row[3]), int(row[4]), int(row[5]),
                int(row[6])) == (
            bool(want["found"]), int(want["best"]), int(want["n_free"]),
            int(want["t_begin"]), int(want["t_end"])), (i, tail)
        if i == N_POLICIES:
            assert not bool(want["found"])


# the CUDA select kernels' candidates per block
PER_BLOCK = 8


@pytest.mark.parametrize("kind,P", [("tie", 300), ("tie spread", 300),
                                    ("infeasible", 384), ("many tiles", 513)])
@pytest.mark.parametrize("units,live", [((64, 6, 3, 40), None),
                                        ((40,), (33,))])
def test_mr_select_matches_pallas_across_blocks(units, live, kind, P):
    """Ties, all-infeasible rows (a secondary plane short on R > 1) and
    many tiles: the plain multi-resource select names the Pallas
    kernel's winner and rectangle under every policy."""
    lu = None if live is None else live + units[1:]
    spec, ref_spec, valid, ref_valid = _layout(units, lu)
    rng = np.random.default_rng(P + len(kind) + len(units))
    if kind.startswith("tie"):
        case = pt_cases.tie_case(rng, spec, lu, 64, P, PER_BLOCK,
                                 spread=kind == "tie spread")
    elif kind == "infeasible":
        case = pt_cases.infeasible_case(rng, spec, lu, 64, P, first_live=256)
    else:
        case = pt_cases.many_tiles_case(rng, spec, lu, 64, P)
    ref = ref_tl.Timeline(times=jnp.asarray(case.times),
                          occ=jnp.asarray(case.occ))
    times = torch.from_numpy(case.times)
    occ = torch.from_numpy(pt_words.to_int32(case.occ))
    starts = torch.from_numpy(case.starts)
    plane = device_layout(spec, CPU).plane_of_word
    tail = torch.tensor(case.demand_tail, dtype=torch.int32)
    last_block = (P - 1) // PER_BLOCK * PER_BLOCK
    for pid in range(N_POLICIES):
        want = ref_ops.search_select(
            ref, jnp.asarray(case.starts), jnp.int32(case.t_du),
            jnp.int32(case.t_now), jnp.int32(case.n_req), jnp.int32(pid),
            spec.n_pe, rspec=ref_spec,
            demand_tail=jnp.asarray(case.demand_tail, jnp.int32),
            valid_mask=ref_valid)
        row = pt_ref.availscan_select_mr_ref(
            times, occ, starts, valid, plane, tail, case.t_du, case.t_now,
            case.n_req, pid)
        assert (bool(row[7]), int(row[3]), int(row[4]), int(row[5]),
                int(row[6])) == (
            bool(want["found"]), int(want["best"]), int(want["n_free"]),
            int(want["t_begin"]), int(want["t_end"])), (case.label, pid)
        best = int(row[3])
        if kind == "tie":
            assert bool(row[7]) and best >= last_block
        elif kind == "tie spread":
            assert bool(row[7]) and best < last_block
        elif kind == "infeasible":
            assert (int(row[7]), best) == (0, 256)


def test_mr_plain_versions_on_dead_candidates_and_empty_timeline():
    spec = ResourceSpec((64, 6, 3, 40))
    lay = device_layout(spec, CPU)
    tl = pt_tl.empty(16, 64, "cpu", words=spec.total_words)
    starts = torch.tensor([T_INF, 5, T_INF, 9], dtype=torch.int32)
    n_free, tail, t_begin, t_end = pt_ref.availscan_mr_ref(
        tl.times, tl.occ, starts, lay.valid_mask, lay.plane_of_word, 4, 7, 0)
    assert n_free.tolist() == [0, 64, 0, 64]
    assert tail.tolist() == [[0, 0, 0], [6, 3, 40], [0, 0, 0], [6, 3, 40]]
    assert t_begin.tolist() == [0, 0, 0, 0] and t_end.tolist() == [
        0, T_INF, 0, T_INF]
    none_live = torch.full((4,), T_INF, dtype=torch.int32)
    row = pt_ref.availscan_select_mr_ref(
        tl.times, tl.occ, none_live, lay.valid_mask, lay.plane_of_word,
        lay.zero_tail, 7, 0, 1, 0)
    assert row.tolist() == [2**31 - 1] * 4 + [0] * 4


# ---------------------------------------------------------------------------
# search and admission against the reference's plain path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("units,live", SPECS)
def test_search_mr_matches_reference(units, live, use_kernel):
    lu = None if live is None else live + units[1:]
    spec, ref_spec, valid, ref_valid = _layout(units, lu)
    rng = np.random.default_rng(len(units) + 17)
    ref = _random_mr_timeline(rng, spec, lu, 32, 10)
    port = _to_port(ref)
    for pid in range(N_POLICIES):
        t_r = int(rng.integers(0, 40))
        t_du = int(rng.integers(1, 40))
        t_dl = t_r + t_du + int(rng.integers(0, 80))
        n_req = int(rng.integers(1, spec.n_pe // 2 + 1))
        tail = tuple(int(rng.integers(0, u + 1)) for u in units[1:])
        want = ref_search.find_allocation(
            ref, jnp.int32(t_r), jnp.int32(t_du), jnp.int32(t_dl),
            jnp.int32(n_req), jnp.int32(pid), jnp.int32(t_r),
            n_pe=spec.n_pe, rspec=ref_spec,
            demand_tail=jnp.asarray(tail, jnp.int32), valid_mask=ref_valid)
        got = pt_search.search(
            port, t_r, t_du, t_dl, n_req, pid, t_r, n_pe=spec.n_pe,
            use_kernel=use_kernel, rspec=spec,
            demand_tail=torch.tensor(tail, dtype=torch.int32),
            valid_mask=valid)
        for f in ("found", "t_s", "t_e", "n_free", "t_begin", "t_end"):
            assert int(getattr(got, f)) == int(getattr(want, f)), (pid, f)
        np.testing.assert_array_equal(
            pt_words.to_uint32(got.pe_mask.numpy()),
            np.asarray(want.pe_mask), err_msg=str(pid))


def _ref_state_arrays(st):
    out = {f: np.asarray(getattr(st, f)) for f in (
        "pend_ts", "pend_te", "pend_mask", "n_accepted", "n_released",
        "overflow", "hw_records", "hw_pending", "lane_valid")}
    out.update(times=np.asarray(st.tl.times), occ=np.asarray(st.tl.occ))
    return out


@pytest.mark.parametrize("policy", [Policy.FF, Policy.PE_B, Policy.PEDU_W])
@pytest.mark.parametrize("units,live", [((32, 4, 8), None),
                                        ((40, 5), (33, 5))])
def test_admit_stream_grow_mr_matches_reference(units, live, policy):
    spec, ref_spec, _, _ = _layout(units, live)
    jobs = _random_jobs(150, spec, seed=11 + len(units))
    ref_state = ref_tl.init_state(4, spec.n_pe, 2, rspec=ref_spec,
                                  live_units=live)
    ref_out, ref_dec = ref_batch.admit_stream_grow(
        ref_state, ref_batch.requests_to_batch(
            _ref_jobs(jobs), extra_demand=spec.R - 1), policy,
        n_pe=spec.n_pe)
    stats = pt_batch.StreamStats()
    state = pt_tl.init_state(4, spec.n_pe, 2, device="cpu", rspec=spec,
                             live_units=live)
    out, dec = pt_batch.admit_stream_grow(
        state, pt_batch.requests_to_batch(jobs, "cpu", spec.R - 1), policy,
        n_pe=spec.n_pe, stats=stats)
    assert stats.growths >= 1
    for f in ref_batch.Decision._fields:
        got = getattr(dec, f).numpy()
        if f == "pe_mask":
            got = pt_words.to_uint32(got)
        np.testing.assert_array_equal(got, np.asarray(getattr(ref_dec, f)),
                                      err_msg=f)
    got = pt_tl.state_to_numpy(out)
    want = _ref_state_arrays(ref_out)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and the host oracle makes the same decisions
    oracle = pt_host.MultiResourceOracle(spec, policy, "none",
                                         live_units=live)
    assert oracle.run(jobs) == [(bool(a), int(t)) for a, t in
                                zip(dec.accepted, dec.t_s)]


def test_admit_one_and_request_struct_carry_the_demand():
    spec = ResourceSpec((16, 4))
    state = pt_tl.init_state(4, 16, 4, device="cpu", rspec=spec)
    jobs = [ARRequest(0, 0, 10, 10, 4, demand=(4, 3)),
            ARRequest(1, 1, 5, 20, 4, demand=(4, 2))]
    state, first = pt_batch.admit_one(state, jobs[0], Policy.FF, n_pe=16)
    assert first.pe_ids == (0, 1, 2, 3, 32, 33, 34)
    # only one GPU is left until t = 10: the second waits for it
    st = pt_batch.request_struct(jobs[1], extra_demand=1, device="cpu")
    assert st.demand.tolist() == [2]
    state, dec = pt_batch.admit(state, st, Policy.FF, n_pe=16)
    assert bool(dec.accepted) and int(dec.t_s) == 10
    assert pt_batch.mask32_to_ids(dec.pe_mask) == (0, 1, 2, 3, 32, 33)


# ---------------------------------------------------------------------------
# R = 1 parity and the host oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [True, False])
def test_r1_decisions_equal_the_plain_path(use_kernel):
    n_pe = 48
    rng = random.Random(7)
    jobs, t = [], 0
    for _ in range(120):
        t += rng.randint(0, 4)
        du = rng.randint(1, 30)
        jobs.append(ARRequest(t, t, du, t + du + rng.randint(0, 50),
                              rng.randint(1, n_pe)))
    for policy in (Policy.FF, Policy.PE_W, Policy.PEDU_B):
        runs = []
        for spec in (None, ResourceSpec((n_pe,))):
            state = pt_tl.init_state(32, n_pe, 32, device="cpu", rspec=spec)
            _, dec = pt_batch.admit_stream_grow(
                state, pt_batch.requests_to_batch(jobs, "cpu"), policy,
                n_pe=n_pe, use_kernel=use_kernel)
            runs.append(dec)
        for f in pt_batch.Decision._fields:
            assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), (
                policy, f)


@pytest.mark.parametrize("mode", ["none", "conservative", "easy"])
def test_multi_resource_oracle_matches_reference(mode):
    units, live = (32, 4, 8), (30, 4, 8)
    spec = ResourceSpec(units)
    jobs = _random_jobs(150, spec, seed=3)
    for policy in (Policy.FF, Policy.PE_W, Policy.DU_B):
        for lu in (None, live):
            ours = pt_host.MultiResourceOracle(spec, policy, mode,
                                               live_units=lu)
            theirs = ref_host.MultiResourceOracle(
                ref_res.ResourceSpec(units), policy, mode, live_units=lu)
            assert ours.run(jobs) == theirs.run(_ref_jobs(jobs))
            assert ours.records() == theirs.records()
            assert ours.pending() == theirs.pending()
            assert ours.moves == theirs.moves
            assert (ours.n_parked, ours.n_promoted, ours.n_moved) == (
                theirs.n_parked, theirs.n_promoted, theirs.n_moved)
            last = jobs[-1].t_a + 10_000
            ours.tick(last)
            theirs.tick(last)
            assert ours.records() == theirs.records()


def test_backfill_oracle_cancel_matches_reference():
    spec = ResourceSpec((16,))
    jobs = _random_jobs(60, spec, seed=8)
    jobs = [dataclasses.replace(j, demand=None) for j in jobs]
    ours = pt_host.BackfillOracle(16, Policy.FF, "easy")
    theirs = ref_host.BackfillOracle(16, Policy.FF, "easy")
    for j, rj in zip(jobs, _ref_jobs(jobs)):
        assert ours.admit(j) == theirs.admit(rj)
    for p in theirs.pending()[:2]:
        assert ours.cancel(p["t_s"], p["t_e"], p["pe_ids"]) == \
            theirs.cancel(p["t_s"], p["t_e"], p["pe_ids"])
    assert ours.cancel(0, 1, (0,)) is theirs.cancel(0, 1, (0,)) is False
    more = [dataclasses.replace(j, t_a=j.t_a + 3000, t_r=j.t_r + 3000,
                                t_dl=j.t_dl + 3000) for j in jobs[:20]]
    assert ours.run(more) == theirs.run(_ref_jobs(more))
    assert ours.moves == theirs.moves and ours.records() == theirs.records()


_BF_STATE_FIELDS = ("pend_ts", "pend_te", "pend_mask", "n_accepted",
                    "n_released", "overflow", "hw_records", "hw_pending",
                    "lane_valid", "park_ts", "park_te", "park_mask",
                    "park_tr", "park_tdl", "park_npe", "park_seq",
                    "park_retry", "park_next_seq", "n_parked", "n_promoted",
                    "n_moved", "hw_parked", "park_dem")


@pytest.mark.parametrize("mode", ["none", "easy", "conservative"])
def test_backfill_mr_matches_reference_and_oracle(mode):
    """Backfilling at R = 3 (after ``tests/test_multires.py``), on the
    kernel path and the plain one: decisions, parked flags and every
    state array (``park_dem`` included) equal the reference's, and the
    queue (with each entry's ``demand``), records and counters equal
    ``MultiResourceOracle``'s."""
    units = (32, 4, 8)
    spec, ref_spec = ResourceSpec(units), ref_res.ResourceSpec(units)
    jobs = _random_jobs(80, spec, seed=11)
    for policy in (Policy.FF, Policy.PEDU_W):
        rstate = ref_tl.init_state(256, 32, 256, park_capacity=8,
                                   rspec=ref_spec)
        rout, rdec = ref_batch.admit_stream_grow(
            rstate, ref_batch.requests_to_batch(_ref_jobs(jobs),
                                                extra_demand=2),
            policy, n_pe=32, backfill=mode)
        oracle = pt_host.MultiResourceOracle(spec, policy, mode,
                                             park_capacity=8)
        want = oracle.run(jobs)
        if mode != "none":
            assert oracle.n_parked > 0
        for use_kernel in (True, False):
            state = pt_tl.init_state(256, 32, 256, device="cpu",
                                     park_capacity=8, rspec=spec)
            out, dec = pt_batch.admit_stream_grow(
                state, pt_batch.requests_to_batch(jobs, "cpu", 2), policy,
                n_pe=32, backfill=mode, use_kernel=use_kernel)
            for f in ref_batch.Decision._fields:
                got = getattr(dec, f).numpy()
                if f == "pe_mask":
                    got = pt_words.to_uint32(got)
                np.testing.assert_array_equal(
                    got, np.asarray(getattr(rdec, f)), err_msg=f)
            got = pt_tl.state_to_numpy(out)
            for k in _BF_STATE_FIELDS:
                np.testing.assert_array_equal(
                    got[k], np.asarray(getattr(rout, k)), err_msg=k)
            assert want == [(bool(a), int(t)) for a, t in
                            zip(dec.accepted, dec.t_s)]
            assert pt_batch.parked_entries(out) == oracle.pending() == \
                ref_batch.parked_entries(rout)
            assert (int(out.n_parked), int(out.n_promoted),
                    int(out.n_moved)) == (oracle.n_parked,
                                          oracle.n_promoted, oracle.n_moved)


# ---------------------------------------------------------------------------
# heterogeneous ensemble lanes and the grid's resource-mix axis
# ---------------------------------------------------------------------------


def _ens_sessions(**kw):
    from repro.api import ReservationService as RefService
    from repro.api import ServiceConfig as RefConfig
    from repro_torch.api import ReservationService, ServiceConfig
    return (ReservationService(ServiceConfig(device="cpu", **kw)).session(),
            RefService(RefConfig(**kw)).session())


def _ens_decisions_equal(res, ref_res):
    for f in ref_batch.Decision._fields:
        got = getattr(res.decision, f).numpy()
        if f == "pe_mask":
            got = pt_words.to_uint32(got)
        np.testing.assert_array_equal(
            got, np.asarray(getattr(ref_res.decision, f)), err_msg=f)


def test_heterogeneous_lane_valid_mask_blocks_dead_pes():
    ours, theirs = _ens_sessions(n_pe=32, lanes=3, machine_sizes=(32, 20, 8),
                                 chunk_size=None)
    req = [ARRequest(t_a=0, t_r=0, t_du=5, t_dl=50, n_pe=16)]
    res = ours.offer([req, req, req])
    _ens_decisions_equal(res, theirs.offer([_ref_jobs(req)] * 3))
    assert res.decision.accepted[:, 0].tolist() == [True, True, False]
    for lane, size in ((0, 32), (1, 20)):
        ids = pt_batch.mask32_to_ids(res.decision.pe_mask[lane, 0])
        assert max(ids) < size and len(ids) == 16
    states = ours._backend.states
    for lane, size in enumerate((32, 20, 8)):
        np.testing.assert_array_equal(
            pt_words.to_uint32(states[lane].lane_valid.numpy()),
            np.asarray(theirs._backend.states.lane_valid[lane]))


def test_heterogeneous_lanes_with_resources():
    ours, theirs = _ens_sessions(n_pe=16, lanes=2, machine_sizes=(16, 4),
                                 resources=(16, 2), chunk_size=None)
    req = [ARRequest(t_a=0, t_r=0, t_du=5, t_dl=50, n_pe=8, demand=(8, 1))]
    res = ours.offer([req, req])
    _ens_decisions_equal(res, theirs.offer([_ref_jobs(req)] * 2))
    assert res.decision.accepted[:, 0].tolist() == [True, False]


@pytest.mark.parametrize("donate", [False, True])
def test_heterogeneous_mr_ensemble_session_matches_reference(donate):
    """A chunked R = 3 ensemble of three machine sizes, growing from a
    tiny capacity, against the reference's ensemble and each lane's
    ``MultiResourceOracle``."""
    spec = ResourceSpec((32, 4, 8))
    jobs = [dataclasses.replace(j, demand=None) if i % 3 == 0 else j
            for i, j in enumerate(_random_jobs(60, spec, seed=4))]
    sizes = (32, 24, 12)
    ours, theirs = _ens_sessions(n_pe=32, lanes=3, resources=spec.units,
                                 machine_sizes=sizes, capacity=8,
                                 pending_capacity=8, chunk_size=8,
                                 ring_capacity=16, donate=donate)
    pols = [Policy.FF, Policy.PE_W, Policy.PEDU_B]
    res = ours.offer([jobs] * 3, policy=pols)
    _ens_decisions_equal(res, theirs.offer([_ref_jobs(jobs)] * 3, policy=pols))
    assert ours.metrics()["growths"] == theirs.metrics()["growths"] >= 1
    for lane, (m, pol) in enumerate(zip(sizes, pols)):
        oracle = pt_host.MultiResourceOracle(spec, pol, "none",
                                             live_units=(m, 4, 8))
        want = oracle.run(jobs)
        v = res.valid[lane]
        got = list(zip(res.decision.accepted[lane].numpy()[v].tolist(),
                       res.decision.t_s[lane].numpy()[v].tolist()))
        assert got == want
        assert ours.records(lane) == oracle.records()


def test_machine_units_requires_rspec():
    from repro.core import ensemble as ref_ens
    from repro_torch.core import ensemble as pt_ens
    for mod, kw in ((pt_ens, dict(device="cpu")), (ref_ens, {})):
        with pytest.raises(ValueError, match="rspec"):
            mod.init_ensemble(2, 32, 16, machine_units=((16,), (8,)), **kw)
    with pytest.raises(ValueError, match="lanes"):
        pt_ens.init_ensemble(2, 32, 16, rspec=ResourceSpec((16,)),
                             machine_units=((16,),), device="cpu")


def test_ensemble_config_validation_matches_reference():
    from repro.api import ServiceConfig as RefConfig
    from repro_torch.api import ServiceConfig
    for kw, match in ((dict(n_pe=8, resources=(4, 2)), "resources"),
                      (dict(n_pe=8, engine="host", resources=(8, 2)),
                       "device"),
                      (dict(n_pe=8, lanes=2, machine_sizes=(8,)),
                       "machine_sizes"),
                      (dict(n_pe=8, lanes=2, machine_sizes=(8, 9)),
                       "machine_sizes entries")):
        with pytest.raises(ValueError, match=match):
            RefConfig(**kw)
        with pytest.raises(ValueError, match=match):
            ServiceConfig(**kw)
    het, ref_het = (cls(n_pe=8, lanes=2, machine_sizes=(8, 4))
                    for cls in (ServiceConfig, RefConfig))
    assert het.rspec.units == ref_het.rspec.units == (8,)
    assert het.machine_units == ref_het.machine_units == ((8,), (4,))


def test_grid_resource_mix_axis_cross_checked():
    from repro.sim.sweep import GridSpec as RefGridSpec
    from repro.core.types import Policy as RefPolicy
    from repro.sim.sweep import simulate_grid as ref_simulate_grid
    from repro_torch.sim.sweep import GridSpec, simulate_grid
    kw = dict(backfill_modes=("none", "easy"), arrival_factors=(1.0,),
              seeds=(0,), n_pe=32, n_jobs=40, resources=(32, 4),
              resource_mixes=(None, (1.0,)))
    res = simulate_grid(GridSpec(policies=(Policy.FF, Policy.PE_W), **kw),
                        cross_check=True, record_decisions=True,
                        device="cpu")
    ref = ref_simulate_grid(RefGridSpec(policies=(RefPolicy.FF,
                                                  RefPolicy.PE_W), **kw),
                            record_decisions=True)
    assert res.acceptance.shape == (2, 2, 1, 1, 1, 2)
    np.testing.assert_array_equal(res.n_accepted, ref.n_accepted)
    np.testing.assert_allclose(res.utilization, ref.utilization, rtol=1e-6)
    assert res.decisions == ref.decisions
    assert (res.n_accepted[..., 1] <= res.n_accepted[..., 0]).all()


def test_grid_resource_mix_requires_resources():
    from repro_torch.sim.sweep import GridSpec, simulate_grid
    with pytest.raises(ValueError, match="resources"):
        simulate_grid(GridSpec(policies=(Policy.FF,), arrival_factors=(1.0,),
                               seeds=(0,), n_jobs=5,
                               resource_mixes=((0.5,),)), device="cpu")
