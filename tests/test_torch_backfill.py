"""The port's backfilling against the JAX package and the port's oracle.

The deferral queue of ``core/batch.py`` (park on a delayed accept,
promote when the start arrives, the EASY retry sweep armed by a cancel,
the EASY displacement transaction) runs through ``admit_stream_grow``,
the one-step ``admit`` and the reservation service.  Each run is held
bit for bit against the reference's ``admit_stream_grow`` (JAX,
``use_kernel=False``) on the same seeded stream, comparing every
``Decision`` field, the ``parked`` flags and every state array
(timeline, pending buffer, queue, counters, high-water marks), and
against the port's ``BackfillOracle`` (records, ``parked_entries`` and
the counters).  The safety invariants are checked on the device path:
conservative never moves a reservation, EASY never delays the head of
queue or a committed start.
"""
import numpy as np
import pytest

from repro.api import ReservationService as RefService
from repro.api import ServiceConfig as RefConfig
from repro.core import batch as ref_batch
from repro.core import timeline as ref_tl
from repro.core.types import ARRequest as RefRequest
from repro.sim import WorkloadParams, generate_filtered
from repro_torch.api import ReservationService, ServiceConfig
from repro_torch.core import batch as pt_batch
from repro_torch.core import timeline as pt_tl
from repro_torch.core import words as pt_words
from repro_torch.core.hostsched import BackfillOracle
from repro_torch.core.types import ALL_POLICIES, ARRequest, Policy, T_INF
from repro_torch.tenancy import TenantSpec

N_PE = 16
SIZES = dict(u_low=2.0, u_med=3.0, u_hi=4.0)
MODES = ("easy", "conservative")
# the state arrays of a one-lane reference state (no tenants, R = 1)
STATE_FIELDS = ("pend_ts", "pend_te", "pend_mask", "n_accepted",
                "n_released", "overflow", "hw_records", "hw_pending",
                "park_ts", "park_te", "park_mask", "park_tr", "park_tdl",
                "park_npe", "park_seq", "park_retry", "park_next_seq",
                "n_parked", "n_promoted", "n_moved", "hw_parked")
# the backfill keys of metrics() both services report
BF_METRICS = ("park_capacity", "n_parked_now", "n_parked", "n_promoted",
              "n_moved", "n_pending", "accepted", "cancelled")


def _workload(n_jobs, seed, load=2.0, n_pe=N_PE):
    jobs = generate_filtered(WorkloadParams(
        n_jobs=n_jobs, n_pe=n_pe, seed=seed, arrival_factor=load, **SIZES),
        max_pe=n_pe)
    return sorted(jobs, key=lambda j: j.t_a)


def _pt(jobs):
    return [ARRequest(j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe) for j in jobs]


def _ref(jobs):
    return [RefRequest(j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe) for j in jobs]


def _ref_run(jobs, policy, mode, *, Q=8, capacity=64, pending=128,
             n_pe=N_PE):
    state = ref_tl.init_state(capacity, n_pe, pending, park_capacity=Q)
    return ref_batch.admit_stream_grow(
        state, ref_batch.requests_to_batch(_ref(jobs)), policy, n_pe=n_pe,
        backfill=mode)


def _port_run(jobs, policy, mode, *, Q=8, capacity=64, pending=128,
              n_pe=N_PE, use_kernel=True, stats=None):
    state = pt_tl.init_state(capacity, n_pe, pending, device="cpu",
                             park_capacity=Q)
    return pt_batch.admit_stream_grow(
        state, pt_batch.requests_to_batch(_pt(jobs), "cpu"), policy,
        n_pe=n_pe, backfill=mode, use_kernel=use_kernel, stats=stats)


def _ref_arrays(st):
    out = {f: np.asarray(getattr(st, f)) for f in STATE_FIELDS}
    out.update(times=np.asarray(st.tl.times), occ=np.asarray(st.tl.occ))
    return out


def assert_state_equal(port, ref):
    got, want = pt_tl.state_to_numpy(port), _ref_arrays(ref)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def assert_decisions_equal(port_dec, ref_dec):
    for f in ref_batch.Decision._fields:
        got = getattr(port_dec, f).numpy()
        if f == "pe_mask":
            got = pt_words.to_uint32(got)
        np.testing.assert_array_equal(got, np.asarray(getattr(ref_dec, f)),
                                      err_msg=f)


def _records(state):
    return [(int(t), frozenset(pt_batch.mask32_to_ids(o)))
            for t, o in zip(state.tl.times.numpy(), state.tl.occ.numpy())
            if t < T_INF]


def _trace(dec):
    return [(bool(a), int(t)) for a, t in zip(dec.accepted, dec.t_s)]


def assert_matches_oracle(jobs, policy, mode, out, dec, Q=8, n_pe=N_PE):
    orc = BackfillOracle(n_pe, policy, mode, park_capacity=Q)
    ref = [orc.admit(r) for r in _pt(jobs)]
    assert _trace(dec) == [r[:2] for r in ref], (policy, mode)
    assert dec.parked.tolist() == [r[2] for r in ref], (policy, mode)
    assert _records(out) == orc.records()
    assert pt_batch.parked_entries(out) == orc.pending()
    assert (int(out.n_parked), int(out.n_promoted), int(out.n_moved)) == (
        orc.n_parked, orc.n_promoted, orc.n_moved)
    return orc


@pytest.fixture(scope="module")
def stream():
    return _workload(100, seed=3)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_stream_matches_reference_and_oracle(stream, policy, mode):
    """Every policy, both modes: decisions, parked flags and the whole
    state equal the reference's; records, queue and counters equal the
    oracle's."""
    stats = pt_batch.StreamStats()
    out, dec = _port_run(stream, policy, mode, stats=stats)
    ref_out, ref_dec = _ref_run(stream, policy, mode)
    assert_decisions_equal(dec, ref_dec)
    assert_state_equal(out, ref_out)
    orc = assert_matches_oracle(stream, policy, mode, out, dec)
    assert orc.n_parked > 0
    if mode == "conservative":
        assert orc.n_moved == 0 and stats.displacements == 0
    assert stats.retry_searches == 0      # no cancel, no sweep


@pytest.mark.parametrize("policy", [Policy.PE_W, Policy.DU_B, Policy.FF])
def test_conservative_is_decision_identical_to_none(policy):
    """Freezing parked reservations reproduces ``none`` exactly, with an
    observable queue: every parked flag marks a delayed accept."""
    jobs = _workload(150, seed=11)
    none_out, none_dec = _port_run(jobs, policy, "none", Q=0)
    cons_out, cons_dec = _port_run(jobs, policy, "conservative")
    assert _trace(cons_dec) == _trace(none_dec)
    assert _records(cons_out) == _records(none_out)
    delayed = [a and t > j.t_r for (a, t), j in zip(_trace(none_dec), jobs)]
    assert all(d for p, d in zip(cons_dec.parked.tolist(), delayed) if p)
    assert int(cons_out.n_parked) > 0 and int(cons_out.n_moved) == 0
    assert not none_dec.parked.any()


def test_none_mode_on_a_queue_state_equals_no_queue():
    """``backfill="none"`` on a state with a queue decides as a state
    without one and never parks."""
    jobs = _workload(100, seed=2)
    a_out, a_dec = _port_run(jobs, Policy.PE_W, "none", Q=8)
    b_out, b_dec = _port_run(jobs, Policy.PE_W, "none", Q=0)
    assert _trace(a_dec) == _trace(b_dec)
    assert int(a_out.n_parked) == 0 and not a_dec.parked.any()
    assert b_out.park_seq is None and pt_batch.parked_entries(b_out) == []


def test_easy_displacement_deterministic_scenario():
    """The head keeps its reservation, the non-head parked job moves
    inside its window, the otherwise rejected arrival is admitted."""
    n_pe = 4
    jobs = [ARRequest(t_a=0, t_r=0, t_du=10, t_dl=30, n_pe=4),
            ARRequest(t_a=1, t_r=1, t_du=5, t_dl=40, n_pe=4),
            ARRequest(t_a=2, t_r=2, t_du=5, t_dl=60, n_pe=4),
            ARRequest(t_a=3, t_r=3, t_du=5, t_dl=20, n_pe=4)]
    _, none_dec = _port_run(jobs, Policy.FF, "none", Q=0, n_pe=n_pe)
    assert _trace(none_dec) == [(True, 0), (True, 10), (True, 15),
                                (False, -1)]
    stats = pt_batch.StreamStats()
    out, dec = _port_run(jobs, Policy.FF, "easy", n_pe=n_pe, stats=stats)
    assert _trace(dec) == [(True, 0), (True, 10), (True, 15), (True, 15)]
    assert dec.parked.tolist() == [False, True, True, True]
    by_seq = {e["seq"]: e for e in pt_batch.parked_entries(out)}
    assert (by_seq[0]["t_s"], by_seq[1]["t_s"], by_seq[2]["t_s"]) == (
        10, 20, 15)
    assert int(out.n_moved) == 1
    assert (stats.displacements, stats.displace_searches) == (1, 2)
    ref_out, ref_dec = _ref_run(jobs, Policy.FF, "easy", n_pe=n_pe)
    assert_decisions_equal(dec, ref_dec)
    assert_state_equal(out, ref_out)
    orc = assert_matches_oracle(jobs, Policy.FF, "easy", out, dec,
                                n_pe=n_pe)
    assert orc.moves == [(1, 15, 20, False, "displace")]


def test_cancel_arms_retry_sweep_and_matches_reference():
    """A cancel arms the EASY retry sweep: on the next admit step the
    parked reservation moves strictly earlier, as in the reference's
    session and the oracle."""
    n_pe = 4
    a = ARRequest(t_a=0, t_r=0, t_du=10, t_dl=30, n_pe=4)
    b = ARRequest(t_a=1, t_r=1, t_du=5, t_dl=40, n_pe=4)     # parks @10
    e = ARRequest(t_a=2, t_r=2, t_du=1, t_dl=12, n_pe=4)
    kw = dict(n_pe=n_pe, policy=Policy.FF, capacity=64, backfill="easy",
              backfill_queue=4, chunk_size=None)
    sess = ReservationService(ServiceConfig(device="cpu", **kw)).session()
    ref = RefService(RefConfig(**kw)).session()
    orc = BackfillOracle(n_pe, Policy.FF, "easy", park_capacity=4)
    r1, ref_r1 = sess.offer([a, b]), ref.offer(_ref([a, b]))
    for req in (a, b):
        orc.admit(req)
    assert sess.pending() == ref.pending() == orc.pending()
    assert sess.pending()[0]["t_s"] == 10
    alloc_a = r1.allocations()[0]
    assert sess.cancel(alloc_a) is True
    assert ref.cancel(ref_r1.allocations()[0]) is True
    assert orc.cancel(alloc_a.t_s, alloc_a.t_e, alloc_a.pe_ids)
    r2 = sess.offer([e])
    ref.offer(_ref([e]))
    acc_e, ts_e, _ = orc.admit(e)
    # the sweep ran first: b moved 10 -> 2, then e fit at 7
    assert sess.pending() == ref.pending() == orc.pending()
    assert sess.pending()[0]["t_s"] == 2
    assert (bool(r2.decision.accepted[0]), int(r2.decision.t_s[0])) == (
        acc_e, ts_e)
    assert orc.moves[-1] == (0, 10, 2, True, "retry")
    m, ref_m = sess.metrics(), ref.metrics()
    assert m["n_moved"] == orc.n_moved == 1
    assert {k: m[k] for k in BF_METRICS} == {k: ref_m[k] for k in BF_METRICS}
    assert m["retry_searches"] == 1
    assert sess.records() == ref.records() == orc.records()


@pytest.mark.parametrize("mode", MODES)
def test_mid_stream_growth_reproduces_big_capacity_decisions(mode):
    """The grow-and-re-run protocol stays deterministic through parking,
    promotion and displacement, and the grown state is the reference's."""
    jobs = _workload(80, seed=5, load=2.5)
    stats = pt_batch.StreamStats()
    small = _port_run(jobs, Policy.PE_W, mode, capacity=8, pending=4,
                      stats=stats)
    big = _port_run(jobs, Policy.PE_W, mode, capacity=256, pending=256)
    assert _trace(small[1]) == _trace(big[1])
    assert small[1].parked.tolist() == big[1].parked.tolist()
    assert _records(small[0]) == _records(big[0])
    assert small[0].tl.capacity > 8 and small[0].pending_capacity > 4
    assert stats.growths >= 1
    ref_out, ref_dec = _ref_run(jobs, Policy.PE_W, mode, capacity=8,
                                pending=4)
    assert_decisions_equal(small[1], ref_dec)
    assert_state_equal(small[0], ref_out)


def test_queue_full_degrades_gracefully():
    """With a 1-slot queue, delayed accepts beyond it commit immovably
    (as under ``none``); decisions still match the reference and the
    oracle with the same queue."""
    jobs = _workload(150, seed=9, load=2.5)
    out, dec = _port_run(jobs, Policy.PE_W, "easy", Q=1)
    ref_out, ref_dec = _ref_run(jobs, Policy.PE_W, "easy", Q=1)
    assert_decisions_equal(dec, ref_dec)
    assert_state_equal(out, ref_out)
    assert_matches_oracle(jobs, Policy.PE_W, "easy", out, dec, Q=1)
    delayed = sum(1 for (a, t), j in zip(_trace(dec), jobs)
                  if a and t > j.t_r)
    assert delayed > int(out.n_parked) > 0


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_session_chunked_offer_identical_to_one_shot(mode, donate):
    """Ring-staged offers (eager and pipelined, a wrapped ring) admit as
    the one-shot stream does, with the reference session's queue."""
    jobs = _workload(90, seed=7)
    ref_out, ref_dec = _port_run(jobs, Policy.PE_W, mode, capacity=128,
                                 pending=256)
    kw = dict(n_pe=N_PE, policy=Policy.PE_W, capacity=64, backfill=mode,
              backfill_queue=8, chunk_size=16, ring_capacity=64,
              donate=donate)
    sess = ReservationService(ServiceConfig(device="cpu", **kw)).session()
    ref = RefService(RefConfig(**kw)).session()
    rng = np.random.RandomState(0)
    accs, tss, parks = [], [], []
    i = 0
    while i < len(jobs):
        take = int(rng.randint(1, 40))
        res = sess.offer(_pt(jobs[i:i + take]))
        ref.offer(_ref(jobs[i:i + take]))
        i += take
        if res.decision is not None:
            v = res.valid
            accs.append(res.decision.accepted.numpy()[v])
            tss.append(res.decision.t_s.numpy()[v])
            parks.append(res.decision.parked.numpy()[v])
    trace = [(bool(a), int(t)) for a, t in zip(np.concatenate(accs),
                                               np.concatenate(tss))]
    assert trace == _trace(ref_dec)
    assert np.concatenate(parks).tolist() == ref_dec.parked.tolist()
    m, ref_m = sess.metrics(), ref.metrics()
    assert m["ring_wrapped"]
    assert sess.pending() == pt_batch.parked_entries(ref_out) == \
        ref.pending()
    assert sess.records() == ref.records()
    assert {k: m[k] for k in BF_METRICS} == {k: ref_m[k] for k in BF_METRICS}


def test_cancel_reaches_parked_reservations():
    """cancel() withdraws a parked reservation and frees its queue slot;
    cancel_many reaches them too."""
    a = ARRequest(t_a=0, t_r=0, t_du=10, t_dl=30, n_pe=4)
    b = ARRequest(t_a=1, t_r=1, t_du=5, t_dl=40, n_pe=4)
    c = ARRequest(t_a=2, t_r=2, t_du=5, t_dl=60, n_pe=4)
    kw = dict(n_pe=4, policy=Policy.FF, capacity=64, backfill="easy",
              backfill_queue=4, chunk_size=None)
    sess = ReservationService(ServiceConfig(device="cpu", **kw)).session()
    ref = RefService(RefConfig(**kw)).session()
    res = sess.offer([a, b])
    ref.offer(_ref([a, b]))
    alloc_b = res.allocations()[1]
    assert alloc_b.t_s == 10 and len(sess.pending()) == 1
    assert sess.cancel(alloc_b) is True
    assert sess.pending() == []
    assert sess.cancel(alloc_b) is False       # idempotent
    assert ref.cancel(alloc_b) is True and ref.cancel(alloc_b) is False
    res = sess.offer([c])
    ref.offer(_ref([c]))
    alloc_c = res.allocations()[0]
    assert res.decision.parked.tolist() == [True]
    assert sess.cancel_many([alloc_c, alloc_c, res.allocations()[0]]) == \
        ref.cancel_many([alloc_c, alloc_c, alloc_c]) == [True, False, False]
    assert sess.pending() == ref.pending() == []
    assert sess.records() == ref.records()
    m = sess.metrics()
    assert m["cancelled"] == ref.metrics()["cancelled"] == 2
    assert m["n_parked"] == 2 and m["n_parked_now"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_committed_starts_and_head_never_delayed(mode):
    """Step the port's ``admit`` one request at a time: committed
    reservations never change, and while an entry is head of queue its
    start never increases (conservative: no queue entry ever moves)."""
    jobs = _pt(_workload(80, seed=4, load=2.5))
    state = pt_tl.init_state(64, N_PE, 128, device="cpu", park_capacity=8)
    committed = set()
    prev_head = None
    starts = {}                              # seq -> first t_s
    for req in jobs:
        state, dec = pt_batch.admit(state, req, Policy.PE_W, mode,
                                    n_pe=N_PE)
        assert not bool(state.overflow)
        pend = {(int(ts), int(te), m.numpy().tobytes())
                for ts, te, m in zip(state.pend_ts, state.pend_te,
                                     state.pend_mask) if te < T_INF}
        for ts, te, _ in committed - pend:
            assert te <= req.t_a
        committed = pend
        entries = pt_batch.parked_entries(state)
        for e in entries:
            starts.setdefault(e["seq"], e["t_s"])
            if mode == "conservative":
                assert e["t_s"] == starts[e["seq"]]
        if entries:
            head = (entries[0]["seq"], entries[0]["t_s"])
            if prev_head is not None and head[0] == prev_head[0]:
                assert head[1] <= prev_head[1]
            prev_head = head
        else:
            prev_head = None
    assert int(state.n_parked) > 0


@pytest.mark.parametrize("mode", MODES)
def test_state_round_trip_mid_stream(mode):
    """A reference state with a queue crosses to the port half-way
    through a stream (``state_from_numpy``), and both continue alike."""
    jobs = _workload(120, seed=6, load=2.5)
    first, second = jobs[:60], jobs[60:]
    ref_half, _ = _ref_run(first, Policy.PE_W, mode)
    assert ref_half.park_capacity == 8
    port_half = pt_tl.state_from_numpy(_ref_arrays(ref_half), device="cpu")
    assert_state_equal(port_half, ref_half)
    assert pt_batch.parked_entries(port_half) == ref_batch.parked_entries(
        ref_half)
    back = pt_tl.state_from_numpy(pt_tl.state_to_numpy(port_half),
                                  device="cpu")
    assert_state_equal(back, ref_half)
    ref_end, ref_dec = ref_batch.admit_stream_grow(
        ref_half, ref_batch.requests_to_batch(_ref(second)), Policy.PE_W,
        n_pe=N_PE, backfill=mode)
    port_end, dec = pt_batch.admit_stream_grow(
        port_half, pt_batch.requests_to_batch(_pt(second), "cpu"),
        Policy.PE_W, n_pe=N_PE, backfill=mode)
    assert_decisions_equal(dec, ref_dec)
    assert_state_equal(port_end, ref_end)


def test_backfill_config_one_lane_accepted_and_wider_refused():
    for mode in MODES + (("easy",),):
        cfg, ref_cfg = ServiceConfig(n_pe=8, backfill=mode), RefConfig(
            n_pe=8, backfill=mode)
        assert cfg.backfilling and cfg.park_capacity == \
            ref_cfg.park_capacity == 8
    assert ServiceConfig(n_pe=8).park_capacity == 0
    one = ReservationService(ServiceConfig(
        n_pe=8, backfill=("easy",), chunk_size=None,
        device="cpu")).session()
    r = one.offer([ARRequest(t_a=0, t_r=0, t_du=5, t_dl=20, n_pe=8)])
    assert r.n_accepted == 1 and one.metrics()["park_capacity"] == 8
    with pytest.raises(NotImplementedError, match="A15"):
        ServiceConfig(n_pe=8, n_partitions=2, chunk_size=None,
                      backfill="easy")
    # the ensemble forms (A12) run: per-lane modes, a 1-tuple of specs
    for kw in (dict(lanes=2, backfill=("easy", "none")),
               dict(tenants=(TenantSpec(),), backfill="easy")):
        sess = ReservationService(ServiceConfig(
            n_pe=8, chunk_size=None, device="cpu", **kw)).session()
        assert sess.metrics()["park_capacity"] == 8
    with pytest.raises(ValueError, match="must be a TenantSpec"):
        ServiceConfig(n_pe=8, tenants=object(), backfill="easy")
    for kw in (dict(backfill="aggressive"),
               dict(engine="host", backfill="easy"),
               dict(backfill="easy", auto_release=False),
               dict(backfill=("easy", "none")),
               dict(backfill="easy", backfill_queue=0)):
        with pytest.raises(ValueError):
            RefConfig(n_pe=8, **kw)
        with pytest.raises(ValueError):
            ServiceConfig(n_pe=8, **kw)
    with pytest.raises(ValueError, match="out of range"):
        pt_batch.as_backfill_id(5)
    with pytest.raises(ValueError, match="single lane"):
        pt_batch.as_backfill_id(("easy", "none"))
    assert [pt_batch.as_backfill_id(m) for m in ("none", "easy",
                                                 "conservative")] == [
        ref_batch.BF_NONE, ref_batch.BF_EASY, ref_batch.BF_CONSERVATIVE]
    plain = ReservationService(ServiceConfig(
        n_pe=8, chunk_size=None, device="cpu")).session()
    assert plain.pending() == []
    assert "park_capacity" not in plain.metrics()


@pytest.mark.parametrize("donate", [False, True])
def test_easy_session_with_cancels_matches_reference(donate):
    """An EASY session that cancels the queue's tail after every offer:
    the retry sweep and displacement both run, and decisions, queue,
    records and counters equal the reference session's and the oracle's,
    through a snapshot and restore mid-stream."""
    jobs = _workload(200, seed=12, load=2.5)
    kw = dict(n_pe=N_PE, policy=Policy.PE_W, capacity=64, backfill="easy",
              backfill_queue=8, chunk_size=16, ring_capacity=64,
              donate=donate)
    sess = ReservationService(ServiceConfig(device="cpu", **kw)).session()
    ref = RefService(RefConfig(**kw)).session()
    orc = BackfillOracle(N_PE, Policy.PE_W, "easy", park_capacity=8)
    got, want = [], []
    snap = None
    for k in range(0, len(jobs), 20):
        piece = jobs[k:k + 20]
        res = sess.offer(_pt(piece))
        ref_res = ref.offer(_ref(piece))
        got += [(a is not None, -1 if a is None else a.t_s)
                for a in res.allocations()]
        want += [orc.admit(r)[:2] for r in _pt(piece)]
        assert [a and (a.t_s, a.t_e, a.pe_ids) for a in res.allocations()] \
            == [a and (a.t_s, a.t_e, a.pe_ids)
                for a in ref_res.allocations()]
        if k == 100:
            snap = (sess.snapshot(), ref.snapshot(), len(got))
        tail = sess.pending()
        assert tail == ref.pending() == orc.pending()
        if tail:
            e = tail[-1]
            assert sess.cancel(t_s=e["t_s"], t_e=e["t_e"],
                               pe_ids=e["pe_ids"])
            assert ref.cancel(t_s=e["t_s"], t_e=e["t_e"], pe_ids=e["pe_ids"])
            assert orc.cancel(e["t_s"], e["t_e"], e["pe_ids"])
    assert got == want
    assert sess.records() == ref.records() == orc.records()
    m, ref_m = sess.metrics(), ref.metrics()
    assert {k: m[k] for k in BF_METRICS} == {k: ref_m[k] for k in BF_METRICS}
    moves = [mv[4] for mv in orc.moves]
    assert "retry" in moves and m["retry_searches"] > 0
    assert m["n_moved"] == orc.n_moved == len(moves)
    # restore rewinds the queue too; the replayed tail decides the same
    sess.restore(snap[0])
    ref.restore(snap[1])
    assert sess.pending() == ref.pending()
    res = sess.offer(_pt(jobs[120:160]))
    ref_res = ref.offer(_ref(jobs[120:160]))
    assert [a and (a.t_s, a.t_e) for a in res.allocations()] == \
        [a and (a.t_s, a.t_e) for a in ref_res.allocations()]
    t = jobs[159].t_a + 5
    assert sess.tick(t) == ref.tick(t)
    assert sess.pending() == ref.pending()
    assert sess.records() == ref.records()


def test_ensemble_mixed_mode_lanes_match_single_lane_sessions():
    """One ensemble with per-lane modes (none, EASY, conservative; every
    lane carries the queue) equals three one-mode runs and the
    reference's ensemble lane by lane: decisions, states, queues and the
    summed backfill counters of the sessions."""
    from repro.core import ensemble as ref_ens
    from repro_torch.core import ensemble as pt_ens

    jobs = _workload(120, seed=2)
    modes = ("none", "easy", "conservative")
    batch, valid = pt_batch.pad_streams([_pt(jobs)] * 3, N_PE, device="cpu")
    out, dec = pt_ens.admit_stream_ensemble_auto(
        pt_ens.init_ensemble(3, 64, N_PE, 128, park_capacity=8,
                             device="cpu"),
        batch, [Policy.PE_W] * 3, backfills=modes, n_pe=N_PE)
    ref_b, _ = ref_batch.pad_streams([_ref(jobs)] * 3, N_PE)
    ref_out, ref_dec = ref_ens.admit_stream_ensemble_auto(
        ref_ens.init_ensemble(3, 64, N_PE, 128, park_capacity=8), ref_b,
        [Policy.PE_W] * 3, backfills=modes, n_pe=N_PE)
    assert_decisions_equal(dec, ref_dec)
    for lane, mode in enumerate(modes):
        # lane 0 runs none on a Q = 8 state: as the reference's bid 0
        assert_state_equal(out[lane], ref_ens.member(ref_out, lane))
        one, one_dec = _port_run(jobs, Policy.PE_W, mode)
        assert _trace(one_dec) == _trace(pt_ens.lane_of(dec, lane))
        assert pt_batch.parked_entries(out[lane]) == \
            pt_batch.parked_entries(one)
    assert pt_batch.parked_entries(out[0]) == []
    kw = dict(n_pe=N_PE, lanes=3, capacity=64, chunk_size=None,
              backfill=modes, backfill_queue=8)
    ours = ReservationService(ServiceConfig(device="cpu", **kw)).session()
    theirs = RefService(RefConfig(**kw)).session()
    ours.offer([_pt(jobs)] * 3, policy=[Policy.PE_W] * 3)
    theirs.offer([_ref(jobs)] * 3, policy=[Policy.PE_W] * 3)
    m, rm = ours.metrics(), theirs.metrics()
    for k in BF_METRICS:
        if k != "n_pending":
            assert m[k] == rm[k], k
    assert m["park_capacity"] == 8 and m["n_parked"] > 0
    for lane in range(3):
        assert ours.pending(lane) == theirs.pending(lane)
    assert len(ours.pending(lane=2)) == m["n_parked_now"] - \
        len(ours.pending(lane=1))
