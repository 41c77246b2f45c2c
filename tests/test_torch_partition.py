"""Partitioned sessions (``ServiceConfig(n_partitions > 1)``) against the
JAX package's, bit for bit.

Twins of the partition cases of ``tests/test_fleet_matching.py``,
``tests/test_service.py``, ``tests/test_backfill.py``,
``tests/test_deprecations.py`` and ``tests/test_tenancy.py``: every
routing, auto-release lanes with ``tick``, EASY lanes with ``pending``
and ``cancel``, snapshots, the availability index, and tenancy at the
router (the quota gate, the completion ledger, reaping with a grace).
Each session runs beside the reference's on the same requests:
allocations, records, lane states, loads and tenant telemetry must be
equal.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.api import ReservationService as RefService
from repro.api import ServiceConfig as RefConfig
from repro.core.types import ARRequest as RefRequest
from repro.tenancy import TenantSpec as RefSpec
from repro_torch.api import ReservationService, ServiceConfig
from repro_torch.core import timeline as pt_tl
from repro_torch.core.hostsched import FleetRoutingOracle
from repro_torch.core.types import ARRequest, Policy
from repro_torch.runtime import PartitionedCore
from repro_torch.tenancy import TenantSpec


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are thousands of small ops, which
    extra threads only slow when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(n, seed, spacing=20, dmin=50, dmax=600, slack=1.0, wmax=30,
         pemax=17, tenants=1):
    rng = np.random.default_rng(seed)
    reqs, t = [], 0
    for i in range(n):
        t += int(rng.integers(0, spacing))
        dur = int(rng.integers(dmin, dmax))
        r = t + int(rng.integers(0, wmax))
        t_dl = r + int(dur * (1.0 + slack * rng.random()))
        reqs.append(ARRequest(t_a=t, t_r=r, t_du=dur, t_dl=t_dl,
                              n_pe=int(rng.integers(1, pemax)),
                              tenant=i % tenants))
    return reqs


def _ref(reqs):
    return [RefRequest(r.t_a, r.t_r, r.t_du, r.t_dl, r.n_pe, r.tenant)
            for r in reqs]


def _key(a):
    return None if a is None else (a.t_s, a.t_e, tuple(a.pe_ids))


def _keys(res):
    return [_key(a) for a in res.allocations()]


def _ref_spec(spec):
    return RefSpec(weights=spec.weights, quotas=spec.quotas,
                   max_live=spec.max_live, grace=spec.grace)


def _pair(**kw):
    """A port session and the reference's of the same settings."""
    ref_kw = dict(kw)
    if isinstance(kw.get("tenants"), TenantSpec):
        ref_kw["tenants"] = _ref_spec(kw["tenants"])
    return (ReservationService(ServiceConfig(device="cpu", **kw)).session(),
            RefService(RefConfig(**ref_kw)).session())


def assert_sessions_equal(port, ref):
    """Records, lane states, loads and the shared metrics."""
    assert port.records() == ref.records()
    got = pt_tl.ensemble_to_numpy(port.engine.states)
    st = ref.engine.states
    for k in got:
        want = np.asarray(getattr(st.tl, k) if k in (
            "times", "occ", "idx_occ", "idx_minfree", "idx_maxfree")
            else getattr(st, k))
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    pm, rm = port.metrics(), ref.metrics()
    for k in ("offered", "accepted", "released", "reaped", "cancelled",
              "capacity", "pending_capacity", "chips_per_partition",
              "partition_load", "match_rounds", "n_parked_now", "n_parked",
              "n_promoted", "n_moved", "park_capacity", "ledger_depth"):
        assert pm.get(k) == rm.get(k), k
    if "tenants" in rm:
        for f, v in rm["tenants"].items():
            np.testing.assert_array_equal(pm["tenants"][f], np.asarray(v),
                                          err_msg=f)


# ---------------------------------------------------------------------------
# twins of the partition cases of tests/test_fleet_matching.py
# ---------------------------------------------------------------------------


def test_partition_session_auto_release_ticks_all_lanes():
    sess, ref = _pair(n_pe=32, n_partitions=2, chunk_size=None)
    reqs = [ARRequest(t_a=0, t_r=0, t_du=100, t_dl=400, n_pe=8)
            for _ in range(4)]
    res = sess.offer(reqs, routing="round_robin")
    assert _keys(res) == _keys(ref.offer(_ref(reqs), routing="round_robin"))
    assert res.n_accepted == 4
    assert sess.tick(50) == ref.tick(50) == 0
    assert sess.tick(500) == ref.tick(500) == 4     # both lanes
    assert sess.records() == []
    assert sess.metrics()["released"] == 4
    assert_sessions_equal(sess, ref)


def test_partition_session_cancel_clears_pending_slot():
    sess, ref = _pair(n_pe=32, n_partitions=2, chunk_size=None)
    r = ARRequest(t_a=0, t_r=0, t_du=100, t_dl=400, n_pe=8)
    (alloc,) = sess.offer([r], routing="round_robin").allocations()
    ref.offer(_ref([r]), routing="round_robin")
    assert sess.cancel(alloc) is True
    assert sess.cancel(alloc) is False   # slot already cleared
    assert ref.cancel(alloc) is True and ref.cancel(alloc) is False
    assert sess.tick(10_000) == 0        # nothing left to release
    assert sess.records() == []
    ref.tick(10_000)
    assert_sessions_equal(sess, ref)
    with pytest.raises(ValueError, match="global"):
        sess.cancel(alloc, lane=1)


def test_partition_session_backfills_per_lane():
    sess, ref = _pair(n_pe=32, n_partitions=2, chunk_size=None,
                      backfill="easy", backfill_queue=8)
    blockers = [ARRequest(t_a=0, t_r=0, t_du=1000, t_dl=1000, n_pe=16)
                for _ in range(2)]
    assert sess.offer(blockers, routing="round_robin").n_accepted == 2
    ref.offer(_ref(blockers), routing="round_robin")
    # infeasible before the blockers release, feasible after: parks
    late = ARRequest(t_a=1, t_r=1, t_du=50, t_dl=2000, n_pe=16)
    res = sess.offer([late], routing="best_acceptance")
    assert _keys(res) == _keys(ref.offer(_ref([late]),
                                         routing="best_acceptance"))
    assert res.n_accepted == 1           # parked counts as accepted
    m = sess.metrics()
    assert m["n_parked_now"] >= 1 and m["park_capacity"] == 8
    assert any(sess.pending(lane) for lane in (0, 1))
    for lane in (0, 1):
        assert [(e["t_s"], e["t_e"], e["pe_ids"]) for e in
                sess.pending(lane)] == [(e["t_s"], e["t_e"], e["pe_ids"])
                                        for e in ref.pending(lane)]
    assert_sessions_equal(sess, ref)
    assert sess.tick(1500) == ref.tick(1500)
    m = sess.metrics()
    assert m["n_parked_now"] == 0 and m["n_promoted"] >= 1
    assert m["dispatches"] > 0
    assert_sessions_equal(sess, ref)
    with pytest.raises(ValueError, match="out of range"):
        sess.pending(2)


def test_partition_session_best_acceptance_metrics():
    sess, ref = _pair(n_pe=64, n_partitions=4, auto_release=False,
                      chunk_size=None)
    reqs = _gen(48, seed=4)
    res = sess.offer(reqs, routing="best_acceptance")
    assert _keys(res) == _keys(ref.offer(_ref(reqs),
                                         routing="best_acceptance"))
    assert res.n_offered == 48
    m = sess.metrics()
    assert m["match_rounds"] == 0         # the fused matcher
    assert m["dispatches"] <= 3 * PartitionedCore.match_max_rounds + 1
    assert m["probe_searches"] == 4 * 48 and m["host_syncs"] > 0
    assert_sessions_equal(sess, ref)


# ---------------------------------------------------------------------------
# twins of tests/test_service.py, test_backfill.py, test_deprecations.py
# ---------------------------------------------------------------------------


def test_partition_session_routes_bulk_offers():
    reqs = [ARRequest(t_a=0, t_r=0, t_du=100, t_dl=1000, n_pe=8)
            for _ in range(6)]
    sess, ref = _pair(n_pe=32, n_partitions=2, auto_release=False,
                      chunk_size=None)
    res = sess.offer(reqs, routing="round_robin")
    allocs = res.allocations()
    assert _keys(res) == _keys(ref.offer(_ref(reqs), routing="round_robin"))
    assert sum(a is not None for a in allocs) == 6
    assert {a.pe_ids[0] // 16 for a in allocs} == {0, 1}
    assert sess.cancel(allocs[0]) is True
    assert ref.cancel(allocs[0]) is True
    assert sess.metrics()["chips_per_partition"] == 16
    assert_sessions_equal(sess, ref)
    with pytest.raises(ValueError, match="flush=False"):
        sess.offer(reqs[:1], flush=False)
    with pytest.raises(ValueError, match="unknown routing"):
        sess.offer(reqs[:1], routing="nearest")
    assert sess.offer([]).n_offered == 0


def test_partition_config_validation():
    assert ServiceConfig(n_pe=8, n_partitions=2).auto_release
    assert not ServiceConfig(n_pe=8, n_partitions=2,
                             auto_release=False).auto_release
    assert ServiceConfig(n_pe=8, n_partitions=2, chunk_size=None,
                         backfill="easy").backfilling
    for kw, match in (
            (dict(auto_release=False, auto_grow=False), "auto_grow"),
            (dict(auto_release=False, chunk_size=None, backfill="easy"),
             "auto_release"),
            (dict(chunk_size=None, backfill=("easy", "none")),
             "single name"),
            (dict(resources=(8, 2)), "resources"),
            (dict(machine_sizes=(8,)), "machine_sizes"),
            (dict(auto_release=False, chunk_size=None,
                  tenants=(TenantSpec(), TenantSpec())), "share one")):
        ref_kw = dict(kw)
        if "tenants" in kw:
            ref_kw["tenants"] = (RefSpec(), RefSpec())
        with pytest.raises(ValueError, match=match):
            RefConfig(n_pe=8, n_partitions=2, **ref_kw)
        with pytest.raises(ValueError, match=match):
            ServiceConfig(n_pe=8, n_partitions=2, **kw)


def test_route_legacy_raise_warns_then_raises():
    sess = ReservationService(ServiceConfig(
        n_pe=8, n_partitions=2, auto_release=False, chunk_size=None,
        device="cpu")).session()
    core = sess.engine
    reqs = [ARRequest(t_a=0, t_r=0, t_du=5, t_dl=20, n_pe=2)]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        lanes = core.route(reqs, "best_acceptance")
    assert len(lanes) == len(reqs)
    with pytest.warns(DeprecationWarning,
                      match="legacy_raise=True.*deprecated"):
        with pytest.raises(ValueError, match="best_acceptance"):
            core.route(reqs, "best_acceptance", legacy_raise=True)


# ---------------------------------------------------------------------------
# every routing, snapshots, the index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("routing", ["round_robin", "least_loaded",
                                     "best_acceptance"])
@pytest.mark.parametrize("backfill", ["none", "easy", "conservative"])
def test_auto_release_sessions_equal_the_reference(routing, backfill):
    """Offers of 25 with a tick between them, a cancel of a held
    reservation and a snapshot / restore / re-offer, every lane array
    compared after each verb."""
    sess, ref = _pair(n_pe=64, n_partitions=4, capacity=16,
                      chunk_size=None, backfill=backfill, backfill_queue=4,
                      routing=routing)
    reqs = _gen(100, seed=41, spacing=6, slack=1.5)
    held = []
    for k in range(3):
        piece = reqs[k * 25:(k + 1) * 25]
        res = sess.offer(piece)
        assert _keys(res) == _keys(ref.offer(_ref(piece)))
        held += [a for a in res.allocations() if a is not None]
        t = piece[-1].t_a + 100
        assert sess.tick(t) == ref.tick(t)
        assert_sessions_equal(sess, ref)
    late = [a for a in held if a.t_e > reqs[74].t_a + 100]
    assert late, "no reservation left to cancel"
    assert sess.cancel(late[-1]) == ref.cancel(late[-1])
    assert_sessions_equal(sess, ref)
    snap, ref_snap = sess.snapshot(), ref.snapshot()
    piece = reqs[75:]
    first = _keys(sess.offer(piece))
    assert first == _keys(ref.offer(_ref(piece)))
    sess.restore(snap)
    ref.restore(ref_snap)
    assert _keys(sess.offer(piece)) == first
    ref.offer(_ref(piece))
    assert_sessions_equal(sess, ref)


def _saturated(n_slots=20, n_probe=40, E=4):
    """Every lane filled with alternating 10 / 11-PE rows (records that
    do not merge), then zero-slack probes the index can refuse."""
    fills = [ARRequest(t_a=0, t_r=100 * k, t_du=100, t_dl=100 * k + 100,
                       n_pe=10 + k % 2) for k in range(n_slots)
             for _ in range(E)]
    probes = [ARRequest(t_a=1, t_r=100 * (k % 8) + 10, t_du=1000,
                        t_dl=100 * (k % 8) + 1010, n_pe=8 + k % 5)
              for k in range(n_probe)]
    return fills + probes


@pytest.mark.parametrize("routing", ["round_robin", "least_loaded",
                                     "best_acceptance"])
def test_indexed_partitions_decide_as_without_the_index(routing):
    reqs = _saturated()
    plain = ReservationService(ServiceConfig(
        n_pe=64, n_partitions=4, capacity=64, chunk_size=None,
        auto_release=False, device="cpu")).session()
    sess, ref = _pair(n_pe=64, n_partitions=4, capacity=64, chunk_size=None,
                      auto_release=False, index_tile=8)
    want = _keys(plain.offer(reqs, routing=routing))
    assert _keys(sess.offer(reqs, routing=routing)) == want
    assert _keys(ref.offer(_ref(reqs), routing=routing)) == want
    m = sess.metrics()
    # the commits' early rejects; with best acceptance the [N, E]
    # probe's too
    assert m["early_rejects"] > 0
    assert (m["probe_rejects"] > 0) == (routing == "best_acceptance")
    assert_sessions_equal(sess, ref)
    if routing == "best_acceptance":
        assert want == [_key(a) for a in FleetRoutingOracle(64, 4)
                        .admit_batch(reqs, Policy.PE_W)]


# ---------------------------------------------------------------------------
# tenancy at the router (twin of tests/test_tenancy.py's partition case)
# ---------------------------------------------------------------------------


def test_partition_sessions_gate_route_and_reap():
    spec = TenantSpec(weights=(1.0, 1.0), quotas=(40.0, None),
                      max_live=(None, 2), grace=2)
    sess, ref = _pair(n_pe=8, n_partitions=2, auto_release=False,
                      chunk_size=None, tenants=spec)
    reqs = [ARRequest(t_a=i, t_r=i, t_du=10, t_dl=i + 30, n_pe=2,
                      tenant=i % 2) for i in range(8)]
    res = sess.offer(reqs)
    assert _keys(res) == _keys(ref.offer(_ref(reqs)))
    m = sess.metrics()
    snap = m["tenants"]
    assert snap["n_quota_rejected"].sum() > 0
    assert (snap["live"] <= np.asarray([100, 2])).all()
    assert m["ledger_depth"] == int(snap["live"].sum())
    assert_sessions_equal(sess, ref)
    live_before = int(snap["live"].sum())
    reaped = sess.tick(200)
    assert reaped == live_before == ref.tick(200)
    snap = sess.metrics()["tenants"]
    assert int(snap["live"].sum()) == 0
    assert int(snap["n_reaped"].sum()) == reaped
    assert sess.metrics(tenant=1)["n_reaped"] == \
        ref.metrics(tenant=1)["n_reaped"]
    assert_sessions_equal(sess, ref)
    with pytest.raises(ValueError, match="out of range"):
        sess.offer([ARRequest(t_a=99, t_r=99, t_du=5, t_dl=200, n_pe=1,
                              tenant=5)])


@pytest.mark.parametrize("routing", ["round_robin", "best_acceptance"])
@pytest.mark.parametrize("auto_release", [False, True])
def test_tenanted_partitions_equal_the_reference(routing, auto_release):
    """Skewed quotas and a live cap over offers of 20: the gate, the
    ledger (released with the lanes on auto-release, reaped with the
    grace otherwise), cancels and snapshots."""
    reqs = _gen(80, seed=47, spacing=10, slack=1.0, tenants=3)
    spec = TenantSpec(weights=(1.0, 2.0, 1.0), quotas=(9000.0, None, 4000.0),
                      max_live=(None, 3, None), grace=50)
    sess, ref = _pair(n_pe=64, n_partitions=4, capacity=16, chunk_size=None,
                      auto_release=auto_release, tenants=spec,
                      routing=routing)
    snap = ref_snap = None
    for k in range(4):
        piece = reqs[k * 20:(k + 1) * 20]
        res = sess.offer(piece)
        assert _keys(res) == _keys(ref.offer(_ref(piece)))
        if k == 1:
            held = [a for a in res.allocations() if a is not None]
            assert sess.cancel(held[-1]) == ref.cancel(held[-1])
            snap, ref_snap = sess.snapshot(), ref.snapshot()
        t = piece[-1].t_a
        assert sess.tick(t) == ref.tick(t)
        assert_sessions_equal(sess, ref)
    m = sess.metrics()
    assert m["tenants"]["n_quota_rejected"].sum() > 0
    assert (m["tenants"]["n_reaped"].sum() > 0) == (not auto_release)
    sess.restore(snap)
    ref.restore(ref_snap)
    piece = reqs[40:60]
    assert _keys(sess.offer(piece)) == _keys(ref.offer(_ref(piece)))
    assert_sessions_equal(sess, ref)
