"""The port's reservation service against the JAX package's, bit for bit.

One-shot and chunked sessions (ring wrap, ``flush=False`` staging, a
final partial chunk of filler, growth inside a chunk, ``tick``) on
plain, multi-resource and heterogeneous-lane configs: the same
allocations, records and counters as ``repro.api`` with the same
config, on the eager chunk loop (``donate=False``) and on the pipelined
one (``donate=True``, the default), terminal growth failure included.
Then ``cancel`` / ``cancel_many``, ``snapshot`` / ``restore``, the host
and list engines, ``metrics()``, ``ServiceConfig`` validation, the
settings the port does not run yet, and demand checks that reject
before any mutation.  Ensemble sessions (``lanes > 1``): each lane as
its one-lane session and every field as the reference's ensemble, on
both chunk loops, with filler, cancels by lane, ``flush=False``
staging and snapshots.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

from repro.api import ReservationService as RefService
from repro.api import ServiceConfig as RefConfig
from repro.core import batch as ref_batch
from repro.core.types import ARRequest as RefRequest
from repro.tenancy import TenantSpec as RefTenantSpec
from repro_torch.api import ReservationService, ServiceConfig
from repro_torch.api import service as pt_service
from repro_torch.core import batch as pt_batch
from repro_torch.core import hostsched as pt_host
from repro_torch.core import words as pt_words
from repro_torch.core.resources import ResourceSpec
from repro_torch.core.types import ARRequest, Policy
from repro_torch.tenancy import TenantSpec

# counters and geometry both services report
METRICS = ("offered", "accepted", "released", "chunks", "growths",
           "one_shot_scans", "capacity", "pending_capacity", "n_pending",
           "ring_capacity", "ring_staged", "ring_wrapped", "engine", "n_pe",
           "lanes", "n_partitions", "chunk_size", "backfill")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are thousands of small ops, which
    extra threads only slow when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jobs(n, units, seed):
    """Random arrival-ordered requests, half of them with a demand."""
    rng = random.Random(seed)
    jobs, t = [], 0
    for i in range(n):
        t += rng.randint(0, 5)
        n_pe = rng.randint(1, units[0])
        du = rng.randint(1, 40)
        tr = t + rng.randint(0, 4)
        demand = None
        if len(units) > 1 and i % 2:
            demand = (n_pe,) + tuple(rng.randint(0, u) for u in units[1:])
        jobs.append(ARRequest(t, tr, du, tr + du + rng.randint(0, 60), n_pe,
                              demand=demand))
    return jobs


def _ref(jobs):
    return [RefRequest(j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe, j.tenant,
                       demand=j.demand) for j in jobs]


def _sessions(donate=False, **kw):
    """The port's session and the reference's with the same config.

    ``donate`` picks the chunk loop of both: eager (``False``) or
    pipelined (``True``).  They decide the same, but the pipelined loop
    counts a growth found while replaying a chunk once more.
    """
    ours = ReservationService(ServiceConfig(device="cpu", donate=donate,
                                            **kw)).session()
    theirs = RefService(RefConfig(donate=donate, **kw)).session()
    return ours, theirs


def _alloc_tuples(res):
    return [None if a is None else (a.t_s, a.t_e, tuple(a.pe_ids),
                                    dataclasses.astuple(a.rectangle))
            for a in res.allocations()]


def _assert_same(ours, theirs, res, ref_res):
    assert _alloc_tuples(res) == _alloc_tuples(ref_res)
    assert (res.n_offered, res.n_accepted) == (ref_res.n_offered,
                                               ref_res.n_accepted)
    assert ours.records() == theirs.records()


def _assert_metrics(ours, theirs):
    m, rm = ours.metrics(), theirs.metrics()
    for k in METRICS:
        assert m.get(k) == rm.get(k), k


CONFIGS = {
    "plain": dict(n_pe=32),
    "r3": dict(n_pe=32, resources=(32, 4, 8)),
    "r4_heterogeneous": dict(n_pe=40, resources=(40, 6, 3, 40),
                             machine_sizes=(33,)),
    "r1_machine_size": dict(n_pe=24, machine_sizes=(20,)),
}


@pytest.mark.parametrize("name", ["r3", "r1_machine_size"])
def test_one_shot_session_matches_reference(name):
    kw = CONFIGS[name]
    units = kw.get("resources", (kw["n_pe"],))
    jobs = _jobs(80, units, seed=len(name))
    ours, theirs = _sessions(chunk_size=None, capacity=8, **kw)
    for policy in (None, Policy.FF, "Du_W"):
        piece = jobs[:40] if policy is None else jobs[40:60] \
            if policy == Policy.FF else jobs[60:]
        _assert_same(ours, theirs, ours.offer(piece, policy=policy),
                     theirs.offer(_ref(piece), policy=policy))
    _assert_metrics(ours, theirs)
    assert ours.metrics()["one_shot_scans"] == 3
    # an empty offer decides nothing and counts nothing
    assert ours.offer([]).allocations() == []


@pytest.mark.parametrize("name", ["plain", "r4_heterogeneous"])
def test_chunked_session_matches_reference(name):
    """Ring wrap, growth inside a chunk, ``flush=False`` staging, a
    final partial chunk of filler, and ``tick`` between offers."""
    kw = CONFIGS[name]
    units = kw.get("resources", (kw["n_pe"],))
    jobs = _jobs(110, units, seed=5)
    ours, theirs = _sessions(chunk_size=8, ring_capacity=16, capacity=4,
                             pending_capacity=4, **kw)
    cuts = [0, 13, 13, 30, 57, 70, 101, 110]
    for k, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
        flush = k % 2 == 1
        piece = jobs[lo:hi]
        _assert_same(ours, theirs, ours.offer(piece, flush=flush),
                     theirs.offer(_ref(piece), flush=flush))
        _assert_metrics(ours, theirs)
        if hi < len(jobs):
            t = jobs[hi].t_a
            assert ours.tick(t) == theirs.tick(t)
    _assert_same(ours, theirs, ours.flush(), theirs.flush())
    m = ours.metrics()
    assert m["ring_wrapped"] and m["growths"] >= 1 and m["released"] > 0
    assert m["ring_staged"] == 0
    _assert_metrics(ours, theirs)
    assert ours.tick(10**6) == theirs.tick(10**6)
    assert ours.records() == theirs.records() == []
    # the session's own cost accounting: every admit step of every chunk
    assert m["steps"] >= m["chunks"] * 8 and m["host_syncs"] > m["steps"]


def test_flush_false_stages_the_remainder_and_filler_never_releases_early():
    ours, theirs = _sessions(n_pe=8, chunk_size=4, ring_capacity=8)
    # one job holds the machine until 10; the staged job arrives at 12
    jobs = [ARRequest(0, 0, 10, 10, 8), ARRequest(1, 1, 5, 30, 8),
            ARRequest(2, 2, 1, 40, 1), ARRequest(3, 3, 1, 50, 1),
            ARRequest(12, 12, 5, 17, 8)]
    res = ours.offer(jobs, flush=False)
    ref = theirs.offer(_ref(jobs), flush=False)
    _assert_same(ours, theirs, res, ref)
    assert ours.metrics()["ring_staged"] == 1
    _assert_same(ours, theirs, ours.flush(), theirs.flush())
    _assert_metrics(ours, theirs)


def test_auto_grow_false_raises_and_keeps_the_ring():
    jobs = [ARRequest(i, i, 5000, i + 5000, 1) for i in range(30)]
    kw = dict(n_pe=16, capacity=8, pending_capacity=4, auto_grow=False,
              chunk_size=8, ring_capacity=16, resources=(16, 2))
    ours, theirs = _sessions(**kw)
    with pytest.raises(RuntimeError, match="overflowing"):
        ours.offer(jobs)
    with pytest.raises(RuntimeError, match="overflowing"):
        theirs.offer(_ref(jobs))
    _assert_metrics(ours, theirs)
    m = ours.metrics()
    assert m["growths"] == 0 and m["ring_staged"] > 0
    assert (m["capacity"], m["pending_capacity"]) == (8, 4)
    assert ours.records() == theirs.records()


def test_demands_are_checked_before_any_mutation():
    plain = ReservationService(ServiceConfig(n_pe=8, device="cpu")).session()
    with pytest.raises(ValueError, match="single-resource"):
        plain.offer([ARRequest(0, 0, 1, 5, 2), ARRequest(1, 1, 1, 5, 2,
                                                         demand=(2, 1))])
    mr = ReservationService(ServiceConfig(
        n_pe=8, resources=(8, 2), device="cpu")).session()
    for bad in ((2, 3), (2, 1, 1)):
        with pytest.raises(ValueError, match="demand"):
            mr.offer([ARRequest(0, 0, 1, 5, 2),
                      ARRequest(1, 1, 1, 5, 2, demand=bad)])
    for s in (plain, mr):
        m = s.metrics()
        assert (m["offered"], m["ring_staged"], m["chunks"]) == (0, 0, 0)
        assert s.records() == []
    # arrival order is checked across offers, atomically
    mr.offer([ARRequest(5, 5, 1, 9, 1)])
    with pytest.raises(ValueError, match="arrival-ordered"):
        mr.offer([ARRequest(6, 6, 1, 9, 1), ARRequest(4, 4, 1, 9, 1)])
    assert mr.metrics()["offered"] == 1


def test_three_operations_take_global_unit_ids():
    ours, theirs = _sessions(n_pe=8, resources=(8, 2), chunk_size=None)
    for s in (ours, theirs):
        s.add_allocation(0, 10, [0, 1, 32])
    req = ARRequest(0, 0, 5, 30, 7, demand=(7, 2))
    got = ours.find_allocation(req)
    want = theirs.find_allocation(_ref([req])[0])
    assert (got.t_s, got.pe_ids) == (want.t_s, want.pe_ids) == (
        10, (0, 1, 2, 3, 4, 5, 6, 32, 33))
    for s in (ours, theirs):
        s.delete_allocation(0, 10, [0, 1, 32])
    assert ours.records() == theirs.records() == []
    with pytest.raises(ValueError, match="out of range"):
        ours.add_allocation(0, 10, [64])


def test_prepacked_batch_only_on_one_shot_sessions():
    jobs = _jobs(20, (16, 4), seed=2)
    one = ReservationService(ServiceConfig(
        n_pe=16, resources=(16, 4), chunk_size=None,
        device="cpu")).session()
    batch = pt_batch.requests_to_batch(jobs, "cpu", extra_demand=1)
    res = one.offer(batch)
    ref = RefService(RefConfig(n_pe=16, resources=(16, 4),
                               chunk_size=None)).session()
    assert _alloc_tuples(res) == _alloc_tuples(ref.offer(_ref(jobs)))
    ring = ReservationService(ServiceConfig(
        n_pe=16, resources=(16, 4), device="cpu")).session()
    with pytest.raises(ValueError, match="bypasses the ring"):
        ring.offer(batch)
    with pytest.raises(ValueError, match="one-shot"):
        one.offer(jobs, flush=False)
    with pytest.raises(ValueError, match="partitioned"):
        ring.offer(jobs, routing="round_robin")


@pytest.mark.parametrize("kw", [
    dict(n_pe=0), dict(n_pe=8, engine="gpu"), dict(n_pe=8, lanes=0),
    dict(n_pe=8, lanes=2, n_partitions=2), dict(n_pe=8, engine="host", lanes=2),
    dict(n_pe=10, n_partitions=3), dict(n_pe=8, routing="nearest"),
    dict(n_pe=8, chunk_size=0), dict(n_pe=8, chunk_size=64, ring_capacity=8),
    dict(n_pe=8, capacity=1), dict(n_pe=8, pending_capacity=0),
    dict(n_pe=8, max_growths=-1), dict(n_pe=8, backfill="sometimes"),
    dict(n_pe=8, backfill=("none", "easy")),
    dict(n_pe=8, backfill="easy", auto_release=False),
    dict(n_pe=8, engine_kwargs={"candidate_chunk": 4}),
    dict(n_pe=8, resources=(4, 2)), dict(n_pe=8, resources=(8, 0)),
    dict(n_pe=8, resources=(8, 2), engine="host"),
    dict(n_pe=8, machine_sizes=(9,)), dict(n_pe=8, machine_sizes=(4, 4)),
    dict(n_pe=8, index_tile=3), dict(n_pe=8, capacity=24, index_tile=16),
    dict(n_pe=8, n_partitions=2, auto_grow=False),
])
def test_config_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        RefConfig(**kw)
    with pytest.raises(ValueError):
        ServiceConfig(**kw)


@pytest.mark.parametrize("kw,item", [
    (dict(lanes=2), None), (dict(n_partitions=2), "A15"),
    (dict(lanes=2, backfill=("easy", "none")), None),
    (dict(n_partitions=2, chunk_size=None, backfill="conservative"), "A15"),
    (dict(tenants=(TenantSpec(weights=(1.0, 2.0)),)), None),
    (dict(lanes=2, machine_sizes=(8, 6)), None),
    (dict(n_partitions=2, chunk_size=None, auto_release=False,
          tenants=TenantSpec(weights=(1.0, 2.0))), "A15"),
])
def test_settings_not_ported_yet_raise(kw, item):
    """No setting is left unported: ``item`` names the ROADMAP item that
    ported it (``None``: the ensemble settings of A12).  Every setting
    opens a session; the partition settings (A15) run one offer beside
    the reference's, with the same allocations and records."""
    cfg = ServiceConfig(n_pe=8, device="cpu", **kw)
    sess = ReservationService(cfg).session()
    assert sess.metrics()["lanes"] == cfg.lanes
    if item is None:
        return
    ref_kw = dict(kw)
    if "tenants" in kw:
        ref_kw["tenants"] = RefTenantSpec(weights=kw["tenants"].weights)
    ref = RefService(RefConfig(n_pe=8, **ref_kw)).session()
    jobs = [ARRequest(t_a=i, t_r=i, t_du=20, t_dl=i + 30, n_pe=3,
                      tenant=i % 2) for i in range(6)]
    got = [(a.t_s, a.pe_ids) if a else None
           for a in sess.offer(jobs).allocations()]
    want = [(a.t_s, a.pe_ids) if a else None for a in ref.offer(
        [RefRequest(j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe, j.tenant)
         for j in jobs]).allocations()]
    assert got == want and any(got) and not all(got)
    assert sess.records() == ref.records()
    assert sess.metrics()["n_partitions"] == 2


def test_config_properties_match_reference():
    for kw in (dict(n_pe=8), dict(n_pe=8, resources=(8, 2, 3)),
               dict(n_pe=8, machine_sizes=(5,)),
               dict(n_pe=8, resources=(8, 2), machine_sizes=(6,))):
        ours, theirs = ServiceConfig(**kw), RefConfig(**kw)
        spec, ref_spec = ours.rspec, theirs.rspec
        assert (spec is None) == (ref_spec is None)
        if spec is not None:
            assert spec.units == ref_spec.units
        assert ours.extra_demand == theirs.extra_demand
        assert ours.machine_units == theirs.machine_units
        assert ours.backfilling == theirs.backfilling
        assert ours.replace(capacity=64).capacity == 64
    assert ServiceConfig(n_pe=8, policy="PEDu_B").policy is Policy.PEDU_B
    assert ServiceConfig(n_pe=8).donate is RefConfig(n_pe=8).donate is True
    for kw in (dict(index_tile=16), dict(engine="host"),
               dict(engine="list", engine_kwargs=None)):
        assert ServiceConfig(n_pe=8, **kw).replace() == ServiceConfig(
            n_pe=8, **kw)
    # placement is ported: the reference's default and its values
    assert ServiceConfig(n_pe=8).placement == RefConfig(n_pe=8).placement
    for pl in (None, "single", "host", "auto", 2):
        assert ServiceConfig(n_pe=8, placement=pl).placement == \
            RefConfig(n_pe=8, placement=pl).placement == pl


def _ring_rows(ring):
    """The staged requests of a ring, oldest first."""
    return [tuple(int(ring._buf[f][(ring._head + i) % ring.capacity])
                  for f in ring._fields) for i in range(ring.count)]


@pytest.mark.parametrize("name", ["plain", "r4_heterogeneous"])
def test_pipelined_session_matches_reference_pipelined(name):
    """``donate=True`` on both: deferred results, growth found while
    replaying a chunk, and the counters of the reference's pipelined
    loop (not its eager one)."""
    kw = CONFIGS[name]
    units = kw.get("resources", (kw["n_pe"],))
    jobs = _jobs(110, units, seed=5)
    ours, theirs = _sessions(donate=True, chunk_size=8, ring_capacity=16,
                             capacity=4, pending_capacity=4, **kw)
    cuts = [0, 13, 30, 57, 70, 101, 110]
    pending = []
    for k, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
        piece = jobs[lo:hi]
        pending.append((ours.offer(piece, flush=k % 2 == 1),
                        theirs.offer(_ref(piece), flush=k % 2 == 1)))
        if k % 2:
            # two offers in flight: one host read settles both unless
            # a latch was set (then the replay reads as the eager path)
            assert len(ours._backend._inflight) == 2
            syncs = ours._backend.stats.host_syncs
            growths = ours._backend.counters["growths"]
            for res, ref_res in pending:
                _assert_same(ours, theirs, res, ref_res)
            assert not ours._backend._inflight
            if ours._backend.counters["growths"] == growths:
                assert ours._backend.stats.host_syncs == syncs + 1
            pending = []
            _assert_metrics(ours, theirs)
    _assert_same(ours, theirs, ours.flush(), theirs.flush())
    m = ours.metrics()
    assert m["growths"] >= 2 and m["ring_wrapped"]
    _assert_metrics(ours, theirs)


def test_pipelined_and_eager_count_growths_as_the_reference_does():
    """The same stream on both loops of both packages: equal decisions,
    and each loop's growth count equals the reference's for that loop."""
    jobs = _jobs(90, (32,), seed=11)
    got = {}
    for donate in (False, True):
        ours, theirs = _sessions(donate=donate, n_pe=32, chunk_size=8,
                                 ring_capacity=64, capacity=2,
                                 pending_capacity=2)
        res, ref_res = ours.offer(jobs), theirs.offer(_ref(jobs))
        _assert_same(ours, theirs, res, ref_res)
        _assert_metrics(ours, theirs)
        got[donate] = (_alloc_tuples(res), ours.metrics()["growths"])
    assert got[False][0] == got[True][0]


def test_pipelined_terminal_growth_error_restages_the_ring():
    """Growth runs out while the drain replays: the error surfaces on
    the first result read, the earlier offer stands, and the undecided
    requests are back in the ring in the reference's order (on a
    multi-tenant session with their tenant column)."""
    jobs = [ARRequest(i, i, 5000, i + 5000, 1) for i in range(30)]
    kw = dict(n_pe=64, capacity=4, pending_capacity=4, max_growths=1,
              chunk_size=16, ring_capacity=64)
    batch_fields = pt_batch.REQ_FIELDS
    ours, theirs = _sessions(donate=True, **kw)
    first = (ours.offer(jobs[:2]), theirs.offer(_ref(jobs[:2])))
    second = (ours.offer(jobs[2:], flush=False),
              theirs.offer(_ref(jobs[2:]), flush=False))
    with pytest.raises(pt_batch.GrowthError, match="overflowing"):
        second[0].allocations()
    with pytest.raises(ref_batch.GrowthError, match="overflowing"):
        second[1].allocations()
    assert _alloc_tuples(first[0]) == _alloc_tuples(first[1])
    assert len(_alloc_tuples(first[0])) == 2
    assert _alloc_tuples(second[0]) == _alloc_tuples(second[1]) == []
    ring, ref_ring = ours._backend.ring, theirs._backend.ring
    assert _ring_rows(ring) == _ring_rows(ref_ring)
    assert len(_ring_rows(ring)) == 28
    assert ring.last_popped_t_a == ref_ring.last_popped_t_a
    assert ours.records() == theirs.records()
    _assert_metrics(ours, theirs)
    # the session stays usable on the rolled-back state
    assert ours.tick(10**6) == theirs.tick(10**6)
    assert ours.records() == theirs.records()
    # a multi-tenant session restages each request's tenant column too
    spec = TenantSpec(weights=(1.0, 2.0, 1.0))
    ours = ReservationService(ServiceConfig(
        device="cpu", donate=True, tenants=spec, **kw)).session()
    theirs = RefService(RefConfig(donate=True, tenants=RefTenantSpec(
        weights=spec.weights), **kw)).session()
    tjobs = [dataclasses.replace(j, tenant=i % 3) for i, j in enumerate(jobs)]
    ours.offer(tjobs[:2]), theirs.offer(_ref(tjobs[:2]))
    second = (ours.offer(tjobs[2:], flush=False),
              theirs.offer(_ref(tjobs[2:]), flush=False))
    with pytest.raises(pt_batch.GrowthError, match="overflowing"):
        second[0].allocations()
    with pytest.raises(ref_batch.GrowthError, match="overflowing"):
        second[1].allocations()
    ring, ref_ring = ours._backend.ring, theirs._backend.ring
    assert ring._fields == ref_ring._fields == batch_fields + ("tenant",)
    assert _ring_rows(ring) == _ring_rows(ref_ring)
    assert [r[5] for r in _ring_rows(ring)] == [i % 3 for i in range(2, 30)]
    assert ours.metrics()["tenants"]["live"].tolist() == \
        theirs.metrics()["tenants"]["live"].tolist()


@pytest.mark.parametrize("backfill", ["none", "easy"])
def test_pipelined_terminal_growth_error_restages_the_ring_mr(backfill):
    """The restage above on a multi-resource session (the reference
    cannot run it: its restage reads ``demand1`` off the batch): the
    ring holds the R = 1 session's rows plus each request's demand
    columns, and re-offered on a larger session it decides as
    ``MultiResourceOracle``."""
    units = (64, 4, 64)
    jobs = [ARRequest(i, i, 5000, i + 5000, 1,
                      demand=(1, i % 2, i % 5)) for i in range(30)]
    kw = dict(n_pe=64, capacity=4, pending_capacity=4, max_growths=1,
              chunk_size=16, ring_capacity=64, donate=True,
              backfill=backfill, device="cpu")
    rings = {}
    for spec in ((64,), units):
        mr = len(spec) > 1
        sess = ReservationService(ServiceConfig(
            resources=spec if mr else None, **kw)).session()
        offered = jobs if mr else [dataclasses.replace(j, demand=None)
                                   for j in jobs]
        first = sess.offer(offered[:2])
        second = sess.offer(offered[2:], flush=False)
        with pytest.raises(pt_batch.GrowthError, match="overflowing"):
            second.allocations()
        assert [a is not None for a in first.allocations()] == [True, True]
        assert second.allocations() == [] and sess.pending() == []
        ring = sess._backend.ring
        rings[mr] = (_ring_rows(ring), ring.last_popped_t_a, ring._fields)
    rows, lta, fields = rings[True]
    assert fields[5:] == ("demand1", "demand2")
    assert len(rows) == 28 and lta == rings[False][1]
    assert [r[:5] for r in rows] == rings[False][0]
    assert [r[5:] for r in rows] == [j.demand[1:] for j in jobs[2:]]
    # the restaged requests, offered again where they fit
    staged = [ARRequest(*r[:5], demand=(r[4],) + r[5:]) for r in rows]
    big = ReservationService(ServiceConfig(
        resources=units, **dict(kw, capacity=64, pending_capacity=64,
                                max_growths=8))).session()
    got = [(a is not None, a.t_s if a else -1) for a in
           big.offer(jobs[:2] + staged).allocations()]
    oracle = pt_host.MultiResourceOracle(ResourceSpec(units), Policy.PE_W,
                                         backfill)
    assert got == oracle.run(jobs[:2] + staged)
    assert big.records() == oracle.records()
    assert big.pending() == oracle.pending()


def test_cancel_and_cancel_many_match_reference():
    jobs = _jobs(40, (32,), seed=3)
    for auto_release in (True, False):
        ours, theirs = _sessions(n_pe=32, chunk_size=None,
                                 auto_release=auto_release)
        # allocations still pending at the end of the offer
        last = jobs[-1].t_a
        allocs = [a for a in ours.offer(jobs).allocations()
                  if a and a.t_e > last]
        ref_allocs = [a for a in theirs.offer(_ref(jobs)).allocations()
                      if a and a.t_e > last]
        assert len(allocs) == len(ref_allocs) >= 4
        # one cancel, then the same again (idempotent under auto-release)
        for _ in range(2):
            assert ours.cancel(allocs[0]) == theirs.cancel(ref_allocs[0])
        assert ours.cancel(t_s=1, t_e=2, pe_ids=[0]) == theirs.cancel(
            t_s=1, t_e=2, pe_ids=[0])
        # a batch with a duplicate and an already cancelled one
        picks = [1, 2, 1, 0, 3]
        got = ours.cancel_many([allocs[i] for i in picks])
        want = theirs.cancel_many([ref_allocs[i] for i in picks])
        assert got == want
        if auto_release:
            assert got == [True, True, False, False, True]
        assert ours.records() == theirs.records()
        _assert_metrics(ours, theirs)
        assert ours.metrics()["cancelled"] == theirs.metrics()["cancelled"]
        # the freed room is used again as the reference uses it
        more = [ARRequest(j.t_a + 400, j.t_r + 400, j.t_du, j.t_dl + 400,
                          j.n_pe) for j in jobs[:10]]
        _assert_same(ours, theirs, ours.offer(more),
                     theirs.offer(_ref(more)))
    with pytest.raises(ValueError, match="cancel needs"):
        ours.cancel(t_s=1)
    with pytest.raises(ValueError, match="ensemble"):
        ours.cancel(allocs[0], lane=1)


@pytest.mark.parametrize("donate", [False, True])
def test_snapshot_restore_round_trip(donate):
    """Restore rewinds decisions, records, counters and the ring; later
    offers go down the eager path until the next admission, as in the
    reference."""
    jobs = _jobs(60, (32, 4), seed=8)
    ours, theirs = _sessions(donate=donate, n_pe=32, resources=(32, 4),
                             chunk_size=8, ring_capacity=32, capacity=4)
    _assert_same(ours, theirs, ours.offer(jobs[:20], flush=False),
                 theirs.offer(_ref(jobs[:20]), flush=False))
    snap, ref_snap = ours.snapshot(), theirs.snapshot()
    first = _alloc_tuples(ours.offer(jobs[20:45]))
    assert first == _alloc_tuples(theirs.offer(_ref(jobs[20:45])))
    before = ours.metrics()
    ours.restore(snap)
    theirs.restore(ref_snap)
    assert ours._backend._retained and theirs._backend._retained
    _assert_metrics(ours, theirs)
    assert ours.metrics()["offered"] == 20 < before["offered"]
    again = ours.offer(jobs[20:45])
    assert not ours._backend._inflight       # eager after a restore
    assert _alloc_tuples(again) == first
    _assert_same(ours, theirs, again, theirs.offer(_ref(jobs[20:45])))
    _assert_same(ours, theirs, ours.offer(jobs[45:]),
                 theirs.offer(_ref(jobs[45:])))
    _assert_metrics(ours, theirs)


@pytest.mark.parametrize("engine", ["host", "list"])
def test_host_and_list_sessions_match_device_and_reference(engine):
    jobs = _jobs(50, (24,), seed=4)
    host = ReservationService(ServiceConfig(
        n_pe=24, engine=engine)).session()
    ref = RefService(RefConfig(n_pe=24, engine=engine)).session()
    dev, _ = _sessions(n_pe=24, chunk_size=None)
    results = [(s.offer(jobs[:30]), s) for s in (host, ref, dev)]
    tuples = [_alloc_tuples(r) for r, _ in results]
    assert tuples[0] == tuples[1] == tuples[2]
    assert host.records() == ref.records() == dev.records()
    res = results[0][0]
    assert res.n_accepted == results[2][0].n_accepted
    # the host decision rows equal the device session's
    for f in ("accepted", "t_s", "t_e", "pe_mask", "n_free"):
        got = getattr(res.decision, f)
        want = getattr(results[2][0].decision, f)
        acc = want.new_ones(want.shape[0], dtype=bool) if f != "n_free" \
            else results[2][0].decision.accepted
        assert (got[acc] == want[acc]).all(), f
    t = jobs[30].t_a
    assert host.tick(t) == ref.tick(t) == dev.tick(t)
    a = next(x for x in res.allocations() if x is not None)
    assert host.cancel(a) == ref.cancel(a) == dev.cancel(a)
    assert host.cancel(a) == ref.cancel(a) == dev.cancel(a) is False
    snap = host.snapshot()
    out = [_alloc_tuples(s.offer(jobs[30:])) for s in (host, ref, dev)]
    assert out[0] == out[1] == out[2]
    for k in ("offered", "accepted", "cancelled", "n_pending"):
        assert host.metrics()[k] == ref.metrics()[k] == dev.metrics()[k], k
    # host sessions count the releases inside an offer too, as the
    # reference's do; device sessions count those of tick only
    assert host.metrics()["released"] == ref.metrics()["released"]
    host.restore(snap)
    assert _alloc_tuples(host.offer(jobs[30:])) == out[0]
    with pytest.raises(ValueError, match="ring-buffer"):
        host.offer(jobs[:1], flush=False)
    with pytest.raises(TypeError):
        ReservationService(ServiceConfig(
            n_pe=8, engine=engine, engine_kwargs={"nope": 1})).session()


def test_metrics_match_reference_and_an_idle_poll_reads_nothing(monkeypatch):
    jobs = _jobs(40, (32,), seed=6)
    ours, theirs = _sessions(donate=True, n_pe=32, chunk_size=8,
                             index_tile=8, capacity=16)
    res, ref_res = ours.offer(jobs), theirs.offer(_ref(jobs))
    _assert_metrics(ours, theirs)
    _assert_same(ours, theirs, res, ref_res)
    reads = []
    real = pt_service._StreamBackend._refresh_dev_metrics
    monkeypatch.setattr(pt_service._StreamBackend, "_refresh_dev_metrics",
                        lambda self: reads.append(1) or real(self))
    syncs = ours._backend.stats.host_syncs
    m1, m2 = ours.metrics(), ours.metrics()
    assert m1 == m2 and not reads
    assert ours._backend.stats.host_syncs == syncs
    assert ours.tick(jobs[-1].t_a + 10**4) == theirs.tick(
        jobs[-1].t_a + 10**4)
    assert ours.metrics()["n_pending"] == 0 and reads == [1]
    _assert_metrics(ours, theirs)


# ---------------------------------------------------------------------------
# ensemble sessions (lanes > 1)
# ---------------------------------------------------------------------------


# the counters and geometry both ensemble backends report
ENS_METRICS = ("offered", "accepted", "released", "reaped", "cancelled",
               "chunks", "growths", "one_shot_scans", "capacity",
               "pending_capacity", "ring_capacity", "ring_staged",
               "ring_wrapped", "lanes", "chunk_size", "backfill")


def _assert_ens_same(res, ref_res):
    """Every Decision field of an ``[E, M]`` offer and its valid mask."""
    assert res.n_offered == ref_res.n_offered
    assert res.n_accepted == ref_res.n_accepted
    if ref_res.decision is None:
        assert res.decision is None
        return
    np.testing.assert_array_equal(res.valid, np.asarray(ref_res.valid))
    for f in ref_batch.Decision._fields:
        got = getattr(res.decision, f).numpy()
        if f == "pe_mask":
            got = pt_words.to_uint32(got)
        np.testing.assert_array_equal(
            got, np.asarray(getattr(ref_res.decision, f)), err_msg=f)


def _assert_ens_metrics(ours, theirs):
    m, rm = ours.metrics(), theirs.metrics()
    for k in ENS_METRICS:
        assert m.get(k) == rm.get(k), k


def _lane_trace(res, lane):
    v = np.asarray(res.valid)[lane]
    return list(zip(res.decision.accepted[lane].numpy()[v].tolist(),
                    res.decision.t_s[lane].numpy()[v].tolist()))


@pytest.mark.parametrize("donate", [False, True])
def test_ensemble_session_matches_single_lane_sessions(donate):
    """Three lanes with their own policies and streams: every lane as
    its one-lane session and every field as the reference's ensemble;
    ``tick`` releases every lane's tail."""
    jobs = _jobs(120, (32,), seed=2)
    policies = [Policy.FF, Policy.PE_W, Policy.DU_B]
    streams = [jobs, jobs[:70], jobs[:45]]
    kw = dict(n_pe=32, lanes=3, capacity=16, pending_capacity=8,
              chunk_size=16, ring_capacity=32)
    ours, theirs = _sessions(donate=donate, **kw)
    res = ours.offer(streams, policy=policies)
    ref_res = theirs.offer([_ref(s) for s in streams], policy=policies)
    _assert_ens_same(res, ref_res)
    _assert_ens_metrics(ours, theirs)
    assert ours.metrics()["growths"] >= 1
    for lane, (pol, stream) in enumerate(zip(policies, streams)):
        one = ReservationService(ServiceConfig(
            n_pe=32, policy=pol, capacity=64, chunk_size=16,
            ring_capacity=32, device="cpu")).session()
        sres = one.offer(stream)
        assert _lane_trace(res, lane) == list(zip(
            sres.decision.accepted.numpy()[sres.valid].tolist(),
            sres.decision.t_s.numpy()[sres.valid].tolist()))
        assert ours.records(lane) == one.records()
        assert ours.records(lane) == theirs._backend.records(lane)
    horizon = max(j.t_dl for j in jobs) + 1
    assert ours.tick(horizon) == theirs.tick(horizon) > 0
    states = ours._backend.states
    assert sum(int(s.n_released) for s in states) == \
        sum(int(s.n_accepted) for s in states)
    for lane in range(3):
        assert ours.records(lane) == []
    _assert_ens_metrics(ours, theirs)


def test_ensemble_filler_never_releases_ahead_of_staged_requests():
    """A lane contributing filler (``flush=False``) while it still holds
    staged requests must not advance that lane's release clock past
    them: filler is stamped with the last popped arrival."""
    a = ARRequest(t_a=0, t_r=0, t_du=5, t_dl=5, n_pe=4)
    d = ARRequest(t_a=3, t_r=3, t_du=2, t_dl=5, n_pe=4)  # blocked by a
    e = ARRequest(t_a=7, t_r=7, t_du=2, t_dl=10, n_pe=4)
    lane0 = [ARRequest(t_a=t, t_r=t, t_du=1, t_dl=t + 3, n_pe=1)
             for t in range(8)]
    ours, theirs = _sessions(n_pe=4, lanes=2, capacity=32, chunk_size=4,
                             ring_capacity=8)
    got = [ours.offer([[], [a]]), ours.offer([lane0, [d, e]], flush=False),
           ours.flush()]
    want = [theirs.offer([[], _ref([a])]),
            theirs.offer([_ref(lane0), _ref([d, e])], flush=False),
            theirs.flush()]
    for r, rr in zip(got, want):
        _assert_ens_same(r, rr)
    lane1 = [acc for r in got for acc, _ in _lane_trace(r, 1)]
    assert lane1 == [True, False, True]


def test_ensemble_cancel_targets_the_named_lane():
    r = ARRequest(t_a=0, t_r=0, t_du=100, t_dl=200, n_pe=4)
    ours, theirs = _sessions(n_pe=8, lanes=2, capacity=32, chunk_size=4,
                             ring_capacity=8)
    res = ours.offer([[r], [r]])
    theirs.offer([_ref([r]), _ref([r])])
    allocs = [pt_batch.decisions_to_allocations(pt_batch.Decision(
        *(f[lane] for f in res.decision)))[0] for lane in range(2)]
    assert ours.cancel(allocs[1], lane=1) is True
    assert theirs.cancel(allocs[1], lane=1) is True
    assert ours.records(0) == theirs._backend.records(0) != []
    assert ours.records(1) == theirs._backend.records(1) == []
    assert ours.cancel(allocs[1], lane=1) is False
    assert ours.cancel_many([allocs[0], allocs[0]], lane=0) == [True, False]
    with pytest.raises(ValueError, match="out of range"):
        ours.cancel(allocs[0], lane=5)
    with pytest.raises(ValueError, match="out of range"):
        ours.pending(lane=2)
    with pytest.raises(NotImplementedError, match="per lane"):
        ours.find_allocation(r)
    flat = ReservationService(ServiceConfig(
        n_pe=8, chunk_size=4, ring_capacity=8, device="cpu")).session()
    a = flat.offer([r]).allocations()[0]
    with pytest.raises(ValueError, match="ensemble"):
        flat.cancel(a, lane=1)
    with pytest.raises(ValueError, match="ensemble"):
        flat.records(lane=1)


def test_ensemble_cancel_that_grows_grows_every_lane():
    """A cancel splitting a merged record on a full timeline grows every
    lane, as the reference's does (counted once)."""
    jobs = [ARRequest(t_a=0, t_r=0, t_du=10 + i, t_dl=100, n_pe=1)
            for i in range(7)]
    kw = dict(n_pe=8, lanes=2, capacity=8, pending_capacity=8,
              chunk_size=None, auto_release=False)
    ours, theirs = _sessions(**kw)
    res = ours.offer([jobs, jobs[:1]])
    theirs.offer([_ref(jobs), _ref(jobs[:1])])
    alloc = pt_batch.decisions_to_allocations(pt_batch.Decision(
        *(f[0] for f in res.decision)))[3]
    assert ours.cancel(alloc, lane=0) == theirs.cancel(alloc, lane=0)
    _assert_ens_metrics(ours, theirs)
    assert ours.records(0) == theirs._backend.records(0)


def test_ensemble_flush_false_keeps_partial_lanes_staged():
    r = [ARRequest(t_a=i, t_r=i, t_du=10, t_dl=i + 50, n_pe=1)
         for i in range(8)]
    ours, theirs = _sessions(n_pe=8, lanes=2, capacity=32, chunk_size=4,
                             ring_capacity=8)
    res = ours.offer([r, r[:1]], flush=False)
    _assert_ens_same(res, theirs.offer([_ref(r), _ref(r[:1])], flush=False))
    assert res.n_offered == 8
    assert [ring.count for ring in ours._backend.rings] == [0, 1]
    rest = ours.flush()
    _assert_ens_same(rest, theirs.flush())
    assert rest.n_offered == 1
    assert sum(ring.count for ring in ours._backend.rings) == 0
    _assert_ens_metrics(ours, theirs)
    with pytest.raises(ValueError, match="per-lane streams"):
        ours.offer([r])
    with pytest.raises(ValueError, match="arrival-ordered"):
        ours.offer([r[:1], r[:1]])


def test_ensemble_pipelined_terminal_growth_error_restages_every_ring():
    """Growth runs out while an ensemble offer replays its latched
    chunk: the offer raises, and every lane's undecided requests are
    back in its ring in the reference's order, with the reference's
    filler stamp; the session stays usable on the rolled-back lanes."""
    jobs = [ARRequest(i, i, 5000, i + 5000, 1) for i in range(30)]
    ours, theirs = _sessions(donate=True, n_pe=64, lanes=2, capacity=4,
                             pending_capacity=4, max_growths=1,
                             chunk_size=16, ring_capacity=64)
    first = ours.offer([jobs[:2], jobs[:1]])
    _assert_ens_same(first, theirs.offer([_ref(jobs[:2]), _ref(jobs[:1])]))
    streams = [jobs[2:], jobs[1:20]]
    with pytest.raises(pt_batch.GrowthError, match="overflowing"):
        ours.offer(streams, flush=False)
    with pytest.raises(ref_batch.GrowthError, match="overflowing"):
        theirs.offer([_ref(s) for s in streams], flush=False)
    for ring, ref_ring in zip(ours._backend.rings, theirs._backend.rings):
        assert _ring_rows(ring) == _ring_rows(ref_ring)
        assert ring.last_popped_t_a == ref_ring.last_popped_t_a
    assert [len(_ring_rows(r)) for r in ours._backend.rings] == [28, 19]
    for lane in range(2):
        assert ours.records(lane) == theirs._backend.records(lane)
    _assert_ens_metrics(ours, theirs)
    assert ours.tick(10**6) == theirs.tick(10**6)
    for lane in range(2):
        assert ours.records(lane) == theirs._backend.records(lane)


@pytest.mark.parametrize("donate", [False, True])
def test_ensemble_snapshot_restore_and_one_shot(donate):
    """``snapshot`` / ``restore`` rewind every lane and ring; one-shot
    ensembles take per-lane streams or a pre-padded pair."""
    jobs = _jobs(60, (16,), seed=9)
    ours, theirs = _sessions(donate=donate, n_pe=16, lanes=2, capacity=16,
                             chunk_size=8, ring_capacity=16)
    ours.offer([jobs[:20], jobs[:10]], flush=False)
    theirs.offer([_ref(jobs[:20]), _ref(jobs[:10])], flush=False)
    snap, ref_snap = ours.snapshot(), theirs.snapshot()
    first = ours.offer([jobs[20:40], jobs[10:50]])
    ours.restore(snap)
    theirs.restore(ref_snap)
    again = ours.offer([jobs[20:40], jobs[10:50]])
    _assert_ens_same(again, theirs.offer([_ref(jobs[20:40]),
                                          _ref(jobs[10:50])]))
    for f in pt_batch.Decision._fields:
        assert torch.equal(getattr(first.decision, f),
                           getattr(again.decision, f))
    _assert_ens_metrics(ours, theirs)
    one, ref_one = _sessions(n_pe=16, lanes=2, capacity=16, chunk_size=None)
    _assert_ens_same(one.offer([jobs[:30], jobs[5:25]], policy=(0, "FF")),
                     ref_one.offer([_ref(jobs[:30]), _ref(jobs[5:25])],
                                   policy=[0, "FF"]))
    batch, valid = pt_batch.pad_streams([jobs[30:], jobs[40:]], 16,
                                        device="cpu")
    ref_b, ref_v = ref_batch.pad_streams([_ref(jobs[30:]), _ref(jobs[40:])],
                                         16)
    _assert_ens_same(one.offer((batch, valid)), ref_one.offer((ref_b, ref_v)))
    _assert_ens_metrics(one, ref_one)
    with pytest.raises(ValueError, match="bypasses the rings"):
        ours.offer((batch, valid))
    with pytest.raises(ValueError, match="policies for"):
        one.offer([jobs[:1], jobs[:1]], policy=[0, 1, 2])
