"""The port's reservation service against the JAX package's, bit for bit.

One-shot and chunked sessions (ring wrap, ``flush=False`` staging, a
final partial chunk of filler, growth inside a chunk, ``tick``) on
plain, multi-resource and heterogeneous-lane configs: the same
allocations, records and counters as ``repro.api`` with the same
config.  Plus ``ServiceConfig`` validation, the settings the port
does not run yet, and demand checks that reject before any mutation.
"""
import dataclasses
import random

import pytest

from repro.api import ReservationService as RefService
from repro.api import ServiceConfig as RefConfig
from repro.core.types import ARRequest as RefRequest
from repro_torch.api import ReservationService, ServiceConfig
from repro_torch.core import batch as pt_batch
from repro_torch.core.types import ARRequest, Policy

# counters and geometry both services report
METRICS = ("offered", "accepted", "released", "chunks", "growths",
           "one_shot_scans", "capacity", "pending_capacity", "n_pending",
           "ring_capacity", "ring_staged", "ring_wrapped", "engine", "n_pe",
           "lanes", "n_partitions", "chunk_size", "backfill")


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
    return [RefRequest(j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe,
                       demand=j.demand) for j in jobs]


def _sessions(**kw):
    """The port's session and the reference's with the same config.

    The reference runs its eager chunk loop (``donate=False``), the one
    the port has; its pipelined loop makes the same decisions but counts
    a growth found while replaying a chunk once more.
    """
    ours = ReservationService(ServiceConfig(device="cpu", **kw)).session()
    theirs = RefService(RefConfig(donate=False, **kw)).session()
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
    (dict(lanes=2), "A12"), (dict(n_partitions=2), "A15"),
    (dict(backfill="easy"), "A11"), (dict(backfill="conservative"), "A11"),
    (dict(tenants=object()), "A14"), (dict(index_tile=16), "A10"),
    (dict(engine="host"), "A9"), (dict(engine="list"), "A9"),
    (dict(lanes=2, machine_sizes=(8, 6)), "A12"),
])
def test_settings_not_ported_yet_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        ServiceConfig(n_pe=8, **kw)


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
    for gone in ("donate", "placement"):
        with pytest.raises(TypeError):
            ServiceConfig(n_pe=8, **{gone: None})
