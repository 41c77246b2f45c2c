"""The port's three engines against each other and the JAX package's.

Twin of ``tests/test_core_engines.py``: the paper's worked example
(Figure 1 / Section 4.2) on the list, host and device engines made by
``make_scheduler`` (which warns that it is deprecated), and a random
walk where all three make the decisions of the reference's literal list
engine under every policy.  Then the deprecated shims (``make_scheduler``,
``DeviceScheduler``, ``admit_stream_auto``) against the first three
tests of ``tests/test_deprecations.py``.
"""
import dataclasses
import random

import pytest

from repro.core.listsched import ListScheduler as RefList
from repro.core.types import ARRequest as RefRequest
from repro.core.types import Policy as RefPolicy
from repro_torch.api import ServiceConfig
from repro_torch.core import batch as pt_batch
from repro_torch.core import timeline as pt_tl
from repro_torch.core.hostsched import HostScheduler
from repro_torch.core.listsched import ListScheduler
from repro_torch.core.scheduler import (DeviceEngine, DeviceScheduler,
                                        make_scheduler)
from repro_torch.core.types import ALL_POLICIES, ARRequest, Policy, T_INF


def _make(engine, n_pe=100):
    kw = dict(device="cpu") if engine == "device" else {}
    with pytest.warns(DeprecationWarning, match="make_scheduler"):
        return make_scheduler(n_pe, engine=engine, **kw)


def _pes(engine, ids):
    return set(ids) if isinstance(engine, ListScheduler) else list(ids)


def _setup_paper_example(sched):
    """N=100; job1: 20 PEs [0,300); job2: 30 PEs [0,100);
    job3 (reserved): 25 PEs [800,1000)."""
    sched.add_allocation(0, 300, _pes(sched, range(0, 20)))
    sched.add_allocation(0, 100, _pes(sched, range(20, 50)))
    sched.add_allocation(800, 1000, _pes(sched, range(0, 25)))


REQ = ARRequest(t_a=0, t_r=200, t_du=200, t_dl=900, n_pe=40)


@pytest.mark.parametrize("engine", ["list", "host", "device"])
def test_paper_example_on_every_engine(engine):
    s = _make(engine)
    assert type(s) is {"list": ListScheduler, "host": HostScheduler,
                       "device": DeviceEngine}[engine]
    _setup_paper_example(s)
    # {t0,n1+n2}, {t1,n1}, {t3,empty->merged}, {t8,n3}, {t10,empty}
    assert [(t, len(b)) for t, b in s.records()] == [
        (0, 50), (100, 20), (300, 0), (800, 25), (1000, 0)]
    if engine != "device":
        # paper: t2, t3, t6, t7
        assert sorted(int(t) for t in s.candidate_starts(REQ)) == [
            200, 300, 600, 700]
    ff = s.find_allocation(REQ, Policy.FF)
    assert (ff.t_s, ff.rectangle.n_free, ff.rectangle.t_begin,
            ff.rectangle.t_end) == (200, 80, 100, 800)
    # PE Worst Fit picks t3 (the earliest of equal rectangles)
    for pol in (Policy.PE_W, Policy.DU_B):
        a = s.find_allocation(REQ, pol)
        assert (a.t_s, a.rectangle.n_free) == (300, 100)
    before = s.records()
    s.add_allocation(300, 500, _pes(s, range(50, 90)))
    assert s.records() != before
    s.delete_allocation(300, 500, _pes(s, range(50, 90)))
    assert s.records() == before
    assert s.find_allocation(ARRequest(0, 0, 250, 260, 90), Policy.FF) is None


def test_randomized_three_engine_equivalence():
    """All three engines and the reference's list engine make the same
    allocation (start, PEs, rectangle) and keep the same records."""
    rng = random.Random(7)
    n_pe = 53
    engines = [ListScheduler(n_pe), HostScheduler(n_pe),
               DeviceEngine(n_pe, capacity=64, device="cpu")]
    ref = RefList(n_pe)
    active, t_now, accepted = [], 0, 0
    for step in range(150):
        t_now += rng.randint(0, 4)
        for job in [j for j in active if j[1] <= t_now]:
            for e in engines:
                e.delete_allocation(job[0], job[1], _pes(e, job[2]))
            ref.delete_allocation(job[0], job[1], set(job[2]))
            active.remove(job)
        du = rng.randint(1, 25)
        tr = t_now + rng.randint(0, 8)
        req = ARRequest(t_now, tr, du, tr + du + rng.randint(0, 40),
                        rng.randint(1, n_pe))
        pol = rng.choice(list(ALL_POLICIES))
        want = ref.find_allocation(
            RefRequest(req.t_a, req.t_r, req.t_du, req.t_dl, req.n_pe),
            RefPolicy(pol.value), t_now=t_now)
        for e in engines:
            a = e.find_allocation(req, pol, t_now=t_now)
            assert (a is None) == (want is None), (step, pol, e)
            if a is not None:
                assert (a.t_s, a.pe_ids, dataclasses.astuple(a.rectangle)) \
                    == (want.t_s, want.pe_ids,
                        dataclasses.astuple(want.rectangle)), (step, e)
        if want is not None:
            for e in engines:
                e.add_allocation(want.t_s, want.t_e, _pes(e, want.pe_ids))
            ref.add_allocation(want.t_s, want.t_e, set(want.pe_ids))
            active.append((want.t_s, want.t_e, want.pe_ids))
            accepted += 1
        r0 = ref.records()
        for e in engines:
            assert e.records() == r0, (step, e)
    assert accepted > 40


def test_make_scheduler_kwargs():
    for engine in ("list", "host"):
        s = _make(engine, n_pe=10)
        s.add_allocation(0, 10, _pes(s, [0, 1]))
        with pytest.raises(ValueError):
            s.add_allocation(5, 15, _pes(s, [1, 2]))
    host = _make("host", n_pe=10)
    alloc = host.find_allocation(ARRequest(0, 5, 10, 100, 4), Policy.FF)
    assert (alloc.t_s, alloc.rectangle.t_end, alloc.rectangle.n_free) == (
        5, T_INF, 10)
    with pytest.warns(DeprecationWarning):
        chunked = make_scheduler(10, engine="host", candidate_chunk=4)
    assert chunked._chunk == 4
    with pytest.warns(DeprecationWarning), pytest.raises(TypeError):
        make_scheduler(10, engine="list", candidate_chunk=4)
    with pytest.warns(DeprecationWarning), pytest.raises(TypeError):
        make_scheduler(10, engine="device", bucketing=True, device="cpu")
    dev = _make("device", n_pe=10)
    assert dev.tl.capacity == 256 and dev.tl.device.type == "cpu"
    cfg = ServiceConfig.from_engine_kwargs(10, "device", capacity=32,
                                           device="cpu")
    assert (cfg.capacity, cfg.engine, cfg.engine_kwargs) == (32, "device",
                                                            None)
    cfg = ServiceConfig.from_engine_kwargs(10, "host", candidate_chunk=8)
    assert cfg.engine_kwargs == {"candidate_chunk": 8}


# ---- the deprecation shims: twins of the first three tests of
# tests/test_deprecations.py

def test_make_scheduler_warns_for_every_engine():
    for engine in ("host", "list", "device"):
        kw = dict(device="cpu") if engine == "device" else {}
        with pytest.warns(DeprecationWarning,
                          match="make_scheduler is deprecated"):
            eng = make_scheduler(8, engine, **kw)
        assert eng is not None


def test_device_scheduler_class_warns_once_per_construction():
    with pytest.warns(DeprecationWarning,
                      match="DeviceScheduler is deprecated") as rec:
        sched = DeviceScheduler(capacity=16, n_pe=8, device="cpu")
    assert sum(issubclass(w.category, DeprecationWarning)
               for w in rec) == 1
    assert isinstance(sched, DeviceEngine)
    # the shim still schedules
    req = ARRequest(t_a=0, t_r=0, t_du=5, t_dl=20, n_pe=2)
    assert sched.find_allocation(req, Policy.FF) is not None


def test_admit_stream_auto_warns_and_forwards():
    state = pt_tl.init_state(16, 8, 16, device="cpu")
    batch = pt_batch.requests_to_batch(
        [ARRequest(t_a=0, t_r=0, t_du=5, t_dl=20, n_pe=2)], "cpu")
    with pytest.warns(DeprecationWarning,
                      match="admit_stream_auto is deprecated"):
        _, dec = pt_batch.admit_stream_auto(state, batch, Policy.FF, n_pe=8)
    assert bool(dec.accepted[0])
    # it forwards the backfill mode as admit_stream_grow takes it
    jobs = [ARRequest(t_a=0, t_r=0, t_du=10, t_dl=30, n_pe=8),
            ARRequest(t_a=1, t_r=1, t_du=5, t_dl=40, n_pe=8)]
    state = pt_tl.init_state(16, 8, 16, device="cpu", park_capacity=4)
    batch = pt_batch.requests_to_batch(jobs, "cpu")
    with pytest.warns(DeprecationWarning):
        out, dec = pt_batch.admit_stream_auto(state, batch, Policy.FF,
                                              n_pe=8, backfill="easy")
    want_out, want = pt_batch.admit_stream_grow(state, batch, Policy.FF,
                                                n_pe=8, backfill="easy")
    assert dec.parked.tolist() == want.parked.tolist() == [False, True]
    assert pt_batch.parked_entries(out) == pt_batch.parked_entries(want_out)
