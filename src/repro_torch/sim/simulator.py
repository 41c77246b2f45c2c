"""Discrete-event simulator for AR scheduling (paper Section 6).

A meta-user submits AR requests in arrival order; the meta-scheduler
keeps the availability structure and admits with one of the seven
policies; completions release their PEs via ``deleteAllocation``.

:func:`simulate` is the event loop over the three paper operations of
any engine; :func:`simulate_batched` admits the whole stream as one
one-shot offer of the reservation service (the device's fused step,
:func:`repro_torch.core.batch.admit_stream_grow`) and can hold its
decisions against a host loop.
"""
from __future__ import annotations

import heapq
import time as _time
from typing import Iterable, List, Optional

from repro_torch.api import ReservationService, ServiceConfig
from repro_torch.core import batch as batch_lib
from repro_torch.core.scheduler import _make_engine
from repro_torch.core.types import ARRequest, Policy
from repro_torch.device import DeviceLike
from repro_torch.sim.metrics import SimResult


def simulate(
    jobs: Iterable[ARRequest],
    n_pe: int,
    policy: Policy,
    engine: str = "device",
    engine_kwargs: Optional[dict] = None,
    record_decisions: bool = False,
    device: DeviceLike = None,
) -> SimResult:
    """Run one experiment: schedule every job, collect the metrics.

    ``device`` places the ``"device"`` engine (``None``: cuda, raising
    without a card); ``engine="host"`` runs the numpy oracle and
    ``engine="list"`` the literal record list instead, on the host.
    """
    jobs = sorted(jobs, key=lambda j: j.t_a)
    kwargs = dict(engine_kwargs or {})
    if engine == "device":
        kwargs.setdefault("device", device)
    sched = _make_engine(n_pe, engine=engine, **kwargs)
    completions: List = []   # heap of (t_e, seq, t_s, t_e, pe_ids)
    seq = 0
    result = SimResult(policy=policy.value, n_jobs=len(jobs),
                       n_accepted=0, n_pe=n_pe)
    if record_decisions:
        result.decisions = []
    wall = 0.0
    for req in jobs:
        t_now = req.t_a
        # release completed reservations first (deleteAllocation runs
        # as soon as a job finishes)
        while completions and completions[0][0] <= t_now:
            _, _, ts, te, ids = heapq.heappop(completions)
            t0 = _time.perf_counter()
            sched.delete_allocation(ts, te, ids)
            wall += _time.perf_counter() - t0
        t0 = _time.perf_counter()
        alloc = sched.find_allocation(req, policy, t_now=t_now)
        if alloc is not None:
            sched.add_allocation(alloc.t_s, alloc.t_e, _as_pes(alloc, engine))
        wall += _time.perf_counter() - t0
        if record_decisions:
            result.decisions.append(
                (alloc is not None, alloc.t_s if alloc else -1))
        if alloc is None:
            continue
        result.n_accepted += 1
        wait = alloc.t_s - req.t_r
        result.slowdowns.append((wait + req.t_du) / req.t_du)
        result.busy_area += req.n_pe * req.t_du
        heapq.heappush(completions, (alloc.t_e, seq, alloc.t_s, alloc.t_e,
                                     _as_pes(alloc, engine)))
        seq += 1
    if jobs:
        result.span = max(jobs[-1].t_a, 1) - jobs[0].t_a + 1
    result.wall_seconds = wall
    return result


def _as_pes(alloc, engine: str):
    return set(alloc.pe_ids) if engine == "list" else list(alloc.pe_ids)


def simulate_batched(
    jobs: Iterable[ARRequest],
    n_pe: int,
    policy: Policy,
    capacity: int = 128,
    pending_capacity: int = 256,
    cross_check: bool = False,
    cross_check_engine: str = "host",
    index_tile: Optional[int] = None,
    use_kernel: bool = True,
    device: DeviceLike = None,
    stats: Optional[batch_lib.StreamStats] = None,
) -> SimResult:
    """Device path: the whole stream as one one-shot service offer.

    Semantically identical to :func:`simulate`: completions are
    released before each arrival, then the fused step searches and
    commits.  ``capacity``/``pending_capacity`` are starting sizes;
    overflow grows them and re-runs.  ``index_tile`` attaches the
    availability index (same decisions).  ``wall_seconds`` spans the
    offer, host reads of the decisions included.

    With ``cross_check=True`` the ``cross_check_engine`` event loop
    (``"host"`` or ``"list"``) runs on the same workload and the
    per-job decisions, start times, slowdowns and busy area must be
    identical, else ``AssertionError``.  ``stats`` collects the run's
    host syncs, steps and early rejects.
    """
    jobs = sorted(jobs, key=lambda j: j.t_a)
    result = SimResult(policy=policy.value, n_jobs=len(jobs),
                       n_accepted=0, n_pe=n_pe)
    result.decisions = []
    if not jobs:
        return result
    session = ReservationService(ServiceConfig(
        n_pe=n_pe, policy=policy, capacity=capacity,
        pending_capacity=pending_capacity, chunk_size=None,
        index_tile=index_tile, use_kernel=use_kernel,
        device=device)).session()
    backend = session._backend
    if stats is not None:
        backend.stats = stats
    batch = batch_lib.requests_to_batch(jobs, device=backend.device)
    t0 = _time.perf_counter()
    res = session.offer(batch)
    accepted = res.decision.accepted.cpu().numpy()
    starts = res.decision.t_s.cpu().numpy()
    if stats is not None:
        stats.sync(2)
    result.wall_seconds = _time.perf_counter() - t0
    result.n_accepted = int(accepted.sum())
    result.decisions = [(bool(a), int(t)) for a, t in zip(accepted, starts)]
    for i, req in enumerate(jobs):
        if not accepted[i]:
            continue
        wait = int(starts[i]) - req.t_r
        result.slowdowns.append((wait + req.t_du) / req.t_du)
        result.busy_area += req.n_pe * req.t_du
    result.span = max(jobs[-1].t_a, 1) - jobs[0].t_a + 1
    if cross_check:
        ref = simulate(jobs, n_pe, policy, engine=cross_check_engine,
                       record_decisions=True)
        if ref.decisions != result.decisions:
            diff = [i for i, (x, y) in
                    enumerate(zip(ref.decisions, result.decisions)) if x != y]
            raise AssertionError(
                f"batched decisions diverge from the {cross_check_engine} "
                f"loop at job indices {diff[:10]} ({len(diff)}/{len(jobs)} "
                f"total)")
        if (ref.n_accepted, ref.slowdowns, ref.busy_area) != (
                result.n_accepted, result.slowdowns, result.busy_area):
            raise AssertionError("batched metrics diverge from the host loop")
    return result


def run_policies(jobs: List[ARRequest], n_pe: int,
                 policies: Iterable[Policy], engine: str = "device",
                 device: DeviceLike = None) -> List[SimResult]:
    """Evaluate several policies on one shared workload (paper setup)."""
    return [simulate(jobs, n_pe, pol, engine=engine, device=device)
            for pol in policies]
