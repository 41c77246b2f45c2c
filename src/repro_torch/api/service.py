"""`ReservationService`: the streaming session API over device timelines.

The port's copy of ``repro/api/service.py`` for one-lane and ensemble
sessions.  A :class:`ReservationService` is configured once by a
:class:`~repro_torch.api.config.ServiceConfig` and opens
:class:`Session` s, each carrying its scheduler state across calls:

``offer(requests)``
    Streaming admission.  Arrivals stage in a fixed-capacity
    :class:`~repro_torch.core.batch.RequestRing` and admit in
    ``chunk_size`` chunks, so every chunk has the same shapes however
    callers group their arrivals.  ``chunk_size=None`` admits each
    offer as one batch.
``tick(t)``
    Release every pending reservation ending by ``t`` (with
    ``auto_release=False`` on a multi-tenant session with a ``grace``
    window: reap those overdue past ``t_e + grace``).
``cancel(...)`` / ``cancel_many(...)``
    Withdraw committed reservations (on auto-release sessions an
    unknown or already released one returns ``False``).
``snapshot()`` / ``restore(...)``
    Capture and rewind the whole session.  States are never written in
    place, so a snapshot holds references, not copies.
``pending()``
    The backfilling deferral queue, FCFS order.
``metrics()``
    Admission counters, growths, capacities, ring geometry, the host
    syncs the session paid, when backfilling the queue's counters, and
    on multi-tenant sessions the per-tenant telemetry (``tenants``;
    ``metrics(tenant=i)`` is one tenant's view).

Capacity overflow grows once to the high-water mark the failed
dispatch recorded and re-runs that chunk, so chunked decisions equal a
one-shot run that started with enough capacity.  With ``donate`` and
``auto_grow`` (the defaults) chunked offers pipeline as the
reference's do: no chunk's overflow latch is read while the offer
runs; the offer returns a deferred :class:`OfferResult`, and the first
access to a result, or the next verb that reads the state, reads every
outstanding latch in one host read (:meth:`_StreamBackend._drain_inflight`).
``engine="host"`` and ``engine="list"`` run the reference's CPU engines
behind the same verbs.  The paper's three operations stay available on
every one-lane session.

Ensemble sessions (``lanes > 1``) hold E lanes of equal capacities
(:mod:`repro_torch.core.ensemble`), each with its own policy, backfill
mode, tenant table and machine size.  ``offer`` takes one stream per
lane (or a pre-padded ``(RequestBatch, valid)`` pair on one-shot
sessions) and returns ``[E, N]`` decisions; a lane's overflow grows
every lane.  ``cancel``, ``pending`` and ``records`` name their lane.

Partitioned sessions (``n_partitions > 1``) slice the machine into
equal partitions behind a :class:`~repro_torch.runtime.fleet.
PartitionedCore`: each ``offer`` is routed (``routing``: round robin,
least loaded or best acceptance) and decided at once; reservations
carry global PE ids; a tenant spec is enforced at the host router.
"""
from __future__ import annotations

import copy
import dataclasses
import heapq
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.config import ROUTINGS, ServiceConfig, policy_id_of
from repro_torch.core import batch as batch_lib
from repro_torch.core import ensemble as ens_lib
from repro_torch.core import timeline as tl_lib
from repro_torch.core import words as words_lib
from repro_torch.core.batch import Decision, RequestBatch, RequestRing
from repro_torch.core.scheduler import DeviceEngine, _make_engine
from repro_torch.core.types import Allocation, ARRequest, Policy, T_INF
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import data_shards, resolve_placement
from repro_torch.sharding import rules as shard_rules
from repro_torch.tenancy import lane_tables, telemetry


class OfferResult:
    """Outcome of one :meth:`Session.offer` call.

    ``decision`` / ``batch`` / ``valid`` are the stacked fixed-shape
    tensors actually admitted (``[M]``); ``valid`` masks out ring
    filler.  :meth:`allocations` unpacks host
    :class:`~repro_torch.core.types.Allocation` objects (``None`` per
    rejection) in the order the requests were offered.  Host and list
    sessions build ``decision`` on the CPU and leave ``batch`` unset.

    A pipelined offer returns a deferred result: its chunks' overflow
    latches are unread, and the first access to any field settles
    every in-flight offer of the session in one host read.
    """

    def __init__(self, decision: Optional[Decision] = None,
                 batch: Optional[RequestBatch] = None,
                 valid: Optional[np.ndarray] = None,
                 _allocations: Optional[List[Optional[Allocation]]] = None,
                 _finalize=None):
        self._decision = decision
        self._batch = batch
        self._valid = valid
        self._allocations = _allocations
        self._finalize = _finalize

    def _materialize(self) -> None:
        if self._finalize is not None:
            fin, self._finalize = self._finalize, None
            fin()

    @property
    def decision(self) -> Optional[Decision]:
        self._materialize()
        return self._decision

    @property
    def batch(self) -> Optional[RequestBatch]:
        self._materialize()
        return self._batch

    @property
    def valid(self) -> Optional[np.ndarray]:
        self._materialize()
        return self._valid

    @property
    def n_offered(self) -> int:
        self._materialize()
        if self._valid is not None:
            return int(np.asarray(self._valid).sum())
        return len(self._allocations or [])

    @property
    def n_accepted(self) -> int:
        self._materialize()
        if self._decision is not None:
            acc = self._decision.accepted.cpu().numpy()
            return int((acc & np.asarray(self._valid)).sum())
        return sum(a is not None for a in (self._allocations or []))

    def allocations(self) -> List[Optional[Allocation]]:
        """Host allocations for the valid offered requests, in order."""
        self._materialize()
        if self._allocations is not None:
            return self._allocations
        if self._decision is None:
            return []
        allocs = batch_lib.decisions_to_allocations(self._decision)
        self._allocations = [a for a, v in zip(allocs, self._valid) if v]
        return self._allocations


def _empty_result() -> OfferResult:
    return OfferResult(_allocations=[])


def _check_demands(rspec, reqs) -> None:
    """Validate request demand vectors against the session's layout.

    On multi-resource sessions every carried ``demand`` must match the
    spec (length, plane 0 equal to ``n_pe``, per-plane range); on plain
    sessions a demand naming secondary resources is an error, since
    dropping it would admit requests against resources the session
    does not model.
    """
    if rspec is not None:
        for r in reqs:
            rspec.demand_tail(r.demand, r.n_pe)
        return
    for r in reqs:
        if r.demand is not None and len(r.demand) > 1:
            raise ValueError(
                f"request carries a {len(r.demand)}-resource demand but "
                f"this session is single-resource; set "
                f"ServiceConfig.resources")


def _concat_tree(chunks: List[Any], axis: int):
    """Concatenate a list of equally-structured NamedTuples of tensors."""
    if len(chunks) == 1:
        return chunks[0]
    return type(chunks[0])(*(
        None if xs[0] is None else torch.cat(xs, dim=axis)
        for xs in zip(*chunks)))


def _push_front(ring: RequestRing, rows: List[dict], lta: int) -> int:
    """Reinsert popped requests at the front of their ring, in order.

    ``lta`` rewinds the filler stamp (``last_popped_t_a``) to the
    newest arrival actually decided.  Returns how many rows did not fit
    (dropped).
    """
    kept = rows[:ring.free]
    for row in reversed(kept):
        ring._head = (ring._head - 1) % ring.capacity
        for f in ring._fields:
            ring._buf[f][ring._head] = row[f]
        ring.count += 1
        ring.popped -= 1
    ring.last_popped_t_a = lta
    return len(rows) - len(kept)


def _staged_rows(batch: RequestBatch, valid, names) -> List[dict]:
    """The valid requests of a popped ``[M]`` batch as ring rows, in
    order (the demand tail from ``batch.demand``)."""
    cols = {f: getattr(batch, f).cpu().numpy() for f in batch_lib.REQ_FIELDS}
    if batch.tenant is not None:
        cols["tenant"] = batch.tenant.cpu().numpy()
    if batch.demand is not None:
        dem = batch.demand.cpu().numpy()
        for r in range(dem.shape[1]):
            cols[f"demand{r + 1}"] = dem[:, r]
    return [{f: int(cols[f][i]) for f in names}
            for i in np.flatnonzero(valid)]


class Session:
    """One long-lived scheduler conversation.

    Create via :meth:`ReservationService.session`.  Admission verbs take
    arrival-ordered traffic (``t_a`` non-decreasing across calls), like
    the paper's event loop.
    """

    def __init__(self, service: "ReservationService"):
        self.service = service
        self.config = service.config
        self._counters = dict(offered=0, accepted=0, released=0,
                              reaped=0, cancelled=0, chunks=0, growths=0,
                              one_shot_scans=0)
        self._backend = _make_backend(self.config, self._counters)

    @property
    def engine(self):
        """The underlying engine object (three-operation surface)."""
        return self._backend.engine

    def offer(self, requests, *, policy=None, routing: Optional[str] = None,
              flush: bool = True) -> OfferResult:
        """Admit newly arrived requests; returns their decisions.

        ``requests`` is an arrival-ordered sequence of
        :class:`~repro_torch.core.types.ARRequest` (or, on one-shot
        sessions, a packed :class:`RequestBatch`).  With ``flush``
        every offered request is decided before returning: a final
        partial chunk is padded with never-feasible filler.
        ``flush=False`` admits only full chunks and leaves the rest in
        the ring for the next offer (or :meth:`flush`).  ``policy``
        overrides the config's for this call; ``routing`` overrides it on
        partitioned sessions and must stay ``None`` elsewhere.
        """
        return self._backend.offer(requests, policy=policy, routing=routing,
                                   flush=flush)

    def flush(self, *, policy=None) -> OfferResult:
        """Decide any requests still staged by ``offer(flush=False)``."""
        return self._backend.offer((), policy=policy, routing=None,
                                   flush=True)

    def tick(self, t: int) -> int:
        """Release reservations ending by ``t``; returns how many.

        A session with ``auto_release=False`` leaves release to the
        caller (``cancel`` / ``delete_allocation``) and releases
        nothing here; a multi-tenant one with a ``grace`` window reaps
        instead the reservations still held past ``t_e + grace``,
        charging their tenants (returns how many, counted in
        ``metrics()["reaped"]``).
        """
        return self._backend.tick(t)

    def cancel(self, alloc: Optional[Allocation] = None, *,
               t_s: Optional[int] = None, t_e: Optional[int] = None,
               pe_ids: Optional[Sequence[int]] = None,
               lane: int = 0) -> bool:
        """Withdraw one committed reservation; ``True`` if it was held.

        Pass the :class:`~repro_torch.core.types.Allocation` returned at
        admission (or its ``t_s``/``t_e``/``pe_ids``).  On ensemble
        sessions ``lane`` names the timeline it was admitted on
        (elsewhere it must stay 0).  On auto-release sessions cancelling
        an unknown or already released reservation is a no-op returning
        ``False``.
        """
        if alloc is not None:
            t_s, t_e, pe_ids = alloc.t_s, alloc.t_e, alloc.pe_ids
        if t_s is None or t_e is None or pe_ids is None:
            raise ValueError("cancel needs an Allocation or t_s/t_e/pe_ids")
        return self._backend.cancel(int(t_s), int(t_e), list(pe_ids),
                                    lane=lane)

    def cancel_many(self, allocs: Sequence[Allocation],
                    lane: int = 0) -> List[bool]:
        """Withdraw several committed reservations at once.

        On device sessions all of them go in one pass
        (``timeline.update_many``); host sessions cancel one by one.
        One bool per allocation, as sequential :meth:`cancel` calls
        would return: on auto-release sessions a repeated allocation
        reports ``False`` after its first occurrence; with
        ``auto_release=False`` cancels are blind deletes and every
        entry reports ``True``.
        """
        triples = [(int(a.t_s), int(a.t_e), list(a.pe_ids)) for a in allocs]
        return self._backend.cancel_many(triples, lane=lane)

    def snapshot(self):
        """Opaque capture of the whole session state."""
        return (self._backend.snapshot(), dict(self._counters))

    def restore(self, snap) -> None:
        """Rewind the session to a :meth:`snapshot`."""
        payload, counters = snap
        self._backend.restore(payload)
        self._counters.clear()
        self._counters.update(counters)

    def records(self, lane: int = 0) -> list:
        """Host view of the availability timeline (merged records); on
        ensemble sessions of lane ``lane``."""
        return self._backend.records(lane)

    def pending(self, lane: int = 0) -> list:
        """The live backfilling deferral queue, FCFS order.

        One dict per parked reservation (``seq``/``t_s``/``t_e``/
        ``t_r``/``t_dl``/``n_pe``/``pe_ids``, plus ``demand`` on
        multi-resource sessions); the first entry is the head of queue.
        Empty on sessions that do not backfill.  On ensemble sessions
        ``lane`` names the timeline to inspect.
        """
        return self._backend.pending(lane)

    def metrics(self, tenant: Optional[int] = None) -> Dict[str, Any]:
        """Admission counters plus capacity, ring and host-sync figures.

        On multi-tenant sessions ``"tenants"`` holds the per-tenant
        telemetry arrays, read in the same transfer as the other
        state-derived counters and cached until the state changes, so
        polling an idle session reads nothing.  ``metrics(tenant=i)``
        returns tenant ``i``'s scalar view.  Ensemble sessions sum their
        counters over the lanes and stack the telemetry ``[E, T]``.
        """
        # backend first: it folds the deferred accepted count in
        backend = self._backend.metrics()
        out = dict(self._counters)
        out.update(backend)
        out.update(engine=self.config.engine, n_pe=self.config.n_pe,
                   lanes=self.config.lanes,
                   n_partitions=self.config.n_partitions,
                   chunk_size=self.config.chunk_size,
                   backfill=self.config.backfill)
        if tenant is not None:
            snap = out.get("tenants")
            if snap is None:
                raise ValueError(
                    "metrics(tenant=...) needs a multi-tenant session "
                    "(set ServiceConfig.tenants)")
            return telemetry.tenant_view(snap, tenant)
        return out

    # -- the paper's three operations -----------------------------------
    def find_allocation(self, req: ARRequest, policy=None,
                        t_now: Optional[int] = None
                        ) -> Optional[Allocation]:
        pol = self._backend.resolve_policy(policy)
        return self._backend.find_allocation(req, pol, t_now=t_now)

    def add_allocation(self, t_s: int, t_e: int,
                       pes: Sequence[int]) -> None:
        self._backend.add_allocation(t_s, t_e, pes)

    def delete_allocation(self, t_s: int, t_e: int,
                          pes: Sequence[int]) -> None:
        self._backend.delete_allocation(t_s, t_e, pes)


class ReservationService:
    """The facade: validate one config, open any number of sessions.

    >>> svc = ReservationService(ServiceConfig(n_pe=64))
    >>> session = svc.session()
    >>> result = session.offer(requests)        # stream in arrivals
    >>> session.tick(now)                        # release completions
    """

    def __init__(self, config: Optional[ServiceConfig] = None, **kwargs):
        if config is None:
            config = ServiceConfig(**kwargs)
        elif kwargs:
            config = config.replace(**kwargs)
        self.config = config
        self.sessions: List[Session] = []

    def session(self) -> Session:
        """Open a fresh session (independent all-free state)."""
        s = Session(self)
        self.sessions.append(s)
        return s

    def metrics(self) -> Dict[str, Any]:
        """Config echo plus per-session counters."""
        return {"config": dataclasses.asdict(self.config),
                "n_sessions": len(self.sessions),
                "sessions": [s.metrics() for s in self.sessions]}


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


def _make_backend(cfg: ServiceConfig, counters: Dict[str, int]):
    if cfg.n_partitions > 1:
        return _PartitionBackend(cfg, counters)
    if cfg.lanes > 1:
        return _EnsembleBackend(cfg, counters)
    if cfg.engine == "device":
        return _StreamBackend(cfg, counters)
    return _HostBackend(cfg, counters)


class _BackendBase:
    """Policy resolution, growth budget and three-operation delegation."""

    def __init__(self, cfg: ServiceConfig, counters: Dict[str, int]):
        self.cfg = cfg
        self.counters = counters
        # an outstanding snapshot/restore holds the live state; the
        # reference must not donate it, so later offers go eager until
        # the next admission (the port keeps that routing)
        self._retained = False
        self._acc_dev: Optional[torch.Tensor] = None  # unsynced accepted
        # state-derived metrics, cached until the state changes
        self._dev_metrics: Optional[Dict[str, Any]] = None

    def resolve_policy(self, policy) -> Policy:
        if policy is None:
            return self.cfg.policy
        if isinstance(policy, str):
            return Policy(policy)
        return policy

    @property
    def growth_budget(self) -> int:
        """Growth retries per dispatch: 0 under ``auto_grow=False``, so
        an overflowing chunk raises without growing or committing."""
        return self.cfg.max_growths if self.cfg.auto_grow else 0

    def _grow_guard(self, before: Tuple[int, int],
                    after: Tuple[int, int]) -> None:
        if after != before:
            self.counters["growths"] += 1

    def _donate_ok(self) -> bool:
        return self.cfg.donate and not self._retained

    def _defer_accepted(self, decision: Decision, valid) -> None:
        """Accumulate the accepted count on the device, no host read;
        :meth:`_sync_counters` folds it in when metrics are read."""
        v = torch.from_numpy(np.asarray(valid, bool)).to(
            decision.accepted.device)
        n = (decision.accepted & v).sum()
        self._acc_dev = n if self._acc_dev is None else self._acc_dev + n

    def _sync_counters(self) -> None:
        if self._acc_dev is not None:
            self.counters["accepted"] += int(self._acc_dev)
            self._acc_dev = None

    def pending(self, lane: int = 0) -> list:
        if lane != 0:
            raise ValueError("lane applies to ensemble sessions")
        return []

    def cancel_many(self, triples, lane: int = 0) -> List[bool]:
        return [self.cancel(ts, te, list(pes), lane=lane)
                for ts, te, pes in triples]

    def find_allocation(self, req, policy, t_now=None):
        return self.engine.find_allocation(req, policy, t_now=t_now)

    def add_allocation(self, t_s, t_e, pes):
        self.engine.add_allocation(t_s, t_e, list(pes))

    def delete_allocation(self, t_s, t_e, pes):
        self.engine.delete_allocation(t_s, t_e, list(pes))

    def records(self, lane: int = 0):
        if lane != 0:
            raise ValueError("lane applies to ensemble sessions")
        return self.engine.records()


class _RingBackend(_BackendBase):
    """Ring-staged chunked offers, shared by the one-lane and the
    ensemble backends.

    Each lane stages its stream in a ring of its own (one ring on a
    one-lane session), and a chunk pops every ring's head.  A backend
    supplies its lanes' state (``_live``, :meth:`_lanes`), the pop, the
    admission of a chunk (eager and donated), the rollback growth and a
    lane's part of a popped chunk.  Only the time at which a pipelined
    offer's overflow latches are read differs, as in the reference: a
    one-lane session reads them at the next read of its state
    (:meth:`_settle`), an ensemble at the end of each offer.
    """

    #: the request axis of a chunk's decisions, batch and valid mask
    _axis = 0

    def __init__(self, cfg: ServiceConfig, counters: Dict[str, int]):
        super().__init__(cfg, counters)
        self.rings = ([RequestRing(cfg.ring_capacity,
                                   extra_demand=cfg.extra_demand,
                                   with_tenant=cfg.tenancy)
                       for _ in range(cfg.lanes)]
                      if cfg.chunk_size else None)
        # host syncs, admit steps and release passes of every dispatch
        self.stats = batch_lib.StreamStats()

    def _settle(self) -> None:
        """Settle every offer whose overflow latches are unread."""

    def _lane_part(self, batch: RequestBatch, valid, e: int):
        """Lane ``e``'s ``[M]`` batch and valid mask of a popped chunk."""
        return batch, valid

    def _push_all(self, streams, cursors) -> None:
        for e, (ring, stream) in enumerate(zip(self.rings, streams)):
            take = min(ring.free, len(stream) - cursors[e])
            ring.push(stream[cursors[e]:cursors[e] + take])
            cursors[e] += take

    def _result(self, decs, batches, valids) -> OfferResult:
        if not decs:
            return _empty_result()
        res = OfferResult(decision=_concat_tree(decs, axis=self._axis),
                          batch=_concat_tree(batches, axis=self._axis),
                          valid=np.concatenate(valids, axis=self._axis))
        self._defer_accepted(res.decision, res.valid)
        return res

    def _offer_eager(self, streams, pid, flush) -> OfferResult:
        chunk = self.cfg.chunk_size
        decs: List[Decision] = []
        batches: List[RequestBatch] = []
        valids: List[np.ndarray] = []

        def drain_one(full_only: bool):
            # keep the rings intact if the chunk raises (auto_grow=False
            # overflow): the popped requests stay staged for a retry.  A
            # lane below a full chunk keeps its requests staged unless
            # this is a flushing drain (the flush=False contract)
            ring_snaps = [r.snapshot() for r in self.rings]
            batch, valid = self._pop(full_only)
            try:
                decs.append(self._admit_batch(batch, pid))
            except Exception:
                for r, snap in zip(self.rings, ring_snaps):
                    r.restore(snap)
                raise
            batches.append(batch)
            valids.append(valid)
            self.counters["chunks"] += 1

        cursors = [0] * len(self.rings)
        while any(c < len(s) for c, s in zip(cursors, streams)):
            self._push_all(streams, cursors)
            while any(r.count >= chunk for r in self.rings):
                drain_one(full_only=not flush)
        if flush:
            while any(r.count for r in self.rings):
                drain_one(full_only=False)
        return self._result(decs, batches, valids)

    def _pipeline(self, streams, pid, flush) -> dict:
        """Stage and dispatch an offer's chunks with no read of any
        overflow latch, chunk k+1 popped while chunk k runs.

        Returns the offer's chunks (``decs``, ``batches``, ``valids``),
        their latches (``ovfs``) and every ring's last popped arrival
        before each chunk (``ltas``, for a restage).
        """
        chunk = self.cfg.chunk_size
        ctx = dict(decs=[], batches=[], valids=[], ovfs=[], pid=pid,
                   ltas=[[r.last_popped_t_a for r in self.rings]])
        staged = None

        def stage(full_only: bool):
            popped = self._pop(full_only)
            ctx["ltas"].append([r.last_popped_t_a for r in self.rings])
            return popped

        def dispatch(cur) -> None:
            batch, valid = cur
            dec, ovf = self._admit_donated(batch, pid)
            ctx["ovfs"].append(ovf)
            ctx["decs"].append(dec)
            ctx["batches"].append(batch)
            ctx["valids"].append(valid)
            self.counters["chunks"] += 1

        def drain(more, full_only: bool) -> None:
            nonlocal staged
            while staged is not None or more():
                cur = staged if staged is not None else stage(full_only)
                staged = None
                dispatch(cur)          # admit chunk k ...
                if more():
                    staged = stage(full_only)   # ... then stage k+1

        cursors = [0] * len(self.rings)
        while any(c < len(s) for c, s in zip(cursors, streams)):
            self._push_all(streams, cursors)
            drain(lambda: any(r.count >= chunk for r in self.rings),
                  full_only=not flush)
        if flush:
            drain(lambda: any(r.count for r in self.rings), full_only=False)
        return ctx

    def _replay_chunks(self, j: int, ctx: dict, *,
                       rollback: bool) -> Optional[Exception]:
        """Re-run one offer's chunks ``j..`` after a latched overflow.

        ``rollback`` grows the rolled-back state first (only for the
        offer owning the first latched chunk).  On terminal overflow the
        failing chunk is noted (``ctx["fail_k"]``) and the
        :class:`~repro_torch.core.batch.GrowthError` is returned.
        """
        if rollback:
            before = self._capacities()
            self._grow_rollback()
            self._grow_guard(before, self._capacities())
        batches, decs = ctx["batches"], ctx["decs"]
        for k in range(j, len(batches)):
            try:
                decs[k] = self._admit_batch(batches[k], ctx["pid"])
            except batch_lib.GrowthError as e:
                ctx["fail_k"] = k
                return e
        return None

    def _cut(self, ctx: dict, k: int) -> None:
        """Cut an offer at chunk ``k``: its undecided chunks go back to
        the front of the rings, in order.

        The eager path would have left these requests staged, so they go
        back ahead of anything pushed later.  Requests that no longer
        fit are dropped with a warning; the session stays usable on the
        rolled-back state.
        """
        batches, valids = ctx["batches"], ctx["valids"]
        self.counters["chunks"] -= len(batches) - k
        dropped = 0
        for e, ring in enumerate(self.rings):
            rows = [row for batch, valid in zip(batches[k:], valids[k:])
                    for row in _staged_rows(*self._lane_part(batch, valid, e),
                                            ring._fields)]
            dropped += _push_front(ring, rows, ctx["ltas"][k][e])
        del ctx["decs"][k:], batches[k:], valids[k:]
        if dropped:
            warnings.warn(
                f"ring full while restaging after terminal overflow: "
                f"{dropped} undecided requests dropped",
                RuntimeWarning, stacklevel=3)

    def snapshot(self):
        self._settle()
        self._sync_counters()
        self._retained = True
        return (self._live,
                [r.snapshot() for r in self.rings] if self.rings else None)

    def restore(self, payload):
        self._settle()           # settle results against the old state
        live, ring_snaps = payload
        self._live = live
        self._retained = True
        self._acc_dev = None     # accumulated after the snapshot
        if self.rings and ring_snaps is not None:
            for r, snap in zip(self.rings, ring_snaps):
                r.restore(snap)

    def _refresh_dev_metrics(self) -> None:
        """One host read of every state-derived counter, summed over the
        lanes, and every lane's tenant telemetry (``[E, T]`` on an
        ensemble)."""
        lanes = self._lanes()
        dev = ens_lib.home(lanes)
        n_pending = sum((s.pend_te != T_INF).sum().to(dev) for s in lanes)
        tables = [s.tenants for s in lanes if s.tenants is not None]
        if not self.cfg.backfilling and not tables:
            self._dev_metrics = dict(n_pending=int(n_pending))
            return
        vals = dict(n_pending=n_pending)
        if self.cfg.backfilling:
            vals["n_parked_now"] = sum((s.park_seq != T_INF).sum().to(dev)
                                       for s in lanes)
            for f in ("n_parked", "n_promoted", "n_moved"):
                vals[f] = sum(getattr(s, f).to(dev) for s in lanes)
        flat = torch.cat(
            [torch.stack([v.to(torch.int32) for v in vals.values()])]
            + [telemetry.pack(t).to(dev) for t in tables])
        host = flat.cpu().numpy()
        self._dev_metrics = dict(zip(vals, (int(v) for v in host)))
        if tables:
            T = tables[0].n_tenants
            width = (len(telemetry.SNAPSHOT_FIELDS) - 1) * T + 1
            per_lane = [telemetry.unpack(
                host[len(vals) + e * width:len(vals) + (e + 1) * width], T)
                for e in range(len(tables))]
            self._dev_metrics["tenants"] = per_lane[0] if len(lanes) == 1 \
                else {f: np.stack([np.asarray(a[f]) for a in per_lane])
                      for f in telemetry.SNAPSHOT_FIELDS}

    def metrics(self) -> Dict[str, Any]:
        # an idle poll (nothing in flight, nothing deferred, the cache
        # warm) reads nothing from the device
        self._settle()
        self._sync_counters()
        if self._dev_metrics is None:
            self._refresh_dev_metrics()
        cap, pend = self._capacities()
        st = self.stats
        out = dict(capacity=cap, pending_capacity=pend, steps=st.steps,
                   host_syncs=st.host_syncs,
                   release_passes=st.release_passes,
                   early_rejects=st.early_rejects)
        out.update(self._dev_metrics)
        if self.rings:
            out.update(ring_capacity=self.cfg.ring_capacity,
                       ring_staged=sum(r.count for r in self.rings),
                       ring_wrapped=any(r.wrapped for r in self.rings))
        if self.cfg.backfilling:
            out.update(park_capacity=self._lanes()[0].park_capacity,
                       retry_searches=st.retry_searches,
                       displace_searches=st.displace_searches,
                       displacements=st.displacements,
                       reject_displacements=st.reject_displacements)
        return out


class _StreamBackend(_RingBackend):
    """One device timeline with ring-buffer chunked streaming."""

    def __init__(self, cfg: ServiceConfig, counters: Dict[str, int]):
        super().__init__(cfg, counters)
        mu = cfg.machine_units
        # a 1-tuple of tenant specs is the one-lane spelling of the
        # per-lane form
        spec = cfg.lane_tenant_specs[0] if cfg.tenancy else None
        self.engine = DeviceEngine(
            cfg.n_pe, capacity=cfg.capacity, use_kernel=cfg.use_kernel,
            pending_capacity=cfg.pending_capacity, device=cfg.device,
            park_capacity=cfg.park_capacity, rspec=cfg.rspec,
            live_units=mu[0] if mu is not None else None,
            index_tile=cfg.index_tile, tenants=spec)
        self._rspec = cfg.rspec
        self._n_tenants = spec.n_tenants if spec is not None else 0
        self._grace = spec.grace if spec is not None else None
        self._bf = batch_lib.BF_NONE if not cfg.backfilling else \
            batch_lib.as_backfill_id(cfg.backfill)
        self.device = self.engine.tl.device
        # pipelined offers whose overflow latches are unread
        self._inflight: List[dict] = []

    @property
    def ring(self) -> Optional[RequestRing]:
        return self.rings[0] if self.rings else None

    @property
    def _state(self):
        return self.engine.state

    @_state.setter
    def _state(self, s):
        self.engine.state = s
        self.engine._n_valid = None      # recounted on the next search
        self._dev_metrics = None         # state-derived metrics are stale

    _live = _state

    def _lanes(self):
        return (self._state,)

    def _capacities(self) -> Tuple[int, int]:
        s = self._state
        return (s.tl.capacity, s.pending_capacity)

    def _admit_batch(self, batch: RequestBatch, pid: int) -> Decision:
        before = self._capacities()
        try:
            state, dec = batch_lib.admit_stream_grow(
                self._state, batch, pid, n_pe=self.cfg.n_pe,
                backfill=self._bf, auto_release=self.cfg.auto_release,
                use_kernel=self.cfg.use_kernel,
                max_growths=self.growth_budget, stats=self.stats,
                donate=self._donate_ok())
        except batch_lib.GrowthError as e:
            if e.state is not None:
                # the rolled-back state, latch cleared, as the
                # reference reinstalls after its donated attempt
                self._state = e.state._replace(
                    overflow=torch.zeros_like(e.state.overflow))
            raise
        self._grow_guard(before, (state.tl.capacity,
                                  state.pending_capacity))
        self._state = state
        self._retained = False
        return dec

    def _admit_donated(self, batch: RequestBatch, pid: int):
        state, dec = batch_lib.admit_stream_donated(
            self._state, batch, pid, self._bf, n_pe=self.cfg.n_pe,
            auto_release=self.cfg.auto_release,
            use_kernel=self.cfg.use_kernel, stats=self.stats)
        self._state = state
        return dec, state.overflow

    def _grow_rollback(self) -> None:
        self._state = batch_lib.grow_rollback(self._state, self.stats)

    def _pop(self, full_only: bool):
        # one lane pops only full chunks unless it flushes
        return self.ring.pop_chunk(self.cfg.chunk_size, self.cfg.n_pe,
                                   self.device)

    # the three operations and records read (or change) the live
    # state: settle any in-flight offers first
    def find_allocation(self, req, policy, t_now=None):
        self._drain_inflight()
        return self.engine.find_allocation(req, policy, t_now=t_now)

    def add_allocation(self, t_s, t_e, pes):
        self._drain_inflight()
        self.engine.add_allocation(t_s, t_e, list(pes))

    def delete_allocation(self, t_s, t_e, pes):
        self._drain_inflight()
        self.engine.delete_allocation(t_s, t_e, list(pes))

    def records(self, lane: int = 0):
        if lane != 0:
            raise ValueError("lane applies to ensemble sessions")
        self._drain_inflight()
        return self.engine.records()

    def pending(self, lane: int = 0) -> list:
        if lane != 0:
            raise ValueError("lane applies to ensemble sessions")
        self._drain_inflight()
        return batch_lib.parked_entries(self._state)

    def offer(self, requests, *, policy, routing, flush) -> OfferResult:
        if routing is not None:
            raise ValueError("routing applies to partitioned sessions")
        if not flush and self.ring is None:
            raise ValueError(
                "flush=False staging needs the ring buffer; this session "
                "is one-shot (chunk_size=None)")
        pid = policy_id_of(self.resolve_policy(policy))
        if isinstance(requests, RequestBatch):
            # pre-packed batch: the pre-materialised-experiment path
            if self.ring is not None:
                raise ValueError(
                    "a pre-packed RequestBatch bypasses the ring; use "
                    "chunk_size=None (one-shot mode) or offer ARRequest "
                    "sequences")
            return self._one_shot(requests, requests.t_a.shape[0], pid)
        reqs = list(requests)
        self._check_tenants(reqs)
        _check_demands(self._rspec, reqs)
        if self.ring is None:
            if not reqs:
                return _empty_result()
            batch = batch_lib.requests_to_batch(
                reqs, self.device, extra_demand=self.cfg.extra_demand,
                with_tenant=self.cfg.tenancy)
            return self._one_shot(batch, len(reqs), pid)
        batch_lib.check_arrival_order(reqs, self.ring.last_t_a)
        self.counters["offered"] += len(reqs)
        if self._donate_ok() and self.growth_budget > 0:
            return self._offer_pipelined(reqs, pid, flush)
        self._drain_inflight()
        return self._offer_eager([reqs], pid, flush)

    def _check_tenants(self, reqs) -> None:
        if self._n_tenants:
            for r in reqs:
                if r.tenant >= self._n_tenants:
                    raise ValueError(
                        f"request tenant {r.tenant} out of range "
                        f"[0, {self._n_tenants}) for this session's "
                        f"TenantSpec")

    def _one_shot(self, batch: RequestBatch, n: int, pid: int
                  ) -> OfferResult:
        self.counters["offered"] += n
        dec = self._admit_batch(batch, pid)
        self.counters["one_shot_scans"] += 1
        res = OfferResult(decision=dec, batch=batch, valid=np.ones(n, bool))
        self._defer_accepted(res.decision, res.valid)
        return res

    def _offer_pipelined(self, reqs, pid, flush) -> OfferResult:
        """Chunked admission with no read of any chunk's overflow latch.

        Every chunk runs through
        :func:`~repro_torch.core.batch.admit_stream_donated`, whose
        latched rollback makes every chunk after an overflowing one
        leave the state as it found it.  The offer registers itself on
        ``_inflight`` and returns a deferred :class:`OfferResult`;
        :meth:`_drain_inflight` reads all outstanding latches at once
        and replays from the first latched chunk on a grown state, so
        the decisions equal the eager path's.
        """
        ctx = self._pipeline([reqs], pid, flush)
        if not ctx["decs"]:
            return _empty_result()
        ctx["result"] = res = OfferResult(_finalize=self._drain_inflight)
        self._inflight.append(ctx)
        return res

    def _drain_inflight(self) -> None:
        """Settle every in-flight pipelined offer with one host read.

        All outstanding overflow latches cross in one transfer.  When
        none is set every offer's decisions stand.  Otherwise the latched
        rollback left ``_state`` at the first latched chunk, sized by
        its high-water marks: grow once, replay that offer's tail, then
        every chunk of the later offers (their decisions are garbage),
        which decides what the eager path decides.
        """
        if not self._inflight:
            return
        inflight, self._inflight = self._inflight, []
        all_ovfs = [o for ctx in inflight for o in ctx["ovfs"]]
        latched = torch.stack(all_ovfs).cpu().numpy()
        self.stats.sync()
        err = None
        if latched.any():
            g = int(latched.argmax())     # first latched chunk
            c = 0                          # -> (offer c, its chunk g)
            while g >= len(inflight[c]["ovfs"]):
                g -= len(inflight[c]["ovfs"])
                c += 1
            for ci in range(c, len(inflight)):
                ctx = inflight[ci]
                err = self._replay_chunks(g if ci == c else 0, ctx,
                                          rollback=(ci == c))
                if err is not None:
                    # terminal overflow: restage the undecided requests
                    # in arrival order, the newest offer first so the
                    # oldest tail ends up at the ring's head
                    for later in reversed(inflight[ci + 1:]):
                        self._cut(later, 0)
                    self._cut(ctx, ctx["fail_k"])
                    break
        for ctx in inflight:
            res = ctx["result"]
            res._finalize = None
            if ctx["decs"]:
                res._decision = _concat_tree(ctx["decs"], axis=0)
                res._batch = _concat_tree(ctx["batches"], axis=0)
                res._valid = np.concatenate(ctx["valids"])
                self._defer_accepted(res._decision, res._valid)
            else:
                res._allocations = []
        if err is not None:
            raise err

    _settle = _drain_inflight

    def tick(self, t: int) -> int:
        if not self.cfg.auto_release:
            return self._reap(t)
        self._drain_inflight()
        before_rel = int(self._state.n_released)
        before = self._capacities()
        state = batch_lib.release_until(self._state, t,
                                        max_growths=self.growth_budget,
                                        stats=self.stats)
        self._grow_guard(before, (state.tl.capacity,
                                  state.pending_capacity))
        self._state = state
        released = int(state.n_released) - before_rel
        self.counters["released"] += released
        return released

    def _reap(self, t: int) -> int:
        """Overdue reaping: with ``auto_release=False`` the caller owns
        release, but a multi-tenant session with a ``grace`` window
        deletes the reservations held past ``t_e + grace`` and charges
        them to their tenants (``n_reaped``).  An auto-release session
        never reaps: its ``tick`` already released everything ending by
        ``t``, earlier than ``t - grace``."""
        if self._grace is None:
            return 0
        self._drain_inflight()
        before_rel = int(self._state.n_released)
        before = self._capacities()
        state = batch_lib.reap_until(self._state, t, self._grace,
                                     max_growths=self.growth_budget,
                                     stats=self.stats)
        self._grow_guard(before, (state.tl.capacity,
                                  state.pending_capacity))
        self._state = state
        reaped = int(state.n_released) - before_rel
        self.counters["reaped"] += reaped
        return reaped

    def _mask(self, pe_ids) -> torch.Tensor:
        limit = None if self._rspec is not None else self.cfg.n_pe
        return tl_lib.ids_to_mask32(sorted(pe_ids), self._state.tl.words,
                                    n_pe=limit, device=self.device)

    def cancel(self, t_s: int, t_e: int, pe_ids: List[int],
               lane: int = 0) -> bool:
        if lane != 0:
            raise ValueError("lane applies to ensemble sessions")
        self._drain_inflight()
        mask = self._mask(pe_ids)
        before = self._capacities()
        state, done = batch_lib.cancel_one(
            self._state, t_s, t_e, mask,
            require_pending=self.cfg.auto_release,
            max_growths=self.growth_budget)
        self._grow_guard(before, (state.tl.capacity,
                                  state.pending_capacity))
        self._state = state
        self.counters["cancelled"] += int(done)
        return done

    def cancel_many(self, triples, lane: int = 0) -> List[bool]:
        if lane != 0:
            raise ValueError("lane applies to ensemble sessions")
        self._drain_inflight()
        entries = [(ts, te, self._mask(pes)) for ts, te, pes in triples]
        before = self._capacities()
        state, done = batch_lib.cancel_many(
            self._state, entries, require_pending=self.cfg.auto_release,
            max_growths=self.growth_budget)
        self._grow_guard(before, (state.tl.capacity,
                                  state.pending_capacity))
        self._state = state
        self.counters["cancelled"] += sum(done)
        return done


class _EnsembleBackend(_RingBackend):
    """E lanes of one capacity behind one session.

    Every chunk (or one-shot batch) runs each lane's row through that
    lane (:func:`~repro_torch.core.ensemble.admit_stream_ensemble_auto`);
    a lane's overflow grows every lane once and re-runs them all from
    the pre-run lanes.  Each lane stages its stream in a ring of its
    own.  The pipelined offer reads every chunk's latch in one host
    read at its end and replays from the first latched chunk on the
    grown ensemble.
    """

    _axis = 1

    def __init__(self, cfg: ServiceConfig, counters: Dict[str, int]):
        super().__init__(cfg, counters)
        self.device = resolve_device(cfg.device)
        self._lane_specs = cfg.lane_tenant_specs
        # per-lane tables padded to one width; None lanes get neutral
        # tables, which decide as no table does
        tables = None if self._lane_specs is None else lane_tables(
            self._lane_specs, cfg.pending_capacity, cfg.park_capacity,
            self.device)
        # lane i lives on card i // (E / d) of the placement's mesh;
        # decisions are the same on every placement
        self.mesh = resolve_placement(cfg.placement, cfg.lanes, self.device)
        self.states = shard_rules.shard_ensemble(
            self.mesh, ens_lib.init_ensemble(
                cfg.lanes, cfg.capacity, cfg.n_pe, cfg.pending_capacity,
                cfg.park_capacity, tenants=tables, rspec=cfg.rspec,
                machine_units=cfg.machine_units, index_tile=cfg.index_tile,
                device=self.device))
        self._bf_ids = ens_lib.backfill_ids(cfg.backfill, cfg.lanes)

    @property
    def states(self):
        return self._states

    @states.setter
    def states(self, s):
        self._states = s
        self._dev_metrics = None         # state-derived metrics are stale

    _live = states

    def _lanes(self):
        return self.states

    @property
    def engine(self):
        return self

    def _capacities(self) -> Tuple[int, int]:
        return ens_lib.lane_capacity(self.states)

    def metrics(self) -> Dict[str, Any]:
        out = super().metrics()
        out["placement_shards"] = 1 if self.mesh is None \
            else data_shards(self.mesh)
        return out

    def _lane(self, lane: int) -> int:
        if not 0 <= lane < self.cfg.lanes:
            raise ValueError(
                f"lane {lane} out of range for {self.cfg.lanes} lanes")
        return lane

    def _lane_part(self, batch: RequestBatch, valid, e: int):
        return ens_lib.lane_of(batch, e), valid[e]

    def _resolve_pids(self, policy) -> Tuple[int, ...]:
        E = self.cfg.lanes
        if policy is None:
            policy = self.cfg.policy
        if isinstance(policy, (Policy, int, np.integer, str)):
            return (policy_id_of(policy),) * E
        if isinstance(policy, torch.Tensor):
            policy = policy.cpu().tolist()
        pids = tuple(policy_id_of(p) for p in policy)
        if len(pids) != E:
            raise ValueError(f"{len(pids)} policies for {E} lanes")
        return pids

    def _admit_batch(self, batch: RequestBatch, pids) -> Decision:
        before = self._capacities()
        try:
            states, dec = ens_lib.admit_stream_ensemble_auto(
                self.states, batch, pids, n_pe=self.cfg.n_pe,
                backfills=self._bf_ids, auto_release=self.cfg.auto_release,
                use_kernel=self.cfg.use_kernel,
                max_growths=self.growth_budget, donate=self._donate_ok(),
                stats=self.stats)
        except batch_lib.GrowthError as e:
            if e.state is not None:
                # the rolled-back lanes, latches cleared
                self.states = tuple(
                    s._replace(overflow=torch.zeros_like(s.overflow))
                    for s in e.state)
            raise
        self._grow_guard(before, ens_lib.lane_capacity(states))
        self.states = states
        self._retained = False
        return dec

    def _admit_donated(self, batch: RequestBatch, pids):
        states, dec = ens_lib.admit_stream_ensemble_donated(
            self.states, batch, pids, self._bf_ids, n_pe=self.cfg.n_pe,
            auto_release=self.cfg.auto_release,
            use_kernel=self.cfg.use_kernel, stats=self.stats)
        self.states = states
        return dec, ens_lib.gather([s.overflow for s in states],
                                   ens_lib.home(states)).any()

    def _grow_rollback(self) -> None:
        self.states = ens_lib.grow_rollback_ensemble(self.states, self.stats)

    def _pop(self, full_only: bool):
        return batch_lib.pop_chunk_ensemble(
            self.rings, self.cfg.chunk_size, self.cfg.n_pe,
            full_only=full_only, device=self.device)

    def pending(self, lane: int = 0) -> list:
        return batch_lib.parked_entries(self.states[self._lane(lane)])

    def offer(self, streams, *, policy, routing, flush) -> OfferResult:
        if routing is not None:
            raise ValueError("routing applies to partitioned sessions")
        if not flush and self.rings is None:
            raise ValueError(
                "flush=False staging needs the ring buffers; this session "
                "is one-shot (chunk_size=None)")
        pids = self._resolve_pids(policy)
        if isinstance(streams, tuple) and len(streams) == 2 \
                and isinstance(streams[0], RequestBatch):
            # pre-padded (batch, valid): the grid's one-shot path
            if self.rings is not None:
                raise ValueError(
                    "a pre-padded (RequestBatch, valid) pair bypasses the "
                    "rings; use chunk_size=None (one-shot mode)")
            batch, valid = streams
            return self._one_shot(batch, np.asarray(valid, bool), pids)
        streams = [list(s) for s in streams] or \
            [[] for _ in range(self.cfg.lanes)]
        if len(streams) != self.cfg.lanes:
            raise ValueError(f"{len(streams)} per-lane streams for "
                             f"{self.cfg.lanes} lanes")
        if self.rings is not None:
            for ring, stream in zip(self.rings, streams):
                batch_lib.check_arrival_order(stream, ring.last_t_a)
        if self._lane_specs is not None:
            for e, (spec, stream) in enumerate(zip(self._lane_specs,
                                                   streams)):
                limit = spec.n_tenants if spec is not None else 1
                for r in stream:
                    if r.tenant >= limit:
                        raise ValueError(
                            f"request tenant {r.tenant} out of range "
                            f"[0, {limit}) for lane {e}'s TenantSpec")
        for stream in streams:
            _check_demands(self.cfg.rspec, stream)
        if self.rings is None:
            if not any(streams):
                return _empty_result()
            batch, valid = batch_lib.pad_streams(
                streams, self.cfg.n_pe, with_tenant=self.cfg.tenancy,
                extra_demand=self.cfg.extra_demand, device=self.device)
            return self._one_shot(batch, valid, pids)
        self.counters["offered"] += sum(map(len, streams))
        if self._donate_ok() and self.growth_budget > 0:
            return self._offer_pipelined(streams, pids, flush)
        return self._offer_eager(streams, pids, flush)

    def _one_shot(self, batch, valid, pids) -> OfferResult:
        self.counters["offered"] += int(valid.sum())
        dec = self._admit_batch(batch, pids)
        self.counters["one_shot_scans"] += 1
        res = OfferResult(decision=dec, batch=batch, valid=valid)
        self._defer_accepted(dec, valid)
        return res

    def _offer_pipelined(self, streams, pids, flush) -> OfferResult:
        """Chunked admission with one read of every chunk's latch.

        Every chunk runs through :func:`~repro_torch.core.ensemble.
        admit_stream_ensemble_donated`, whose latched rollback leaves the
        lanes as they were from the first overflowing chunk on; the
        latches cross in one read at the end of the offer, and a latched
        chunk replays on the collectively grown ensemble, deciding as
        the eager offer does.
        """
        ctx = self._pipeline(streams, pids, flush)
        if ctx["decs"]:
            latched = torch.stack(ctx["ovfs"]).cpu().numpy()
            self.stats.sync()
            if latched.any():
                err = self._replay_chunks(int(latched.argmax()), ctx,
                                          rollback=True)
                if err is not None:
                    self._cut(ctx, ctx["fail_k"])
                    raise err
        return self._result(ctx["decs"], ctx["batches"], ctx["valids"])

    def _n_released(self) -> int:
        return int(ens_lib.gather([s.n_released for s in self.states],
                                  ens_lib.home(self.states)).sum())

    def tick(self, t: int) -> int:
        if not self.cfg.auto_release:
            return self._reap(t)
        before_rel = self._n_released()
        before = self._capacities()
        self.states = ens_lib.release_until_ensemble(
            self.states, t, max_growths=self.growth_budget, stats=self.stats)
        self._grow_guard(before, self._capacities())
        released = self._n_released() - before_rel
        self.counters["released"] += released
        return released

    def _reap(self, t: int) -> int:
        """Per-lane overdue reaping: each lane with its own spec's
        grace; a lane without one gets ``T_INF``, which reaps nothing."""
        if self._lane_specs is None:
            return 0
        graces = [T_INF if s is None or s.grace is None else s.grace
                  for s in self._lane_specs]
        if all(g == T_INF for g in graces):
            return 0
        before_rel = self._n_released()
        before = self._capacities()
        self.states = ens_lib.reap_until_ensemble(
            self.states, t, graces, max_growths=self.growth_budget,
            stats=self.stats)
        self._grow_guard(before, self._capacities())
        reaped = self._n_released() - before_rel
        self.counters["reaped"] += reaped
        return reaped

    def cancel(self, t_s: int, t_e: int, pe_ids: List[int],
               lane: int = 0) -> bool:
        one = self.states[self._lane(lane)]
        limit = None if self.cfg.rspec is not None else self.cfg.n_pe
        mask = tl_lib.ids_to_mask32(sorted(pe_ids), one.tl.words,
                                    n_pe=limit, device=one.tl.device)
        state, done = batch_lib.cancel_one(
            one, t_s, t_e, mask, require_pending=self.cfg.auto_release,
            max_growths=self.growth_budget)
        if (state.tl.capacity, state.pending_capacity) != \
                self._capacities():
            # growth stays collective: grow every lane, cancel again
            self.states = ens_lib.grow_ensemble(
                self.states, state.tl.capacity, state.pending_capacity)
            self.counters["growths"] += 1
            state, done = batch_lib.cancel_one(
                self.states[lane], t_s, t_e, mask,
                require_pending=self.cfg.auto_release,
                max_growths=self.growth_budget)
        self.states = ens_lib.set_member(self.states, lane, state)
        self.counters["cancelled"] += int(done)
        return done

    def find_allocation(self, req, policy, t_now=None):
        raise NotImplementedError(
            "ensemble sessions decide per lane; use offer() with per-lane "
            "streams")

    add_allocation = delete_allocation = find_allocation

    def records(self, lane: int = 0):
        tl = self.states[self._lane(lane)].tl
        times, occ = tl.times.cpu().numpy(), tl.occ.cpu().numpy()
        return [(int(t), frozenset(batch_lib.mask32_to_ids(row)))
                for t, row in zip(times, occ) if t < T_INF]


class _PartitionBackend(_BackendBase):
    """Cluster partitions (machine slices) with routed bulk admission.

    The engine is a :class:`~repro_torch.runtime.fleet.PartitionedCore`;
    every offer is decided at once (no ring).  Tenancy is enforced at
    the host router, the lane states keeping no tenant table: a
    :class:`~repro_torch.tenancy.HostTenantAccounts` gate before routing,
    and a completion ledger attributing each held reservation to its
    tenant for release and overdue reaping.  The router's EWMAs round as
    the reference's router does (:func:`~repro_torch.tenancy.table.
    ewma_router`).
    """

    def __init__(self, cfg: ServiceConfig, counters: Dict[str, int]):
        super().__init__(cfg, counters)
        from repro_torch.runtime.fleet import PartitionedCore

        self.engine = PartitionedCore(
            cfg.n_pe, cfg.n_partitions, capacity=cfg.capacity,
            pending_capacity=cfg.pending_capacity,
            use_kernel=cfg.use_kernel, placement=cfg.placement,
            device=cfg.device,
            park_capacity=cfg.park_capacity, backfill=cfg.backfill,
            auto_release=cfg.auto_release, index_tile=cfg.index_tile)
        self._accounts = None
        self._grace = None
        if cfg.tenancy:
            from repro_torch.tenancy import HostTenantAccounts
            self._accounts = HostTenantAccounts(cfg.tenants, router=True)
            self._grace = cfg.tenants.grace
        self._ledger: list = []   # heap of (t_e, seq, tid, t_s, ids)
        self._lseq = 0

    def _n_released(self) -> int:
        return int(torch.stack([s.n_released
                                for s in self.engine.states]).sum())

    def _ledger_release(self, t: int) -> None:
        """Mirror the engine's completion releases ending by ``t``."""
        while self._ledger and self._ledger[0][0] <= t:
            _, _, tid, _, _ = heapq.heappop(self._ledger)
            self._accounts.release(tid)

    def offer(self, requests, *, policy, routing, flush) -> OfferResult:
        routing = routing or self.cfg.routing
        if routing not in ROUTINGS:
            raise ValueError(
                f"unknown routing {routing!r}; pick one of {ROUTINGS}")
        if not flush:
            raise ValueError(
                "flush=False staging is a ring-buffer (device session) "
                "feature; partitioned sessions decide every offer "
                "immediately")
        reqs = list(requests)
        self.counters["offered"] += len(reqs)
        if not reqs:
            return _empty_result()
        pol = self.resolve_policy(policy)
        if self._accounts is None:
            allocs = self.engine.admit_stream_allocations(reqs, pol, routing)
        else:
            allocs = self._offer_gated(reqs, pol, routing)
        self.counters["accepted"] += sum(a is not None for a in allocs)
        self.counters["one_shot_scans"] += 1
        return OfferResult(_allocations=allocs)

    def _offer_gated(self, reqs, pol, routing):
        """Quota-gated routing: reject over-quota requests before the
        probe.

        The device path's gate order: releases ending by the arrival
        settle first (so ``live`` counts the post-release population),
        then the float32 quota and live-cap check, then routing, one
        request at a time, for the requests that pass.  The router has
        no single machine occupancy across partitions, so the occupancy
        EWMA sees 0.
        """
        acc = self._accounts
        allocs: List[Optional[Allocation]] = []
        for req in reqs:
            if acc.n_tenants and req.tenant >= acc.n_tenants:
                raise ValueError(
                    f"request tenant {req.tenant} out of range "
                    f"[0, {acc.n_tenants}) for this session's TenantSpec")
            if self.cfg.auto_release:
                self._ledger_release(req.t_a)
            tid = acc.clip_tid(req.tenant)
            if not acc.allowed(tid, req.n_pe, req.t_du):
                acc.record(tid, accepted=False, blocked=True, parked=False,
                           occ_frac=np.float32(0.0))
                allocs.append(None)
                continue
            alloc = self.engine.admit_stream_allocations(
                [req], pol, routing)[0]
            acc.record(tid, accepted=alloc is not None, blocked=False,
                       parked=False, occ_frac=np.float32(0.0),
                       t_e=alloc.t_e if alloc else -1, t_r=req.t_r,
                       t_du=req.t_du, n_pe=req.n_pe)
            if alloc is not None:
                heapq.heappush(self._ledger,
                               (alloc.t_e, self._lseq, tid, alloc.t_s,
                                tuple(alloc.pe_ids)))
                self._lseq += 1
            allocs.append(alloc)
        return allocs

    def tick(self, t: int) -> int:
        # with auto_release=False the client owns completion release
        # (cancel / delete_allocation), and a tenanted session reaps;
        # otherwise every lane's pending buffer advances
        if not self.cfg.auto_release:
            return self._reap(t)
        before = self._n_released()
        self.engine.release_until(t)
        if self._accounts is not None:
            self._ledger_release(t)
        released = self._n_released() - before
        self.counters["released"] += released
        return released

    def _reap(self, t: int) -> int:
        """Ledger-driven overdue reaping at the host router."""
        if self._accounts is None or self._grace is None:
            return 0
        reaped = 0
        cutoff = t - self._grace
        while self._ledger and self._ledger[0][0] <= cutoff:
            t_e, _, tid, t_s, ids = heapq.heappop(self._ledger)
            self.engine.delete_allocation(t_s, t_e, list(ids))
            self._accounts.reap(tid)
            reaped += 1
        self.counters["reaped"] += reaped
        return reaped

    def pending(self, lane: int = 0) -> list:
        if not 0 <= lane < self.cfg.n_partitions:
            raise ValueError(f"lane {lane} out of range for "
                             f"{self.cfg.n_partitions} partitions")
        if not self.cfg.backfilling:
            return []
        return batch_lib.parked_entries(self.engine.states[lane])

    def cancel(self, t_s, t_e, pe_ids, lane: int = 0) -> bool:
        if lane != 0:
            raise ValueError(
                "partitioned sessions address reservations by global "
                "chip ids, not lanes")
        eng = self.engine
        if not self.cfg.auto_release:
            eng.delete_allocation(t_s, t_e, list(pe_ids))
            self._ledger_cancel(t_s, t_e, pe_ids)
            self.counters["cancelled"] += 1
            return True
        # auto-release lanes track completions in the pending buffer:
        # cancel through cancel_one so the slot clears with the interval
        # (a blind delete would release it twice at the next tick)
        part, local = eng._split(pe_ids)
        state = eng.states[part]
        mask = tl_lib.ids_to_mask32(local, state.tl.words,
                                    device=state.tl.device)
        state, done = batch_lib.cancel_one(state, t_s, t_e, mask,
                                           require_pending=True,
                                           max_growths=0)
        eng.states = ens_lib.set_member(eng.states, part, state)
        if done:
            eng._bump_load(part, -(t_e - t_s) * len(local))
            self._ledger_cancel(t_s, t_e, pe_ids)
        self.counters["cancelled"] += int(done)
        return done

    def _ledger_cancel(self, t_s, t_e, pe_ids) -> None:
        """Drop a cancelled reservation's ledger entry (if tracked)."""
        if self._accounts is None:
            return
        key = (t_e, t_s, tuple(pe_ids))
        for i, ent in enumerate(self._ledger):
            if (ent[0], ent[3], ent[4]) == key:
                self._accounts.release(ent[2])
                self._ledger.pop(i)
                heapq.heapify(self._ledger)
                return

    def snapshot(self):
        tenancy = None
        if self._accounts is not None:
            tenancy = (copy.deepcopy(self._accounts), list(self._ledger),
                       self._lseq)
        return (self.engine.states, list(self.engine.load),
                self.engine._rr, tenancy)

    def restore(self, payload):
        states, load, rr, tenancy = payload
        self.engine.states = states
        self.engine.load = list(load)
        self.engine._rr = rr
        if tenancy is not None:
            accounts, ledger, lseq = tenancy
            self._accounts = copy.deepcopy(accounts)
            self._ledger = list(ledger)
            self._lseq = lseq

    def metrics(self) -> Dict[str, Any]:
        eng = self.engine
        cap, pend = ens_lib.lane_capacity(eng.states)
        st = eng.stats
        out = dict(capacity=cap, pending_capacity=pend,
                   chips_per_partition=eng.chips_per_part,
                   partition_load=list(eng.load),
                   dispatches=eng.dispatches,
                   match_rounds=eng.last_match_rounds, steps=st.steps,
                   host_syncs=st.host_syncs, early_rejects=st.early_rejects,
                   probe_searches=st.probe_searches,
                   probe_rejects=st.probe_rejects)
        if self.cfg.backfilling:
            lanes = eng.states
            vals = torch.stack([
                sum((s.park_seq != T_INF).sum() for s in lanes),
                *(sum(getattr(s, f) for s in lanes)
                  for f in ("n_parked", "n_promoted", "n_moved"))])
            host = [int(v) for v in vals.cpu()]
            out.update(park_capacity=lanes[0].park_capacity,
                       n_parked_now=host[0], n_parked=host[1],
                       n_promoted=host[2], n_moved=host[3])
        if self._accounts is not None:
            out["tenants"] = self._accounts.snapshot()
            out["ledger_depth"] = len(self._ledger)
        return out


class _HostBackend(_BackendBase):
    """The host (numpy) or list engine behind the same verbs.

    Everything runs on the CPU: the engines are the reference's
    host-side oracles, and a session runs them only when its config
    names them.  Decisions come back as CPU tensors.
    """

    def __init__(self, cfg: ServiceConfig, counters: Dict[str, int]):
        super().__init__(cfg, counters)
        self.engine = _make_engine(cfg.n_pe, cfg.engine,
                                   **(cfg.engine_kwargs or {}))
        self._completions: list = []     # heap of (t_e, seq, t_s, ids)
        self._seq = 0
        self._last_ta = 0                # arrival-order watermark

    def _pes(self, ids):
        return set(ids) if self.cfg.engine == "list" else list(ids)

    def add_allocation(self, t_s, t_e, pes):
        self.engine.add_allocation(t_s, t_e, self._pes(pes))

    def delete_allocation(self, t_s, t_e, pes):
        self.engine.delete_allocation(t_s, t_e, self._pes(pes))

    def _release_due(self, t: int) -> int:
        n = 0
        while self._completions and self._completions[0][0] <= t:
            t_e, _, t_s, ids = heapq.heappop(self._completions)
            self.engine.delete_allocation(t_s, t_e, self._pes(ids))
            n += 1
        self.counters["released"] += n
        return n

    def offer(self, requests, *, policy, routing, flush) -> OfferResult:
        if routing is not None:
            raise ValueError("routing applies to partitioned sessions")
        if not flush:
            raise ValueError(
                "flush=False staging is a ring-buffer (device session) "
                "feature; host/list sessions decide every offer at once")
        pol = self.resolve_policy(policy)
        reqs = list(requests)
        _check_demands(None, reqs)
        batch_lib.check_arrival_order(reqs, self._last_ta)
        self.counters["offered"] += len(reqs)
        if not reqs:
            return _empty_result()
        W = words_lib.n_words(self.cfg.n_pe)
        rows: List[Tuple] = []
        allocs: List[Optional[Allocation]] = []
        for req in reqs:
            if self.cfg.auto_release:
                self._release_due(req.t_a)
            alloc = self.engine.find_allocation(req, pol, t_now=req.t_a)
            allocs.append(alloc)
            if alloc is None:
                rows.append((False, -1, -1, np.zeros(W, np.uint32), 0, 0, 0))
                continue
            self.engine.add_allocation(alloc.t_s, alloc.t_e,
                                       self._pes(alloc.pe_ids))
            if self.cfg.auto_release:
                heapq.heappush(self._completions,
                               (alloc.t_e, self._seq, alloc.t_s,
                                tuple(alloc.pe_ids)))
                self._seq += 1
            mask = np.zeros(W, np.uint32)
            for i in alloc.pe_ids:
                mask[i // 32] |= np.uint32(1 << (i % 32))
            r = alloc.rectangle
            rows.append((True, alloc.t_s, alloc.t_e, mask, r.n_free,
                         r.t_begin, r.t_end))
        self._last_ta = reqs[-1].t_a
        self.counters["accepted"] += sum(a is not None for a in allocs)

        def col(k):
            return torch.tensor([r[k] for r in rows], dtype=torch.int32)

        dec = Decision(
            accepted=torch.tensor([r[0] for r in rows]),
            t_s=col(1), t_e=col(2),
            pe_mask=torch.from_numpy(words_lib.to_int32(
                np.stack([r[3] for r in rows]))),
            n_free=col(4), t_begin=col(5), t_end=col(6),
            parked=torch.zeros(len(rows), dtype=torch.bool))
        return OfferResult(decision=dec, valid=np.ones(len(reqs), bool),
                           _allocations=allocs)

    def tick(self, t: int) -> int:
        if not self.cfg.auto_release:
            return 0
        return self._release_due(t)

    def cancel(self, t_s, t_e, pe_ids, lane: int = 0) -> bool:
        if lane != 0:
            raise ValueError("lane applies to ensemble sessions")
        key = (t_s, t_e, tuple(pe_ids))
        if self.cfg.auto_release:
            match = [c for c in self._completions
                     if (c[2], c[0], c[3]) == key]
            if not match:
                return False
            self._completions.remove(match[0])
            heapq.heapify(self._completions)
        self.engine.delete_allocation(t_s, t_e, self._pes(pe_ids))
        self.counters["cancelled"] += 1
        return True

    def snapshot(self):
        return (copy.deepcopy(self.engine), list(self._completions),
                self._seq, self._last_ta)

    def restore(self, payload):
        engine, completions, seq, last_ta = payload
        self.engine = copy.deepcopy(engine)
        self._completions = list(completions)
        self._seq = seq
        self._last_ta = last_ta

    def metrics(self) -> Dict[str, Any]:
        return dict(n_pending=len(self._completions))
