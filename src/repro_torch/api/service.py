"""`ReservationService`: the streaming session API over one device timeline.

The port's copy of ``repro/api/service.py`` for single-lane device
sessions.  A :class:`ReservationService` is configured once by a
:class:`~repro_torch.api.config.ServiceConfig` and opens
:class:`Session` s, each carrying its scheduler state on the card
across calls:

``offer(requests)``
    Streaming admission.  Arrivals stage in a fixed-capacity
    :class:`~repro_torch.core.batch.RequestRing` and admit in
    ``chunk_size`` chunks, so every chunk has the same shapes however
    callers group their arrivals.  ``chunk_size=None`` admits each
    offer as one batch.
``tick(t)``
    Release every pending reservation ending by ``t``.
``metrics()``
    Admission counters, growths, capacities, ring geometry and the host
    syncs the session paid.

Capacity overflow grows once to the high-water mark the failed
dispatch recorded and re-runs that chunk, so chunked decisions equal a
one-shot run that started with enough capacity.  The chunks run
eagerly: each chunk's overflow latch is read before the next chunk
starts (the reference also pipelines them; the decisions are the
same).  The paper's three operations stay available on every session.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.config import ServiceConfig, policy_id_of
from repro_torch.core import batch as batch_lib
from repro_torch.core.batch import Decision, RequestBatch, RequestRing
from repro_torch.core.scheduler import DeviceEngine
from repro_torch.core.types import Allocation, ARRequest, Policy, T_INF


class OfferResult:
    """Outcome of one :meth:`Session.offer` call.

    ``decision`` / ``batch`` / ``valid`` are the stacked fixed-shape
    tensors actually admitted (``[M]``); ``valid`` masks out ring
    filler.  :meth:`allocations` unpacks host
    :class:`~repro_torch.core.types.Allocation` objects (``None`` per
    rejection) in the order the requests were offered.
    """

    def __init__(self, decision: Optional[Decision] = None,
                 batch: Optional[RequestBatch] = None,
                 valid: Optional[np.ndarray] = None,
                 _allocations: Optional[List[Optional[Allocation]]] = None):
        self.decision = decision
        self.batch = batch
        self.valid = valid
        self._allocations = _allocations

    @property
    def n_offered(self) -> int:
        if self.valid is not None:
            return int(np.asarray(self.valid).sum())
        return len(self._allocations or [])

    @property
    def n_accepted(self) -> int:
        if self.decision is not None:
            acc = self.decision.accepted.cpu().numpy()
            return int((acc & np.asarray(self.valid)).sum())
        return sum(a is not None for a in (self._allocations or []))

    def allocations(self) -> List[Optional[Allocation]]:
        """Host allocations for the valid offered requests, in order."""
        if self._allocations is not None:
            return self._allocations
        if self.decision is None:
            return []
        allocs = batch_lib.decisions_to_allocations(self.decision)
        self._allocations = [a for a, v in zip(allocs, self.valid) if v]
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


class Session:
    """One long-lived scheduler conversation (state lives on the card).

    Create via :meth:`ReservationService.session`.  Admission verbs take
    arrival-ordered traffic (``t_a`` non-decreasing across calls), like
    the paper's event loop.
    """

    def __init__(self, service: "ReservationService"):
        self.service = service
        self.config = service.config
        self._counters = dict(offered=0, accepted=0, released=0, chunks=0,
                              growths=0, one_shot_scans=0)
        self._backend = _StreamBackend(self.config, self._counters)

    @property
    def engine(self) -> DeviceEngine:
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
        overrides the config's for this call; ``routing`` belongs to
        partitioned sessions and must stay ``None``.
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
        caller (``delete_allocation``) and releases nothing here.
        """
        return self._backend.tick(t)

    def records(self) -> list:
        """Host view of the availability timeline (merged records)."""
        return self._backend.engine.records()

    def metrics(self) -> Dict[str, Any]:
        """Admission counters plus capacity, ring and host-sync figures."""
        backend = self._backend.metrics()
        out = dict(self._counters)
        out.update(backend)
        out.update(engine=self.config.engine, n_pe=self.config.n_pe,
                   lanes=self.config.lanes,
                   n_partitions=self.config.n_partitions,
                   chunk_size=self.config.chunk_size,
                   backfill=self.config.backfill)
        return out

    # -- the paper's three operations -----------------------------------
    def find_allocation(self, req: ARRequest, policy=None,
                        t_now: Optional[int] = None
                        ) -> Optional[Allocation]:
        pol = self._backend.resolve_policy(policy)
        return self.engine.find_allocation(req, pol, t_now=t_now)

    def add_allocation(self, t_s: int, t_e: int,
                       pes: Sequence[int]) -> None:
        self.engine.add_allocation(t_s, t_e, list(pes))

    def delete_allocation(self, t_s: int, t_e: int,
                          pes: Sequence[int]) -> None:
        self.engine.delete_allocation(t_s, t_e, list(pes))


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


class _StreamBackend:
    """One device timeline with ring-buffer chunked streaming."""

    def __init__(self, cfg: ServiceConfig, counters: Dict[str, int]):
        self.cfg = cfg
        self.counters = counters
        self._acc_dev: Optional[torch.Tensor] = None  # unsynced accepted
        mu = cfg.machine_units
        self.engine = DeviceEngine(
            cfg.n_pe, capacity=cfg.capacity, use_kernel=cfg.use_kernel,
            pending_capacity=cfg.pending_capacity, device=cfg.device,
            rspec=cfg.rspec,
            live_units=mu[0] if mu is not None else None)
        self._rspec = cfg.rspec
        self.device = self.engine.tl.device
        self.ring = (RequestRing(cfg.ring_capacity,
                                 extra_demand=cfg.extra_demand)
                     if cfg.chunk_size else None)
        # host syncs, admit steps and release passes of every dispatch
        self.stats = batch_lib.StreamStats()

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

    @property
    def _state(self):
        return self.engine.state

    @_state.setter
    def _state(self, s):
        self.engine.state = s
        self.engine._n_valid = None      # recounted on the next search

    def _capacities(self) -> Tuple[int, int]:
        s = self._state
        return (s.tl.capacity, s.pending_capacity)

    def _admit_batch(self, batch: RequestBatch, pid: int) -> Decision:
        before = self._capacities()
        state, dec = batch_lib.admit_stream_grow(
            self._state, batch, pid, n_pe=self.cfg.n_pe,
            auto_release=self.cfg.auto_release,
            use_kernel=self.cfg.use_kernel, max_growths=self.growth_budget,
            stats=self.stats)
        self._grow_guard(before, (state.tl.capacity,
                                  state.pending_capacity))
        self._state = state
        return dec

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
        _check_demands(self._rspec, reqs)
        if self.ring is None:
            if not reqs:
                return _empty_result()
            batch = batch_lib.requests_to_batch(
                reqs, self.device, extra_demand=self.cfg.extra_demand)
            return self._one_shot(batch, len(reqs), pid)
        batch_lib.check_arrival_order(reqs, self.ring.last_t_a)
        self.counters["offered"] += len(reqs)
        return self._offer_eager(reqs, pid, flush)

    def _one_shot(self, batch: RequestBatch, n: int, pid: int
                  ) -> OfferResult:
        self.counters["offered"] += n
        dec = self._admit_batch(batch, pid)
        self.counters["one_shot_scans"] += 1
        res = OfferResult(decision=dec, batch=batch, valid=np.ones(n, bool))
        self._defer_accepted(res.decision, res.valid)
        return res

    def _offer_eager(self, reqs, pid, flush) -> OfferResult:
        chunk = self.cfg.chunk_size
        decs: List[Decision] = []
        batches: List[RequestBatch] = []
        valids: List[np.ndarray] = []

        def drain_one():
            # keep the ring intact if the chunk raises (auto_grow=False
            # overflow): the popped requests stay staged for a retry
            ring_snap = self.ring.snapshot()
            batch, valid = self.ring.pop_chunk(chunk, self.cfg.n_pe,
                                               self.device)
            try:
                decs.append(self._admit_batch(batch, pid))
            except Exception:
                self.ring.restore(ring_snap)
                raise
            batches.append(batch)
            valids.append(valid)
            self.counters["chunks"] += 1

        i = 0
        while i < len(reqs):
            take = min(self.ring.free, len(reqs) - i)
            self.ring.push(reqs[i:i + take])
            i += take
            while self.ring.count >= chunk:
                drain_one()
        if flush:
            while self.ring.count:
                drain_one()
        if not decs:
            return _empty_result()
        res = OfferResult(decision=_concat_tree(decs, axis=0),
                          batch=_concat_tree(batches, axis=0),
                          valid=np.concatenate(valids))
        self._defer_accepted(res.decision, res.valid)
        return res

    def tick(self, t: int) -> int:
        if not self.cfg.auto_release:
            return 0
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

    def metrics(self) -> Dict[str, Any]:
        self._sync_counters()
        cap, pend = self._capacities()
        out = dict(capacity=cap, pending_capacity=pend,
                   n_pending=int((self._state.pend_te != T_INF).sum()),
                   steps=self.stats.steps,
                   host_syncs=self.stats.host_syncs,
                   release_passes=self.stats.release_passes)
        if self.ring:
            out.update(ring_capacity=self.ring.capacity,
                       ring_staged=self.ring.count,
                       ring_wrapped=self.ring.wrapped)
        return out
