"""Fused admission: ``(state, request) -> (state, decision)``.

One admit step runs the paper's loop body for one arrival: delete the
reservations that ended by ``t_a`` (``deleteAllocation``), search
(``findAllocation``, Algorithm 3), and commit the winner
(``addAllocation``) together with its pending-release slot.
:func:`admit_stream` runs the step over an arrival-ordered batch in a
Python loop whose state stays on the device.

The commit is branch-free: every state field is a ``torch.where``
between the old and the committed value, so the overflow latch
behaves as in the reference's ``lax.cond``.  Once ``overflow`` is set
every later step is a no-op; :func:`admit_stream_grow` then grows the
state to the high-water marks and re-runs the batch from its start.

Host syncs.  The release loop reads one flag per pass to learn whether
another :data:`RELEASE_CHUNK` pass is due (the reference's
``while_loop``); a stream reads the batch to the host once and the
overflow latch once per attempt.  On an indexed timeline the step also
needs the early-reject predicate on the host (the reference's
``lax.cond``); it is read in the same transfer as the release loop's
last flag, so with ``auto_release`` it costs no read of its own.
:class:`StreamStats` counts every read.

No state tensor is ever written in place: every step builds new
tensors, so a state that a caller keeps (the pre-chunk state of
:func:`admit_stream_donated`, a session snapshot) stays valid.

Multi-resource states (``state.rspec`` set) admit with the vector fit:
each step hands its row of the batch's ``demand`` column (the
secondary planes' demands, int32[R-1], on the device) and the lane's
``lane_valid`` mask to the search.  Streaming arrivals stage through
the host-side :class:`RequestRing` and leave as fixed-shape chunks.

Backfilling.  A state with a deferral queue (``park_capacity > 0``)
admits under a backfill mode (:data:`BF_NONE`, :data:`BF_EASY`,
:data:`BF_CONSERVATIVE`): an accepted request that starts after its
ready time parks in the queue; a parked reservation whose start has
arrived is promoted into the pending-release buffer; under EASY a
cancel arms a retry sweep that pulls parked reservations earlier, and
an otherwise rejected request may displace the non-head entries
(:func:`_displace`).  The reference hides the queue work behind
``lax.cond``; here the host branches, and reads what it branches on in
the transfers the step already makes: the queue's predicates come with
the release loop's first flag, so a step whose queue is idle costs the
syncs of a ``none`` step.  A sweep or a displacement reads the queue's
FCFS order once, and the searches inside them run without the index's
early reject (it never changes an answer, and the loops use only
``found``, ``t_s`` and the mask), so they read nothing else per
iteration; a displacement reads once more whether the request itself
fits around the lifted entries.  Every accept or rollback inside them
stays on the device.

Tenancy.  A state with a tenant table (``state.tenants``) admits each
request on behalf of its tenant (the batch's ``tenant`` column).  After
the queue work and before the search, the quota gate decides on the
device whether the tenant may hold one more reservation of this size;
the host reads that flag with the release loop's last flag (or, with
``auto_release=False``, in the one read of the step), and a gated
request is rewritten never-feasible (``n_pe + 1`` PEs in a one-second
window at its arrival) and searched as such, as the reference does, so
every ``Decision`` field equals the reference's.  The deferral queue's
sweeps and promotion rank by the weighted fair-share key
(:func:`repro_torch.tenancy.table.fair_key`) instead of FCFS, which
equal weights leave unchanged; the host computes the same float32 keys
from the queue read it already makes.  The per-tenant accounting
(usage, live count, counters, EWMAs) is tensor code after the commit,
with nothing read back.  Releases, reaping (:func:`reap_until`) and
cancels return ownership and decrement the owner's live count.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import search as search_lib
from repro_torch.core import timeline as tl_lib
from repro_torch.core import words as words_lib
from repro_torch.core.policies import first_true, policy_index
from repro_torch.core.timeline import I32, SchedulerState
from repro_torch.tenancy import table as tenancy_lib
from repro_torch.core.types import (
    Allocation,
    ARRequest,
    BackfillMode,
    Policy,
    Rectangle,
    T_INF,
    backfill_index,
)
from repro_torch.device import DeviceLike, resolve_device

# Growth retries before the host wrappers give up.
MAX_DOUBLINGS = 8

# Due reservations deleted per release pass (one update_many call).
RELEASE_CHUNK = 8

# Backfill mode ids (see repro_torch.core.types.BackfillMode).
BF_NONE = backfill_index(BackfillMode.NONE)
BF_EASY = backfill_index(BackfillMode.EASY)
BF_CONSERVATIVE = backfill_index(BackfillMode.CONSERVATIVE)


def as_backfill_id(backfill) -> int:
    """Any backfill spelling -> its integer id.

    Accepts a mode name, a :class:`~repro_torch.core.types.BackfillMode`,
    a validated id, or a 1-tuple (the one-lane spelling of the per-lane
    config form).
    """
    if isinstance(backfill, (tuple, list)):
        if len(backfill) != 1:
            raise ValueError(
                f"{len(backfill)} backfill modes for a single lane "
                f"(per-lane tuples belong to ensemble callers)")
        backfill = backfill[0]
    return backfill_index(backfill)


class RequestBatch(NamedTuple):
    """Struct-of-tensors AR request stream, sorted by arrival time.

    ``tenant`` is the optional ownership column of multi-tenant
    streams (int32[N]); ``demand`` the optional multi-resource column:
    int32[N, R-1] secondary-plane demands (plane 0 is ``n_pe``).  Both
    are ``None`` where unused.
    """

    t_a: torch.Tensor   # int32[N]
    t_r: torch.Tensor
    t_du: torch.Tensor
    t_dl: torch.Tensor
    n_pe: torch.Tensor
    tenant: Optional[torch.Tensor] = None  # int32[N]
    demand: Optional[torch.Tensor] = None  # int32[N, R-1]


#: The paper's five request coordinates: the always-present columns.
REQ_FIELDS: Tuple[str, ...] = ("t_a", "t_r", "t_du", "t_dl", "n_pe")


class Decision(NamedTuple):
    """Per-request admission outcome (0-d per step, ``[N]`` stacked)."""

    accepted: torch.Tensor  # bool
    t_s: torch.Tensor       # int32; -1 when rejected
    t_e: torch.Tensor       # int32; -1 when rejected
    pe_mask: torch.Tensor   # int32[W]; 0 when rejected
    n_free: torch.Tensor    # int32 winning-rectangle free PEs
    t_begin: torch.Tensor   # int32 winning-rectangle begin
    t_end: torch.Tensor     # int32 winning-rectangle end
    parked: torch.Tensor    # bool: accepted into the deferral queue


@dataclasses.dataclass
class StreamStats:
    """What one admission run cost the host (summed over attempts)."""

    steps: int = 0           # admit steps, re-runs after growth included
    host_syncs: int = 0      # reads of device values by the host
    release_passes: int = 0  # RELEASE_CHUNK passes (update_many calls)
    growths: int = 0         # overflow -> grow -> re-run cycles
    early_rejects: int = 0   # steps the index proved infeasible
    # backfilling: the searches of the EASY retry sweep, and of the
    # displacement transactions (the request's own and the
    # re-placements); transactions tried, and those tried after an
    # early reject.  A step's own search is one per step, so the select
    # kernel runs steps - early_rejects + retry_searches +
    # displace_searches times
    retry_searches: int = 0
    displace_searches: int = 0
    displacements: int = 0
    reject_displacements: int = 0
    # with count_candidates, int64[2] on the device (never read here):
    # live candidates the searches enumerated, and how many of them the
    # index pruned
    count_candidates: bool = False
    candidates: Optional[torch.Tensor] = None
    capacity: int = 0        # timeline capacity of the last attempt
    pending_capacity: int = 0  # pending-buffer capacity of the last attempt

    def sync(self, n: int = 1) -> None:
        self.host_syncs += n


def _req_field(r: ARRequest, f: str) -> int:
    """One staging column of a host request.

    ``demand<k>`` (k >= 1) reads plane ``k`` of the request's demand
    vector; a request without one stages 0 there (PEs only).
    """
    if f.startswith("demand"):
        k = int(f[len("demand"):])
        return 0 if r.demand is None else int(r.demand[k])
    return int(getattr(r, f))


def _demand_fields(extra_demand: int) -> Tuple[str, ...]:
    """Staging column names of the demand tail (planes 1..R-1)."""
    return tuple(f"demand{k}" for k in range(1, extra_demand + 1))


def _fields_to_batch(fields: Dict[str, np.ndarray],
                     device: torch.device) -> RequestBatch:
    """Host columns (with any ``tenant`` / ``demand<k>``) -> a
    RequestBatch on device.

    The five request columns, and the tenant column, cross in one copy;
    the demand columns stack along a trailing axis into the
    int32[N, R-1] tail (``None`` without any).
    """
    names = REQ_FIELDS + (("tenant",) if "tenant" in fields else ())
    cols = np.stack([np.asarray(fields[f], np.int32) for f in names])
    t = torch.from_numpy(cols).to(device)
    dcols = sorted((k for k in fields if k.startswith("demand")),
                   key=lambda k: int(k[len("demand"):]))
    demand = None
    if dcols:
        demand = torch.from_numpy(np.stack(
            [np.asarray(fields[k], np.int32) for k in dcols],
            axis=-1)).to(device)
    return RequestBatch(*t[:5], tenant=t[5] if len(names) > 5 else None,
                        demand=demand)


def _stage_fields(with_tenant: bool, extra_demand: int) -> Tuple[str, ...]:
    """Staging column names: the request, its tenant, its demand tail."""
    return (REQ_FIELDS + (("tenant",) if with_tenant else ())
            + _demand_fields(extra_demand))


def requests_to_batch(jobs: Sequence[ARRequest], device: DeviceLike = None,
                      extra_demand: int = 0, *, with_tenant: bool = False
                      ) -> RequestBatch:
    """Pack host requests into the device struct-of-tensors layout.

    ``extra_demand`` (= R - 1) adds the multi-resource demand column;
    requests without a demand vector stage zeros there.  ``with_tenant``
    adds the tenant column.
    """
    dev = resolve_device(device)
    names = _stage_fields(with_tenant, extra_demand)
    fields = {f: np.array([_req_field(j, f) for j in jobs], np.int32)
              for f in names}
    return _fields_to_batch(fields, dev)


def request_struct(req: ARRequest, extra_demand: int = 0,
                   device: DeviceLike = None, *, with_tenant: bool = False
                   ) -> RequestBatch:
    """A single request as 0-d tensors (demand int32[R-1]) for :func:`admit`."""
    b = requests_to_batch([req], device, extra_demand,
                          with_tenant=with_tenant)
    return RequestBatch(*(None if x is None else x[0] for x in b))


def filler_request(n_pe: int, t_a: int) -> ARRequest:
    """A never-feasible padding request (asks for ``n_pe + 1`` PEs).

    Rejected without touching the timeline.  It carries the arrival
    time of the last request already popped for admission, so it can
    never reorder releases (a filler stamped past a still-staged
    request would trigger its releases early).
    """
    return ARRequest(t_a=t_a, t_r=t_a, t_du=1, t_dl=t_a + 1, n_pe=n_pe + 1)


def check_arrival_order(requests: Sequence[ARRequest],
                        last_t_a: int) -> None:
    """Validate ``t_a`` monotonicity of a whole slice before any
    mutation, so a rejected offer or push changes nothing."""
    last = last_t_a
    for r in requests:
        if r.t_a < last:
            raise ValueError(
                f"requests must be arrival-ordered across offers: "
                f"got t_a={r.t_a} after t_a={last}")
        last = r.t_a


def pad_streams(streams, n_pe: int, with_tenant: bool = False,
                extra_demand: int = 0, device: DeviceLike = None
                ) -> Tuple[RequestBatch, np.ndarray]:
    """Stack variable-length request streams into ``[C, N]`` + mask.

    Padding requests (:func:`filler_request`) ask for ``n_pe + 1`` PEs,
    so they are rejected without touching the timeline, and arrive with
    the stream's last real request, so they cannot reorder releases.
    Decisions at padded positions are masked out with the returned
    ``valid`` array.  ``with_tenant`` adds the tenant column (filler
    carries tenant 0, never charged), ``extra_demand`` (= R - 1) the
    demand tail.
    """
    C = len(streams)
    N = max(max((len(s) for s in streams), default=0), 1)
    names = _stage_fields(with_tenant, extra_demand)
    fields = {f: np.zeros((C, N), np.int32) for f in names}
    valid = np.zeros((C, N), bool)
    for c, stream in enumerate(streams):
        pad = filler_request(n_pe, stream[-1].t_a if stream else 0)
        for i in range(N):
            r = stream[i] if i < len(stream) else pad
            for f in names:
                fields[f][c, i] = _req_field(r, f)
        valid[c, :len(stream)] = True
    return _fields_to_batch(fields, resolve_device(device)), valid


def scatter_streams(requests: Sequence[ARRequest], lanes: Sequence[int],
                    n_lanes: int, n_pe: int, extra_demand: int = 0,
                    device: DeviceLike = None
                    ) -> Tuple[RequestBatch, np.ndarray, list]:
    """Group routed requests into per-lane padded streams.

    ``lanes[i]`` is the lane of ``requests[i]``.  Returns ``(batch,
    valid, slots)``: ``batch`` / ``valid`` from :func:`pad_streams` over
    ``n_lanes`` streams, and ``slots[i] = (lane, pos)`` where request
    ``i``'s decision sits in the ``[C, N]`` layout.  Each lane keeps the
    input's arrival order.
    """
    streams: list = [[] for _ in range(n_lanes)]
    slots = []
    for req, lane in zip(requests, lanes):
        slots.append((int(lane), len(streams[lane])))
        streams[lane].append(req)
    batch, valid = pad_streams(streams, n_pe, extra_demand=extra_demand,
                               device=device)
    return batch, valid, slots


class RequestRing:
    """Fixed-capacity FIFO staging ring for streaming admission.

    Arriving requests are staged in host numpy storage and leave as
    fixed-shape device chunks via :meth:`pop_chunk`, so every chunk has
    the same shapes however the arrivals are grouped.  Slots are reused
    modulo ``capacity``; a full ring rejects the push.  ``with_tenant``
    stages the tenant column (filler carries tenant 0, and is never
    charged: the admit step knows it by its ``n_pe + 1`` ask).
    """

    def __init__(self, capacity: int, extra_demand: int = 0, *,
                 with_tenant: bool = False):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.capacity = capacity
        self._fields = _stage_fields(with_tenant, extra_demand)
        self._buf = {f: np.zeros(capacity, np.int32) for f in self._fields}
        self._head = 0          # index of the oldest staged request
        self.count = 0          # staged (not yet popped) requests
        self.pushed = 0         # lifetime pushes
        self.popped = 0         # lifetime pops (valid only)
        self.wrapped = False    # a slot has been reused (index wrapped)
        self.last_t_a = 0       # arrival time of the newest push
        self.last_popped_t_a = 0  # arrival time of the newest pop

    @property
    def free(self) -> int:
        return self.capacity - self.count

    def push(self, requests: Sequence[ARRequest]) -> None:
        """Stage arrival-ordered requests; raises when they don't fit.

        All-or-nothing: the whole slice is validated before any slot is
        written, so a rejected push leaves the ring untouched.
        """
        if len(requests) > self.free:
            raise OverflowError(
                f"ring full: {len(requests)} requests, "
                f"{self.free}/{self.capacity} slots free; pop a chunk "
                f"first or configure a larger ring_capacity")
        check_arrival_order(requests, self.last_t_a)
        for r in requests:
            i = (self._head + self.count) % self.capacity
            if self.pushed >= self.capacity:
                self.wrapped = True
            for f in self._fields:
                self._buf[f][i] = _req_field(r, f)
            self.count += 1
            self.pushed += 1
            self.last_t_a = r.t_a

    def pop_chunk_host(self, chunk: int, n_pe: int,
                       n: Optional[int] = None
                       ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """As :meth:`pop_chunk`, with the columns left on the host.

        ``n`` caps how many staged requests leave (default: up to
        ``chunk``); the remaining positions hold filler.
        """
        n = min(chunk, self.count) if n is None else min(n, chunk,
                                                         self.count)
        idx = (self._head + np.arange(chunk)) % self.capacity
        fields = {f: self._buf[f][idx].copy() for f in self._fields}
        valid = np.arange(chunk) < n
        if n > 0:
            self.last_popped_t_a = int(fields["t_a"][n - 1])
        if n < chunk:
            # filler is stamped with the newest *popped* arrival, never
            # a still-staged one: stamping past staged requests would
            # release their predecessors early and change decisions
            pad = filler_request(n_pe, self.last_popped_t_a)
            for f in self._fields:
                fields[f][n:] = _req_field(pad, f)
        self._head = (self._head + n) % self.capacity
        self.count -= n
        self.popped += n
        return fields, valid

    def pop_chunk(self, chunk: int, n_pe: int, device: DeviceLike = None
                  ) -> Tuple[RequestBatch, np.ndarray]:
        """Dequeue up to ``chunk`` requests as one fixed-shape batch.

        Always ``chunk`` long: missing tail positions hold
        :func:`filler_request` padding and are ``False`` in the
        returned ``valid`` mask.
        """
        fields, valid = self.pop_chunk_host(chunk, n_pe)
        return _fields_to_batch(fields, resolve_device(device)), valid

    def snapshot(self) -> dict:
        """Copy of the ring's mutable state (see :meth:`restore`)."""
        return {"buf": {f: v.copy() for f, v in self._buf.items()},
                "head": self._head, "count": self.count,
                "pushed": self.pushed, "popped": self.popped,
                "wrapped": self.wrapped, "last_t_a": self.last_t_a,
                "last_popped_t_a": self.last_popped_t_a}

    def restore(self, snap: dict) -> None:
        for f, v in snap["buf"].items():
            self._buf[f][:] = v
        self._head = snap["head"]
        self.count = snap["count"]
        self.pushed = snap["pushed"]
        self.popped = snap["popped"]
        self.wrapped = snap["wrapped"]
        self.last_t_a = snap["last_t_a"]
        self.last_popped_t_a = snap["last_popped_t_a"]


def pop_chunk_ensemble(rings: Sequence[RequestRing], chunk: int, n_pe: int,
                       full_only: bool = False, device: DeviceLike = None
                       ) -> Tuple[RequestBatch, np.ndarray]:
    """Pop one fixed-shape chunk from every lane's ring, stacked.

    Returns an ``[E, chunk]`` :class:`RequestBatch` and its ``valid``
    mask; a lane with fewer than ``chunk`` staged requests is padded
    with :func:`filler_request`.  With ``full_only`` a lane below a
    full chunk keeps its requests staged and contributes only filler
    (the ``flush=False`` contract).
    """
    names = rings[0]._fields if rings else REQ_FIELDS
    fields = {f: np.zeros((len(rings), chunk), np.int32) for f in names}
    valid = np.zeros((len(rings), chunk), bool)
    for e, ring in enumerate(rings):
        n = 0 if full_only and ring.count < chunk else None
        lane_fields, valid[e] = ring.pop_chunk_host(chunk, n_pe, n=n)
        for f in names:
            fields[f][e] = lane_fields[f]
    return _fields_to_batch(fields, resolve_device(device)), valid


def _field_tuple(req) -> Tuple[int, int, int, int, int]:
    return tuple(int(getattr(req, f)) for f in REQ_FIELDS)


def request_demand(state: SchedulerState, req) -> Optional[torch.Tensor]:
    """A request's secondary-plane demands on the state's device.

    ``req`` is an :class:`ARRequest` (its ``demand`` vector checked
    against the spec) or a :func:`request_struct`.  ``None`` on
    single-resource states.
    """
    spec = state.rspec
    if spec is None:
        return None
    dev = state.tl.device
    if isinstance(req.demand, torch.Tensor):
        return req.demand.to(device=dev, dtype=I32)
    tail = spec.demand_tail(req.demand, int(req.n_pe))
    return torch.tensor(tail, dtype=I32).to(dev)


def _tenant_dec(tn, freed: torch.Tensor, owner: torch.Tensor) -> torch.Tensor:
    """int32[T]: how many of the ``freed`` slots each tenant owned."""
    hit = (freed & (owner >= 0)).to(I32)
    return torch.zeros_like(tn.live).scatter_add(
        0, owner.clamp(0, tn.n_tenants - 1).to(torch.int64), hit)


def _release_chunk(s: SchedulerState, t_now: int,
                   reap: bool = False) -> SchedulerState:
    """Delete up to RELEASE_CHUNK due reservations in one update_many.

    On a tenanted state the freed slots return to unowned and their
    owners' live counts drop; ``reap`` also charges them to the owners'
    ``n_reaped`` (overdue reaping, :func:`reap_until`).
    """
    CH = min(RELEASE_CHUNK, s.pending_capacity)
    W = s.pend_mask.shape[1]
    dev = s.pend_te.device
    due = s.pend_te <= t_now
    rank = torch.cumsum(due, dim=0) - 1
    chosen = due & (rank < CH)
    # unchosen slots all write the same zero row to the spare index CH
    dest = torch.where(chosen, rank, CH)

    def gather(x, width=None):
        shape = (CH + 1,) if width is None else (CH + 1, width)
        out = torch.zeros(shape, dtype=x.dtype, device=dev)
        sel = chosen if width is None else chosen[:, None]
        out[dest] = torch.where(sel, x, 0)
        return out[:CH]

    act = torch.zeros((CH + 1,), dtype=torch.bool, device=dev)
    act[dest] = chosen
    new_tl, ovf, n_keep = tl_lib.update_many(
        s.tl, gather(s.pend_ts), gather(s.pend_te),
        gather(s.pend_mask, W), act[:CH], is_add=False, with_count=True)
    # slots are freed even on overflow so the loop always progresses;
    # an overflowed stream is re-run anyway
    out = s._replace(
        tl=_where_tl(ovf, s.tl, new_tl),
        pend_ts=torch.where(chosen, T_INF, s.pend_ts),
        pend_te=torch.where(chosen, T_INF, s.pend_te),
        pend_mask=torch.where(chosen[:, None], 0, s.pend_mask),
        n_released=s.n_released + torch.where(
            ovf, 0, chosen.sum()).to(I32),
        overflow=s.overflow | ovf,
        hw_records=torch.maximum(s.hw_records, n_keep))
    tn = s.tenants
    if tn is not None:
        dec = _tenant_dec(tn, chosen, tn.pend_tenant)
        upd = dict(live=tn.live - dec,
                   pend_tenant=torch.where(chosen, -1, tn.pend_tenant))
        if reap:
            upd["n_reaped"] = tn.n_reaped + dec
        out = out._replace(tenants=tn._replace(**upd))
    return out


def _where_tl(pred, if_true: tl_lib.Timeline,
              if_false: tl_lib.Timeline) -> tl_lib.Timeline:
    """Field-wise select of two timelines of one layout (index too)."""
    return if_true._replace(**{
        f: torch.where(pred, getattr(if_true, f), getattr(if_false, f))
        for f in ("times", "occ", "idx_occ", "idx_minfree", "idx_maxfree")
        if getattr(if_true, f) is not None})


def _where_table(pred, if_true, if_false):
    """Field-wise select of two tenant tables; a field both share (the
    configuration, or whatever the step left alone) is kept as is."""
    return if_true._replace(**{
        f: torch.where(pred, a, b)
        for f, a, b in zip(if_true._fields, if_true, if_false) if a is not b})


def _where_state(pred, if_true: SchedulerState,
                 if_false: SchedulerState) -> SchedulerState:
    """Field-wise select of two states of one layout (a state without a
    deferral queue or a tenant table has ``None`` there, and nothing is
    selected)."""
    pick = {"tl": _where_tl, "tenants": _where_table}
    return if_true._replace(**{
        f: pick.get(f, torch.where)(
            pred, getattr(if_true, f), getattr(if_false, f))
        for f in _STEP_FIELDS if getattr(if_true, f) is not None})


def _read(stats: Optional[StreamStats], xs: List[torch.Tensor]) -> List[int]:
    """One host read of 0-d device values (bools, or int32 with them)."""
    if len(xs) == 1:
        vals = [int(xs[0])]
    else:
        if any(x.dtype != torch.bool for x in xs):
            xs = [x.to(I32) for x in xs]
        vals = [int(v) for v in torch.stack(xs).cpu().tolist()]
    if stats is not None:
        stats.sync()
    return vals


def _release_then(state: SchedulerState, t_now: int,
                  stats: Optional[StreamStats], probe=None, stop=None,
                  reap: bool = False) -> Tuple[SchedulerState, List[int]]:
    """:func:`release_due`, reading ``probe(state)`` with every flag.

    ``probe`` maps the state to a list of 0-d device values, computed
    with each "anything still due?" flag and read in the same transfer.
    Returns the state and the last read, ``[due, *probe]``: the reading
    that comes with the last flag (nothing due) is of the released
    state.  A read for which ``stop(values)`` holds ends the loop before
    the release it announces.  ``reap`` charges the releases as reaped.
    """
    while True:
        due = (state.pend_te <= t_now).any() & ~state.overflow
        vals = _read(stats, [due] + ([] if probe is None else probe(state)))
        if not vals[0] or (stop is not None and stop(vals)):
            return state, vals
        state = _release_chunk(state, t_now, reap)
        if stats is not None:
            stats.release_passes += 1


def _promote_due(s: SchedulerState, t_now: int) -> SchedulerState:
    """Commit the parked reservations whose start has arrived.

    A queue entry with ``t_s <= t_now`` becomes immovable and moves to
    the pending-release buffer, freeing its queue slot.  All due entries
    promote in one pass: the k-th due entry in FCFS order takes the k-th
    free pending slot in index order, so the pending arrays equal the
    reference's, not just the records.  A tenanted state ranks by the
    fair-share key instead (higher first, sequence breaking ties) and
    moves each entry's owner with it.  More due entries than free
    slots latch ``overflow`` (``hw_pending`` K + 1).  The caller gates
    it: the pass assumes something is due and nothing has overflowed.
    """
    K = s.pending_capacity
    tn = s.tenants
    due = (s.park_seq < T_INF) & (s.park_ts <= t_now)
    free = s.pend_te == T_INF
    n_free = free.sum().to(I32)
    n_due = due.sum().to(I32)
    seq = torch.where(due, s.park_seq, T_INF)
    if tn is None:
        # FCFS rank among due entries (sequence numbers are unique)
        rank = ((seq[None, :] < seq[:, None]) & due[None, :]).sum(dim=1)
    else:
        # due entries strictly ahead: a higher key, or an equal key and
        # an earlier sequence number
        key = tenancy_lib.fair_key(tn, t_now)
        ahead = due[None, :] & ((key[None, :] > key[:, None])
                                | ((key[None, :] == key[:, None])
                                   & (seq[None, :] < seq[:, None])))
        rank = ahead.sum(dim=1)
    promoted = due & (rank < n_free)
    frank = torch.cumsum(free, dim=0) - 1
    # take[q, k]: queue entry q goes to pending slot k
    take = promoted[:, None] & free[None, :] & (frank[None, :]
                                                == rank[:, None])
    got = take.any(dim=0)
    src = take.to(I32).argmax(dim=0)

    def scat(pend, park):
        return torch.where(got if pend.dim() == 1 else got[:, None],
                           park[src], pend)

    ovf = n_due > n_free
    n_prom = torch.minimum(n_due, n_free)
    used0 = (~free).sum().to(I32)
    if tn is not None:
        # ownership follows the reservation; freed queue slots return
        # to unowned
        s = s._replace(tenants=tn._replace(
            pend_tenant=scat(tn.pend_tenant, tn.park_tenant),
            park_tenant=torch.where(promoted, -1, tn.park_tenant),
            park_ta=torch.where(promoted, 0, tn.park_ta)))
    return s._replace(
        pend_ts=scat(s.pend_ts, s.park_ts),
        pend_te=scat(s.pend_te, s.park_te),
        pend_mask=scat(s.pend_mask, s.park_mask),
        park_ts=torch.where(promoted, T_INF, s.park_ts),
        park_te=torch.where(promoted, T_INF, s.park_te),
        park_mask=torch.where(promoted[:, None], 0, s.park_mask),
        park_seq=torch.where(promoted, T_INF, s.park_seq),
        n_promoted=s.n_promoted + n_prom,
        overflow=s.overflow | ovf,
        hw_pending=torch.maximum(s.hw_pending, torch.where(
            ovf, K + 1, used0 + n_prom).to(I32)))


def _due_parked(s: SchedulerState, t_now: int) -> torch.Tensor:
    """0-d bool: some live queue entry starts by ``t_now``."""
    return ((s.park_seq < T_INF) & (s.park_ts <= t_now)).any() & ~s.overflow


def release_due(state: SchedulerState, t_now: int,
                stats: Optional[StreamStats] = None) -> SchedulerState:
    """Delete every pending reservation with ``t_e <= t_now``.

    The deletions commute and the timeline is canonical, so deleting
    them RELEASE_CHUNK at a time equals deleting them one by one.
    Each pass is preceded by one host read of "anything still due?".
    With a deferral queue, the parked reservations whose start has
    arrived are promoted first (selected on the device, no read), so a
    due end among them is released in the same call: the session's
    ``tick``.
    """
    if state.park_capacity:
        state = _where_state(_due_parked(state, t_now),
                             _promote_due(state, t_now), state)
    return _release_then(state, t_now, stats)[0]


# the fields an admit step may change (the layout fields stay)
_STEP_FIELDS = tuple(f for f in SchedulerState._fields
                     if f not in ("lane_valid", "rspec"))

# the queue's integer columns, as one host read lays them out
_QUEUE_COLS = ("park_seq", "park_ts", "park_te", "park_tr", "park_tdl",
               "park_npe")


# a tenanted queue adds its owners and arrival stamps (the fair key's
# inputs), and the table's weights as their float32 bits
_TENANT_COLS = ("park_tenant", "park_ta")


def _read_queue(s: SchedulerState, stats: Optional[StreamStats],
                flags: Sequence[torch.Tensor] = ()
                ) -> Tuple[Dict[str, np.ndarray], List[int]]:
    """The queue's columns, and 0-d ``flags``, in one host read."""
    tn = s.tenants
    parts = [getattr(s, f) for f in _QUEUE_COLS]
    if tn is not None:
        parts += [getattr(tn, f) for f in _TENANT_COLS]
    cols = torch.stack(parts).reshape(-1)
    if tn is not None:
        cols = torch.cat([cols, tn.weight.view(I32)])
    if flags:
        cols = torch.cat([cols, torch.stack(list(flags)).to(I32)])
    host = cols.cpu().numpy()
    if stats is not None:
        stats.sync()
    Q = s.park_capacity
    names = _QUEUE_COLS + (_TENANT_COLS if tn is not None else ())
    q = {f: host[k * Q:(k + 1) * Q] for k, f in enumerate(names)}
    k = len(names) * Q
    if tn is not None:
        q["weight"] = host[k:k + tn.n_tenants].view(np.float32)
        k += tn.n_tenants
    return q, [int(v) for v in host[k:]]


def _fcfs(q: Dict[str, np.ndarray]) -> List[int]:
    """Live queue slots in FCFS order (ascending sequence number)."""
    seq = q["park_seq"]
    return [int(i) for i in np.argsort(seq, kind="stable") if seq[i] < T_INF]


def _order(q: Dict[str, np.ndarray], t_now: int) -> List[int]:
    """Live queue slots in service order at ``t_now``.

    FCFS; on a tenanted queue the fair-share key decides, highest first
    and the sequence number breaking ties, with the device's float32
    product (:func:`~repro_torch.tenancy.table.fair_key`).  Keys do not
    change inside a sweep, so this order is the reference's choice of
    the next entry at every iteration.
    """
    live = _fcfs(q)
    if "weight" not in q:
        return live
    w = q["weight"]
    T = w.shape[0]

    def rank(i):
        tid = min(max(int(q["park_tenant"][i]), 0), T - 1)
        wait = np.float32(np.int32(t_now) - np.int32(q["park_ta"][i]))
        return (-np.float32(w[tid] * wait), int(q["park_seq"][i]))

    return sorted(live, key=rank)


def _park_demand(s: SchedulerState, i: int) -> Optional[torch.Tensor]:
    """Demand tail of queue entry ``i`` (``None`` on R = 1 states)."""
    return None if s.park_dem is None else s.park_dem[i]


def _retry_parked(s: SchedulerState, t_now: int, *, n_pe: int,
                  use_kernel: bool, stats: Optional[StreamStats]
                  ) -> SchedulerState:
    """EASY retry-on-release sweep: pull parked reservations earlier.

    In service order (:func:`_order`) each live entry is lifted off the
    timeline, re-searched with
    :func:`~repro_torch.core.search.replacement_search`
    (First Fit: the earliest feasible start) and moved only to a
    strictly earlier start, so the sweep never delays anybody, the head
    included.  It runs after a cancel armed ``park_retry``: completions
    free only past capacity.  The queue is read once; every iteration's
    accept stays on the device.
    """
    q, _ = _read_queue(s, stats)
    idx = torch.arange(s.park_capacity, device=s.park_seq.device)
    for i in _order(q, t_now):
        ts, te = int(q["park_ts"][i]), int(q["park_te"][i])
        t_du = te - ts
        act = ~s.overflow
        tl1, ovf1, nk1 = tl_lib.update(s.tl, ts, te, s.park_mask[i],
                                       is_add=False, with_count=True)
        res = search_lib.replacement_search(
            tl1, int(q["park_tr"][i]), t_du, int(q["park_tdl"][i]),
            int(q["park_npe"][i]), 0, t_now, n_pe=n_pe,
            use_kernel=use_kernel, rspec=s.rspec,
            demand_tail=_park_demand(s, i), valid_mask=s.lane_valid,
            reject=False)
        if stats is not None:
            stats.retry_searches += 1
        better = act & ~ovf1 & res.found & (res.t_s < ts)
        new_ts = torch.where(better, res.t_s, ts)
        new_mk = torch.where(better, res.pe_mask, s.park_mask[i])
        tl2, ovf2, nk2 = tl_lib.update(tl1, new_ts, new_ts + t_du, new_mk,
                                       is_add=True, with_count=True)
        apply = act & ~ovf1 & ~ovf2
        moved = apply & better
        hit = (idx == i) & moved
        s = s._replace(
            tl=_where_tl(apply, tl2, s.tl),
            park_ts=torch.where(hit, new_ts, s.park_ts),
            park_te=torch.where(hit, new_ts + t_du, s.park_te),
            park_mask=torch.where(hit[:, None], new_mk[None, :], s.park_mask),
            n_moved=s.n_moved + moved.to(I32),
            overflow=s.overflow | (act & (ovf1 | ovf2)),
            hw_records=torch.maximum(s.hw_records, torch.where(
                act, torch.maximum(nk1, nk2), 0).to(I32)))
    return s


def _probes(gate, probe) -> list:
    """The step's predicates read with the release flags: the quota gate
    (tenanted states), then the early reject (indexed timelines)."""
    return [p for p in (gate, probe) if p is not None]


def _split(vals: Sequence[int], gate, probe
           ) -> Tuple[Optional[bool], Optional[bool]]:
    """``(within, reject)`` from the values :func:`_probes` read."""
    it = iter(vals)
    within = bool(next(it)) if gate is not None else None
    reject = bool(next(it)) if probe is not None else None
    return within, reject


def _queue_then(state: SchedulerState, t_now: int, bf: int,
                stats: Optional[StreamStats], gate, probe, *, n_pe: int,
                use_kernel: bool
                ) -> Tuple[SchedulerState, Optional[bool], Optional[bool],
                           bool]:
    """Queue work and release of one backfilling admit step.

    As the reference's one queue-work ``lax.cond``: when a live entry is
    due, or (EASY) a cancel armed the retry latch and the queue holds
    anything, promote the due entries, release, then run the retry
    sweep if it is still armed and the queue still holds entries;
    otherwise only release.  The latch is consumed either way.  The
    queue's predicates come with the release loop's first flag, so a
    step whose queue is idle reads exactly what a ``none`` step reads.
    ``gate`` (tenanted states) gives the quota gate and ``probe``
    (indexed timelines) the early-reject predicate of the state the
    search will see; both ride on the release loop's reads.  The retry
    sweep changes no tenant's usage or live count, so the gate read
    before it stands; the early reject is read again after it.  Returns
    that state, the gate and the predicate, and whether two or more
    entries are live (EASY displacement needs two).
    """
    easy = bf == BF_EASY
    extra = _probes(gate, probe)

    def head(s):
        live = s.park_seq < T_INF
        promote = _due_parked(s, t_now)
        work = promote
        if easy:
            work = work | (s.park_retry & live.any() & ~s.overflow)
        return [work, promote, s.park_retry, live.sum() >= 2] + [
            p(s) for p in extra]

    state, v = _release_then(state, t_now, stats, head, stop=lambda v: v[1])
    work, promote, retry, two_live = (bool(x) for x in v[1:5])
    within, reject = _split(v[5:], gate, probe)
    if work:
        if promote:
            state = _promote_due(state, t_now)

        def after(s):
            live = s.park_seq < T_INF
            sweep = s.park_retry & live.any() & ~s.overflow
            return [sweep, live.sum() >= 2] + [p(s) for p in extra]

        state, v = _release_then(state, t_now, stats, after)
        sweep, two_live = easy and bool(v[1]), bool(v[2])
        within, reject = _split(v[3:], gate, probe)
        if sweep:
            state = _retry_parked(state, t_now, n_pe=n_pe,
                                  use_kernel=use_kernel, stats=stats)
            if probe is not None:
                reject = bool(_read(stats, [probe(state)])[0])
    if retry:
        state = state._replace(park_retry=torch.zeros_like(state.park_retry))
    return state, within, reject, two_live


def _displace(s: SchedulerState, req: Tuple[int, ...], policy_id: int,
              q: Dict[str, np.ndarray], *, n_pe: int, use_kernel: bool,
              stats: Optional[StreamStats], demand: Optional[torch.Tensor]
              ) -> Tuple[SchedulerState, search_lib.SearchResult]:
    """EASY displacement: admit ``req`` by moving non-head reservations.

    The transaction: lift every non-head queue reservation off the
    timeline in one ``update_many``, place the request (its own policy,
    its whole window) around the committed reservations and the head,
    then re-place the lifted entries in service order (:func:`_order`:
    FCFS, or the fair-share key's on a tenanted queue, whose head is
    then the entry with the highest key) at their earliest feasible
    start inside their own windows.  The request is admitted
    only if every lifted entry fits again; otherwise every field rolls
    back (``overflow`` and the high-water marks aside: an overflow
    inside the transaction latches whatever the outcome, so the host's
    grow-and-re-run stays deterministic).  The head and every committed
    start are untouched by construction.  ``q`` is the queue as read
    on the host; whether the request fits around the lifted entries is
    read once, and the re-placements run only if it does (with it
    unplaced, each of them would change nothing).  Returns the state
    and the request's search result, ``found`` the transaction's
    outcome.
    """
    t_a, t_r, t_du, t_dl, n_req = req
    order = _order(q, t_a)
    live = s.park_seq < T_INF
    if s.tenants is None:
        head_seq = torch.where(live, s.park_seq, T_INF).min()
    else:
        head_seq = int(q["park_seq"][order[0]])
    nonhead = live & (s.park_seq != head_seq)
    tl, ovf, hw = tl_lib.update_many(s.tl, s.park_ts, s.park_te,
                                     s.park_mask, nonhead, is_add=False,
                                     with_count=True)
    tl = _where_tl(ovf, s.tl, tl)
    res_r = search_lib.search(
        tl, t_r, t_du, t_dl, n_req, policy_id, t_a, n_pe=n_pe,
        use_kernel=use_kernel, rspec=s.rspec, demand_tail=demand,
        valid_mask=s.lane_valid, reject=False)
    if stats is not None:
        stats.displace_searches += 1
    # a t_e at the horizon sentinel would commit as a no-op record:
    # rejected, as in the admit step
    ok = res_r.found & ~ovf & (res_r.t_e < T_INF)
    if not _read(stats, [ok])[0]:
        return s._replace(overflow=s.overflow | ovf,
                          hw_records=torch.maximum(s.hw_records, hw)), \
            res_r._replace(found=ok)
    tl2, o2, nk2 = tl_lib.update(tl, res_r.t_s, res_r.t_e, res_r.pe_mask,
                                 is_add=True, with_count=True)
    ovf = ovf | o2
    tl = _where_tl(o2, tl, tl2)
    hw = torch.maximum(hw, nk2)
    idx = torch.arange(s.park_capacity, device=s.park_seq.device)
    pts, pte, pmk = s.park_ts, s.park_te, s.park_mask
    moved = torch.zeros((), dtype=I32, device=idx.device)
    for i in order[1:]:
        ts = int(q["park_ts"][i])
        du = int(q["park_te"][i]) - ts
        act = ok & ~ovf
        res = search_lib.replacement_search(
            tl, int(q["park_tr"][i]), du, int(q["park_tdl"][i]),
            int(q["park_npe"][i]), 0, t_a, n_pe=n_pe,
            use_kernel=use_kernel, rspec=s.rspec,
            demand_tail=_park_demand(s, i), valid_mask=s.lane_valid,
            reject=False)
        if stats is not None:
            stats.displace_searches += 1
        okp = act & res.found
        t2, o2, nk = tl_lib.update(
            tl, torch.where(okp, res.t_s, 0),
            torch.where(okp, res.t_s + du, 1),
            torch.where(okp, res.pe_mask, 0), is_add=True, with_count=True)
        tl = _where_tl(okp & ~o2, t2, tl)
        ovf = ovf | (okp & o2)
        hw = torch.maximum(hw, torch.where(okp, nk, 0).to(I32))
        ok = ok & (res.found | ~act)
        hit = (idx == i) & okp
        pts = torch.where(hit, res.t_s, pts)
        pte = torch.where(hit, res.t_s + du, pte)
        pmk = torch.where(hit[:, None], res.pe_mask[None, :], pmk)
        moved = moved + (okp & (res.t_s != ts)).to(I32)
    commit = ok & ~ovf
    return s._replace(
        tl=_where_tl(commit, tl, s.tl),
        park_ts=torch.where(commit, pts, s.park_ts),
        park_te=torch.where(commit, pte, s.park_te),
        park_mask=torch.where(commit, pmk, s.park_mask),
        n_moved=s.n_moved + torch.where(commit, moved, 0),
        overflow=s.overflow | ovf,
        hw_records=torch.maximum(s.hw_records, hw)), \
        res_r._replace(found=commit)


def _park_write(o: SchedulerState, do: torch.Tensor, t_s: torch.Tensor,
                t_e: torch.Tensor, pe_mask: torch.Tensor, t_r: int,
                t_dl: int, n_req: int, demand: Optional[torch.Tensor],
                tid: int = 0, t_a: int = 0) -> SchedulerState:
    """Book an accepted, delayed request into the first free queue slot
    (where ``do``); it keeps its window and demand for re-placement, and
    on a tenanted state its owner ``tid`` and arrival ``t_a`` (the fair
    key's wait starts there)."""
    free = o.park_seq == T_INF
    hit = (torch.arange(o.park_capacity, device=free.device)
           == first_true(free)) & do
    live = (~free).sum().to(I32) + 1
    out = o._replace(
        park_ts=torch.where(hit, t_s, o.park_ts),
        park_te=torch.where(hit, t_e, o.park_te),
        park_mask=torch.where(hit[:, None], pe_mask[None, :], o.park_mask),
        park_tr=torch.where(hit, t_r, o.park_tr),
        park_tdl=torch.where(hit, t_dl, o.park_tdl),
        park_npe=torch.where(hit, n_req, o.park_npe),
        park_seq=torch.where(hit, o.park_next_seq, o.park_seq),
        park_next_seq=o.park_next_seq + do.to(I32),
        n_parked=o.n_parked + do.to(I32),
        hw_parked=torch.where(do, torch.maximum(o.hw_parked, live),
                              o.hw_parked))
    if o.park_dem is not None:
        row = (torch.zeros_like(o.park_dem[0]) if demand is None
               else demand.to(I32))
        out = out._replace(park_dem=torch.where(hit[:, None], row[None, :],
                                                o.park_dem))
    tn = o.tenants
    if tn is not None:
        out = out._replace(tenants=tn._replace(
            park_tenant=torch.where(hit, tid, tn.park_tenant),
            park_ta=torch.where(hit, t_a, tn.park_ta)))
    return out


def _occ_frac(s: SchedulerState, t: int, n_pe: int) -> torch.Tensor:
    """float32: the busy share of the PEs (plane 0 only) at instant ``t``.

    The division is by a tensor on the device: CUDA divides by a Python
    number through its reciprocal, which can differ in the last bit.
    """
    row = tl_lib.occupancy_at(s.tl, t)
    if s.rspec is not None:
        row = row[s.rspec.plane_slice(0)]
    busy = words_lib.popcount(row).sum().to(torch.float32)
    return busy / torch.full((), float(n_pe), dtype=torch.float32,
                             device=busy.device)


def _set_col(x: torch.Tensor, i: int, v: torch.Tensor) -> torch.Tensor:
    """``x`` with column ``i`` of its last axis replaced by ``v``."""
    return torch.cat([x[..., :i], v[..., None], x[..., i + 1:]], dim=-1)


def _account(s: SchedulerState, tid: int, found: torch.Tensor,
             parks: Optional[torch.Tensor], blocked: bool,
             occ_frac: torch.Tensor, t_e: torch.Tensor,
             req: Tuple[int, ...]) -> SchedulerState:
    """Charge one real request to tenant ``tid`` (no host read).

    ``found`` and ``s`` are the step's outcome and committed state;
    ``req`` is the request as offered (a gated one's rewrite aside), so
    the slowdown sample is ``f32(t_e - t_r) / f32(t_du)`` of the
    original.  An overflowed step charges nothing: it is re-run.  The
    EWMAs round as pinned in :mod:`repro_torch.tenancy.table`.
    """
    t_a, t_r, t_du, t_dl, n_req = req
    tn = s.tenants
    dev = tn.used.device
    ok = ~s.overflow
    acc = found & ok
    rej = (ok & ~acc).to(I32)
    acc_i = acc.to(I32)
    prk = (torch.zeros_like(acc_i) if parks is None
           else (acc & parks).to(I32))
    inc = torch.stack([acc_i, acc_i, rej,
                       rej if blocked else torch.zeros_like(rej), prk])
    cnt = torch.stack([tn.live, tn.n_accepted, tn.n_rejected,
                       tn.n_quota_rejected, tn.n_parked])
    live, n_acc, n_rej, n_qrej, n_prk = _set_col(
        cnt, tid, cnt[:, tid] + inc).unbind(0)
    a = tn.alpha
    oma = 1.0 - a
    a64, oma64 = a.double(), oma.double()

    def fma(p, q, r):
        # p * q + r with one float32 rounding; p * q is exact in float64
        return (p.double() * q + r.double()).to(torch.float32)

    acc_x = acc.to(torch.float32)
    new_acc = fma(acc_x, a64, tn.acc_ewma[tid] * oma)
    slow_x = (t_e - t_r).to(torch.float32) / torch.full(
        (), float(t_du), dtype=torch.float32, device=dev)
    new_slow = fma(slow_x, a64, tn.slow_ewma[tid] * oma)
    new_occ = fma(tn.occ_ewma, oma64, occ_frac * a)
    dem = float(np.float32(n_req) * np.float32(t_du))
    used = tn.used[tid]
    col = torch.stack([torch.where(acc, used + dem, used),
                       torch.where(ok, new_acc, tn.acc_ewma[tid]),
                       torch.where(acc, new_slow, tn.slow_ewma[tid])])
    fl = torch.stack([tn.used, tn.acc_ewma, tn.slow_ewma])
    used_v, acc_v, slow_v = _set_col(fl, tid, col).unbind(0)
    return s._replace(tenants=tn._replace(
        used=used_v, live=live, n_accepted=n_acc, n_rejected=n_rej,
        n_quota_rejected=n_qrej, n_parked=n_prk, acc_ewma=acc_v,
        slow_ewma=slow_v,
        occ_ewma=torch.where(ok, new_occ, tn.occ_ewma)))


def _admit_impl(state: SchedulerState, req: Tuple[int, ...],
                policy_id: int, bf: int = BF_NONE, *, n_pe: int,
                auto_release: bool, use_kernel: bool,
                stats: Optional[StreamStats],
                demand: Optional[torch.Tensor] = None, tenant: int = 0
                ) -> Tuple[SchedulerState, Decision]:
    t_a, t_r, t_du, t_dl, n_req = req
    probe = None
    if state.tl.ispec is not None:
        def probe(s):
            return search_lib.index_reject(
                s.tl, t_r, t_du, t_dl, n_req, rspec=s.rspec,
                demand_tail=demand, valid_mask=s.lane_valid)
    # the quota gate: filler (n_pe + 1 PEs) belongs to no tenant and is
    # neither gated nor charged
    gate = None
    tid = 0
    real = state.tenants is not None and n_req <= n_pe
    if real:
        tid = min(max(int(tenant), 0), state.tenants.n_tenants - 1)
        ask = float(np.float32(n_req) * np.float32(t_du))

        def gate(s):
            tn = s.tenants
            return ((tn.used[tid] + ask <= tn.quota[tid])
                    & (tn.live[tid] < tn.max_live[tid]))
    # the queue works only where the reference's does: with
    # auto-release (promotion goes through the pending buffer)
    backfilling = bool(state.park_capacity) and auto_release
    within = reject = None
    two_live = False
    if backfilling:
        state, within, reject, two_live = _queue_then(
            state, t_a, bf, stats, gate, probe, n_pe=n_pe,
            use_kernel=use_kernel)
    elif auto_release:
        extra = _probes(gate, probe)
        state, v = _release_then(state, t_a, stats,
                                 (lambda s: [p(s) for p in extra])
                                 if extra else None)
        within, reject = _split(v[1:], gate, probe)
    elif gate is not None or probe is not None:
        # no release loop to ride on: the step's one read
        within, reject = _split(
            _read(stats, [p(state) for p in _probes(gate, probe)]),
            gate, probe)
    blocked = real and not within
    occ_frac = _occ_frac(state, t_a, n_pe) if real else None
    if blocked:
        # an over-quota request is searched as a never-feasible one, as
        # the reference rewrites it (``req`` keeps the offered request,
        # which the accounting charges); asking for n_pe + 1 PEs, it is
        # rejected by summary_reject's capacity proof on any index
        t_r, t_du, t_dl, n_req = t_a, 1, t_a + 1, n_pe + 1
        if probe is not None:
            reject = True
    res = search_lib.search(state.tl, t_r, t_du, t_dl, n_req, policy_id,
                            t_a, n_pe=n_pe, use_kernel=use_kernel,
                            rspec=state.rspec, demand_tail=demand,
                            valid_mask=state.lane_valid, reject=reject,
                            stats=stats)
    if reject and stats is not None:
        stats.early_rejects += 1
    queue = None
    if backfilling and bf == BF_EASY and two_live and not blocked:
        # EASY may displace when the search failed: that, and the
        # queue's order for the transaction, cross in one read (a gated
        # request never displaces)
        q, (found_h, ovf_h) = _read_queue(state, stats,
                                          [res.found, state.overflow])
        if not (found_h or ovf_h):
            queue = q
    if reject and queue is None:
        # nothing is feasible: the commit below would select the old
        # state in every field, so it is skipped (the tenant is still
        # charged a rejection)
        if real:
            state = _account(state, tid, res.found, None, blocked,
                             occ_frac, res.t_e, req)
        return state, _decision(res.found, res)
    # a win whose end reaches the horizon sentinel is rejected: the
    # update's T_INF guard would make its commit a silent no-op
    found = res.found & ~state.overflow & (res.t_e < T_INF)
    if queue is not None:
        if stats is not None:
            stats.displacements += 1
            stats.reject_displacements += bool(reject)
        state, res = _displace(state, req, policy_id, queue, n_pe=n_pe,
                               use_kernel=use_kernel, stats=stats,
                               demand=demand)
        found = res.found
    t_s, t_e, pe_mask = res.t_s, res.t_e, res.pe_mask
    parks = None
    if backfilling and bf != BF_NONE:
        parks = (t_s > t_r) & (state.park_seq == T_INF).any()

    # ---- commit, computed unconditionally and selected by `found`;
    # the pending-release slot only with auto_release or a tenant table,
    # as in the reference (a caller that releases by hand keeps no
    # ledger, unless reaping and cancels need one)
    s = state
    dev = s.pend_te.device
    if queue is None:
        new_tl, ovf, n_keep = tl_lib.update(s.tl, t_s, t_e, pe_mask,
                                            is_add=True, with_count=True)
    else:
        # the displacement already placed the request; the merged
        # timeline's record count is what a no-op update would report
        new_tl, ovf = s.tl, torch.zeros((), dtype=torch.bool, device=dev)
        n_keep = s.tl.n_valid()
    pend = {}
    if auto_release or s.tenants is not None:
        free = s.pend_te == T_INF
        slot = first_true(free)
        used = (~free).sum().to(I32) + 1
        if parks is None:
            ovf = ovf | ~free.any()
            wr = ~ovf
            hw_pending = torch.maximum(s.hw_pending, used)
        else:
            # a parked request takes a queue slot, not a pending one
            ovf = ovf | (~parks & ~free.any())
            wr = ~parks & ~ovf
            hw_pending = torch.maximum(s.hw_pending,
                                       torch.where(parks, 0, used))

        def put(x, v):
            y = x.index_put((slot.reshape(1),),
                            v.reshape((1,) + x.shape[1:]))
            return torch.where(wr, y, x)

        pend = dict(pend_ts=put(s.pend_ts, t_s), pend_te=put(s.pend_te, t_e),
                    pend_mask=put(s.pend_mask, pe_mask),
                    hw_pending=hw_pending)
        if s.tenants is not None:
            pend["tenants"] = s.tenants._replace(pend_tenant=put(
                s.tenants.pend_tenant,
                torch.full((), tid, dtype=I32, device=dev)))
    committed = s._replace(
        # an overflowing update returns a truncated timeline: keep the
        # pre-commit one so the re-run starts from consistent data
        tl=new_tl if queue is not None else _where_tl(ovf, s.tl, new_tl),
        n_accepted=s.n_accepted + torch.where(ovf, 0, 1).to(I32),
        overflow=s.overflow | ovf,
        hw_records=torch.maximum(s.hw_records, n_keep), **pend)
    if parks is not None:
        committed = _park_write(committed, parks & ~ovf, t_s, t_e, pe_mask,
                                t_r, t_dl, n_req, demand, tid, t_a)
    state = _where_state(found, committed, state)
    if real:
        state = _account(state, tid, found, parks, blocked, occ_frac, t_e,
                         req)
    return state, _decision(found & ~state.overflow, res, parks)


def _decision(accepted: torch.Tensor, res: search_lib.SearchResult,
              parks: Optional[torch.Tensor] = None) -> Decision:
    return Decision(
        accepted=accepted,
        t_s=torch.where(accepted, res.t_s, -1),
        t_e=torch.where(accepted, res.t_e, -1),
        pe_mask=torch.where(accepted, res.pe_mask, 0),
        n_free=res.n_free, t_begin=res.t_begin, t_end=res.t_end,
        parked=torch.zeros_like(accepted) if parks is None
        else accepted & parks)


def _policy_id(policy) -> int:
    if isinstance(policy, (int, np.integer)):
        return int(policy)
    return policy_index(policy)


def admit(state: SchedulerState, req, policy, backfill=BF_NONE, *,
          n_pe: int, auto_release: bool = True, use_kernel: bool = True,
          stats: Optional[StreamStats] = None
          ) -> Tuple[SchedulerState, Decision]:
    """One fused admission step: release due -> queue work -> search ->
    commit (or park).

    ``req`` is an :class:`ARRequest` or a :func:`request_struct`.
    ``auto_release=False`` skips the release pass for callers that
    manage completions themselves.  ``backfill`` (any spelling of
    :func:`as_backfill_id`) matters only on a state with a deferral
    queue; the request's ``tenant`` only on a tenanted state.
    """
    tenant = getattr(req, "tenant", None)
    return _admit_impl(state, _field_tuple(req), _policy_id(policy),
                       as_backfill_id(backfill), n_pe=n_pe,
                       auto_release=auto_release, use_kernel=use_kernel,
                       stats=stats, demand=request_demand(state, req),
                       tenant=0 if tenant is None else int(tenant))


def admit_stream(state: SchedulerState, batch: RequestBatch, policy,
                 backfill=BF_NONE, *, n_pe: int, auto_release: bool = True,
                 use_kernel: bool = True,
                 stats: Optional[StreamStats] = None
                 ) -> Tuple[SchedulerState, Decision]:
    """Admit an arrival-ordered stream; decisions stacked ``[N]``.

    The request fields cross to the host once, up front: every step's
    search takes them as kernel arguments.  On a tenanted state the
    tenant column crosses with them (a batch without one is tenant 0's).
    """
    pid = _policy_id(policy)
    bf = as_backfill_id(backfill)
    demand = batch.demand if state.rspec is not None else None
    if demand is not None and tuple(demand.shape) != (
            batch.t_a.shape[0], state.rspec.R - 1):
        raise ValueError(f"demand column {tuple(demand.shape)} does not "
                         f"match the spec's {state.rspec.R - 1} planes")
    cols = [getattr(batch, f) for f in REQ_FIELDS]
    if state.tenants is not None:
        cols.append(torch.zeros_like(batch.t_a) if batch.tenant is None
                    else batch.tenant.to(I32))
    rows = torch.stack(cols).cpu().numpy().T
    if stats is not None:
        stats.sync()
    decisions: List[Decision] = []
    for i, row in enumerate(rows):
        state, dec = _admit_impl(
            state, tuple(int(x) for x in row[:5]), pid, bf, n_pe=n_pe,
            auto_release=auto_release, use_kernel=use_kernel, stats=stats,
            demand=None if demand is None else demand[i],
            tenant=int(row[5]) if len(row) > 5 else 0)
        decisions.append(dec)
    if stats is not None:
        stats.steps += len(rows)
    if not decisions:
        W = state.tl.words
        dev = state.tl.device
        z = torch.zeros((0,), dtype=I32, device=dev)
        b = torch.zeros((0,), dtype=torch.bool, device=dev)
        return state, Decision(b, z, z, torch.zeros((0, W), dtype=I32,
                                                    device=dev), z, z, z, b)
    return state, Decision(*(torch.stack(f) for f in zip(*decisions)))


def admit_stream_donated(state: SchedulerState, batch: RequestBatch,
                         policy, backfill=BF_NONE, *, n_pe: int,
                         auto_release: bool = True, use_kernel: bool = True,
                         stats: Optional[StreamStats] = None
                         ) -> Tuple[SchedulerState, Decision]:
    """:func:`admit_stream` with the reference's latched rollback.

    The reference donates the state's buffers to this call, so it
    cannot re-run a batch from the caller's copy; PyTorch has no buffer
    donation, and here every step builds new tensors instead, so the
    input state stays valid.  What the function keeps is the protocol
    the pipelined offer is built on, with no host read of the latch:

    * a batch entered with ``overflow`` set returns its input state
      unchanged (its decisions are garbage and must be discarded);
    * a batch that overflows returns its input state, carrying the
      latch and the run's high-water marks, so the caller can grow once
      (:func:`grow_rollback`) and re-run it.
    """
    out, dec = admit_stream(state, batch, policy, backfill, n_pe=n_pe,
                            auto_release=auto_release,
                            use_kernel=use_kernel, stats=stats)
    ovf = state.overflow | out.overflow
    rolled = _where_state(ovf, state, out)
    return rolled._replace(
        overflow=ovf,
        hw_records=torch.maximum(state.hw_records, out.hw_records),
        hw_pending=torch.maximum(state.hw_pending, out.hw_pending)), dec


class GrowthError(RuntimeError):
    """Overflow with growth exhausted or forbidden.

    ``state``, when set, is the rolled-back pre-run state of an
    :func:`admit_stream_donated` attempt (latched, with the failed
    run's high-water marks); a caller that runs that protocol
    reinstalls it, latch cleared, as the reference's service does.
    """

    def __init__(self, msg: str, state: Optional[SchedulerState] = None):
        super().__init__(msg)
        self.state = state


def grown_capacities(state: SchedulerState, need_records: int,
                     need_pending: int) -> Tuple[int, int]:
    """New ``(capacity, pending_capacity)`` sized by the high-water marks.

    A structure whose mark fits keeps its size; one that overflowed
    jumps to the next power of two covering the need (at least
    doubling, so retries always progress).
    """
    cap, pend = state.tl.capacity, state.pending_capacity
    new_cap = cap if need_records <= cap \
        else max(2 * cap, tl_lib.next_pow2(need_records))
    new_pend = pend if need_pending <= pend \
        else max(2 * pend, tl_lib.next_pow2(need_pending))
    if (new_cap, new_pend) == (cap, pend):
        new_cap, new_pend = 2 * cap, 2 * pend
    return new_cap, new_pend


def _grown(state: SchedulerState, run: SchedulerState,
           stats: Optional[StreamStats] = None) -> SchedulerState:
    """Grow the pre-run snapshot to what the failed ``run`` needed."""
    if stats is not None:
        stats.sync(2)
        stats.growths += 1
    new_cap, new_pend = grown_capacities(
        state, int(run.hw_records), int(run.hw_pending))
    return tl_lib.grow_state(state, new_capacity=new_cap,
                             new_pending_capacity=new_pend)


def grow_rollback(state: SchedulerState,
                  stats: Optional[StreamStats] = None) -> SchedulerState:
    """Grow a rolled-back (latched) state and clear its latch.

    An :func:`admit_stream_donated` overflow returns the pre-run state
    carrying the failed run's high-water marks, so that state is its
    own growth reference.
    """
    out = _grown(state, state, stats)
    return out._replace(overflow=torch.zeros_like(out.overflow))


def admit_stream_grow(state: SchedulerState, batch: RequestBatch, policy,
                      *, n_pe: int, backfill=BF_NONE,
                      auto_release: bool = True,
                      use_kernel: bool = True,
                      max_growths: int = MAX_DOUBLINGS,
                      stats: Optional[StreamStats] = None,
                      donate: bool = False
                      ) -> Tuple[SchedulerState, Decision]:
    """:func:`admit_stream`, growing capacity on overflow.

    Each retry re-runs the whole batch from the (grown) pre-run state;
    padding never changes decisions, so the result equals a run that
    started with enough capacity.  ``max_growths=0`` forbids growth.
    ``donate=True`` runs :func:`admit_stream_donated` (the reference's
    donated path): retries grow the rolled-back state, and a terminal
    overflow raises :class:`GrowthError` carrying it.  Decisions are
    the same either way.  ``backfill`` is the deferral mode (it matters
    on a state with a queue, which growth never resizes).
    """
    fn = admit_stream_donated if donate else admit_stream
    bf = as_backfill_id(backfill)
    start = state
    for attempt in range(max_growths + 1):
        out, dec = fn(start, batch, policy, bf, n_pe=n_pe,
                      auto_release=auto_release, use_kernel=use_kernel,
                      stats=stats)
        if stats is not None:
            stats.sync()
            stats.capacity = start.tl.capacity
            stats.pending_capacity = start.pending_capacity
        if not bool(out.overflow):
            return out, dec
        if attempt < max_growths:
            start = grow_rollback(out, stats) if donate \
                else _grown(start, out, stats)
    last = out if donate else start
    raise GrowthError(
        f"admit_stream still overflowing after {max_growths + 1} attempts "
        f"(last tried capacity {last.tl.capacity}, pending "
        f"{last.pending_capacity}; needed records {int(out.hw_records)}, "
        f"pending {int(out.hw_pending)})", state=out if donate else None)


def admit_stream_auto(state: SchedulerState, batch: RequestBatch, policy,
                      *, n_pe: int, backfill=BF_NONE,
                      auto_release: bool = True, use_kernel: bool = True
                      ) -> Tuple[SchedulerState, Decision]:
    """Deprecated alias of :func:`admit_stream_grow`.

    Use :class:`repro_torch.api.ReservationService` (a session's
    ``offer`` streams fixed-shape chunks), or :func:`admit_stream_grow`
    for a one-shot batch.
    """
    warnings.warn(
        "admit_stream_auto is deprecated: open a repro_torch.api."
        "ReservationService session and use Session.offer(requests) "
        "(or admit_stream_grow for a one-shot batch)",
        DeprecationWarning, stacklevel=2)
    return admit_stream_grow(state, batch, policy, n_pe=n_pe,
                             backfill=backfill, auto_release=auto_release,
                             use_kernel=use_kernel)


def admit_one(state: SchedulerState, req: ARRequest, policy: Policy, *,
              n_pe: int, backfill=BF_NONE, auto_release: bool = True,
              use_kernel: bool = True
              ) -> Tuple[SchedulerState, Optional[Allocation]]:
    """Single fused admission with growth retry; host-typed result."""
    start = state
    for attempt in range(MAX_DOUBLINGS + 1):
        out, dec = admit(start, req, policy, backfill, n_pe=n_pe,
                         auto_release=auto_release, use_kernel=use_kernel)
        if not bool(out.overflow):
            return out, decision_to_allocation(dec)
        if attempt < MAX_DOUBLINGS:
            start = _grown(start, out)
    raise GrowthError(
        f"admit still overflowing after {MAX_DOUBLINGS + 1} attempts "
        f"(last tried capacity {start.tl.capacity}, "
        f"pending {start.pending_capacity})")


def release_until(state: SchedulerState, t_now: int, *,
                  max_growths: int = MAX_DOUBLINGS,
                  stats: Optional[StreamStats] = None) -> SchedulerState:
    """Delete every pending reservation ending by ``t_now``, with growth.

    A deletion can split a merged record and overflow the timeline; the
    retry re-runs from the pre-call state on a grown one.
    ``max_growths=0`` raises on the first overflow instead, changing
    nothing.
    """
    start = state
    for attempt in range(max_growths + 1):
        out = release_due(start, t_now, stats)
        if stats is not None:
            stats.sync()
        if not bool(out.overflow):
            return out
        if attempt < max_growths:
            start = _grown(start, out, stats)
    raise GrowthError(
        f"release_until still overflowing after {max_growths + 1} "
        f"attempts (last tried capacity {start.tl.capacity})")


def reap_step(state: SchedulerState, t_now: int, grace: int,
              stats: Optional[StreamStats] = None) -> SchedulerState:
    """Delete the reservations overdue past the tenant grace window.

    A reservation is overdue at ``t_now`` iff ``t_e + grace <= t_now``,
    i.e. ``t_e <= t_now - grace``: reaping is the release loop at the
    shifted cutoff, each freed slot also charged to its owner's
    ``n_reaped``.  No promotion runs first.  Meant for sessions that
    track completions themselves (``auto_release=False``): with
    auto-release every reservation is released at ``t_e``.
    """
    return _release_then(state, int(t_now) - int(grace), stats,
                         reap=True)[0]


def reap_until(state: SchedulerState, t_now: int, grace: int, *,
               max_growths: int = MAX_DOUBLINGS,
               stats: Optional[StreamStats] = None) -> SchedulerState:
    """:func:`reap_step` with overflow growth (a deletion can split a
    merged record); as :func:`release_until`."""
    start = state
    for attempt in range(max_growths + 1):
        out = reap_step(start, t_now, grace, stats)
        if stats is not None:
            stats.sync()
        if not bool(out.overflow):
            return out
        if attempt < max_growths:
            start = _grown(start, out, stats)
    raise GrowthError(
        f"reap_until still overflowing after {max_growths + 1} "
        f"attempts (last tried capacity {start.tl.capacity})")


def cancel_step(state: SchedulerState, t_s: int, t_e: int,
                mask: torch.Tensor, *, require_pending: bool = True
                ) -> Tuple[SchedulerState, torch.Tensor]:
    """Withdraw one committed reservation ``[t_s, t_e) x mask``.

    Deletes it from the timeline and clears its pending-release slot.
    With ``require_pending`` (auto-release sessions) a reservation that
    is not pending (released, cancelled, never admitted) is a no-op
    returning ``False``, so cancel is idempotent.  Overflow latches as
    in :func:`admit`; :func:`cancel_one` grows and retries.  Returns the
    new state and a 0-d bool on the device.
    """
    dev = state.pend_te.device
    match = ((state.pend_ts == t_s) & (state.pend_te == t_e)
             & (state.pend_mask == mask[None, :]).all(dim=1))
    found = match.any()
    if state.park_capacity:
        # a parked (deferral-queue) reservation is cancellable too
        pmatch = ((state.park_ts == t_s) & (state.park_te == t_e)
                  & (state.park_mask == mask[None, :]).all(dim=1)
                  & (state.park_seq < T_INF))
        found = found | pmatch.any()
    ok = found if require_pending else torch.ones((), dtype=torch.bool,
                                                  device=dev)
    ok = ok & ~state.overflow
    new_tl, ovf, n_keep = tl_lib.update(state.tl, t_s, t_e, mask,
                                        is_add=False, with_count=True)
    ovf = ovf & ok
    do = ok & ~ovf
    clear = match & (torch.cumsum(match, dim=0) == 1) & do  # first match
    out = state._replace(
        tl=_where_tl(do, new_tl, state.tl),
        pend_ts=torch.where(clear, T_INF, state.pend_ts),
        pend_te=torch.where(clear, T_INF, state.pend_te),
        pend_mask=torch.where(clear[:, None], 0, state.pend_mask),
        overflow=state.overflow | ovf,
        hw_records=torch.maximum(state.hw_records,
                                 torch.where(ok, n_keep, 0)))
    pclear = None
    if state.park_capacity:
        pclear = pmatch & (torch.cumsum(pmatch, dim=0) == 1) & do
        out = out._replace(
            park_ts=torch.where(pclear, T_INF, out.park_ts),
            park_te=torch.where(pclear, T_INF, out.park_te),
            park_mask=torch.where(pclear[:, None], 0, out.park_mask),
            park_seq=torch.where(pclear, T_INF, out.park_seq),
            # a withdrawal frees future capacity: arm the EASY retry
            # sweep for the next admit step
            park_retry=out.park_retry | do)
    return _disown(out, clear, pclear), do


def _disown(out: SchedulerState, clear: torch.Tensor,
            pclear: Optional[torch.Tensor]) -> SchedulerState:
    """Return the cancelled slots of a tenanted state to unowned and
    drop their owners' live counts (pending ``clear``, queue ``pclear``)."""
    tn = out.tenants
    if tn is None:
        return out
    live = tn.live - _tenant_dec(tn, clear, tn.pend_tenant)
    upd = dict(pend_tenant=torch.where(clear, -1, tn.pend_tenant))
    if pclear is not None:
        live = live - _tenant_dec(tn, pclear, tn.park_tenant)
        upd.update(park_tenant=torch.where(pclear, -1, tn.park_tenant),
                   park_ta=torch.where(pclear, 0, tn.park_ta))
    return out._replace(tenants=tn._replace(live=live, **upd))


def cancel_one(state: SchedulerState, t_s: int, t_e: int,
               mask: torch.Tensor, *, require_pending: bool = True,
               max_growths: int = MAX_DOUBLINGS
               ) -> Tuple[SchedulerState, bool]:
    """:func:`cancel_step` with overflow growth; a host bool."""
    start = state
    for attempt in range(max_growths + 1):
        out, done = cancel_step(start, t_s, t_e, mask,
                                require_pending=require_pending)
        if not bool(out.overflow):
            return out, bool(done)
        if attempt < max_growths:
            start = _grown(start, out)
    raise GrowthError(
        f"cancel still overflowing after {max_growths + 1} attempts "
        f"(last tried capacity {start.tl.capacity})")


def cancel_many_step(state: SchedulerState, t_s: torch.Tensor,
                     t_e: torch.Tensor, masks: torch.Tensor,
                     active: torch.Tensor, *, require_pending: bool = True
                     ) -> Tuple[SchedulerState, torch.Tensor]:
    """Withdraw up to K committed reservations in one pass.

    One ``timeline.update_many`` deletes every matched interval and
    their pending slots clear together; cancellations of distinct
    reservations commute, so this equals K sequential cancels (callers
    must not repeat a reservation within one batch; :func:`cancel_many`
    removes repeats).  Returns the new state and bool[K] outcomes.
    """
    K = t_s.shape[0]
    P = state.pending_capacity
    dev = state.pend_te.device
    pmatch = ((state.pend_ts[None, :] == t_s[:, None])
              & (state.pend_te[None, :] == t_e[:, None])
              & (state.pend_mask[None, :, :] == masks[:, None, :]).all(
                  dim=2))                                        # [K, P]
    pfound = pmatch.any(dim=1)
    found = pfound
    if state.park_capacity:
        kmatch = ((state.park_ts[None, :] == t_s[:, None])
                  & (state.park_te[None, :] == t_e[:, None])
                  & (state.park_mask[None, :, :] == masks[:, None, :]).all(
                      dim=2)
                  & (state.park_seq[None, :] < T_INF))           # [K, Q]
        kfound = kmatch.any(dim=1)
        found = found | kfound
    ok = found if require_pending else torch.ones((K,), dtype=torch.bool,
                                                  device=dev)
    ok = ok & active & ~state.overflow
    new_tl, ovf, n_keep = tl_lib.update_many(
        state.tl, t_s, t_e, masks, ok, is_add=False, with_count=True)
    do = ok & ~ovf

    def first_hits(m, hit_rows, n):
        # slots of each row's first match, for the rows that hit
        slot = m.to(torch.int32).argmax(dim=1)
        hit = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
        hit[torch.where(hit_rows, slot, n)] = True
        return hit[:n]

    clear = first_hits(pmatch, do & pfound, P)
    out = state._replace(
        tl=_where_tl(ovf, state.tl, new_tl),
        pend_ts=torch.where(clear, T_INF, state.pend_ts),
        pend_te=torch.where(clear, T_INF, state.pend_te),
        pend_mask=torch.where(clear[:, None], 0, state.pend_mask),
        overflow=state.overflow | ovf,
        hw_records=torch.maximum(state.hw_records, torch.where(
            ok.any(), n_keep, 0)))
    pclear = None
    if state.park_capacity:
        pclear = first_hits(kmatch, do & kfound, state.park_capacity)
        out = out._replace(
            park_ts=torch.where(pclear, T_INF, out.park_ts),
            park_te=torch.where(pclear, T_INF, out.park_te),
            park_mask=torch.where(pclear[:, None], 0, out.park_mask),
            park_seq=torch.where(pclear, T_INF, out.park_seq),
            park_retry=out.park_retry | do.any())
    return _disown(out, clear, pclear), do


def cancel_many(state: SchedulerState, entries, *,
                require_pending: bool = True,
                max_growths: int = MAX_DOUBLINGS
                ) -> Tuple[SchedulerState, List[bool]]:
    """:func:`cancel_many_step` with overflow growth.

    ``entries`` is a sequence of ``(t_s, t_e, mask)`` triples.  Under
    ``require_pending`` a triple repeated within the batch is removed on
    the host: its first occurrence cancels and the later ones report
    ``False``, as sequential :func:`cancel_one` calls would.  With
    ``require_pending=False`` cancels are blind deletes that report
    ``True`` every time, so repeats stay (the batched AND-NOT union is
    idempotent).  The batch pads to a power of two of inactive rows.
    """
    entries = list(entries)
    if not entries:
        return state, []
    dev = state.pend_te.device
    W = state.tl.words
    masks_np = [words_lib.to_int32(np.asarray(
        e[2].cpu().numpy() if isinstance(e[2], torch.Tensor) else e[2]
    ).reshape(W)) for e in entries]
    act = np.ones(len(entries), bool)
    if require_pending:
        seen = set()
        for i, (ts, te, _) in enumerate(entries):
            key = (int(ts), int(te), masks_np[i].tobytes())
            act[i] = key not in seen
            seen.add(key)
    K = tl_lib.next_pow2(len(entries)) if len(entries) > 1 else 1
    cols = np.zeros((3, K), np.int32)
    cols[0, :len(entries)] = [int(e[0]) for e in entries]
    cols[1, :len(entries)] = [int(e[1]) for e in entries]
    cols[2, :len(entries)] = act
    masks = np.zeros((K, W), np.int32)
    masks[:len(entries)] = np.stack(masks_np)
    c = torch.from_numpy(cols).to(dev)
    t_s, t_e, active = c[0], c[1], c[2] > 0
    masks_t = torch.from_numpy(masks).to(dev)
    start = state
    for attempt in range(max_growths + 1):
        out, done = cancel_many_step(start, t_s, t_e, masks_t, active,
                                     require_pending=require_pending)
        if not bool(out.overflow):
            return out, [bool(d) for d in
                         done[:len(entries)].cpu().numpy()]
        if attempt < max_growths:
            start = _grown(start, out)
    raise GrowthError(
        f"cancel_many still overflowing after {max_growths + 1} attempts "
        f"(last tried capacity {start.tl.capacity})")


def parked_entries(state: SchedulerState) -> List[dict]:
    """Host view of the deferral queue in FCFS order.

    One dict per live entry: the reservation (``t_s``/``t_e``/
    ``pe_ids``), the window it can still be re-placed in (``t_r``/
    ``t_dl``/``n_pe``), its sequence number, on multi-resource states
    its full ``demand``, and on tenanted states its ``tenant`` and
    arrival ``t_a``.  Without tenants the first entry is the head of
    queue (protected under EASY); with them the head is the entry with
    the highest fair-share key.  Empty without a queue.
    """
    if not state.park_capacity:
        return []
    q, _ = _read_queue(state, None)
    masks = state.park_mask.cpu().numpy()
    dem = None if state.park_dem is None else state.park_dem.cpu().numpy()
    out = []
    for i in _fcfs(q):
        entry = dict(
            seq=int(q["park_seq"][i]), t_s=int(q["park_ts"][i]),
            t_e=int(q["park_te"][i]), t_r=int(q["park_tr"][i]),
            t_dl=int(q["park_tdl"][i]), n_pe=int(q["park_npe"][i]),
            pe_ids=mask32_to_ids(masks[i]))
        if dem is not None:
            entry["demand"] = (entry["n_pe"],) + tuple(int(x)
                                                        for x in dem[i])
        if "weight" in q:
            entry["tenant"] = int(q["park_tenant"][i])
            entry["t_a"] = int(q["park_ta"][i])
        out.append(entry)
    return out


def mask32_to_ids(mask32) -> Tuple[int, ...]:
    """int32 (or uint32) [W] bitmask -> sorted tuple of PE ids.

    On multi-resource masks the ids are global bit ids: plane ``r``'s
    unit ``u`` is ``rspec.bit_offset(r) + u``.
    """
    if isinstance(mask32, torch.Tensor):
        mask32 = mask32.cpu().numpy()
    bits = np.unpackbits(
        np.ascontiguousarray(mask32).view("<u4").view(np.uint8),
        bitorder="little")
    return tuple(int(i) for i in np.nonzero(bits)[0])


def _allocation(found, t_s, t_e, pe_mask, n_free, t_begin,
                t_end) -> Optional[Allocation]:
    if not bool(found):
        return None
    return Allocation(
        t_s=int(t_s), t_e=int(t_e), pe_ids=mask32_to_ids(pe_mask),
        rectangle=Rectangle(t_s=int(t_s), t_begin=int(t_begin),
                            t_end=int(t_end), n_free=int(n_free)))


def decision_to_allocation(dec: Decision) -> Optional[Allocation]:
    """One 0-d :class:`Decision` -> host :class:`Allocation`."""
    return _allocation(dec.accepted, dec.t_s, dec.t_e, dec.pe_mask,
                       dec.n_free, dec.t_begin, dec.t_end)


def decisions_to_allocations(dec: Decision) -> List[Optional[Allocation]]:
    """Stacked decisions -> one host allocation (or None) per request."""
    accepted, t_s, t_e, masks, n_free, t_begin, t_end = (
        x.cpu().numpy() for x in (dec.accepted, dec.t_s, dec.t_e,
                                  dec.pe_mask, dec.n_free, dec.t_begin,
                                  dec.t_end))
    return [_allocation(*f) for f in zip(accepted, t_s, t_e, masks, n_free,
                                         t_begin, t_end)]


def search_result_to_allocation(res: search_lib.SearchResult
                                ) -> Optional[Allocation]:
    """One ``SearchResult`` -> host :class:`Allocation`."""
    return _allocation(res.found, res.t_s, res.t_e, res.pe_mask,
                       res.n_free, res.t_begin, res.t_end)

