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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import search as search_lib
from repro_torch.core import timeline as tl_lib
from repro_torch.core import words as words_lib
from repro_torch.core.policies import first_true, policy_index
from repro_torch.core.timeline import I32, SchedulerState
from repro_torch.core.types import (
    Allocation,
    ARRequest,
    Policy,
    Rectangle,
    T_INF,
)
from repro_torch.device import DeviceLike, resolve_device

# Growth retries before the host wrappers give up.
MAX_DOUBLINGS = 8

# Due reservations deleted per release pass (one update_many call).
RELEASE_CHUNK = 8


class RequestBatch(NamedTuple):
    """Struct-of-tensors AR request stream, sorted by arrival time.

    ``demand`` is the optional multi-resource column: int32[N, R-1]
    secondary-plane demands (plane 0 is ``n_pe``); ``None`` for
    single-resource streams.
    """

    t_a: torch.Tensor   # int32[N]
    t_r: torch.Tensor
    t_du: torch.Tensor
    t_dl: torch.Tensor
    n_pe: torch.Tensor
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
    parked: torch.Tensor    # bool; always False (no deferral queue)


@dataclasses.dataclass
class StreamStats:
    """What one admission run cost the host (summed over attempts)."""

    steps: int = 0           # admit steps, re-runs after growth included
    host_syncs: int = 0      # reads of device values by the host
    release_passes: int = 0  # RELEASE_CHUNK passes (update_many calls)
    growths: int = 0         # overflow -> grow -> re-run cycles
    early_rejects: int = 0   # steps the index proved infeasible
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
    """Host columns (with any ``demand<k>``) -> a RequestBatch on device.

    The five request columns cross in one copy; the demand columns
    stack along a trailing axis into the int32[N, R-1] tail (``None``
    without any).
    """
    cols = np.stack([np.asarray(fields[f], np.int32) for f in REQ_FIELDS])
    t = torch.from_numpy(cols).to(device)
    dcols = sorted((k for k in fields if k.startswith("demand")),
                   key=lambda k: int(k[len("demand"):]))
    demand = None
    if dcols:
        demand = torch.from_numpy(np.stack(
            [np.asarray(fields[k], np.int32) for k in dcols],
            axis=-1)).to(device)
    return RequestBatch(*t, demand=demand)


def requests_to_batch(jobs: Sequence[ARRequest], device: DeviceLike = None,
                      extra_demand: int = 0) -> RequestBatch:
    """Pack host requests into the device struct-of-tensors layout.

    ``extra_demand`` (= R - 1) adds the multi-resource demand column;
    requests without a demand vector stage zeros there.
    """
    dev = resolve_device(device)
    names = REQ_FIELDS + _demand_fields(extra_demand)
    fields = {f: np.array([_req_field(j, f) for j in jobs], np.int32)
              for f in names}
    return _fields_to_batch(fields, dev)


def request_struct(req: ARRequest, extra_demand: int = 0,
                   device: DeviceLike = None) -> RequestBatch:
    """A single request as 0-d tensors (demand int32[R-1]) for :func:`admit`."""
    b = requests_to_batch([req], device, extra_demand)
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


class RequestRing:
    """Fixed-capacity FIFO staging ring for streaming admission.

    Arriving requests are staged in host numpy storage and leave as
    fixed-shape device chunks via :meth:`pop_chunk`, so every chunk has
    the same shapes however the arrivals are grouped.  Slots are reused
    modulo ``capacity``; a full ring rejects the push.
    """

    def __init__(self, capacity: int, extra_demand: int = 0):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.capacity = capacity
        self._fields = REQ_FIELDS + _demand_fields(extra_demand)
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

    def pop_chunk(self, chunk: int, n_pe: int, device: DeviceLike = None
                  ) -> Tuple[RequestBatch, np.ndarray]:
        """Dequeue up to ``chunk`` requests as one fixed-shape batch.

        Always ``chunk`` long: missing tail positions hold
        :func:`filler_request` padding and are ``False`` in the
        returned ``valid`` mask.
        """
        n = min(chunk, self.count)
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


def _release_chunk(s: SchedulerState, t_now: int) -> SchedulerState:
    """Delete up to RELEASE_CHUNK due reservations in one update_many."""
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
    return s._replace(
        tl=_where_tl(ovf, s.tl, new_tl),
        pend_ts=torch.where(chosen, T_INF, s.pend_ts),
        pend_te=torch.where(chosen, T_INF, s.pend_te),
        pend_mask=torch.where(chosen[:, None], 0, s.pend_mask),
        n_released=s.n_released + torch.where(
            ovf, 0, chosen.sum()).to(I32),
        overflow=s.overflow | ovf,
        hw_records=torch.maximum(s.hw_records, n_keep))


def _where_tl(pred, if_true: tl_lib.Timeline,
              if_false: tl_lib.Timeline) -> tl_lib.Timeline:
    """Field-wise select of two timelines of one layout (index too)."""
    return if_true._replace(**{
        f: torch.where(pred, getattr(if_true, f), getattr(if_false, f))
        for f in ("times", "occ", "idx_occ", "idx_minfree", "idx_maxfree")
        if getattr(if_true, f) is not None})


def _where_state(pred, if_true: SchedulerState,
                 if_false: SchedulerState) -> SchedulerState:
    """Field-wise select of two states of one layout."""
    return if_true._replace(**{
        f: (_where_tl if f == "tl" else torch.where)(
            pred, getattr(if_true, f), getattr(if_false, f))
        for f in _STEP_FIELDS})


def _release_then(state: SchedulerState, t_now: int,
                  stats: Optional[StreamStats], probe=None
                  ) -> Tuple[SchedulerState, Optional[bool]]:
    """:func:`release_due`, plus ``probe(state)`` read with its last flag.

    ``probe`` maps the state to a 0-d bool on the device.  It is
    computed with every "anything still due?" flag and read in the same
    transfer; the reading that comes with the last flag (nothing due)
    is of the released state, and is returned with it.
    """
    while True:
        due = (state.pend_te <= t_now).any() & ~state.overflow
        value = None
        if probe is None:
            due_h = bool(due)
        else:
            due_h, value = (bool(x) for x in
                            torch.stack([due, probe(state)]).cpu())
        if stats is not None:
            stats.sync()
        if not due_h:
            return state, value
        state = _release_chunk(state, t_now)
        if stats is not None:
            stats.release_passes += 1


def release_due(state: SchedulerState, t_now: int,
                stats: Optional[StreamStats] = None) -> SchedulerState:
    """Delete every pending reservation with ``t_e <= t_now``.

    The deletions commute and the timeline is canonical, so deleting
    them RELEASE_CHUNK at a time equals deleting them one by one.
    Each pass is preceded by one host read of "anything still due?".
    """
    return _release_then(state, t_now, stats)[0]


# the fields an admit step may change (the layout fields stay)
_STEP_FIELDS = tuple(f for f in SchedulerState._fields
                     if f not in ("lane_valid", "rspec"))


def _admit_impl(state: SchedulerState, req: Tuple[int, ...],
                policy_id: int, *, n_pe: int, auto_release: bool,
                use_kernel: bool, stats: Optional[StreamStats],
                demand: Optional[torch.Tensor] = None
                ) -> Tuple[SchedulerState, Decision]:
    t_a, t_r, t_du, t_dl, n_req = req
    probe = None
    if state.tl.ispec is not None:
        def probe(s):
            return search_lib.index_reject(
                s.tl, t_r, t_du, t_dl, n_req, rspec=s.rspec,
                demand_tail=demand, valid_mask=s.lane_valid)
    reject = None
    if auto_release:
        state, reject = _release_then(state, t_a, stats, probe)
    elif probe is not None:
        reject = bool(probe(state))
        if stats is not None:
            stats.sync()
    res = search_lib.search(state.tl, t_r, t_du, t_dl, n_req, policy_id,
                            t_a, n_pe=n_pe, use_kernel=use_kernel,
                            rspec=state.rspec, demand_tail=demand,
                            valid_mask=state.lane_valid, reject=reject,
                            stats=stats)
    if reject:
        # nothing is feasible: the commit below would select the old
        # state in every field, so it is skipped
        if stats is not None:
            stats.early_rejects += 1
        return state, _decision(res.found, res)
    # a win whose end reaches the horizon sentinel is rejected: the
    # update's T_INF guard would make its commit a silent no-op
    found = res.found & ~state.overflow & (res.t_e < T_INF)
    t_s, t_e, pe_mask = res.t_s, res.t_e, res.pe_mask

    # ---- commit, computed unconditionally and selected by `found`;
    # the pending-release slot only with auto_release, as in the
    # reference (a caller that releases by hand keeps no ledger)
    s = state
    new_tl, ovf, n_keep = tl_lib.update(s.tl, t_s, t_e, pe_mask,
                                        is_add=True, with_count=True)
    pend = {}
    if auto_release:
        free = s.pend_te == T_INF
        slot = first_true(free)
        ovf = ovf | ~free.any()
        wr = ~ovf

        def put(x, v):
            y = x.index_put((slot.reshape(1),),
                            v.reshape((1,) + x.shape[1:]))
            return torch.where(wr, y, x)

        pend = dict(pend_ts=put(s.pend_ts, t_s), pend_te=put(s.pend_te, t_e),
                    pend_mask=put(s.pend_mask, pe_mask),
                    hw_pending=torch.maximum(
                        s.hw_pending, (~free).sum().to(I32) + 1))
    committed = s._replace(
        # an overflowing update returns a truncated timeline: keep the
        # pre-commit one so the re-run starts from consistent data
        tl=_where_tl(ovf, s.tl, new_tl),
        n_accepted=s.n_accepted + torch.where(ovf, 0, 1).to(I32),
        overflow=s.overflow | ovf,
        hw_records=torch.maximum(s.hw_records, n_keep), **pend)
    state = _where_state(found, committed, state)
    return state, _decision(found & ~state.overflow, res)


def _decision(accepted: torch.Tensor,
              res: search_lib.SearchResult) -> Decision:
    return Decision(
        accepted=accepted,
        t_s=torch.where(accepted, res.t_s, -1),
        t_e=torch.where(accepted, res.t_e, -1),
        pe_mask=torch.where(accepted, res.pe_mask, 0),
        n_free=res.n_free, t_begin=res.t_begin, t_end=res.t_end,
        parked=torch.zeros_like(accepted))


def _policy_id(policy) -> int:
    if isinstance(policy, (int, np.integer)):
        return int(policy)
    return policy_index(policy)


def admit(state: SchedulerState, req, policy, *, n_pe: int,
          auto_release: bool = True, use_kernel: bool = True,
          stats: Optional[StreamStats] = None
          ) -> Tuple[SchedulerState, Decision]:
    """One fused admission step: release due -> search -> commit.

    ``req`` is an :class:`ARRequest` or a :func:`request_struct`.
    ``auto_release=False`` skips the release pass for callers that
    manage completions themselves.
    """
    return _admit_impl(state, _field_tuple(req), _policy_id(policy),
                       n_pe=n_pe, auto_release=auto_release,
                       use_kernel=use_kernel, stats=stats,
                       demand=request_demand(state, req))


def admit_stream(state: SchedulerState, batch: RequestBatch, policy, *,
                 n_pe: int, auto_release: bool = True,
                 use_kernel: bool = True,
                 stats: Optional[StreamStats] = None
                 ) -> Tuple[SchedulerState, Decision]:
    """Admit an arrival-ordered stream; decisions stacked ``[N]``.

    The request fields cross to the host once, up front: every step's
    search takes them as kernel arguments.
    """
    pid = _policy_id(policy)
    demand = batch.demand if state.rspec is not None else None
    if demand is not None and tuple(demand.shape) != (
            batch.t_a.shape[0], state.rspec.R - 1):
        raise ValueError(f"demand column {tuple(demand.shape)} does not "
                         f"match the spec's {state.rspec.R - 1} planes")
    rows = torch.stack([getattr(batch, f) for f in REQ_FIELDS]
                       ).cpu().numpy().T
    if stats is not None:
        stats.sync()
    decisions: List[Decision] = []
    for i, row in enumerate(rows):
        state, dec = _admit_impl(
            state, tuple(int(x) for x in row), pid, n_pe=n_pe,
            auto_release=auto_release, use_kernel=use_kernel, stats=stats,
            demand=None if demand is None else demand[i])
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
                         policy, *, n_pe: int, auto_release: bool = True,
                         use_kernel: bool = True,
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
    out, dec = admit_stream(state, batch, policy, n_pe=n_pe,
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
                      *, n_pe: int, auto_release: bool = True,
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
    the same either way.
    """
    fn = admit_stream_donated if donate else admit_stream
    start = state
    for attempt in range(max_growths + 1):
        out, dec = fn(start, batch, policy, n_pe=n_pe,
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


def admit_one(state: SchedulerState, req: ARRequest, policy: Policy, *,
              n_pe: int, auto_release: bool = True,
              use_kernel: bool = True
              ) -> Tuple[SchedulerState, Optional[Allocation]]:
    """Single fused admission with growth retry; host-typed result."""
    start = state
    for attempt in range(MAX_DOUBLINGS + 1):
        out, dec = admit(start, req, policy, n_pe=n_pe,
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
    ok = found if require_pending else torch.ones((), dtype=torch.bool,
                                                  device=dev)
    ok = ok & ~state.overflow
    new_tl, ovf, n_keep = tl_lib.update(state.tl, t_s, t_e, mask,
                                        is_add=False, with_count=True)
    ovf = ovf & ok
    do = ok & ~ovf
    clear = match & (torch.cumsum(match, dim=0) == 1) & do  # first match
    return state._replace(
        tl=_where_tl(do, new_tl, state.tl),
        pend_ts=torch.where(clear, T_INF, state.pend_ts),
        pend_te=torch.where(clear, T_INF, state.pend_te),
        pend_mask=torch.where(clear[:, None], 0, state.pend_mask),
        overflow=state.overflow | ovf,
        hw_records=torch.maximum(state.hw_records,
                                 torch.where(ok, n_keep, 0))), do


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
    found = pmatch.any(dim=1)
    ok = found if require_pending else torch.ones((K,), dtype=torch.bool,
                                                  device=dev)
    ok = ok & active & ~state.overflow
    new_tl, ovf, n_keep = tl_lib.update_many(
        state.tl, t_s, t_e, masks, ok, is_add=False, with_count=True)
    do = ok & ~ovf
    slot = pmatch.to(torch.int32).argmax(dim=1)                  # first
    hit = torch.zeros((P + 1,), dtype=torch.bool, device=dev)
    hit[torch.where(do & found, slot, P)] = True
    clear = hit[:P]
    return state._replace(
        tl=_where_tl(ovf, state.tl, new_tl),
        pend_ts=torch.where(clear, T_INF, state.pend_ts),
        pend_te=torch.where(clear, T_INF, state.pend_te),
        pend_mask=torch.where(clear[:, None], 0, state.pend_mask),
        overflow=state.overflow | ovf,
        hw_records=torch.maximum(state.hw_records, torch.where(
            ok.any(), n_keep, 0))), do


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

