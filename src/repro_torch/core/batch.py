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
overflow latch once per attempt.  :class:`StreamStats` counts them.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import search as search_lib
from repro_torch.core import timeline as tl_lib
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
    """Struct-of-tensors AR request stream, sorted by arrival time."""

    t_a: torch.Tensor   # int32[N]
    t_r: torch.Tensor
    t_du: torch.Tensor
    t_dl: torch.Tensor
    n_pe: torch.Tensor


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
    capacity: int = 0        # timeline capacity of the last attempt
    pending_capacity: int = 0  # pending-buffer capacity of the last attempt

    def sync(self, n: int = 1) -> None:
        self.host_syncs += n


def requests_to_batch(jobs: Sequence[ARRequest],
                      device: DeviceLike = None) -> RequestBatch:
    """Pack host requests into the device struct-of-tensors layout."""
    dev = resolve_device(device)
    cols = np.array([[j.t_a, j.t_r, j.t_du, j.t_dl, j.n_pe] for j in jobs],
                    dtype=np.int32).reshape(-1, 5)
    t = torch.from_numpy(np.ascontiguousarray(cols.T)).to(dev)
    return RequestBatch(*t)


def _field_tuple(req) -> Tuple[int, int, int, int, int]:
    return tuple(int(getattr(req, f)) for f in
                 ("t_a", "t_r", "t_du", "t_dl", "n_pe"))


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
    return tl_lib.Timeline(
        times=torch.where(pred, if_true.times, if_false.times),
        occ=torch.where(pred, if_true.occ, if_false.occ))


def release_due(state: SchedulerState, t_now: int,
                stats: Optional[StreamStats] = None) -> SchedulerState:
    """Delete every pending reservation with ``t_e <= t_now``.

    The deletions commute and the timeline is canonical, so deleting
    them RELEASE_CHUNK at a time equals deleting them one by one.
    Each pass is preceded by one host read of "anything still due?".
    """
    while True:
        due = (state.pend_te <= t_now).any() & ~state.overflow
        if stats is not None:
            stats.sync()
        if not bool(due):
            return state
        state = _release_chunk(state, t_now)
        if stats is not None:
            stats.release_passes += 1


def _admit_impl(state: SchedulerState, req: Tuple[int, ...],
                policy_id: int, *, n_pe: int, auto_release: bool,
                use_kernel: bool, stats: Optional[StreamStats]
                ) -> Tuple[SchedulerState, Decision]:
    t_a, t_r, t_du, t_dl, n_req = req
    if auto_release:
        state = release_due(state, t_a, stats)
    res = search_lib.search(state.tl, t_r, t_du, t_dl, n_req, policy_id,
                            t_a, n_pe=n_pe, use_kernel=use_kernel)
    # a win whose end reaches the horizon sentinel is rejected: the
    # update's T_INF guard would make its commit a silent no-op
    found = res.found & ~state.overflow & (res.t_e < T_INF)
    t_s, t_e, pe_mask = res.t_s, res.t_e, res.pe_mask

    # ---- commit, computed unconditionally and selected by `found`
    s = state
    new_tl, ovf, n_keep = tl_lib.update(s.tl, t_s, t_e, pe_mask,
                                        is_add=True, with_count=True)
    free = s.pend_te == T_INF
    slot = first_true(free)
    n_used = (~free).sum().to(I32) + 1
    ovf = ovf | ~free.any()
    wr = ~ovf

    def put(x, v):
        y = x.index_put((slot.reshape(1),), v.reshape((1,) + x.shape[1:]))
        return torch.where(wr, y, x)

    committed = s._replace(
        # an overflowing update returns a truncated timeline: keep the
        # pre-commit one so the re-run starts from consistent data
        tl=_where_tl(ovf, s.tl, new_tl),
        pend_ts=put(s.pend_ts, t_s), pend_te=put(s.pend_te, t_e),
        pend_mask=put(s.pend_mask, pe_mask),
        n_accepted=s.n_accepted + torch.where(ovf, 0, 1).to(I32),
        overflow=s.overflow | ovf,
        hw_records=torch.maximum(s.hw_records, n_keep),
        hw_pending=torch.maximum(s.hw_pending, n_used))
    state = SchedulerState(*(
        _where_tl(found, c, o) if isinstance(o, tl_lib.Timeline)
        else torch.where(found, c, o)
        for c, o in zip(committed, state)))
    accepted = found & ~state.overflow
    return state, Decision(
        accepted=accepted,
        t_s=torch.where(accepted, t_s, -1),
        t_e=torch.where(accepted, t_e, -1),
        pe_mask=torch.where(accepted, pe_mask, 0),
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

    ``req`` is an :class:`ARRequest` (or anything with its five
    integer fields).  ``auto_release=False`` skips the release pass for
    callers that manage completions themselves.
    """
    return _admit_impl(state, _field_tuple(req), _policy_id(policy),
                       n_pe=n_pe, auto_release=auto_release,
                       use_kernel=use_kernel, stats=stats)


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
    rows = torch.stack(list(batch)).cpu().numpy().T
    if stats is not None:
        stats.sync()
    decisions: List[Decision] = []
    for row in rows:
        state, dec = _admit_impl(
            state, tuple(int(x) for x in row), pid, n_pe=n_pe,
            auto_release=auto_release, use_kernel=use_kernel, stats=stats)
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


class GrowthError(RuntimeError):
    """Overflow with growth exhausted."""


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


def admit_stream_grow(state: SchedulerState, batch: RequestBatch, policy,
                      *, n_pe: int, auto_release: bool = True,
                      use_kernel: bool = True,
                      max_growths: int = MAX_DOUBLINGS,
                      stats: Optional[StreamStats] = None
                      ) -> Tuple[SchedulerState, Decision]:
    """:func:`admit_stream`, growing capacity on overflow.

    Each retry re-runs the whole batch from the (grown) pre-run state;
    padding never changes decisions, so the result equals a run that
    started with enough capacity.  ``max_growths=0`` forbids growth.
    """
    start = state
    for attempt in range(max_growths + 1):
        out, dec = admit_stream(start, batch, policy, n_pe=n_pe,
                                auto_release=auto_release,
                                use_kernel=use_kernel, stats=stats)
        if stats is not None:
            stats.sync()
            stats.capacity = start.tl.capacity
            stats.pending_capacity = start.pending_capacity
        if not bool(out.overflow):
            return out, dec
        if attempt < max_growths:
            start = _grown(start, out, stats)
    raise GrowthError(
        f"admit_stream still overflowing after {max_growths + 1} attempts "
        f"(last tried capacity {start.tl.capacity}, pending "
        f"{start.pending_capacity}; needed records {int(out.hw_records)}, "
        f"pending {int(out.hw_pending)})")


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


def mask32_to_ids(mask32) -> Tuple[int, ...]:
    """int32 (or uint32) [W] bitmask -> sorted tuple of PE ids."""
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


def search_result_to_allocation(res: search_lib.SearchResult
                                ) -> Optional[Allocation]:
    """One ``SearchResult`` -> host :class:`Allocation`."""
    return _allocation(res.found, res.t_s, res.t_e, res.pe_mask,
                       res.n_free, res.t_begin, res.t_end)

