"""The availability timeline as dense tensors.

The paper's ``AvailRectList`` (a linked list of ``{time, busy-PE-set}``
records) becomes a fixed-capacity struct of tensors:

``times : int32[S]``      sorted boundaries; ``T_INF`` marks padding
``occ   : int32[S, W]``   busy-PE bitmask during ``[times[i], times[i+1])``
                          (uint32 bits kept in int32, see ``words``)

Multi-resource states (``rspec`` set) widen the word axis to
``rspec.total_words``: one packed bitplane per resource, plane ``r`` on
the words of ``rspec.plane_slice(r)``, and bit ``u`` of that plane is
unit ``u`` of resource ``r``.

Invariants (kept by ``update``):
  * valid entries are strictly sorted and precede all padding;
  * consecutive valid rows differ (merged records, the paper's "clean");
  * the first valid row is non-empty; occupancy before the first and
    after the last valid boundary is empty, as is every padding row;
  * bits past ``n_pe`` are never set.

An indexed timeline (``ispec`` set) carries the availability index of
:mod:`repro_torch.core.availindex`: three summary tensors that every
update recomputes from the post-update rows, so they always equal
``availindex.build_summaries`` of the current records.

Every function is a plain function of tensors that returns new
tensors; none of them reads a value back to the host, and none writes
into a tensor it was given.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import availindex as idx_lib
from repro_torch.core import words as words_lib
from repro_torch.core.types import T_INF
from repro_torch.core.words import n_words, pack_bits, unpack_bits
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tenancy.table import FLOAT_FIELDS, TenantTable, grow_table

__all__ = [
    "Timeline", "SchedulerState", "n_words", "next_pow2", "empty",
    "init_state", "grow", "grow_state", "ids_to_mask32", "pack_bits",
    "unpack_bits", "occupancy_at", "next_times", "update",
    "update_lexsort", "update_many", "window_busy", "from_host",
    "state_from_numpy", "state_to_numpy", "ensemble_from_numpy",
    "ensemble_to_numpy",
]

I32 = torch.int32
Scalar = Union[int, torch.Tensor]


def next_pow2(n: int) -> int:
    """Smallest power of two >= ``n`` (and >= 2): growth sizing."""
    return 1 << max(int(n) - 1, 1).bit_length()


def scalar(x: Scalar, device: torch.device) -> torch.Tensor:
    """A 0-d int32 tensor on ``device``, made without a host sync."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=I32).reshape(())
    return torch.full((), int(x), dtype=I32, device=device)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0 for a 0-d index tensor, without a sync."""
    return x.index_select(0, idx.reshape(1).to(torch.int64))[0]


class Timeline(NamedTuple):
    """Fixed-capacity availability timeline.

    The index fields are ``None`` on a timeline without the index.
    """

    times: torch.Tensor  # int32[S]
    occ: torch.Tensor    # int32[S, W]
    idx_occ: Optional[torch.Tensor] = None      # int32[S/T, W]
    idx_minfree: Optional[torch.Tensor] = None  # int32[S/T, R]
    idx_maxfree: Optional[torch.Tensor] = None  # int32[S/T, R]
    ispec: Optional[Any] = None                 # IndexSpec

    @property
    def capacity(self) -> int:
        return self.times.shape[0]

    @property
    def words(self) -> int:
        return self.occ.shape[1]

    @property
    def device(self) -> torch.device:
        return self.times.device

    def n_valid(self) -> torch.Tensor:
        return (self.times < T_INF).sum().to(I32)


class SchedulerState(NamedTuple):
    """Scheduler state: the timeline, pending releases and counters.

    ``pend_te == T_INF`` marks a free slot of the pending-release
    buffer of committed reservations.  ``overflow`` latches when the
    timeline or the pending buffer ran out of capacity: every later
    admit step is then a no-op, and the host wrapper grows the state
    and re-runs the stream.  ``hw_records`` / ``hw_pending`` are
    high-water marks of what any step needed (the record count may
    exceed the capacity), so growth jumps to the size needed at once.
    Scalars are 0-d tensors on the state's device.
    """

    tl: Timeline
    pend_ts: torch.Tensor    # int32[K] reservation starts
    pend_te: torch.Tensor    # int32[K] reservation ends; T_INF = free
    pend_mask: torch.Tensor  # int32[K, W] reserved-PE bitmasks
    n_accepted: torch.Tensor  # int32
    n_released: torch.Tensor  # int32
    overflow: torch.Tensor    # bool
    hw_records: torch.Tensor  # int32: max records any update needed
    hw_pending: torch.Tensor  # int32: max pending slots needed
    # the backfilling deferral queue of Q entries, all None when Q == 0
    # (then no step touches it): accepted-but-delayed reservations hold
    # their mark here (start / end / mask occupy the timeline like any
    # committed one) with the window to re-place them in and an FCFS
    # sequence number; ``park_seq == T_INF`` marks a free slot and the
    # smallest live one is the head of queue
    park_ts: Optional[torch.Tensor] = None    # int32[Q] parked starts
    park_te: Optional[torch.Tensor] = None    # int32[Q] parked ends
    park_mask: Optional[torch.Tensor] = None  # int32[Q, W] parked masks
    park_tr: Optional[torch.Tensor] = None    # int32[Q] ready times
    park_tdl: Optional[torch.Tensor] = None   # int32[Q] deadlines
    park_npe: Optional[torch.Tensor] = None   # int32[Q] PEs requested
    park_seq: Optional[torch.Tensor] = None   # int32[Q]; T_INF = free
    # bool: a cancel freed future capacity; the next EASY admit step
    # runs the retry sweep once
    park_retry: Optional[torch.Tensor] = None
    park_next_seq: Optional[torch.Tensor] = None  # int32: next sequence
    n_parked: Optional[torch.Tensor] = None    # int32: lifetime parks
    n_promoted: Optional[torch.Tensor] = None  # int32: lifetime promotions
    n_moved: Optional[torch.Tensor] = None     # int32: lifetime moves
    hw_parked: Optional[torch.Tensor] = None   # int32: max live entries
    # int32[Q, R-1] secondary-plane demands of parked requests (R > 1)
    park_dem: Optional[torch.Tensor] = None
    # the multi-tenant table (a repro_torch.tenancy.TenantTable); None
    # without tenancy, and then no step touches it
    tenants: Optional[Any] = None
    # multi-resource layout, None on single-resource states:
    # ``lane_valid`` is the packed valid-unit mask of this lane (a
    # heterogeneous machine size shrinks it below the spec's padded
    # word layout); ``rspec`` the static ResourceSpec
    lane_valid: Optional[torch.Tensor] = None  # int32[W]
    rspec: Optional[Any] = None

    @property
    def pending_capacity(self) -> int:
        return self.pend_te.shape[0]

    @property
    def park_capacity(self) -> int:
        return 0 if self.park_seq is None else self.park_seq.shape[0]


#: The deferral queue's fields (``park_dem`` only on R > 1 states).
PARK_FIELDS = ("park_ts", "park_te", "park_mask", "park_tr", "park_tdl",
               "park_npe", "park_seq", "park_retry", "park_next_seq",
               "n_parked", "n_promoted", "n_moved", "hw_parked", "park_dem")


def _init_queue(Q: int, W: int, rspec, dev: torch.device) -> Dict[str, Any]:
    """An empty deferral queue of ``Q`` entries (nothing when Q == 0)."""
    if Q == 0:
        return {}

    def full(shape, v):
        return torch.full(shape, v, dtype=I32, device=dev)

    out = dict(
        park_ts=full((Q,), T_INF), park_te=full((Q,), T_INF),
        park_mask=full((Q, W), 0), park_tr=full((Q,), 0),
        park_tdl=full((Q,), 0), park_npe=full((Q,), 0),
        park_seq=full((Q,), T_INF),
        park_retry=torch.zeros((), dtype=torch.bool, device=dev),
        **{f: full((), 0) for f in ("park_next_seq", "n_parked",
                                    "n_promoted", "n_moved", "hw_parked")})
    if rspec is not None and rspec.R > 1:
        out["park_dem"] = full((Q, rspec.R - 1), 0)
    return out


def empty(capacity: int, n_pe: int, device: DeviceLike = None,
          words: Optional[int] = None, ispec=None) -> Timeline:
    """All-free timeline of ``capacity`` records.

    ``words`` overrides the word width (multi-resource layouts pass
    ``rspec.total_words``); ``ispec`` attaches the availability index.
    """
    dev = resolve_device(device)
    W = n_words(n_pe) if words is None else words
    out = Timeline(
        times=torch.full((capacity,), T_INF, dtype=I32, device=dev),
        occ=torch.zeros((capacity, W), dtype=I32, device=dev))
    if ispec is None:
        return out
    if ispec.total_words != W:
        raise ValueError(
            f"ispec covers {ispec.total_words} words, timeline has {W}")
    i_occ, i_min, i_max = idx_lib.empty_summaries(capacity, ispec, dev)
    return out._replace(idx_occ=i_occ, idx_minfree=i_min,
                        idx_maxfree=i_max, ispec=ispec)


def _reindex(tl: Timeline, ispec) -> Timeline:
    """The index of ``tl``'s rows, recomputed (``ispec=None``: none)."""
    if ispec is None:
        return tl
    i_occ, i_min, i_max = idx_lib.build_summaries(tl.times, tl.occ, ispec)
    return tl._replace(idx_occ=i_occ, idx_minfree=i_min, idx_maxfree=i_max,
                       ispec=ispec)


def init_state(capacity: int, n_pe: int, pending_capacity: int = 256,
               device: DeviceLike = None, *, park_capacity: int = 0,
               rspec=None, live_units: Optional[Sequence[int]] = None,
               index_tile: Optional[int] = None,
               tenants: Optional[Any] = None) -> SchedulerState:
    """Fresh all-free scheduler state on ``device`` (``None``: cuda).

    ``park_capacity`` sizes the backfilling deferral queue; the default
    0 leaves it out, and no step then does any queue work.
    ``rspec`` (a :class:`~repro_torch.core.resources.ResourceSpec` with
    ``units[0] == n_pe``) switches to the multi-resource layout: the
    occupancy and every reservation mask widen to ``rspec.total_words``
    words, and ``live_units`` optionally shrinks this lane's live units
    per plane (heterogeneous machine sizes).  ``index_tile`` (a power
    of two dividing ``capacity``) attaches the availability index.
    ``tenants`` attaches a :class:`~repro_torch.tenancy.TenantTable`
    sized for these buffers (:func:`~repro_torch.tenancy.init_table`).
    """
    if rspec is not None and rspec.n_pe != n_pe:
        raise ValueError(
            f"rspec.units[0]={rspec.n_pe} must equal n_pe={n_pe}")
    if live_units is not None and rspec is None:
        raise ValueError("live_units requires rspec")
    ispec = None
    if index_tile is not None:
        ispec = idx_lib.make_index_spec(index_tile, n_pe, rspec)
        ispec.n_tiles(capacity)   # validates divisibility
    dev = resolve_device(device)
    W = n_words(n_pe) if rspec is None else rspec.total_words
    lane_valid = None
    if rspec is not None:
        lane_valid = torch.from_numpy(
            rspec.valid_mask_np(live_units)).to(dev)

    def zero():
        return torch.zeros((), dtype=I32, device=dev)

    return SchedulerState(
        tl=empty(capacity, n_pe, dev, words=W, ispec=ispec),
        pend_ts=torch.full((pending_capacity,), T_INF, dtype=I32,
                           device=dev),
        pend_te=torch.full((pending_capacity,), T_INF, dtype=I32,
                           device=dev),
        pend_mask=torch.zeros((pending_capacity, W), dtype=I32,
                              device=dev),
        n_accepted=zero(), n_released=zero(),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
        hw_records=zero(), hw_pending=zero(),
        lane_valid=lane_valid, rspec=rspec, tenants=tenants,
        **_init_queue(park_capacity, W, rspec, dev))


def grow(tl: Timeline, new_capacity: int) -> Timeline:
    """Capacity growth: padding rows never change decisions.  An
    attached index is rebuilt at the new tile count."""
    if new_capacity < tl.capacity:
        raise ValueError(f"cannot shrink {tl.capacity} -> {new_capacity}")
    pad = new_capacity - tl.capacity
    return _reindex(Timeline(
        times=torch.cat([tl.times, torch.full(
            (pad,), T_INF, dtype=I32, device=tl.device)]),
        occ=torch.cat([tl.occ, torch.zeros(
            (pad, tl.words), dtype=I32, device=tl.device)])), tl.ispec)


def grow_state(state: SchedulerState,
               new_capacity: Optional[int] = None,
               new_pending_capacity: Optional[int] = None
               ) -> SchedulerState:
    """Growth of the timeline and/or the pending buffer.

    The deferral queue never grows: a full queue commits delayed
    requests immovably instead, as under ``none``.  A tenant table's
    pending ownership column grows with the buffer (new slots unowned).
    """
    out = state
    if new_capacity is not None:
        out = out._replace(tl=grow(out.tl, new_capacity))
    if new_pending_capacity is not None:
        K = out.pending_capacity
        if new_pending_capacity < K:
            raise ValueError(
                f"cannot shrink pending {K} -> {new_pending_capacity}")
        pad = new_pending_capacity - K
        dev = out.pend_te.device
        fill = torch.full((pad,), T_INF, dtype=I32, device=dev)
        out = out._replace(
            pend_ts=torch.cat([out.pend_ts, fill]),
            pend_te=torch.cat([out.pend_te, fill]),
            pend_mask=torch.cat([out.pend_mask, torch.zeros(
                (pad, out.pend_mask.shape[1]), dtype=I32, device=dev)]))
        if out.tenants is not None:
            out = out._replace(tenants=grow_table(out.tenants,
                                                  new_pending_capacity))
    return out


def ids_to_mask32(pe_ids, words: int, n_pe: Optional[int] = None,
                  device: DeviceLike = "cpu") -> torch.Tensor:
    """PE id sequence -> int32[words] bitmask (host-side ids).

    Ids must be distinct integers in ``[0, n_pe)`` (``[0, words*32)``
    when ``n_pe`` is ``None``).
    """
    limit = words * words_lib.WORD if n_pe is None else int(n_pe)
    bits = np.zeros(words * words_lib.WORD, dtype=np.int64)
    for i in pe_ids:
        idx = int(i)
        if idx != i:
            raise TypeError(f"PE id {i!r} is not an integer")
        if not 0 <= idx < limit:
            raise ValueError(f"PE id {idx} out of range [0, {limit})")
        if bits[idx]:
            raise ValueError(f"duplicate PE id {idx}")
        bits[idx] = 1
    return pack_bits(torch.from_numpy(bits)[None, :])[0].to(
        resolve_device(device))


def occupancy_at(tl: Timeline, t: Scalar) -> torch.Tensor:
    """Busy bitmask in effect at instant ``t`` (zeros outside records)."""
    t = scalar(t, tl.device)
    idx = torch.searchsorted(tl.times, t.reshape(1), right=True)[0] - 1
    row_idx = idx.clamp(0, tl.capacity - 1)
    in_range = (idx >= 0) & (take(tl.times, row_idx) < T_INF)
    return torch.where(in_range, take(tl.occ, row_idx),
                       torch.zeros_like(tl.occ[0]))


def _occupancy_many(tl: Timeline, t: torch.Tensor) -> torch.Tensor:
    """:func:`occupancy_at` for every instant of an int32[N] vector."""
    idx = torch.searchsorted(tl.times, t, right=True) - 1
    row_idx = idx.clamp(0, tl.capacity - 1)
    in_range = (idx >= 0) & (tl.times[row_idx] < T_INF)
    return torch.where(in_range[:, None], tl.occ[row_idx],
                       torch.zeros_like(tl.occ[:1]))


def next_times(tl: Timeline) -> torch.Tensor:
    """End of each slot's interval; the last row gets ``T_INF``."""
    return torch.cat([tl.times[1:], torch.full(
        (1,), T_INF, dtype=I32, device=tl.device)])


def _merge_compact(ext_t: torch.Tensor, ext_o: torch.Tensor, S: int,
                   ispec=None) -> Tuple[Timeline, torch.Tensor, torch.Tensor]:
    """Shared epilogue of every update: merge + scatter-compact, then
    the index of the result (with ``ispec``).

    ``ext_t``/``ext_o`` are the time-sorted extended rows, already
    range-updated.  A row survives when its occupancy differs from its
    predecessor's (duplicates carry identical occupancy after the range
    update).  Survivors scatter to the front; every dropped row writes
    the same sentinel to the one spare index ``R - 1``, so the order of
    duplicate writes never matters.
    """
    R = ext_t.shape[0]
    dev = ext_t.device
    prev = torch.cat([torch.zeros_like(ext_o[:1]), ext_o[:-1]])
    keep = (ext_t < T_INF) & (ext_o != prev).any(dim=1)
    pos = torch.cumsum(keep, dim=0) - 1
    dest = torch.where(keep, pos, R - 1)
    out_t = torch.full((R,), T_INF, dtype=I32, device=dev)
    out_t[dest] = torch.where(keep, ext_t, T_INF)
    out_o = torch.zeros_like(ext_o)
    out_o[dest] = torch.where(keep[:, None], ext_o, 0)
    n_keep = keep.sum().to(I32)
    overflow = n_keep > S
    out = Timeline(times=out_t[:S], occ=out_o[:S].contiguous())
    return _reindex(out, ispec), overflow, n_keep


def _range_update(ext_t, ext_o, t_s, t_e, mask, is_add):
    in_range = (ext_t >= t_s) & (ext_t < t_e)
    upd = ext_o | mask[None, :] if is_add else ext_o & ~mask[None, :]
    return torch.where(in_range[:, None], upd, ext_o)


def _finish(out, overflow, n_keep, with_count):
    if with_count:
        return out, overflow, n_keep
    return out, overflow


def update(tl: Timeline, t_s: Scalar, t_e: Scalar, mask: torch.Tensor,
           *, is_add: bool, with_count: bool = False):
    """``addAllocation`` / ``deleteAllocation`` (Algorithms 1-2).

    Inserts the two boundary records, ORs (or AND-NOTs) ``mask`` into
    every record in ``[t_s, t_e)``, merges redundant records and
    re-compacts into the same capacity.  Returns ``(new_tl, overflow)``
    (plus ``n_keep``, the record count the result needed, with
    ``with_count``).  Sort-free: the two boundaries are placed with
    ``searchsorted`` and a shift-gather; bit-identical to
    :func:`update_lexsort`.
    """
    S, dev = tl.capacity, tl.device
    t_s = scalar(t_s, dev)
    t_e = scalar(t_e, dev)
    # malformed intervals (empty, inverted, or reaching the T_INF
    # sentinel) become the empty [T_INF, T_INF) x 0 update, whose
    # boundary rows the merge pass drops
    valid_iv = (t_s < t_e) & (t_e < T_INF)
    t_s = torch.where(valid_iv, t_s, T_INF)
    t_e = torch.where(valid_iv, t_e, T_INF)
    mask = torch.where(valid_iv, mask, 0)
    # merged positions of the two inserted records: after all
    # originals of equal time, the t_s record before the t_e record
    # when the two coincide (the lexsort oracle's stable tie-break)
    i_s = torch.searchsorted(tl.times, t_s.reshape(1), right=True)[0]
    i_e = torch.searchsorted(tl.times, t_e.reshape(1), right=True)[0]
    pos_s = i_s + (t_e < t_s).to(torch.int64)
    pos_e = i_e + (t_s <= t_e).to(torch.int64)
    idx = torch.arange(S + 2, device=dev)
    src = (idx - (idx > pos_s).to(torch.int64)
           - (idx > pos_e).to(torch.int64)).clamp(0, S - 1)
    ext_t = torch.where(idx == pos_s, t_s,
                        torch.where(idx == pos_e, t_e, tl.times[src]))
    ext_o = torch.where(
        (idx == pos_s)[:, None], occupancy_at(tl, t_s)[None, :],
        torch.where((idx == pos_e)[:, None],
                    occupancy_at(tl, t_e)[None, :], tl.occ[src]))
    ext_o = _range_update(ext_t, ext_o, t_s, t_e, mask, is_add)
    return _finish(*_merge_compact(ext_t, ext_o, S, tl.ispec), with_count)


def update_lexsort(tl: Timeline, t_s: Scalar, t_e: Scalar,
                   mask: torch.Tensor, *, is_add: bool,
                   with_count: bool = False):
    """The sort-based :func:`update`, kept as its oracle.

    Appends the two boundary records and stable-sorts by time, so
    originals precede inserted duplicates and the ``t_s`` record
    precedes the ``t_e`` record.  Not used on any hot path.  Unlike
    :func:`update` it does not clamp malformed intervals; callers pass
    well-formed ones.
    """
    S, dev = tl.capacity, tl.device
    t_s = scalar(t_s, dev)
    t_e = scalar(t_e, dev)
    ext_t = torch.cat([tl.times, torch.stack([t_s, t_e])])
    ext_o = torch.cat([tl.occ, torch.stack(
        [occupancy_at(tl, t_s), occupancy_at(tl, t_e)])])
    perm = torch.sort(ext_t, stable=True).indices
    ext_t, ext_o = ext_t[perm], ext_o[perm]
    ext_o = _range_update(ext_t, ext_o, t_s, t_e, mask, is_add)
    return _finish(*_merge_compact(ext_t, ext_o, S, tl.ispec), with_count)


def update_many(tl: Timeline, t_s: torch.Tensor, t_e: torch.Tensor,
                masks: torch.Tensor, active: torch.Tensor, *,
                is_add: bool, with_count: bool = False):
    """Batched :func:`update`: K same-direction intervals, one merge.

    Applies ``[t_s[k], t_e[k]) x masks[k]`` for every ``active[k]``,
    all adds or all deletes.  Same-direction updates commute and the
    merged timeline is canonical, so one pass equals the K sequential
    updates bit for bit, except that only the end state can overflow.
    """
    S, W, dev = tl.capacity, tl.words, tl.device
    K = t_s.shape[0]
    active = active & (t_s < t_e) & (t_e < T_INF)
    R = S + 2 * K
    # boundary records of every active interval (inactive ones become
    # T_INF rows, which the merge drops); inserted records go after
    # originals of equal time, ties among them break by position
    b_t = torch.where(torch.cat([active, active]),
                      torch.cat([t_s, t_e]), T_INF)
    base = torch.searchsorted(tl.times, b_t, right=True)
    order = torch.arange(2 * K, device=dev)
    lt = b_t[None, :] < b_t[:, None]
    tie = (b_t[None, :] == b_t[:, None]) & (order[None, :] < order[:, None])
    pos_b = base + (lt | tie).sum(dim=1)
    # originals shift right past every boundary strictly below them
    pos_o = torch.arange(S, device=dev) + (
        b_t[None, :] < tl.times[:, None]).sum(dim=1)
    ext_t = torch.zeros((R,), dtype=I32, device=dev)
    ext_t[pos_o] = tl.times
    ext_t[pos_b] = b_t
    ext_o = torch.zeros((R, W), dtype=I32, device=dev)
    ext_o[pos_o] = tl.occ
    ext_o[pos_b] = _occupancy_many(tl, b_t)
    # OR (add) / AND-NOT (delete) of every active interval covering
    # each record's instant
    cover = (active[None, :] & (t_s[None, :] <= ext_t[:, None])
             & (ext_t[:, None] < t_e[None, :]))               # [R, K]
    union = words_lib.or_reduce(
        torch.where(cover[:, :, None], masks[None, :, :], 0), dim=1)
    ext_o = ext_o | union if is_add else ext_o & ~union
    return _finish(*_merge_compact(ext_t, ext_o, S, tl.ispec), with_count)


def window_busy(tl: Timeline, a: Scalar, b: Scalar) -> torch.Tensor:
    """Union of busy masks over records intersecting ``[a, b)``."""
    ov = (tl.times < b) & (next_times(tl) > a)
    return words_lib.or_reduce(torch.where(ov[:, None], tl.occ, 0), dim=0)


def from_host(times: np.ndarray, occ64: np.ndarray, n_pe: int,
              capacity: int, device: DeviceLike = None,
              ispec=None) -> Timeline:
    """Timeline from the host engine's sorted records (uint64 rows);
    ``ispec`` builds its availability index."""
    S = times.shape[0]
    if S > capacity:
        raise ValueError(
            f"host timeline has {S} records, capacity is {capacity}")
    W = n_words(n_pe)
    occ32 = np.ascontiguousarray(occ64, dtype="<u8").view("<u4")[:, :W]
    rows = np.zeros((capacity, W), dtype=np.uint32)
    rows[:S, :occ32.shape[1]] = occ32
    t = np.full(capacity, T_INF, dtype=np.int32)
    t[:S] = times
    dev = resolve_device(device)
    return _reindex(Timeline(
        times=torch.from_numpy(t).to(dev),
        occ=torch.from_numpy(words_lib.to_int32(rows)).to(dev)), ispec)


_SCALARS = ("n_accepted", "n_released", "hw_records", "hw_pending")


def state_to_numpy(state: SchedulerState) -> Dict[str, np.ndarray]:
    """Field-by-field numpy arrays under the reference's field names.

    Occupancy and masks come back as ``uint32`` like the reference's
    ``SchedulerState``; scalars as 0-d arrays.  Multi-resource states
    add ``lane_valid`` (uint32), indexed ones the three summaries
    (``idx_occ`` as uint32), tenanted ones ``tenants``: a dict of the
    table's 17 fields under their names.
    """
    out = {
        "times": state.tl.times.cpu().numpy(),
        "occ": words_lib.to_uint32(state.tl.occ.cpu().numpy()),
        "pend_ts": state.pend_ts.cpu().numpy(),
        "pend_te": state.pend_te.cpu().numpy(),
        "pend_mask": words_lib.to_uint32(state.pend_mask.cpu().numpy()),
        "overflow": np.asarray(state.overflow.cpu().numpy(), bool),
    }
    for f in _SCALARS:
        out[f] = np.asarray(getattr(state, f).cpu().numpy(), np.int32)
    if state.lane_valid is not None:
        out["lane_valid"] = words_lib.to_uint32(
            state.lane_valid.cpu().numpy())
    tl = state.tl
    if tl.ispec is not None:
        out["idx_occ"] = words_lib.to_uint32(tl.idx_occ.cpu().numpy())
        out["idx_minfree"] = tl.idx_minfree.cpu().numpy()
        out["idx_maxfree"] = tl.idx_maxfree.cpu().numpy()
    for f in PARK_FIELDS:
        x = getattr(state, f)
        if x is not None:
            a = x.cpu().numpy()
            out[f] = (words_lib.to_uint32(a) if f == "park_mask"
                      else np.asarray(a, bool if f == "park_retry"
                                      else np.int32))
    if state.tenants is not None:
        out["tenants"] = {f: getattr(state.tenants, f).cpu().numpy()
                          for f in state.tenants._fields}
    return out


def state_from_numpy(arrays: Dict[str, np.ndarray], *,
                     device: DeviceLike = None,
                     rspec=None, ispec=None) -> SchedulerState:
    """Inverse of :func:`state_to_numpy`.

    Takes the arrays of a reference ``SchedulerState`` (``times``,
    ``occ`` as uint32, ``pend_ts``, ``pend_te``, ``pend_mask``, the
    counters, ``overflow`` and the ``hw_*`` marks), so a half-run
    state can cross from the JAX package to the port.  A multi-resource
    state also needs ``lane_valid`` and its ``rspec``; an indexed one
    ``idx_occ`` (uint32), ``idx_minfree``, ``idx_maxfree`` and its
    ``ispec`` (an :class:`~repro_torch.core.availindex.IndexSpec`).
    The deferral queue comes with its ``park_*`` arrays and counters
    (a queue of 0 entries, as the reference's states without one carry,
    is left out), and a tenant table with ``tenants`` (a dict of its
    fields under their names).
    """
    if (rspec is None) != (arrays.get("lane_valid") is None):
        raise ValueError("a multi-resource state needs both rspec and "
                         "lane_valid; a plain one neither")
    if (ispec is None) != (arrays.get("idx_occ") is None):
        raise ValueError("an indexed state needs both ispec and the "
                         "idx_* summaries; a plain one neither")
    dev = resolve_device(device)

    def i32(name):
        return torch.from_numpy(np.array(
            arrays[name], dtype=np.int32)).to(dev)

    def words(name):
        return torch.from_numpy(
            words_lib.to_int32(np.asarray(arrays[name]))).to(dev)

    tl = Timeline(times=i32("times"), occ=words("occ"))
    if ispec is not None:
        tl = tl._replace(idx_occ=words("idx_occ"),
                         idx_minfree=i32("idx_minfree"),
                         idx_maxfree=i32("idx_maxfree"), ispec=ispec)
    queue = {}
    if np.asarray(arrays.get("park_seq", ())).size:
        for f in PARK_FIELDS:
            if f == "park_mask":
                queue[f] = words(f)
            elif f == "park_retry":
                queue[f] = torch.from_numpy(
                    np.array(arrays[f], dtype=bool)).to(dev)
            elif arrays.get(f) is not None:
                queue[f] = i32(f)
    tenants = None
    if arrays.get("tenants") is not None:
        tn = arrays["tenants"]
        tenants = TenantTable(**{
            f: torch.from_numpy(np.array(tn[f], dtype=np.float32 if f in
                                         FLOAT_FIELDS else np.int32)).to(dev)
            for f in TenantTable._fields})
    return SchedulerState(
        tl=tl, tenants=tenants,
        pend_ts=i32("pend_ts"), pend_te=i32("pend_te"),
        pend_mask=words("pend_mask"),
        overflow=torch.from_numpy(
            np.array(arrays["overflow"], dtype=bool)).to(dev),
        lane_valid=None if rspec is None else words("lane_valid"),
        rspec=rspec,
        **{f: i32(f).reshape(()) for f in _SCALARS}, **queue)


def ensemble_to_numpy(states: Sequence[SchedulerState]) -> Dict[str, Any]:
    """Lane states -> the reference's stacked ``[E, ...]`` arrays.

    :func:`state_to_numpy` of every lane, stacked on a leading lane
    axis (the tenant table's fields too), as the reference lays out an
    ensemble's ``SchedulerState``.
    """
    lanes = [state_to_numpy(s) for s in states]
    out: Dict[str, Any] = {}
    for k in lanes[0]:
        if k == "tenants":
            out[k] = {f: np.stack([a[k][f] for a in lanes])
                      for f in lanes[0][k]}
        else:
            out[k] = np.stack([a[k] for a in lanes])
    return out


def ensemble_from_numpy(arrays: Dict[str, Any], *, device: DeviceLike = None,
                        rspec=None, ispec=None
                        ) -> Tuple[SchedulerState, ...]:
    """Inverse of :func:`ensemble_to_numpy`: split the arrays of a
    reference ensemble (every leaf with a leading lane axis, its stacked
    tenant table too) into one-lane states, so a half-run reference
    ensemble can cross to the port."""
    E = np.asarray(arrays["times"]).shape[0]

    def lane(e):
        out = {}
        for k, v in arrays.items():
            if v is None:
                out[k] = None
            elif k == "tenants":
                out[k] = {f: np.asarray(x)[e] for f, x in v.items()}
            else:
                out[k] = np.asarray(v)[e]
        return out

    return tuple(state_from_numpy(lane(e), device=device, rspec=rspec,
                                  ispec=ispec) for e in range(E))
