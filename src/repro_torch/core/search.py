"""``findAllocation`` (Algorithm 3) over the dense timeline.

Candidates -> maximum availability rectangles -> policy selection ->
lowest-index PE pick.  With ``use_kernel`` the rectangles and the
selection run fused in the ``availscan_select`` kernel
(:mod:`repro_torch.kernels.ops`); without it they run as plain tensor
code on the timeline's device.  Request fields are host integers; the
results stay on the device.

Multi-resource timelines (``rspec`` set) switch to the vector fit: a
candidate is feasible iff plane 0 fits ``n_req`` and every secondary
plane fits its ``demand_tail`` entry; the policies keep scoring plane
0's free count, and the winning mask takes units on every plane.
``valid_mask`` (the lane's live units, default the spec's full layout)
carries heterogeneous machine sizes.

An indexed timeline (``tl.ispec`` set) adds two conservative fast
paths from :mod:`repro_torch.core.availindex`: :func:`summary_reject`
proves a whole request infeasible, and the search then reports the
rejected result without enumerating candidates (the result is one
kernel call, and its fields are views of that call's output row);
:func:`prune_candidates` masks provably infeasible candidates to
``T_INF`` on the kernel path.  Neither changes
a decision.  The reject predicate is a device value the host must read
to branch on; the admit step reads it together with the release
check's last flag (:mod:`repro_torch.core.batch`), other callers pay
one read here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import availindex as idx_lib
from repro_torch.core import policies as policies_lib
from repro_torch.core import resources as res_lib
from repro_torch.core import timeline as tl_lib
from repro_torch.core import words as words_lib
from repro_torch.core.timeline import Timeline, take
from repro_torch.core.types import T_INF
from repro_torch.kernels import ref as kernel_ref


class SearchResult(NamedTuple):
    found: torch.Tensor    # bool
    t_s: torch.Tensor      # int32 chosen start
    t_e: torch.Tensor      # int32 chosen end
    pe_mask: torch.Tensor  # int32[W] chosen PEs
    n_free: torch.Tensor   # int32 free PEs in the winning rectangle
    t_begin: torch.Tensor  # int32 rectangle begin
    t_end: torch.Tensor    # int32 rectangle end


class Rectangles(NamedTuple):
    """Per-candidate maximum availability rectangles."""

    starts: torch.Tensor   # int32[P]
    n_free: torch.Tensor   # int32[P]
    t_begin: torch.Tensor  # int32[P]
    t_end: torch.Tensor    # int32[P]
    valid: torch.Tensor    # bool[P]
    # int32[P, R-1] free units of planes 1..R-1 (multi-resource only)
    n_free_tail: Optional[torch.Tensor] = None


def candidate_starts(tl: Timeline, t_r: int, t_du: int,
                     t_dl: int) -> torch.Tensor:
    """int32[2S+2] candidates; out-of-window slots padded with T_INF.

    The ready time, the latest start, every boundary in range and every
    boundary shifted left by the duration (end-aligned placements): the
    paper's Section 4.2 enumeration.  Sorted, deduplicated and
    compacted: distinct live candidates ascend at the front, all
    duplicates and out-of-window slots collapse into the ``T_INF``
    tail (duplicates share their first occurrence's rectangle and
    score, so dropping them never changes the selected start).
    """
    lo, hi = int(t_r), int(t_dl) - int(t_du)
    times = tl.times

    def in_range(x):
        return (x >= lo) & (x <= hi) & (x < T_INF)

    c_bound = torch.where(in_range(times), times, T_INF)
    shifted = torch.where(times < T_INF, times - int(t_du), T_INF)
    c_shift = torch.where(in_range(shifted), shifted, T_INF)
    # filled on the device: a copy from host memory would stall the host
    ends = torch.full((2,), lo, dtype=torch.int32, device=tl.device)
    ends[1] = hi
    cand = torch.sort(torch.cat([ends, c_bound, c_shift])).values
    P = cand.shape[0]
    first = torch.ones((1,), dtype=torch.bool, device=tl.device)
    keep = (cand < T_INF) & torch.cat([first, cand[1:] != cand[:-1]])
    dest = torch.where(keep, torch.cumsum(keep, dim=0) - 1, P)
    out = torch.full((P + 1,), T_INF, dtype=torch.int32, device=tl.device)
    out[dest] = torch.where(keep, cand, T_INF)
    return out[:P]


def availability_rectangles(tl: Timeline, starts: torch.Tensor, t_du: int,
                            t_now: int, n_pe: int, *, rspec=None,
                            valid_mask: Optional[torch.Tensor] = None
                            ) -> Rectangles:
    """Maximum availability rectangle per candidate (Algorithm 3 l.6-9).

    Plain tensor code on the packed words, on the timeline's device.
    Invalid candidates (``T_INF`` padding) get ``n_free = t_begin =
    t_end = 0``; they are never feasible, and the all-infeasible
    fallback index 0 is always a live candidate.  With ``rspec`` the
    free words are masked with ``valid_mask`` and counted per plane:
    ``n_free`` is plane 0's count, ``n_free_tail`` the others'.
    """
    if rspec is None:
        n_free, t_begin, t_end = kernel_ref.availscan_ref(
            tl.times, tl.occ, starts, int(t_du), int(t_now), n_pe)
        tail = None
    else:
        lay = res_lib.device_layout(rspec, tl.device)
        n_free, tail, t_begin, t_end = kernel_ref.availscan_mr_ref(
            tl.times, tl.occ, starts,
            lay.valid_mask if valid_mask is None else valid_mask,
            lay.plane_of_word, rspec.R, int(t_du), int(t_now))
    return Rectangles(starts=starts, n_free=n_free, t_begin=t_begin,
                      t_end=t_end, valid=starts < T_INF, n_free_tail=tail)


def _winning_pe_mask(tl: Timeline, t_s: torch.Tensor, t_du: int,
                     n_req: int, n_pe: int) -> torch.Tensor:
    """Lowest-index ``n_req`` free PEs over the winning window."""
    a = t_s.clamp(max=T_INF - int(t_du))
    busy = tl_lib.window_busy(tl, a, a + int(t_du))            # int32[W]
    free_bits = 1 - words_lib.unpack_bits(busy[None, :], n_pe)[0].to(
        torch.int32)                                            # [n_pe]
    sel = (free_bits == 1) & (torch.cumsum(free_bits, dim=0) <= int(n_req))
    padded = torch.zeros((tl.words * words_lib.WORD,), dtype=torch.int32,
                         device=tl.device)
    padded[:n_pe] = sel.to(torch.int32)
    return words_lib.pack_bits(padded[None, :])[0]


def _winning_mask_mr(tl: Timeline, t_s: torch.Tensor, t_du: int,
                     n_req: int, demand_tail: torch.Tensor, rspec,
                     valid_mask: torch.Tensor) -> torch.Tensor:
    """Lowest-index free valid units of each plane over the window.

    Plane 0 takes ``n_req`` units, plane ``r`` ``demand_tail[r - 1]``,
    each in its own bit range.  One cumulative sum over all bits, less
    its value before each plane's first bit, walks every plane at once;
    plane 0 matches :func:`_winning_pe_mask` bit for bit on a
    full-width lane (invalid bits are never free).
    """
    lay = res_lib.device_layout(rspec, tl.device)
    a = t_s.clamp(max=T_INF - int(t_du))
    busy = tl_lib.window_busy(tl, a, a + int(t_du))
    free_bits = words_lib.unpack_bits(
        (~busy & valid_mask)[None, :], rspec.total_bits)[0].to(torch.int64)
    before = torch.cumsum(free_bits, dim=0) - free_bits  # exclusive
    rank = before - before[lay.plane_start]               # within plane
    need = torch.cat([torch.full((1,), int(n_req), dtype=torch.int64,
                                 device=tl.device),
                      demand_tail.to(torch.int64)])
    sel = (free_bits == 1) & (rank < need[lay.plane_of_bit])
    return words_lib.pack_bits(sel.to(torch.int32)[None, :])[0]


def _index_demand(ispec, n_req: int, demand_tail: Optional[torch.Tensor],
                  device: torch.device) -> torch.Tensor:
    """int32[R]: the request's demand on every plane, for the bounds."""
    head = torch.full((1,), int(n_req), dtype=torch.int32, device=device)
    if ispec.R == 1:
        return head
    if demand_tail is None:
        return torch.cat([head, torch.zeros((ispec.R - 1,),
                                            dtype=torch.int32,
                                            device=device)])
    return torch.cat([head, demand_tail.to(torch.int32)])


def summary_reject(tl: Timeline, t_r: int, t_du: int, t_dl: int,
                   demand: torch.Tensor, deficit: torch.Tensor
                   ) -> torch.Tensor:
    """Conservative proof that no window ``[s, s + t_du)`` with ``s`` in
    ``[t_r, t_dl - t_du]`` is feasible (a 0-d bool on the device).

    Two proofs: some plane demands more units than the lane has; or,
    with ``t_r >= times[0]`` (every window start then lies inside some
    record's interval), every tile intersecting ``[t_r, t_dl)`` has a
    plane whose ``maxfree - deficit`` is below the demand, since a
    window's free count never exceeds a covering row's.  An empty
    timeline, or a window reaching past the last record (whose all-free
    row summarises to ``maxfree == units``), never rejects.
    """
    ispec = tl.ispec
    S, T = tl.capacity, ispec.tile
    NT = S // T
    units = idx_lib.units_on(ispec, tl.device)
    lo, hi, dl = int(t_r), int(t_dl) - int(t_du), int(t_dl)
    cap_reject = (demand > units - deficit).any()
    if hi < lo:
        return cap_reject
    tile_t0 = tl.times.reshape(NT, T)[:, 0]
    tile_end = torch.cat([tile_t0[1:], tile_t0.new_full((1,), T_INF)])
    intersect = (tile_t0 < dl) & (tile_end > lo)
    bad = (tl.idx_maxfree - deficit[None, :] < demand[None, :]).any(dim=1)
    tile_reject = ((tl.times[0] <= lo) & intersect.any()
                   & (~intersect | bad).all())
    return cap_reject | tile_reject


def prune_candidates(tl: Timeline, starts: torch.Tensor, t_du: int,
                     demand: torch.Tensor, deficit: torch.Tensor
                     ) -> torch.Tensor:
    """Mask summary-infeasible candidates to the ``T_INF`` sentinel.

    A window that fully contains tile ``k`` has at most
    ``idx_minfree[k] - deficit`` free units per plane; if that is below
    the demand on some plane for any contained tile, the candidate is
    truly infeasible and could never win.  Candidate 0 (the one the
    rejected result reports when nothing is feasible) is never pruned.
    """
    ispec = tl.ispec
    S, T = tl.capacity, ispec.tile
    NT = S // T
    a = starts.clamp(max=T_INF - int(t_du))
    b = a + int(t_du)
    tile_last = tl.times.reshape(NT, T)[:, -1]
    tile_nxt0 = tl_lib.next_times(tl).reshape(NT, T)[:, 0]
    contained = ((tile_last[None, :] < b[:, None])
                 & (tile_nxt0[None, :] > a[:, None]))             # [P, NT]
    bad = (tl.idx_minfree - deficit[None, :] < demand[None, :]).any(dim=1)
    prune = (contained & bad[None, :]).any(dim=1)
    prune[0] = False
    return torch.where(prune, T_INF, starts)


def _index_args(tl: Timeline, n_req: int, rspec,
                demand_tail: Optional[torch.Tensor],
                valid_mask: Optional[torch.Tensor]):
    """The index bounds' demand vector and per-plane deficit."""
    demand = _index_demand(tl.ispec, n_req, demand_tail, tl.device)
    deficit = idx_lib.plane_deficit(
        tl.ispec, valid_mask if rspec is not None else None, tl.device)
    return demand, deficit


def index_reject(tl: Timeline, t_r: int, t_du: int, t_dl: int, n_req: int,
                 *, rspec=None, demand_tail: Optional[torch.Tensor] = None,
                 valid_mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """:func:`summary_reject` of a request on an indexed timeline (a
    0-d bool on the device, not read here)."""
    if rspec is not None and valid_mask is None:
        valid_mask = res_lib.device_layout(rspec, tl.device).valid_mask
    demand, deficit = _index_args(tl, n_req, rspec, demand_tail, valid_mask)
    return summary_reject(tl, t_r, t_du, t_dl, demand, deficit)


def _rejected(tl: Timeline, t_r: int, t_du: int, t_dl: int, t_now: int,
              n_pe: int, rspec, valid_mask) -> SearchResult:
    """The result of a search over an all-infeasible candidate set.

    Selection then names index 0, whose start is the smallest live
    candidate ``min(t_r, t_dl - t_du)``; its rectangle and the whole
    result are one kernel launch at that start
    (:func:`repro_torch.kernels.ops.window_rectangle`), and every field
    is a view of the kernel's output row.
    """
    from repro_torch.kernels import ops as kernel_ops
    s0 = min(int(t_r), int(t_dl) - int(t_du))
    w = kernel_ops.window_rectangle(tl, s0, t_du, t_now, n_pe, rspec=rspec,
                                    valid_mask=valid_mask)
    return SearchResult(found=w["found"], t_s=w["t_s"], t_e=w["t_e"],
                        pe_mask=w["pe_mask"], n_free=w["n_free"],
                        t_begin=w["t_begin"], t_end=w["t_end"])


def search(tl: Timeline, t_r: int, t_du: int, t_dl: int, n_req: int,
           policy_id: int, t_now: int, *, n_pe: int,
           use_kernel: bool = True, rspec=None,
           demand_tail: Optional[torch.Tensor] = None,
           valid_mask: Optional[torch.Tensor] = None,
           reject: Optional[bool] = None, stats=None) -> SearchResult:
    """Full Algorithm 3: candidates -> rectangles -> policy -> PE pick.

    With ``rspec``, ``demand_tail`` (int32[R-1] on the timeline's
    device, default zeros) and ``valid_mask`` (int32[W], default every
    unit live) feed the vector fit.  On an indexed timeline ``reject``
    is the caller's host reading of :func:`index_reject` for this
    request; ``None`` computes and reads it here (one host sync,
    counted in ``stats``, a :class:`~repro_torch.core.batch.StreamStats`).
    """
    if rspec is not None:
        lay = res_lib.device_layout(rspec, tl.device)
        valid_mask = lay.valid_mask if valid_mask is None else valid_mask
        demand_tail = lay.zero_tail if demand_tail is None else demand_tail
    if tl.ispec is not None:
        if reject is None:
            reject = bool(index_reject(
                tl, t_r, t_du, t_dl, n_req, rspec=rspec,
                demand_tail=demand_tail, valid_mask=valid_mask))
            if stats is not None:
                stats.sync()
        if reject:
            return _rejected(tl, t_r, t_du, t_dl, t_now, n_pe, rspec,
                             valid_mask)
    starts = candidate_starts(tl, t_r, t_du, t_dl)
    if tl.ispec is not None and use_kernel:
        # pruned starts become T_INF holes the kernels skip; the plain
        # path scores every slot anyway, so it is left unpruned
        pruned = prune_candidates(tl, starts, t_du, *_index_args(
            tl, n_req, rspec, demand_tail, valid_mask))
        if stats is not None and stats.count_candidates:
            live = torch.stack([(starts < T_INF).sum(),
                                (pruned == T_INF).sum()
                                - (starts == T_INF).sum()])
            stats.candidates = live if stats.candidates is None \
                else stats.candidates + live
        starts = pruned
    if use_kernel:
        from repro_torch.kernels import ops as kernel_ops
        # fused rectangles + selection: the per-candidate vectors never
        # leave the kernel
        sel = kernel_ops.search_select(
            tl, starts, t_du, t_now, n_req, policy_id, n_pe, rspec=rspec,
            demand_tail=demand_tail, valid_mask=valid_mask)
        found = sel["found"]
        # best is INT32_MAX only with no live candidate, which never
        # happens (the ready time is always a candidate)
        best = sel["best"].clamp(max=starts.shape[0] - 1)
        n_free, t_begin, t_end = sel["n_free"], sel["t_begin"], sel["t_end"]
    else:
        rects = availability_rectangles(tl, starts, t_du, t_now, n_pe,
                                        rspec=rspec, valid_mask=valid_mask)
        feasible = rects.valid & (rects.n_free >= int(n_req))
        if rspec is not None and rspec.R > 1:
            feasible = feasible & (
                rects.n_free_tail >= demand_tail[None, :]).all(dim=1)
        best, found = policies_lib.select(
            policy_id, rects.n_free, rects.t_end - rects.t_begin,
            rects.starts, feasible)
        n_free = take(rects.n_free, best)
        t_begin = take(rects.t_begin, best)
        t_end = take(rects.t_end, best)
    t_s = take(starts, best)
    if rspec is None:
        pe_mask = _winning_pe_mask(tl, t_s, t_du, n_req, n_pe)
    else:
        pe_mask = _winning_mask_mr(tl, t_s, t_du, n_req, demand_tail,
                                   rspec, valid_mask)
    return SearchResult(
        found=found, t_s=t_s, t_e=t_s + int(t_du),
        pe_mask=torch.where(found, pe_mask, 0),
        n_free=n_free, t_begin=t_begin, t_end=t_end)


find_allocation = search


def replacement_search(tl: Timeline, t_r: int, t_du: int, t_dl: int,
                       n_req: int, policy_id: int, t_now: int, *, n_pe: int,
                       use_kernel: bool = True, rspec=None,
                       demand_tail: Optional[torch.Tensor] = None,
                       valid_mask: Optional[torch.Tensor] = None,
                       reject: Optional[bool] = None,
                       stats=None) -> SearchResult:
    """The backfill feasibility check: re-place a parked reservation.

    :func:`search` with the window clamped to what is still reachable:
    candidates start at ``max(t_r, t_now)``, so a deferral-queue entry
    is only re-placed at a start it could really make.  A live parked
    reservation satisfies ``t_now < t_s <= t_dl - t_du``, so the clamped
    window is never empty.  Used by the EASY retry sweep and the
    displacement transaction (:mod:`repro_torch.core.batch`).
    """
    return search(tl, max(int(t_r), int(t_now)), t_du, t_dl, n_req,
                  policy_id, t_now, n_pe=n_pe, use_kernel=use_kernel,
                  rspec=rspec, demand_tail=demand_tail,
                  valid_mask=valid_mask, reject=reject, stats=stats)
