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
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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


def search(tl: Timeline, t_r: int, t_du: int, t_dl: int, n_req: int,
           policy_id: int, t_now: int, *, n_pe: int,
           use_kernel: bool = True, rspec=None,
           demand_tail: Optional[torch.Tensor] = None,
           valid_mask: Optional[torch.Tensor] = None) -> SearchResult:
    """Full Algorithm 3: candidates -> rectangles -> policy -> PE pick.

    With ``rspec``, ``demand_tail`` (int32[R-1] on the timeline's
    device, default zeros) and ``valid_mask`` (int32[W], default every
    unit live) feed the vector fit.
    """
    if rspec is not None:
        lay = res_lib.device_layout(rspec, tl.device)
        valid_mask = lay.valid_mask if valid_mask is None else valid_mask
        demand_tail = lay.zero_tail if demand_tail is None else demand_tail
    starts = candidate_starts(tl, t_r, t_du, t_dl)
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
