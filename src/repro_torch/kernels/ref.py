"""Plain PyTorch versions of the availability-scan kernels.

Each function computes exactly what its CUDA kernel in
``csrc/availscan.cu`` computes, on any device: the four of the TPU
kernels, and the one-window rows of the early reject
(:func:`availscan_one_ref`, :func:`availscan_one_mr_ref`).  The wrappers in
:mod:`repro_torch.kernels.ops` take these for tensors on the CPU; on
the card they serve only as the yardstick the kernels are held to.

Both work on the packed int32 occupancy words (bitwise OR / AND plus
popcount), the form :func:`repro.core.search.availability_rectangles`
uses in the reference, rather than the bit-expanded matrix products
of the TPU kernels.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import policies as policies_lib
from repro_torch.core import words as words_lib
from repro_torch.core.types import T_INF

BIG = policies_lib.BIG
# bound on the [P, S, W] intermediates of one candidate chunk (int32
# elements): S = 4096 records of 64 words takes 64 candidates a chunk
_CHUNK_ELEMS = 1 << 24


def _scan(times, nxt, occ, starts, t_du, t_now, count):
    """Rectangles of one candidate chunk.

    ``count(busy) -> (free, counts)`` turns the busy union into the
    free words the blocking test uses and the per-candidate counts
    (one column per count) returned first.
    """
    a = starts.clamp(max=T_INF - t_du)       # no int32 overflow in a + t_du
    b = a + t_du
    # window overlap and busy-unit union
    ov = (times[None, :] < b[:, None]) & (nxt[None, :] > a[:, None])
    busy = words_lib.or_reduce(
        torch.where(ov[:, :, None], occ[None, :, :], 0), dim=1)  # [P, W]
    free, counts = count(busy)
    # a slot blocks the rectangle iff it occupies a unit free in the window
    blocking = (free[:, None, :] & occ[None, :, :]).ne(0).any(dim=2)
    left = blocking & (nxt[None, :] <= a[:, None])
    t_begin = torch.where(left, nxt[None, :], -T_INF).amax(dim=1)
    t_begin = torch.minimum(t_begin.clamp(min=t_now), a)
    right = blocking & (times[None, :] >= b[:, None])
    t_end = torch.where(right, times[None, :], T_INF).amin(dim=1)
    return counts, t_begin, t_end


def _rects(times, occ, starts, t_du, t_now, count, n_counts):
    """Chunked :func:`_scan` over every candidate; dead ones get zeros."""
    nxt = torch.cat([times[1:], times.new_full((1,), T_INF)])
    S, W = occ.shape
    chunk = max(1, _CHUNK_ELEMS // max(1, S * W))
    parts = [_scan(times, nxt, occ, starts[i:i + chunk], t_du, t_now, count)
             for i in range(0, starts.shape[0], chunk)]
    if not parts:
        return (starts.new_zeros((0, n_counts)), starts.new_zeros((0,)),
                starts.new_zeros((0,)))
    counts, t_begin, t_end = (torch.cat(p) for p in zip(*parts))
    live = starts < T_INF
    return (torch.where(live[:, None], counts, 0),
            torch.where(live, t_begin, 0), torch.where(live, t_end, 0))


def availscan_ref(times: torch.Tensor, occ: torch.Tensor,
                  starts: torch.Tensor, t_du: int, t_now: int, n_pe: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Maximum availability rectangle of each candidate start.

    Returns int32 ``(n_free, t_begin, t_end)``, one entry per start.
    For candidate window ``[a, a + t_du)`` (``a`` = the start, clamped
    so the end stays at most ``T_INF``): ``n_free`` counts the PEs free
    over every overlapping record; ``t_begin`` is the end of the latest
    record before ``a`` that occupies one of those PEs, clamped to
    ``[t_now, a]``; ``t_end`` is the start of the earliest such record
    at or after the window's end (``T_INF`` if none).  Dead candidates
    (``T_INF`` padding) get zeros.
    """
    def count(busy):
        # occupancy never sets bits past n_pe, so the busy popcount
        # counts real PEs only
        n_free = n_pe - words_lib.popcount(busy).sum(dim=1, keepdim=True)
        return ~busy, n_free.to(torch.int32)

    n_free, t_begin, t_end = _rects(times, occ, starts, t_du, t_now, count, 1)
    return n_free[:, 0], t_begin, t_end


def availscan_mr_ref(times: torch.Tensor, occ: torch.Tensor,
                     starts: torch.Tensor, valid_mask: torch.Tensor,
                     plane_of_word: torch.Tensor, n_planes: int, t_du: int,
                     t_now: int) -> Tuple[torch.Tensor, ...]:
    """Multi-resource :func:`availscan_ref`.

    The free words are ``~busy & valid_mask``, so padding and dead
    units are never free and never block; the free units are counted
    per plane (``plane_of_word[w]`` is word ``w``'s plane).  Returns
    int32 ``(n_free[P], n_free_tail[P, R-1], t_begin[P], t_end[P])``:
    plane 0's count, the other planes' counts, and the rectangle
    bounds as in :func:`availscan_ref`.  Dead candidates get zeros.
    """
    idx = plane_of_word.to(torch.int64)

    def count(busy):
        free = ~busy & valid_mask[None, :]
        pop = words_lib.popcount(free)
        planes = torch.zeros((busy.shape[0], n_planes), dtype=torch.int32,
                             device=busy.device).index_add_(1, idx, pop)
        return free, planes

    planes, t_begin, t_end = _rects(times, occ, starts, t_du, t_now, count,
                                    n_planes)
    return planes[:, 0], planes[:, 1:], t_begin, t_end


def _one_row(s: int, t_du: int, W: int, rects) -> torch.Tensor:
    """The one-window row: the rectangle's fields (n_free, t_begin,
    t_end, the tail on multi-resource), then t_s = s, t_e = s + t_du
    wrapped to int32 as the reference adds, found = 0 and W words of
    PE mask (0)."""
    head = torch.cat([x.reshape(-1) for x in rects])
    t_e = (s + t_du + 2**31) % 2**32 - 2**31
    rest = torch.tensor([s, t_e, 0] + [0] * W, dtype=torch.int32,
                        device=head.device)
    return torch.cat([head, rest])


def availscan_one_ref(times: torch.Tensor, occ: torch.Tensor, s: int,
                      t_du: int, t_now: int, n_pe: int) -> torch.Tensor:
    """:func:`availscan_ref` of the one start ``s`` (a host integer) as
    the early reject's int32[6 + W] row: ``n_free, t_begin, t_end, t_s,
    t_e, found`` (0), then the empty PE mask."""
    starts = torch.tensor([s], dtype=torch.int32, device=times.device)
    n_free, t_begin, t_end = availscan_ref(times, occ, starts, t_du, t_now,
                                           n_pe)
    return _one_row(s, t_du, occ.shape[1], (n_free, t_begin, t_end))


def availscan_one_mr_ref(times: torch.Tensor, occ: torch.Tensor, s: int,
                         valid_mask: torch.Tensor,
                         plane_of_word: torch.Tensor, n_planes: int,
                         t_du: int, t_now: int) -> torch.Tensor:
    """Multi-resource :func:`availscan_one_ref`: int32[R + 5 + W], the
    other planes' counts (R - 1) right after ``t_end``."""
    starts = torch.tensor([s], dtype=torch.int32, device=times.device)
    n_free, tail, t_begin, t_end = availscan_mr_ref(
        times, occ, starts, valid_mask, plane_of_word, n_planes, t_du, t_now)
    return _one_row(s, t_du, occ.shape[1], (n_free, t_begin, t_end, tail))


def select_row(starts: torch.Tensor, n_free: torch.Tensor,
               t_begin: torch.Tensor, t_end: torch.Tensor,
               feasible: torch.Tensor, policy_id: int) -> torch.Tensor:
    """The select kernels' epilogue: the int32[8] row of the
    lexicographic ``(key1, key2, start_key, index)`` winner among live
    candidates, given their rectangles and feasibility."""
    live = starts < T_INF
    key1, key2 = policies_lib.integer_keys(policy_id, n_free,
                                           t_end - t_begin)
    key1 = torch.where(feasible, key1, BIG)
    key2 = torch.where(feasible, key2, BIG)
    start_key = torch.where(feasible, starts, BIG)
    idx = torch.arange(starts.shape[0], dtype=torch.int32,
                       device=starts.device)
    m1 = torch.where(live, key1, BIG).min()
    e1 = live & (key1 == m1)
    m2 = torch.where(e1, key2, BIG).min()
    e2 = e1 & (key2 == m2)
    m3 = torch.where(e2, start_key, BIG).min()
    e3 = e2 & (start_key == m3)
    m4 = torch.where(e3, idx, BIG).min()
    win = e3 & (idx == m4)

    def pick(v):
        return torch.where(win, v, 0).sum().to(torch.int32)

    return torch.stack([m1, m2, m3, m4, pick(n_free), pick(t_begin),
                        pick(t_end), pick(feasible.to(torch.int32))])


def availscan_select_ref(times: torch.Tensor, occ: torch.Tensor,
                         starts: torch.Tensor, t_du: int, t_now: int,
                         n_req: int, policy_id: int, n_pe: int
                         ) -> torch.Tensor:
    """Fused scan + policy selection: one int32[8] result row.

    Row layout: ``key1, key2, start_key, best_index, n_free, t_begin,
    t_end, feasible`` of the winner, the lexicographic minimum of
    ``(key1, key2, start_key, index)`` over live candidates.  An
    infeasible candidate carries ``INT32_MAX`` in its three keys, so
    with nothing feasible the lowest live index wins and reports its
    own rectangle.  With no live candidate the row is ``INT32_MAX`` in
    the four keys and 0 elsewhere.
    """
    n_free, t_begin, t_end = availscan_ref(times, occ, starts, t_du,
                                           t_now, n_pe)
    feasible = (starts < T_INF) & (n_free >= n_req)
    return select_row(starts, n_free, t_begin, t_end, feasible, policy_id)


def availscan_select_mr_ref(times: torch.Tensor, occ: torch.Tensor,
                            starts: torch.Tensor, valid_mask: torch.Tensor,
                            plane_of_word: torch.Tensor,
                            demand_tail: torch.Tensor, t_du: int,
                            t_now: int, n_req: int, policy_id: int
                            ) -> torch.Tensor:
    """Multi-resource :func:`availscan_select_ref`.

    A live candidate is feasible iff plane 0 has ``n_req`` free units
    and every plane ``r >= 1`` has ``demand_tail[r - 1]``; the keys
    score plane 0's count.  ``demand_tail`` is int32[R-1] (R is its
    length plus one).
    """
    n_free, tail, t_begin, t_end = availscan_mr_ref(
        times, occ, starts, valid_mask, plane_of_word,
        demand_tail.shape[0] + 1, t_du, t_now)
    feasible = ((starts < T_INF) & (n_free >= n_req)
                & (tail >= demand_tail[None, :]).all(dim=1))
    return select_row(starts, n_free, t_begin, t_end, feasible, policy_id)
