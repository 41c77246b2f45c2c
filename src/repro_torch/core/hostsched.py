"""Numpy bitmask engine: the port's own host oracle.

The paper's data structure with PE sets as uint64 bitmask rows and
every operation vectorised in numpy.  It shares no code with the
device path, so :func:`repro_torch.sim.simulate_batched` holds the
card's decisions against it (``cross_check=True``) on a machine that
has no JAX.

Representation
--------------
``times  : int64[S]``    sorted slot boundaries
``occ    : uint64[S,W]`` busy-PE bitmask during ``[times[i], times[i+1])``
with all PEs free before ``times[0]`` and from ``times[-1]`` on.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.types import (
    Allocation,
    ARRequest,
    Policy,
    Rectangle,
    T_INF,
)

_WORD = 64


def n_words(n_pe: int) -> int:
    return (n_pe + _WORD - 1) // _WORD


def mask_from_ids(ids: Iterable[int], n_pe: int) -> np.ndarray:
    m = np.zeros(n_words(n_pe), dtype=np.uint64)
    arr = np.fromiter(ids, dtype=np.int64) if not isinstance(
        ids, np.ndarray) else ids.astype(np.int64)
    if arr.size == 0:
        return m
    if arr.min() < 0 or arr.max() >= n_pe:
        raise ValueError("PE id out of range")
    np.bitwise_or.at(m, arr // _WORD,
                     np.uint64(1) << (arr % _WORD).astype(np.uint64))
    return m


def ids_from_mask(mask: np.ndarray) -> Tuple[int, ...]:
    bits = np.unpackbits(mask.view(np.uint8), bitorder="little")
    return tuple(np.nonzero(bits)[0].tolist())


def popcount(mask: np.ndarray) -> np.ndarray:
    """Population count, summed over the trailing word axis."""
    as_bytes = np.ascontiguousarray(mask).view(np.uint8)
    return np.unpackbits(as_bytes, axis=-1).sum(axis=-1).astype(np.int64)


def lowest_bits(mask: np.ndarray, k: int) -> np.ndarray:
    """Mask of the ``k`` lowest set bits of ``mask`` (1-D word array)."""
    out = np.zeros_like(mask)
    remaining = k
    for w in range(mask.shape[0]):
        word = int(mask[w])
        take = 0
        while word and remaining:
            b = word & -word
            take |= b
            word ^= b
            remaining -= 1
        out[w] = np.uint64(take)
        if not remaining:
            break
    if remaining:
        raise ValueError(f"asked for {k} bits, mask has too few")
    return out


def _policy_primary(policy: Policy, n_free: np.ndarray,
                    t_begin: np.ndarray,
                    t_end: np.ndarray) -> np.ndarray:
    """Lexicographic primary key, ``types.policy_score`` vectorised
    (the ``t_s`` tiebreak stays with the caller)."""
    dur = (t_end - t_begin).astype(np.float64)
    nf = n_free.astype(np.float64)
    if policy == Policy.FF:
        return np.zeros_like(nf)
    if policy == Policy.PE_B:
        return nf
    if policy == Policy.PE_W:
        return -nf
    if policy == Policy.DU_B:
        return dur
    if policy == Policy.DU_W:
        return -dur
    if policy == Policy.PEDU_B:
        return nf * dur
    if policy == Policy.PEDU_W:
        return -nf * dur
    raise ValueError(policy)  # pragma: no cover


class HostScheduler:
    """Vectorised availability timeline + the three paper operations."""

    def __init__(self, n_pe: int):
        self.n_pe = n_pe
        self.W = n_words(n_pe)
        self.times = np.zeros(0, dtype=np.int64)
        self.occ = np.zeros((0, self.W), dtype=np.uint64)
        # bits >= n_pe never participate
        self._pe_mask = mask_from_ids(range(n_pe), n_pe)

    @property
    def n_slots(self) -> int:
        return int(self.times.shape[0])

    def _next_times(self) -> np.ndarray:
        if self.n_slots == 0:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate([self.times[1:], [T_INF]])

    def _busy_row_at(self, t: int) -> np.ndarray:
        i = int(np.searchsorted(self.times, t, side="right")) - 1
        if i < 0 or i >= self.n_slots:
            return np.zeros(self.W, dtype=np.uint64)
        return self.occ[i].copy()

    def _insert_boundaries(self, t_s: int, t_e: int) -> None:
        """Insert both boundary records with one reallocation."""
        new_t, new_rows = [], []
        for t in (t_s, t_e):
            i = int(np.searchsorted(self.times, t, side="left"))
            if not (i < self.n_slots and self.times[i] == t):
                new_t.append(t)
                new_rows.append(self._busy_row_at(t))
        if not new_t:
            return
        idx = np.searchsorted(self.times, new_t, side="left")
        self.times = np.insert(self.times, idx, new_t)
        self.occ = np.insert(self.occ, idx, np.array(new_rows), axis=0)

    def _clean(self) -> None:
        n = self.n_slots
        if n == 0:
            return
        keep = np.empty(n, dtype=bool)
        keep[0] = bool(self.occ[0].any())
        if n > 1:
            np.any(self.occ[1:] != self.occ[:-1], axis=1, out=keep[1:])
        if not keep.all():
            self.times = self.times[keep]
            self.occ = self.occ[keep]

    # -- Algorithms 1 and 2 --------------------------------------------
    def add_allocation(self, t_s: int, t_e: int,
                       pes: Sequence[int] | np.ndarray) -> None:
        mask = pes if isinstance(pes, np.ndarray) \
            else mask_from_ids(pes, self.n_pe)
        if t_s >= t_e:
            raise ValueError("empty interval")
        self._insert_boundaries(t_s, t_e)
        lo = int(np.searchsorted(self.times, t_s, side="left"))
        hi = int(np.searchsorted(self.times, t_e, side="left"))
        if np.any(self.occ[lo:hi] & mask):
            raise ValueError("double booking")
        self.occ[lo:hi] |= mask
        self._clean()

    def delete_allocation(self, t_s: int, t_e: int,
                          pes: Sequence[int] | np.ndarray) -> None:
        mask = pes if isinstance(pes, np.ndarray) \
            else mask_from_ids(pes, self.n_pe)
        self._insert_boundaries(t_s, t_e)
        lo = int(np.searchsorted(self.times, t_s, side="left"))
        hi = int(np.searchsorted(self.times, t_e, side="left"))
        if np.any((self.occ[lo:hi] & mask) != mask):
            raise ValueError("deleting PEs that were not reserved")
        self.occ[lo:hi] &= ~mask
        self._clean()

    # -- Algorithm 3, vectorised over candidate start times -------------
    def window_busy(self, a: int, b: int) -> np.ndarray:
        if self.n_slots == 0:
            return np.zeros(self.W, dtype=np.uint64)
        ov = (self.times < b) & (self._next_times() > a)
        if not ov.any():
            return np.zeros(self.W, dtype=np.uint64)
        return np.bitwise_or.reduce(self.occ[ov], axis=0)

    def candidate_starts(self, req: ARRequest) -> np.ndarray:
        lo, hi = req.t_r, req.t_dl - req.t_du
        cands = [np.array([lo, hi], dtype=np.int64)]
        if self.n_slots:
            t = self.times
            cands.append(t[(t >= lo) & (t <= hi)])
            shifted = t - req.t_du
            cands.append(shifted[(shifted >= lo) & (shifted <= hi)])
        return np.unique(np.concatenate(cands))

    def _rectangles(self, starts: np.ndarray, t_du: int, t_now: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorised rectangles ``(n_free, t_begin, t_end)``.

        Windows over the sorted timeline cover contiguous record
        ranges ``[lo, hi)``, so the busy union is a segmented OR
        (``np.bitwise_or.reduceat``) and the rectangle bounds expand
        outward from the window until the first blocking record.
        """
        P = starts.shape[0]
        if self.n_slots == 0:
            return (np.full(P, self.n_pe, np.int64),
                    np.minimum(t_now, starts.astype(np.int64)),
                    np.full(P, T_INF, np.int64))
        a = starts.astype(np.int64)
        b = a + t_du
        lo = np.searchsorted(self._next_times(), a, side="right")
        hi = np.searchsorted(self.times, b, side="left")
        lo = np.minimum(lo, hi)
        busy = np.zeros((P, self.W), dtype=np.uint64)
        nonempty = hi > lo
        if nonempty.any():
            idx = np.empty(2 * int(nonempty.sum()), dtype=np.int64)
            idx[0::2] = lo[nonempty]
            idx[1::2] = hi[nonempty]
            # reduceat segments alternate [lo:hi) and [hi:next_lo);
            # guard a trailing lo == n_slots (reduceat requires < n)
            seg = np.bitwise_or.reduceat(
                self.occ, np.minimum(idx, self.n_slots - 1), axis=0)
            busy[nonempty] = seg[0::2]
        free = ~busy & self._pe_mask
        nxt = self._next_times()
        t_begin = np.full(P, np.int64(t_now))
        t_end = np.full(P, np.int64(T_INF))
        # left: first blocking slot at lo-1, lo-2, ...
        pos = lo.copy() - 1
        act = np.arange(P)[pos >= 0]
        while act.size:
            p = pos[act]
            blocked = np.any(self.occ[p] & free[act], axis=1)
            hit = act[blocked]
            t_begin[hit] = nxt[pos[hit]]
            act = act[~blocked]
            pos[act] -= 1
            act = act[pos[act] >= 0]
        t_begin = np.minimum(np.maximum(t_begin, t_now), a)
        # right: first blocking slot at hi, hi+1, ...
        pos = hi.copy()
        act = np.arange(P)[pos < self.n_slots]
        while act.size:
            p = pos[act]
            blocked = np.any(self.occ[p] & free[act], axis=1)
            hit = act[blocked]
            t_end[hit] = self.times[pos[hit]]
            act = act[~blocked]
            pos[act] += 1
            act = act[pos[act] < self.n_slots]
        return popcount(free), t_begin, t_end

    def find_allocation(self, req: ARRequest, policy: Policy,
                        t_now: Optional[int] = None
                        ) -> Optional[Allocation]:
        t_now = req.t_a if t_now is None else t_now
        starts = self.candidate_starts(req)
        n_free, t_begin, t_end = self._rectangles(starts, req.t_du, t_now)
        feas = n_free >= req.n_pe
        if not feas.any():
            return None
        primary = np.where(
            feas, _policy_primary(policy, n_free, t_begin, t_end), np.inf)
        tiebreak = np.where(feas, starts, T_INF)
        best = int(np.lexsort((tiebreak, primary))[0])
        rect = Rectangle(t_s=int(starts[best]), t_begin=int(t_begin[best]),
                         t_end=int(t_end[best]), n_free=int(n_free[best]))
        busy = self.window_busy(rect.t_s, rect.t_s + req.t_du)
        chosen = lowest_bits(~busy & self._pe_mask, req.n_pe)
        return Allocation(t_s=rect.t_s, t_e=rect.t_s + req.t_du,
                          pe_ids=ids_from_mask(chosen), rectangle=rect)

    def records(self) -> List[Tuple[int, frozenset]]:
        return [(int(t), frozenset(ids_from_mask(row)))
                for t, row in zip(self.times, self.occ)]
