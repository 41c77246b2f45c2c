"""Literal reference implementation of the paper's data structure.

This module follows Section 4 of the paper as directly as possible: the
availability of the cluster is a sorted list of ``{time, busy-PE-set}``
records (``AvailRectList``); the busy set of record ``i`` holds during
``[time_i, time_{i+1})``; before the first record and from the last
record onwards every PE is free (the last record always carries an empty
set).  Sets are real Python ``set`` objects and every operation walks the
list exactly the way the paper's Algorithms 1-3 describe.

It is deliberately unoptimised: it is the semantic oracle that the
numpy host engine (``hostsched.py``) and the device engine
(``timeline.py`` / ``search.py`` / the CUDA kernels) are held against.
The port's copy of ``repro/core/listsched.py``; it runs on the host
only, and a session picks it explicitly with ``engine="list"``.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Set, Tuple

from repro_torch.core.types import (
    Allocation,
    ARRequest,
    Policy,
    Rectangle,
    T_INF,
    policy_score,
)


class ListScheduler:
    """The paper's ``AvailRectList`` with the three basic operations."""

    def __init__(self, n_pe: int):
        if n_pe <= 0:
            raise ValueError("n_pe must be positive")
        self.n_pe = n_pe
        self._all_pes: Set[int] = set(range(n_pe))
        # Parallel sorted arrays: times[i] is the instant at which the
        # busy set changes to busy[i].
        self.times: List[int] = []
        self.busy: List[Set[int]] = []

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _busy_at(self, t: int) -> Set[int]:
        """Busy set in effect at instant ``t`` (empty outside records)."""
        i = bisect.bisect_right(self.times, t) - 1
        if i < 0 or i >= len(self.times):
            return set()
        return set(self.busy[i])

    def _insert_boundary(self, t: int) -> None:
        """Ensure a record exists exactly at ``t`` (inheriting state)."""
        i = bisect.bisect_left(self.times, t)
        if i < len(self.times) and self.times[i] == t:
            return
        inherited = self._busy_at(t)
        self.times.insert(i, t)
        self.busy.insert(i, inherited)

    def _clean(self) -> None:
        """Merge redundant records (paper: 'clean possible redundant
        records').  A record is redundant when its busy set equals the
        previous record's busy set; a leading record with an empty busy
        set is redundant as well (everything is free before the first
        record anyway)."""
        out_t: List[int] = []
        out_b: List[Set[int]] = []
        prev: Set[int] = set()
        for t, b in zip(self.times, self.busy):
            if b == prev:
                continue
            out_t.append(t)
            out_b.append(b)
            prev = b
        self.times, self.busy = out_t, out_b

    # ------------------------------------------------------------------
    # Algorithm 1 / Algorithm 2
    # ------------------------------------------------------------------
    def add_allocation(self, t_s: int, t_e: int, pes: Set[int]) -> None:
        if not t_s < t_e:
            raise ValueError("empty interval")
        if not pes <= self._all_pes:
            raise ValueError("unknown PE id")
        self._insert_boundary(t_s)
        self._insert_boundary(t_e)
        lo = bisect.bisect_left(self.times, t_s)
        hi = bisect.bisect_left(self.times, t_e)
        for i in range(lo, hi):
            if self.busy[i] & pes:
                raise ValueError(
                    f"double booking of PEs {self.busy[i] & pes} in "
                    f"[{self.times[i]}, ...)")
            self.busy[i] = self.busy[i] | pes
        self._clean()

    def delete_allocation(self, t_s: int, t_e: int, pes: Set[int]) -> None:
        self._insert_boundary(t_s)
        self._insert_boundary(t_e)
        lo = bisect.bisect_left(self.times, t_s)
        hi = bisect.bisect_left(self.times, t_e)
        for i in range(lo, hi):
            if not pes <= self.busy[i]:
                raise ValueError("deleting PEs that were not reserved")
            self.busy[i] = self.busy[i] - pes
        self._clean()

    # ------------------------------------------------------------------
    # Algorithm 3
    # ------------------------------------------------------------------
    def window_busy(self, a: int, b: int) -> Set[int]:
        """Union of busy sets over all records intersecting ``[a, b)``."""
        acc: Set[int] = set()
        n = len(self.times)
        for i in range(n):
            start = self.times[i]
            end = self.times[i + 1] if i + 1 < n else T_INF
            if start < b and end > a:
                acc |= self.busy[i]
        return acc

    def candidate_starts(self, req: ARRequest) -> List[int]:
        """Feasible-start candidates: the ready time, the latest start,
        every existing slot boundary in range, and every boundary shifted
        left by the duration (end-aligned placements).  Matches the
        paper's Section 4.2 example (candidates t2, t3, t6, t7)."""
        lo, hi = req.t_r, req.t_dl - req.t_du
        cands = {lo, hi}
        for t in self.times:
            if lo <= t <= hi:
                cands.add(t)
            if lo <= t - req.t_du <= hi:
                cands.add(t - req.t_du)
        return sorted(cands)

    def rectangle(self, t_s: int, t_du: int, t_now: int) -> Rectangle:
        """Maximum availability rectangle for the window
        ``[t_s, t_s + t_du)`` (paper Algorithm 3 line 7)."""
        a, b = t_s, t_s + t_du
        busy_union = self.window_busy(a, b)
        free = self._all_pes - busy_union
        t_begin, t_end = t_now, T_INF
        n = len(self.times)
        for i in range(n):
            start = self.times[i]
            end = self.times[i + 1] if i + 1 < n else T_INF
            if not (self.busy[i] & free):
                continue  # not blocking: its busy PEs are all outside F
            if end <= a and end > t_begin:
                t_begin = end
            if start >= b and start < t_end:
                t_end = start
        t_begin = min(t_begin, a)
        return Rectangle(t_s=t_s, t_begin=t_begin, t_end=t_end,
                         n_free=len(free))

    def find_allocation(
        self,
        req: ARRequest,
        policy: Policy,
        t_now: Optional[int] = None,
    ) -> Optional[Allocation]:
        t_now = req.t_a if t_now is None else t_now
        feasible: List[Rectangle] = []
        for t_s in self.candidate_starts(req):
            rect = self.rectangle(t_s, req.t_du, t_now)
            if rect.n_free >= req.n_pe:
                feasible.append(rect)
        if not feasible:
            return None
        best = min(feasible, key=lambda r: policy_score(policy, r))
        busy_union = self.window_busy(best.t_s, best.t_s + req.t_du)
        free = sorted(self._all_pes - busy_union)
        return Allocation(
            t_s=best.t_s,
            t_e=best.t_s + req.t_du,
            pe_ids=tuple(free[: req.n_pe]),
            rectangle=best,
        )

    # ------------------------------------------------------------------
    # introspection used by tests
    # ------------------------------------------------------------------
    def records(self) -> List[Tuple[int, frozenset]]:
        return [(t, frozenset(b)) for t, b in zip(self.times, self.busy)]

    def busy_count_at(self, t: int) -> int:
        return len(self._busy_at(t))
