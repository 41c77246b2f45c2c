"""Numpy bitmask engine: the port's own host oracle.

The paper's data structure with PE sets as uint64 bitmask rows and
every operation vectorised in numpy.  It shares no code with the
device path, so :func:`repro_torch.sim.simulate_batched` holds the
card's decisions against it (``cross_check=True``) on a machine that
has no JAX.  :class:`MultiResourceOracle` is the same for
multi-resource sessions: the event loop of the admit step (with the
backfilling modes of :class:`BackfillOracle`) over a
:class:`MultiHostScheduler` timeline in the device's global bit space,
and :class:`TenantOracle` for multi-tenant ones.

Representation
--------------
``times  : int64[S]``    sorted slot boundaries
``occ    : uint64[S,W]`` busy-PE bitmask during ``[times[i], times[i+1])``
with all PEs free before ``times[0]`` and from ``times[-1]`` on.
"""
from __future__ import annotations

import heapq
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.types import (
    Allocation,
    ARRequest,
    BackfillMode,
    Policy,
    Rectangle,
    T_INF,
)
from repro_torch.tenancy.table import HostTenantAccounts

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

    def __init__(self, n_pe: int, candidate_chunk: int = 128):
        self.n_pe = n_pe
        # the reference's constructor knob (``engine_kwargs``); kept for
        # its interface, the scan is vectorised over all candidates
        self._chunk = candidate_chunk
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

    def _rect_core(self, starts: np.ndarray, t_du: int, t_now: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Free-word rectangles ``(free[P, W], t_begin, t_end)``.

        Windows over the sorted timeline cover contiguous record
        ranges ``[lo, hi)``, so the busy union is a segmented OR
        (``np.bitwise_or.reduceat``) and the rectangle bounds expand
        outward from the window until the first blocking record.  The
        popcount stays with the caller: :meth:`_rectangles` takes one
        count, the multi-resource subclass one per plane.
        """
        P = starts.shape[0]
        if self.n_slots == 0:
            free = np.broadcast_to(self._pe_mask, (P, self.W)).copy()
            return (free, np.minimum(t_now, starts.astype(np.int64)),
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
        return free, t_begin, t_end

    def _rectangles(self, starts: np.ndarray, t_du: int, t_now: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorised rectangles ``(n_free, t_begin, t_end)``."""
        free, t_begin, t_end = self._rect_core(starts, t_du, t_now)
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


class MultiHostScheduler(HostScheduler):
    """Host mirror of the multi-resource timeline.

    The bit space is the device's global bit space (``rspec.total_bits``
    bits, plane ``r`` from ``rspec.bit_offset(r)``), so host unit ids
    equal the ids :func:`repro_torch.core.batch.mask32_to_ids` decodes
    from device masks and records compare verbatim.  ``live_units``
    shrinks planes for heterogeneous machine lanes; bits outside a
    plane's live range are never counted or allocated.  Feasibility is
    the vector test (every plane's free count covers its demand);
    policies score the primary plane's count, as on the device.
    """

    def __init__(self, rspec, live_units=None, candidate_chunk: int = 128):
        super().__init__(rspec.total_bits, candidate_chunk=candidate_chunk)
        self.rspec = rspec
        valid = rspec.valid_bits_np(live_units)
        self._pe_mask = mask_from_ids(np.nonzero(valid)[0], rspec.total_bits)
        self._plane_masks = []
        for r in range(rspec.R):
            o = rspec.bit_offset(r)
            w = rspec.words_per[r] * 32
            ids = o + np.nonzero(valid[o:o + w])[0]
            self._plane_masks.append(mask_from_ids(ids, rspec.total_bits))

    def _demand_vec(self, req: ARRequest) -> Tuple[int, ...]:
        tail = self.rspec.demand_tail(getattr(req, "demand", None),
                                      req.n_pe)
        return (int(req.n_pe),) + tail

    def find_allocation(self, req: ARRequest, policy: Policy,
                        t_now: Optional[int] = None
                        ) -> Optional[Allocation]:
        t_now = req.t_a if t_now is None else t_now
        demand = self._demand_vec(req)
        starts = self.candidate_starts(req)
        free, t_begin, t_end = self._rect_core(starts, req.t_du, t_now)
        plane_free = np.stack([popcount(free & pm)
                               for pm in self._plane_masks], axis=1)
        n_free = plane_free[:, 0]
        feas = np.all(plane_free >= np.asarray(demand, np.int64)[None, :],
                      axis=1)
        if not feas.any():
            return None
        primary = np.where(
            feas, _policy_primary(policy, n_free, t_begin, t_end), np.inf)
        tiebreak = np.where(feas, starts, T_INF)
        best = int(np.lexsort((tiebreak, primary))[0])
        rect = Rectangle(t_s=int(starts[best]), t_begin=int(t_begin[best]),
                         t_end=int(t_end[best]), n_free=int(n_free[best]))
        busy = self.window_busy(rect.t_s, rect.t_s + req.t_du)
        free_w = ~busy & self._pe_mask
        # lowest free units per plane, like the device winning mask
        chosen = np.zeros_like(free_w)
        for r, pm in enumerate(self._plane_masks):
            chosen |= lowest_bits(free_w & pm, demand[r])
        return Allocation(t_s=rect.t_s, t_e=rect.t_s + req.t_du,
                          pe_ids=ids_from_mask(chosen), rectangle=rect)


class BackfillOracle:
    """Host event-loop oracle for the backfilling admission modes.

    A literal Python re-statement of
    the device pipeline — promote due parked reservations, release due
    completions, EASY retry sweep, search, commit-or-park, EASY
    displacement transaction — over a :class:`HostScheduler` timeline.
    The differential suites assert the device ``admit_stream`` is
    bit-identical to :meth:`admit` called per request, and the
    ``moves`` log carries every reservation move for the safety-
    invariant property tests (conservative never moves anything; EASY
    never delays the head of queue or a committed start).
    """

    def __init__(self, n_pe: int, policy: Policy, mode,
                 park_capacity: int = 8):
        self.sched = HostScheduler(n_pe)
        self.n_pe = n_pe
        self.policy = policy
        self.mode = BackfillMode(mode)
        self.Q = park_capacity
        self.parked: List[dict] = []      # ordered by _order_key
        # heap (t_e, heap_seq, t_s, ids, tenant); tenant -1 = anonymous
        self.completions: List[tuple] = []
        self._next_seq = 0
        self._heap_seq = 0
        self.n_parked = self.n_promoted = self.n_moved = 0
        self.retry_flag = False   # armed by cancel, consumed per admit
        # (seq, old_t_s, new_t_s, was_head, event) per reservation move
        self.moves: List[tuple] = []

    # -- tenancy hooks -------------------------------------------------
    # The oracle is single-tenant: FCFS order, anonymous owners, no
    # accounting.  A tenant-aware oracle overrides exactly these four
    # hooks; everything else (promote / release / retry / displace /
    # commit) stays shared.
    def _order_key(self, entry: dict, t_now: int) -> tuple:
        """Queue-sweep priority of a parked entry (ascending)."""
        return (entry["seq"],)

    def _tenant_of(self, req: ARRequest) -> int:
        return -1

    def _on_release(self, tenant: int) -> None:
        """A held reservation left the machine (release or cancel)."""

    def _on_reap(self, tenant: int) -> None:
        """A held reservation was reaped overdue."""

    # -- helpers -------------------------------------------------------
    def _heap_push(self, t_s: int, t_e: int, ids,
                   tenant: int = -1) -> None:
        heapq.heappush(self.completions,
                       (t_e, self._heap_seq, t_s, tuple(ids), tenant))
        self._heap_seq += 1

    def _promote_due(self, t_now: int) -> None:
        self.parked.sort(key=lambda p: self._order_key(p, t_now))
        still = []
        for p in self.parked:
            if p["t_s"] <= t_now:
                self._heap_push(p["t_s"], p["t_e"], p["pe_ids"],
                                p.get("tenant", -1))
                self.n_promoted += 1
            else:
                still.append(p)
        self.parked = still

    def _release_due(self, t_now: int) -> None:
        while self.completions and self.completions[0][0] <= t_now:
            t_e, _, t_s, ids, tenant = heapq.heappop(self.completions)
            self.sched.delete_allocation(t_s, t_e, list(ids))
            self._on_release(tenant)

    def _replacement(self, entry: dict, t_now: int,
                     policy: Policy) -> Optional[Allocation]:
        """The clamped-window re-placement search of a parked entry."""
        req = ARRequest(
            t_a=t_now, t_r=max(entry["t_r"], t_now),
            t_du=entry["t_e"] - entry["t_s"], t_dl=entry["t_dl"],
            n_pe=entry["n_pe"], demand=entry.get("demand"))
        return self.sched.find_allocation(req, policy, t_now=t_now)

    def _retry_parked(self, t_now: int) -> None:
        """EASY retry-on-release sweep: pull reservations earlier
        (never later), in ``_order_key`` order (FCFS, or weighted
        fair-share on the tenant oracle); runs once after a cancel
        armed the latch (only a cancel frees *future* capacity)."""
        for p in sorted(self.parked,
                        key=lambda q: self._order_key(q, t_now)):
            self.sched.delete_allocation(p["t_s"], p["t_e"],
                                         list(p["pe_ids"]))
            alloc = self._replacement(p, t_now, Policy.FF)
            if alloc is not None and alloc.t_s < p["t_s"]:
                self.moves.append((p["seq"], p["t_s"], alloc.t_s,
                                   self._is_head(p, t_now), "retry"))
                p["t_s"], p["t_e"] = alloc.t_s, alloc.t_e
                p["pe_ids"] = alloc.pe_ids
                self.n_moved += 1
            self.sched.add_allocation(p["t_s"], p["t_e"],
                                      list(p["pe_ids"]))

    def _is_head(self, entry: dict, t_now: int) -> bool:
        if not self.parked:
            return False
        head = min(self.parked,
                   key=lambda p: self._order_key(p, t_now))
        return entry["seq"] == head["seq"]

    def _commit_or_park(self, req: ARRequest, t_s: int, t_e: int,
                        pe_ids) -> bool:
        """Book an accepted reservation; returns whether it parked."""
        parks = (self.mode != BackfillMode.NONE
                 and t_s > req.t_r and len(self.parked) < self.Q)
        if parks:
            self.parked.append(dict(
                seq=self._next_seq, t_s=t_s, t_e=t_e, t_r=req.t_r,
                t_dl=req.t_dl, n_pe=req.n_pe, pe_ids=tuple(pe_ids),
                tenant=self._tenant_of(req), t_a=req.t_a,
                demand=req.demand))
            self._next_seq += 1
            self.n_parked += 1
        else:
            self._heap_push(t_s, t_e, pe_ids, self._tenant_of(req))
        return parks

    def _displace(self, req: ARRequest) -> Optional[Allocation]:
        """The EASY transaction: move non-head reservations for req."""
        snap = (self.sched.times.copy(), self.sched.occ.copy(),
                [dict(p) for p in self.parked])
        head_seq = min(self.parked,
                       key=lambda p: self._order_key(p, req.t_a))["seq"]
        nonhead = sorted((p for p in self.parked
                          if p["seq"] != head_seq),
                         key=lambda p: self._order_key(p, req.t_a))
        for p in nonhead:
            self.sched.delete_allocation(p["t_s"], p["t_e"],
                                         list(p["pe_ids"]))
        alloc = self.sched.find_allocation(req, self.policy,
                                           t_now=req.t_a)
        moves = []
        ok = alloc is not None
        if ok:
            self.sched.add_allocation(alloc.t_s, alloc.t_e,
                                      list(alloc.pe_ids))
            for p in nonhead:
                re = self._replacement(p, req.t_a, Policy.FF)
                if re is None:
                    ok = False
                    break
                if re.t_s != p["t_s"]:
                    moves.append((p["seq"], p["t_s"], re.t_s, False,
                                  "displace"))
                p["t_s"], p["t_e"] = re.t_s, re.t_e
                p["pe_ids"] = re.pe_ids
                self.sched.add_allocation(re.t_s, re.t_e,
                                          list(re.pe_ids))
        if not ok:
            self.sched.times, self.sched.occ, self.parked = \
                snap[0], snap[1], snap[2]
            return None
        self.moves.extend(moves)
        self.n_moved += len(moves)
        return alloc

    # -- one admission step (mirrors the device _admit_impl) ----------
    def admit(self, req: ARRequest) -> Tuple[bool, int, bool]:
        """Decide one arrival; returns ``(accepted, t_s, parked)``."""
        t_now = req.t_a
        self._promote_due(t_now)
        self._release_due(t_now)
        if self.mode == BackfillMode.EASY and self.parked \
                and self.retry_flag:
            self._retry_parked(t_now)
        self.retry_flag = False
        alloc = self.sched.find_allocation(req, self.policy,
                                           t_now=t_now)
        if alloc is None and self.mode == BackfillMode.EASY \
                and len(self.parked) >= 2:
            # a lone head cannot be displaced around: the transaction
            # would re-run the identical failed search (device parity)
            alloc = self._displace(req)
            if alloc is None:
                return False, -1, False
            parked = self._commit_or_park(req, alloc.t_s, alloc.t_e,
                                          alloc.pe_ids)
            return True, alloc.t_s, parked
        if alloc is None:
            return False, -1, False
        self.sched.add_allocation(alloc.t_s, alloc.t_e,
                                  list(alloc.pe_ids))
        parked = self._commit_or_park(req, alloc.t_s, alloc.t_e,
                                      alloc.pe_ids)
        return True, alloc.t_s, parked

    def run(self, jobs) -> List[Tuple[bool, int]]:
        """Admit an arrival-ordered stream; per-job (accepted, t_s)."""
        return [self.admit(r)[:2] for r in jobs]

    def tick(self, t_now: int) -> None:
        """Advance time only: promote and release everything due."""
        self._promote_due(t_now)
        self._release_due(t_now)

    def cancel(self, t_s: int, t_e: int, pe_ids) -> bool:
        """Withdraw a parked or committed reservation; arms the
        EASY retry-on-release sweep (mirrors ``cancel_step``)."""
        key = (t_s, t_e, tuple(pe_ids))
        for p in self.parked:
            if (p["t_s"], p["t_e"], tuple(p["pe_ids"])) == key:
                self.parked.remove(p)
                self._on_release(p.get("tenant", -1))
                break
        else:
            match = [c for c in self.completions
                     if (c[2], c[0], c[3]) == key]
            if not match:
                return False
            self.completions.remove(match[0])
            heapq.heapify(self.completions)
            self._on_release(match[0][4])
        self.sched.delete_allocation(t_s, t_e, list(pe_ids))
        self.retry_flag = True
        return True

    def pending(self) -> List[dict]:
        """FCFS deferral-queue view, one dict per parked entry."""
        out = []
        for p in sorted(self.parked, key=lambda q: q["seq"]):
            d = dict(seq=p["seq"], t_s=p["t_s"], t_e=p["t_e"],
                     t_r=p["t_r"], t_dl=p["t_dl"], n_pe=p["n_pe"],
                     pe_ids=tuple(p["pe_ids"]))
            if p.get("demand") is not None:
                d["demand"] = tuple(p["demand"])
            out.append(d)
        return out

    def records(self):
        return self.sched.records()


class TenantOracle(BackfillOracle):
    """Host event-loop oracle of the multi-tenant admit step.

    :class:`BackfillOracle` with the four tenancy hooks filled in and
    the accounting of :class:`repro_torch.tenancy.HostTenantAccounts`
    (the device's float32 roundings, so the counters and EWMAs are bit
    for bit): the quota gate runs after the queue work and before the
    search, the queue sweeps rank by the weighted fair-share key, and
    :meth:`reap` deletes the completions overdue past ``t_e + grace``,
    charging their owners.  ``auto_release=False`` mirrors a session
    that releases nothing on arrival (mode ``none``): reservations then
    leave only by :meth:`reap` or :meth:`cancel`.
    """

    def __init__(self, n_pe: int, policy: Policy, mode, spec,
                 park_capacity: int = 8, auto_release: bool = True):
        super().__init__(n_pe, policy, mode, park_capacity)
        if not auto_release and self.mode != BackfillMode.NONE:
            raise ValueError("backfilling needs auto_release")
        self.spec = spec
        self.accounts = HostTenantAccounts(spec)
        self.grace = spec.grace
        self.auto_release = auto_release
        self.n_reaped = 0

    # -- the tenancy hooks ---------------------------------------------
    def _order_key(self, entry: dict, t_now: int) -> tuple:
        # the device's fair key: highest weight * wait first, then seq
        key = self.accounts.key(entry.get("tenant", 0), entry["t_a"], t_now)
        return (-key, entry["seq"])

    def _tenant_of(self, req: ARRequest) -> int:
        return int(req.tenant)

    def _on_release(self, tenant: int) -> None:
        self.accounts.release(tenant)

    def _on_reap(self, tenant: int) -> None:
        self.accounts.reap(tenant)

    def _release_due(self, t_now: int) -> None:
        if self.auto_release:
            super()._release_due(t_now)

    # -- gated admission -----------------------------------------------
    def admit(self, req: ARRequest) -> Tuple[bool, int, bool]:
        t_now = req.t_a
        # the queue work precedes the gate; the base admit then finds
        # nothing new due and the retry latch consumed
        self._promote_due(t_now)
        self._release_due(t_now)
        if self.mode == BackfillMode.EASY and self.parked \
                and self.retry_flag:
            self._retry_parked(t_now)
        self.retry_flag = False
        # occupancy after the queue work, as the device samples it
        occ_frac = (np.float32(popcount(self.sched._busy_row_at(t_now)))
                    / np.float32(self.n_pe))
        tid = self.accounts.clip_tid(self._tenant_of(req))
        if not self.accounts.allowed(tid, req.n_pe, req.t_du):
            self.accounts.record(tid, accepted=False, blocked=True,
                                 parked=False, occ_frac=occ_frac)
            return False, -1, False
        accepted, t_s, parked = super().admit(req)
        self.accounts.record(
            tid, accepted=accepted, blocked=False, parked=parked,
            occ_frac=occ_frac, t_e=(t_s + req.t_du) if accepted else -1,
            t_r=req.t_r, t_du=req.t_du, n_pe=req.n_pe)
        return accepted, t_s, parked

    def reap(self, t_now: int) -> int:
        """Delete reservations overdue past ``t_e + grace`` (no
        promotion first); returns how many."""
        if self.grace is None:
            return 0
        cutoff = t_now - self.grace
        reaped = 0
        while self.completions and self.completions[0][0] <= cutoff:
            t_e, _, t_s, ids, tenant = heapq.heappop(self.completions)
            self.sched.delete_allocation(t_s, t_e, list(ids))
            self._on_reap(tenant)
            reaped += 1
        self.n_reaped += reaped
        return reaped

    def pending(self) -> List[dict]:
        """FCFS queue view with each entry's ``tenant`` and ``t_a``, as
        :func:`repro_torch.core.batch.parked_entries` on a tenanted
        state."""
        by_seq = {p["seq"]: p for p in self.parked}
        out = super().pending()
        for d in out:
            d["tenant"] = by_seq[d["seq"]]["tenant"]
            d["t_a"] = by_seq[d["seq"]]["t_a"]
        return out


class MultiResourceOracle(BackfillOracle):
    """Differential mirror of the multi-resource device admit path.

    :class:`BackfillOracle` with its timeline swapped for a
    :class:`MultiHostScheduler` — every shared sweep (promote /
    release / retry / displace / commit-or-park) already threads the
    request's ``demand`` vector through the parked entries, so the
    vector feasibility test is the only behavioural difference.
    ``live_units`` mirrors a heterogeneous machine lane.
    """

    def __init__(self, rspec, policy: Policy, mode,
                 park_capacity: int = 8, live_units=None):
        super().__init__(rspec.n_pe, policy, mode, park_capacity)
        self.rspec = rspec
        self.sched = MultiHostScheduler(rspec, live_units=live_units)
