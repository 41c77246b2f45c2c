"""FleetScheduler: the paper's AR core managing the cards of an ML fleet.

The port's copy of ``repro/runtime/fleet.py``.  The production fleet
(2 pods x 256 cards) is the paper's multiprocessor system, with cards
as PEs.  Every training or serving run of an assigned architecture is
an AR request: ``n_pe`` is the job's card footprint, ``t_du`` its
estimated steps x roofline step time (:mod:`repro_torch.roofline.
analysis`, H100 constants), ``t_r`` / ``t_dl`` come from the user's
SLO.  Admission, placement and policy choice reuse
:mod:`repro_torch.core` unchanged.

With ``n_partitions > 1`` the fleet is *partitioned*: the cards split
into equal partitions, each one lane of an ensemble
(:class:`PartitionedCore`).  Bulk submissions are routed across
partitions (round robin, least loaded, or best-acceptance probes) and
admitted through one grouped ensemble admission; jobs never span
partitions.  The reference's routing scans (``_match_scan``,
``_least_loaded_scan``) are ``lax.scan`` s over ``[N, E]`` booleans and
int32 starts it reads back right after; here they are host loops over
the same arrays, read once.

Fault tolerance (the general-deadline slack is what makes it work, the
paper's central observation):

* ``fail_chip``: the card gets a repair reservation; every job holding
  it has its reservation deleted and its *remaining* work (back to the
  last checkpoint) re-submitted as a new AR request within the original
  deadline.
* ``report_straggler``: a job running slower than its reservation is
  re-reserved with the stretched duration while its deadline slack
  absorbs the slip.
* ``rescale``: elastic re-reservation of the remaining work on a
  different card count (duration rescaled by the roofline model).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api import ReservationService, ServiceConfig
from repro_torch.api.config import ROUTINGS  # noqa: F401  (re-export)
from repro_torch.configs import get_config, shape_by_name
from repro_torch.core import batch as batch_lib
from repro_torch.core import ensemble as ens_lib
from repro_torch.core import timeline as tl_lib
from repro_torch.core.hostsched import merge_records
from repro_torch.core.policies import policy_index
from repro_torch.core.types import Allocation, ARRequest, Policy, T_INF
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import resolve_placement
from repro_torch.roofline import analysis as roof
from repro_torch.sharding import rules as shard_rules


class JobState(str, enum.Enum):
    REJECTED = "rejected"
    RESERVED = "reserved"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"


@dataclasses.dataclass
class FleetJob:
    job_id: int
    arch: str
    shape: str
    n_chips: int
    n_steps: int
    submit_time: int
    ready: int
    deadline: int
    state: JobState = JobState.RESERVED
    t_start: int = -1
    t_end: int = -1
    chips: tuple = ()
    partition: int = -1                   # -1: unpartitioned fleet
    checkpoint_interval: int = 600        # seconds of work per ckpt
    work_done: int = 0                    # seconds of completed work
    preemptions: int = 0

    @property
    def step_time(self) -> float:
        return (self.t_end - self.t_start) / max(self.n_steps, 1)


def estimate_duration(arch: str, shape_name: str, n_chips: int,
                      n_steps: int, efficiency: float = 0.5) -> int:
    """Roofline-model duration estimate for ``n_steps`` on ``n_chips``.

    ``efficiency`` discounts peak (achieved fraction of roofline).
    """
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    model = min(16, n_chips)
    mesh = {"data": max(n_chips // model, 1), "model": model}
    costs = roof.step_costs(cfg, shape, mesh)
    terms = costs.terms(n_chips)
    step_s = max(terms["compute_s"], terms["memory_s"],
                 terms["collective_s"]) / efficiency
    return max(int(step_s * n_steps) + 1, 60)


# -- fleet matching ----------------------------------------------------
#
# Policies whose slot *selection* depends only on occupancy inside the
# request's own search window [t_r, t_dl): FF orders by start time and
# the PE policies by free-PE count at the candidate, both window-local
# quantities.  The duration policies score by rectangle extent, which
# reaches outside the window to the nearest blocking boundary, so any
# same-round commit on a lane may move their chosen start.
_WINDOW_LOCAL_POLICIES = frozenset((Policy.FF, Policy.PE_B, Policy.PE_W))


def _match_scan(found: np.ndarray, t_s: np.ndarray, t_e: np.ndarray,
                t_r: np.ndarray, t_dl: np.ndarray, pending: np.ndarray,
                window_local: bool, monotone: bool):
    """One matching round over an ``[N, E]`` probe (host arrays).

    A scan over the requests in arrival order.  The carry tracks, per
    lane, whether this round committed to it plus a bounding interval
    ``[cmin, cmax)`` over the round's committed slots, and one scalar
    bounding interval ``[dmin, dmax)`` over the *deferred* requests'
    search windows.  Request i's probe of lane e is *valid* (still equal
    to a fresh sequential probe) iff no earlier commit this round can
    have changed e's answer: for window-local policies that means no
    committed slot overlapping ``[t_r_i, t_dl_i)``; for rectangle-scored
    policies any commit on the lane invalidates it.  The bounding
    intervals are conservative: false overlaps only defer, never
    misroute.

    Sequential order also demands that a request never finalizes
    *ahead* of a still-deferred earlier arrival whose eventual commit
    could change its answer (or be changed by its commit): request i
    additionally requires its window to be disjoint from every deferred
    window so far (``clear``); rectangle policies require no deferral
    at all.

    Finalization (bit for bit the sequential probe-commit oracle): pick
    ``lane* = argmin`` start over *valid feasible* lanes (ties to the
    lowest index).  Finalize when every lane is valid and the row is
    clear.  Otherwise finalize only under ready-start dominance:
    ``t_s[lane*] == t_r_i``, the row is clear, and every lane below
    ``lane*`` is valid.  FF starts are monotone under added occupancy,
    so under FF an invalid lane below ``lane*`` whose stale start
    already exceeds ``t_r_i`` is also safe (``monotone``).  Rejection
    is final regardless of staleness: a commit only adds occupancy.
    Everything else defers to the next round's re-probe.  The first
    pending request of a round always resolves.  Returns the lane per
    request (``-1`` where not assigned) and the rejected mask.
    """
    n, E = found.shape
    lane_idx = np.arange(E)
    committed = np.zeros(E, bool)
    cmin = np.full(E, T_INF, np.int64)
    cmax = np.zeros(E, np.int64)
    dmin, dmax, any_def = T_INF, 0, False
    lanes = np.full(n, -1, np.int32)
    rejects = np.zeros(n, bool)
    for i in range(n):
        if not pending[i]:
            continue            # neither assigns, rejects nor defers
        f, ts, tr, tdl = found[i], t_s[i], int(t_r[i]), int(t_dl[i])
        if window_local:
            valid = ~(committed & (tr < cmax) & (tdl > cmin))
            clear = not (tr < dmax and tdl > dmin)
        else:
            valid = ~committed
            clear = not any_def
        tv = np.where(f & valid, ts, T_INF)
        lane = int(np.argmin(tv))
        best = int(tv[lane])
        feasible = best < T_INF
        all_valid = bool(valid.all()) and clear
        safe_below = valid | (lane_idx >= lane) \
            | (monotone & (np.where(f, ts, T_INF) > tr))
        dominant = feasible and best == tr and clear and bool(
            safe_below.all())
        if feasible and (all_valid or dominant):
            lanes[i] = lane
            committed[lane] = True
            cmin[lane] = min(cmin[lane], int(ts[lane]))
            cmax[lane] = max(cmax[lane], int(t_e[i, lane]))
        elif not f.any():
            rejects[i] = True
        else:
            dmin, dmax, any_def = min(dmin, tr), max(dmax, tdl), True
    return lanes, rejects


def _least_loaded_scan(load: np.ndarray, n_pe, t_du) -> List[int]:
    """Greedy least-loaded routing over the load vector.

    The lane is the argmin of committed + planned PE-seconds; each
    request's planned area ``f32(n_pe) * f32(t_du)`` is added, in
    float32, before the next request, as the reference's scan adds it.
    The scratch copy is never written back: committed load lands only
    after the grouped commit.
    """
    ld = np.array(load, np.float32)
    lanes = []
    for npe, tdu in zip(n_pe, t_du):
        lane = int(np.argmin(ld))
        ld[lane] += np.float32(npe) * np.float32(tdu)
        lanes.append(lane)
    return lanes


class PartitionedCore:
    """E cluster partitions behind one ensemble of lane states.

    The fleet's cards are split into ``n_partitions`` equal partitions;
    each partition is one lane of an ensemble (:mod:`repro_torch.core.
    ensemble`), so bulk admission steps every partition through one
    grouped admission (``admit_stream_ensemble_auto``) and the
    best-acceptance probe searches all partitions
    (``find_allocation_ensemble``).

    The interface mirrors the single-cluster engines, ``find`` /
    ``add`` / ``delete`` with *global* card ids, plus the routed bulk
    path :meth:`admit_stream_allocations`.  An allocation never spans
    partitions: requests wider than a partition are rejected.

    Bulk ingress costs a number of dispatches bounded by the rounds,
    never by N: ``least_loaded`` routes with one scan over the load
    vector, ``best_acceptance`` runs bounded probe -> match ->
    grouped-commit rounds over an ``[N, E]`` probe, and every routing
    commits through one grouped ensemble admission.  ``dispatches``
    counts them at the reference's points (each probe, match, commit,
    fused tail, routing scan, timeline update and release); ``stats``
    counts the admit steps, probes and host reads they cost.

    With ``backfill`` set (and ``auto_release=True``, required) every
    partition lane carries the deferral queue: rejected requests park
    (up to ``park_capacity``) and retry as completed reservations
    release on :meth:`release_until`.  ``placement`` places partition
    ``i`` on card ``i // (E / d)`` of its mesh (``ServiceConfig.
    placement``; one card: every lane on ``device``, ``None`` is cuda).
    """

    #: probe -> match -> commit rounds before the fused matcher takes the
    #: remaining requests (the default of ``match_rounds=8``)
    match_max_rounds: int = 8

    def __init__(self, n_chips: int, n_partitions: int,
                 capacity: int = 128, pending_capacity: int = 256,
                 use_kernel: bool = True, placement="auto",
                 device: DeviceLike = None,
                 park_capacity: int = 0, backfill: str = "none",
                 auto_release: bool = False,
                 match_rounds: Optional[int] = None,
                 index_tile: Optional[int] = None):
        if n_partitions < 1 or n_chips % n_partitions:
            raise ValueError(
                f"n_chips={n_chips} not divisible into "
                f"{n_partitions} partitions")
        if backfill != "none" and not auto_release:
            raise ValueError(
                "backfilling partitions replay parked requests from "
                "the pending-release buffer; auto_release must be on")
        if backfill != "none" and park_capacity <= 0:
            raise ValueError(
                "backfilling partitions need park_capacity > 0")
        self.n_chips = n_chips
        self.n_partitions = n_partitions
        self.chips_per_part = n_chips // n_partitions
        self.use_kernel = use_kernel
        self.backfill = backfill
        self.auto_release = auto_release
        self.device = resolve_device(device)
        # partition i lives on card i // (E / d) of the placement's mesh;
        # decisions are the same on every placement
        self.mesh = resolve_placement(placement, n_partitions, self.device)
        # probe -> match rounds pay only where the [N, E] probe evaluates
        # in parallel.  The port's probe is N x E searches one after
        # another, each the serial scan the fused matcher runs per step
        # anyway, so the auto choice is the fused matcher (0 rounds);
        # match_rounds > 0 forces the rounds protocol.  Decisions are
        # the same either way.
        self.match_max_rounds = 0 if match_rounds is None \
            else int(match_rounds)
        # index_tile attaches the availability index to every lane: the
        # [N, E] probe early-rejects summary-infeasible lanes to the
        # result a full search would give, prefiltering the matcher
        # without changing a routing decision
        self.states = shard_rules.shard_ensemble(
            self.mesh, ens_lib.init_ensemble(
                n_partitions, capacity, self.chips_per_part,
                pending_capacity, park_capacity, index_tile=index_tile,
                device=self.device))
        self._backfills = ens_lib.backfill_ids(backfill, n_partitions)
        # committed PE-seconds per partition (least-loaded routing): a
        # float32 host ledger, the reference's authoritative copy
        self._load_host = np.zeros(n_partitions, np.float32)
        self._rr = 0                      # round-robin cursor
        self.dispatches = 0               # dispatch counter
        self.last_match_rounds = 0        # rounds of the last matcher
        # admit steps, probes, growths and host reads of every call
        self.stats = batch_lib.StreamStats()

    @property
    def load(self) -> List[float]:
        """Committed PE-seconds per partition (host view)."""
        return [float(x) for x in self._load_host]

    @load.setter
    def load(self, values) -> None:
        self._load_host = np.asarray(values, np.float32).copy()

    def _bump_load(self, lane: int, delta: float) -> None:
        self._load_host[lane] += np.float32(delta)

    # -- global card ids <-> (lane, local) ------------------------------
    def _split(self, pes: Sequence[int]):
        lanes = {p // self.chips_per_part for p in pes}
        if len(lanes) != 1:
            raise ValueError(
                f"allocation spans partitions {sorted(lanes)}")
        lane = lanes.pop()
        return lane, [p - lane * self.chips_per_part for p in pes]

    def _mask(self, local_pes: Sequence[int], lane: int) -> torch.Tensor:
        tl = self.states[lane].tl
        return tl_lib.ids_to_mask32(local_pes, tl.words, device=tl.device)

    def _globalize(self, lane: int, alloc: Optional[Allocation]
                   ) -> Optional[Allocation]:
        if alloc is None:
            return None
        off = lane * self.chips_per_part
        return dataclasses.replace(
            alloc, pe_ids=tuple(p + off for p in alloc.pe_ids))

    # -- the three classic operations (global card ids) ------------------
    def _lane_update(self, lane: int, t_s: int, t_e: int,
                     local_pes: Sequence[int], is_add: bool) -> None:
        mask = self._mask(local_pes, lane)
        for _ in range(batch_lib.MAX_DOUBLINGS + 1):
            one = self.states[lane]
            new_tl, overflow, n_keep = tl_lib.update(
                one.tl, t_s, t_e, mask, is_add=is_add, with_count=True)
            self.dispatches += 1
            ovf, need = (int(x) for x in torch.stack(
                [overflow.to(tl_lib.I32), n_keep.to(tl_lib.I32)]).cpu())
            self.stats.sync()
            if not ovf:
                self.states = ens_lib.set_member(
                    self.states, lane, one._replace(tl=new_tl))
                return
            # the watermark protocol: grow every lane once to the
            # needed record count
            cap, pend = ens_lib.lane_capacity(self.states)
            self.states = ens_lib.grow_ensemble(
                self.states, max(2 * cap, tl_lib.next_pow2(need)), pend)
        raise RuntimeError("partition timeline kept overflowing")

    def add_allocation(self, t_s: int, t_e: int,
                       pes: Sequence[int]) -> None:
        lane, local = self._split(pes)
        self._lane_update(lane, t_s, t_e, local, is_add=True)
        self._bump_load(lane, (t_e - t_s) * len(local))

    def delete_allocation(self, t_s: int, t_e: int,
                          pes: Sequence[int]) -> None:
        lane, local = self._split(pes)
        self._lane_update(lane, t_s, t_e, local, is_add=False)
        self._bump_load(lane, -(t_e - t_s) * len(local))

    def release_until(self, t_now: int) -> None:
        """Advance the auto-release clock on every partition lane."""
        self.states = ens_lib.release_until_ensemble(self.states, t_now,
                                                     stats=self.stats)
        self.dispatches += 1

    # -- staged probe structs --------------------------------------------
    def stage_request(self, req: ARRequest) -> batch_lib.RequestBatch:
        """Stage one request's scalar struct for :meth:`find_allocation`.

        The port's search takes the request's fields as host integers
        (kernel arguments), so the struct stays on the host: passing it
        via ``struct=`` to repeated probes of one request (the
        malleable sweep probing per card count) reads nothing back.
        """
        return batch_lib.request_struct(req, device="cpu")

    def stage_requests(self, requests: Sequence[ARRequest]
                       ) -> batch_lib.RequestBatch:
        """Stage an ``[N]`` request batch on the host: every probe
        round of the batched matcher reads its rows from it."""
        return batch_lib.requests_to_batch(requests, device="cpu")

    def find_allocation(self, req: Optional[ARRequest], policy: Policy,
                        t_now: Optional[int] = None, *,
                        struct: Optional[batch_lib.RequestBatch] = None
                        ) -> Optional[Allocation]:
        """Best-acceptance probe: search every partition, take the
        earliest feasible start (ties to the lowest lane).

        ``struct`` (from :meth:`stage_request`) stands in for ``req``.
        """
        if struct is None:
            struct = self.stage_request(req)
        if t_now is not None:
            # the search reads its "now" from the struct's t_a
            struct = struct._replace(t_a=torch.tensor(t_now,
                                                      dtype=tl_lib.I32))
        res = ens_lib.to_host(ens_lib.find_allocation_ensemble(
            self.states, struct, policy_index(policy),
            n_pe=self.chips_per_part, use_kernel=self.use_kernel,
            stats=self.stats), self.stats)           # one read
        self.dispatches += 1
        if not res.found.any():
            return None
        lane = int(np.argmin(np.where(res.found, res.t_s, T_INF)))
        one = batch_lib.search_result_to_allocation(
            ens_lib.lane_of(res, lane))
        return self._globalize(lane, one)

    # -- routed bulk admission -------------------------------------------
    def route(self, requests: Sequence[ARRequest], routing: str, *,
              policy: Policy = Policy.FF,
              legacy_raise: bool = False) -> List[int]:
        """Assign a partition lane to every request (no commit).

        Every routing returns one lane per request.  ``best_acceptance``
        returns the matcher's probe preview: one shared ``[N, E]`` probe
        of the current timelines under ``policy``, each request taking
        its earliest feasible start (ties to the lowest lane), ``-1``
        where no partition can host it.  The preview is commit-free and
        therefore ignores contention inside the batch:
        :meth:`admit_stream_allocations` is the authoritative matcher.
        ``legacy_raise=True`` restores the old ValueError contract and
        is deprecated.
        """
        if routing not in ROUTINGS:
            raise ValueError(
                f"unknown routing {routing!r}; pick one of {ROUTINGS}")
        if routing == "best_acceptance":
            if legacy_raise:
                warnings.warn(
                    "route(legacy_raise=True) is deprecated: "
                    "best_acceptance now returns the matcher's lane "
                    "preview instead of raising",
                    DeprecationWarning, stacklevel=2)
                raise ValueError(
                    "best_acceptance routes by probing the timelines, "
                    "not by pre-assignment; use "
                    "admit_stream_allocations")
            if not requests:
                return []
            res = self._probe_all(self.stage_requests(requests), policy)
            self.dispatches += 1
            t_s = np.where(res.found, res.t_s, T_INF)
            lanes = np.argmin(t_s, axis=1)
            return [int(lane) if res.found[i].any() else -1
                    for i, lane in enumerate(lanes)]
        E = self.n_partitions
        if routing == "round_robin":
            lanes = [(self._rr + i) % E for i in range(len(requests))]
            self._rr = (self._rr + len(requests)) % E
            return lanes
        # least_loaded: greedy argmin over committed + planned area
        if not requests:
            return []
        lanes = _least_loaded_scan(self._load_host,
                                   [r.n_pe for r in requests],
                                   [r.t_du for r in requests])
        self.dispatches += 1
        return lanes

    def _probe_all(self, reqs: batch_lib.RequestBatch, policy: Policy):
        """The ``[N, E]`` probe of a staged batch, on the host."""
        return ens_lib.to_host(ens_lib.find_allocations_ensemble(
            self.states, reqs, policy_index(policy),
            n_pe=self.chips_per_part, use_kernel=self.use_kernel,
            stats=self.stats), self.stats)

    def _commit_grouped(self, requests: Sequence[ARRequest],
                        lanes: Sequence[int], policy: Policy
                        ) -> List[Optional[Allocation]]:
        """Commit routed requests in one grouped ensemble admission."""
        batch, _, slots = batch_lib.scatter_streams(
            requests, lanes, self.n_partitions, self.chips_per_part,
            device=self.device)
        self.states, dec = ens_lib.admit_stream_ensemble_auto(
            self.states, batch, (policy_index(policy),) * self.n_partitions,
            n_pe=self.chips_per_part, backfills=self._backfills,
            auto_release=self.auto_release, use_kernel=self.use_kernel,
            stats=self.stats)
        self.dispatches += 1
        dec = ens_lib.to_host(dec, self.stats)        # one read
        allocs = []
        for lane, pos in slots:
            alloc = self._globalize(lane, batch_lib.decision_to_allocation(
                batch_lib.Decision(*(x[lane][pos] for x in dec))))
            if alloc is not None:
                self._load_host[lane] += np.float32(
                    (alloc.t_e - alloc.t_s) * len(alloc.pe_ids))
            allocs.append(alloc)
        return allocs

    def _admit_best_acceptance(self, requests: Sequence[ARRequest],
                               policy: Policy
                               ) -> List[Optional[Allocation]]:
        """Batched best-acceptance: probe x match x commit rounds.

        Each round is three dispatches: the ``[N, E]`` probe of the
        requests still pending (:func:`~repro_torch.core.ensemble.
        find_allocations_ensemble`; a request no longer pending cannot
        change the round's scan, so its row is not searched), the
        :func:`_match_scan` assignment, and one grouped commit.  The
        matcher finalizes every request whose probe row provably equals
        a fresh sequential probe; the rest re-probe next round.  When
        the rounds stop paying (resolution slows, ``match_max_rounds``
        is reached, the lanes auto-release so probe staleness is no
        longer monotone, or ``match_max_rounds`` is 0, the auto choice)
        the remainder goes through the fused sequential matcher
        (:func:`~repro_torch.core.ensemble.match_stream_ensemble`) in
        one dispatch.  Decisions equal the sequential probe-commit
        oracle's for every policy.
        """
        n_req = len(requests)
        pending = np.ones(n_req, bool)
        allocs: List[Optional[Allocation]] = [None] * n_req
        rounds = 0
        # the rounds protocol proves probe rows fresh from commits only
        # ever *adding* occupancy; auto-releasing lanes violate that,
        # so they go straight to the fused matcher
        if not self.auto_release and self.match_max_rounds > 0:
            window_local = policy in _WINDOW_LOCAL_POLICIES
            monotone = policy == Policy.FF
            t_r = np.array([r.t_r for r in requests], np.int64)
            t_dl = np.array([r.t_dl for r in requests], np.int64)
            E = self.n_partitions
            while pending.any() and rounds < self.match_max_rounds:
                rounds += 1
                live = int(pending.sum())
                idx = np.flatnonzero(pending)
                res = self._probe_all(self.stage_requests(
                    [requests[i] for i in idx]), policy)
                self.dispatches += 1
                found = np.zeros((n_req, E), bool)
                t_s = np.zeros((n_req, E), np.int64)
                t_e = np.zeros((n_req, E), np.int64)
                found[idx], t_s[idx], t_e[idx] = res.found, res.t_s, res.t_e
                lanes, rejects = _match_scan(found, t_s, t_e, t_r, t_dl,
                                             pending, window_local,
                                             monotone)
                self.dispatches += 1
                take = lanes >= 0
                pending &= ~(rejects | take)
                sel = np.flatnonzero(take)
                if sel.size:
                    committed = self._commit_grouped(
                        [requests[i] for i in sel], lanes[sel].tolist(),
                        policy)
                    for i, alloc in zip(sel, committed):
                        allocs[i] = alloc
                if live - int(pending.sum()) < max(1, live // 4):
                    break      # colliding tail: the fused matcher is cheaper
        if pending.any():
            idx = np.flatnonzero(pending)
            tail = [requests[i] for i in idx]
            if self.auto_release:
                # pad to a power of two as the reference does: with
                # auto-release a filler step runs every lane's release
                # and queue work, so the lanes end where the
                # reference's do
                fill = batch_lib.filler_request(self.chips_per_part,
                                                tail[-1].t_a)
                tail = tail + [fill] * (tl_lib.next_pow2(len(tail))
                                        - len(tail))
            self.states, lanes_d, decs_d = ens_lib.match_stream_ensemble_auto(
                self.states, self.stage_requests(tail),
                policy_index(policy), n_pe=self.chips_per_part,
                backfills=self._backfills, auto_release=self.auto_release,
                use_kernel=self.use_kernel, stats=self.stats)
            self.dispatches += 1
            lanes = lanes_d.cpu().numpy()
            decs = ens_lib.to_host(decs_d, self.stats)   # one read
            self.stats.sync()
            for k, i in enumerate(idx):
                lane = int(lanes[k])
                if lane < 0:
                    continue
                alloc = self._globalize(lane, batch_lib.decision_to_allocation(
                    batch_lib.Decision(*(x[k] for x in decs))))
                if alloc is not None:
                    self._load_host[lane] += np.float32(
                        (alloc.t_e - alloc.t_s) * len(alloc.pe_ids))
                allocs[i] = alloc
        self.last_match_rounds = rounds
        return allocs

    def admit_stream_allocations(
        self, requests: Sequence[ARRequest], policy: Policy,
        routing: str = "round_robin",
    ) -> List[Optional[Allocation]]:
        """Bulk admission across partitions.

        ``round_robin`` / ``least_loaded`` route up front (host cursor /
        load scan) and admit every lane's stream in one grouped
        admission.  ``best_acceptance`` runs the batched matcher
        (:meth:`_admit_best_acceptance`), decision-identical to
        sequential probing.  Completion release stays with the caller
        unless the core was built with ``auto_release=True``.
        """
        if not requests:
            return []
        if routing == "best_acceptance":
            return self._admit_best_acceptance(list(requests), policy)
        lanes = self.route(requests, routing)
        return self._commit_grouped(requests, lanes, policy)

    # -- debug / test view -------------------------------------------------
    def records(self) -> List[tuple]:
        """Merged (time, busy-global-card-set) view across partitions."""
        dev = ens_lib.home(self.states)
        times = ens_lib.gather([s.tl.times for s in self.states],
                               dev).cpu().numpy()
        occ = ens_lib.gather([s.tl.occ for s in self.states],
                             dev).cpu().numpy()
        return merge_records([
            [(int(t), frozenset(p + lane * self.chips_per_part
                                for p in batch_lib.mask32_to_ids(o)))
             for t, o in zip(times[lane], occ[lane]) if t < T_INF]
            for lane in range(self.n_partitions)])


class FleetScheduler:
    """Admission control for the card fleet, a
    :class:`~repro_torch.api.ReservationService` client.

    The fleet owns job bookkeeping, fault handling and completion
    release (``advance``); all reservation decisions go through one
    service session.  Completion release stays with the fleet
    (``auto_release=False``), bulk admission uses one-shot
    :meth:`~repro_torch.api.Session.offer` calls, and the classic three
    operations reach the underlying engine via ``session.engine`` (kept
    as ``self.core``).  ``engine`` defaults to ``"device"`` (the
    reference's default is ``"host"``); the device engine and
    partitioned fleets keep their state on ``device`` (``None`` is
    cuda), and ``engine="host"`` / ``"list"`` run the CPU engines.
    """

    def __init__(self, n_chips: int = 512,
                 policy: Policy = Policy.PE_W,
                 engine: Optional[str] = None,
                 repair_seconds: int = 1800,
                 restart_overhead: int = 120,
                 n_partitions: int = 1,
                 routing: str = "round_robin",
                 use_kernel: bool = True,
                 index_tile: Optional[int] = None,
                 device: DeviceLike = None):
        self.n_chips = n_chips
        self.policy = policy
        if n_partitions > 1:
            if engine is not None:
                raise ValueError(
                    "a partitioned fleet is always device-backed "
                    "(one ensemble of lanes); drop the engine argument")
            cfg = ServiceConfig(
                n_pe=n_chips, engine="device", policy=policy,
                n_partitions=n_partitions, routing=routing,
                use_kernel=use_kernel, auto_release=False,
                chunk_size=None, index_tile=index_tile, device=device)
        else:
            engine = engine or "device"
            if index_tile is not None and engine != "device":
                raise ValueError("index_tile needs the device engine")
            cfg = ServiceConfig.from_engine_kwargs(
                n_chips, engine,
                **({"use_kernel": use_kernel, "device": device}
                   if engine == "device" else {})
            ).replace(policy=policy, auto_release=False,
                      chunk_size=None, index_tile=index_tile)
        self.service = ReservationService(cfg)
        self.session = self.service.session()
        self.core = self.session.engine
        self.n_partitions = n_partitions
        self.routing = routing
        self.repair_seconds = repair_seconds
        self.restart_overhead = restart_overhead
        self.jobs: Dict[int, FleetJob] = {}
        self._ids = itertools.count()
        self.now = 0
        self.events: List[tuple] = []     # (time, kind, job_id) log

    # ------------------------------------------------------------------
    def advance(self, t: int) -> None:
        """Move the fleet clock; complete reservations that finished."""
        assert t >= self.now
        self.now = t
        for job in self.jobs.values():
            if job.state in (JobState.RESERVED, JobState.RUNNING):
                if job.t_start <= t and job.state == JobState.RESERVED:
                    job.state = JobState.RUNNING
                if job.t_end <= t:
                    job.work_done = job.t_end - job.t_start
                    job.state = JobState.DONE
                    self.core.delete_allocation(
                        job.t_start, job.t_end, list(job.chips))
                    self.events.append((t, "complete", job.job_id))

    # ------------------------------------------------------------------
    def _build_job(self, arch: str, shape: str, n_chips: int,
                   n_steps: int, ready: Optional[int] = None,
                   deadline_slack: float = 2.0):
        """Shared job/request construction for submit and submit_batch."""
        dur = estimate_duration(arch, shape, n_chips, n_steps)
        ready = self.now if ready is None else ready
        deadline = ready + int(dur * (1.0 + deadline_slack))
        job = FleetJob(
            job_id=next(self._ids), arch=arch, shape=shape,
            n_chips=n_chips, n_steps=n_steps, submit_time=self.now,
            ready=ready, deadline=deadline)
        req = ARRequest(t_a=self.now, t_r=ready, t_du=dur,
                        t_dl=deadline, n_pe=n_chips)
        return job, req

    def _place(self, job: FleetJob, alloc: Allocation) -> None:
        """Record the job's reservation (and its partition)."""
        job.t_start, job.t_end = alloc.t_s, alloc.t_e
        job.chips = alloc.pe_ids
        if self.n_partitions > 1:
            job.partition = alloc.pe_ids[0] // self.core.chips_per_part

    def _record_decision(self, job: FleetJob,
                         alloc, committed: bool) -> FleetJob:
        """Book-keep one admission outcome (alloc already committed
        when ``committed``; otherwise commit it here)."""
        if alloc is None:
            job.state = JobState.REJECTED
            self.events.append((self.now, "reject", job.job_id))
        else:
            if not committed:
                self.core.add_allocation(alloc.t_s, alloc.t_e,
                                         list(alloc.pe_ids))
            self._place(job, alloc)
            self.events.append((self.now, "reserve", job.job_id))
        self.jobs[job.job_id] = job
        return job

    def submit(self, arch: str, shape: str, n_chips: int,
               n_steps: int, ready: Optional[int] = None,
               deadline_slack: float = 2.0,
               policy: Optional[Policy] = None) -> FleetJob:
        """Admission-control one job; returns it (possibly REJECTED)."""
        job, req = self._build_job(arch, shape, n_chips, n_steps,
                                   ready, deadline_slack)
        alloc = self.core.find_allocation(
            req, policy or self.policy, t_now=self.now)
        return self._record_decision(job, alloc, committed=False)

    # ------------------------------------------------------------------
    def submit_batch(self, specs: Sequence[Dict],
                     policy: Optional[Policy] = None,
                     routing: Optional[str] = None) -> List[FleetJob]:
        """Bulk admission control: one session offer for many jobs.

        Each spec is a dict with the keyword arguments of :meth:`submit`
        (``arch``, ``shape``, ``n_chips``, ``n_steps``, optional
        ``ready`` / ``deadline_slack``).

        On a partitioned fleet the batch is routed across partitions
        (``routing`` overrides the fleet default: round robin, least
        loaded, or best-acceptance probes) and all partitions admit in
        one grouped admission.  On a device engine the whole batch is
        one session :meth:`~repro_torch.api.Session.offer`; decisions
        are identical to sequential submission because the stream
        commits each accepted job before considering the next.
        Host/list engines admit through the same verb.  Completion
        release stays with :meth:`advance` (``auto_release=False``).
        """
        pol = policy or self.policy
        built = [self._build_job(**spec) for spec in specs]
        res = self.session.offer(
            [req for _, req in built], policy=pol,
            routing=(routing or self.routing)
            if self.n_partitions > 1 else None)
        return [self._record_decision(job, alloc, committed=True)
                for (job, _), alloc in zip(built, res.allocations())]

    # ------------------------------------------------------------------
    def submit_malleable(self, arch: str, shape: str,
                         chip_options: List[int], n_steps: int,
                         ready: Optional[int] = None,
                         deadline: Optional[int] = None) -> FleetJob:
        """Malleable AR job (paper Section 7): the request's PE count is
        not fixed.  As the paper proposes, the malleable requirement is
        *translated into a group of rigid requests* (one per card count,
        with the duration rescaled by the roofline model) and
        ``findAllocation`` evaluates each; the completion-time-earliest
        feasible allocation wins (the "new criterion" the paper leaves
        open: earliest finish keeps the most fleet flexibility).  Each
        rigid variant is searched with FF so that the cross-variant
        earliest-finish comparison is coherent.
        """
        ready = self.now if ready is None else ready
        best = None           # (finish_time, alloc, n_chips, dur)
        durations = {n: estimate_duration(arch, shape, n, n_steps)
                     for n in chip_options}
        dl = deadline if deadline is not None else \
            ready + int(2.0 * max(durations.values()))
        for n_chips in sorted(chip_options):
            dur = durations[n_chips]
            if ready + dur > dl:
                continue      # this rigid variant cannot meet the SLO
            req = ARRequest(t_a=self.now, t_r=ready, t_du=dur,
                            t_dl=dl, n_pe=n_chips)
            alloc = self.core.find_allocation(req, Policy.FF,
                                              t_now=self.now)
            if alloc is None:
                continue
            finish = alloc.t_s + dur
            if best is None or finish < best[0]:
                best = (finish, alloc, n_chips, dur)
        job = FleetJob(
            job_id=next(self._ids), arch=arch, shape=shape,
            n_chips=best[2] if best else min(chip_options),
            n_steps=n_steps, submit_time=self.now, ready=ready,
            deadline=dl)
        if best is None:
            job.state = JobState.REJECTED
            self.events.append((self.now, "reject-malleable",
                                job.job_id))
        else:
            _, alloc, n_chips, dur = best
            self.core.add_allocation(alloc.t_s, alloc.t_e,
                                     list(alloc.pe_ids))
            self._place(job, alloc)
            self.events.append((self.now, "reserve-malleable",
                                job.job_id))
        self.jobs[job.job_id] = job
        return job

    # ------------------------------------------------------------------
    def _release(self, job: FleetJob) -> None:
        self.core.delete_allocation(job.t_start, job.t_end,
                                    list(job.chips))
        job.chips = ()

    def _resubmit_remainder(self, job: FleetJob, extra_duration: int = 0,
                            n_chips: Optional[int] = None) -> bool:
        """Re-reserve the job's remaining work within its deadline."""
        done = max(0, min(self.now, job.t_end) - job.t_start)
        ckpt_done = (done // job.checkpoint_interval) \
            * job.checkpoint_interval
        total = job.t_end - job.t_start
        remaining = total - ckpt_done + self.restart_overhead \
            + extra_duration
        n_chips = n_chips or job.n_chips
        if n_chips != job.n_chips:
            frac = remaining / max(total, 1)
            full = estimate_duration(job.arch, job.shape, n_chips,
                                     job.n_steps)
            remaining = int(full * frac) + self.restart_overhead
        if self.now + remaining > job.deadline:
            job.state = JobState.FAILED
            self.events.append((self.now, "deadline-miss", job.job_id))
            return False
        req = ARRequest(t_a=self.now, t_r=self.now, t_du=remaining,
                        t_dl=job.deadline, n_pe=n_chips)
        alloc = self.core.find_allocation(req, self.policy,
                                          t_now=self.now)
        if alloc is None:
            job.state = JobState.FAILED
            self.events.append((self.now, "no-capacity", job.job_id))
            return False
        self.core.add_allocation(alloc.t_s, alloc.t_e,
                                 list(alloc.pe_ids))
        self._place(job, alloc)
        job.n_chips = n_chips
        job.preemptions += 1
        job.state = JobState.RESERVED if alloc.t_s > self.now \
            else JobState.RUNNING
        self.events.append((self.now, "re-reserve", job.job_id))
        return True

    # ------------------------------------------------------------------
    def fail_chip(self, chip_id: int) -> List[int]:
        """Hardware failure: repair-reserve the card, migrate its jobs."""
        affected = [j for j in self.jobs.values()
                    if chip_id in j.chips
                    and j.state in (JobState.RESERVED, JobState.RUNNING)]
        for job in affected:
            self._release(job)
        # the card is unavailable while under repair
        self.core.add_allocation(
            self.now, self.now + self.repair_seconds, [chip_id])
        self.events.append((self.now, "chip-fail", chip_id))
        migrated = []
        for job in affected:
            if self._resubmit_remainder(job):
                migrated.append(job.job_id)
        return migrated

    def report_straggler(self, job_id: int,
                         slowdown: float = 1.5) -> bool:
        """The job is running ``slowdown``x slower than reserved:
        stretch its reservation into the deadline slack."""
        job = self.jobs[job_id]
        if job.state not in (JobState.RUNNING, JobState.RESERVED):
            return False
        remaining = max(job.t_end - self.now, 0)
        extra = int(remaining * (slowdown - 1.0))
        self._release(job)
        self.events.append((self.now, "straggler", job_id))
        return self._resubmit_remainder(job, extra_duration=extra)

    def rescale(self, job_id: int, new_n_chips: int) -> bool:
        """Elastic scaling: move the remaining work to a new footprint."""
        job = self.jobs[job_id]
        if job.state not in (JobState.RUNNING, JobState.RESERVED):
            return False
        self._release(job)
        self.events.append((self.now, "rescale", job_id))
        return self._resubmit_remainder(job, n_chips=new_n_chips)

    # ------------------------------------------------------------------
    def utilisation(self, horizon: int) -> float:
        area = sum(
            (min(j.t_end, self.now + horizon) - max(j.t_start, self.now))
            * j.n_chips
            for j in self.jobs.values()
            if j.state in (JobState.RESERVED, JobState.RUNNING)
            and j.t_end > self.now)
        return area / (self.n_chips * horizon)

    def summary(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for j in self.jobs.values():
            out[j.state.value] = out.get(j.state.value, 0) + 1
        return out
