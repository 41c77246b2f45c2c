"""Ensemble axis: E independent scheduler timelines stepped together.

The port's copy of ``repro/core/ensemble.py``.  The reference stacks E
lanes into one ``SchedulerState`` with a leading axis and steps them
with ``jax.vmap``.  The port's admit step cannot be vmapped: request fields
become kernel arguments and the release loop, the deferral queue and
the quota gate branch on host reads.  So an ensemble here is a tuple of
one-lane :class:`~repro_torch.core.timeline.SchedulerState` s, and each
lane runs the one-lane admission (:func:`~repro_torch.core.batch.
admit_stream`) on its row of the ``[E, N]`` batch, one lane after
another.  Lanes are independent, so this decides what vmap's lockstep
decides; decisions stack to ``[E, N]``.  Every kernel of the step then
runs once per lane per step.

Lanes share one capacity, as the reference's shared static shape
makes them: growth is collective.  The auto wrapper reads every lane's
high-water marks after an overflowing run, grows all lanes once to the
worst lane's need, and re-runs every lane from the pre-run snapshot.
Lanes that did not overflow reproduce their decisions exactly.

The partitioned fleet (:mod:`repro_torch.runtime.fleet`) probes
requests against every lane without committing
(:func:`find_allocation_ensemble`, and the ``[N, E]`` probe
:func:`find_allocations_ensemble`, each row against the same pre-batch
lanes) and matches a stream to its earliest lanes
(:func:`match_stream_ensemble`).  A probe is E searches (N x E for the
batch) in turn; on indexed lanes every early-reject predicate of the
probe crosses to the host in one read.

Lanes may live on different cards (``ServiceConfig.placement``,
:func:`repro_torch.sharding.rules.shard_ensemble`): each lane's step
runs on its card with its row of the batch moved there, and every
cross-lane read (decisions, latches, high-water marks, the probe)
gathers the lanes' values on lane 0's card (:func:`gather`).  On one
card these moves copy nothing.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import batch as batch_lib
from repro_torch.core import search as search_lib
from repro_torch.core import timeline as tl_lib
from repro_torch.core.batch import Decision, RequestBatch, StreamStats
from repro_torch.core.search import SearchResult
from repro_torch.core.policies import policy_index
from repro_torch.core.timeline import SchedulerState
from repro_torch.core.types import T_INF, backfill_index
from repro_torch.device import DeviceLike, to_device

Ensemble = Tuple[SchedulerState, ...]


def init_ensemble(n_ensemble: int, capacity: int, n_pe: int,
                  pending_capacity: int = 256, park_capacity: int = 0,
                  tenants=None, rspec=None, machine_units=None,
                  index_tile: Optional[int] = None,
                  device: DeviceLike = None) -> Ensemble:
    """E fresh all-free lanes of equal capacities.

    ``tenants`` is one :class:`~repro_torch.tenancy.TenantTable` shared
    by every lane (states are never written in place, so sharing is
    safe), or one table per lane (:func:`~repro_torch.tenancy.
    lane_tables` pads heterogeneous specs to one width).  ``rspec``
    installs a shared multi-resource layout; ``machine_units`` (one
    live-unit tuple per lane) then gives each lane its own valid mask
    over the same word layout.  ``index_tile`` attaches the
    availability index to every lane.
    """
    if machine_units is not None:
        if rspec is None:
            raise ValueError("machine_units requires rspec")
        if len(machine_units) != n_ensemble:
            raise ValueError(f"{len(machine_units)} machine_units entries "
                             f"for {n_ensemble} lanes")
    if tenants is None or hasattr(tenants, "n_tenants"):
        tables = [tenants] * n_ensemble
    else:
        tables = list(tenants)
        if len(tables) != n_ensemble:
            raise ValueError(f"{len(tables)} tenant tables for "
                             f"{n_ensemble} lanes")
    return tuple(
        tl_lib.init_state(
            capacity, n_pe, pending_capacity, device,
            park_capacity=park_capacity, rspec=rspec,
            live_units=None if machine_units is None else machine_units[e],
            index_tile=index_tile, tenants=tables[e])
        for e in range(n_ensemble))


def stack_states(states: Sequence[SchedulerState]) -> Ensemble:
    """One-lane states of one layout -> an ensemble."""
    states = tuple(states)
    caps = {(s.tl.capacity, s.pending_capacity, s.park_capacity)
            for s in states}
    if len(caps) > 1:
        raise ValueError(f"lanes must share their capacities, got {caps}")
    return states


def member(states: Ensemble, i: int) -> SchedulerState:
    """Lane ``i`` as a one-lane state."""
    return states[i]


def set_member(states: Ensemble, i: int, lane: SchedulerState) -> Ensemble:
    """The ensemble with lane ``i`` replaced by ``lane``."""
    return states[:i] + (lane,) + states[i + 1:]


def ensemble_size(states: Ensemble) -> int:
    return len(states)


def lane_capacity(states: Ensemble) -> Tuple[int, int]:
    """(timeline capacity, pending capacity) of each lane."""
    return states[0].tl.capacity, states[0].pending_capacity


def _host_ids(ids) -> List[int]:
    if isinstance(ids, torch.Tensor):
        return [int(x) for x in ids.cpu().tolist()]
    return [int(x) for x in ids]


def policy_ids(policies) -> Tuple[int, ...]:
    """Per-lane policy ids (host integers) from policies or ids."""
    if isinstance(policies, torch.Tensor):
        return tuple(_host_ids(policies))
    return tuple(p if isinstance(p, (int, np.integer)) else policy_index(p)
                 for p in policies)


def backfill_ids(modes, n_ensemble: int) -> Tuple[int, ...]:
    """Per-lane backfill-mode ids from one mode or one per lane."""
    if modes is None:
        return (0,) * n_ensemble
    if isinstance(modes, torch.Tensor):
        return tuple(_host_ids(modes))
    if isinstance(modes, (str, int, np.integer)) or not hasattr(
            modes, "__len__"):
        return (backfill_index(modes),) * n_ensemble
    return tuple(backfill_index(m) for m in modes)


def lane_of(batch, e: int):
    """Row ``e`` of an ``[E, ...]`` batch or decision: lane ``e``'s."""
    return type(batch)(*(None if x is None else x[e] for x in batch))


def home(states: Ensemble) -> torch.device:
    """The device cross-lane results are gathered on: lane 0's."""
    return states[0].tl.device


def gather(xs: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Per-lane tensors stacked on ``device`` (lanes placed on other
    cards are copied there first)."""
    return torch.stack([x.to(device) for x in xs])


def _stack_decisions(decs: Sequence[Decision], device) -> Decision:
    return Decision(*(gather(f, device) for f in zip(*decs)))


def _lane_args(states, pids, bids):
    pids = _host_ids(pids)
    bids = (0,) * len(states) if bids is None else _host_ids(bids)
    if not len(pids) == len(bids) == len(states):
        raise ValueError(f"{len(pids)} policies and {len(bids)} backfill "
                         f"modes for {len(states)} lanes")
    return pids, bids


def admit_ensemble(states: Ensemble, reqs: RequestBatch, pids, bids=None,
                   *, n_pe: int, auto_release: bool = True,
                   use_kernel: bool = True,
                   stats: Optional[StreamStats] = None
                   ) -> Tuple[Ensemble, Decision]:
    """One admission step on every lane; ``reqs`` fields are ``[E]``.

    ``pids`` gives every lane its policy, ``bids`` (optional) its
    backfill mode.
    """
    pids, bids = _lane_args(states, pids, bids)
    out, decs = [], []
    for e, s in enumerate(states):
        s, dec = batch_lib.admit(
            s, to_device(lane_of(reqs, e), s.tl.device), pids[e], bids[e],
            n_pe=n_pe, auto_release=auto_release, use_kernel=use_kernel,
            stats=stats)
        out.append(s)
        decs.append(dec)
    return tuple(out), _stack_decisions(decs, home(states))


def admit_stream_ensemble(states: Ensemble, batches: RequestBatch, pids,
                          bids=None, *, n_pe: int, auto_release: bool = True,
                          use_kernel: bool = True,
                          stats: Optional[StreamStats] = None
                          ) -> Tuple[Ensemble, Decision]:
    """Run each lane's row of an ``[E, N]`` batch through that lane.

    The rows are per-lane arrival-ordered streams padded to one length
    with never-feasible requests (:func:`~repro_torch.core.batch.
    pad_streams`).  Returns the lanes and the ``[E, N]`` decisions.
    """
    pids, bids = _lane_args(states, pids, bids)
    out, decs = [], []
    for e, s in enumerate(states):
        s, dec = batch_lib.admit_stream(
            s, to_device(lane_of(batches, e), s.tl.device), pids[e],
            bids[e], n_pe=n_pe, auto_release=auto_release,
            use_kernel=use_kernel, stats=stats)
        out.append(s)
        decs.append(dec)
    return tuple(out), _stack_decisions(decs, home(states))


def admit_stream_ensemble_donated(
        states: Ensemble, batches: RequestBatch, pids, bids=None, *,
        n_pe: int, auto_release: bool = True, use_kernel: bool = True,
        stats: Optional[StreamStats] = None) -> Tuple[Ensemble, Decision]:
    """:func:`admit_stream_ensemble` with the reference's latched rollback.

    An overflow on any lane returns the whole ensemble as it entered,
    every lane carrying its latch (set where that lane overflowed, now
    or before) and the elementwise max of its high-water marks, with
    no host read.  The latch is sticky: a call entered with any lane
    latched leaves the ensemble as it found it.  Its decisions are
    garbage and must be discarded.
    """
    outs, dec = admit_stream_ensemble(
        states, batches, pids, bids, n_pe=n_pe, auto_release=auto_release,
        use_kernel=use_kernel, stats=stats)
    ovfs = [s.overflow | o.overflow for s, o in zip(states, outs)]
    anyo = gather(ovfs, home(states)).any()
    return tuple(
        batch_lib._where_state(anyo.to(s.tl.device), s, o)._replace(
            overflow=v, hw_records=torch.maximum(s.hw_records, o.hw_records),
            hw_pending=torch.maximum(s.hw_pending, o.hw_pending))
        for s, o, v in zip(states, outs, ovfs)), dec


def _any_overflow(states: Ensemble, stats: Optional[StreamStats] = None
                 ) -> bool:
    """One host read: is any lane's overflow latch set?"""
    flag = bool(gather([s.overflow for s in states], home(states)).any())
    if stats is not None:
        stats.sync()
    return flag


def grow_ensemble(states: Ensemble, new_capacity: int,
                  new_pending_capacity: int) -> Ensemble:
    """Collective capacity growth of every lane."""
    return tuple(tl_lib.grow_state(s, new_capacity=new_capacity,
                                   new_pending_capacity=new_pending_capacity)
                 for s in states)


def _grown(start: Ensemble, run: Ensemble,
           stats: Optional[StreamStats] = None) -> Ensemble:
    """Grow ``start`` once to the worst lane's need in ``run``.

    The marks of every lane cross in one read.
    """
    hw = gather([s.hw_records for s in run] + [s.hw_pending for s in run],
                home(run)).cpu().numpy()
    E = len(run)
    if stats is not None:
        stats.sync()
        stats.growths += 1
    new_cap, new_pend = batch_lib.grown_capacities(
        member(start, 0), int(hw[:E].max()), int(hw[E:].max()))
    return grow_ensemble(start, new_cap, new_pend)


def grow_rollback_ensemble(states: Ensemble,
                           stats: Optional[StreamStats] = None) -> Ensemble:
    """Grow a rolled-back (latched) ensemble and clear every latch.

    A donated overflow returned the pre-run lanes carrying the failed
    run's marks, so they are their own growth reference.
    """
    out = _grown(states, states, stats)
    return tuple(s._replace(overflow=torch.zeros_like(s.overflow))
                 for s in out)


def release_due_ensemble(states: Ensemble, t_now: int,
                         stats: Optional[StreamStats] = None) -> Ensemble:
    """:func:`~repro_torch.core.batch.release_due` on every lane."""
    return tuple(batch_lib.release_due(s, t_now, stats) for s in states)


def reap_step_ensemble(states: Ensemble, t_now: int, graces,
                       stats: Optional[StreamStats] = None) -> Ensemble:
    """:func:`~repro_torch.core.batch.reap_step` on every lane, each with
    its own grace.  A lane with a ``T_INF`` grace has nothing overdue
    (its cutoff precedes every time) and is left as it is."""
    return tuple(s if g >= T_INF else batch_lib.reap_step(s, t_now, g, stats)
                 for s, g in zip(states, graces))


def _until(step, states: Ensemble, what: str, max_growths: int,
           stats: Optional[StreamStats]) -> Ensemble:
    """Run ``step`` on every lane, growing all lanes on any overflow."""
    start = states
    for attempt in range(max_growths + 1):
        out = step(start)
        if not _any_overflow(out, stats):
            return out
        if attempt < max_growths:
            start = _grown(start, out, stats)
    cap, pend = lane_capacity(start)
    raise batch_lib.GrowthError(
        f"{what} still overflowing after {max_growths + 1} attempts (last "
        f"tried capacity {cap}, pending {pend})")


def release_until_ensemble(states: Ensemble, t_now: int, *,
                           max_growths: int = batch_lib.MAX_DOUBLINGS,
                           stats: Optional[StreamStats] = None) -> Ensemble:
    """Every lane releases its reservations ending by ``t_now``.

    An overflow on any lane (a deletion splitting a merged record)
    grows all lanes once to the worst watermark and re-runs from the
    pre-call lanes; ``max_growths=0`` raises on the first overflow.
    """
    return _until(lambda s: release_due_ensemble(s, t_now, stats), states,
                  "release_until_ensemble", max_growths, stats)


def reap_until_ensemble(states: Ensemble, t_now: int, grace, *,
                        max_growths: int = batch_lib.MAX_DOUBLINGS,
                        stats: Optional[StreamStats] = None) -> Ensemble:
    """Per-lane overdue reaping with collective growth.

    ``grace`` is one window for all lanes or one per lane; ``T_INF``
    disables a lane.
    """
    E = ensemble_size(states)
    graces = ([int(grace)] * E if np.ndim(grace) == 0
              else [int(g) for g in grace])
    return _until(lambda s: reap_step_ensemble(s, t_now, graces, stats),
                  states, "reap_until_ensemble", max_growths, stats)


def admit_stream_ensemble_auto(
        states: Ensemble, batches: RequestBatch, policies, *, n_pe: int,
        backfills=None, auto_release: bool = True, use_kernel: bool = True,
        max_growths: int = batch_lib.MAX_DOUBLINGS, donate: bool = False,
        stats: Optional[StreamStats] = None) -> Tuple[Ensemble, Decision]:
    """:func:`admit_stream_ensemble`, growing on any lane's overflow.

    On overflow every lane grows once to the worst lane's high-water
    marks and the whole batch re-runs from the pre-run lanes, so the
    result equals E independent growing runs.  ``max_growths=0``
    raises on the first overflow, changing nothing.  ``donate=True``
    runs :func:`admit_stream_ensemble_donated`: retries grow the
    rolled-back lanes, and a terminal overflow raises
    :class:`~repro_torch.core.batch.GrowthError` carrying them.
    Decisions are the same either way.
    """
    pids = policy_ids(policies)
    bids = backfill_ids(backfills, len(pids))
    fn = admit_stream_ensemble_donated if donate else admit_stream_ensemble
    start = states
    for attempt in range(max_growths + 1):
        out, dec = fn(start, batches, pids, bids, n_pe=n_pe,
                      auto_release=auto_release, use_kernel=use_kernel,
                      stats=stats)
        if not _any_overflow(out, stats):
            return out, dec
        if attempt < max_growths:
            start = grow_rollback_ensemble(out, stats) if donate \
                else _grown(start, out, stats)
    cap, pend = lane_capacity(out if donate else start)
    raise batch_lib.GrowthError(
        f"admit_stream_ensemble still overflowing after {max_growths + 1} "
        f"attempts (last tried capacity {cap}, pending {pend})",
        state=out if donate else None)


# -- the fleet's probe and matcher ------------------------------------------


def to_host(nt, stats: Optional[StreamStats] = None):
    """A :class:`Decision` or :class:`~repro_torch.core.search.
    SearchResult` of tensors with one leading shape, as numpy arrays, in
    one read (``bool`` fields stay ``bool``)."""
    lead = tuple(nt[0].shape)
    parts = [x.reshape(lead + (-1,)).to(torch.int32) for x in nt]
    host = torch.cat(parts, dim=-1).cpu().numpy()
    if stats is not None and nt[0].device.type != "cpu":
        stats.sync()
    out, k = [], 0
    for x, p in zip(nt, parts):
        w = p.shape[-1]
        v = host[..., k:k + w].reshape(tuple(x.shape))
        out.append(v.astype(bool) if x.dtype == torch.bool else v)
        k += w
    return type(nt)(*out)


def _host_rows(reqs, stats: Optional[StreamStats]) -> np.ndarray:
    """The request columns of a batch (or a 0-d struct, or an
    :class:`~repro_torch.core.types.ARRequest`) as host integers:
    ``int64[N, 5]`` (``[5]`` for one request), in one read."""
    if not isinstance(reqs, RequestBatch):
        return np.asarray(batch_lib._field_tuple(reqs), np.int64)
    cols = torch.stack([getattr(reqs, f) for f in batch_lib.REQ_FIELDS])
    host = cols.cpu().numpy().astype(np.int64)
    if stats is not None and cols.device.type != "cpu":
        stats.sync()
    return host.T


def _demands(states: Ensemble, reqs, n: Optional[int]) -> list:
    """Per-row secondary-plane demands on the lanes' device (``None``
    per row on single-resource lanes; ``n`` is None for one request)."""
    if states[0].rspec is None:
        return [None] * (n or 1)
    if n is None:
        return [batch_lib.request_demand(states[0], reqs)]
    dev = states[0].tl.device
    if reqs.demand is None:
        return [None] * n
    dem = reqs.demand.to(device=dev, dtype=tl_lib.I32)
    return [dem[i] for i in range(n)]


def _probe(states: Ensemble, rows: np.ndarray, demands: list, pid: int, *,
           n_pe: int, use_kernel: bool,
           stats: Optional[StreamStats]) -> List[List[SearchResult]]:
    """Search every row against every lane, committing nothing.

    On indexed lanes every (row, lane) early-reject predicate is
    computed first and all of them cross to the host in one read; the
    searches then take their row of it.
    """
    rejects = None
    if states[0].tl.ispec is not None and len(rows):
        flags = gather([
            search_lib.index_reject(
                s.tl, int(r[1]), int(r[2]), int(r[3]), int(r[4]),
                rspec=s.rspec, demand_tail=to_device(d, s.tl.device),
                valid_mask=s.lane_valid)
            for r, d in zip(rows, demands) for s in states], home(states))
        rejects = flags.cpu().numpy().reshape(len(rows), len(states))
        if stats is not None:
            stats.sync()
    out = []
    for i, (r, d) in enumerate(zip(rows, demands)):
        t_a, t_r, t_du, t_dl, n_req = (int(x) for x in r)
        lane_res = []
        for e, s in enumerate(states):
            rej = None if rejects is None else bool(rejects[i, e])
            lane_res.append(search_lib.search(
                s.tl, t_r, t_du, t_dl, n_req, pid, t_a, n_pe=n_pe,
                use_kernel=use_kernel, rspec=s.rspec,
                demand_tail=to_device(d, s.tl.device),
                valid_mask=s.lane_valid, reject=rej))
            if stats is not None:
                if rej:
                    stats.probe_rejects += 1
                else:
                    stats.probe_searches += 1
        out.append(lane_res)
    return out


def _stack_results(results: Sequence[SearchResult], lead: Tuple[int, ...],
                   device: torch.device) -> SearchResult:
    return SearchResult(*(gather(f, device).reshape(lead + tuple(f[0].shape))
                          for f in zip(*results)))


def find_allocation_ensemble(states: Ensemble, req, pid, *, n_pe: int,
                             use_kernel: bool = True,
                             stats: Optional[StreamStats] = None
                             ) -> SearchResult:
    """Probe one request against every lane's timeline (no commit).

    ``req`` is an :class:`~repro_torch.core.types.ARRequest` or a 0-d
    :func:`~repro_torch.core.batch.request_struct`; its ``t_a`` is the
    search's "now".  Returns a :class:`SearchResult` with ``[E]``
    leaves: the fleet's best-acceptance probe.
    """
    row = _host_rows(req, stats)
    res = _probe(states, row[None, :], _demands(states, req, None),
                 batch_lib._policy_id(pid), n_pe=n_pe, use_kernel=use_kernel,
                 stats=stats)
    return _stack_results(res[0], (len(states),), home(states))


def find_allocations_ensemble(states: Ensemble, reqs: RequestBatch, pid, *,
                              n_pe: int, use_kernel: bool = True,
                              stats: Optional[StreamStats] = None
                              ) -> SearchResult:
    """Probe N requests against every lane's timeline (no commit).

    The fleet's request-batched probe: a :class:`SearchResult` with
    ``[N, E]`` leaves, row i being request i's feasibility, start and
    rectangle on every lane, all against the *same* pre-batch lanes.
    Each row uses its own request's ``t_a`` as "now", as a sequential
    probe at arrival time would.  The rows cross to the host in one
    read.
    """
    rows = _host_rows(reqs, stats)
    n, E = len(rows), len(states)
    if n == 0:
        s0 = states[0]
        dev = s0.tl.device
        z = torch.zeros((0, E), dtype=tl_lib.I32, device=dev)
        return SearchResult(
            torch.zeros((0, E), dtype=torch.bool, device=dev), z, z,
            torch.zeros((0, E, s0.tl.words), dtype=tl_lib.I32, device=dev),
            z, z, z)
    res = _probe(states, rows, _demands(states, reqs, n),
                 batch_lib._policy_id(pid), n_pe=n_pe, use_kernel=use_kernel,
                 stats=stats)
    return _stack_results([r for lane_res in res for r in lane_res], (n, E),
                          home(states))


def match_stream_ensemble(states: Ensemble, reqs: RequestBatch, pid,
                          bids=None, *, n_pe: int, auto_release: bool = False,
                          use_kernel: bool = True,
                          stats: Optional[StreamStats] = None
                          ) -> Tuple[Ensemble, torch.Tensor, Decision]:
    """Fused sequential best-acceptance matching over an ``[N]`` stream.

    Per request, in arrival order: probe every lane, take the earliest
    feasible start among the lanes whose overflow latch is clear (ties
    to the lowest lane, as ``np.argmin``) and admit the request on that
    lane; every other lane admits the never-feasible filler carrying
    the request's arrival time, so with ``auto_release=True`` every
    lane's release clock and deferral queue still advance per arrival.
    Decisions equal N sequential ``find_allocation`` + commit
    round-trips.  The probe's starts and the latches cross to the host
    in one read per request; a lane that read showed latched is not
    probed again (its start is masked).

    With ``auto_release=False`` a filler step changes nothing on its
    lane (no release pass, no queue work, nothing feasible to commit),
    so only the lane whose decision is returned runs it.

    Returns ``(states, lanes, decisions)``: ``lanes`` is ``int32[N]``
    with the committed lane per request (``-1`` rejected) and
    ``decisions`` the per-request :class:`Decision` of that lane (lane 0
    where nothing was feasible).  An overflow latches as in
    :func:`admit_stream_ensemble`; :func:`match_stream_ensemble_auto`
    grows and re-runs.
    """
    E = len(states)
    pid = batch_lib._policy_id(pid)
    bids = (0,) * E if bids is None else tuple(_host_ids(bids))
    rows = _host_rows(reqs, stats)
    demands = _demands(states, reqs, len(rows))
    dev = states[0].tl.device
    out_lanes, decs = [], []
    states = tuple(states)
    # lanes whose latch an earlier read showed set: the latch is sticky
    # and masks the lane out of every later argmin, so its probe is not
    # searched
    latched = np.zeros(E, bool)
    for i, row in enumerate(rows):
        t_a, t_r, t_du, t_dl, n_req = (int(x) for x in row)
        live = [e for e in range(E) if not latched[e]]
        probe = dict(zip(live, _probe(
            [states[e] for e in live], row[None, :], demands[i:i + 1], pid,
            n_pe=n_pe, use_kernel=use_kernel, stats=stats)[0])) if live \
            else {}
        no = torch.zeros((), dtype=tl_lib.I32, device=dev)
        look = torch.stack([gather(
            ([probe[e].found.to(tl_lib.I32), probe[e].t_s] if e in probe
             else [no, no]) + [states[e].overflow.to(tl_lib.I32)], dev)
            for e in range(E)]).cpu().numpy()
        if stats is not None:
            stats.sync()
        latched = look[:, 2] > 0
        tv = np.where((look[:, 0] > 0) & ~latched, look[:, 1], T_INF)
        lane = int(np.argmin(tv))
        feasible = bool(tv[lane] < T_INF)
        filler = (t_a, t_a, 1, t_a + 1, n_pe + 1)
        new = list(states)
        mine = None
        for e, s in enumerate(states):
            if e != lane and not auto_release:
                continue        # a filler step would leave the lane as it is
            real = e == lane and feasible
            req = (t_a, t_r, t_du, t_dl, n_req) if real else filler
            new[e], dec = batch_lib._admit_impl(
                s, req, pid, bids[e], n_pe=n_pe, auto_release=auto_release,
                use_kernel=use_kernel, stats=stats,
                demand=to_device(demands[i], s.tl.device))
            if stats is not None:
                stats.steps += 1
            if e == lane:
                mine = to_device(dec, dev)
        states = tuple(new)
        out_lanes.append(torch.where(mine.accepted, lane, -1).to(tl_lib.I32)
                         if feasible else
                         torch.full((), -1, dtype=tl_lib.I32, device=dev))
        decs.append(mine)
    if not decs:
        W = states[0].tl.words
        z = torch.zeros((0,), dtype=tl_lib.I32, device=dev)
        b = torch.zeros((0,), dtype=torch.bool, device=dev)
        return states, z, Decision(b, z, z, torch.zeros(
            (0, W), dtype=tl_lib.I32, device=dev), z, z, z, b)
    return states, torch.stack(out_lanes), Decision(
        *(torch.stack(f) for f in zip(*decs)))


def match_stream_ensemble_auto(
        states: Ensemble, reqs: RequestBatch, pid, *, n_pe: int,
        backfills=None, auto_release: bool = False, use_kernel: bool = True,
        max_growths: int = batch_lib.MAX_DOUBLINGS,
        stats: Optional[StreamStats] = None
        ) -> Tuple[Ensemble, torch.Tensor, Decision]:
    """:func:`match_stream_ensemble` with collective overflow growth.

    As :func:`admit_stream_ensemble_auto`: an overflowing run is
    discarded, every lane grows to the worst lane's high-water marks,
    and the whole stream re-runs from the pre-call lanes; lanes that did
    not overflow reproduce their decisions exactly.
    """
    bids = backfill_ids(backfills, len(states))
    start = states
    for attempt in range(max_growths + 1):
        out, lanes, decs = match_stream_ensemble(
            start, reqs, pid, bids, n_pe=n_pe, auto_release=auto_release,
            use_kernel=use_kernel, stats=stats)
        if not _any_overflow(out, stats):
            return out, lanes, decs
        if attempt < max_growths:
            start = _grown(start, out, stats)
    cap, pend = lane_capacity(start)
    raise batch_lib.GrowthError(
        f"match_stream_ensemble still overflowing after {max_growths + 1} "
        f"attempts (last tried capacity {cap}, pending {pend})")
