"""Ensemble axis: E independent scheduler timelines stepped together.

The port's copy of ``repro/core/ensemble.py`` without the fleet's probe
and matching (ROADMAP A15).  The reference stacks E lanes into one
``SchedulerState`` with a leading axis and steps them with
``jax.vmap``.  The port's admit step cannot be vmapped: request fields
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
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import batch as batch_lib
from repro_torch.core import timeline as tl_lib
from repro_torch.core.batch import Decision, RequestBatch, StreamStats
from repro_torch.core.policies import policy_index
from repro_torch.core.timeline import SchedulerState
from repro_torch.core.types import T_INF, backfill_index
from repro_torch.device import DeviceLike

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


def _stack_decisions(decs: Sequence[Decision]) -> Decision:
    return Decision(*(torch.stack(f) for f in zip(*decs)))


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
            s, lane_of(reqs, e), pids[e], bids[e], n_pe=n_pe,
            auto_release=auto_release, use_kernel=use_kernel, stats=stats)
        out.append(s)
        decs.append(dec)
    return tuple(out), _stack_decisions(decs)


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
            s, lane_of(batches, e), pids[e], bids[e], n_pe=n_pe,
            auto_release=auto_release, use_kernel=use_kernel, stats=stats)
        out.append(s)
        decs.append(dec)
    return tuple(out), _stack_decisions(decs)


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
    anyo = torch.stack(ovfs).any()
    return tuple(
        batch_lib._where_state(anyo, s, o)._replace(
            overflow=v, hw_records=torch.maximum(s.hw_records, o.hw_records),
            hw_pending=torch.maximum(s.hw_pending, o.hw_pending))
        for s, o, v in zip(states, outs, ovfs)), dec


def _any_overflow(states: Ensemble, stats: Optional[StreamStats] = None
                 ) -> bool:
    """One host read: is any lane's overflow latch set?"""
    flag = bool(torch.stack([s.overflow for s in states]).any())
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
    hw = torch.stack([s.hw_records for s in run]
                     + [s.hw_pending for s in run]).cpu().numpy()
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
