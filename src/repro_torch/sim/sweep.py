"""Section-6 sweep grids as the lanes of one ensemble session.

The paper evaluates its seven policies by simulating a grid of loads,
seeds and flexibilities.  Here that grid (policies x backfill modes x
loads x seeds x flexibilities, plus tenant and resource mixes) runs as
the lanes of one :class:`repro_torch.api.Session` with ``lanes`` = cells
and one-shot offers: every cell's request stream is generated on the
host (:mod:`repro_torch.sim.workload`), padded to one length, stacked
and offered once.  The port's ensemble runs its lanes one after
another (:mod:`repro_torch.core.ensemble`); the metrics are reduced on
the device and read once (:func:`~repro_torch.sim.metrics.
grid_reductions`).

``cross_check=True`` holds every cell against its host oracle: the
event loop for ``backfill="none"``, :class:`~repro_torch.core.
hostsched.BackfillOracle` for the other modes, :class:`~repro_torch.
core.hostsched.TenantOracle` for tenant mixes and
:class:`~repro_torch.core.hostsched.MultiResourceOracle` on
multi-resource grids.
"""
from __future__ import annotations

import dataclasses
import itertools
import time as _time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.api import ReservationService, ServiceConfig
from repro_torch.core.batch import pad_streams
from repro_torch.core.policies import policy_index
from repro_torch.core.resources import ResourceSpec
from repro_torch.core.types import ALL_POLICIES, Policy
from repro_torch.device import DeviceLike
from repro_torch.sim.metrics import GridResult, grid_reductions
from repro_torch.sim.workload import WorkloadParams, generate_filtered


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """The experiment matrix: policies x backfill x loads x seeds x flex.

    ``arrival_factors`` rescale arrivals (higher = heavier load, paper
    Figs. 4-5); ``flex_factors`` set both the AR-time and the deadline
    factor (Figs. 6-7); ``backfill_modes`` adds the deferral-queue axis
    with ``park_capacity`` queue slots per lane.  ``tenant_mixes`` adds
    the multi-tenancy axis: each entry is a
    :class:`~repro_torch.tenancy.TenantSpec` (jobs are assigned tenants
    round-robin) or ``None`` for one tenant.  ``resources`` makes the
    machine multi-resource (``resources[0] == n_pe``) and
    ``resource_mixes`` adds the secondary-demand axis: each entry is a
    tuple of R-1 intensity fractions (job ``j`` gets ``demand[r] =
    min(units[r], round(f_r * units[r] * j.n_pe / n_pe))``) or ``None``
    for PE-only demand.  ``base`` supplies every other workload knob.
    """

    policies: Tuple[Policy, ...] = ALL_POLICIES
    arrival_factors: Tuple[float, ...] = (0.75, 1.0, 1.25)
    seeds: Tuple[int, ...] = (0, 1, 2)
    flex_factors: Tuple[float, ...] = (3.0,)
    backfill_modes: Tuple[str, ...] = ("none",)
    tenant_mixes: Tuple[Optional[object], ...] = (None,)
    resources: Optional[Tuple[int, ...]] = None
    resource_mixes: Tuple[Optional[Tuple[float, ...]], ...] = (None,)
    base: WorkloadParams = WorkloadParams()
    n_pe: int = 64
    n_jobs: int = 200
    park_capacity: int = 8

    @property
    def rspec(self) -> Optional[ResourceSpec]:
        """The grid's :class:`ResourceSpec`, ``None`` on PE-only grids."""
        return None if self.resources is None else ResourceSpec(
            self.resources)

    @property
    def shape(self) -> Tuple[int, ...]:
        base = (len(self.policies), len(self.backfill_modes),
                len(self.arrival_factors), len(self.seeds),
                len(self.flex_factors))
        if len(self.tenant_mixes) > 1:
            base = base + (len(self.tenant_mixes),)
        if len(self.resource_mixes) > 1:
            base = base + (len(self.resource_mixes),)
        return base

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.shape))

    def workload_params(self, load: float, seed: int,
                        flex: float) -> WorkloadParams:
        return self.base.replace(
            n_jobs=self.n_jobs, n_pe=self.n_pe, arrival_factor=load,
            seed=seed, artime_factor=flex, deadline_factor=flex)


def simulate_grid(spec: Optional[GridSpec] = None, *, capacity: int = 128,
                  pending_capacity: int = 256, use_kernel: bool = True,
                  cross_check: bool = False, record_decisions: bool = False,
                  placement="auto", donate: bool = True,
                  device: DeviceLike = None,
                  **overrides) -> GridResult:
    """Run the whole experiment matrix as one ensemble offer.

    Each (load, seed, flexibility) workload is generated once and shared
    by every policy and backfill mode, the paper's setup.  All cells
    admit through one ``ReservationService(ServiceConfig(lanes=C))``
    session in one one-shot offer (one growth covers the worst lane),
    and the stacked metrics come back as a :class:`GridResult` indexed
    ``[policy, backfill, load, seed, flex]``.  ``cross_check=True``
    re-runs every cell on its host oracle and raises on the first
    divergence; ``record_decisions`` keeps each cell's ``(accepted,
    t_s)`` trace.  ``placement`` places the cells over the local cards
    (``ServiceConfig.placement``; the same decisions on every
    placement).  ``donate=False`` takes the reference's non-donated
    admission (the same decisions).  ``device`` holds the lanes on one
    card (``None``: cuda).
    """
    spec = dataclasses.replace(spec or GridSpec(), **overrides)
    shape = spec.shape
    # one workload per (load, seed, flex), shared across policy / mode;
    # tenant mixes re-stamp the shared stream round-robin
    workloads = {}
    for load, seed, flex in itertools.product(
            spec.arrival_factors, spec.seeds, spec.flex_factors):
        jobs = generate_filtered(spec.workload_params(load, seed, flex),
                                 max_pe=spec.n_pe)
        workloads[(load, seed, flex)] = sorted(jobs, key=lambda j: j.t_a)
    mixes = spec.tenant_mixes
    tenanted = {}
    for key, jobs in workloads.items():
        for m, mix in enumerate(mixes):
            tenanted[key + (m,)] = jobs if mix is None else [
                dataclasses.replace(j, tenant=i % mix.n_tenants)
                for i, j in enumerate(jobs)]
    rmixes = spec.resource_mixes
    rspec = spec.rspec
    if rspec is None and any(rm is not None for rm in rmixes):
        raise ValueError("resource_mixes needs GridSpec.resources")
    stamped = {}
    for key, jobs in tenanted.items():
        for rm, fracs in enumerate(rmixes):
            stamped[key + (rm,)] = jobs if fracs is None else \
                _stamp_demand(jobs, rspec, fracs)
    cells = list(itertools.product(
        spec.policies, spec.backfill_modes, spec.arrival_factors,
        spec.seeds, spec.flex_factors, range(len(mixes)),
        range(len(rmixes))))
    streams = [stamped[(lo, se, fl, m, rm)]
               for _, _, lo, se, fl, m, rm in cells]
    tenancy = any(mix is not None for mix in mixes)
    batch, valid = pad_streams(streams, spec.n_pe, with_tenant=tenancy,
                               extra_demand=rspec.R - 1 if rspec else 0,
                               device=device)
    pids = [policy_index(p) for p, *_ in cells]
    backfill = tuple(m for _, m, *_ in cells)
    if all(m == "none" for m in backfill):
        backfill = "none"          # no deferral queue at all
    session = ReservationService(ServiceConfig(
        n_pe=spec.n_pe, lanes=len(cells), capacity=capacity,
        pending_capacity=pending_capacity, use_kernel=use_kernel,
        backfill=backfill, backfill_queue=spec.park_capacity,
        chunk_size=None, placement=placement, donate=donate,
        resources=spec.resources,
        tenants=(tuple(mixes[c[-2]] for c in cells) if tenancy else None),
        device=device)).session()
    t0 = _time.perf_counter()
    res = session.offer((batch, valid), policy=pids)
    dec = res.decision
    n_acc, n_val, acc_rate, slowdown, util = grid_reductions(
        dec, batch, valid, spec.n_pe)          # reads the device once
    wall = _time.perf_counter() - t0
    result = GridResult(
        policies=tuple(p.value for p in spec.policies),
        arrival_factors=spec.arrival_factors, seeds=spec.seeds,
        flex_factors=spec.flex_factors, backfill_modes=spec.backfill_modes,
        acceptance=acc_rate.reshape(shape), slowdown=slowdown.reshape(shape),
        utilization=util.reshape(shape),
        n_jobs=n_val.reshape(shape).astype(int),
        n_accepted=n_acc.reshape(shape).astype(int), wall_seconds=wall,
        metrics=session.metrics())
    if record_decisions or cross_check:
        accepted = dec.accepted.cpu().numpy()
        starts = dec.t_s.cpu().numpy()
        traces: List[List[Tuple[bool, int]]] = [
            [(bool(accepted[c, i]), int(starts[c, i]))
             for i in range(len(streams[c]))] for c in range(len(cells))]
        if record_decisions:
            arr = np.empty(len(cells), dtype=object)
            for c in range(len(cells)):
                arr[c] = traces[c]
            result.decisions = arr.reshape(shape).tolist()
    if cross_check:
        _cross_check_cells(cells, mixes, streams, traces, spec.n_pe,
                           spec.park_capacity, rspec)
    return result


def _stamp_demand(jobs, rspec, fracs):
    """Stamp a per-resource demand vector onto each job.

    Secondary-plane demand scales with the job's PE fraction:
    ``demand[r] = min(units[r], round(f_r * units[r] * n_pe / n_pe0))``;
    an ``f_r`` of 1.0 means a whole-machine job wants the whole plane.
    """
    if len(fracs) != rspec.R - 1:
        raise ValueError(f"resource mix has {len(fracs)} fractions for "
                         f"{rspec.R - 1} secondary resources")
    out = []
    for j in jobs:
        tail = tuple(
            min(rspec.units[r + 1],
                max(0, int(round(float(f) * rspec.units[r + 1]
                                 * (j.n_pe / rspec.n_pe)))))
            for r, f in enumerate(fracs))
        out.append(dataclasses.replace(j, demand=(j.n_pe,) + tail))
    return out


def _cross_check_cells(cells, mixes, streams, traces, n_pe: int,
                       park_capacity: int, rspec=None) -> None:
    """Raise unless every cell decides as its host oracle does."""
    from repro_torch.core.hostsched import (BackfillOracle,
                                            MultiResourceOracle,
                                            TenantOracle)
    from repro_torch.sim.simulator import simulate

    for c, (policy, mode, load, seed, flex, m, rm) in enumerate(cells):
        mix = mixes[m]
        if rspec is not None:
            if mix is not None:
                raise NotImplementedError(
                    "cross_check with both tenant_mixes and resources is "
                    "not supported (no multi-resource tenant oracle)")
            ref = MultiResourceOracle(rspec, policy, mode,
                                      park_capacity=park_capacity
                                      ).run(streams[c])
        elif mix is not None:
            orc = TenantOracle(n_pe, policy, mode, mix,
                               park_capacity=park_capacity)
            ref = [orc.admit(r)[:2] for r in streams[c]]
        elif mode == "none":
            ref = simulate(streams[c], n_pe, policy, engine="host",
                           record_decisions=True).decisions
        else:
            ref = BackfillOracle(n_pe, policy, mode,
                                 park_capacity=park_capacity
                                 ).run(streams[c])
        if ref != traces[c]:
            diff = [i for i, (x, y) in enumerate(zip(ref, traces[c]))
                    if x != y]
            raise AssertionError(
                f"grid cell (policy={policy.value}, backfill={mode}, "
                f"load={load}, seed={seed}, flex={flex}, tenant_mix={m}, "
                f"resource_mix={rm}) diverges from the host oracle at job "
                f"indices {diff[:10]} ({len(diff)}/{len(streams[c])} "
                f"total)")
