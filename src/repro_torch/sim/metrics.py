"""Performance metrics of Section 6.1: acceptance rate and slowdown.

Also the grid reductions (:func:`grid_reductions`) and the NaN-safe
aggregation helpers: a grid cell that accepts no job has no slowdown
(and an all-padding cell no utilization), so those cells carry ``NaN``
and every :class:`GridResult` reduction masks them instead of dividing
by zero or tripping numpy's all-NaN warnings.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def nanmean_safe(a) -> float:
    """Mean over finite entries; NaN (no warning) when none are."""
    a = np.asarray(a, dtype=float)
    m = np.isfinite(a)
    if not m.any():
        return float("nan")
    return float(a[m].mean())


@dataclasses.dataclass
class SimResult:
    """Outcome of one simulation run."""

    policy: str
    n_jobs: int
    n_accepted: int
    slowdowns: List[float] = dataclasses.field(default_factory=list)
    busy_area: float = 0.0          # accepted PE-seconds
    span: float = 0.0               # makespan of the arrival stream
    n_pe: int = 0
    wall_seconds: float = 0.0       # scheduler wall time
    # per-job (accepted, t_s) trace; populated on request only
    decisions: Optional[List[Tuple[bool, int]]] = None

    @property
    def acceptance_rate(self) -> float:
        return self.n_accepted / max(self.n_jobs, 1)

    @property
    def avg_slowdown(self) -> float:
        if not self.slowdowns:
            return float("nan")
        return sum(self.slowdowns) / len(self.slowdowns)

    @property
    def utilization(self) -> float:
        denom = self.n_pe * self.span
        if denom <= 0:
            return float("nan")
        return self.busy_area / denom

    def summary(self) -> str:
        return (f"{self.policy:8s} accept={self.acceptance_rate:.3f} "
                f"slowdown={self.avg_slowdown:.3f} "
                f"util={self.utilization:.3f} "
                f"sched_wall={self.wall_seconds:.2f}s")


@dataclasses.dataclass
class GridResult:
    """Stacked metrics of one Section-6 sweep grid.

    Every metric array is indexed ``[policy, backfill, load, seed,
    flexibility]`` (plus a tenant-mix and a resource-mix axis when the
    grid has more than one of those), the cell order of
    :func:`repro_torch.sim.sweep.simulate_grid`.  A cell that accepts no
    job carries ``NaN`` slowdown (an all-padding cell ``NaN``
    utilization); the reductions below mask those cells.
    """

    policies: Tuple[str, ...]
    arrival_factors: Tuple[float, ...]
    seeds: Tuple[int, ...]
    flex_factors: Tuple[float, ...]
    backfill_modes: Tuple[str, ...]
    acceptance: np.ndarray        # float [P, B, L, S, F]
    slowdown: np.ndarray          # float [P, B, L, S, F] (nan: empty)
    utilization: np.ndarray       # float [P, B, L, S, F]
    n_jobs: np.ndarray            # int   [P, B, L, S, F] valid jobs
    n_accepted: np.ndarray        # int   [P, B, L, S, F]
    wall_seconds: float = 0.0     # admission and reductions of the grid
    # per-cell (accepted, t_s) traces, populated on request only:
    # decisions[p][b][l][s][f] is a list over the cell's unpadded jobs
    decisions: Optional[list] = None
    # the grid session's metrics() after the offer (steps, host syncs,
    # growths, capacities); the port's addition
    metrics: Optional[dict] = None

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.acceptance.shape))

    @property
    def cells_per_sec(self) -> float:
        return self.n_cells / max(self.wall_seconds, 1e-9)

    def policy_acceptance(self) -> Dict[str, float]:
        """Grid-mean acceptance rate per policy (paper Figs. 2/4/6)."""
        return {p: nanmean_safe(self.acceptance[i])
                for i, p in enumerate(self.policies)}

    def policy_slowdown(self) -> Dict[str, float]:
        """Grid-mean slowdown per policy (paper Figs. 3/5/7); empty
        cells are masked, not averaged."""
        return {p: nanmean_safe(self.slowdown[i])
                for i, p in enumerate(self.policies)}

    def mode_policy_acceptance(self) -> Dict[str, Dict[str, float]]:
        """Per backfill mode, grid-mean acceptance per policy."""
        return {m: {p: nanmean_safe(self.acceptance[i, b])
                    for i, p in enumerate(self.policies)}
                for b, m in enumerate(self.backfill_modes)}

    def mode_policy_slowdown(self) -> Dict[str, Dict[str, float]]:
        """Per backfill mode, grid-mean slowdown per policy."""
        return {m: {p: nanmean_safe(self.slowdown[i, b])
                    for i, p in enumerate(self.policies)}
                for b, m in enumerate(self.backfill_modes)}

    def summary(self) -> str:
        lines = [f"{self.n_cells} cells in {self.wall_seconds:.2f}s "
                 f"({self.cells_per_sec:.1f} cells/s)"]
        by_acc = self.mode_policy_acceptance()
        by_sd = self.mode_policy_slowdown()
        for m in self.backfill_modes:
            head = f" [{m}]" if len(self.backfill_modes) > 1 else ""
            for p in self.policies:
                lines.append(
                    f"  {p:8s}{head} accept={by_acc[m][p]:.3f} "
                    f"slowdown={by_sd[m][p]:.3f}")
        return "\n".join(lines)


def grid_reductions(dec, batch, valid: np.ndarray, n_pe: int):
    """Per-cell metric reductions on the decisions' device, read once.

    ``dec`` / ``batch`` are the stacked ``[C, N]`` decisions and
    requests of one grid, ``valid`` the padding mask.  Returns host
    ``(n_accepted, n_valid, acceptance, slowdown, utilization)`` arrays
    of shape ``[C]``; the counts are exact, the rates float32 sums as
    in the reference (whose summation order differs).  A cell with no
    accepted job gets ``NaN`` slowdown, one with no valid job ``NaN``
    utilization.
    """
    f32 = torch.float32
    v = torch.from_numpy(np.asarray(valid, bool)).to(dec.accepted.device)
    acc = dec.accepted & v                                  # [C, N]
    n_acc = acc.sum(dim=1)
    n_val = v.sum(dim=1)
    t_du = batch.t_du.to(f32)
    wait = (dec.t_s - batch.t_r + batch.t_du).to(f32)
    slow = torch.where(acc, wait / torch.clamp(t_du, min=1), 0.0)
    slowdown = slow.sum(dim=1) / torch.clamp(n_acc, min=1).to(f32)
    slowdown = torch.where(n_acc > 0, slowdown, float("nan"))
    # PE-seconds accumulate in float32: paper-scale cells overflow an
    # int32 sum, and utilization is a ratio
    area = torch.where(acc, (batch.n_pe * batch.t_du).to(f32), 0.0).sum(1)
    t_a = torch.where(v, batch.t_a, 0)
    first = torch.where(v, batch.t_a, 2**31 - 1).amin(dim=1)
    span = torch.clamp(t_a.amax(dim=1), min=1) - first + 1
    util = area / (n_pe * span.to(f32))
    util = torch.where(n_val > 0, util, float("nan"))
    rate = n_acc.to(f32) / torch.clamp(n_val, min=1).to(f32)
    host = torch.stack([x.to(torch.float64) for x in (
        n_acc, n_val, rate, slowdown, util)]).cpu().numpy()
    return (host[0].astype(np.int32), host[1].astype(np.int32),
            host[2].astype(np.float32), host[3].astype(np.float32),
            host[4].astype(np.float32))


def mean_ci95(values: Sequence[float]) -> tuple:
    """(mean, half-width of the normal-approximation 95% CI)."""
    n = len(values)
    if n == 0:
        return float("nan"), float("nan")
    mean = sum(values) / n
    if n == 1:
        return mean, float("nan")
    var = sum((v - mean) ** 2 for v in values) / (n - 1)
    return mean, 1.96 * math.sqrt(var / n)
