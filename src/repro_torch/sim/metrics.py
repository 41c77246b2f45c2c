"""Performance metrics of Section 6.1: acceptance rate and slowdown."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


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
