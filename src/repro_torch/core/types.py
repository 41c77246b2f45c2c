"""Core value types for advance-reservation scheduling.

The paper characterises an AR request by the 5-tuple
``(t_a, t_r, t_du, t_dl, n_pe)`` (Section 3).  All times are integer
seconds, which keeps the timeline arithmetic exact on the host engine
and in the int32 device tensors alike.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

# Sentinel for "+infinity" on the int32 device path.  The host engine
# uses the same value so that both engines agree bit for bit.
T_INF: int = 2**31 - 1


class Policy(str, enum.Enum):
    """The seven scheduling policies of Section 5."""

    FF = "FF"          # First Fit: earliest feasible start time
    PE_B = "PE_B"      # PE Best Fit: min free PEs in the rectangle
    PE_W = "PE_W"      # PE Worst Fit: max free PEs in the rectangle
    DU_B = "Du_B"      # Duration Best Fit: min rectangle duration
    DU_W = "Du_W"      # Duration Worst Fit: max rectangle duration
    PEDU_B = "PEDu_B"  # PE-Duration Best Fit: min PEs * duration
    PEDU_W = "PEDu_W"  # PE-Duration Worst Fit: max PEs * duration


ALL_POLICIES: Tuple[Policy, ...] = tuple(Policy)


class BackfillMode(str, enum.Enum):
    """Admission-order relaxation of the deferral queue.

    ``NONE`` is the paper's strict arrival-order admission.  Under the
    backfilling modes an accepted request whose start is delayed past
    its ready time parks in a bounded FCFS queue: ``CONSERVATIVE``
    reservations never move (decision-identical to ``NONE``); under
    ``EASY`` only the head of the queue binds, so later reservations
    may be pulled earlier or displaced inside their deadline windows.
    The device path (:mod:`repro_torch.core.batch`) and the host oracle
    (:class:`repro_torch.core.hostsched.BackfillOracle`) run all three.
    """

    NONE = "none"
    EASY = "easy"
    CONSERVATIVE = "conservative"


BACKFILL_MODES: Tuple[BackfillMode, ...] = tuple(BackfillMode)
BACKFILL_IDS = {m: i for i, m in enumerate(BACKFILL_MODES)}


def backfill_index(mode) -> int:
    """Any mode spelling -> its integer id (none=0, easy=1,
    conservative=2); an integer id is range-checked."""
    if isinstance(mode, str) and not isinstance(mode, BackfillMode):
        mode = BackfillMode(mode)
    if isinstance(mode, BackfillMode):
        return BACKFILL_IDS[mode]
    mode = int(mode)
    if not 0 <= mode < len(BACKFILL_MODES):
        raise ValueError(
            f"backfill id {mode} out of range; valid ids are "
            f"{dict((m.value, i) for m, i in BACKFILL_IDS.items())}")
    return mode


@dataclasses.dataclass(frozen=True)
class ARRequest:
    """An advance-reservation request (paper Section 3).

    Attributes:
      t_a:  arrival time of the request.
      t_r:  ready time (earliest start), ``t_r >= t_a``.
      t_du: duration on the current cluster.
      t_dl: deadline, ``t_dl >= t_r + t_du``.
      n_pe: number of processing elements required.
      tenant: owning tenant id on multi-tenant sessions; ignored when
            tenancy is off.
      demand: optional full per-resource demand vector for
            multi-resource sessions (keyword only); ``demand[0]`` must
            equal ``n_pe``, and the session's
            :class:`~repro_torch.core.resources.ResourceSpec` checks
            the rest.  ``None`` means "PEs only".
    """

    t_a: int
    t_r: int
    t_du: int
    t_dl: int
    n_pe: int
    tenant: int = 0
    demand: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, kw_only=True)

    def __post_init__(self) -> None:
        if self.t_r < self.t_a:
            raise ValueError(f"t_r={self.t_r} < t_a={self.t_a}")
        if self.t_du <= 0:
            raise ValueError(f"t_du={self.t_du} must be positive")
        if self.t_dl < self.t_r + self.t_du:
            raise ValueError(
                f"infeasible request: t_dl={self.t_dl} < t_r+t_du="
                f"{self.t_r + self.t_du}")
        if self.n_pe <= 0:
            raise ValueError(f"n_pe={self.n_pe} must be positive")
        if self.tenant < 0:
            raise ValueError(f"tenant={self.tenant} must be >= 0")
        if self.demand is not None:
            d = tuple(int(x) for x in self.demand)
            if not d or d[0] != self.n_pe:
                raise ValueError(
                    f"demand[0] must equal n_pe={self.n_pe}: got {d}")
            if any(x < 0 for x in d):
                raise ValueError(f"demand must be >= 0: got {d}")
            object.__setattr__(self, "demand", d)


@dataclasses.dataclass(frozen=True)
class Rectangle:
    """A maximum availability rectangle for one candidate start time.

    ``{t_s, T_begin, T_end, PE_free}`` of Algorithm 3: the widest time
    extent ``[t_begin, t_end)`` over which the ``n_free`` PEs that are
    free throughout the job window ``[t_s, t_s + t_du)`` stay free.
    """

    t_s: int
    t_begin: int
    t_end: int
    n_free: int

    @property
    def duration(self) -> int:
        return self.t_end - self.t_begin


@dataclasses.dataclass(frozen=True)
class Allocation:
    """A successful placement decision returned by ``findAllocation``."""

    t_s: int
    t_e: int
    pe_ids: Tuple[int, ...]          # identities of the allocated PEs
    rectangle: Optional[Rectangle] = None


def policy_score(policy: Policy, rect: Rectangle) -> Tuple[float, int]:
    """Lexicographic minimisation key shared by every engine.

    All policies minimise ``(primary, t_s)``: the earliest feasible
    start breaks ties (Section 5).  Worst-fit variants negate the
    primary term.
    """
    dur = float(rect.duration)
    if policy == Policy.FF:
        primary = 0.0
    elif policy == Policy.PE_B:
        primary = float(rect.n_free)
    elif policy == Policy.PE_W:
        primary = -float(rect.n_free)
    elif policy == Policy.DU_B:
        primary = dur
    elif policy == Policy.DU_W:
        primary = -dur
    elif policy == Policy.PEDU_B:
        primary = float(rect.n_free) * dur
    elif policy == Policy.PEDU_W:
        primary = -float(rect.n_free) * dur
    else:  # pragma: no cover - exhaustive enum
        raise ValueError(f"unknown policy {policy}")
    return (primary, rect.t_s)
