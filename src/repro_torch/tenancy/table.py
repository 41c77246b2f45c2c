"""The multi-tenant admission tables.

The port's copy of ``repro/tenancy/table.py``.

``TenantSpec``
    The host-side configuration: per-tenant fair-share weights,
    PE-seconds quotas, concurrent-reservation caps, the overdue grace
    window and the telemetry EWMA coefficient.  Frozen and validated
    once by ``ServiceConfig``.
``TenantTable``
    The device-resident state: ``[T]`` per-tenant accumulators plus
    per-slot ownership columns for the pending buffer and the deferral
    queue, as tensors on one device.  It hangs off
    ``SchedulerState.tenants``; ``None`` there means no tenancy, and the
    admit step then runs exactly what it runs without this module.
``HostTenantAccounts``
    The numpy mirror used by the port's ``TenantOracle``, and the
    accounts of the partitioned fleet's host router.

Rounding.  Every fractional update is float32, on the device and in the
mirror alike, with the rounding pinned per field so the two agree bit
for bit, and with the reference's device path (XLA on the CPU, which
contracts ``e * (1 - a) + x * a`` into one fused multiply-add, a
different one for the per-tenant vectors than for the scalar):

* ``acc_ewma`` / ``slow_ewma``: ``fma(x, a, f32(e * (1 - a)))``;
* ``occ_ewma``: ``fma(e, 1 - a, f32(x * a))``;
* ``used``: ``f32(used + f32(f32(n_pe) * f32(t_du)))``.

``1 - a`` is a float32.  Each fma is computed in float64: the product
of two float32 values is exact there, the sum with the third rounds at
most once in float64 (only when the terms' exponents lie more than 29
bits apart), and the cast to float32 rounds.

Divisions by a host value divide by a tensor on the device, never by a
Python number: CUDA computes ``x / scalar`` as ``x * (1 / scalar)``.

The partitioned fleet's router keeps its accounts on the host only (no
device table exists there); its EWMAs round as the reference's router
does, once over both exact products: ``f32(e * (1 - a) + x * a)``
(:func:`ewma_router`).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

#: int32 "+infinity" for unlimited concurrent-reservation caps.
_I32_MAX = 2**31 - 1

#: Supported over-quota dispositions.  ``"park"`` (defer instead of
#: reject) is not implemented: parking an over-quota request would hold
#: a reservation mark for work the tenant may never be allowed to run.
OVER_QUOTA_MODES = ("reject",)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Host-side tenant configuration (``ServiceConfig.tenants``).

    ``weights``
        one positive fair-share weight per tenant; the tuple length is
        the tenant count.  Equal weights make the fair-share ranking
        identical to FCFS.
    ``quotas``
        per-tenant lifetime PE-seconds budgets (``None`` entries are
        unlimited); an admission that would exceed the budget is
        rejected before the search.
    ``max_live``
        per-tenant concurrent-reservation caps (``None`` = unlimited).
    ``over_quota``
        disposition of gated requests; only ``"reject"``.
    ``grace``
        overdue-reservation grace window: on ``Session.tick(t)`` of a
        session with ``auto_release=False`` a reservation still held
        past ``t_e + grace`` is reaped (deleted, charged to its
        tenant).  ``None`` disables reaping.
    ``ewma_alpha``
        coefficient of the telemetry EWMAs (acceptance, slowdown,
        occupancy).
    """

    weights: Tuple[float, ...] = (1.0,)
    quotas: Optional[Tuple[Optional[float], ...]] = None
    max_live: Optional[Tuple[Optional[int], ...]] = None
    over_quota: str = "reject"
    grace: Optional[int] = None
    ewma_alpha: float = 0.05

    def __post_init__(self):
        if not self.weights:
            raise ValueError("TenantSpec needs at least one tenant "
                             "(weights is empty)")
        ws = tuple(float(w) for w in self.weights)
        object.__setattr__(self, "weights", ws)
        if any(not np.isfinite(w) or w <= 0 for w in ws):
            raise ValueError(
                f"tenant weights must be positive and finite, got "
                f"{self.weights}")
        for name in ("quotas", "max_live"):
            vals = getattr(self, name)
            if vals is None:
                continue
            vals = tuple(vals)
            object.__setattr__(self, name, vals)
            if len(vals) != len(ws):
                raise ValueError(
                    f"{len(vals)} {name} entries for {len(ws)} tenants")
            if any(v is not None and v <= 0 for v in vals):
                raise ValueError(
                    f"{name} entries must be positive (or None for "
                    f"unlimited), got {vals}")
        if self.over_quota not in OVER_QUOTA_MODES:
            raise ValueError(
                f"unknown over_quota {self.over_quota!r}; supported: "
                f"{OVER_QUOTA_MODES} (over_quota='park' is not "
                f"implemented: parking an over-quota request would "
                f"reserve capacity the tenant may never get)")
        if self.grace is not None and self.grace < 0:
            raise ValueError(
                f"grace must be >= 0 (seconds past t_e), got {self.grace}")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}")

    @property
    def n_tenants(self) -> int:
        return len(self.weights)

    def quota_array(self) -> np.ndarray:
        """float32[T] PE-seconds budgets; inf = unlimited."""
        if self.quotas is None:
            return np.full(self.n_tenants, np.inf, np.float32)
        return np.asarray(
            [np.inf if q is None else float(q) for q in self.quotas],
            np.float32)

    def max_live_array(self) -> np.ndarray:
        """int32[T] concurrent caps; INT32_MAX = unlimited."""
        if self.max_live is None:
            return np.full(self.n_tenants, _I32_MAX, np.int32)
        return np.asarray(
            [_I32_MAX if m is None else int(m) for m in self.max_live],
            np.int32)

    def padded(self, n_tenants: int) -> "TenantSpec":
        """This spec widened to ``n_tenants`` with neutral tenants
        (weight 1, unlimited), which never receive requests."""
        if n_tenants < self.n_tenants:
            raise ValueError(
                f"cannot pad {self.n_tenants} tenants down to {n_tenants}")
        pad = n_tenants - self.n_tenants
        if pad == 0:
            return self
        return dataclasses.replace(
            self,
            weights=self.weights + (1.0,) * pad,
            quotas=None if self.quotas is None
            else self.quotas + (None,) * pad,
            max_live=None if self.max_live is None
            else self.max_live + (None,) * pad)


class TenantTable(NamedTuple):
    """Device-resident per-tenant state.

    Configuration: ``weight``/``quota``/``max_live``/``alpha``.
    Accounting: ``used`` (lifetime PE-seconds admitted), ``live``
    (currently held reservations), the lifetime counters and the
    telemetry EWMAs.  Ownership columns attribute every pending-buffer
    slot (``pend_tenant``) and deferral-queue slot (``park_tenant``,
    plus the arrival stamp ``park_ta`` of the fair-share key) to a
    tenant; ``-1`` marks an unowned slot.
    """

    weight: torch.Tensor        # float32[T] fair-share weights
    quota: torch.Tensor         # float32[T] PE-seconds budget; inf = none
    max_live: torch.Tensor      # int32[T] concurrent cap; I32_MAX = none
    used: torch.Tensor          # float32[T] lifetime PE-seconds admitted
    live: torch.Tensor          # int32[T] currently held reservations
    n_accepted: torch.Tensor    # int32[T]
    n_rejected: torch.Tensor    # int32[T] (all rejections, gated too)
    n_quota_rejected: torch.Tensor  # int32[T] rejected by the quota gate
    n_parked: torch.Tensor      # int32[T] accepted into the deferral queue
    n_reaped: torch.Tensor      # int32[T] reservations reaped overdue
    acc_ewma: torch.Tensor      # float32[T] acceptance EWMA
    slow_ewma: torch.Tensor     # float32[T] slowdown EWMA
    occ_ewma: torch.Tensor      # float32 0-d machine-occupancy EWMA
    alpha: torch.Tensor         # float32 0-d EWMA coefficient
    pend_tenant: torch.Tensor   # int32[K] pending-slot owner; -1 = free
    park_tenant: torch.Tensor   # int32[Q] queue-slot owner; -1 = free
    park_ta: torch.Tensor       # int32[Q] queue-slot arrival time

    @property
    def n_tenants(self) -> int:
        return self.weight.shape[-1]


#: The float32 fields of a :class:`TenantTable` (the rest are int32).
FLOAT_FIELDS = ("weight", "quota", "used", "acc_ewma", "slow_ewma",
                "occ_ewma", "alpha")


def init_table(spec: TenantSpec, pending_capacity: int, park_capacity: int,
               device: DeviceLike = None) -> TenantTable:
    """Fresh all-zero table for one timeline's buffers on ``device``
    (``None``: cuda); every field is a tensor of its own."""
    dev = resolve_device(device)
    T = spec.n_tenants

    def zi():
        return torch.zeros((T,), dtype=torch.int32, device=dev)

    def zf():
        return torch.zeros((T,), dtype=torch.float32, device=dev)

    return TenantTable(
        weight=torch.tensor(spec.weights, dtype=torch.float32).to(dev),
        quota=torch.from_numpy(spec.quota_array()).to(dev),
        max_live=torch.from_numpy(spec.max_live_array()).to(dev),
        used=zf(), live=zi(),
        n_accepted=zi(), n_rejected=zi(), n_quota_rejected=zi(),
        n_parked=zi(), n_reaped=zi(),
        acc_ewma=zf(), slow_ewma=zf(),
        occ_ewma=torch.zeros((), dtype=torch.float32, device=dev),
        alpha=torch.tensor(np.float32(spec.ewma_alpha)).to(dev),
        pend_tenant=torch.full((pending_capacity,), -1, dtype=torch.int32,
                               device=dev),
        park_tenant=torch.full((park_capacity,), -1, dtype=torch.int32,
                               device=dev),
        park_ta=torch.zeros((park_capacity,), dtype=torch.int32,
                            device=dev))


def lane_tables(specs, pending_capacity: int, park_capacity: int,
                device: DeviceLike = None) -> List[TenantTable]:
    """Per-lane specs -> one table per lane, all of one width.

    Lane specs are padded to the widest tenant count
    (:meth:`TenantSpec.padded`); ``None`` entries become neutral
    equal-weight unlimited tables, which decide as no table does.
    """
    specs = list(specs)
    T = max((s.n_tenants for s in specs if s is not None), default=1)
    return [init_table((s or TenantSpec(weights=(1.0,) * T)).padded(T),
                       pending_capacity, park_capacity, device)
            for s in specs]


def stack_tables(specs, pending_capacity: int, park_capacity: int,
                 device: DeviceLike = None) -> TenantTable:
    """Per-lane specs -> one stacked ``[E, ...]`` table: the lanes of
    :func:`lane_tables`, as the reference lays out an ensemble's."""
    tables = lane_tables(specs, pending_capacity, park_capacity, device)
    return TenantTable(*(torch.stack(xs) for xs in zip(*tables)))


def grow_table(table: TenantTable,
               new_pending_capacity: int) -> TenantTable:
    """Pad the pending ownership column to a grown pending buffer."""
    K = table.pend_tenant.shape[0]
    if new_pending_capacity < K:
        raise ValueError(f"cannot shrink pending {K} -> "
                         f"{new_pending_capacity}")
    pad = new_pending_capacity - K
    if pad == 0:
        return table
    return table._replace(pend_tenant=torch.cat([
        table.pend_tenant,
        torch.full((pad,), -1, dtype=torch.int32,
                   device=table.pend_tenant.device)]))


def fair_key(table: TenantTable, t_now: int) -> torch.Tensor:
    """The weighted wait-time fair-share key of every queue slot.

    ``key = weight[owner] * float32(t_now - t_a)``, one float32
    multiply, as :meth:`HostTenantAccounts.key` computes it.  Free slots
    give garbage keys; every consumer masks by slot liveness first.
    With equal weights the ``(-key, seq)`` order is FCFS order: arrival
    stamps do not decrease with seq, and scaling non-negative waits by
    one float32 weight is monotone.
    """
    T = table.n_tenants
    tid = table.park_tenant.clamp(0, T - 1).to(torch.int64)
    wait = (int(t_now) - table.park_ta).to(torch.float32)
    return table.weight[tid] * wait


def ewma_tenant(e: np.float32, x: np.float32, a: np.float32) -> np.float32:
    """One per-tenant EWMA step (``acc``/``slow``):
    ``fma(x, a, f32(e * (1 - a)))``."""
    one = np.float32(1.0)
    return np.float32(np.float64(x) * np.float64(a)
                      + np.float64(np.float32(e * (one - a))))


def ewma_occ(e: np.float32, x: np.float32, a: np.float32) -> np.float32:
    """One occupancy EWMA step: ``fma(e, 1 - a, f32(x * a))``."""
    one = np.float32(1.0)
    return np.float32(np.float64(e) * np.float64(one - a)
                      + np.float64(np.float32(x * a)))


def ewma_router(e: np.float32, x: np.float32, a: np.float32) -> np.float32:
    """One EWMA step of the partitioned fleet's router:
    ``f32(e * (1 - a) + x * a)``, one rounding over both exact products."""
    one = np.float32(1.0)
    return np.float32(np.float64(e) * np.float64(one - a)
                      + np.float64(x) * np.float64(a))


class HostTenantAccounts:
    """Numpy mirror of :class:`TenantTable` accounting (bit for bit).

    Used by :class:`~repro_torch.core.hostsched.TenantOracle`.  Every
    fractional update rounds as the device does (module docstring), so
    :meth:`snapshot` equals the device table after the same stream.
    ``router=True`` makes them the partitioned fleet's router accounts,
    whose EWMAs round as :func:`ewma_router`.
    """

    def __init__(self, spec: TenantSpec, *, router: bool = False):
        self.spec = spec
        self.router = router
        T = spec.n_tenants
        self.weight = np.asarray(spec.weights, np.float32)
        self.quota = spec.quota_array()
        self.max_live = spec.max_live_array()
        self.used = np.zeros(T, np.float32)
        self.live = np.zeros(T, np.int32)
        self.n_accepted = np.zeros(T, np.int32)
        self.n_rejected = np.zeros(T, np.int32)
        self.n_quota_rejected = np.zeros(T, np.int32)
        self.n_parked = np.zeros(T, np.int32)
        self.n_reaped = np.zeros(T, np.int32)
        self.acc_ewma = np.zeros(T, np.float32)
        self.slow_ewma = np.zeros(T, np.float32)
        self.occ_ewma = np.float32(0.0)
        self.alpha = np.float32(spec.ewma_alpha)

    @property
    def n_tenants(self) -> int:
        return self.spec.n_tenants

    def clip_tid(self, tenant: int) -> int:
        return min(max(int(tenant), 0), self.n_tenants - 1)

    def key(self, tenant: int, t_a: int, t_now: int) -> np.float32:
        """The fair-share key of a queue entry (as :func:`fair_key`)."""
        wait = np.float32(np.int32(t_now) - np.int32(t_a))
        return np.float32(self.weight[self.clip_tid(tenant)] * wait)

    def allowed(self, tid: int, n_pe: int, t_du: int) -> bool:
        """The quota gate: the device's float32 compare."""
        demand = np.float32(n_pe) * np.float32(t_du)
        return bool((self.used[tid] + demand <= self.quota[tid])
                    and (self.live[tid] < self.max_live[tid]))

    def record(self, tid: int, *, accepted: bool, blocked: bool,
               parked: bool, occ_frac: np.float32, t_e: int = -1,
               t_r: int = 0, t_du: int = 1, n_pe: int = 0) -> None:
        """One real request's accounting (as the admit step's)."""
        a = self.alpha
        tenant_step, occ_step = (ewma_router, ewma_router) if self.router \
            else (ewma_tenant, ewma_occ)
        if accepted:
            self.used[tid] = np.float32(
                self.used[tid] + np.float32(n_pe) * np.float32(t_du))
            self.live[tid] += 1
            self.n_accepted[tid] += 1
            if parked:
                self.n_parked[tid] += 1
            slow = np.float32(t_e - t_r) / np.float32(t_du)
            self.slow_ewma[tid] = tenant_step(self.slow_ewma[tid], slow, a)
        else:
            self.n_rejected[tid] += 1
            if blocked:
                self.n_quota_rejected[tid] += 1
        x = np.float32(1.0 if accepted else 0.0)
        self.acc_ewma[tid] = tenant_step(self.acc_ewma[tid], x, a)
        self.occ_ewma = occ_step(self.occ_ewma, np.float32(occ_frac), a)

    def release(self, tenant: int) -> None:
        if tenant >= 0:
            self.live[self.clip_tid(tenant)] -= 1

    def reap(self, tenant: int) -> None:
        if tenant >= 0:
            tid = self.clip_tid(tenant)
            self.live[tid] -= 1
            self.n_reaped[tid] += 1

    def snapshot(self) -> dict:
        """Same layout as :func:`repro_torch.tenancy.telemetry.snapshot`."""
        return dict(
            weight=self.weight.copy(), quota=self.quota.copy(),
            max_live=self.max_live.copy(),
            used=self.used.copy(), live=self.live.copy(),
            n_accepted=self.n_accepted.copy(),
            n_rejected=self.n_rejected.copy(),
            n_quota_rejected=self.n_quota_rejected.copy(),
            n_parked=self.n_parked.copy(),
            n_reaped=self.n_reaped.copy(),
            acc_ewma=self.acc_ewma.copy(),
            slow_ewma=self.slow_ewma.copy(),
            occ_ewma=np.float32(self.occ_ewma))
