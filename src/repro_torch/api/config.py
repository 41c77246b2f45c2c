"""`ServiceConfig`: one declarative knob set for the reservation service.

The port's copy of ``repro/api/config.py``.  It keeps every field the
reference has, ``placement`` included, except ``bucketing`` (the port
always searches the smallest power-of-two prefix of the timeline that
holds its records), validates each one as the reference does, and adds
``device``.  ``donate`` keeps its name and default but not its
mechanism: PyTorch has no buffer donation, so the field only selects
the reference's pipelined offer (see ``ServiceConfig``).  A session
runs one device timeline, an ensemble of lanes (``lanes > 1``),
partitions of one machine (``n_partitions > 1``), or one of the host
engines.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple, Union

from repro_torch.core import batch as batch_lib
from repro_torch.core.policies import policy_index
from repro_torch.core.resources import ResourceSpec
from repro_torch.core.types import BackfillMode, Policy
from repro_torch.device import DeviceLike

#: The three engine implementations of the reference.
ENGINE_NAMES = ("list", "host", "device")

#: Partition routing strategies of the reference.
ROUTINGS = ("round_robin", "least_loaded", "best_acceptance")

#: Named lane placements; an int caps the shard count.
PLACEMENTS = ("auto", "single", "host")

#: Backfilling admission modes.
BACKFILLS = tuple(m.value for m in BackfillMode)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Complete configuration of a :class:`~repro_torch.api.ReservationService`.

    ``engine`` / ``policy`` / ``use_kernel``
        ``engine="device"`` keeps the state on ``device``;
        ``"host"`` (numpy) and ``"list"`` (the literal record list)
        are the reference's CPU engines, run only when named here, and
        ``engine_kwargs`` forwards their constructor knobs.  ``policy``
        is the default Section-5 policy (overridable per ``offer``);
        ``use_kernel`` runs the device search through the hand-written
        CUDA kernels (on the CPU it takes their plain versions),
        ``False`` through plain tensor code.  All make the same
        decisions.
    ``capacity`` / ``pending_capacity`` / ``auto_grow`` / ``max_growths``
        Starting sizes of the timeline and the pending-release buffer.
        An overflowing dispatch grows to the high-water mark it
        recorded and re-runs; ``auto_grow=False`` raises instead,
        commits nothing of the overflowing chunk and leaves its
        requests in the ring.
    ``lanes`` / ``n_partitions`` / ``routing``
        ``lanes > 1`` runs that many whole-machine replicas (the
        Section-6 grid); ``n_partitions > 1`` splits the machine into
        equal partitions, and each offer is routed across them by
        ``routing`` (round robin, least loaded, best acceptance) and
        decided at once.  The two axes are exclusive.
    ``chunk_size`` / ``ring_capacity``
        :meth:`~repro_torch.api.Session.offer` stages arrivals in a
        ``ring_capacity``-slot ring and admits them in chunks of
        ``chunk_size``; ``None`` admits each offer as one batch.
    ``resources`` / ``machine_sizes``
        ``resources`` makes the machine multi-resource: one unit count
        per resource, ``resources[0] == n_pe``, one packed bitplane
        each, and requests may carry a full ``demand`` vector.
        ``machine_sizes`` (one entry per lane) gives the lane fewer
        live PEs than ``n_pe``.
    ``donate``
        With ``auto_grow``, chunked offers pipeline as the reference's
        donated sessions do: no chunk's overflow latch is read before
        the next chunk runs; the offer returns a deferred result, and
        the first access to it (or the next verb that reads the state)
        reads every outstanding latch in one host read and replays from
        the first latched chunk on a grown state.  ``False`` reads each
        chunk's latch before the next one starts.  Decisions are the
        same.  A snapshot or restore sends later offers down the eager
        path until the next admission, as in the reference.
    ``backfill`` / ``backfill_queue``
        ``"easy"`` or ``"conservative"`` parks each accepted request
        that starts after its ready time in a deferral queue of
        ``backfill_queue`` entries: conservative never moves it (the
        decisions of ``"none"``), EASY may pull it earlier after a
        cancel or move it to admit a request that would otherwise be
        rejected.  On ensemble sessions a tuple gives one mode per
        lane, and every lane then carries the queue (a ``"none"`` lane
        decides as it would without one).
    ``index_tile``
        Attaches the availability index (tiles of ``index_tile``
        records, a power of two dividing ``capacity``): early rejects
        and candidate pruning, with identical decisions.
    ``tenants``
        A :class:`~repro_torch.tenancy.TenantSpec`: requests carry a
        ``tenant`` id, each tenant's quota and live cap gate its
        admissions, the deferral queue ranks by weighted fair share,
        ``metrics(tenant=i)`` reports the tenant's telemetry, and with
        ``auto_release=False`` and a ``grace`` window ``tick`` reaps
        overdue reservations.  On ensemble sessions a tuple gives one
        spec per lane (``None`` leaves that lane single-tenant).
    ``placement``
        The cards ensemble lanes and partitions are placed on:
        ``"auto"`` (default) spreads the lanes over every local card
        (:func:`repro_torch.launch.mesh.make_lane_mesh`: the largest
        divisor of the lane count that fits), lane ``i`` on card
        ``i // (E / d)``; on one card this resolves to the one-device
        host mesh.  ``"host"`` pins that mesh, an int caps the shard
        count, ``"single"`` / ``None`` keep every lane on ``device``.
        Decisions are the same on every placement;
        ``metrics()["placement_shards"]`` of an ensemble session says
        how many cards hold its lanes.
    ``device``
        Where the session's state lives (with a placement over several
        cards, lane 0's card and where cross-lane results gather);
        ``None`` means cuda (raising without a card).
    """

    n_pe: int
    engine: str = "device"
    policy: Policy = Policy.PE_W
    capacity: int = 128
    pending_capacity: int = 256
    auto_grow: bool = True
    max_growths: int = batch_lib.MAX_DOUBLINGS
    auto_release: bool = True
    use_kernel: bool = True
    lanes: int = 1
    n_partitions: int = 1
    routing: str = "round_robin"
    chunk_size: Optional[int] = 64
    ring_capacity: int = 256
    backfill: Union[str, Tuple[str, ...]] = "none"
    backfill_queue: int = 8
    tenants: Optional[Any] = None
    resources: Optional[Tuple[int, ...]] = None
    machine_sizes: Optional[Tuple[int, ...]] = None
    index_tile: Optional[int] = None
    donate: bool = True
    engine_kwargs: Optional[Mapping[str, Any]] = None
    placement: Union[None, str, int] = "auto"
    device: DeviceLike = None

    def __post_init__(self):
        if self.n_pe < 1:
            raise ValueError(f"n_pe must be >= 1, got {self.n_pe}")
        if self.engine not in ENGINE_NAMES:
            raise ValueError(
                f"unknown engine {self.engine!r}; pick one of "
                f"{ENGINE_NAMES}")
        if isinstance(self.policy, str):
            object.__setattr__(self, "policy", Policy(self.policy))
        if self.lanes < 1 or self.n_partitions < 1:
            raise ValueError("lanes and n_partitions must be >= 1")
        if self.lanes > 1 and self.n_partitions > 1:
            raise ValueError(
                "lanes (whole-machine replicas) and n_partitions "
                "(machine slices) are exclusive scale-out axes")
        if (self.lanes > 1 or self.n_partitions > 1) \
                and self.engine != "device":
            raise ValueError(
                "ensemble lanes and partitions are device states; use "
                "engine='device'")
        if self.n_partitions > 1 and self.n_pe % self.n_partitions:
            raise ValueError(
                f"n_pe={self.n_pe} not divisible into "
                f"{self.n_partitions} partitions")
        if self.n_partitions > 1 and not self.auto_grow:
            raise ValueError(
                "the partitioned core grows internally; "
                "auto_grow=False is not supported with n_partitions>1")
        if self.engine_kwargs and self.engine == "device":
            raise ValueError(
                "device-engine knobs are first-class config fields "
                "(capacity/pending_capacity/use_kernel); "
                "engine_kwargs is for host/list engines")
        if self.max_growths < 0:
            raise ValueError("max_growths must be >= 0")
        if self.routing not in ROUTINGS:
            raise ValueError(
                f"unknown routing {self.routing!r}; pick one of "
                f"{ROUTINGS}")
        if self.chunk_size is not None:
            if self.chunk_size < 1:
                raise ValueError("chunk_size must be >= 1 or None")
            if self.ring_capacity < self.chunk_size:
                raise ValueError(
                    f"ring_capacity ({self.ring_capacity}) must hold "
                    f"at least one chunk ({self.chunk_size})")
        if self.capacity < 2 or self.pending_capacity < 1:
            raise ValueError("capacity >= 2 and pending_capacity >= 1")
        self._check_backfill()
        self._check_placement()
        self._check_tenants()
        self._check_resources()
        if self.index_tile is not None:
            it = int(self.index_tile)
            object.__setattr__(self, "index_tile", it)
            if self.engine != "device":
                raise ValueError(
                    "the availability index lives in the device state; "
                    "use engine='device'")
            if it < 1 or (it & (it - 1)) != 0:
                raise ValueError(
                    f"index_tile must be a positive power of two: got "
                    f"{it}")
            if self.capacity % it:
                raise ValueError(
                    f"capacity ({self.capacity}) must be divisible by "
                    f"index_tile ({it})")

    def _check_backfill(self) -> None:
        bf = self.backfill
        if isinstance(bf, str):
            if bf not in BACKFILLS:
                raise ValueError(
                    f"unknown backfill {bf!r}; pick one of {BACKFILLS}")
        else:
            bf = tuple(bf)
            object.__setattr__(self, "backfill", bf)
            unknown = [m for m in bf if m not in BACKFILLS]
            if unknown:
                raise ValueError(
                    f"unknown backfill modes {unknown}; pick from "
                    f"{BACKFILLS}")
            if self.n_partitions > 1:
                raise ValueError(
                    "partition lanes share one backfill mode; pass a "
                    "single name (per-lane tuples are for ensemble "
                    "sessions)")
            if len(bf) != self.lanes:
                raise ValueError(
                    f"{len(bf)} backfill modes for {self.lanes} lanes "
                    f"(a tuple gives one mode per ensemble lane)")
        if self.backfilling:
            if self.engine != "device":
                raise ValueError(
                    "backfilling runs on the device deferral queue; "
                    "use engine='device'")
            if not self.auto_release:
                raise ValueError(
                    "backfilling promotes parked reservations through "
                    "the pending-release buffer; it requires "
                    "auto_release=True")
            if self.backfill_queue < 1:
                raise ValueError(
                    "backfill_queue must be >= 1 when backfilling")

    def _check_placement(self) -> None:
        pl = self.placement
        if isinstance(pl, bool) or not (
                pl is None or isinstance(pl, (str, int))):
            raise ValueError(
                f"placement must be one of {PLACEMENTS}, a positive "
                f"int shard cap, or None; got {pl!r}")
        if isinstance(pl, str) and pl not in PLACEMENTS:
            raise ValueError(
                f"unknown placement {pl!r}; pick one of {PLACEMENTS} "
                f"(or an int shard cap / None)")
        if isinstance(pl, int) and pl < 1:
            raise ValueError(
                f"an int placement caps the shard count and must be "
                f">= 1, got {pl}")

    def _check_tenants(self) -> None:
        """The reference's tenant validation, at construction."""
        if self.tenants is None:
            return
        from repro_torch.tenancy import TenantSpec
        tn = self.tenants
        if isinstance(tn, (list, tuple)):
            tn = tuple(tn)
            object.__setattr__(self, "tenants", tn)
            if self.n_partitions > 1:
                raise ValueError(
                    "partition lanes share one tenant spec; pass a single "
                    "TenantSpec (per-lane tuples are for ensemble "
                    "sessions)")
            if len(tn) != self.lanes:
                raise ValueError(
                    f"{len(tn)} tenant specs for {self.lanes} lanes (a "
                    f"tuple gives one spec per ensemble lane; use None "
                    f"for single-tenant lanes)")
            bad = [type(s).__name__ for s in tn
                   if s is not None and not isinstance(s, TenantSpec)]
            if bad:
                raise ValueError(
                    f"tenants tuple entries must be TenantSpec or None, "
                    f"got {bad}")
            specs = [s for s in tn if s is not None]
        elif isinstance(tn, TenantSpec):
            specs = [tn]
        else:
            raise ValueError(
                f"tenants must be a TenantSpec (or a per-lane tuple of "
                f"TenantSpec/None), got {type(tn).__name__}")
        if self.engine != "device":
            raise ValueError(
                "tenancy lives in the device state; use engine='device'")
        for s in specs:
            if s.n_tenants > self.pending_capacity:
                raise ValueError(
                    f"max tenants ({s.n_tenants}) exceeds the "
                    f"pending-queue size (pending_capacity="
                    f"{self.pending_capacity}); every tenant must be "
                    f"able to hold at least one live reservation")

    def _check_resources(self) -> None:
        if self.resources is not None:
            rs = tuple(int(x) for x in self.resources)
            object.__setattr__(self, "resources", rs)
            if not rs or rs[0] != self.n_pe:
                raise ValueError(
                    f"resources[0] must equal n_pe={self.n_pe}: got {rs}")
            if any(x < 1 for x in rs):
                raise ValueError(
                    f"every resource needs >= 1 unit: got {rs}")
            if self.engine != "device":
                raise ValueError(
                    "multi-resource timelines live in the device state; "
                    "use engine='device'")
            if self.n_partitions > 1:
                raise ValueError(
                    "resources and n_partitions>1 are not supported "
                    "together (partitions slice the single PE pool)")
        if self.machine_sizes is not None:
            ms = tuple(int(x) for x in self.machine_sizes)
            object.__setattr__(self, "machine_sizes", ms)
            if self.engine != "device":
                raise ValueError(
                    "machine_sizes masks the device timeline; use "
                    "engine='device'")
            if self.n_partitions > 1:
                raise ValueError(
                    "machine_sizes and n_partitions>1 are not supported "
                    "together")
            if self.tenants is not None:
                raise ValueError(
                    "machine_sizes with tenants is not supported "
                    "(tenant PE-seconds accounting assumes homogeneous "
                    "lanes)")
            if len(ms) != self.lanes:
                raise ValueError(
                    f"{len(ms)} machine_sizes for {self.lanes} lanes "
                    f"(one live-PE count per ensemble lane)")
            bad = [m for m in ms if not 0 < m <= self.n_pe]
            if bad:
                raise ValueError(
                    f"machine_sizes entries must be in (0, n_pe="
                    f"{self.n_pe}]: got {bad}")

    @property
    def rspec(self) -> Optional[ResourceSpec]:
        """The session's :class:`ResourceSpec`; ``None`` on plain configs.

        ``machine_sizes`` without ``resources`` implies an R=1 spec
        (heterogeneous lanes need the masked fit test).
        """
        if self.resources is None and self.machine_sizes is None:
            return None
        return ResourceSpec(self.resources if self.resources is not None
                            else (self.n_pe,))

    @property
    def extra_demand(self) -> int:
        """Staged demand-tail width (R-1) for rings and batches."""
        spec = self.rspec
        return 0 if spec is None else spec.R - 1

    @property
    def machine_units(self) -> Optional[Tuple[Tuple[int, ...], ...]]:
        """Per-lane live-unit tuples for heterogeneous lanes."""
        if self.machine_sizes is None:
            return None
        spec = self.rspec
        return tuple((m,) + spec.units[1:] for m in self.machine_sizes)

    @property
    def tenancy(self) -> bool:
        """Whether any lane carries a tenant table."""
        tn = self.tenants
        if isinstance(tn, tuple):
            return any(s is not None for s in tn)
        return tn is not None

    @property
    def lane_tenant_specs(self) -> Optional[Tuple[Any, ...]]:
        """Per-lane tenant specs (length ``lanes``), or ``None``."""
        if not self.tenancy:
            return None
        tn = self.tenants
        return tn if isinstance(tn, tuple) else (tn,) * self.lanes

    @property
    def backfilling(self) -> bool:
        """Whether any lane runs a non-``none`` backfill mode."""
        bf = self.backfill
        modes = (bf,) if isinstance(bf, str) else bf
        return any(m != BackfillMode.NONE.value for m in modes)

    @property
    def park_capacity(self) -> int:
        """Deferral-queue size: 0 when no lane backfills."""
        return self.backfill_queue if self.backfilling else 0

    def replace(self, **changes) -> "ServiceConfig":
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_engine_kwargs(cls, n_pe: int, engine: str = "device",
                           **kwargs) -> "ServiceConfig":
        """Translate ``make_scheduler`` kwargs to a config.

        Device kwargs map onto the config's fields (with the engine's
        own ``capacity=256`` default); host/list kwargs pass through
        ``engine_kwargs`` to the engine's constructor, which rejects
        unknown names.
        """
        if engine != "device":
            return cls(n_pe=n_pe, engine=engine,
                       engine_kwargs=dict(kwargs) or None)
        known = {"capacity", "pending_capacity", "use_kernel", "device"}
        unknown = set(kwargs) - known
        if unknown:
            raise TypeError(
                f"unknown device engine kwargs {sorted(unknown)}; "
                f"supported: {sorted(known)}")
        return cls(n_pe=n_pe, engine=engine,
                   **{"capacity": 256, **kwargs})


PolicyLike = Union[Policy, int, str]


def policy_id_of(policy: PolicyLike) -> int:
    """Any policy spelling -> its int32 id."""
    if isinstance(policy, str):
        policy = Policy(policy)
    if isinstance(policy, Policy):
        return policy_index(policy)
    return int(policy)
