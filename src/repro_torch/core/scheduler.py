"""Engine facade: one API over the list, host and device engines.

All three expose the paper's three operations (``add_allocation``,
``delete_allocation``, ``find_allocation``).  ``list`` (the literal
``AvailRectList`` of :mod:`repro_torch.core.listsched`) and ``host``
(the numpy engine of :mod:`repro_torch.core.hostsched`) run on the
host, and only when a caller names them.  :class:`DeviceEngine`
holds one :class:`~repro_torch.core.timeline.SchedulerState` on the
card and adds the fused ``admit`` step and the ``admit_stream`` batch
path of :mod:`repro_torch.core.batch`.  Capacity overflow grows the
state to the needed record count and re-runs.  ``rspec`` makes the
engine multi-resource: PE ids become global bit ids across planes, and
requests carry their ``demand`` vectors; ``index_tile`` attaches the
availability index.

``make_scheduler`` and ``DeviceScheduler`` are the reference's
deprecated entry points, kept as shims over the service API.
``park_capacity`` sizes the state's backfilling deferral queue (the
service's sessions pass the mode); ``tenants`` (a
:class:`~repro_torch.tenancy.TenantSpec`) attaches a tenant table.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence, Union

from repro_torch.core import batch as batch_lib
from repro_torch.core import search as search_lib
from repro_torch.core import timeline as tl_lib
from repro_torch.core.hostsched import HostScheduler
from repro_torch.core.listsched import ListScheduler
from repro_torch.core.policies import policy_index
from repro_torch.core.types import Allocation, ARRequest, Policy, T_INF
from repro_torch.device import DeviceLike
from repro_torch.tenancy import init_table


class DeviceEngine:
    """Device-resident scheduler with the HostScheduler interface."""

    def __init__(self, n_pe: int, capacity: int = 256,
                 use_kernel: bool = True, pending_capacity: int = 256,
                 device: DeviceLike = None, *, park_capacity: int = 0,
                 rspec=None, live_units=None,
                 index_tile: Optional[int] = None, tenants=None):
        self.n_pe = n_pe
        self.use_kernel = use_kernel
        # valid-record count for the search bucket; None = stale
        # (recounted on the next search)
        self._n_valid: Optional[int] = 0
        table = None
        if tenants is not None:
            table = init_table(tenants, pending_capacity, park_capacity,
                               device)
        self.state = tl_lib.init_state(capacity, n_pe, pending_capacity,
                                       device=device,
                                       park_capacity=park_capacity,
                                       rspec=rspec, live_units=live_units,
                                       index_tile=index_tile,
                                       tenants=table)

    @property
    def tl(self) -> tl_lib.Timeline:
        return self.state.tl

    def _set_tl(self, new_tl: tl_lib.Timeline) -> None:
        self.state = self.state._replace(tl=new_tl)
        self._n_valid = None

    def _mask32(self, pes):
        # on multi-resource states ids are global bit ids spanning every
        # plane, so the word width bounds them; otherwise the machine
        limit = None if self.state.rspec is not None else self.n_pe
        return tl_lib.ids_to_mask32(sorted(pes), self.tl.words, n_pe=limit,
                                    device=self.tl.device)

    def _update(self, t_s: int, t_e: int, pes, is_add: bool) -> None:
        mask = self._mask32(pes)
        new_tl, overflow, n_keep = tl_lib.update(
            self.tl, t_s, t_e, mask, is_add=is_add, with_count=True)
        if bool(overflow):
            # grow once to the needed record count, then redo
            self.state = tl_lib.grow_state(self.state, new_capacity=max(
                2 * self.tl.capacity, tl_lib.next_pow2(int(n_keep))))
            new_tl, overflow = tl_lib.update(self.tl, t_s, t_e, mask,
                                             is_add=is_add)
            if bool(overflow):
                raise RuntimeError("update overflowed after growth")
        self._set_tl(new_tl)

    def _search_view(self) -> tl_lib.Timeline:
        """Smallest power-of-two prefix covering the valid records.

        The search walks capacity-sized tensors; searching the prefix
        cuts that work when the timeline is mostly empty (padding rows
        never change a decision).  With the index, a prefix that is a
        whole number of tiles keeps the prefix of the summaries (they
        summarise the same rows); a shorter one is searched without the
        index, which decides the same.
        """
        if self._n_valid is None:
            self._n_valid = int(self.tl.n_valid())
        k = 16
        while k < self._n_valid:
            k *= 2
        tl = self.tl
        k = min(k, tl.capacity)
        view = tl_lib.Timeline(times=tl.times[:k], occ=tl.occ[:k])
        if tl.ispec is None or k % tl.ispec.tile:
            return view
        nt = k // tl.ispec.tile
        return view._replace(idx_occ=tl.idx_occ[:nt],
                             idx_minfree=tl.idx_minfree[:nt],
                             idx_maxfree=tl.idx_maxfree[:nt], ispec=tl.ispec)

    # -- the three operations ------------------------------------------
    def add_allocation(self, t_s: int, t_e: int, pes) -> None:
        self._update(t_s, t_e, pes, is_add=True)

    def delete_allocation(self, t_s: int, t_e: int, pes) -> None:
        self._update(t_s, t_e, pes, is_add=False)

    def find_allocation(self, req: ARRequest, policy: Policy,
                        t_now: Optional[int] = None) -> Optional[Allocation]:
        t_now = req.t_a if t_now is None else t_now
        res = search_lib.find_allocation(
            self._search_view(), req.t_r, req.t_du, req.t_dl, req.n_pe,
            policy_index(policy), t_now, n_pe=self.n_pe,
            use_kernel=self.use_kernel, rspec=self.state.rspec,
            demand_tail=batch_lib.request_demand(self.state, req),
            valid_mask=self.state.lane_valid)
        return batch_lib.search_result_to_allocation(res)

    # -- the fused batch path --------------------------------------------
    def admit(self, req: ARRequest, policy: Policy,
              auto_release: bool = True) -> Optional[Allocation]:
        """Fused find + commit.

        With ``auto_release`` the committed reservation joins the
        pending-release buffer and every earlier reservation ending by
        ``req.t_a`` is deleted first; do not mix this mode with manual
        ``delete_allocation`` of the same reservations.
        """
        self.state, alloc = batch_lib.admit_one(
            self.state, req, policy, n_pe=self.n_pe,
            auto_release=auto_release, use_kernel=self.use_kernel)
        self._n_valid = None
        return alloc

    def admit_stream(self,
                     requests: Union[batch_lib.RequestBatch,
                                     Sequence[ARRequest]],
                     policy: Policy,
                     auto_release: bool = True) -> batch_lib.Decision:
        """Admit a whole arrival-ordered stream; stacked decisions.

        Overflow mid-stream grows the state and re-runs the stream.
        """
        if not isinstance(requests, batch_lib.RequestBatch):
            spec = self.state.rspec
            requests = batch_lib.requests_to_batch(
                list(requests), device=self.tl.device,
                extra_demand=0 if spec is None else spec.R - 1)
        self.state, dec = batch_lib.admit_stream_grow(
            self.state, requests, policy, n_pe=self.n_pe,
            auto_release=auto_release, use_kernel=self.use_kernel)
        self._n_valid = None
        return dec

    def records(self):
        times = self.tl.times.cpu().numpy()
        occ = self.tl.occ.cpu().numpy()
        return [(int(t), frozenset(batch_lib.mask32_to_ids(row)))
                for t, row in zip(times, occ) if t < T_INF]


class DeviceScheduler(DeviceEngine):
    """Deprecated alias of :class:`DeviceEngine`.

    Open a :class:`repro_torch.api.ReservationService` session instead:
    it has the same three operations plus the streaming verbs, and
    ``session.engine`` is the underlying :class:`DeviceEngine`.
    """

    def __init__(self, *args, **kwargs):
        warnings.warn(
            "DeviceScheduler is deprecated: use repro_torch.api."
            "ReservationService(ServiceConfig(n_pe=..., "
            "engine='device')).session(); the session has the same "
            "three operations plus offer/tick/cancel, and "
            "session.engine exposes the raw DeviceEngine",
            DeprecationWarning, stacklevel=2)
        super().__init__(*args, **kwargs)


ENGINES = {
    "list": ListScheduler,
    "host": HostScheduler,
    "device": DeviceEngine,
}


def _make_engine(n_pe: int, engine: str = "device", **kwargs):
    """Engine factory."""
    try:
        cls = ENGINES[engine]
    except KeyError:
        raise ValueError(
            f"unknown engine {engine!r}; pick one of {sorted(ENGINES)}")
    return cls(n_pe, **kwargs)


def make_scheduler(n_pe: int, engine: str = "device", **kwargs):
    """Deprecated factory over the three engines.

    ``ReservationService(ServiceConfig(n_pe=..., engine=...)).session()
    .engine`` is the same engine object, and the session adds the
    streaming verbs.  ``engine="device"`` (the default) takes the
    device engine's knobs (``capacity``, ``pending_capacity``,
    ``use_kernel``, ``device``; ``device=None`` is cuda), the host
    engines their constructor's.
    """
    warnings.warn(
        "make_scheduler is deprecated: use repro_torch.api."
        "ReservationService(ServiceConfig(n_pe=..., engine=..., ...))"
        ".session() (session.engine is the raw engine object)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.api import ReservationService, ServiceConfig
    cfg = ServiceConfig.from_engine_kwargs(n_pe, engine, **kwargs)
    return ReservationService(cfg).session().engine
