"""Device meshes: the production shapes and the lane meshes that the
service places ensemble lanes and partitions on.

The port of ``repro/launch/mesh.py``.  A :class:`Mesh` is a small
value: named axes with their sizes and the tuple of
:class:`torch.device` s behind them, row-major.  ``make_lane_mesh``
takes the largest divisor of the lane count that fits the local card
count (``torch.cuda.device_count()`` in a cuda session, 1 on the CPU),
so on one card every placement resolves to the one-device host mesh
and changes nothing.  With ``d > 1`` cards,
:func:`repro_torch.sharding.rules.lane_devices` puts lane ``i`` on card
``i // (E / d)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device

#: cards of one production pod (16 x 16)
POD_CARDS = 256


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes (``axis_names`` with ``axis_sizes``) over ``devices``."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        n = 1
        for s in self.axis_sizes:
            n *= s
        if len(self.axis_names) != len(self.axis_sizes) \
                or n != len(self.devices):
            raise ValueError(
                f"mesh axes {self.axis_names} x {self.axis_sizes} do not "
                f"match {len(self.devices)} devices")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)


def local_device_count(device: DeviceLike = None) -> int:
    """Cards a session on ``device`` can place lanes on (1 on the CPU)."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _production_axes(multi_pod: bool):
    if multi_pod:
        return ("pod", "data", "model"), (2, 16, 16)
    return ("data", "model"), (16, 16)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 cards per pod; 2 pods = 512 cards when multi_pod.

    Raises :class:`ValueError` where fewer cards are present.
    """
    axes, shape = _production_axes(multi_pod)
    need = POD_CARDS * (2 if multi_pod else 1)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise ValueError(f"the production mesh {shape} needs {need} "
                         f"cards; {have} present")
    return Mesh(axes, shape,
                tuple(torch.device("cuda", i) for i in range(need)))


def make_placeholder_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh's axes over ``meta`` placeholder devices: the
    dry-run's mesh (the reference forces 512 host devices for it).  The
    placement rules read only its axis names and sizes."""
    axes, shape = _production_axes(multi_pod)
    return Mesh(axes, shape,
                (torch.device("meta"),) * (POD_CARDS * (2 if multi_pod else 1)))


def make_host_mesh(device: DeviceLike = None) -> Mesh:
    """1 x 1 mesh on one device (``None``: cuda)."""
    return Mesh(("data", "model"), (1, 1), (resolve_device(device),))


def data_shards(mesh: Mesh) -> int:
    shape = mesh.shape
    return shape.get("data", 1) * shape.get("pod", 1)


def make_lane_mesh(n_lanes: int, max_shards: Optional[int] = None,
                   device: DeviceLike = None) -> Mesh:
    """1-D ``("data",)`` mesh for an ensemble / partition axis.

    The largest divisor of ``n_lanes`` that fits the local card count
    (capped by ``max_shards``): 63 lanes on 8 cards place 7 ways, a
    prime lane count on one card resolves to :func:`make_host_mesh` on
    ``device``.  Decisions are the same on every mesh.
    """
    if n_lanes < 1:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    n_dev = local_device_count(device)
    if max_shards is not None:
        n_dev = min(n_dev, max_shards)
    d = max(k for k in range(1, max(n_dev, 1) + 1) if n_lanes % k == 0)
    if d == 1:
        return make_host_mesh(device)
    return Mesh(("data",), (d,),
                tuple(torch.device("cuda", i) for i in range(d)))


def resolve_placement(placement: Union[None, str, int], n_lanes: int,
                      device: DeviceLike = None) -> Optional[Mesh]:
    """``ServiceConfig.placement`` -> the mesh lanes are placed on.

    ``None`` / ``"single"``: no mesh (every lane on ``device``);
    ``"auto"``: :func:`make_lane_mesh` over every local card;
    ``"host"``: the 1 x 1 :func:`make_host_mesh`; an ``int`` caps the
    shard count.
    """
    if placement is None or placement == "single":
        return None
    if placement == "host":
        return make_host_mesh(device)
    if placement == "auto":
        return make_lane_mesh(n_lanes, device=device)
    if isinstance(placement, int):
        return make_lane_mesh(n_lanes, max_shards=placement, device=device)
    raise ValueError(f"unknown placement {placement!r}")
