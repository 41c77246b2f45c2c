"""Logical -> mesh placement rules for parameters, inputs and lanes.

The port of ``repro/sharding/rules.py``.  A spec is a plain tuple with
one entry per dimension: ``None`` (replicated), a mesh axis name, or a
tuple of names (the dimension split over their product), as the
reference's ``PartitionSpec`` reads when taken apart with ``tuple()``.

``param_specs`` walks a model's parameters by the reference's leaf
names (``attn.wq`` ``[d, H, hd]``, ``moe.w_gate`` ``[E, d, f]``, ...):
Megatron-style tensor parallelism over ``"model"``, experts over
``"model"`` with their ffn dimension over the data axes, heads for the
SSM / mLSTM families; a dimension the 16-way model axis does not divide
stays replicated.  Rules count axes from the end, so the port's
per-layer leaves and the reference's stacked ``[L, ...]`` ones get the
same spec past the layer axis.  ``zero_specs`` adds the data axes to
optimizer state (ZeRO-1).

The ensemble rules place lanes rather than shard arrays: the port's
ensemble is a tuple of one-lane states (:mod:`repro_torch.core.
ensemble`), and :func:`shard_ensemble` puts lane ``i`` on the mesh's
card ``i // (E / d)`` (:func:`lane_devices`).  On a one-device mesh it
is the identity.  Cross-lane reads (collective growth, the fleet's
probe, ``metrics()`` sums) gather the lanes' values onto lane 0's card
and read them from there, as the lane-by-lane step reads them on one
card, so the reference's ``shard_probe`` has no counterpart.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

from torch import nn

from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.launch.mesh import Mesh, data_shards

# (parent-context, leaf-name) -> index of the axis sharded over "model";
# negative indices count from the end so stacked [L, ...] and per-layer
# weights share one rule.  None context = any parent.
_MODEL_AXIS_RULES = [
    ("moe", "w_gate", -3),      # [.., E, d, f] -> experts
    ("moe", "w_up", -3),
    ("moe", "w_down", -3),
    ("moe", "router", -1),
    ("mlp", "w_gate", -1),      # [.., d, f] -> ff
    ("mlp", "w_up", -1),
    ("mlp", "w_down", -2),
    ("attn", "wq", -2),         # [.., d, H, hd] -> heads
    ("attn", "wk", -2),
    ("attn", "wv", -2),
    ("attn", "wo", -3),         # [.., H, hd, d]
    ("ssm", "w_in", -1),
    ("ssm", "w_out", -2),
    ("ssm", "conv_w", -1),
    ("ssm", "conv_b", -1),
    ("ssm", "a_log", -1),
    ("ssm", "d_skip", -1),
    ("ssm", "dt_bias", -1),
    ("ssm", "norm", -1),
    ("mlstm", "w_qkv", -2),     # [.., d, H, 3hd] -> heads
    ("mlstm", "w_if", -2),
    ("mlstm", "w_gate", -1),
    ("mlstm", "w_out", -2),
    ("mlstm", "norm", -2),
    ("slstm", "w_x", -2),
    ("slstm", "r_h", -3),
    ("slstm", "bias", -2),
    ("slstm", "norm", -2),
    (None, "tok_embed", 0),     # vocab-sharded embedding
    (None, "lm_head", -1),
    (None, "enc_embed_proj", -1),
    (None, "img_proj", -1),
]


MODEL_AXIS_SIZE = 16   # fixed by the production mesh (16x16 / 2x16x16)
DATA_AXES_SIZE = 16    # secondary (fully-sharded) axis, per pod

# MoE expert tensors additionally shard their ffn/d axis over the data
# axes (2D expert sharding): a trillion-parameter expert bank cannot
# live 16-way sharded.
_DATA_AXIS_RULES = {
    ("moe", "w_gate"): -1,   # [.., E, d, f] -> f over data
    ("moe", "w_up"): -1,
    ("moe", "w_down"): -2,   # [.., E, f, d] -> f over data
}

Spec = Tuple[Any, ...]


def _axes(names: Sequence[str]) -> Any:
    """A dimension's mesh axes: one name alone, several as a tuple (a
    ``PartitionSpec`` reads a one-name tuple as the name)."""
    names = tuple(names)
    return names[0] if len(names) == 1 else names


def spec_for(names: Sequence[str], shape: Sequence[int]) -> Spec:
    """The spec of the leaf at path ``names`` (its last entry the leaf's
    name) with ``shape``."""
    leaf_name = names[-1] if names else ""
    parents = set(names[:-1])
    ndim = len(shape)
    for ctx, name, axis in _MODEL_AXIS_RULES:
        if name != leaf_name:
            continue
        if ctx is not None and ctx not in parents:
            continue
        if ndim == 0:
            return ()
        ax = axis % ndim
        if shape[ax] % MODEL_AXIS_SIZE != 0:
            # replicated fallback: the dimension must divide (e.g.
            # starcoder2's 36 heads, 8-of-16 KV heads)
            return (None,) * ndim
        spec = [None] * ndim
        spec[ax] = "model"
        for (d_ctx, d_name), d_axis in _DATA_AXIS_RULES.items():
            if d_name == leaf_name and d_ctx in parents:
                dax = d_axis % ndim
                if dax != ax and shape[dax] % DATA_AXES_SIZE == 0:
                    spec[dax] = ("pod", "data")
        return tuple(spec)
    return (None,) * ndim


def _is_tree(x) -> bool:
    return isinstance(x, Mapping)


def param_specs(params) -> Any:
    """Specs matching ``params``.

    An ``nn.Module`` gives ``{parameter name: spec}`` (names split on
    ``.``, so ``layers.3.attn.wq`` has parents ``layers``, ``3`` and
    ``attn``); a nested mapping of arrays (anything with ``.shape``)
    gives a nested mapping of specs.
    """
    if isinstance(params, nn.Module):
        return {name: spec_for(name.split("."), p.shape)
                for name, p in params.named_parameters()}

    def walk(path, node):
        return {k: walk(path + (k,), v) if _is_tree(v)
                else spec_for(path + (k,), v.shape)
                for k, v in node.items()}
    return walk((), params)


def _leaves(params) -> Mapping:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def zero_specs(specs, params, mesh: Mesh) -> Any:
    """ZeRO-1: shard optimizer state over the data axes too (on the
    first free *divisible* dimension of each tensor)."""
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dn = 1
    for a in data_axes:
        dn *= mesh.shape[a]

    def add_data(spec: Spec, leaf) -> Spec:
        shape = tuple(leaf.shape)
        size = 1
        for s in shape:
            size *= s
        if not shape or size < 1024 or not data_axes:
            return spec
        axes = list(spec) + [None] * (len(shape) - len(spec))
        if any(isinstance(a, (tuple, list)) or a in ("pod", "data")
               for a in axes if a is not None):
            return spec    # already data-sharded (2D expert weights)
        for i in range(len(shape)):
            if axes[i] is None and shape[i] % dn == 0:
                axes[i] = _axes(data_axes)
                return tuple(axes)
        return spec

    def walk(sp, pr):
        return {k: walk(v, pr[k]) if _is_tree(v) else add_data(v, pr[k])
                for k, v in sp.items()}
    return walk(specs, _leaves(params))


def batch_spec(ndim: int, batch_axis: int = 0) -> Spec:
    axes: list = [None] * ndim
    axes[batch_axis] = ("pod", "data")
    return tuple(axes)


LANE_DATA_AXES = ("pod", "data")


def lane_spec(ndim: int) -> Spec:
    """Leading lane axis over the data mesh axes, rest replicated."""
    return (LANE_DATA_AXES,) + (None,) * (ndim - 1)


def probe_spec(ndim: int) -> Spec:
    """Spec for ``[N, E, ...]`` fleet-probe tensors: the lane axis is
    the second one (requests lead)."""
    return (None, LANE_DATA_AXES) + (None,) * (ndim - 2)


def fit_sharding(mesh: Mesh, shape: Sequence[int], spec: Spec) -> Spec:
    """``spec`` with axes missing from ``mesh`` or not dividing their
    dimension dropped, per dimension."""
    names = set(mesh.axis_names)
    sizes = mesh.shape

    def extent(ax) -> int:
        if isinstance(ax, (tuple, list)):
            n = 1
            for a in ax:
                n *= sizes[a]
            return n
        return sizes[ax]

    axes = []
    for i, ax in enumerate(spec):
        if ax is None:
            axes.append(None)
            continue
        if isinstance(ax, (tuple, list)):
            ax = tuple(a for a in ax if a in names)
            ax = _axes(ax) if ax else None
        elif ax not in names:
            ax = None
        if ax is not None and shape[i] % extent(ax) != 0:
            ax = None
        axes.append(ax)
    return tuple(axes)


def lane_devices(mesh: Optional[Mesh], n_lanes: int,
                 device: DeviceLike = None) -> tuple:
    """The card of each lane: lane ``i`` on data shard ``i // (E / d)``
    of ``mesh`` (every lane on ``device`` without a mesh)."""
    if mesh is None:
        return (resolve_device(device),) * n_lanes
    d = data_shards(mesh)
    if n_lanes % d:
        raise ValueError(f"{n_lanes} lanes do not divide over {d} shards")
    per_shard = mesh.size // d          # cards of one data coordinate
    block = n_lanes // d
    return tuple(mesh.devices[(i // block) * per_shard]
                 for i in range(n_lanes))


def shard_ensemble(mesh: Optional[Mesh], states) -> Any:
    """Place the lanes of an ensemble (a tuple of one-lane states) on
    ``mesh`` by :func:`lane_devices`.  ``mesh=None``, and any mesh
    whose cards already hold their lanes, return ``states`` itself."""
    if mesh is None:
        return states
    devs = lane_devices(mesh, len(states), mesh.devices[0])
    if all(s.tl.device == d for s, d in zip(states, devs)):
        return states
    return tuple(to_device(s, d) for s, d in zip(states, devs))
