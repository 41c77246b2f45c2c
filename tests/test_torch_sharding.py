"""The port's placement rules against the JAX package's.

``param_specs`` of all ten configurations equals the reference's leaf
for leaf, built on shapes alone: ``jax.eval_shape`` on the reference
side, the ``meta`` device (or the reference's shapes) on the port's.
The reference's ``PartitionSpec`` is compared as ``tuple(spec)``.  The
port's per-layer leaves take the reference's stacked spec past the
layer axis.  ``zero_specs``, ``fit_sharding``, ``batch_spec``,
``lane_spec`` and ``probe_spec`` mirror ``tests/test_sharding_roofline.py``.
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_config
from repro.launch import mesh as ref_mesh
from repro.models import transformer as ref_tf
from repro.sharding import rules as ref_rules
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tf
from repro_torch.sharding import rules


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every port test file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_shapes(arch):
    cfg = ref_config(arch)
    return jax.eval_shape(lambda k: ref_tf.init_params(cfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


def _as_meta(tree):
    """The reference's shape tree as meta tensors."""
    return {k: _as_meta(v) if isinstance(v, dict) else
            torch.empty(v.shape, device="meta") for k, v in tree.items()}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _ref_specs(shapes):
    specs = ref_rules.param_specs(shapes)
    return {k: tuple(v) for k, v in _flat(
        jax.tree.map(lambda s: s, specs, is_leaf=lambda x: isinstance(x, P)),
    ).items()}


def _canon(spec):
    """A spec with one-name tuples read as the name (``PartitionSpec``
    normalises them so in some jax versions, not in others)."""
    return tuple(ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
                 for ax in spec)


def test_same_arch_list():
    assert list(ARCH_IDS) == list(REF_ARCH_IDS) and len(ARCH_IDS) == 10


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch):
    shapes = _ref_shapes(arch)
    want = _ref_specs(shapes)
    # the same rules on the reference's own shapes
    got = _flat(rules.param_specs(_as_meta(shapes)))
    assert got == want
    n_model = sum(ax == "model" for spec in got.values() for ax in spec)
    assert n_model > 0, f"{arch}: nothing sharded at all"
    # the port's model: layer i's spec is the stacked leaf's past the
    # layer axis (``layers``, the ssm family's ``slstm_layers``, the
    # encdec family's ``enc_layers`` and the encdec / vlm families'
    # ``cross_layers``: their 0-d gates take the ``[n]`` leaf's ``()``);
    # unstacked leaves (the hybrid family's ``shared_attn``) take the
    # reference's own
    cfg = get_config(arch)
    assert cfg.family in tf.FAMILIES
    model = tf.Transformer(cfg, device="meta")
    specs = rules.param_specs(model)
    stacked = ("layers", "slstm_layers", "enc_layers", "cross_layers")
    rows = {k: _flat(shapes)[k].shape[0] for k in want if k[0] in stacked}
    assert len(specs) == sum(rows.get(k, 1) for k in want)
    for name, spec in specs.items():
        parts = name.split(".")
        if parts[0] in stacked:
            assert parts[1].isdigit(), name
            ref = want[(parts[0],) + tuple(parts[2:])]
            assert ref[0] is None and spec == ref[1:], name
        else:
            assert spec == want[tuple(parts)], name
        for ax, dim in zip(spec, dict(model.named_parameters())[name].shape):
            if ax == "model":
                assert dim % rules.MODEL_AXIS_SIZE == 0


def test_big_weights_are_sharded_for_dense():
    specs = rules.param_specs(tf.Transformer(get_config("minitron-8b"),
                                             device="meta"))
    assert specs["layers.0.mlp.w_gate"] == (None, "model")
    assert specs["layers.5.attn.wq"] == (None, "model", None)
    assert specs["tok_embed"] == ("model", None)


def test_moe_experts_sharded():
    specs = rules.param_specs(tf.Transformer(get_config("kimi-k2-1t-a32b"),
                                             device="meta"))
    # 2D expert sharding: experts over model, FFN dim over data axes
    assert specs["layers.0.moe.w_gate"] == ("model", None, ("pod", "data"))
    assert specs["layers.0.moe.w_down"] == ("model", ("pod", "data"), None)


def test_indivisible_heads_fall_back_to_replication():
    specs = rules.param_specs(tf.Transformer(get_config("starcoder2-7b"),
                                             device="meta"))
    assert specs["layers.0.attn.wq"] == (None, None, None)
    assert specs["layers.0.mlp.w_gate"] == (None, "model")


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["minitron-8b", "kimi-k2-1t-a32b",
                                  "zamba2-7b", "xlstm-1.3b"])
def test_zero_specs_equal_reference(arch, multi_pod):
    shapes = _ref_shapes(arch)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    # the rules read only axis names and sizes: one stand-in mesh serves
    # both sides (the reference's Mesh needs the cards themselves)
    duck = types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, sizes)))
    want = ref_rules.zero_specs(ref_rules.param_specs(shapes), shapes, duck)
    want = {k: _canon(tuple(v)) for k, v in _flat(want).items()}
    meta = _as_meta(shapes)
    port_mesh = mesh_lib.Mesh(names, sizes, (torch.device("meta"),)
                              * int(np.prod(sizes)))
    got = _flat(rules.zero_specs(rules.param_specs(meta), meta, port_mesh))
    assert got == want
    assert any(("data" in ax if isinstance(ax, tuple) else ax == "data")
               for spec in got.values() for ax in spec if ax is not None)
    if tf.FAMILIES.count(get_config(arch).family):
        model = tf.Transformer(get_config(arch), device="meta")
        z = rules.zero_specs(rules.param_specs(model), model, port_mesh)
        assert len(z) == len(dict(model.named_parameters()))


def test_fit_sharding_and_leaf_specs():
    for nd in (1, 2, 3):
        assert rules.lane_spec(nd) == tuple(ref_rules.lane_spec(nd))
        assert rules.batch_spec(nd) == tuple(ref_rules.batch_spec(nd))
        assert rules.batch_spec(nd, nd - 1) == \
            tuple(ref_rules.batch_spec(nd, nd - 1))
    for nd in (2, 3, 4):
        assert rules.probe_spec(nd) == tuple(ref_rules.probe_spec(nd))
    # on the one-device host mesh, against the reference's own
    host_r, host_p = ref_mesh.make_host_mesh(), mesh_lib.make_host_mesh("cpu")
    cases = [((8, 3), rules.lane_spec(2)), ((5,), rules.lane_spec(1)),
             ((4, 6, 2), rules.probe_spec(3)), ((16, 32), ("model", "data")),
             ((7, 9), (("pod", "data"), "model"))]
    for shape, spec in cases:
        want = ref_rules.fit_sharding(host_r, shape, P(*spec)).spec
        assert rules.fit_sharding(host_p, shape, spec) == \
            _canon(tuple(want))
    # on a 4-way lane mesh: indivisible and missing axes drop per dim
    lane = mesh_lib.Mesh(("data",), (4,),
                         tuple(torch.device("cuda", i) for i in range(4)))
    assert rules.fit_sharding(lane, (8, 3), rules.lane_spec(2)) == \
        ("data", None)
    assert rules.fit_sharding(lane, (6, 3), rules.lane_spec(2)) == \
        (None, None)
    assert rules.fit_sharding(lane, (5, 8), rules.probe_spec(2)) == \
        (None, "data")
    assert rules.fit_sharding(lane, (8, 8), ("model", "data")) == \
        (None, "data")
