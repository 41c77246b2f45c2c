"""The port's checkpoint manager: the twins of ``tests/test_checkpoint.py``
(exact roundtrip including bfloat16, async saves, GC, no visible
``.tmp``, a structure mismatch raising) and cross restores with the JAX
package's manager.

Both sides write the same layout (one ``leaf_<i>.npy`` per leaf in
``jax.tree.flatten`` order, bfloat16 as its 16 bits), so a ``(params,
opt_state)`` written by the reference's ``CheckpointManager`` is restored
by the port's, and the reverse, bit-equal on every leaf, for bfloat16
reduced configs of the dense, hybrid (``shared_attn`` unstacked, float32
Mamba leaves), ssm (``slstm_layers``) and vlm (``cross_layers`` with
their float32 gates, ``img_proj``) families.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import get_config as ref_config
from repro.models import transformer as ref_tf
from repro.train import optim as ref_optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as mgr_lib
from repro_torch.configs import get_config
from repro_torch.models import transformer as tf
from repro_torch.train import optim


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every port test file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((8, 16), generator=g),
        "b16": torch.randn((4, 4), generator=g).to(torch.bfloat16),
        "step": torch.tensor(7, dtype=torch.int32),
        "nested": {"u": torch.arange(5, dtype=torch.int32)},
    }


def _leaves(tree):
    return mgr_lib.flatten(tree)[0]


def test_roundtrip_exact(tmp_path):
    mgr = CheckpointManager(tmp_path)
    state = _state(0)
    mgr.save(3, state, {"loss": 1.5})
    restored, step, meta = mgr.restore(state)
    assert step == 3 and meta["loss"] == 1.5
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(tmp_path)
    state = _state(1)
    mgr.save_async(5, state)
    # the snapshot was taken before save_async returned: an in-place
    # update now must not reach the files
    want = state["w"].clone()
    state["w"].add_(1.0)
    mgr.wait()
    restored, step, _ = mgr.restore(state)
    assert step == 5
    assert torch.equal(restored["w"], want)


def test_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = _state(2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_tmp_dirs_never_visible(tmp_path):
    mgr = CheckpointManager(tmp_path)
    state = _state(3)
    mgr.save(1, state)
    assert not list(tmp_path.glob("*.tmp"))
    # manifest must parse and carry dtype info for the bf16 leaf
    man = json.loads(
        (tmp_path / "step_00000001" / "manifest.json").read_text())
    assert "bfloat16" in man["dtypes"]
    assert man["n_leaves"] == 4 and "nested" in man["treedef"]


def test_structure_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _state(4))
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore({"only": torch.zeros((2,))})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(_state(4))


def test_flatten_order_is_jax_tree_flatten():
    tree = {"b": (1.0, {"z": np.zeros(2), "a": np.ones(3)}), "a": None,
            "c": [np.arange(2), np.float32(4)],
            "o": optim.OptState(step=np.int32(1), mu={"y": 2.0, "x": 3.0},
                                nu={"k": 5.0})}
    mine = _leaves(tree)
    ref = jax.tree.flatten(tree)[0]
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert mgr_lib.unflatten(tree, mine)["o"].mu == {"y": 2.0, "x": 3.0}


# ---------------------------------------------------------------------------
# cross restores with the JAX package
# ---------------------------------------------------------------------------

ARCHS = ["stablelm-1.6b", "zamba2-7b", "xlstm-1.3b", "llama-3.2-vision-11b"]


def _ref_state(arch):
    """A bf16 reduced model on the reference side with float32 moments
    of random values and step 5."""
    cfg = dataclasses.replace(ref_config(arch).reduced(), dtype="bfloat16")
    params = ref_tf.init_params(cfg, jax.random.PRNGKey(3))
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(4)
    mu = jax.tree.unflatten(treedef, [jnp.asarray(
        rng.normal(size=p.shape), jnp.float32) for p in leaves])
    nu = jax.tree.unflatten(treedef, [jnp.asarray(
        rng.random(p.shape), jnp.float32) for p in leaves])
    return params, ref_optim.OptState(step=jnp.int32(5), mu=mu, nu=nu)


def _port_state(arch):
    cfg = get_config(arch).reduced()
    assert cfg.dtype == "bfloat16"
    params = tf.init_params(cfg, seed=6, device="cpu")
    opt = optim.init(params, optim.OptConfig())
    g = torch.Generator().manual_seed(7)
    for k in opt.mu:
        opt.mu[k].normal_(generator=g)
        opt.nu[k].uniform_(generator=g)
    return cfg, params, opt._replace(step=torch.tensor(9, dtype=torch.int32))


def _bits(a) -> np.ndarray:
    """A leaf's exact bits as an integer array (bf16 through its view)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().reshape(-1)
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy().view(np.uint8)
    a = np.asarray(a).reshape(-1)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else \
        a.view(np.uint8)


def _same(port_leaf, ref_leaf):
    assert str(port_leaf.dtype).split(".")[-1] == np.asarray(
        ref_leaf).dtype.name
    assert tuple(port_leaf.shape) == tuple(np.asarray(ref_leaf).shape)
    np.testing.assert_array_equal(_bits(port_leaf), _bits(ref_leaf))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_restores_what_the_reference_wrote(arch, tmp_path):
    ref_params, ref_opt = _ref_state(arch)
    RefManager(tmp_path).save(5, (ref_params, ref_opt), {"arch": arch})
    cfg, params, opt = _port_state(arch)
    like = tf.state_to_reference(params, opt, device="meta")
    state, step, meta = CheckpointManager(tmp_path).restore(like,
                                                           device="cpu")
    assert step == 5 and meta == {"arch": arch}
    params, opt = tf.state_from_reference(state, cfg, params, opt)
    back = tf.state_to_reference(params, opt)
    mine, ref = _leaves(back), jax.tree.leaves((ref_params, ref_opt))
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        _same(a, b)
    assert int(opt.step) == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_restores_what_the_port_wrote(arch, tmp_path):
    cfg, params, opt = _port_state(arch)
    CheckpointManager(tmp_path).save(9, tf.state_to_reference(params, opt),
                                     {"arch": arch})
    like = _ref_state(arch)
    (ref_params, ref_opt), step, _ = RefManager(tmp_path).restore(like)
    assert step == 9 and int(ref_opt.step) == 9
    mine = _leaves(tf.state_to_reference(params, opt))
    ref = jax.tree.leaves((ref_params, ref_opt))
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        _same(a, b)
    # and the port builds the same state anew from the reference's arrays
    p2, o2 = tf.state_from_reference(
        jax.tree.map(np.asarray, (ref_params, ref_opt)), cfg, device="cpu")
    for a, b in zip(_leaves(tf.state_to_reference(p2, o2)), mine):
        assert a.dtype == b.dtype and torch.equal(a, b)
