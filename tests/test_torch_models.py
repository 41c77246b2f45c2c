"""The port's model blocks against the JAX package, on the CPU.

Each block of ``repro_torch.models`` (norms, RoPE, SwiGLU, attention
in its full, blockwise and cached-decode forms, the MoE dispatch, the
Mamba2 and mLSTM / sLSTM blocks with a state carried in, the cross
attention) and all six families end to end (``forward``, ``prefill``,
``decode_step``, the window cache, the encdec and vlm families' cross
K / V) get the same inputs as the
reference: weights from the reference's ``init_params`` carried across
with ``params_from_reference``, activations drawn from a numpy seed.
float32 runs agree within ``rtol = atol = 1e-4``; bfloat16 runs within
the reference's own serving tolerance of 0.12; int8 KV values, the MoE
expert ids, keep mask and slot table are equal.  The vlm family's gates
start at zero, where a gated cross block returns its input whatever the
image, so every vlm comparison first sets them to nonzero values drawn
from the seed on both sides.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import mlp as ref_mlp
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro.models import xlstm as ref_xlstm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xlstm_lib

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.12, atol=0.12)
SERVED = ["qwen3-4b", "stablelm-1.6b", "starcoder2-7b", "minitron-8b",
          "granite-moe-1b-a400m", "kimi-k2-1t-a32b"]
RECURRENT = ["zamba2-7b", "xlstm-1.3b"]
CROSS = ["seamless-m4t-medium", "llama-3.2-vision-11b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are many small ops, which extra
    threads only slow when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32", **kw):
    """The reduced config of ``arch`` on both sides."""
    return (dataclasses.replace(ref_config(arch).reduced(), dtype=dtype, **kw),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype, **kw))


def _models(arch, dtype="float32", seed=0, **kw):
    rcfg, pcfg = _cfgs(arch, dtype, **kw)
    rp = ref_tf.init_params(rcfg, jax.random.PRNGKey(seed))
    pp = tf.params_from_reference(jax.tree.map(np.asarray, rp), pcfg, "cpu")
    return rcfg, pcfg, rp, pp


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _pair(a, dtype):
    """One numpy array on both sides in ``dtype``."""
    return (jnp.asarray(a, jnp.float32).astype(dtype),
            torch.from_numpy(np.asarray(a, np.float32)).to(
                getattr(torch, dtype)))


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.normal(size=(2, 5, 64)) * 3, dtype)
    jw, tw = _pair(rng.normal(size=(64,)), dtype)
    got = common.rms_norm(tx, tw, 1e-6)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(ref_common.rms_norm(jx, jw)),
                               **(F32 if dtype == "float32" else BF16))


def test_rope_tables_and_rotation():
    cos_r, sin_r = ref_common.rope_freqs(32, 300, 1e6)
    cos_p, sin_p = common.rope_freqs(32, 300, 1e6)
    np.testing.assert_allclose(cos_p.numpy(), np.asarray(cos_r), **F32)
    np.testing.assert_allclose(sin_p.numpy(), np.asarray(sin_r), **F32)
    # angles at given positions are the table's rows, bit for bit
    pos = torch.tensor([[0, 7, 299], [5, 5, 1]])
    c, s = common.rope_angles(32, 1e6, pos)
    assert torch.equal(c, cos_p[pos]) and torch.equal(s, sin_p[pos])
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.normal(size=(2, 3, 4, 32)), "float32")
    np.testing.assert_allclose(
        common.apply_rope(tx, cos_p, sin_p).numpy(),
        np.asarray(ref_common.apply_rope(jx, cos_r, sin_r)), **F32)
    np.testing.assert_allclose(
        common.apply_rope(tx, cos_p, sin_p, pos).numpy(),
        np.asarray(ref_common.apply_rope(jx, cos_r, sin_r,
                                         jnp.asarray(pos.numpy()))), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(dtype):
    _, _, rp, pp = _models("stablelm-1.6b", dtype)
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.normal(size=(2, 6, 128)), dtype)
    got = mlp_lib.mlp(pp.layers[0].mlp, tx)
    want = ref_mlp.mlp(_layer0(rp["layers"]["mlp"]), jx)
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16))


def test_count_params_and_init():
    for arch in SERVED + RECURRENT + CROSS:
        rcfg, pcfg = _cfgs(arch)
        rp = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
        model = tf.init_params(pcfg, seed=0, device="cpu")
        assert common.count_params(model) == ref_common.count_params(rp)
        # the full-width model on the meta device counts the same
        full = tf.Transformer(get_config(arch), device="meta")
        want = jax.eval_shape(
            lambda k: ref_tf.init_params(ref_config(arch), k),
            jax.ShapeDtypeStruct((2,), jnp.uint32))
        assert common.count_params(full) == ref_common.count_params(want)
    # random init: float32 normals scaled and cast, norms at one
    m = tf.init_params(_cfgs("qwen3-4b", "bfloat16")[1], seed=3, device="cpu")
    assert m.layers[0].attn.wq.dtype == torch.bfloat16
    assert torch.all(m.layers[1].attn.q_norm == 1)
    assert abs(float(m.tok_embed.float().std()) - 0.02) < 2e-3
    w = m.layers[0].mlp.w_down.float()
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.05
    m2 = tf.init_params(_cfgs("qwen3-4b", "bfloat16")[1], seed=3,
                        device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 m2.parameters()))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(rng, b, t, s, hq, hkv, hd, dtype="float32"):
    return (_pair(rng.normal(size=(b, t, hq, hd)), dtype),
            _pair(rng.normal(size=(b, s, hkv, hd)), dtype),
            _pair(rng.normal(size=(b, s, hkv, hd)), dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_masked(dtype):
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 6, 9, 4, 2, 16, dtype)
    m = rng.random((2, 1, 6, 9)) < 0.7
    m[..., 0] = True
    got = attn._sdpa(tq, tk, tv, torch.from_numpy(m), 2)
    want = ref_attn._sdpa(jq, jk, jv, jnp.asarray(m), 2)
    assert got.dtype == tv.dtype
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("window", [0, 300])
def test_blockwise_sdpa(window):
    rng = np.random.default_rng(4)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, 2048, 2048, 2, 1, 16)
    got = attn._blockwise_sdpa(tq, tk, tv, 2, window)
    want = ref_attn._blockwise_sdpa(jq, jk, jv, 2, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_self_attention_qk_norm(dtype):
    rcfg, pcfg, rp, pp = _models("qwen3-4b", dtype)
    assert pp.layers[0].attn.q_norm is not None
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng.normal(size=(2, 12, 128)), dtype)
    got, (k, v) = attn.self_attention(
        pp.layers[0].attn, tx, pcfg, attn.make_rope(pcfg, 12),
        return_kv=True)
    want, (rk, rv) = ref_attn.self_attention(
        _layer0(rp["layers"]["attn"]), jx, rcfg, ref_attn.make_rope(rcfg, 12),
        return_kv=True)
    tol = F32 if dtype == "float32" else BF16
    for a, b in ((got, want), (k, rk), (v, rv)):
        np.testing.assert_allclose(_np(a), _np(b), **tol)


def test_quantize_kv_exact():
    rng = np.random.default_rng(6)
    for dtype in ("float32", "bfloat16"):
        jx, tx = _pair(rng.normal(size=(2, 7, 4, 32)) * 2, dtype)
        q, s = attn.quantize_kv(tx)
        rq, rs = ref_attn.quantize_kv(jx)
        assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(_np(s), _np(rs))
        np.testing.assert_array_equal(
            _np(attn.dequant_kv(q, s, tx.dtype)),
            _np(ref_attn.dequant_kv(rq, rs, jx.dtype)))


@pytest.mark.parametrize("case", ["full", "window", "int8"])
def test_decode_attention(case):
    kv = "int8" if case == "int8" else "bfloat16"
    rcfg, pcfg, rp, pp = _models("qwen3-4b", kv_cache_dtype=kv)
    window = 16 if case == "window" else 0
    s_max, pos = (16, 37) if window else (24, 13)
    rng = np.random.default_rng(7)
    b, hkv, hd = 2, pcfg.n_kv_heads, pcfg.hd
    cache_np = {"k": rng.normal(size=(b, s_max, hkv, hd)),
                "v": rng.normal(size=(b, s_max, hkv, hd))}
    if kv == "int8":
        cache_np = {"k": rng.integers(-127, 128, (b, s_max, hkv, hd)),
                    "v": rng.integers(-127, 128, (b, s_max, hkv, hd)),
                    "k_scale": rng.random((b, s_max, hkv)) * 0.02,
                    "v_scale": rng.random((b, s_max, hkv)) * 0.02}
    rcache, pcache = {}, {}
    for name, a in cache_np.items():
        if name in ("k", "v") and kv == "int8":
            rcache[name] = jnp.asarray(a, jnp.int8)
            pcache[name] = torch.from_numpy(a.astype(np.int8))
        else:
            dt = "bfloat16" if name.endswith("scale") else "float32"
            rcache[name], pcache[name] = _pair(a, dt)
    jx, tx = _pair(rng.normal(size=(b, 1, 128)), "float32")
    got, new = attn.decode_attention(
        pp.layers[0].attn, tx, pcache, torch.tensor(pos, dtype=torch.int32),
        pcfg, common.rope_angles(pcfg.hd, pcfg.rope_theta,
                                 torch.full((b, 1), pos)), window=window)
    want, rnew = ref_attn.decode_attention(
        _layer0(rp["layers"]["attn"]), jx, rcache, jnp.int32(pos), rcfg,
        ref_attn.make_rope(rcfg, 64), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    slot = pos % s_max if window else pos
    for name in cache_np:
        a, r = new[name], rnew[name]
        if name in ("k", "v") and kv == "int8":
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(_np(a), _np(r), **F32)
        # only the slot changed, in place
        keep = [i for i in range(s_max) if i != slot]
        assert new[name] is pcache[name]
        np.testing.assert_array_equal(_np(a)[:, keep],
                                      np.asarray(cache_np[name],
                                                 _np(a).dtype)[:, keep]
                                      if name in ("k", "v") else
                                      _np(rnew[name])[:, keep])


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

def _spy_reference(monkeypatch):
    seen = {}
    top_k, slot_gate = jax.lax.top_k, ref_moe._slot_gate

    def spy_top_k(x, k):
        seen["gate_vals"], seen["expert_ids"] = out = top_k(x, k)
        return out

    def spy_slot_gate(g, keep, slot, e, cap):
        seen["keep"], seen["slot"], seen["cap"] = keep, slot, cap
        return slot_gate(g, keep, slot, e, cap)
    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    monkeypatch.setattr(ref_moe, "_slot_gate", spy_slot_gate)
    return seen


@pytest.mark.parametrize("case", ["drops", "ties", "quant", "bf16"])
def test_moe_dispatch_exact_and_output_close(case, monkeypatch):
    dtype = "bfloat16" if case == "bf16" else "float32"
    rcfg, pcfg, rp, pp = _models("granite-moe-1b-a400m", dtype,
                                 moe_quant_dispatch=case == "quant")
    rmoe = _layer0(rp["layers"]["moe"])
    pmoe = pp.layers[0].moe
    if case == "ties":
        # experts 3 and 5 get equal logits: top-k must take 3 first
        router = np.asarray(rmoe["router"]).copy()
        router[:, 5] = router[:, 3]
        rmoe = dict(rmoe, router=jnp.asarray(router))
        pmoe.router.copy_(torch.from_numpy(router))
    rng = np.random.default_rng(8)
    jx, tx = _pair(rng.normal(size=(2, 16, 128)), dtype)
    seen = _spy_reference(monkeypatch)
    want, raux = ref_moe.moe(rmoe, jx, rcfg)
    r = moe_lib.route(pmoe, tx.reshape(-1, 128), pcfg)
    got, aux = moe_lib.moe(pmoe, tx, pcfg)
    np.testing.assert_array_equal(r.expert_ids.numpy(),
                                  np.asarray(seen["expert_ids"]))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(seen["keep"]))
    np.testing.assert_array_equal(r.slot.numpy(), np.asarray(seen["slot"]))
    n, e, k, cap = 32, pcfg.n_experts, pcfg.top_k, seen["cap"]
    table = np.full(e * cap + 1, n)
    table[np.asarray(seen["slot"])] = np.repeat(np.arange(n), k)
    np.testing.assert_array_equal(r.table.numpy(),
                                  table[:-1].reshape(e, cap))
    assert 0 < float(aux["dropped_frac"]) < 1     # capacity binds
    if case == "ties":
        ids = r.expert_ids.numpy()
        both = (ids == 3).any(1) & (ids == 5).any(1)
        pos3 = np.argmax(ids == 3, 1)
        pos5 = np.argmax(ids == 5, 1)
        assert both.any() and (pos3[both] < pos5[both]).all()
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(r.gate_vals), _np(seen["gate_vals"]) /
                               _np(seen["gate_vals"]).sum(1, keepdims=True),
                               **F32)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    for name in raux:
        np.testing.assert_allclose(float(aux[name]), float(raux[name]), **F32)


MOE_GRAD_CASES = {
    # case: (dtype, config overrides, x shape)
    "drops": ("float32", {}, (2, 16, 128)),
    "ties": ("float32", {}, (2, 16, 128)),
    "bf16": ("bfloat16", {}, (2, 16, 128)),
    # 3 tokens, top-2, 3 slots an expert: 24 slots for 6 assignments, so
    # at least two experts get none (top-2, not top-1, whose single
    # renormalised gate is 1 and gives the router no gradient)
    "empty": ("float32", {"capacity_factor": 4.0}, (1, 3, 128)),
    "quant": ("float32", {"moe_quant_dispatch": True}, (2, 16, 128)),
}
MOE_LEAVES = ("router", "w_gate", "w_up", "w_down")


@pytest.mark.parametrize("case", list(MOE_GRAD_CASES))
def test_moe_gradients_match_reference(case):
    """The gradients of one fixed cotangent on the layer's output, through
    the port's gathers and through ``jax.vjp`` of the reference, for the
    input and every weight ("quant": the forward, whose int8 dispatch
    the reference shares)."""
    dtype, kw, shape = MOE_GRAD_CASES[case]
    rcfg, pcfg, rp, pp = _models("granite-moe-1b-a400m", dtype, **kw)
    rmoe = _layer0(rp["layers"]["moe"])
    pmoe = pp.layers[0].moe
    if case == "ties":
        router = np.asarray(rmoe["router"]).copy()
        router[:, 5] = router[:, 3]
        rmoe = dict(rmoe, router=jnp.asarray(router))
        pmoe.router.copy_(torch.from_numpy(router))
    rng = np.random.default_rng(9)
    jx, tx = _pair(rng.normal(size=shape), dtype)
    jct, tct = _pair(rng.normal(size=shape), dtype)
    r = moe_lib.route(pmoe, tx.reshape(-1, 128), pcfg)
    n = tx.shape[0] * tx.shape[1]
    if case == "empty":
        assert (r.table == n).all(dim=1).any()      # a whole expert idle
    if case in ("drops", "ties", "bf16"):
        assert not r.keep.all()                     # capacity binds
    tol = F32 if dtype == "float32" else BF16
    if case == "quant":
        got, _ = moe_lib.moe(pmoe, tx, pcfg)
        want, _ = ref_moe.moe(rmoe, jx, rcfg)
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        return

    def ref_out(xx, p):
        return ref_moe.moe(p, xx, rcfg)[0]
    want, vjp = jax.vjp(ref_out, jx, rmoe)
    want_gx, want_gp = vjp(jct)
    leaves = [getattr(pmoe, name) for name in MOE_LEAVES]
    tx.requires_grad_(True)
    for w in leaves:
        w.requires_grad_(True)
    got, _ = moe_lib.moe(pmoe, tx, pcfg)
    grads = torch.autograd.grad(got, [tx] + leaves, grad_outputs=tct)
    np.testing.assert_allclose(_np(got.detach()), _np(want), **tol)
    for name, g, w in zip(("x",) + MOE_LEAVES, grads,
                          [want_gx] + [want_gp[k] for k in MOE_LEAVES]):
        w = _np(w)
        atol = tol["atol"] * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(_np(g), w, rtol=tol["rtol"], atol=atol,
                                   err_msg=name)


def test_moe_scatters_into_no_sentinel_row():
    """The layer's forward and backward at the reduced granite shapes run
    gathers only: no ``index_add`` and no accumulating ``index_put_``,
    which would add every empty slot into the one zero row."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            acc = False
            if name in ("index_put", "index_put_", "_index_put_impl_"):
                acc = bool(kwargs.get("accumulate",
                                      args[3] if len(args) > 3 else False))
            self.seen.append((name, acc))
            return func(*args, **kwargs)

    _, pcfg, _, pp = _models("granite-moe-1b-a400m", "bfloat16")
    pmoe = pp.layers[0].moe
    for w in pmoe.parameters():
        w.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 16, 128)).astype(np.float32)).to(torch.bfloat16)
    x.requires_grad_(True)
    ops = Ops()
    with ops:
        out, aux = moe_lib.moe(pmoe, x, pcfg)
        r = moe_lib.route(pmoe, x.detach().reshape(-1, 128), pcfg)
        loss = out.float().square().sum() + aux["load_balance"]
        torch.autograd.grad(loss, [x] + list(pmoe.parameters()))
    assert not r.keep.all() and (r.table == 2 * 16).any()
    names = {name for name, _ in ops.seen}
    assert "index_select" in names                  # the gathers were seen
    assert not any("index_add" in name for name in names)
    assert not [name for name, acc in ops.seen if acc]


# ---------------------------------------------------------------------------
# the families end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SERVED)
def test_forward_prefill_decode_match_reference(arch, dtype):
    # bfloat16 MoE: a rounding can move an assignment past the capacity
    # cut on one side only, so those runs drop nothing (as the
    # reference's serving tests do); float32 keeps the default capacity
    kw = dict(capacity_factor=100.0) if dtype == "bfloat16" and \
        get_config(arch).family == "moe" else {}
    rcfg, pcfg, rp, pp = _models(arch, dtype, **kw)
    tol = F32 if dtype == "float32" else BF16
    rng = np.random.default_rng(9)
    tok = rng.integers(0, rcfg.vocab, (2, 17)).astype(np.int32)
    jt, tt = jnp.asarray(tok), torch.from_numpy(tok).long()
    ro = ref_tf.forward(rp, rcfg, jt)
    po = tf.forward(pp, pcfg, tt, collect=True)
    if dtype == "float32" or pcfg.family == "dense":
        np.testing.assert_allclose(_np(po.hidden), _np(ro.hidden), **tol)
    # bfloat16 MoE: a rounding can flip a token's top-k choice on one
    # side, which moves that token's hidden state by more than the
    # tolerance; the logits are held as the reference holds its own
    np.testing.assert_allclose(
        _np(po.hidden[:, -1] @ pp.head),
        _np(jnp.einsum("bd,dv->bv", ro.hidden[:, -1], rp["lm_head"])), **tol)
    assert sorted(po.aux) == sorted(ro.aux)
    for name in ro.aux:
        np.testing.assert_allclose(float(po.aux[name]), float(ro.aux[name]),
                                   **tol)
    assert len(po.kv[0]) == pcfg.n_layers
    for kind in ("", "int8") if dtype == "float32" else ("",):
        rc = dataclasses.replace(rcfg, kv_cache_dtype=kind or "bfloat16")
        pc = dataclasses.replace(pcfg, kv_cache_dtype=kind or "bfloat16")
        rl, rcache = ref_tf.prefill(rp, rc, jt[:, :16], max_len=18)
        pl, pcache = tf.prefill(pp, pc, tt[:, :16], max_len=18)
        assert pl.dtype == torch.float32 and int(pcache["pos"]) == 16
        assert pcache["attn"]["k"].shape == rcache["attn"]["k"].shape
        assert str(pcache["attn"]["k"].dtype).split(".")[-1] == \
            str(rcache["attn"]["k"].dtype)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **tol)
        rg, rcache = ref_tf.decode_step(rp, rc, rcache, jt[:, 16:])
        pg, pcache = tf.decode_step(pp, pc, pcache, tt[:, 16:])
        np.testing.assert_allclose(pg.numpy(), np.asarray(rg), **tol)
        if dtype == "float32":
            assert (pg.argmax(-1).numpy() == np.asarray(rg).argmax(-1)).all()
        assert int(pcache["pos"]) == 17


def test_params_from_reference_roundtrip():
    rcfg, pcfg, rp, pp = _models("granite-moe-1b-a400m", "bfloat16")
    flat = dict(pp.named_parameters())
    np.testing.assert_array_equal(
        _np(flat["layers.2.moe.w_gate"]),
        np.asarray(rp["layers"]["moe"]["w_gate"][2], np.float32))
    assert flat["layers.2.moe.router"].dtype == torch.float32
    assert flat["tok_embed"].dtype == torch.bfloat16
    bad = dict(jax.tree.map(np.asarray, rp), extra=np.zeros(3))
    with pytest.raises(ValueError, match="no port parameter"):
        tf.params_from_reference(bad, pcfg, "cpu")
    assert "qwen3-4b" in ARCH_IDS


# ---------------------------------------------------------------------------
# the Mamba2 and xLSTM blocks
# ---------------------------------------------------------------------------

def _tol(dtype):
    return F32 if dtype == "float32" else BF16


def _close(got, want, dtype, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what,
                               **_tol(dtype))


def _close_state(got, want, dtype, what=""):
    """A recurrent state (an accumulator, not an output) within the
    tolerance of its largest entry."""
    want = _np(want)
    scale = _tol(dtype)["rtol"] * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=scale,
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_blocks_with_a_carried_state(dtype, monkeypatch):
    rcfg, pcfg, rp, pp = _models("zamba2-7b", dtype)
    rblk, pblk = _layer0(rp["layers"]["ssm"]), pp.layers[0].ssm
    assert pblk.a_log.dtype == pblk.d_skip.dtype == torch.float32
    d_in, h, p_dim, n = ssm_lib.dims(pcfg)
    rng = np.random.default_rng(10)
    b, width = 2, pcfg.conv_width
    jh, th = _pair(rng.normal(size=(b, h, p_dim, n)) * 0.5, "float32")
    jc, tc = _pair(rng.normal(size=(b, width - 1, d_in + 2 * n)), dtype)
    # the causal conv with a tail
    jx, tx = _pair(rng.normal(size=(b, 5, d_in + 2 * n)), dtype)
    (ro, rt), (po, pt) = ref_ssm._conv(rblk, jx, jc), ssm_lib._conv(pblk, tx, tc)
    _close(po, ro, dtype, "conv")
    np.testing.assert_array_equal(_np(pt), _np(rt))
    # the chunked forward from a state: one chunk of 16, then (chunk 8
    # on both sides) two, the state carried from the first to the second
    jx, tx = _pair(rng.normal(size=(b, 16, 128)), dtype)
    for chunk in (ssm_lib.CHUNK, 8):
        monkeypatch.setattr(ref_ssm, "CHUNK", chunk)
        monkeypatch.setattr(ssm_lib, "CHUNK", chunk)
        ry, rs = ref_ssm.ssm_forward(rblk, jx, rcfg,
                                     ref_ssm.SSMState(h=jh, conv=jc))
        py, ps = ssm_lib.ssm_forward(pblk, tx, pcfg,
                                     ssm_lib.SSMState(h=th, conv=tc))
        assert py.dtype == tx.dtype and ps.h.dtype == torch.float32
        _close(py, ry, dtype, f"ssm_forward chunk {chunk}")
        _close_state(ps.h, rs.h, dtype, "h")
        _close_state(ps.conv, rs.conv, dtype, "conv tail")
    xcfg = get_config("xlstm-1.3b").reduced()
    mblk = tf.init_params(xcfg, device="cpu").layers[0].mlstm
    for fn, blk, cfg in ((ssm_lib.ssm_forward, pblk, pcfg),
                         (xlstm_lib.mlstm_parallel, mblk, xcfg)):
        x = torch.zeros((1, 300, 128), dtype=next(blk.parameters()).dtype)
        with pytest.raises(ValueError, match="multiple of the chunk"):
            fn(blk, x, cfg)
    # one recurrent step
    jx, tx = _pair(rng.normal(size=(b, 1, 128)), dtype)
    ry, rs = ref_ssm.ssm_decode(rblk, jx, rcfg, ref_ssm.SSMState(h=jh, conv=jc))
    py, ps = ssm_lib.ssm_decode(pblk, tx, pcfg, ssm_lib.SSMState(h=th, conv=tc))
    _close(py, ry, dtype, "ssm_decode")
    _close_state(ps.h, rs.h, dtype, "decode h")
    _close_state(ps.conv, rs.conv, dtype, "decode conv tail")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_blocks_with_a_carried_state(dtype, monkeypatch):
    rcfg, pcfg, rp, pp = _models("xlstm-1.3b", dtype)
    rm, pm = _layer0(rp["layers"]["mlstm"]), pp.layers[0].mlstm
    rs, ps = _layer0(rp["slstm_layers"]["slstm"]), pp.slstm_layers[0].slstm
    assert pm.w_if.dtype == ps.r_h.dtype == torch.float32
    rng = np.random.default_rng(11)
    b, h, hd = 2, pcfg.n_heads, pcfg.d_model // pcfg.n_heads
    m_state = [_pair(rng.normal(size=(b, h, hd, hd)) * 0.1, "float32"),
               _pair(rng.normal(size=(b, h, hd)) * 0.1, "float32"),
               _pair(rng.normal(size=(b, h)), "float32")]
    r_m = ref_xlstm.MLSTMState(*(j for j, _ in m_state))
    p_m = xlstm_lib.MLSTMState(*(t for _, t in m_state))
    jx, tx = _pair(rng.normal(size=(b, 16, 128)), dtype)
    for chunk in (xlstm_lib.MLSTM_CHUNK, 8):       # one chunk, then two
        monkeypatch.setattr(ref_xlstm, "MLSTM_CHUNK", chunk)
        monkeypatch.setattr(xlstm_lib, "MLSTM_CHUNK", chunk)
        ry, rst = ref_xlstm.mlstm_parallel(rm, jx, rcfg, state=r_m,
                                           return_state=True)
        py, pst = xlstm_lib.mlstm_parallel(pm, tx, pcfg, state=p_m,
                                           return_state=True)
        _close(py, ry, dtype, f"mlstm_parallel chunk {chunk}")
        for a, r in zip(pst, rst):
            _close_state(a, r, dtype, "mlstm state")
    # from the initial state (m at -1e30, the stabiliser's floor)
    ry = ref_xlstm.mlstm_parallel(rm, jx, rcfg)
    _close(xlstm_lib.mlstm_parallel(pm, tx, pcfg), ry, dtype, "from zero")
    jx, tx = _pair(rng.normal(size=(b, 1, 128)), dtype)
    ry, rst = ref_xlstm.mlstm_decode(rm, jx, rcfg, r_m)
    py, pst = xlstm_lib.mlstm_decode(pm, tx, pcfg, p_m)
    _close(py, ry, dtype, "mlstm_decode")
    for a, r in zip(pst, rst):
        _close_state(a, r, dtype, "mlstm_decode state")
    # sLSTM: the time loop from a state
    s_state = [_pair(rng.normal(size=(b, h, hd)) * 0.5, "float32"),
               _pair(rng.normal(size=(b, h, hd)), "float32"),
               _pair(rng.random((b, h, hd)) + 0.5, "float32"),
               _pair(rng.normal(size=(b, h, hd)), "float32")]
    jx, tx = _pair(rng.normal(size=(b, 12, 128)), dtype)
    ry, rst = ref_xlstm.slstm_forward(
        rs, jx, rcfg, state=ref_xlstm.SLSTMState(*(j for j, _ in s_state)))
    py, pst = xlstm_lib.slstm_forward(
        ps, tx, pcfg, state=xlstm_lib.SLSTMState(*(t for _, t in s_state)))
    _close(py, ry, dtype, "slstm_forward")
    for a, r in zip(pst, rst):
        _close_state(a, r, dtype, "slstm state")
    # m starts at -1e30 (not -inf), n at 1e-6, as the reference's
    for mine, ref in ((xlstm_lib.init_slstm_state(pcfg, 3),
                       ref_xlstm.init_slstm_state(rcfg, 3)),
                      (xlstm_lib.init_mlstm_state(pcfg, 3),
                       ref_xlstm.init_mlstm_state(rcfg, 3))):
        for a, r in zip(mine, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# the hybrid and ssm families end to end
# ---------------------------------------------------------------------------

# (arch, overrides, dtype): the reduced configs, plus float32 variants
# whose stacks end in a remainder (zamba2: 5 layers, groups of 2 and a
# third application of the shared block; xlstm: a trailing mLSTM layer)
RECURRENT_CASES = [("zamba2-7b", {}, "float32"),
                   ("zamba2-7b", {}, "bfloat16"),
                   ("zamba2-7b", dict(n_layers=5), "float32"),
                   ("xlstm-1.3b", {}, "float32"),
                   ("xlstm-1.3b", {}, "bfloat16"),
                   ("xlstm-1.3b", dict(n_layers=5), "float32")]


def _states(cache, fam):
    if fam == "hybrid":
        return {"attn.k": cache["attn"]["k"], "attn.v": cache["attn"]["v"],
                "ssm.h": cache["ssm"].h, "ssm.conv": cache["ssm"].conv}
    out = {f"mlstm.{f}": getattr(cache["mlstm"], f) for f in "cnm"}
    out.update({f"slstm.{f}": getattr(cache["slstm"], f) for f in "hcnm"})
    return out


@pytest.mark.parametrize("arch,kw,dtype", RECURRENT_CASES,
                         ids=[f"{a}-{d}{'-rem' if k else ''}"
                              for a, k, d in RECURRENT_CASES])
def test_recurrent_families_match_reference(arch, kw, dtype):
    """forward, prefill (logits and every cached state) and one decode
    step.  bfloat16 zamba2's forward over all positions is held within
    the tolerance widened, element by element, by how far the
    reference's compiled run lies from its own op-by-op run
    (``jax.disable_jit``) there: its unnormalised Mamba inputs make the
    reference's two runs differ by more than the tolerance at a few
    elements (4 of 4,352 here, by up to 0.19)."""
    rcfg, pcfg, rp, pp = _models(arch, dtype, **kw)
    fam = pcfg.family
    tol = _tol(dtype)
    rng = np.random.default_rng(12)
    tok = rng.integers(0, rcfg.vocab, (2, 17)).astype(np.int32)
    jt, tt = jnp.asarray(tok), torch.from_numpy(tok).long()
    po = tf.forward(pp, pcfg, tt, collect=True)
    got, want = _np(po.hidden), _np(ref_tf.forward(rp, rcfg, jt).hidden)
    if dtype == "bfloat16" and fam == "hybrid":
        with jax.disable_jit():
            eager = _np(ref_tf.forward(rp, rcfg, jt).hidden)
        spread = np.abs(want - eager)
        assert (spread > tol["atol"] + tol["rtol"] * np.abs(want)).any()
        over = np.abs(got - want) - tol["atol"] - tol["rtol"] * np.abs(want)
        assert (over <= spread).all(), float(over.max())
    else:
        np.testing.assert_allclose(got, want, **tol)
    rl, rcache = ref_tf.prefill(rp, rcfg, jt[:, :16], max_len=18)
    want_states = {k: _np(v) for k, v in _states(rcache, fam).items()}
    rg, rcache = ref_tf.decode_step(rp, rcfg, rcache, jt[:, 16:])
    pl, pcache = tf.prefill(pp, pcfg, tt[:, :16], max_len=18)
    assert pl.dtype == torch.float32 and int(pcache["pos"]) == 16
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **tol)
    for name, got in _states(pcache, fam).items():
        assert tuple(got.shape) == want_states[name].shape, name
        _close_state(got, want_states[name], dtype, name)
    pg, pcache = tf.decode_step(pp, pcfg, pcache, tt[:, 16:])
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), **tol)
    for name, got in _states(pcache, fam).items():
        _close_state(got, _states(rcache, fam)[name], dtype,
                     f"after decode: {name}")
    assert int(pcache["pos"]) == 17
    if dtype == "float32":
        assert (pg.argmax(-1).numpy() == np.asarray(rg).argmax(-1)).all()
    if fam == "hybrid":
        n_g, g, rem = tf._hybrid_groups(pcfg)
        assert pcache["attn"]["k"].shape[0] == n_g + (1 if rem else 0)
        assert len(po.kv[0]) == n_g + (1 if rem else 0)


def test_window_cache_matches_windowed_forward_past_wraparound():
    """The twin of ``tests/test_window_decode.py`` on the whole model:
    zamba2's shared attention decodes against an 8-slot ring buffer
    (``long_attention="window"``), and every step's logits equal the
    port's windowed full forward over the prefix and the reference's
    decode, before and after the ring wraps (twice)."""
    rcfg, pcfg, rp, pp = _models("zamba2-7b", "float32", window=8)
    assert pcfg.long_attention == "window"
    b, t0, n = 1, 4, 20
    rng = np.random.default_rng(13)
    tok = rng.integers(0, rcfg.vocab, (b, t0 + n)).astype(np.int32)
    jt, tt = jnp.asarray(tok), torch.from_numpy(tok).long()
    _, cache = tf.prefill(pp, pcfg, tt[:, :t0], max_len=t0 + n)
    assert cache["attn"]["k"].shape[2] == pcfg.window
    _, rcache = ref_tf.prefill(rp, rcfg, jt[:, :t0], max_len=t0 + n)
    ref_step = jax.jit(lambda c, x: ref_tf.decode_step(rp, rcfg, c, x))
    for i in range(n):
        got, cache = tf.decode_step(pp, pcfg, cache, tt[:, t0 + i:t0 + i + 1])
        out = tf.forward(pp, pcfg, tt[:, :t0 + i + 1])
        full = (out.hidden[:, -1] @ pp.head).float()
        np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=f"step {i}")
        rg, rcache = ref_step(rcache, jt[:, t0 + i:t0 + i + 1])
        np.testing.assert_allclose(got.numpy(), np.asarray(rg), **F32)
    assert int(cache["pos"]) == t0 + n > 2 * pcfg.window


def test_bf16_moe_routing_against_the_reference(monkeypatch):
    """How often the port's bfloat16 expert ids differ from the
    reference's (reduced granite-moe, ``capacity_factor=100``, 4 x 33
    positions a layer), beside the reference's own counts: its compiled
    forward against its op-by-op run (``jax.disable_jit``), and its
    decode against its forward.  Measured: port against the compiled
    reference [0, 1, 2, 3] positions a layer, port against the op-by-op
    run [0, 1, 1, 0], the reference's compiled run against its op-by-op
    run [0, 2, 3, 3], the reference's decode against its forward 0.  So
    the port differs from either reference run at no more positions, in
    any layer, than the reference's two runs differ from each other:
    the flips are bfloat16 rounding, not a fault."""
    rcfg, pcfg, rp, pp = _models("granite-moe-1b-a400m", "bfloat16",
                                 capacity_factor=100.0)
    b, t = 4, 32
    tok = np.random.default_rng(0).integers(0, 512, (b, t + 1)).astype(
        np.int32)
    jt = jnp.asarray(tok)
    log, top_k = [], jax.lax.top_k

    def spy_top_k(x, k):
        out = top_k(x, k)
        jax.debug.callback(lambda ids: log.append(np.sort(np.asarray(ids),
                                                          -1)), out[1])
        return out
    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)

    def ref_ids(fn):
        log.clear()
        jax.block_until_ready(fn())
        return list(log)
    compiled = ref_ids(lambda: ref_tf.forward(rp, rcfg, jt).hidden)
    with jax.disable_jit():
        eager = ref_ids(lambda: ref_tf.forward(rp, rcfg, jt).hidden)
    pre_cache = {}

    def prefill():
        _, pre_cache["c"] = ref_tf.prefill(rp, rcfg, jt[:, :t],
                                          max_len=t + 1)
        return pre_cache["c"]["pos"]
    pre = ref_ids(prefill)
    dec = ref_ids(lambda: ref_tf.decode_step(rp, rcfg, pre_cache["c"],
                                             jt[:, t:])[0])
    plog, route = [], moe_lib.route

    def spy_route(p, xf, cfg):
        r = route(p, xf, cfg)
        plog.append(r.expert_ids.sort(dim=-1).values.numpy())
        return r
    monkeypatch.setattr(moe_lib, "route", spy_route)
    tf.forward(pp, pcfg, torch.from_numpy(tok).long())
    n_layers = pcfg.n_layers
    assert len(plog) == len(compiled) == len(eager) == n_layers

    def flips(a, c):
        return [int((a[i] != c[i]).any(-1).sum()) for i in range(n_layers)]
    port_vs_compiled = flips(plog, compiled)
    port_vs_eager = flips(plog, eager)
    ref_compiled_vs_eager = flips(compiled, eager)
    ref_decode_vs_forward = [
        int((pre[i].reshape(b, t, -1)
             != compiled[i].reshape(b, t + 1, -1)[:, :t]).any(-1).sum()
            + (dec[i].reshape(b, 1, -1)
               != compiled[i].reshape(b, t + 1, -1)[:, t:]).any(-1).sum())
        for i in range(n_layers)]
    for i in range(n_layers):
        assert port_vs_compiled[i] <= ref_compiled_vs_eager[i], i
        assert port_vs_eager[i] <= ref_compiled_vs_eager[i], i
    assert sum(ref_compiled_vs_eager) > 0
    assert ref_decode_vs_forward == [0] * n_layers


# ---------------------------------------------------------------------------
# the encdec and vlm families
# ---------------------------------------------------------------------------

def _set_gates(rp, pp, seed):
    """Nonzero gates (|g| in [0.5, 1.5), either sign) drawn from
    ``seed``, on both sides: at zero a gated block ignores the image."""
    n = len(pp.cross_layers)
    rng = np.random.default_rng(seed + 100)
    g = rng.uniform(0.5, 1.5, (2, n)) * rng.choice([-1.0, 1.0], (2, n))
    rp = dict(rp, cross_layers=dict(
        rp["cross_layers"], gate_attn=jnp.asarray(g[0], jnp.float32),
        gate_mlp=jnp.asarray(g[1], jnp.float32)))
    for blk, ga, gm in zip(pp.cross_layers, g[0], g[1]):
        blk.gate_attn.fill_(float(np.float32(ga)))
        blk.gate_mlp.fill_(float(np.float32(gm)))
    return rp


def _cross_models(arch, dtype="float32", seed=0, **kw):
    rcfg, pcfg, rp, pp = _models(arch, dtype, seed, **kw)
    return rcfg, pcfg, _set_gates(rp, pp, seed), pp


def _frontend(cfg, b, seed):
    """The family's ``extra`` from a numpy seed, on both sides."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        name, shape = "enc_frames", (b, cfg.enc_seq, cfg.d_model)
    else:
        name, shape = "image_embeds", (b, cfg.vision_tokens, cfg.vision_dim)
    a = rng.normal(size=shape).astype(np.float32) * 0.5
    return {name: jnp.asarray(a)}, {name: torch.from_numpy(a)}


def _ref_logits(rp, hidden):
    return jnp.einsum("bd,dv->bv", hidden, rp["lm_head"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_and_encoder_kv(dtype):
    rcfg, pcfg, rp, pp = _cross_models("llama-3.2-vision-11b", dtype)
    rblk, pblk = _layer0(rp["cross_layers"]["attn"]), pp.cross_layers[0].attn
    assert pblk.q_norm is None and "q_norm" not in rblk
    rng = np.random.default_rng(20)
    jx, tx = _pair(rng.normal(size=(2, 5, 128)), dtype)
    js, ts = _pair(rng.normal(size=(2, 9, 128)), dtype)
    kv = attn.encoder_kv(pblk, ts, pcfg)
    rkv = ref_attn.encoder_kv(rblk, js, rcfg)
    tol = F32 if dtype == "float32" else BF16
    for a, r in zip(kv, rkv):
        np.testing.assert_allclose(_np(a), _np(r), **tol)
    mask = rng.random((2, 9)) < 0.6
    mask[:, 0] = True
    for m in (None, mask):
        got = attn.cross_attention(pblk, tx, kv, pcfg,
                                   None if m is None else torch.from_numpy(m))
        want = ref_attn.cross_attention(rblk, jx, rkv, rcfg,
                                        None if m is None else jnp.asarray(m))
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(_np(got), _np(want), **tol)


def _int8_equal_off_ties(got, want, x):
    """int8 cache values ``got`` equal the reference's ``want`` except
    where the float value ``x`` they quantise lies within 1e-3 of a
    rounding boundary: there the two sides' float32 inputs (equal within
    rounding) may round one step apart."""
    got, want = (np.asarray(a).astype(np.int32) for a in (got, want))
    x = np.asarray(x, np.float32)
    x = x / (np.max(np.abs(x), -1, keepdims=True) / 127.0 + 1e-9)
    tie = np.abs(np.abs(x - np.trunc(x)) - 0.5) < 1e-3
    assert (np.abs(got - want) <= 1).all()
    assert ((got == want) | tie).all()


CROSS_CASES = [(a, d, kv) for a in CROSS
               for d, kv in (("float32", "bfloat16"), ("bfloat16", "bfloat16"),
                             ("float32", "int8"))]


@pytest.mark.parametrize("arch,dtype,kv", CROSS_CASES,
                         ids=[f"{a}-{d}-{k}" for a, d, k in CROSS_CASES])
def test_cross_families_match_reference(arch, dtype, kv, monkeypatch):
    """forward, prefill (logits, the self-attention cache and every cross
    layer's K / V) and 4 decode steps against the reference, vlm gates
    nonzero: float32 within 1e-4 with greedy tokens equal, bfloat16
    within 0.12, int8 KV values equal."""
    rcfg, pcfg, rp, pp = _cross_models(arch, dtype, kv_cache_dtype=kv)
    tol = F32 if dtype == "float32" else BF16
    rng = np.random.default_rng(21)
    tok = rng.integers(0, rcfg.vocab, (2, 20)).astype(np.int32)
    jt, tt = jnp.asarray(tok), torch.from_numpy(tok).long()
    rex, pex = _frontend(pcfg, 2, 22)
    ro = ref_tf.forward(rp, rcfg, jt, rex)
    po = tf.forward(pp, pcfg, tt, pex, collect=True)
    np.testing.assert_allclose(_np(po.hidden), _np(ro.hidden), **tol)
    n_cross = len(pp.cross_layers)
    assert n_cross == (pcfg.n_layers if pcfg.family == "encdec"
                       else pcfg.n_layers // pcfg.cross_attn_every)
    rl, rcache = ref_tf.prefill(rp, rcfg, jt[:, :16], rex, max_len=20)
    pl, pcache = tf.prefill(pp, pcfg, tt[:, :16], pex, max_len=20)
    assert pl.dtype == torch.float32 and int(pcache["pos"]) == 16
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **tol)
    for a, r in zip(pcache["cross_kv"], rcache["cross_kv"]):
        assert tuple(a.shape) == tuple(r.shape) == (
            n_cross, 2, rex[next(iter(rex))].shape[1], pcfg.n_kv_heads,
            pcfg.hd)
        assert a.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(a), _np(r), **tol)
    if kv == "int8":
        rkv = ref_tf.forward(rp, rcfg, jt[:, :16], rex, collect=True).kv
        for name, ref_f in zip(("k", "v"), rkv):
            got = pcache["attn"][name]
            assert got.dtype == torch.int8
            _int8_equal_off_ties(got[:, :, :16].numpy(),
                                 rcache["attn"][name][:, :, :16], ref_f)
            np.testing.assert_array_equal(got[:, :, 16:].numpy(), 0)
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(_np(pcache["attn"][name]),
                                       _np(rcache["attn"][name]), **F32)
        # the float K / V each decode step quantises, layer by layer
        seen, quantize = [], attn.quantize_kv
        monkeypatch.setattr(attn, "quantize_kv",
                            lambda x: seen.append(x) or quantize(x))
    else:
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(pcache["attn"][name]),
                                       _np(rcache["attn"][name]), **tol)
    for i in range(16, 20):
        if kv == "int8":
            # decode from the same int8 values: a value at a rounding
            # tie moves a logit by about 1e-4 on its own
            for name, t in pcache["attn"].items():
                t.copy_(torch.from_numpy(np.asarray(
                    rcache["attn"][name], np.float32)).to(t.dtype))
            seen.clear()
        rg, rcache = ref_tf.decode_step(rp, rcfg, rcache, jt[:, i:i + 1])
        pg, pcache = tf.decode_step(pp, pcfg, pcache, tt[:, i:i + 1])
        np.testing.assert_allclose(pg.numpy(), np.asarray(rg), **tol,
                                   err_msg=f"decode at {i}")
        if kv == "int8":
            for j, name in enumerate(("k", "v")):
                _int8_equal_off_ties(
                    pcache["attn"][name][:, :, i].numpy(),
                    rcache["attn"][name][:, :, i],
                    torch.stack(seen[j::2])[:, :, 0].numpy())
        if dtype == "float32":
            assert (pg.argmax(-1).numpy() ==
                    np.asarray(rg).argmax(-1)).all(), i
    assert int(pcache["pos"]) == 20


@pytest.mark.parametrize("arch", CROSS)
def test_logits_move_with_the_frontend_input(arch):
    """Two frontend inputs give logits apart by far more than the
    tolerance, each within it of the reference's; with the vlm gates at
    their initial zero the image changes nothing, on both sides."""
    rcfg, pcfg, rp0, pp = _models(arch)
    rng = np.random.default_rng(23)
    tok = rng.integers(0, rcfg.vocab, (2, 12)).astype(np.int32)
    jt, tt = jnp.asarray(tok), torch.from_numpy(tok).long()
    inputs = [_frontend(pcfg, 2, s) for s in (24, 25)]

    def both(rp):
        out = []
        for rex, pex in inputs:
            got = (tf.forward(pp, pcfg, tt, pex).hidden[:, -1]
                   @ pp.head).numpy()
            want = np.asarray(_ref_logits(
                rp, ref_tf.forward(rp, rcfg, jt, rex).hidden[:, -1]))
            np.testing.assert_allclose(got, want, **F32)
            out.append(got)
        return out
    if pcfg.family == "vlm":
        a, b = both(rp0)
        np.testing.assert_array_equal(a, b)
        assert not any(float(blk.gate_attn) or float(blk.gate_mlp)
                       for blk in pp.cross_layers)
    a, b = both(_set_gates(rp0, pp, 0))
    assert np.abs(a - b).max() > 100 * F32["atol"]


def test_cross_family_parameters():
    """The cross layers' gates are float32 0-d leaves at zero (``[n]``
    stacked in the reference), carried across both ways; the frontend
    projections and the encoder's leaves take the reference's shapes and
    placement specs."""
    from repro.sharding import rules as ref_rules
    from repro_torch.sharding import rules
    for arch in CROSS:
        rcfg, pcfg = _cfgs(arch, "bfloat16")
        model = tf.init_params(pcfg, seed=1, device="cpu")
        flat = dict(model.named_parameters())
        n = len(model.cross_layers)
        for i in range(n):
            for g in ("gate_attn", "gate_mlp"):
                t = flat[f"cross_layers.{i}.{g}"]
                assert t.dtype == torch.float32 and t.shape == () and \
                    float(t) == 0.0
        assert flat["cross_layers.0.attn.wq"].dtype == torch.bfloat16
        rp = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
        rp = _set_gates(rp, model, 3)
        back = tf.state_to_reference(
            tf.params_from_reference(jax.tree.map(np.asarray, rp), pcfg,
                                     "cpu"))
        for key, want in tf._flat_tree(jax.tree.map(np.asarray, rp)).items():
            got = tf._flat_tree(back)[key]
            assert tuple(got.shape) == want.shape, key
            np.testing.assert_array_equal(_np(got), np.asarray(
                want, np.float32), err_msg=str(key))
        assert back["cross_layers"]["gate_attn"].dtype == torch.float32
        full = tf.Transformer(get_config(arch), device="meta")
        shapes = jax.eval_shape(
            lambda k: ref_tf.init_params(ref_config(arch), k),
            jax.ShapeDtypeStruct((2,), jnp.uint32))
        want = {k: tuple(v) for k, v in tf._flat_tree(
            ref_rules.param_specs(shapes)).items()}
        got = tf._flat_tree(rules.param_specs(
            tf.state_to_reference(full, device="meta")))
        assert got == want
        proj = "enc_embed_proj" if pcfg.family == "encdec" else "img_proj"
        assert got[(proj,)] == (None, "model")
