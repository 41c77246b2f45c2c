"""The fused causal attention (``repro_torch.kernels.flash``) and its route
(``models.attention.causal_attention``).

On the CPU: ``causal_attention`` is the plain chain bit for bit (``_sdpa``
with the causal mask, ``_blockwise_sdpa`` above the threshold), self- and
latent attention route through it, the counters count each call (fused:
none here) only while spans are recorded, the benchmark's
``attention_fused_share`` reads them, the head-dim split and the checks
refuse what the kernels do not take, and the plain float32 version agrees
with the chain.

On the card (``card``: skips without one; ``python3 -m pytest
tests/test_torch_flash.py -m card``): the kernels' O, log-sum-exp, dQ, dK
and dV against the plain version at every cell's shapes and at ragged
lengths, two runs bit-equal, what the kernels do not take raises, a
checkpointed layer's gradients equal the unchecked layer's, and the
route never runs the eager chain there.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.kernels import flash
from repro_torch.models import attention as attn
from repro_torch.models.common import rope_freqs
from repro_torch.train import optim
from repro_torch.train import step as step_lib

READERS = Path(__file__).resolve().parent.parent / "perfbench" / "metrics"
KIMI_SCALE = attn.latent_scale(get_config("kimi-k2-instruct"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every port test file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_registry():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _qkv(b, t, h, hk, d, dv, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k = (torch.randn(b, t, n, d, generator=g) for n in (h, hk))
    v = torch.randn(b, t, hk, dv, generator=g)
    return tuple(x.to(dtype=dtype, device=device) for x in (q, k, v))


def _causal(t):
    idx = torch.arange(t)
    return (idx[None, :, None] >= idx[None, None, :])[:, None]


# ---------------------------------------------------------------------------
# the CPU: the route is the plain chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("b,t,h,hk,d,dv,scale", [
    (2, 24, 4, 4, 16, 16, None),           # MHA
    (2, 33, 4, 2, 16, 16, None),           # GQA, ragged
    (1, 20, 4, 4, 24, 16, KIMI_SCALE),     # MLA-like: wider scores, a scale
])
def test_cpu_route_is_sdpa_with_the_causal_mask(dtype, b, t, h, hk, d, dv,
                                                scale):
    q, k, v = _qkv(b, t, h, hk, d, dv, dtype)
    got = attn.causal_attention(q, k, v, h // hk, scale)
    want = attn._sdpa(q, k, v, _causal(t), h // hk, scale)
    assert got.dtype == dtype and torch.equal(got, want)


def test_cpu_route_is_blockwise_above_the_threshold():
    t = attn.BLOCKWISE_THRESHOLD + attn.Q_BLOCK
    q, k, v = _qkv(1, t, 2, 1, 8, 8, torch.bfloat16)
    got = attn.causal_attention(q, k, v, 2)
    assert torch.equal(got, attn._blockwise_sdpa(q, k, v, 2))


@pytest.mark.parametrize("t,scale,blockwise", [
    (64, None, True), (72, None, False), (64, 0.3, False)])
def test_cpu_route_threshold_and_scale(monkeypatch, t, scale, blockwise):
    """Above the threshold on a whole number of query blocks and without a
    scale, blockwise; else ``_sdpa`` (a latent scale keeps it, as before)."""
    monkeypatch.setattr(attn, "BLOCKWISE_THRESHOLD", 32)
    monkeypatch.setattr(attn, "Q_BLOCK", 16)
    monkeypatch.setattr(attn, "KV_BLOCK", 16)
    q, k, v = _qkv(1, t, 2, 2, 8, 8)
    got = attn.causal_attention(q, k, v, 1, scale)
    want = attn._blockwise_sdpa(q, k, v, 1) if blockwise else \
        attn._sdpa(q, k, v, _causal(t), 1, scale)
    assert torch.equal(got, want)


def _spy(monkeypatch):
    seen = []
    real = attn.causal_attention

    def spy(q, k, v, n_rep, scale=None):
        seen.append((tuple(q.shape), tuple(v.shape), n_rep, scale))
        return real(q, k, v, n_rep, scale)
    monkeypatch.setattr(attn, "causal_attention", spy)
    return seen


@pytest.mark.parametrize("arch,window", [
    ("stablelm-1.6b", 0), ("granite-moe-1b-a400m", 0), ("zamba2-7b", 16)])
def test_self_attention_routes_unwindowed_calls(monkeypatch, arch, window):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    p = attn.Attention(cfg, torch.float32)
    with torch.no_grad():
        p.reset(torch.Generator().manual_seed(0))
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    rope = rope_freqs(cfg.hd, 24, cfg.rope_theta)
    want = attn.self_attention(p, x, cfg, rope, window=window)
    seen = _spy(monkeypatch)
    got = attn.self_attention(p, x, cfg, rope, window=window)
    assert torch.equal(got, want)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    assert seen == ([] if window else [((2, 24, cfg.n_heads, cfg.hd),
                                        (2, 24, cfg.n_kv_heads, cfg.hd),
                                        n_rep, None)])


def test_latent_attention_routes_with_its_scale(monkeypatch):
    cfg = dataclasses.replace(get_config("kimi-k2-instruct").reduced(),
                              dtype="float32")
    p = attn.LatentAttention(cfg, torch.float32)
    with torch.no_grad():
        p.reset(torch.Generator().manual_seed(0))
    x = torch.randn(1, 20, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    rope = attn.make_rope(cfg, 20)
    want = attn.latent_attention(p, x, cfg, rope)
    seen = _spy(monkeypatch)
    assert torch.equal(attn.latent_attention(p, x, cfg, rope), want)
    h = cfg.n_heads
    assert seen == [((1, 20, h, cfg.qk_head_dim), (1, 20, h, cfg.v_head_dim),
                     1, attn.latent_scale(cfg))]


@pytest.mark.parametrize("mb", (1, 2))
def test_counters_count_each_forward_only_while_recorded(mb):
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              n_layers=2)
    ocfg = optim.OptConfig(warmup_steps=1)
    g = torch.Generator().manual_seed(7)
    batch = {k: torch.randint(0, cfg.vocab, (mb, 4 // mb, 16), generator=g)
             for k in ("tokens", "labels")}
    fn = step_lib.make_train_step(cfg, ocfg, mb)
    params, st = step_lib.init_train_state(cfg, ocfg, seed=3, device="cpu")
    params, st, _ = fn(params, st, batch)
    assert spans.summary()["counters"] == {}
    spans.reset()
    spans.enable()
    fn(params, st, batch)
    c = spans.summary()["counters"]
    # each microbatch: the forward, and the layer's recompute in the
    # backward
    assert c["attention.calls"] == 2 * cfg.n_layers * mb
    assert c.get("attention.fused", 0) == 0


def _read(metric, run):
    spec = importlib.util.spec_from_file_location(
        f"reader_{metric}", READERS / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def test_fused_share_reads_none_without_the_counters_and_the_share_with():
    assert _read("attention_fused_share", {"steps": 2}) is None
    spans.enable()
    spans.count("moe.assignments", 10)
    assert _read("attention_fused_share", {"steps": 2}) is None
    spans.reset()
    for fused in (True, True, False, True):
        spans.count("attention.calls", 1)
        if fused:
            spans.count("attention.fused", 1)
    assert _read("attention_fused_share", {"steps": 2}) == \
        pytest.approx(75.0)


@pytest.mark.parametrize("dtype", flash.DTYPES)
@pytest.mark.parametrize("d,dv", flash.CASES)
def test_plan_takes_each_case(d, dv, dtype):
    assert flash.plan(d, dv, dtype) == (d, dv)
    assert flash.library_path(d, dv, dtype).name.startswith(
        f"libflash_d{d}_v{dv}_")


def test_each_case_and_dtype_builds_a_library_of_its_own():
    keys = [(d, dv, t) for d, dv in flash.CASES for t in flash.DTYPES]
    assert len({flash.library_path(*key) for key in keys}) == len(keys)
    for d, dv, t in keys:
        f = flash.flags(d, dv, t)
        assert f"-DFLASH_D={d}" in f and f"-DFLASH_DV={dv}" in f
        assert f"-DFLASH_F32={int(t == torch.float32)}" in f


@pytest.mark.parametrize("d,dv,dtype", [
    (8, 64, torch.bfloat16), (72, 64, torch.bfloat16),
    (272, 64, torch.bfloat16), (64, 144, torch.bfloat16),
    (112, 112, torch.bfloat16), (80, 48, torch.bfloat16),
    (192, 192, torch.bfloat16), (64, 64, torch.float16),
    (64, 64, torch.float64)])
def test_plan_refuses_what_the_kernels_do_not_take(d, dv, dtype):
    with pytest.raises(ValueError):
        flash.plan(d, dv, dtype)


def test_the_kernels_refuse_cpu_tensors():
    q, k, v = _qkv(1, 8, 2, 2, 16, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash.attention(q, k, v, 1)
    with pytest.raises(ValueError, match="CUDA"):
        flash.forward(q, k, v, 1)


@pytest.mark.parametrize("h,hk,d,dv,scale", [
    (4, 4, 16, 16, None), (4, 2, 16, 16, None), (4, 4, 48, 32, 0.2)])
def test_plain_version_is_the_chain_in_float32(h, hk, d, dv, scale):
    q, k, v = _qkv(2, 19, h, hk, d, dv)
    o, lse = flash.attention_ref(q, k, v, h // hk, scale)
    want = attn._sdpa(q, k, v, _causal(19), h // hk, scale)
    assert torch.allclose(o, want, atol=1e-5, rtol=1e-5)
    kf = k.repeat_interleave(h // hk, dim=2)
    sc = 1 / math.sqrt(d) if scale is None else scale
    s = torch.einsum("bthd,bshd->bhts", q, kf) * sc
    s = s.masked_fill(~_causal(19), float("-inf"))
    assert torch.allclose(lse, torch.logsumexp(s, -1), atol=1e-5)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

# each cell's per-call shape: (B, T, H, Hkv, D, Dv, scale)
CELLS = {
    "stablelm-1.6b.pretrain-4k": (2, 4096, 32, 32, 64, 64, None),
    "stablelm-1.6b.ft-512": (32, 512, 32, 32, 64, 64, None),
    "granite-moe-1b-a400m.pretrain-4k": (8, 4096, 16, 8, 64, 64, None),
    "granite-moe-1b-a400m.ft-512": (64, 512, 16, 8, 64, 64, None),
    "kimi-k2-instruct.ft-4k": (1, 4096, 64, 64, 192, 128, KIMI_SCALE),
}
RAGGED = [(2, t, 16, 8, 64, 64, None) for t in (1, 17, 1000, 4097)] + \
    [(1, t, 64, 64, 192, 128, KIMI_SCALE) for t in (17, 1000)] + \
    [(4, 64, 32, 8, 128, 128, None), (1, 1000, 32, 8, 128, 128, None),
     (2, 200, 4, 2, 32, 32, None)]
# bf16 operands: P and dS are rounded to bf16 (2**-9 relative) before
# their products, and O, dQ, dK, dV are stored in bf16 (2**-9 relative);
# over up to 4,096 keys of either sign these give relative (Frobenius)
# errors of a few 1e-3.  The log-sum-exp is float32 on both sides and
# differs only by the order of the sums and exp2 for exp.
TOL_O, TOL_GRAD, TOL_LSE = 1e-2, 2e-2, 1e-4
# float32 operands, products in full float32 on the CUDA cores: the
# order of the sums
TOL_F32 = 1e-5
# rows of the batch held against the plain version (it holds the [T, T]
# logits and their gradient in float32)
REF_ROWS = 2


def _rel(a, b):
    """Relative Frobenius error; absolute where the reference is 0 (one
    key: the softmax is constant, dQ and dK vanish)."""
    den = float(b.detach().float().norm())
    return float((a.float() - b.detach().float()).norm()) / (den or 1.0)


def _run(shape, dev, dtype=torch.bfloat16, seed=0):
    b, t, h, hk, d, dv, scale = shape
    q, k, v = _qkv(b, t, h, hk, d, dv, dtype, dev, seed)
    g = torch.Generator().manual_seed(seed + 1)
    do = torch.randn(b, t, h, dv, generator=g).to(dtype=dtype, device=dev)
    o, lse = flash.forward(q, k, v, h // hk, scale)
    dq, dk, dv_ = flash.backward(q, k, v, o, lse, do, h // hk, scale)
    torch.cuda.synchronize()
    return (q, k, v, do), (o, lse, dq, dk, dv_)


def _hold(shape, dev, dtype=torch.bfloat16):
    b, t, h, hk, d, dv, scale = shape
    (q, k, v, do), got = _run(shape, dev, dtype)
    rows = sorted({0, b - 1})[:REF_ROWS]
    leaves = [x[rows].float().requires_grad_(True) for x in (q, k, v)]
    o, lse = flash.attention_ref(*leaves, h // hk, scale)
    o.backward(do[rows].float())
    want = (o, lse, *(x.grad for x in leaves))
    errs = {n: _rel(a[rows], w) for n, a, w in
            zip(("o", "lse", "dq", "dk", "dv"), got, want)}
    tol = dict(o=TOL_O, lse=TOL_LSE, dq=TOL_GRAD, dk=TOL_GRAD, dv=TOL_GRAD)
    if dtype == torch.float32:
        tol = dict.fromkeys(tol, TOL_F32)
    bad = {n: e for n, e in errs.items() if not e <= tol[n]}
    assert not bad, (shape, errs)
    assert all(bool(torch.isfinite(x).all()) for x in got)


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_kernels_hold_the_plain_version_at_each_cells_shape(card, cell):
    _hold(CELLS[cell], card)


@pytest.mark.card
@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: f"T{s[1]}-D{s[4]}")
def test_kernels_hold_the_plain_version_at_ragged_lengths(card, shape):
    _hold(shape, card)


@pytest.mark.card
@pytest.mark.parametrize("shape", [(2, 100, 4, 2, 32, 32, None),
                                   (1, 70, 4, 4, 192, 128, 0.1),
                                   (1, 40, 4, 2, 128, 128, None),
                                   (1, 33, 2, 2, 64, 64, None)])
def test_float32_holds_the_plain_version(card, shape):
    _hold(shape, card, torch.float32)


@pytest.mark.card
@pytest.mark.parametrize("shape", [(2, 1000, 16, 8, 64, 64, None),
                                   (1, 1000, 64, 64, 192, 128, KIMI_SCALE)])
def test_two_runs_are_bit_equal(card, shape):
    _, a = _run(shape, card)
    _, b = _run(shape, card)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.card
def test_what_the_kernels_do_not_take_raises(card):
    q, k, v = _qkv(1, 64, 2, 2, 64, 64, torch.bfloat16, card)
    for bad in ((q.half(), k.half(), v.half()),
                (q.double(), k.double(), v.double()),
                (q[..., :8], k[..., :8], v),
                (q[..., :40], k[..., :40], v),
                (q, k, torch.cat([v, v, v], -1)[..., :144]),
                (q, k, v.transpose(1, 3).contiguous().transpose(1, 3)),
                (q, k[:, :32], v), (q, k, v.cpu())):
        with pytest.raises(ValueError):
            flash.attention(*bad, 1)
    with pytest.raises(ValueError):
        flash.attention(q, k[:, :, :1], v[:, :, :1], 1)


@pytest.mark.card
def test_a_checkpointed_layer_has_the_unchecked_layers_gradients(card):
    cfg = get_config("granite-moe-1b-a400m")
    p = attn.Attention(cfg, torch.bfloat16, card)
    with torch.no_grad():
        p.reset(torch.Generator(device=card).manual_seed(0))
    p.requires_grad_(True)
    rope = rope_freqs(cfg.hd, 512, cfg.rope_theta, card)
    x = torch.randn(2, 512, cfg.d_model, device=card, dtype=torch.bfloat16)
    dy = torch.randn_like(x)
    grads = []
    for remat in (False, True):
        xi = x.clone().requires_grad_(True)
        y = checkpoint(attn.self_attention, p, xi, cfg, rope,
                       use_reentrant=False) if remat else \
            attn.self_attention(p, xi, cfg, rope)
        y.backward(dy)
        grads.append([xi.grad] + [w.grad.clone() for w in p.parameters()])
        p.zero_grad(set_to_none=True)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("t", (512, attn.BLOCKWISE_THRESHOLD + 1024))
def test_the_route_on_the_card_never_runs_the_eager_chain(card, monkeypatch,
                                                          t):
    def eager(*a, **k):
        raise AssertionError("the eager chain ran on the card")
    monkeypatch.setattr(attn, "_sdpa", eager)
    monkeypatch.setattr(attn, "_blockwise_sdpa", eager)
    q, k, v = _qkv(1, t, 4, 2, 64, 64, torch.bfloat16, card)
    q.requires_grad_(True)
    flash.reset_launches()
    spans.enable()
    attn.causal_attention(q, k, v, 2).sum().backward()
    c = spans.summary()["counters"]
    assert c["attention.calls"] == c["attention.fused"] == 1
    assert flash.LAUNCHES == {"attention_fwd": 1, "attention_bwd_pre": 1,
                              "attention_bwd_dkdv": 1, "attention_bwd_dq": 1}
