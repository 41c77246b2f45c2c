"""The latent-attention configuration (Kimi K2) on the port's train path, on
the CPU: the registry entry, YaRN's frequencies and the softmax scale at
fixed points, the expert share against the uncut layer, the selection bias,
the spans and counters, serving refused, and the train launcher's smoke
run.  The port against the benchmark's plain reference is
``perfbench/test_perfbench_latent.py``."""
import contextlib
import dataclasses
import io
import math

import pytest
import torch

from repro_torch import spans
from repro_torch.configs import ARCH_IDS, LatentConfig, get_config
from repro_torch.launch import train as launch
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tf
from repro_torch.models.common import yarn_inv_freq
from repro_torch.train import optim
from repro_torch.train import step as step_lib

ARCH = "kimi-k2-instruct"


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


def _small(**over) -> LatentConfig:
    return dataclasses.replace(get_config(ARCH).reduced(), dtype="float32",
                               **over)


def _batch(cfg, b=2, t=16, mb=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab, (mb, b, t + 1), generator=g)
    return {"tokens": tok[..., :-1], "labels": tok[..., 1:]}


def test_the_published_config_resolves_outside_the_reference_list():
    cfg = get_config(ARCH)
    assert isinstance(cfg, LatentConfig) and ARCH not in ARCH_IDS
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab) == \
        (61, 7168, 64, 163840)
    assert (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_head_dim,
            cfg.v_head_dim) == (1536, 512, 192, 128)
    assert (cfg.router_experts, cfg.n_experts, cfg.top_k, cfg.d_ff,
            cfg.dense_d_ff, cfg.n_shared_experts) == (384, 384, 8, 2048,
                                                      18432, 1)
    model = tf.Transformer(dataclasses.replace(cfg, n_layers=2),
                           device="meta")
    kinds = [(b.mlp is not None, b.moe is not None) for b in model.layers]
    assert kinds == [(True, False), (False, True)]
    assert tuple(model.layers[1].moe.router.shape) == (7168, 384)
    assert model.layers[1].moe.router.dtype == torch.float32
    assert tuple(model.layers[0].mlp.w_gate.shape) == (7168, 18432)
    assert tuple(model.layers[1].moe.shared.w_gate.shape) == (7168, 2048)


def test_yarn_frequencies_and_softmax_scale_at_fixed_points():
    cfg = get_config(ARCH)
    inv = yarn_inv_freq(64, 50000.0, 32.0, 4096, 1.0, 1.0)
    # the correction dim of one turn over 4,096 positions is
    # 64 ln(4096 / 2 pi) / (2 ln 50000) = 19.16: plain up to index 19,
    # divided by 32 from index 20 on
    assert 64 * math.log(4096 / (2 * math.pi)) / (2 * math.log(50000)) \
        == pytest.approx(19.1646, abs=1e-4)
    for i in (0, 1, 19):
        assert inv[i].item() == pytest.approx(50000.0 ** (-2 * i / 64),
                                              rel=1e-6)
    for i in (20, 31):
        assert inv[i].item() == pytest.approx(
            50000.0 ** (-2 * i / 64) / 32, rel=1e-6)
    m = 0.1 * math.log(32) + 1
    assert attn_lib.latent_scale(cfg) == pytest.approx(192 ** -0.5 * m * m,
                                                       rel=1e-12)
    assert attn_lib.latent_scale(cfg) == pytest.approx(0.130861, abs=1e-6)
    cos, sin = attn_lib.make_rope(cfg, 8)
    ang = torch.arange(8.0)[:, None] * inv
    assert torch.equal(cos, torch.cos(ang)) and torch.equal(sin,
                                                            torch.sin(ang))


def _layer_out(cfg, ref: moe_lib.MoE, offset, x):
    """The expert layer holding ``cfg.n_experts`` experts from ``offset``
    on, with ``ref``'s weights for them."""
    share = dataclasses.replace(cfg, expert_offset=offset)
    p = moe_lib.MoE(share, torch.float32)
    held = slice(offset, offset + share.n_experts)
    with torch.no_grad():
        p.router.copy_(ref.router)
        for name in ("w_gate", "w_up", "w_down"):
            getattr(p, name).copy_(getattr(ref, name)[held])
        p.shared.load_state_dict(ref.shared.state_dict())
    return moe_lib.moe(p, x, share)


def test_the_shares_of_the_experts_add_up_to_the_uncut_layer():
    # capacity for every assignment: nothing is dropped anywhere
    whole = _small(n_experts=16, router_experts=16, top_k=4,
                   capacity_factor=4.0)
    gen = torch.Generator().manual_seed(0)
    ref = moe_lib.MoE(whole, torch.float32)
    with torch.no_grad():
        ref.reset(gen)
    x = torch.randn(2, 16, whole.d_model, generator=gen)
    assert moe_lib.moe(ref, x, whole)[1] == {}     # nothing counted
    spans.enable()                                  # the counters' numbers
    want, aux = moe_lib.moe(ref, x, whole)
    assert int(aux["held"]) == 2 * 16 * 4
    held = dataclasses.replace(whole, n_experts=4)
    shares = [_layer_out(held, ref, off, x) for off in range(0, 16, 4)]
    assert sum(int(a["held"]) for _, a in shares) == 2 * 16 * 4
    assert all(float(a["dropped_frac"]) == 0 for _, a in shares)
    shared = moe_lib.mlp_lib.mlp(ref.shared, x)
    got = sum(out for out, _ in shares) - (len(shares) - 1) * shared
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_the_bias_moves_the_choice_but_not_the_gates_of_a_choice():
    cfg = _small()
    gen = torch.Generator().manual_seed(1)
    p = moe_lib.MoE(cfg, torch.float32)
    with torch.no_grad():
        p.reset(gen)
    xf = torch.randn(32, cfg.d_model, generator=gen)
    plain = moe_lib.route(p, xf, cfg)
    with torch.no_grad():
        p.bias[3] = 10.0                # expert 3 chosen by every token
    biased = moe_lib.route(p, xf, cfg)
    assert not torch.equal(plain.expert_ids, biased.expert_ids)
    assert (biased.expert_ids == 3).any(dim=-1).all()
    scores = torch.sigmoid(xf @ p.router)
    for r in (plain, biased):
        s = scores.gather(1, r.expert_ids)
        torch.testing.assert_close(
            r.gate_vals, s / s.sum(-1, keepdim=True) * cfg.routed_scale)
    # a token whose choice the bias did not change keeps its gates
    same = (plain.expert_ids == biased.expert_ids).all(dim=-1)
    assert torch.equal(plain.gate_vals[same], biased.gate_vals[same])
    assert "bias" not in dict(p.named_parameters())
    assert p.bias.dtype == torch.float32


def test_spans_and_counters_read_as_stated(monkeypatch):
    cfg = _small()
    params, _ = step_lib.init_train_state(
        cfg, optim.OptConfig(warmup_steps=1), seed=3, device="cpu")
    held = []
    real = moe_lib.route

    def route(*a, **k):
        r = real(*a, **k)
        held.append(r.held)
        return r
    monkeypatch.setattr(moe_lib, "route", route)
    spans.enable()
    batch = {k: v[0] for k, v in _batch(cfg).items()}
    loss, _ = tf.loss_fn(params, cfg, batch)
    loss.backward()
    s = spans.summary()
    rows, c = s["spans"], s["counters"]
    n_moe = cfg.n_layers - cfg.first_k_dense
    # forward and recompute: each call of each layer
    assert rows["attention.latent"]["calls"] == 2 * cfg.n_layers
    assert rows["attention.latent"]["parents"] == ["attention.fwd"]
    assert rows["moe.shared"]["calls"] == 2 * n_moe
    assert rows["moe.shared"]["parents"] == ["moe.fwd"]
    assert c["moe.routed"] == batch["tokens"].numel() * cfg.top_k * n_moe
    first = torch.cat(held[:n_moe])             # the forward's routings
    assert c["moe.assignments"] == first.sum().item()
    assert 0 < c["moe.assignments"] < c["moe.routed"]
    assert 0 <= c["moe.dropped"] < c["moe.assignments"]


def test_the_loss_is_the_nll_alone_and_serving_is_refused():
    cfg = _small()
    params = tf.init_params(cfg, seed=0, device="cpu")
    batch = {k: v[0] for k, v in _batch(cfg).items()}
    loss, metrics = tf.loss_fn(params, cfg, batch)
    assert torch.equal(loss, metrics["nll"]) and "load_balance" not in metrics
    with pytest.raises(NotImplementedError):
        tf.prefill(params, cfg, batch["tokens"])
    with pytest.raises(NotImplementedError):
        tf.init_decode_cache(cfg, 2, 16, device="cpu")
    mask = optim.decay_mask(params)
    assert set(mask) == {n for n, _ in params.named_parameters()}
    assert not any(n.endswith("bias") for n in mask)
    assert mask["layers.1.attn.kv_norm"] and not mask["final_norm"]


def test_train_launcher_smoke_runs_and_resumes(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--steps", "4", "--batch", "4", "--seq", "16",
                     "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
        launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--steps", "6", "--batch", "4", "--seq", "16",
                     "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    text = out.getvalue()
    assert "resumed from step 4" in text
    done = [ln for ln in text.splitlines() if ln.startswith("done:")]
    assert len(done) == 2 and "'steps_run': 2" in done[1]
    assert all("nan" not in ln for ln in done)
