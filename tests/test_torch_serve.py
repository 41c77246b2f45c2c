"""The port's serving path against the JAX package's, on the CPU.

Greedy ``generate`` gives the reference's tokens in float32 with the
same weights (carried across with ``params_from_reference``; the vlm
family's gates set nonzero from the seed on both sides) and the same
frontend inputs, for all six families; the port's twins of the reference's serving tests
(``tests/test_serve_consistency.py``, ``tests/test_perf_knobs.py``)
hold prefill + decode against the port's own full forward at the
reference's tolerances; and the ``repro_torch.launch.serve`` entry point
runs end to end.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.models import transformer as ref_tf
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.models import transformer as tf
from repro_torch.serve import engine

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are many small ops, which extra
    threads only slow when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch, seed, **kw):
    """The reduced config on both sides and the reference's weights."""
    rcfg = dataclasses.replace(ref_config(arch).reduced(), **kw)
    pcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    rp = ref_tf.init_params(rcfg, jax.random.PRNGKey(seed))
    return rcfg, pcfg, rp, tf.params_from_reference(
        jax.tree.map(np.asarray, rp), pcfg, "cpu")


def _gated(rp, pp, seed):
    """The vlm gates (zero at init: the image would change nothing) set
    to nonzero values from ``seed`` on both sides."""
    if not pp.cross_layers or pp.cfg.family != "vlm":
        return rp
    n = len(pp.cross_layers)
    g = np.random.default_rng(seed).uniform(0.5, 1.5, (2, n))
    for blk, ga, gm in zip(pp.cross_layers, g[0], g[1]):
        blk.gate_attn.fill_(float(np.float32(ga)))
        blk.gate_mlp.fill_(float(np.float32(gm)))
    return dict(rp, cross_layers=dict(
        rp["cross_layers"], gate_attn=jnp.asarray(g[0], jnp.float32),
        gate_mlp=jnp.asarray(g[1], jnp.float32)))


def _extra(cfg, b, seed):
    """The family's frontend input from a numpy seed: ``(jax, torch)``
    dicts (empty for the families without one)."""
    if cfg.family not in ("encdec", "vlm"):
        return {}, {}
    name, shape = (("enc_frames", (b, cfg.enc_seq, cfg.d_model))
                   if cfg.family == "encdec" else
                   ("image_embeds", (b, cfg.vision_tokens, cfg.vision_dim)))
    a = np.random.default_rng(seed).normal(size=shape).astype(
        np.float32) * 0.1
    return {name: jnp.asarray(a)}, {name: torch.from_numpy(a)}


def _tokens(seed, shape, vocab):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, vocab, shape)).long()


def _last_logits(params, cfg, tokens, extra=None):
    out = tf.forward(params, cfg, tokens, extra)
    return (out.hidden[:, -1] @ params.head).float().numpy()


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-1b-a400m",
                                  "zamba2-7b", "xlstm-1.3b",
                                  "seamless-m4t-medium",
                                  "llama-3.2-vision-11b"])
def test_generate_matches_reference_tokens(arch):
    rcfg, pcfg, rp, pp = _models(arch, 0, dtype="float32")
    rp = _gated(rp, pp, 0)
    rex, pex = _extra(pcfg, 2, 2)
    prompt = _tokens(1, (2, 8), pcfg.vocab)
    got = engine.generate(pp, pcfg, prompt, n_tokens=6, extra=pex)
    want = ref_engine.generate(rp, rcfg, jnp.asarray(prompt.numpy()),
                               n_tokens=6, extra=rex or None, jit=True)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-moe-1b-a400m",
                                  "zamba2-7b", "xlstm-1.3b",
                                  "llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_decode_matches_forward(arch):
    # MoE: no capacity drops, so a 32-token prefill and a 2-token decode
    # compute the same expert mixtures (as the reference's twin)
    kw = dict(capacity_factor=100.0) if "moe" in arch else {}
    _, cfg, rp, params = _models(arch, 1, **kw)
    _gated(rp, params, 1)
    _, extra = _extra(cfg, 2, 1)
    B, T = 2, 16
    tokens = _tokens(1, (B, T + 1), cfg.vocab)
    ref = _last_logits(params, cfg, tokens, extra)
    _, cache = tf.prefill(params, cfg, tokens[:, :T], extra, max_len=T + 1)
    got, _ = tf.decode_step(params, cfg, cache, tokens[:, T:T + 1], extra)
    got = got.numpy()
    assert np.argmax(ref, -1).tolist() == np.argmax(got, -1).tolist()
    np.testing.assert_allclose(got, ref, rtol=0.12, atol=0.12)


def _gap(prefill, decode, forward, tokens, t):
    """Teacher-forced decode logits at positions ``t - 1 ..`` against
    one full forward over ``tokens[:, :-1]``: ``|decode - forward|``
    ``[B, n, V]``."""
    logits, cache = prefill(tokens[:, :t])
    got = [np.asarray(logits, np.float32)]
    for i in range(t, tokens.shape[1] - 1):
        logits, cache = decode(cache, tokens[:, i:i + 1])
        got.append(np.asarray(logits, np.float32))
    want = np.asarray(forward(tokens[:, :-1]), np.float32)[:, t - 1:]
    return np.abs(np.stack(got, 1) - want)


# (arch, layers): reduced widths, deeper than the reduced configs, where
# the reference's own bfloat16 gap grows past its 0.12 (zamba2) or up to
# it (xlstm)
GAP_CASES = [("zamba2-7b", 8), ("xlstm-1.3b", 16)]


@pytest.mark.parametrize("arch,layers", GAP_CASES,
                         ids=[f"{a}-{n}" for a, n in GAP_CASES])
def test_bf16_decode_gap_within_the_references(arch, layers):
    """The port's bfloat16 decode against its own forward (prefill of 16
    tokens, then 7 teacher-forced decode steps, batch 2) is no further
    from it than the reference's decode is from the reference's forward,
    on the same weights and tokens: max and rms of ``|decode -
    forward|`` over the logits.  Measured: the reference's max 0.219
    (zamba2, 8 layers) and 0.126 (xlstm, 16 layers), the port's 0.000
    and 0.031: the port's recurrent blocks keep the products that the
    reference's chunked forms round to bfloat16 (``C . B`` and the
    decay weights in Mamba2, ``Q . K`` and the key scale in mLSTM) in
    float32, as their recurrent decode steps do."""
    rcfg, pcfg, rp, pp = _models(arch, 0, dtype="bfloat16", n_layers=layers)
    b, t, n = 2, 16, 8
    tok = np.random.default_rng(0).integers(0, rcfg.vocab,
                                            (b, t + n)).astype(np.int32)
    head = rp.get("lm_head")
    head = rp["tok_embed"].T if head is None else head
    ref = _gap(
        jax.jit(lambda x: ref_tf.prefill(rp, rcfg, x, max_len=t + n)),
        jax.jit(lambda c, x: ref_tf.decode_step(rp, rcfg, c, x)),
        jax.jit(lambda x: jnp.einsum("btd,dv->btv",
                                     ref_tf.forward(rp, rcfg, x).hidden,
                                     head)), jnp.asarray(tok), t)
    with torch.inference_mode():
        mine = _gap(
            lambda x: tf.prefill(pp, pcfg, x, max_len=t + n),
            lambda c, x: tf.decode_step(pp, pcfg, c, x),
            lambda x: (tf.forward(pp, pcfg, x).hidden @ pp.head).float(),
            torch.from_numpy(tok).long(), t)
    assert mine.max() <= ref.max() + 0.01, (mine.max(), ref.max())
    assert np.sqrt((mine ** 2).mean()) <= np.sqrt((ref ** 2).mean())


def test_multi_step_decode_stays_consistent():
    _, cfg, _, params = _models("stablelm-1.6b", 2)
    B, T, N = 1, 8, 4
    tokens = _tokens(2, (B, T + N), cfg.vocab)
    _, cache = tf.prefill(params, cfg, tokens[:, :T], max_len=T + N)
    for i in range(N):
        got, cache = tf.decode_step(params, cfg, cache,
                                    tokens[:, T + i:T + i + 1])
        ref = _last_logits(params, cfg, tokens[:, :T + i + 1])
        assert np.argmax(ref, -1).tolist() == \
            np.argmax(got.numpy(), -1).tolist(), f"step {i}"


def test_int8_kv_cache_decode_matches_forward():
    _, cfg, _, params = _models("stablelm-1.6b", 3, kv_cache_dtype="int8")
    B, T = 2, 16
    tokens = _tokens(3, (B, T + 1), cfg.vocab)
    ref = _last_logits(params, cfg, tokens)
    _, cache = tf.prefill(params, cfg, tokens[:, :T], max_len=T + 1)
    assert cache["attn"]["k"].dtype == torch.int8
    got, _ = tf.decode_step(params, cfg, cache, tokens[:, T:T + 1])
    assert np.argmax(ref, -1).tolist() == \
        np.argmax(got.numpy(), -1).tolist()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0.25, atol=0.25)


def test_int8_moe_dispatch_close_to_baseline():
    _, base, _, params = _models("granite-moe-1b-a400m", 0,
                                 capacity_factor=100.0)
    quant = dataclasses.replace(base, moe_quant_dispatch=True)
    batch = {"tokens": _tokens(4, (2, 32), base.vocab),
             "labels": _tokens(5, (2, 32), base.vocab)}
    l0, m0 = tf.loss_fn(params, base, batch)
    l1, _ = tf.loss_fn(params, quant, batch)
    assert abs(float(l0) - float(l1)) < 0.05 * float(l0)
    assert {"nll", "loss", "load_balance", "router_z",
            "dropped_frac"} <= set(m0)


def test_seq_parallel_is_noop_on_single_device():
    _, base, _, params = _models("qwen3-4b", 1)
    sp = dataclasses.replace(base, seq_parallel=True)
    batch = {"tokens": _tokens(6, (2, 32), base.vocab),
             "labels": _tokens(7, (2, 32), base.vocab)}
    l0, _ = tf.loss_fn(params, base, batch)
    l1, _ = tf.loss_fn(params, sp, batch)
    assert float(l0) == float(l1)


def test_int8_cache_struct_halves_bytes():
    cfg = get_config("qwen3-4b")
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")

    def nbytes(c):
        cache = tf.init_decode_cache(c, 8, 1024, device="meta")
        return sum(t.numel() * t.element_size()
                   for t in cache["attn"].values())
    assert nbytes(cfg8) < 0.55 * nbytes(cfg)


def test_generate_greedy_runs():
    cfg = get_config("qwen3-4b").reduced()
    params = tf.init_params(cfg, seed=0, device="cpu")
    prompt = torch.full((2, 8), 5, dtype=torch.long)
    out = engine.generate(params, cfg, prompt, n_tokens=6)
    assert out.shape == (2, 6)
    assert bool((out >= 0).all()) and bool((out < cfg.vocab).all())


def test_serve_launcher_smoke_on_cpu():
    _launch_serve("qwen3-4b")


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_serve_launcher_recurrent_families_on_cpu(arch):
    _launch_serve(arch)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llama-3.2-vision-11b"])
def test_serve_launcher_cross_families_on_cpu(arch):
    """The launcher builds the stub frontend's input from its seed."""
    _launch_serve(arch)


def _launch_serve(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         arch, "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "16", "--gen", "4"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "prefill(16 tok):" in out and "ms/step" in out
    assert "sample tokens[0,:8]:" in out and "device=cpu" in out
