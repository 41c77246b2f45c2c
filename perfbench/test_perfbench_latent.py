"""The latent-attention cell (Kimi K2) on the CPU: the port against the plain
reference ``reference/train_latent.py`` over three steps, the leaves by
name, shape and stated dtype, the counts the new metrics divide by, their
readers, and a tiny checkout's run through ``drivers/train_latent.py``,
``correct`` with the timed path sound and not with half a batch
(``faults_latent.py``'s: half of the microbatches)."""
import contextlib
import importlib.util
import io
import json
import shutil

import numpy as np
import pytest
import torch

from perfbench import faults_latent, harness
from perfbench.drivers import train as drv
from perfbench.drivers import train_latent as drv_latent
from perfbench.reference import train as ref_lib
from perfbench.reference import train_latent as ref_latent
from perfbench.yardstick import flops, latent

CELL = "kimi-k2-instruct.ft-4k"
CONFIG = json.loads((harness.HERE / "configs" / "kimi-k2-instruct.json")
                    .read_text())
CPU = torch.device("cpu")


def _config(dtype="float32"):
    """The cell's configuration cut to a CPU size: 1 dense and 2 expert
    layers, 4 of 8 routed experts held (the second half)."""
    cfg = json.loads(json.dumps(CONFIG))
    cfg["model"].update(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                        head_dim=8, d_ff=32, vocab=256, n_experts=4, top_k=2,
                        dtype=dtype)
    cfg["latent"].update(q_lora_rank=24, kv_lora_rank=16, qk_nope_head_dim=8,
                         qk_rope_head_dim=8, v_head_dim=8, dense_d_ff=96,
                         router_experts=8, expert_offset=4, yarn_original=8)
    return cfg


def _mix(**over):
    mix = json.loads((harness.HERE / "traffic" / "ft-4k-mb2.json")
                     .read_text())
    mix.update(seq_len=16, batch=4, batches=3, **over)
    return mix


def test_leaves_match_the_port_by_name_shape_and_stated_dtype():
    from repro_torch.configs.base import LatentConfig
    from repro_torch.models.transformer import Transformer
    port = Transformer(LatentConfig(**CONFIG["model"], **CONFIG["latent"]),
                       device="meta")
    spec = latent.LatentSpec.from_config(CONFIG)
    want = ref_latent.leaf_shapes(spec)
    assert {n: tuple(p.shape) for n, p in port.named_parameters()} == want
    stated = ref_lib.stated_dtype(spec)
    assert {n: p.dtype for n, p in port.named_parameters()} == \
        {n: stated(n) for n in want}
    # the cut as PERF.md gives it: 2.79 G weights held here
    total = sum(p.numel() for p in port.parameters())
    assert total == latent.param_count(spec)
    assert 2.78e9 < total < 2.80e9


@pytest.mark.parametrize("microbatches", (1, 2))
def test_reference_follows_the_port_in_float32(microbatches):
    # the same gaps as the dense and MoE cells' test: float32 on both
    # sides, so only the order of float32 sums differs
    cfg, mix = _config(), _mix(microbatches=microbatches)
    got = drv.check_steps(drv_latent.Program(cfg, mix, 5, CPU))
    want = drv_latent.reference_readings(latent.LatentSpec.from_config(cfg),
                                         mix, 5, CPU)
    gaps = drv.compare(got, want)
    assert gaps["first_loss_gap"] < 1e-5 and gaps["grad_norm_gap"] < 1e-5
    assert gaps["change_norm_gap"] < 1e-4
    assert np.ptp(got["losses"]) > 0
    # the held experts' and the shared expert's weights moved
    for leaf in ("layers.1.moe.w_down", "layers.1.moe.shared.w_down",
                 "layers.2.moe.router"):
        assert want["change"][leaf] > 0


def test_counts_of_the_new_metrics():
    s = latent.LatentSpec.from_config(CONFIG)
    # W_qa, W_qb, W_kva, W_kvb, W_o
    assert latent.attention_weights(s) == 101_122_048 == (
        7168 * 1536 + 1536 * 64 * 192 + 7168 * 576 + 512 * 64 * 256
        + 64 * 128 * 7168)
    per_token = latent.model_flops_per_token(s, 4096)
    attn = 3.0 * 5 * 4096 * 64 * (192 + 128)
    assert per_token - attn == pytest.approx(6 * latent.touched_weights(s))
    # experts: 8 of the 8 x 384 routed assignments' weights land here
    moe = 7168 * 384 + 3 * 7168 * 2048 * (1 + 8 * 8 / 384)
    assert latent.touched_weights(s) == pytest.approx(
        5 * 101_122_048 + 3 * 7168 * 18432 + 4 * moe + 20480 * 7168)
    work, nbytes = latent.mla_call(s, 1, 4096)
    assert work == pytest.approx(2 * 4096 * 101_122_048
                                 + 4096 ** 2 * 64 * 320)
    assert flops.least_time_s(work, nbytes) == work / flops.PEAK_BF16_FLOPS


def _read(metric, run):
    spec = importlib.util.spec_from_file_location(
        f"reader_{metric}", harness.HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def test_readers_of_the_new_metrics(monkeypatch):
    from repro_torch import spans
    spans.reset()
    s = latent.LatentSpec.from_config(CONFIG)
    mix = json.loads((harness.HERE / "traffic" / "ft-4k-mb2.json")
                     .read_text())
    run = {"steps": 2, "spec": s, "mix": mix, "tokens_per_step": 8192,
           "trace": {"window_s": 4.0}}
    for metric in ("latent_proj_ms", "shared_expert_ms", "moe_held_share",
                   "mla_roofline"):
        assert _read(metric, run) is None
    summary = {"spans": {
        "attention.latent": {"calls": 40, "ms": 100.0},
        "moe.shared": {"calls": 32, "ms": 60.0},
        "attention.fwd": {"calls": 40, "ms": 800.0}},
        "counters": {"moe.routed": 4800.0, "moe.assignments": 100.0}}
    monkeypatch.setattr(spans, "summary", lambda: summary)
    assert _read("latent_proj_ms", run) == 50.0
    assert _read("shared_expert_ms", run) == 30.0
    assert _read("moe_held_share", run) == pytest.approx(100 / 48)
    least = 40 * flops.least_time_s(*latent.mla_call(s, 1, 4096))
    assert _read("mla_roofline", run) == pytest.approx(100 * least / 0.8)
    done = latent.model_flops_per_token(s, 4096) * 8192 * 2
    assert _read("mfu_latent", run) == pytest.approx(
        100 * done / 4.0 / flops.PEAK_BF16_FLOPS)
    assert _read("mfu_latent", dict(run, spec=drv.Spec.from_model(
        CONFIG["model"]))) is None


def _tiny_checkout(tmp_path):
    """A copy of the benchmark with the cell cut to a CPU size."""
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = tmp_path / "perfbench"
    (base / "configs" / "kimi-k2-instruct.json").write_text(
        json.dumps(_config()))
    (base / "traffic" / "ft-4k-mb2.json").write_text(json.dumps(_mix()))
    (base / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"first_loss_gap": 1e-4, "grad_norm_gap": 1e-4,
         "change_norm_gap": 1e-3, "nonfinite_losses": 0}))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def _run_line(root):
    from perfbench import run
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", CELL, "--seed", "2147483713",
                       "--seconds", "0.2", "--trace", "0"], root, CPU)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_a_sound_run_is_correct(tmp_path):
    line = _run_line(_tiny_checkout(tmp_path))
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["metrics"]) == {"tokens_per_s", "setup_s"}
    assert line["checks"]["first_loss_gap"]["value"] < 1e-5


def test_half_the_batch_is_not_correct(tmp_path, monkeypatch):
    from repro_torch.train import step as step_lib
    real = step_lib.make_train_step

    def make(cfg, opt_cfg, microbatches=1):
        return faults_latent.half_batch(real(cfg, opt_cfg, microbatches),
                                        cfg)
    monkeypatch.setattr(step_lib, "make_train_step", make)
    line = _run_line(_tiny_checkout(tmp_path))
    assert line["correct"] is False


def test_half_the_batch_is_half_the_microbatches():
    # the cell's microbatches hold one row: the fault keeps every shape
    # and trains on the first microbatch's row alone
    seen = []
    broken = faults_latent.half_batch(
        lambda params, opt, batch: seen.append(batch), None)
    tokens = torch.arange(2 * 1 * 8).reshape(2, 1, 8)
    broken(None, None, {"tokens": tokens})
    got = seen[0]["tokens"]
    assert got.shape == tokens.shape
    assert torch.equal(got[0], tokens[0]) and torch.equal(got[1], tokens[0])


def test_the_benchmark_spans_wrap_latent_attention():
    # ``attention_fwd_ms`` reads the benchmark's ``self_attention`` span:
    # every latent layer's attention runs inside it
    from repro_torch.models import transformer as tf_lib
    prog = drv_latent.Program(_config(), _mix(), 5, CPU)
    wrapped = drv.Spans()
    try:
        with torch.profiler.profile() as prof, torch.no_grad():
            tf_lib.loss_fn(prog.params, prog.cfg,
                           {k: v[0] for k, v in prog.batches[0].items()})
    finally:
        wrapped.close()
    names = [e.name for e in prof.events()]
    assert names.count(drv.span_name("self_attention")) == \
        prog.cfg.n_layers
