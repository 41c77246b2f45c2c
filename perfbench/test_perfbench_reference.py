"""The plain reference against the port on one train step, the draws, and
the run's ``correct`` coming out false with the timed path broken."""
import contextlib
import io
import json
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from perfbench import faults, harness
from perfbench.drivers import train as drv
from perfbench.reference import train as ref_lib
from perfbench.yardstick import tokens, weights
from perfbench.yardstick.spec import Spec

CONFIGS = ("stablelm-1.6b", "granite-moe-1b-a400m")
CPU = torch.device("cpu")


def _model(config, dtype="float32"):
    """The config's model block cut to a CPU size (the port's ``reduced``
    widths)."""
    model = json.loads((harness.HERE / "configs" / f"{config}.json")
                       .read_text())["model"]
    mha = model["n_kv_heads"] == model["n_heads"]
    model.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4 if mha else 2,
                 d_ff=96, vocab=256, dtype=dtype)
    if model.get("n_experts"):
        model.update(n_experts=8, top_k=2)
    return model


def _mix(**over):
    mix = json.loads((harness.HERE / "traffic" / "ft-512.json").read_text())
    mix.update(seq_len=16, batch=4, batches=3, **over)
    return mix


@pytest.mark.parametrize("config", CONFIGS)
def test_leaves_match_the_port_by_name_and_shape(config):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.transformer import Transformer
    model = json.loads((harness.HERE / "configs" / f"{config}.json")
                       .read_text())["model"]
    port = Transformer(ModelConfig(**model), device="meta")
    want = ref_lib.leaf_shapes(Spec.from_model(model))
    assert {n: tuple(p.shape) for n, p in port.named_parameters()} == want
    stated = ref_lib.stated_dtype(Spec.from_model(model))
    assert {n: p.dtype for n, p in port.named_parameters()} == \
        {n: stated(n) for n in want}


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("microbatches", (1, 2))
def test_reference_follows_the_port_in_float32(config, microbatches):
    model, mix = _model(config), _mix(microbatches=microbatches)
    got = drv.check_steps(drv.Program(model, mix, 5, CPU))
    want = drv.reference_readings(Spec.from_model(model), mix, 5, CPU)
    gaps = drv.compare(got, want)
    assert gaps["first_loss_gap"] < 1e-5 and gaps["grad_norm_gap"] < 1e-5
    assert gaps["change_norm_gap"] < 1e-4
    assert np.ptp(got["losses"]) > 0


def test_draws_are_pure_functions_of_the_seed():
    seed = 2 ** 31 + 12_345
    a = tokens.batch_at(seed, 3, 1000, 16, 4, 2)
    b = tokens.batch_at(seed, 3, 1000, 16, 4, 2)
    assert a["tokens"].shape == (2, 2, 16)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["tokens"],
                              tokens.batch_at(seed, 4, 1000, 16, 4, 2)["tokens"])
    spec = Spec.from_model(_model(CONFIGS[1], "bfloat16"))
    shapes = ref_lib.leaf_shapes(spec)
    w1 = {n: torch.empty(s) for n, s in shapes.items()}
    w2 = {n: torch.empty(s) for n, s in shapes.items()}
    for w in (w1, w2):
        weights.fill(w, seed, ref_lib.stated_dtype(spec))
    assert all(torch.equal(w1[n], w2[n]) for n in shapes)
    assert torch.equal(w1["layers.0.attn.wq"],
                       w1["layers.0.attn.wq"].bfloat16().float())
    assert w1["final_norm"].eq(1).all()


def _tiny_checkout(tmp_path):
    """A copy of the benchmark with one tiny float32 cell."""
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = tmp_path / "perfbench"
    (base / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "source": "https://example.org/tiny",
         "model": _model(CONFIGS[1])}))
    (base / "traffic" / "tiny-mix.json").write_text(json.dumps(_mix()))
    (base / "limits" / "tiny.tiny-mix.json").write_text(json.dumps(
        {"first_loss_gap": 1e-4, "grad_norm_gap": 1e-4, "change_norm_gap": 1e-3,
         "nonfinite_losses": 0}))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "https://example.org/tiny",
                         "file": "perfbench/configs/tiny.json",
                         "reduced": []}]
    bench["workloads"] = [{"name": "tiny.tiny-mix", "config": "tiny",
                           "traffic": "tiny-mix", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m["workloads"] = ["tiny.tiny-mix"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def _run(root):
    from perfbench import run
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", "tiny.tiny-mix", "--seed", "2147483713",
                       "--seconds", "0.2", "--trace", "0"], root, CPU)
    return rc, out.getvalue()


def _run_line(root):
    rc, out = _run(root)
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])


def _broken(kind):
    """``make_train_step`` with one fault planted under the timed path."""
    from repro_torch.train import step as step_lib
    real = step_lib.make_train_step

    def make(cfg, opt_cfg, microbatches=1):
        return faults.FAULTS[kind](real(cfg, opt_cfg, microbatches), cfg)
    return make


def test_a_sound_run_is_correct_and_prints_its_checks_last(tmp_path):
    line = _run_line(_tiny_checkout(tmp_path))
    assert line["correct"] is True and line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"tokens_per_s", "setup_s"}
    assert line["checks"]["first_loss_gap"]["limit"] == 1e-4


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    from repro_torch.train import step as step_lib
    monkeypatch.setattr(step_lib, "make_train_step", _broken(fault))
    line = _run_line(_tiny_checkout(tmp_path))
    assert line["correct"] is False


def test_a_run_that_loads_the_jax_package_prints_no_result(tmp_path,
                                                           monkeypatch):
    from repro_torch.train import step as step_lib
    real = step_lib.make_train_step

    def make(cfg, opt_cfg, microbatches=1):
        monkeypatch.setitem(sys.modules, "repro.planted",
                            types.ModuleType("repro.planted"))
        return real(cfg, opt_cfg, microbatches)
    monkeypatch.setattr(step_lib, "make_train_step", make)
    rc, out = _run(_tiny_checkout(tmp_path))
    assert rc != 0 and out.strip() == ""


def test_a_module_loaded_after_the_window_still_stops_the_result(
        tmp_path, monkeypatch):
    real = harness.judge

    def judge(checks, limits):
        # a name no earlier test loaded, under the forbidden top level
        monkeypatch.setitem(sys.modules, "jax.perfbench_planted",
                            types.ModuleType("jax.perfbench_planted"))
        return real(checks, limits)
    monkeypatch.setattr(harness, "judge", judge)
    rc, out = _run(_tiny_checkout(tmp_path))
    assert rc != 0 and out.strip() == ""
