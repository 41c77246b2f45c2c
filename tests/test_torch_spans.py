"""The span registry (``repro_torch.spans``) in the train step, on the CPU.

Off, a dense and an MoE step insert no autograd node and give the same
bits as the same step with the registry on.  On (under a ``torch.profiler``
window's active phase, or after ``enable()``), the step records its spans,
each under the right parent, with self time within inclusive time; the
MoE drop counters agree with the routing's ``keep``; the benchmark's
readers of the registry return ``None`` on an empty registry and the
registry's numbers on a filled one; and the train launcher's ``--spans``
log lines carry them.
"""
import contextlib
import dataclasses
import importlib.util
import io
import math
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.launch import train as launch
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tf
from repro_torch.train import optim
from repro_torch.train import step as step_lib

ARCHS = ("stablelm-1.6b", "granite-moe-1b-a400m")
READERS = Path(__file__).resolve().parent.parent / "perfbench" / "metrics"
MARKS = ("_ReachBackward", "_LeaveBackward")


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


def _cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(), n_layers=2)


def _state(cfg):
    return step_lib.init_train_state(
        cfg, optim.OptConfig(warmup_steps=1), seed=3, device="cpu")


def _batch(cfg, mb=1, rows=4, seq=16):
    g = torch.Generator().manual_seed(7)
    return {k: torch.randint(0, cfg.vocab, (mb, rows // mb, seq),
                             generator=g) for k in ("tokens", "labels")}


def _step(cfg, mb, batch=None):
    params, st = _state(cfg)
    fn = step_lib.make_train_step(cfg, optim.OptConfig(warmup_steps=1), mb)
    params, st, m = fn(params, st, batch or _batch(cfg, mb))
    return params, st, m


def _nodes(t):
    """Every autograd node of ``t``'s graph, by class name."""
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        n = todo.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        names.append(type(n).__name__)
        todo.extend(f for f, _ in n.next_functions)
    return names


@pytest.mark.parametrize("arch", ARCHS)
def test_off_inserts_no_node_and_on_gives_the_same_bits(arch):
    cfg = _cfg(arch)
    params, _ = _state(cfg)
    mb = {k: v[0] for k, v in _batch(cfg).items()}
    off = _nodes(tf.loss_fn(params, cfg, mb)[0])
    assert not spans.active() and not set(MARKS) & set(off)
    spans.enable()
    on = _nodes(tf.loss_fn(params, cfg, mb)[0])
    spans.disable()
    calls = cfg.n_layers * (2 if cfg.family == "moe" else 1)
    assert len(on) == len(off) + 2 * calls
    assert sorted(n for n in on if n not in MARKS) == sorted(off)
    spans.reset()
    p_off, s_off, m_off = _step(cfg, 2)
    assert spans.summary()["spans"] == {}
    spans.enable()
    p_on, s_on, m_on = _step(cfg, 2)
    assert spans.summary()["spans"]
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    for (n, a), (_, b) in zip(p_off.named_parameters(),
                              p_on.named_parameters()):
        assert torch.equal(a, b), n
    for k in s_off.mu:
        assert torch.equal(s_off.mu[k], s_on.mu[k])
        assert torch.equal(s_off.nu[k], s_on.nu[k])


def _parents(arch, mb):
    moe = arch != "stablelm-1.6b"
    want = {"train.step": [None], "train.fwd": ["train.step"],
            "train.bwd": ["train.step"], "train.update": ["train.step"],
            "attention.fwd": ["layer.recompute", "train.fwd"],
            "attention.bwd": ["train.bwd"],
            # the recompute runs in the first backward span that unpacks
            # a saved tensor: the expert layer's, or the step's
            "layer.recompute": ["moe.bwd" if moe else "train.bwd"]}
    if moe:
        want.update({"moe.fwd": ["layer.recompute", "train.fwd"],
                     "moe.bwd": ["train.bwd"]})
    if mb > 1:
        want["train.accumulate"] = ["train.step"]
    return want


@pytest.mark.parametrize("how", ("profiler", "enable"))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mb", (1, 2))
def test_the_step_records_each_span_under_its_parent(how, arch, mb):
    cfg = _cfg(arch)
    params, st = _state(cfg)
    fn = step_lib.make_train_step(cfg, optim.OptConfig(warmup_steps=1), mb)
    batch = _batch(cfg, mb)
    if how == "profiler":
        prof = profile(activities=[ProfilerActivity.CPU],
                       schedule=schedule(wait=1, warmup=1, active=1,
                                         repeat=1))
        with prof:
            for _ in range(2):      # the wait and warmup phases
                params, st, _ = fn(params, st, batch)
                assert spans.summary()["spans"] == {}
                prof.step()
            params, st, _ = fn(params, st, batch)
        names = {e.name for e in prof.events()}
        assert {spans.PREFIX + n for n in _parents(arch, mb)} <= names
    else:
        spans.enable()
        params, st, _ = fn(params, st, batch)
    s = spans.summary()
    assert {k: v["parents"] for k, v in s["spans"].items()} == \
        _parents(arch, mb)
    assert s["steps"] == 1 and s["dropped"] == 0 and s["clock"] == "host"
    rows = s["spans"]
    layers = cfg.n_layers * mb
    assert rows["attention.fwd"]["calls"] == 2 * layers   # and recompute
    assert rows["attention.bwd"]["calls"] == layers
    assert rows["layer.recompute"]["calls"] == layers
    assert rows["train.fwd"]["calls"] == rows["train.bwd"]["calls"] == mb
    assert rows.get("train.accumulate", {"calls": 0})["calls"] == \
        (mb + 1 if mb > 1 else 0)
    for name, row in rows.items():
        assert 0 <= row["self_ms"] <= row["ms"] + 1e-9, name
    assert rows["train.step"]["self_ms"] < rows["train.step"]["ms"]


def test_nothing_is_recorded_outside_the_active_phase():
    cfg = _cfg(ARCHS[1])
    params, st = _state(cfg)
    fn = step_lib.make_train_step(cfg, optim.OptConfig(warmup_steps=1), 1)
    batch = _batch(cfg)
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=1, warmup=1, active=1, repeat=1))
    with prof:
        for _ in range(2):
            assert not spans.active()
            params, st, _ = fn(params, st, batch)
            prof.step()
        assert spans.active()
    assert not spans.active()
    params, st, _ = fn(params, st, batch)
    s = spans.summary()
    assert s["spans"] == {} and s["counters"] == {}


def test_drop_counters_equal_the_routing_keep(monkeypatch):
    cfg = _cfg(ARCHS[1])
    params, _ = _state(cfg)
    kept = []
    real = moe_lib.route

    def route(*a, **k):
        r = real(*a, **k)
        kept.append(r.keep)
        return r
    monkeypatch.setattr(moe_lib, "route", route)
    spans.enable()
    tf.loss_fn(params, cfg, {k: v[0] for k, v in _batch(cfg).items()})
    c = spans.summary()["counters"]
    keep = torch.cat(kept).float()
    assert len(kept) == cfg.n_layers
    assert c["moe.assignments"] == c["moe.routed"] == keep.numel()
    share = c["moe.dropped"] / c["moe.assignments"]
    assert 0 < share < 1
    assert math.isclose(share, 1 - keep.mean().item(), abs_tol=1e-6)


class _Clock:
    """A host clock that moves only when told to."""

    def __init__(self):
        self.ns = 0

    def __call__(self):
        return self.ns

    def at(self, ms):
        self.ns = int(ms * 1e6)


def _filled(monkeypatch):
    """A registry holding two steps of known spans and counters:
    per step ``attention.bwd`` 50 ms with a 20 ms recompute in it,
    ``moe.bwd`` 40 ms with a 30 ms recompute, ``train.accumulate``
    5 ms, and 3 of 100 assignments dropped."""
    clock = _Clock()
    monkeypatch.setattr(spans.time, "perf_counter_ns", clock)
    spans.enable()
    for step in range(2):
        t = 1000.0 * step
        clock.at(t)
        with spans.span("train.step", new_step=True):
            for name, t0, rc, t1 in (("attention", 10, (20, 40), 60),
                                     ("moe", 100, (105, 135), 140)):
                clock.at(t + t0)
                bwd = spans.REGISTRY.open(name + ".bwd")
                clock.at(t + rc[0])
                with spans.span("layer.recompute"):
                    clock.at(t + rc[1])
                clock.at(t + t1)
                spans.REGISTRY.close(bwd)
            clock.at(t + 200)
            with spans.span("train.accumulate"):
                clock.at(t + 205)
            clock.at(t + 300)
        spans.count("moe.assignments", 100)
        spans.count("moe.dropped", torch.tensor(3.0))
    return {"steps": 2}


def _read(metric, run):
    spec = importlib.util.spec_from_file_location(
        f"reader_{metric}", READERS / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


WANT = {"attention_bwd_ms": 30.0, "moe_bwd_ms": 10.0, "recompute_ms": 50.0,
        "grad_accum_ms": 5.0, "moe_drop_share": 3.0}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_readers_give_none_when_empty_and_the_numbers_when_filled(
        monkeypatch, metric):
    assert _read(metric, {"steps": 2}) is None
    run = _filled(monkeypatch)
    assert _read(metric, run) == pytest.approx(WANT[metric], abs=1e-9)


def test_self_time_leaves_out_children_and_the_buffer_is_bounded(
        monkeypatch):
    _filled(monkeypatch)
    s = spans.summary()
    assert s["steps"] == 2 and s["dropped"] == 0
    step = s["spans"]["train.step"]
    assert step["ms"] == pytest.approx(600.0)
    assert step["self_ms"] == pytest.approx(600.0 - 2 * (50 + 40 + 5))
    assert s["spans"]["layer.recompute"]["parents"] == ["attention.bwd",
                                                        "moe.bwd"]
    assert spans.summary() is s                # cached until reset
    reg = spans.Registry(capacity=3)
    reg.enabled = True
    for _ in range(5):
        reg.close(reg.open("x"))
    assert reg.summary()["spans"]["x"]["calls"] == 3
    assert reg.summary()["dropped"] == 2


def test_a_backward_span_left_open_closes_with_its_parent():
    reg = spans.REGISTRY
    spans.enable()
    outer = reg.open("train.bwd")
    reg.open("moe.bwd")                         # never closed itself
    reg.close(outer)
    assert not reg.stack
    rows = spans.summary()["spans"]
    assert rows["moe.bwd"]["parents"] == ["train.bwd"]


def test_train_launcher_logs_the_spans(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(["--arch", "granite-moe-1b-a400m", "--smoke",
                     "--device", "cpu", "--steps", "20", "--batch", "4",
                     "--seq", "16", "--spans",
                     "--ckpt-dir", str(tmp_path)])
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("step ")]
    assert len(lines) == 2 and not spans.active()
    for ln in lines:
        fields = dict(f.split("=", 1) for f in ln.split()[2:] if "=" in f)
        for name in ("train.step", "train.fwd", "train.bwd", "train.update",
                     "train.accumulate", "attention.bwd", "moe.bwd",
                     "layer.recompute"):
            assert fields[name].endswith("ms") and \
                float(fields[name][:-2]) >= 0, name
        assert 0 <= float(fields["moe.dropped"].rstrip("%")) <= 100
    assert spans.summary()["spans"] == {}
