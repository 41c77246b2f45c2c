"""The training driver: the port's train step, step after step, on batches
already on the device.

Set-up builds the program's model and AdamW state from the seed's weights,
moves the mix's batches to the device, and drives the step through its
first ``check_steps`` steps (the readings ``correct`` compares, and the
warm-up of every shape the window uses).  The same objects then go to the
window: ``--seconds`` of steps, each reading its loss back as the port's
launcher does (``--trace 0``), or ``trace_steps`` steps under the profiler
with the benchmark's spans around the layers (``--trace 1``).  Once the
window has closed and the program's state is freed, the plain reference
follows the first steps from the same weights and batches.
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

from perfbench.reference import train as ref_lib
from perfbench.yardstick import tokens, trace, weights
from perfbench.yardstick.spec import Spec

#: the program's functions the traced window wraps in spans, by module
SPANS = {"repro_torch.models.attention": ("self_attention",),
         "repro_torch.models.moe": ("moe", "route"),
         "repro_torch.train.optim": ("update",)}


def span_name(fn: str) -> str:
    return f"perfbench.{fn}"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def seed_of(seed: int) -> int:
    return int(seed) % (1 << 64)


class Program:
    """The port's model, AdamW state and train step, and the mix's batches
    on the device."""

    def __init__(self, spec_model: Dict, mix: Dict, seed: int,
                 dev: torch.device):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models import transformer as tf_lib
        from repro_torch.train import optim as optim_lib
        from repro_torch.train import step as step_lib
        self.spec = Spec.from_model(spec_model)
        self.cfg = ModelConfig(**spec_model)
        self.mix = mix
        self.opt_cfg = optim_lib.OptConfig(**mix["optimizer"])
        self.params = tf_lib.Transformer(self.cfg, device=dev)
        weights.fill(dict(self.params.named_parameters()), seed,
                     ref_lib.stated_dtype(self.spec))
        self.params.requires_grad_(True)
        self.opt_state = optim_lib.init(self.params, self.opt_cfg)
        self.step_fn = step_lib.make_train_step(self.cfg, self.opt_cfg,
                                                mix["microbatches"])
        self.batches = [device_batch(seed, i, self.spec, mix, dev)
                        for i in range(mix["batches"])]
        self.n = 0

    @property
    def tokens_per_step(self) -> int:
        return self.mix["batch"] * self.mix["seq_len"]

    def step(self) -> float:
        """One train step on the next batch; its loss, read back."""
        batch = self.batches[self.n % len(self.batches)]
        self.params, self.opt_state, m = self.step_fn(
            self.params, self.opt_state, batch)
        self.n += 1
        return float(m["loss"])

    def leaves(self) -> Dict[str, torch.Tensor]:
        return dict(self.params.named_parameters())


def device_batch(seed: int, i: int, spec: Spec, mix: Dict,
                 dev: torch.device) -> Dict[str, torch.Tensor]:
    b = tokens.batch_at(seed_of(seed), i, spec.vocab, mix["seq_len"],
                        mix["batch"], mix["microbatches"],
                        mix["zipf_exponent"])
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def _norms(ts: List[torch.Tensor]) -> List[float]:
    return torch.stack([t.detach().float().norm() for t in ts]).tolist()


def check_steps(prog: Program) -> Dict:
    """Drive the program through its first ``check_steps`` steps: each
    step's loss, the first gradient's leaf norms as AdamW took it (from
    its first moment) and the leaf norms of the weights' change."""
    names = list(prog.leaves())
    start = {n: p.detach().clone() for n, p in prog.leaves().items()}
    b1 = prog.mix["optimizer"]["b1"]
    losses, first = [], None
    for i in range(prog.mix["check_steps"]):
        losses.append(prog.step())
        if i == 0:
            mu = prog.opt_state.mu
            first = dict(zip(names, (v / (1 - b1) for v in
                                     _norms([mu[n] for n in names]))))
    now = prog.leaves()
    change = dict(zip(names, _norms([now[n].float() - start[n].float()
                                     for n in names])))
    return {"losses": losses, "first_grad": first, "change": change}


def reference_readings(spec: Spec, mix: Dict, seed: int, dev: torch.device,
                       precision: str = "float32") -> Dict:
    """The reference's first ``check_steps`` steps from the seed's weights
    and batches."""
    w = {n: torch.empty(s, dtype=torch.float32, device=dev)
         for n, s in ref_lib.leaf_shapes(spec).items()}
    weights.fill(w, seed, ref_lib.stated_dtype(spec))
    batches = [device_batch(seed, i, spec, mix, dev)
               for i in range(mix["check_steps"])]
    return ref_lib.run_steps(spec, w, batches, mix["optimizer"], precision)


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float],
               keep: Optional[List[str]] = None) -> List[float]:
    """Each leaf's gap of norms, over the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    names = keep if keep is not None else list(want)
    med = statistics.median(want[n] for n in names)
    return [abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names]


def compare(got: Dict, want: Dict) -> Dict[str, float]:
    """The numbers a cell's limits may hold.  The loss is taken at the
    first step: the later steps' losses follow full-rate AdamW updates,
    where a rounding apart can swing them from seed to seed (their gaps
    are a reading of ``calibrate.py``).  Each leaf reading is given by its
    worst leaf and by its median leaf, which one small leaf's noise does
    not move.  Leaves whose first gradient is under a thousandth of the
    median leaf's in the reference move by round-off alone and are left
    out of the change."""
    gmed = statistics.median(want["first_grad"].values())
    moved = [n for n, g in want["first_grad"].items() if g >= 1e-3 * gmed]
    grad = _leaf_gaps(got["first_grad"], want["first_grad"])
    change = _leaf_gaps(got["change"], want["change"], moved)
    return {
        "first_loss_gap": abs(got["losses"][0] - want["losses"][0]),
        "grad_norm_gap": max(grad),
        "grad_norm_gap_median": statistics.median(grad),
        "change_norm_gap": max(change),
        "change_norm_gap_median": statistics.median(change),
    }


# ---------------------------------------------------------------------------
# the traced window's spans
# ---------------------------------------------------------------------------

class Spans:
    """``record_function`` wrappers on the program's module attributes
    (its callers look them up at call time, and the checkpoint's recompute
    calls them again), plus the routing counter ``moe_slot_use`` reads."""

    def __init__(self):
        import importlib
        self.saved = []
        self.kept: List[torch.Tensor] = []
        self.slots = 0
        for mod_name, fns in SPANS.items():
            mod = importlib.import_module(mod_name)
            for fn in fns:
                orig = getattr(mod, fn)
                self.saved.append((mod, fn, orig))
                setattr(mod, fn, self._wrap(fn, orig))

    def _wrap(self, fn: str, orig: Callable) -> Callable:
        name = span_name(fn)

        def wrapped(*a, **k):
            with torch.profiler.record_function(name):
                out = orig(*a, **k)
            if fn == "route":           # counted after the window: no kernel
                self.kept.append(out.keep)
                self.slots += out.table.numel()
            return out
        return wrapped

    def close(self) -> Optional[Dict[str, int]]:
        for mod, fn, orig in self.saved:
            setattr(mod, fn, orig)
        if not self.kept:
            return None
        return {"kept": int(sum(int(k.sum()) for k in self.kept)),
                "slots": self.slots}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run(ctx) -> Dict:
    """One run of a training cell; ``ctx`` is the harness's resolved cell
    (see ``perfbench/harness.py``)."""
    dev, mix, seed = ctx.device, ctx.mix, ctx.seed
    prog = Program(ctx.config["model"], mix, seed, dev)
    spec = prog.spec
    got = check_steps(prog)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    result = {"metrics": {}, "device": {}}
    window_losses: List[float] = []
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    ends: List[float] = []
    if not ctx.trace:
        while True:
            window_losses.append(prog.step())
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= ctx.seconds:
                break
        _sync(dev)
        wall = time.perf_counter() - t0
        result["metrics"] = {
            "tokens_per_s": len(window_losses) * prog.tokens_per_step / wall,
            "setup_s": setup_s}
    else:
        spans = Spans()
        try:
            with trace.profiled_window(dev) as prof:
                with torch.profiler.record_function(trace.WINDOW):
                    for _ in range(mix["trace_steps"]):
                        window_losses.append(prog.step())
                    _sync(dev)
        finally:
            routing = spans.close()
        t_read = time.perf_counter()
        summary = trace.reduce(
            prof.events(), [span_name(f) for fns in SPANS.values()
                            for f in fns])
        result["trace_read_s"] = time.perf_counter() - t_read
        result["trace"] = summary
        result["routing"] = routing
        result["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["top_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["steps"] = len(window_losses)
    result["tokens_per_step"] = prog.tokens_per_step
    result["spec"] = spec
    result["mix"] = mix
    result["device"]["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)

    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = reference_readings(spec, mix, seed, dev)
    checks = compare(got, want)
    bad = sum(not math.isfinite(x) for x in window_losses)
    checks["nonfinite_losses"] = float(bad)
    result.update(attempted=len(window_losses), failed=bad, checks=checks)
    # for the reader of a run: the losses, when each window step ended,
    # and what the reference and the trace's reading cost
    result["notes"] = {
        "losses": {"check": got["losses"], "window_first": window_losses[0],
                   "window_last": window_losses[-1],
                   "window_max": max(window_losses)},
        "step_ends_s": [round(t, 4) for t in ends],
        "reference_s": time.perf_counter() - t_ref,
        "trace_read_s": result.pop("trace_read_s", None)}
    return result
