"""Spans and counters of the train step, on the profiler's clock.

    with spans.span("train.fwd"):
        loss = ...
    with spans.layer("attention") as m:        # attention.fwd
        y = attention(m.input(x))
    y = m.output(y)                            # attention.bwd, backward
    spans.count("moe.dropped", frac, scale=n)  # a 0-d tensor or a number
    spans.summary()   # {"spans": {name: {"calls", "ms", "self_ms", ...}}, ...}

The registry is on while a ``torch.profiler`` session records (its
schedule's active phase) and after :func:`enable`; :func:`active` is the
one test.  Off, :func:`span` and :func:`layer` return a shared null
context whose marks return their argument, :func:`rerun` returns the
function it is given, and :func:`count` returns: no autograd node, no
event, no kernel and no read from the device.

On, a span opens ``torch.profiler.record_function("repro_torch." +
name)``, so a profiler trace shows it beside the kernels, and records
its host start and end (``perf_counter_ns``), a CUDA event at each end on
the current stream (where CUDA is initialised), the span open when it
began (its parent: one stack for the main thread and the autograd
thread, since the main thread waits while the backward runs) and the
step id (:func:`span` with ``new_step`` advances it).  A backward span
is opened by an identity ``autograd.Function`` on the layer's output
when the gradient reaches it and closed by another on the layer's input
when the gradient leaves; :func:`layer` inserts the pair only when on
and only under grad, so a forward without grad (serving) records
nothing.  Under the non-reentrant checkpoint a layer's recompute runs
inside the first backward span that unpacks a saved tensor;
:func:`rerun` puts it under a span of its own, which the enclosing
span's self time leaves out.

:func:`summary` synchronises once, resolves the events and returns, per
span name, ``calls``, inclusive ``ms``, ``self_ms`` (inclusive less the
part its child spans cover) and the names of its ``parents``, with the
counters, the number of steps and of spans dropped from the bounded
buffer.  It is cached until :func:`reset`.  Times come from the CUDA
events when every kept span has them, else from the host clock.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

PREFIX = "repro_torch."
#: spans kept in memory; later ones are counted in ``dropped``
CAPACITY = 1 << 16

Number = Union[int, float, torch.Tensor]


class _Span:
    __slots__ = ("name", "parent", "step", "kept", "t0", "t1", "ev0", "ev1",
                 "rf")

    def __init__(self, name: str, parent: Optional["_Span"], step: int,
                 kept: bool):
        self.name, self.parent, self.step, self.kept = name, parent, step, kept
        self.t0 = self.t1 = self.ev0 = self.ev1 = self.rf = None


def _event() -> Optional[torch.cuda.Event]:
    """A timing event recorded on the current stream, if CUDA is up."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _total(vals: List[Tuple[Number, float]], fold: bool = False) -> Number:
    """The sum of a counter's ``(value, scale)`` pairs: host numbers on
    the host, tensors on the device; ``fold`` keeps a tensor sum there."""
    host = sum(v * k for v, k in vals if not isinstance(v, torch.Tensor))
    dev = [v.detach().double() * k for v, k in vals
           if isinstance(v, torch.Tensor)]
    if not dev:
        return host
    tot = torch.stack(dev).sum() + host
    return tot if fold else tot.item()


def _covered(a: float, b: float, spans: List[Tuple[float, float]]) -> float:
    """The length of ``[a, b]`` that the union of ``spans`` covers."""
    out, end = 0.0, a
    for x, y in sorted(spans):
        x, y = max(x, end), min(y, b)
        if y > x:
            out += y - x
            end = y
    return out


class Registry:
    """Open spans (one stack), kept spans and counters; see the module's
    docstring."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.enabled = False
        self.reset()

    def reset(self) -> None:
        self.kept: List[_Span] = []
        self.stack: List[_Span] = []
        self.counters: Dict[str, List[Tuple[Number, float]]] = {}
        self.dropped = 0
        self.step = 0
        self._summary: Optional[Dict[str, Any]] = None

    def open(self, name: str, new_step: bool = False) -> _Span:
        if new_step:
            self.step += 1
        rec = _Span(name, self.stack[-1] if self.stack else None, self.step,
                    len(self.kept) + len(self.stack) < self.capacity)
        rec.rf = torch.autograd.profiler.record_function(PREFIX + name)
        rec.rf.__enter__()
        rec.t0 = time.perf_counter_ns()
        if rec.kept:
            rec.ev0 = _event()
        self.stack.append(rec)
        return rec

    def close(self, rec: _Span) -> None:
        """Close ``rec``, and first any span opened after it and left
        open (a backward span whose input the gradient never left)."""
        if rec not in self.stack:
            return
        while True:
            top = self.stack.pop()
            if top.kept:
                top.ev1 = _event()
            top.t1 = time.perf_counter_ns()
            top.rf.__exit__(None, None, None)
            top.rf = None
            if top.kept:
                self.kept.append(top)
            else:
                self.dropped += 1
            self._summary = None
            if top is rec:
                return

    def count(self, name: str, value: Number, scale: float = 1) -> None:
        vals = self.counters.setdefault(name, [])
        vals.append((value, scale))
        if len(vals) >= self.capacity:
            self.counters[name] = [(_total(vals, fold=True), 1)]
        self._summary = None

    def summary(self) -> Dict[str, Any]:
        if self._summary is None:
            self._summary = self._resolve()
        return self._summary

    def _times(self) -> Tuple[List[Tuple[float, float]], str]:
        """Each kept span's (start, end) in ms, on the device's clock
        where every span has its events, else on the host's."""
        spans = self.kept
        if spans and all(s.ev0 is not None and s.ev1 is not None
                         for s in spans):
            torch.cuda.synchronize()
            base = min(spans, key=lambda s: s.t0).ev0
            return [(base.elapsed_time(s.ev0), base.elapsed_time(s.ev1))
                    for s in spans], "cuda_events"
        t = min((s.t0 for s in spans), default=0)
        return [((s.t0 - t) / 1e6, (s.t1 - t) / 1e6) for s in spans], "host"

    def _resolve(self) -> Dict[str, Any]:
        spans = self.kept
        times, clock = self._times()
        index = {id(s): i for i, s in enumerate(spans)}
        children: Dict[int, List[Tuple[float, float]]] = {}
        for i, s in enumerate(spans):
            if s.parent is not None and id(s.parent) in index:
                children.setdefault(index[id(s.parent)], []).append(times[i])
        rows: Dict[str, Dict[str, Any]] = {}
        for i, s in enumerate(spans):
            a, b = times[i]
            row = rows.setdefault(s.name, {"calls": 0, "ms": 0.0,
                                           "self_ms": 0.0, "parents": set()})
            row["calls"] += 1
            row["ms"] += b - a
            row["self_ms"] += b - a - _covered(a, b, children.get(i, []))
            row["parents"].add(s.parent.name if s.parent else None)
        for row in rows.values():
            row["parents"] = sorted(row["parents"], key=str)
        return {"spans": rows,
                "counters": {k: float(_total(v))
                             for k, v in self.counters.items()},
                "steps": len({s.step for s in spans if s.step}),
                "dropped": self.dropped, "clock": clock}


REGISTRY = Registry()


def active() -> bool:
    """Whether spans and counts are recorded: after :func:`enable`, or
    while a ``torch.profiler`` session is in its active phase."""
    return REGISTRY.enabled or torch._C._autograd._profiler_enabled()


def enable() -> None:
    REGISTRY.enabled = True


def disable() -> None:
    REGISTRY.enabled = False


def reset() -> None:
    """Forget every kept span, counter and cached summary."""
    REGISTRY.reset()


def summary() -> Dict[str, Any]:
    return REGISTRY.summary()


def count(name: str, value: Number, scale: float = 1) -> None:
    """Add ``value`` x ``scale`` to the counter ``name``; ``value`` is a
    number or a 0-d tensor left on its device, and the product is taken
    when the summary is read, so counting launches no kernel."""
    if active():
        REGISTRY.count(name, value, scale)


class _Null:
    """The context and marks of a span that is not recorded."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def input(x):
        return x

    @staticmethod
    def output(y):
        return y


_NULL = _Null()


class _SpanCtx:
    __slots__ = ("name", "new_step", "rec")

    def __init__(self, name: str, new_step: bool):
        self.name, self.new_step, self.rec = name, new_step, None

    def __enter__(self):
        self.rec = REGISTRY.open(self.name, self.new_step)
        return self

    def __exit__(self, *exc):
        REGISTRY.close(self.rec)
        return False


def span(name: str, new_step: bool = False):
    """A context recording span ``name`` when :func:`active`;
    ``new_step`` gives it, and every span after it, a new step id."""
    if not active():
        return _NULL
    return _SpanCtx(name, new_step)


class _Reach(torch.autograd.Function):
    """Identity; its backward opens the layer's backward span."""

    @staticmethod
    def forward(ctx, marks, y):
        ctx.marks = marks
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        m = ctx.marks
        m.bwd = REGISTRY.open(m.name + ".bwd")
        return None, g


class _Leave(torch.autograd.Function):
    """Identity; its backward closes the layer's backward span."""

    @staticmethod
    def forward(ctx, marks, x):
        ctx.marks = marks
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        m = ctx.marks
        if m.bwd is not None:
            REGISTRY.close(m.bwd)
            m.bwd = None
        return None, g


class _Marks(_SpanCtx):
    """The forward span ``<name>.fwd`` of one call, and the marks that
    time its backward as ``<name>.bwd``."""

    __slots__ = ("armed", "bwd")

    def __init__(self, name: str):
        super().__init__(name, False)
        self.armed, self.bwd = False, None

    def __enter__(self):
        self.rec = REGISTRY.open(self.name + ".fwd")
        return self

    def input(self, x: torch.Tensor) -> torch.Tensor:
        if not x.requires_grad:
            return x
        self.armed = True
        return _Leave.apply(self, x)

    def output(self, y: torch.Tensor) -> torch.Tensor:
        if not (self.armed and y.requires_grad):
            return y
        return _Reach.apply(self, y)


def layer(name: str):
    """A context recording ``<name>.fwd`` around a layer's call, with
    ``input`` / ``output`` marks for its tensors (the gradient's way
    between them is ``<name>.bwd``), when :func:`active` and under
    grad."""
    if not (active() and torch.is_grad_enabled()):
        return _NULL
    return _Marks(name)


def rerun(fn: Callable) -> Callable:
    """``fn`` for ``torch.utils.checkpoint``: its first call runs as it
    is, every later one (the recompute) under span ``layer.recompute``."""
    if not active():
        return fn
    calls = [0]

    def wrapped(*args):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*args)
        with span("layer.recompute"):
            return fn(*args)
    return wrapped
