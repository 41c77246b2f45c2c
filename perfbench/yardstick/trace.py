"""The profiler window and its reduction to the numbers the metrics read.

``profiled_window`` is a frozen copy of the port's
``chip_smoke.py::profiled_window``: the tracer is started in a discarded
warmup step of the profiler's schedule, and the window opens with 32 small
kernels and closes with three, each edge with a 20 ms pause, because on
some hosts the profiler drops a window's first few device events.  The
edges here are a small PyTorch op, not the port's empty CUDA kernel, so
the benchmark builds nothing.

``reduce`` reads, inside the benchmark's own ``perfbench.window`` span:
the device operations and the union of their intervals (busy time), the
device time under each named span (kernels launched by the span's
operations and their children, by the profiler's correlation of a kernel
with its launching operation), the device operations by name, and the
idle gaps by the innermost host operation running when each began.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import Dict, Iterable, List, Tuple

import torch

WINDOW = "perfbench.window"
EDGE_PAUSE_S = 0.02
OPEN_KERNELS = 32
TOP = 10
SCAN = 512          # host operations looked back at for a gap's label
_ANNOTATIONS = ("perfbench.", "ProfilerStep")


def _edge(dev: torch.device, n: int = 3) -> None:
    x = torch.zeros(1, device=dev)
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize(dev)
    time.sleep(EDGE_PAUSE_S)


@contextlib.contextmanager
def profiled_window(dev: torch.device):
    """A CPU and CUDA ``torch.profiler`` window whose tracer already runs
    when it opens; the caller marks its window with a ``WINDOW`` span."""
    from torch.profiler import ProfilerActivity, profile, schedule
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.start()
    try:
        _edge(dev)
        prof.step()
        _edge(dev, OPEN_KERNELS)
        yield prof
        torch.cuda.synchronize(dev)
        _edge(dev)
    finally:
        prof.stop()


def _union(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events, span_names: Iterable[str]) -> Dict:
    """The window's numbers from ``prof.events()`` (times in seconds).

    Returns ``window_s``, ``busy_s``, ``device_ops`` (count), ``spans``
    (name -> ``{"device_s", "calls"}``), ``top_ops`` and ``idle_gaps``
    (lists of ``[name, seconds]``, longest first)."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    wins = [e for e in cpu if e.name == WINDOW]
    if len(wins) != 1:
        raise RuntimeError(f"{len(wins)} {WINDOW} spans in the trace")
    w0, w1 = wins[0].time_range.start, wins[0].time_range.end
    # device operations; the GPU side of a ``record_function`` span is an
    # annotation over the kernels, not one of them
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith(_ANNOTATIONS)
           and e.time_range.end > w0 and e.time_range.start < w1]
    clipped = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
               for e in dev]
    busy = _union(clipped)
    busy_us = sum(b - a for a, b in busy)

    # a span holds the kernels its operations and their children launched
    # (the profiler's correlation), and not its own annotation's
    def under(e) -> float:
        own = sum(k.duration for k in e.kernels
                  if not k.name.startswith(_ANNOTATIONS))
        return own + sum(under(c) for c in e.cpu_children)

    spans = {}
    for name in span_names:
        hits = [e for e in cpu if e.name == name
                and w0 <= e.time_range.start < w1]
        spans[name] = {"device_s": sum(under(e) for e in hits) / 1e6,
                       "calls": len(hits)}

    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in dev:
        by_name[e.name[:120]] += (e.time_range.end - e.time_range.start)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    # each idle gap is labelled by the innermost host operation running
    # when it began
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu
                  if not e.name.startswith(_ANNOTATIONS))
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = collections.defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        i = bisect.bisect_right(starts, a) - 1
        label = "no host operation"
        for j in range(i, max(i - SCAN, -1), -1):
            if host[j][1] >= a:
                label = host[j][2]
                break
        gaps[label[:120]] += b - a
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "device_ops": len(dev), "spans": spans,
            "top_ops": [[k, v / 1e6] for k, v in top_ops],
            "idle_gaps": [[k, v / 1e6] for k, v in idle_gaps]}
