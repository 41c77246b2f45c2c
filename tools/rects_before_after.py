#!/usr/bin/env python3
"""Time an older build of the rectangle kernels beside the current one.

    git show <commit>:src/repro_torch/kernels/csrc/availscan.cu \\
        > build/parent/availscan.cu
    python3 tools/rects_before_after.py build/parent/availscan.cu

Builds the given ``availscan.cu`` (the first design: ``availscan_rects``
and ``availscan_rects_mr`` take three output pointers, plus the tail on
``_mr``, and launch one warp a candidate) with the same ``nvcc`` flags as
the current library, drives it through a copy of that design's wrappers
and of its early reject (``search._rejected`` as it was: a one-element
starts tensor filled on the card, the kernel-backed rectangles with
their validity mask, zero tensors for ``found`` and the PE mask, the end
added on the card), and times it in turns with the current code on the
same inputs.  Order: parent, current, current, parent, so a drift of the
host or the card shows.

* P = 1 on the saturated stream's real timelines (``chip_smoke.py``'s
  ``saturated_jobs`` at 1024 PEs, capacity 256, index tile 32: the state
  after the 240 fills, the 480 probes' starts ``min(t_r, t_dl - t_du)``
  in turn; R = 1, and R = 4 on (1024, 128, 64, 256)).  The timeline was
  just written, as the early reject finds it (in L2).  Parent: its
  ``availscan`` on a one-candidate tensor; current: ``availscan_one``.
  Also split by probe: those whose nearest blocking records lie within
  eight records on both sides, and the rest (which the one-window
  kernel's far bands serve).
* P = 258 at the paper's shape (S = 128 records, fill 0.2, candidates
  from ``candidate_starts``; 1024 PEs, and the R = 4 layout).
* The early reject as the search runs it, per call.
* Whole probe steps of the saturated stream through a session (fresh
  for each turn; the parent turns run the parent's early reject): host
  wall time per step over the first 240 probes, device operations
  (kernels and copies, ``torch.profiler``) per step over the last 240 in
  windows of 60.

Each turn reports the per-call time (CUDA events over 200 back-to-back
calls, host-bound), the kernels' time on the card and the kernels per
call (``torch.profiler``); both versions must give identical outputs on
every input.  The last line is one JSON object with every turn.  Needs
one CUDA card.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

ORDER = ("parent", "current", "current", "parent")


def parent_code(lib):
    """The first design's rectangle wrappers and early reject, as they
    were."""
    import torch
    from repro_torch.core.resources import device_layout
    from repro_torch.core.search import Rectangles, SearchResult
    from repro_torch.core.types import T_INF
    from repro_torch.kernels import availscan as K

    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.availscan_rects.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.availscan_rects.restype = i32
    lib.availscan_rects_mr.argtypes = [ptr] * 9 + [i32] * 6 + [ptr]
    lib.availscan_rects_mr.restype = i32

    def rects(times, occ, starts, t_du, t_now, n_pe):
        S, W, P = K._check(times, occ, starts, n_pe, t_du, t_now)
        out = torch.empty((3, P), dtype=torch.int32, device=times.device)
        with K._on(times.device):
            stream = torch.cuda.current_stream(times.device).cuda_stream
            rc = lib.availscan_rects(
                times.data_ptr(), occ.data_ptr(), starts.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), S,
                W, P, t_du, t_now, n_pe, stream)
        if rc:
            raise RuntimeError(f"parent availscan: CUDA error {rc}")
        return out[0], out[1], out[2]

    def rects_mr(times, occ, starts, valid, plane, n_planes, t_du, t_now, *,
                 n_pe):
        S, W, P = K._check_mr(times, occ, starts, valid, plane, n_planes,
                              n_pe, t_du, t_now)
        out = torch.empty((3, P), dtype=torch.int32, device=times.device)
        tail = torch.empty((P, n_planes - 1), dtype=torch.int32,
                           device=times.device)
        with K._on(times.device):
            stream = torch.cuda.current_stream(times.device).cuda_stream
            rc = lib.availscan_rects_mr(
                times.data_ptr(), occ.data_ptr(), valid.data_ptr(),
                plane.data_ptr(), starts.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), out[2].data_ptr(), tail.data_ptr(), S, W,
                n_planes, P, t_du, t_now, stream)
        if rc:
            raise RuntimeError(f"parent availscan_mr: CUDA error {rc}")
        return out[0], tail, out[1], out[2]

    def rejected(tl, t_r, t_du, t_dl, t_now, n_pe, rspec, valid_mask):
        s0 = min(int(t_r), int(t_dl) - int(t_du))
        starts0 = torch.full((1,), s0, dtype=torch.int32, device=tl.device)
        tail = None
        if rspec is not None:
            lay = device_layout(rspec, tl.device)
            n_free, tail, t_begin, t_end = rects_mr(
                tl.times, tl.occ, starts0,
                lay.valid_mask if valid_mask is None else valid_mask,
                lay.plane_of_word, rspec.R, int(t_du), int(t_now),
                n_pe=rspec.n_pe)
        else:
            n_free, t_begin, t_end = rects(tl.times, tl.occ, starts0,
                                           int(t_du), int(t_now), n_pe)
        rects_ = Rectangles(starts=starts0, n_free=n_free, t_begin=t_begin,
                            t_end=t_end, valid=starts0 < T_INF,
                            n_free_tail=tail)
        return SearchResult(
            found=torch.zeros((), dtype=torch.bool, device=tl.device),
            t_s=starts0[0], t_e=starts0[0] + int(t_du),
            pe_mask=torch.zeros((tl.words,), dtype=torch.int32,
                                device=tl.device),
            n_free=rects_.n_free[0], t_begin=rects_.t_begin[0],
            t_end=rects_.t_end[0])

    return rects, rects_mr, rejected


def flat(x):
    import torch
    if isinstance(x, tuple):
        return torch.cat([t.reshape(-1) for t in x])
    return x


def turns(label, versions, turn_log, inputs=None):
    """Time ``versions[v]()`` in the order parent, current, current,
    parent; ``inputs`` (a count) makes each call take the next input in
    turn."""
    import chip_smoke as C
    def cycled(fn):
        it = itertools.cycle(range(inputs))
        return lambda: fn(next(it))

    for version in ORDER:
        call = cycled(versions[version]) if inputs else versions[version]
        ms = C.cuda_time_ms(call, reps=200)
        dev_ms, per_call, names = C.device_profile(call, reps=200)
        turn_log.append(dict(what=label, version=version, per_call_ms=ms,
                             device_ms=dev_ms, kernels_per_call=per_call,
                             kernels=names))
        print(f"{label:44s} {version:8s} per call {ms * 1e3:8.2f} us, on "
              f"the card {dev_ms * 1e3:7.3f} us, {per_call:.3f} kernels a "
              f"call", flush=True)


def saturated_state(dev, units):
    """A session of the saturated stream after its 240 fills, and the
    480 probes (stamped with the R = 4 demands on ``units``)."""
    import chip_smoke as C
    from repro_torch.api import ReservationService, ServiceConfig
    from repro_torch.core.types import Policy
    jobs = C.saturated_jobs()
    if units is not None:
        jobs = C.stamp(jobs, units)
    sess = ReservationService(ServiceConfig(
        n_pe=1024, policy=Policy.PE_W, capacity=256, chunk_size=None,
        index_tile=32, device=dev,
        **({} if units is None else dict(resources=units)))).session()
    sess.offer(jobs[:240])
    return sess, jobs[240:]


def probe_steps(dev, units, rejected_fn, turn_log, version):
    """One fresh saturated session: the fills, then the probes, with
    ``search._rejected`` set to ``rejected_fn``.  Host seconds per step
    over the first 240 probes (no profiler), device operations per step
    over the last 240 (profiler, windows of 60).  Returns the decisions."""
    import torch
    import chip_smoke as C
    from repro_torch.core import search as search_lib

    saved = search_lib._rejected
    search_lib._rejected = rejected_fn
    try:
        sess, probes = saturated_state(dev, units)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = [sess.offer(probes[:240])]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_ops = 0
        for lo in range(240, len(probes), 60):
            with C.profiled_window() as prof:
                res.append(sess.offer(probes[lo:lo + 60]))
            n_ops += sum(e.count for e in prof.key_averages()
                         if getattr(e, "self_device_time_total", 0) > 0
                         and "empty_kernel" not in e.key)
    finally:
        search_lib._rejected = saved
    rejects = sess.metrics()["early_rejects"]
    label = f"probe step, R = {1 if units is None else len(units)}"
    turn_log.append(dict(what=label, version=version,
                         host_ms_per_step=wall / 240 * 1e3,
                         device_ops_per_step=n_ops / 240,
                         early_rejects=rejects))
    print(f"{label:44s} {version:8s} host {wall / 240 * 1e3:.3f} ms/step "
          f"(240 probes, no profiler), {n_ops / 240:.2f} device operations "
          f"per step (240 probes), early rejects {rejects}/480", flush=True)
    return [tuple(x.tolist()) for r in res for x in r.decision]


def main(argv=None) -> int:
    import torch
    import chip_smoke as C
    from select_before_after import build_parent
    argv = sys.argv if argv is None else argv
    if len(argv) < 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        print("rects_before_after: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core import search as search_lib
    from repro_torch.core.resources import ResourceSpec, device_layout
    from repro_torch.core.timeline import Timeline
    from repro_torch.core.words import to_int32, to_uint32
    from repro_torch.kernels import availscan as K

    dev = torch.device("cuda")
    card = C.card_line()
    print(f"card: {card}")
    old_rects, old_rects_mr, old_rejected = parent_code(
        build_parent(Path(argv[1])))
    log = []

    # ---- P = 1 on the saturated timelines, and the early reject
    for units in (None, C.MR_UNITS):
        spec = ResourceSpec(units or (1024,))
        R = spec.R
        rspec = None if units is None else spec
        sess, probes = saturated_state(dev, units)
        tl = sess.engine.tl
        valid = sess.engine.state.lane_valid if units else None
        lay = device_layout(spec, dev)
        s0 = [min(j.t_r, j.t_dl - j.t_du) for j in probes]
        starts = torch.tensor(s0, dtype=torch.int32, device=dev)
        if units is None:
            def old(i):
                j = probes[i]
                return old_rects(tl.times, tl.occ, starts[i:i + 1], j.t_du,
                                 j.t_a, 1024)

            def new(i):
                j = probes[i]
                return K.availscan_one(tl.times, tl.occ, s0[i], j.t_du,
                                       j.t_a, 1024)
        else:
            def old(i):
                j = probes[i]
                return old_rects_mr(tl.times, tl.occ, starts[i:i + 1], valid,
                                    lay.plane_of_word, R, j.t_du, j.t_a,
                                    n_pe=1024)

            def new(i):
                j = probes[i]
                return K.availscan_one_mr(tl.times, tl.occ, s0[i], valid,
                                          lay.plane_of_word, R, j.t_du,
                                          j.t_a, n_pe=1024)

        def old_rej(i):
            j = probes[i]
            return old_rejected(tl, j.t_r, j.t_du, j.t_dl, j.t_a, 1024,
                                rspec, valid)

        def new_rej(i):
            j = probes[i]
            return search_lib._rejected(tl, j.t_r, j.t_du, j.t_dl, j.t_a,
                                        1024, rspec, valid)

        for i in range(len(probes)):
            o, n = old(i), new(i)
            # the parent's (n_free, [tail,] t_begin, t_end) in the row's
            # order: n_free, t_begin, t_end, tail
            o = torch.cat([o[0], o[-2], o[-1]] + ([o[1].reshape(-1)]
                                                   if R > 1 else []))
            if not torch.equal(o, n[:R + 2]):
                raise SystemExit(f"R = {R}: parent and current rectangles "
                                 f"differ at probe {i}")
            if not all(torch.equal(a, b)
                       for a, b in zip(old_rej(i), new_rej(i))):
                raise SystemExit(f"R = {R}: parent and current early "
                                 f"rejects differ at probe {i}")
        name = "availscan" if R == 1 else "availscan_mr"
        turns(f"{name} P = 1, 480 saturated probes",
              dict(parent=old, current=new), log, len(probes))
        # the probes whose nearest blocking records lie within the near
        # band on both sides, and the others
        times_np = tl.times.cpu().numpy()
        occ_np = to_uint32(tl.occ.cpu().numpy())
        vm = to_uint32(valid.cpu().numpy()) if units else None
        near = []
        for s, j in zip(s0, probes):
            _, per, _ = C._touched(
                times_np, occ_np, np.asarray([s], np.int32), j.t_du,
                (lambda b: ~b) if vm is None else (lambda b: ~b & vm))
            _, _, n_left, n_right = per[0]
            near.append(max(n_left, n_right) <= 8)
        print(f"{sum(near)} of {len(probes)} probes need only the near "
              f"band (at most 8 records scanned on each side)")
        for kind, pick in (("near", [i for i, x in enumerate(near) if x]),
                           ("far", [i for i, x in enumerate(near) if not x])):
            if pick:
                turns(f"{name} P = 1, {len(pick)} {kind}-band probes",
                      dict(parent=lambda k, p=pick: old(p[k]),
                           current=lambda k, p=pick: new(p[k])),
                      log, len(pick))
        turns(f"early reject R = {R} (search._rejected)",
              dict(parent=old_rej, current=new_rej), log, len(probes))

    # ---- P = 258 at the paper's shape
    rng = np.random.default_rng(0)
    for units in ((1024,), C.MR_UNITS):
        spec = ResourceSpec(units)
        times_np, occ_np = C.random_timeline_mr(rng, spec, None, 128, 0.2)
        tl = Timeline(torch.from_numpy(times_np).to(dev),
                      torch.from_numpy(to_int32(occ_np)).to(dev))
        span = int(times_np[times_np < C.T_INF][-1])
        starts = search_lib.candidate_starts(tl, 0, 900, span + 3600)
        lay = device_layout(spec, dev)
        if spec.R == 1:
            versions = dict(
                parent=lambda: old_rects(tl.times, tl.occ, starts, 900, 0,
                                         1024),
                current=lambda: K.availscan(tl.times, tl.occ, starts, 900, 0,
                                            1024))
            name = "availscan"
        else:
            args = (tl.times, tl.occ, starts, lay.valid_mask,
                    lay.plane_of_word, spec.R, 900, 0)
            versions = dict(
                parent=lambda a=args: old_rects_mr(*a, n_pe=1024),
                current=lambda a=args: K.availscan_mr(*a, n_pe=1024))
            name = "availscan_mr"
        if not torch.equal(flat(versions["parent"]()),
                           flat(versions["current"]())):
            raise SystemExit(f"{name}: parent and current differ at P = "
                             f"{starts.numel()}")
        turns(f"{name} P = {starts.numel()}, paper shape", versions, log)

    # ---- whole probe steps through a session
    for units in (None, C.MR_UNITS):
        first = None
        for version in ORDER:
            fn = old_rejected if version == "parent" else search_lib._rejected
            dec = probe_steps(dev, units, fn, log, version)
            first = dec if first is None else first
            if dec != first:
                raise SystemExit("probe steps decide differently across "
                                 "turns")
    print(json.dumps({"card": card, "turns": log}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
