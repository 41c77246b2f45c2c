#!/usr/bin/env python3
"""Time an older build of the select kernels beside the current one.

    git show <commit>:src/repro_torch/kernels/csrc/availscan.cu \\
        > build/parent/availscan.cu
    python3 tools/select_before_after.py build/parent/availscan.cu

Builds the given ``availscan.cu`` (the two-launch design: a scan launch
writing one row per block to a ``partial`` buffer, then a one-block
reduction launch) with the same ``nvcc`` flags as the current library,
drives it through a copy of that design's wrapper (``partial`` and
``out`` allocated per call, ``torch.cuda.device`` entered on every
call), and times it in turns with the current wrappers on the same
inputs at the paper's shapes: ``availscan_select`` on 1024 PEs and
``availscan_select_mr`` on the session's (1024, 128, 64, 256) layout,
S = 128 records, candidates from ``candidate_starts``.  Order: parent,
current, current, parent, so a drift of the host or the card shows.
Each turn reports the per-call time (CUDA events over 200 back-to-back
calls, host-bound), the kernels' time on the card and the kernels per
call (``torch.profiler``); both versions must give the same rows.  The
last line is one JSON object with every turn.  Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def build_parent(source: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build
    out = build.BUILD_DIR / "parent" / "libavailscan_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {source}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.availscan_candidates_per_block.restype = i32
    lib.availscan_select.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
    lib.availscan_select.restype = i32
    lib.availscan_select_mr.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
    lib.availscan_select_mr.restype = i32
    return lib


def parent_wrappers(lib):
    """The two-launch design's wrappers, as they were."""
    import torch
    from repro_torch.kernels import availscan as K

    def select(times, occ, starts, t_du, t_now, n_req, policy_id, n_pe):
        S, W, P = K._check(times, occ, starts, n_pe, t_du, t_now)
        n_blocks = -(-P // lib.availscan_candidates_per_block())
        partial = torch.empty((n_blocks, 8), dtype=torch.int32,
                              device=times.device)
        out = torch.empty((8,), dtype=torch.int32, device=times.device)
        with torch.cuda.device(times.device):
            stream = torch.cuda.current_stream(times.device).cuda_stream
            rc = lib.availscan_select(
                times.data_ptr(), occ.data_ptr(), starts.data_ptr(),
                partial.data_ptr(), out.data_ptr(), S, W, P, t_du, t_now,
                n_req, policy_id, n_pe, stream)
        if rc:
            raise RuntimeError(f"parent availscan_select: CUDA error {rc}")
        return out

    def select_mr(times, occ, starts, valid, plane, tail, t_du, t_now,
                  n_req, policy_id, *, n_pe):
        n_planes = tail.shape[0] + 1
        S, W, P = K._check_mr(times, occ, starts, valid, plane, n_planes,
                              n_pe, t_du, t_now)
        n_blocks = -(-P // lib.availscan_candidates_per_block())
        partial = torch.empty((n_blocks, 8), dtype=torch.int32,
                              device=times.device)
        out = torch.empty((8,), dtype=torch.int32, device=times.device)
        with torch.cuda.device(times.device):
            stream = torch.cuda.current_stream(times.device).cuda_stream
            rc = lib.availscan_select_mr(
                times.data_ptr(), occ.data_ptr(), valid.data_ptr(),
                plane.data_ptr(), tail.data_ptr(), starts.data_ptr(),
                partial.data_ptr(), out.data_ptr(), S, W, n_planes, P, t_du,
                t_now, n_req, policy_id, stream)
        if rc:
            raise RuntimeError(f"parent availscan_select_mr: CUDA error {rc}")
        return out

    return select, select_mr


def main(argv=None) -> int:
    import torch
    import chip_smoke as C
    if len(sys.argv if argv is None else argv) < 2:
        raise SystemExit(__doc__)
    source = Path((sys.argv if argv is None else argv)[1])
    if not torch.cuda.is_available():
        print("select_before_after: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core import search as search_lib
    from repro_torch.core.resources import ResourceSpec, device_layout
    from repro_torch.core.timeline import Timeline
    from repro_torch.core.words import to_int32
    from repro_torch.kernels import availscan as K

    dev = torch.device("cuda")
    card = C.card_line()
    print(f"card: {card}")
    old_select, old_select_mr = parent_wrappers(build_parent(source))
    rng = np.random.default_rng(0)
    calls = {}
    for name, units in (("availscan_select", (1024,)),
                        ("availscan_select_mr", C.MR_UNITS)):
        spec = ResourceSpec(units)
        times_np, occ_np = C.random_timeline_mr(rng, spec, None, 128, 0.2)
        tl = Timeline(torch.from_numpy(times_np).to(dev),
                      torch.from_numpy(to_int32(occ_np)).to(dev))
        span = int(times_np[times_np < C.T_INF][-1])
        starts = search_lib.candidate_starts(tl, 0, 900, span + 3600)
        if spec.R == 1:
            args = (tl.times, tl.occ, starts, 900, 0, 256, 2, 1024)
            calls[name] = (lambda a=args: old_select(*a),
                           lambda a=args: K.availscan_select(*a))
        else:
            lay = device_layout(spec, dev)
            tail = torch.tensor([u // 4 for u in units[1:]],
                                dtype=torch.int32).to(dev)
            args = (tl.times, tl.occ, starts, lay.valid_mask,
                    lay.plane_of_word, tail, 900, 0, 256, 2)
            calls[name] = (lambda a=args: old_select_mr(*a, n_pe=1024),
                           lambda a=args: K.availscan_select_mr(*a,
                                                                n_pe=1024))
    turns = []
    for name, (parent, current) in calls.items():
        if not torch.equal(parent(), current()):
            raise SystemExit(f"{name}: parent and current rows differ")
        for label, fn in (("parent", parent), ("current", current),
                          ("current", current), ("parent", parent)):
            ms = C.cuda_time_ms(fn, reps=200)
            dev_ms, per_call, names = C.device_profile(fn, reps=200)
            turns.append(dict(kernel=name, version=label, per_call_ms=ms,
                              device_ms=dev_ms, kernels_per_call=per_call))
            print(f"{name} {label:8s} per call {ms * 1e3:7.2f} us, on the "
                  f"card {dev_ms * 1e3:6.2f} us, {per_call:.3f} kernels a "
                  f"call")
    print(json.dumps({"card": card, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
