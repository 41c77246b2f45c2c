#!/usr/bin/env python3
"""Where a kernel call's time goes on the card: per-block clock stamps.

    python3 tools/select_stamps.py

Builds an instrumented copy of ``src/repro_torch/kernels/csrc/
availscan.cu`` into ``build/`` (thread 0 of each block writes
``clock64()`` at named points of ``availscan_select_kernel`` and of
``availscan_one_kernel``, and ``%globaltimer`` at their entry and exit),
then:

* runs ``availscan_select`` 30 times at the paper's shape (S = 128,
  P = 258, 1024 PEs, the timeline ``chip_smoke.py`` times) and prints,
  for the first blocks of the last call, the cycles from the block's
  entry to each point;
* runs the one-window kernel (``availscan_one``, the early reject's
  rectangle) 30 times on the saturated stream's timeline (the state
  after its 240 fills, capacity 256, 1024 PEs) at a probe whose blocking
  records lie within the near band and at one with none on either side
  (the far bands), and prints the same for its one block.

The stamps perturb what they measure a little; read them as where the
cycles go, not as the kernel's time (``chip_smoke.py`` gives that).
The anchors are lines of the current source: the script fails if one
is missing.  Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SLOTS = 24
# (anchor in the source, stamp inserted before it, point's name)
POINTS = [
    ("  // Everything that needs no earlier read", 0, "entry"),
    ("  // the times staged and counted", 1, "issued"),
    ("  s_starts[tid] = s0;", 2, "times read"),
    ("  n_below = __reduce_add_sync(kFull, n_below);", 3, "starts read"),
    ("  int best[8];\n  sentinel_row(best);", 4, "first barrier"),
    ("      warp_candidates<NW, kMr, kRects>(g, s_times, s_occ", 5, "staged"),
    ("  // the block's row: fold the warps' rows in warp 0", 6, "scored"),
    ("  int row[8];\n  if (lane < kWarps)", 7, "fold barrier"),
    ("  if (gridDim.x == 1) {\n    if (lane == 0) write_row(out, row);", 8,
     "block row"),
    ("  ticket = __shfl_sync(kFull, ticket, 0);", 9, "ticket"),
]
END = ("    *reinterpret_cast<volatile int*>(counter) = 0;   "
       "// for the next call\n  }\n}")
# the one-window kernel's points, in slots of their own
ONE_POINTS = [
    ("  const int s = g.s;", 12, "entry"),
    ("  for (int w = tid; w < g.W; w += kThreads) s_busy[w] = 0u;", 13,
     "times read"),
    ("  na = nb = nl = 0;", 14, "round 1 barrier"),
    ("#pragma unroll\n  for (int j = 0; j < NW; ++j)\n"
     "    if (busy[j]) atomicOr(", 15, "window ORed"),
    ("  // the window's busy and free words, in every warp; the counts", 16,
     "fold barrier"),
    ("  // The far bands, only for a side whose near band holds no", 17,
     "near band tested"),
    ("  // t_begin: the end of the nearest blocking record on the left,", 18,
     "far bands done"),
]
ONE_END = "            kMr ? s_cnt : nullptr, tid);\n}"


def instrumented_source() -> str:
    src = (ROOT / "src/repro_torch/kernels/csrc/availscan.cu").read_text()
    head = (f"__device__ long long g_stamps[264][{SLOTS}];\n"
            "#define STAMP(k) do { if (threadIdx.x == 0) "
            "g_stamps[blockIdx.x][k] = clock64(); } while (0)\n"
            "#define GTIME(k) do { if (threadIdx.x == 0) { long long t; "
            "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
            "g_stamps[blockIdx.x][k] = t; } } while (0)\n")
    src = src.replace("namespace {\n", "namespace {\n" + head, 1)
    for anchor, k, _ in POINTS + ONE_POINTS:
        if anchor not in src:
            raise SystemExit(f"anchor missing from availscan.cu: {anchor!r}")
        extra = f"GTIME({SLOTS - 2}); " if k in (0, 12) else ""
        src = src.replace(anchor, f"  {extra}STAMP({k});\n" + anchor, 1)
    for end, k in ((END, 10), (ONE_END, 19)):
        if end not in src:
            raise SystemExit("end anchor missing from availscan.cu")
        src = src.replace(end, end[:-1] + f"  STAMP({k}); GTIME({SLOTS - 1});"
                          "\n}", 1)
    return src + ('\nextern "C" int stamps_read(void* dst) { return (int)'
                  'cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps)); }\n')


def main() -> int:
    import torch
    import chip_smoke as C
    from repro_torch.core import search as search_lib
    from repro_torch.core.timeline import Timeline
    from repro_torch.core.words import to_int32
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("select_stamps: no CUDA device available", file=sys.stderr)
        return 2
    out_dir = build.BUILD_DIR / "stamps"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "availscan_stamps.cu", out_dir / "libstamps.so"
    cu.write_text(instrumented_source())
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.availscan_select.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
    lib.availscan_one.argtypes = [ptr] * 2 + [i32, ptr] + [i32] * 5 + [ptr]
    lib.availscan_select_scratch_ints.restype = i32
    lib.stamps_read.argtypes = [ptr]
    dev = torch.device("cuda")
    print(f"card: {C.card_line()}")
    rng = np.random.default_rng(0)
    times_np, occ_np = C.random_timeline(rng, 1024, 128, 0.2)
    tl = Timeline(torch.from_numpy(times_np).to(dev),
                  torch.from_numpy(to_int32(occ_np)).to(dev))
    span = int(times_np[times_np < C.T_INF][-1])
    starts = search_lib.candidate_starts(tl, 0, 900, span + 3600)
    scratch = torch.zeros(lib.availscan_select_scratch_ints(),
                          dtype=torch.int32, device=dev)
    out = torch.empty(8, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(30):
        rc = lib.availscan_select(
            tl.times.data_ptr(), tl.occ.data_ptr(), starts.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), 128, 32, starts.numel(),
            900, 0, 256, 2, 1024, stream)
        if rc:
            raise SystemExit(f"launch failed: CUDA error {rc}")
        torch.cuda.synchronize()
    stamps = np.zeros((264, SLOTS), np.int64)
    lib.stamps_read(stamps.ctypes.data)
    names = {k: n for _, k, n in POINTS}
    names[10] = "end (last block)"
    print(f"P = {starts.numel()}, live candidates "
          f"{int((starts < C.T_INF).sum())}, live records "
          f"{int((times_np < C.T_INF).sum())}; cycles from each block's "
          f"entry (- where the block did not pass)")
    for b in range(5):
        print_row(f"block {b}", stamps[b], names, range(11))
    one_window(lib, dev, stamps)
    return 0


def print_row(label, row, names, slots) -> None:
    first, last = slots[0], slots[-1]
    cells = [f"{names[k]} {row[k] - row[first] if row[k] else '-'}"
             for k in slots]
    print(f"{label}: " + ", ".join(cells))
    if row[SLOTS - 1]:
        ns = row[SLOTS - 1] - row[SLOTS - 2]
        print(f"  entry to end {ns} ns, {row[last] - row[first]} cycles: "
              f"{(row[last] - row[first]) / ns:.3f} GHz")


def one_window(lib, dev, stamps) -> None:
    """The one-window kernel on the saturated timeline, at a near-band
    probe and a far-band one."""
    import torch
    import chip_smoke as C
    from repro_torch.api import ReservationService, ServiceConfig
    from repro_torch.core.types import Policy
    from repro_torch.core.words import to_uint32

    jobs = C.saturated_jobs()
    sess = ReservationService(ServiceConfig(
        n_pe=1024, policy=Policy.PE_W, capacity=256, chunk_size=None,
        index_tile=32, device=dev)).session()
    sess.offer(jobs[:240])
    tl = sess.engine.tl
    times_np = tl.times.cpu().numpy()
    occ_np = to_uint32(tl.occ.cpu().numpy())
    picks = {}
    for j in jobs[240:]:
        s0 = min(j.t_r, j.t_dl - j.t_du)
        _, per, _ = C._touched(times_np, occ_np, np.asarray([s0], np.int32),
                               j.t_du, lambda b: ~b)
        _, _, n_left, n_right = per[0]
        kind = "near" if max(n_left, n_right) <= 8 else "far"
        picks.setdefault(kind, (j, s0, per[0]))
    S, W = occ_np.shape
    out = torch.empty(6 + W, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    names = {k: n for _, k, n in ONE_POINTS}
    names[19] = "end"
    print(f"one-window kernel, saturated timeline: S = {S}, "
          f"{int((times_np < C.T_INF).sum())} live records")
    for kind, (j, s0, (n_win, _, n_left, n_right)) in sorted(picks.items()):
        for _ in range(30):
            rc = lib.availscan_one(tl.times.data_ptr(), tl.occ.data_ptr(),
                                   s0, out.data_ptr(), S, W, j.t_du, j.t_a,
                                   1024, stream)
            if rc:
                raise SystemExit(f"launch failed: CUDA error {rc}")
            torch.cuda.synchronize()
        lib.stamps_read(stamps.ctypes.data)
        print_row(f"{kind} probe ({n_win} window rows, {n_left} scanned "
                  f"left, {n_right} right)", stamps[0], names,
                  list(range(12, 20)))


if __name__ == "__main__":
    sys.exit(main())
