#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--n-jobs 1000] [--n-event-loop 300]
                          [--n-session 1000] [--placement-cards]
                          [--phases main,index,...,train,dryrun,service]

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and then:

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, the kernel build time and each kernel's ``-Xptxas
   -v`` report (registers, shared memory, spills);
2. kernel phase: holds ``availscan`` and ``availscan_select`` against
   their plain PyTorch versions on the card, exact equality on every
   output, over random timelines (n_pe in {1024, 1000, 2048, 64},
   capacity in {128, 1024, 4096}, all seven policies) and the edge
   cases (empty timeline, dead candidates, an infeasible request, a
   window at the horizon, no blocking record in 2,000), on both of the
   select kernel's branches
   (live records in shared memory, and over its budget in global
   memory); ``availscan`` in both modes on each input (all candidates,
   and at P = 1 on the first, middle and last start: the rectangle mode
   on a one-candidate tensor, the one-window kernel through
   ``availscan_one``);
   times both at the paper's shape, fails unless each call is one
   kernel on the card (profiler), and times an empty kernel of the same
   library at the launch shape (the launch floor);
3. main path: ``simulate_batched`` on the paper stream (1024 PEs,
   ``WorkloadParams(n_jobs=1000, seed=0)``, PE_W; the paper's 10,000
   jobs with ``--n-jobs 10000``, cut by default to keep the run short)
   on the card, its
   decisions, slowdowns and busy area held against the host event loop;
   then the per-operation event loop ``simulate(engine="device")`` on
   the stream's first jobs, held against the host loop; then the
   kernel-backed rectangle query ``ops.availability_rectangles`` over
   probe requests on the admitted timeline.  Launch counts are reset
   before each path and read after it;
4. paper claims: all seven policies on ``WorkloadParams(n_jobs=1000,
   seed=11)`` (the reference's test uses 1500; cut for time): PE_W's
   acceptance within 0.01 of the best, FF the lowest slowdown;
5. multi-resource kernel phase (after phase 2): holds ``availscan_mr``
   (both modes, as in phase 2) and ``availscan_select_mr`` against
   their plain versions, exact, on
   the layouts (1024,), (1024,) with 1000 live PEs, (64, 8, 4, 16),
   (1024, 128, 64, 256) and (2048, 14336) (512 words) at capacities
   128, 1024 and 4096, all seven policies, demand tails of zero, half
   and full, and the edge cases (plus a request only a secondary plane
   refuses), on both select branches; times both at the session's
   shape, one kernel a call, and the launch floor;
5b. select seams (after phase 5): both select kernels against their
   plain versions on the inputs of ``repro_torch.kernels.cases`` (ties
   across blocks with the winner in the last block or an earlier one,
   nothing feasible with the first live candidate in the last block,
   random starts with holes) at candidate counts k x 8 - 1, k x 8 and
   k x 8 + 1 for k in {1, 2, 33, 264, 265} (8 candidates a block, at
   most 264 blocks), on 32, 64, 46 and 512 words; then 1,000 calls of
   each with random P in [1, 3000) queued back to back and checked
   after one sync;
5c. pruned starts (after phase 5b): all four kernels against their plain
   versions on the candidate arrays of ``cases.pruned_cases`` (dead
   holes mid-array, index 0 live then dead to past the first
   128-candidate tile, only index 0 live, P = 1), the rectangle kernels
   in both modes, at 1024 PEs and the R = 4 layout; with nothing
   feasible every select must name index 0;
3b. the availability index (after phase 3): ``simulate_batched(...,
   index_tile=16, cross_check=True)`` on the main path's jobs, decisions
   held against the host loop and the main path's index-free run, one
   ``availscan`` launch per early reject and one ``availscan_select``
   per full search, the early-reject and pruned shares printed; then
   the reference's saturated stream (``benchmarks/bench_index.py``)
   scaled to 1024 PEs at capacity 256 with tile 32 and without the
   index: every Decision field equal, at least 90 % of the 480 probes
   early-rejected, each one one-window ``availscan`` kernel on the card
   (profiler), device operations per probe step; then the same stream
   stamped with the R = 4 demands against ``MultiResourceOracle``, one
   one-window ``availscan_mr`` kernel per early reject; on each
   stream's timeline the early reject's kernel at P = 1 is held against
   its plain version at all 480 probe starts and timed (per call, on the
   card, launch floor at one block, bound, resources), and so is the
   whole early reject (``search._rejected``, one kernel a call);
6. multi-resource session: ``ReservationService(ServiceConfig(n_pe=1024,
   resources=(1024, 128, 64, 256), policy=PE_W, use_kernel=True,
   chunk_size=64, ring_capacity=256))`` on 1,000 jobs of the paper stream
   (``--n-session 10000`` for the 10,000 of the paper; cut for the run's
   time)
   stamped with half-intensity secondary demands, offered in pieces of
   100 and flushed; decisions and records held against the port's
   ``MultiResourceOracle``; one ``availscan_select_mr`` launch per admit
   step; then a profiled window of the session, one-shot sessions for
   all seven policies (150 jobs each), a heterogeneous lane
   (``machine_sizes=(1000,)``, 1,000 jobs), the per-operation event loop
   and the kernel-backed rectangle query,
   each held against the oracle or the plain version.  The session runs
   the pipelined offer (``donate=True``, the default);
7. service (after phase 6): the eager offer (``donate=False``) and the
   pipelined one on the session's stamped jobs against the oracle
   (host syncs per request side by side); a session from
   capacity 16 that grows mid-stream on both offers, against the
   oracle, each other, and the same session's counters on the CPU;
   ``cancel``, ``cancel_many`` with a repeat, ``snapshot``/``restore``
   and ``tick`` on 300 paper jobs against ``BackfillOracle`` (mode
   none); ``engine="host"`` (500 jobs) and ``engine="list"`` (200 jobs)
   sessions against the device session;
6b. backfilling (after phase 6): ``none``, conservative and EASY on the
   paper stream's first 400 jobs against ``BackfillOracle``, an EASY
   session cancelling its queue's tail (8 offers of 50), EASY at R = 4
   and with the index, 300 EASY steps profiled;
6c. tenancy (after phase 6b): the same 400 jobs with ``tenant = i % 4``,
   quotas of half of tenants 0 and 2's offered PE-seconds, a live cap of
   6 on tenant 1 and weights (1, 4, 2, 1) under EASY against
   ``TenantOracle`` (decisions, records, queue and every telemetry field
   bit for bit; both gates must bite); a neutral table (equal weights,
   no limits) identical to the tenancy-free EASY, ``none``, R = 4 and
   tile-16 runs, host syncs included; a pipelined ``auto_release=False``
   session that reaps (grace 300) after each of 8 offers against the
   oracle, then 20 idle ``metrics(tenant=i)`` polls that read nothing;
   300 EASY steps profiled with tenants off and on;
6d. ensemble (after phase 6c): ``simulate_grid`` at 1024 PEs with the
   paper's ``WorkloadParams``, every cell held against its host oracle:
   ``grid_paper`` (7 policies x arrival factors 0.75 / 1.0 / 1.25, seed
   0, flexibility 3, 300 jobs a cell; the paper's claims on it; then 3
   of its cells profiled: kernels and host syncs per lane step),
   ``grid_backfill`` (PE_W, DU_B, FF x none / easy / conservative, 200
   jobs, a queue of 8; conservative decides as none), ``grid_mixes`` (a
   tenant-mix axis with the skewed 4-tenant spec against
   ``TenantOracle``, a resource-mix axis on (1024, 128, 64, 256) against
   ``MultiResourceOracle``); then ``ensemble_session``: a pipelined
   ``lanes=3`` session with machine sizes 1024 / 768 / 512 and policies
   PE_W / FF / DU_B, each lane held against a one-lane session, a
   ``tick``, a ``cancel`` on lane 1 and a snapshot / restore / re-offer;
   and a ``lanes=2`` session with ``tenants=(spec, None)`` and
   ``auto_release=False`` that reaps on the spec's lane only.  Each
   path's select launches equal its lane steps' searches;
6e. fleet (after phase 6d): ``fleet_routing``: 300 paper jobs (the
   reference's gate runs 1,000; cut for the run's time) through
   ``PartitionedCore`` at 1024 PEs in 4 partitions of 256 (capacity 128,
   PE_W) under round robin, least loaded, best acceptance (fused; the
   rounds protocol under PE_W and FF; tile 32), each held against the
   port's ``FleetRoutingOracle`` (allocations, merged records);
   ``partition_sessions``: an EASY round-robin partitioned session (20
   offers of 50, a tick after each, a cancel, a snapshot / restore /
   re-offer) with every lane held against a ``BackfillOracle`` fed its
   routed requests, and a tenanted best-acceptance session
   (``auto_release=False``, grace 300) against a host replay of the
   router's gate on ``HostTenantAccounts`` plus ``FleetRoutingOracle``;
   ``fleet_jobs``: ``FleetScheduler(n_chips=512)`` through a scripted day
   (8 batches of 25 jobs over the ten architectures, 3 card failures, 3
   stragglers, 2 rescales, 5 malleable jobs) on the device engine against
   the host engine, then partitioned in two with every batch held
   against ``FleetRoutingOracle``.  Select launches equal the searches
   (admit steps plus probes), one-window launches the early rejects;
6f. placement (after phase 6e): a 4-lane ``simulate_grid`` (PE_W, FF x
   none / EASY, 200 jobs at 1024 PEs) and a partitioned session (4
   partitions, least loaded, 8 offers of 50) under
   ``placement="auto"``, each equal to ``placement=None`` (decisions,
   records, accepted counts, partition loads), select launches counted
   per run, ``placement_shards`` the lane mesh's;
6g. serving (after phase 6f): the reduced float32 configs of every
   served family on the card against the same port on the CPU with the
   same weights (prefill + 6 decode steps, logits within 1e-4, greedy
   tokens equal, TF32 off); then qwen3-4b (4.41 G parameters) and
   granite-moe-1b-a400m (1.38 G) at full width, bfloat16, random
   weights from ``--seed``: greedy generation of 32 tokens for 4
   prompts of 64 through ``repro_torch.serve.engine`` with the bf16 and
   the int8 KV cache, after a warm-up, with prefill ms, decode ms a step
   and tokens/s, each decode position's logits held against one full
   forward over prompt + generated tokens (within 0.12, int8 0.25; the
   token the forward's top-1 wherever its top-two margin exceeds the
   tolerance; MoE at ``capacity_factor=100`` for the check, positions
   whose tokens took other experts in the two paths counted and left
   out), 8 decode steps profiled (kernels a step, device time, idle
   share), the step's bound (every weight but the embedding table and
   the KV cache, over 3.35 TB/s) beside ``roofline.analysis.step_costs``
   for the same shape, and the peak memory.  Then
   zamba2-7b (hybrid: Mamba2 and a shared attention block) and
   xlstm-1.3b (ssm: mLSTM and sLSTM) at full width and depth, bf16 KV
   only, their bound counting the recurrent states read and written,
   and their reduced float32 configs in the card-against-CPU check;
   then seamless-m4t-medium (encdec: a 12-layer encoder over 1,536 stub
   audio frames, 12 decoder layers each with a cross block; 1.13 G)
   and llama-3.2-vision-11b (vlm: 40 layers, a gated cross block over
   1,601 stub image tokens after every fifth; 11.52 G) as the dense
   families, bf16 and int8 KV, frontend inputs from the seed, the vlm
   gates set nonzero from it (at their initial zero the image would
   change nothing), their bound counting the cross K / V and leaving
   out the weights only the prefill reads, the largest logit change the
   cross path makes printed (gates set against zero; a second draw of
   audio frames), and their reduced float32 configs in the
   card-against-CPU check.
   The serving path runs none of the CUDA kernels (its work is
   PyTorch's matmuls and elementwise operations);
6h. training (after 6g): one microbatched train step of each
   family's reduced float32 config (stablelm, granite-moe at
   ``capacity_factor=100``, zamba2, xlstm, seamless, llama-vision with
   their frontend inputs) on the card against the same
   step on the CPU (loss, grad norm and every parameter within 1e-4,
   TF32 off); then stablelm-1.6b at full width and depth (1.64 G
   parameters, bf16, float32 Adam moments) through
   ``repro_torch.launch.train.run``: 8 steps of 8 x 256 tokens in 2
   microbatches with the loss falling, checkpoints at steps 4 and 8 in
   a temporary directory, the step-8 checkpoint restored and held
   bit-equal against the live state, the step-8 checkpoint dropped and
   the run resumed from step 4 with its losses within 1e-3 of the
   straight run's, and the peak memory (the train step's speed is the
   benchmark's, ``perfbench/``).  It runs none of the CUDA kernels;
6i. dry-run (after 6h): ``repro_torch.launch.dryrun``'s 80 cells on the
   host CPU (no JAX): 64 ok, 16 skipped (the ``long_500k`` cells of the
   full-attention archs), none failed, each decode cell's step run on
   the ``meta`` device at full size, every decode cell memory-bound and
   every serve cell within 80 GB a card.

``--placement-cards`` builds the kernels and runs only
:func:`placement_cards`, which holds lane placement over every local
card against one card.  ``--phases`` runs only the named phase groups
(``main``, ``index``, ``claims``, ``session``, ``backfill``, ``tenancy``,
``ensemble``, ``fleet``, ``placement``, ``serve``, ``train``,
``dryrun``, ``service``; each with the groups whose results it needs) after the
build and the kernel phases; an unknown name exits non-zero before any
work.  With no flag every group runs.

The line before the last is one JSON object with every kernel's
launches, error, times and bound; the last line is the run's verdict.
Any failure raises and exits non-zero.  Without a CUDA device, or
without the repository's ``src/`` beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

T_INF = 2**31 - 1
# H100 SXM peaks.  HBM bandwidth: NVIDIA's data sheet.  int32 ALU rate:
# 64 INT32 lanes per SM (NVIDIA H100 Tensor Core GPU Architecture
# whitepaper) x 132 SMs x the 1.98 GHz clock implied by the data
# sheet's 67 TFLOP/s float32 (132 SMs x 128 lanes x 2 per FMA).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
PAPER_SHAPE = dict(n_pe=1024, capacity=128)
# the multi-resource machine: LANL-CM5's 1024 PEs plus the repo's R = 4
# pools (benchmarks/bench_multires.py, R4_TAIL at 64 PEs) scaled with it
MR_UNITS = (1024, 128, 64, 256)
MR_LAYOUTS = (((1024,), None), ((1024,), (1000,)), ((64, 8, 4, 16), None),
              (MR_UNITS, None), ((2048, 14336), None))
MR_CAPACITIES = (128, 1024, 4096)
# back-to-back calls of each select kernel, each with another P
N_REPEAT = 1000


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# random canonical timelines (numpy, from the seed)
# ---------------------------------------------------------------------------


def random_timeline(rng, n_pe: int, capacity: int, fill: float):
    """:func:`repro_torch.kernels.cases.random_timeline` on one plane of
    ``n_pe`` units."""
    from repro_torch.core.resources import ResourceSpec
    return random_timeline_mr(rng, ResourceSpec((n_pe,)), None, capacity,
                              fill)


def random_timeline_mr(rng, spec, live, capacity: int, fill: float):
    from repro_torch.kernels import cases
    return cases.random_timeline(rng, spec, live, capacity, fill)


def _touched(times, occ, starts, t_du, free_of):
    """The occupancy words the rectangles of these starts need, counted
    once each, and per live candidate ``(window rows, free words, rows
    scanned left, rows scanned right)``: every word of the overlapping
    records [lo, hi), and of the records the outward scans test up to
    the first blocking one on each side only the words that hold free
    units (``free_of(busy)`` gives the free words): a record can block
    only there."""
    W = occ.shape[1]
    t64 = times.astype(np.int64)
    n_valid = int((times < T_INF).sum())
    need = np.zeros(occ.shape, bool)
    per = []
    for s in starts[starts < T_INF].astype(np.int64):
        a = min(int(s), T_INF - t_du)
        b = a + t_du
        # overlapping records [lo, hi), as the kernels find them
        lo = max(int(np.searchsorted(t64, a, side="right")) - 1, 0)
        hi = int(np.searchsorted(t64, b, side="left"))
        busy = np.bitwise_or.reduce(occ[lo:hi], axis=0) if hi > lo \
            else np.zeros(W, np.uint32)
        free = free_of(busy)
        nz = free != 0
        blocking = ((occ[:n_valid] & free) != 0).any(axis=1)
        left = np.nonzero(blocking[:lo])[0]
        right = np.nonzero(blocking[hi:])[0]
        k_left = int(left[-1]) if left.size else 0
        k_right = hi + int(right[0]) + 1 if right.size else n_valid
        need[lo:hi] = True
        need[k_left:lo] |= nz
        need[hi:k_right] |= nz
        per.append((hi - lo, int(nz.sum()), lo - k_left,
                    max(k_right - hi, 0)))
    return int(need.sum()), per, n_valid


def scan_work(times, occ, starts, t_du) -> tuple:
    """(bytes, word ops) this input needs.

    Bytes: what the scan reads, once each: the occupancy words the
    candidates' windows and outward scans need (:func:`_touched`), the
    live times and the padding sentinel that stops the right scan, every
    candidate start.  Word ops: the OR over each live window's records,
    its popcount, and the AND tests of the outward scans on the free
    words up to the first blocking record.
    """
    W = occ.shape[1]
    n_need, per, n_valid = _touched(times, occ, starts, t_du, lambda b: ~b)
    ops = sum(W * (n_win + 1) + 2 * n_free * (n_l + n_r)
              for n_win, n_free, n_l, n_r in per)
    n_bytes = 4 * (n_need + min(n_valid + 1, times.size) + starts.size)
    return n_bytes, ops


def scan_work_mr(times, occ, starts, t_du, valid, n_planes) -> tuple:
    """(bytes, word ops) a multi-resource scan of this input needs.

    As :func:`scan_work`, with the free words ``~busy & valid``; bytes
    add the valid mask, the per-word plane ids and the demand tail;
    operations add the AND with the valid mask, the popcount, the
    per-plane add of every word and the demand compares.
    """
    W = occ.shape[1]
    n_need, per, n_valid = _touched(times, occ, starts, t_du,
                                    lambda b: ~b & valid)
    ops = sum(W * (n_win + 3) + 2 * n_free * (n_l + n_r) + n_planes - 1
              for n_win, n_free, n_l, n_r in per)
    n_bytes = 4 * (n_need + min(n_valid + 1, times.size)
                   + starts.size + 2 * W + n_planes - 1)
    return n_bytes, ops


def stamp(jobs, units):
    """Half-intensity secondary demands, scaled by the job's PE share
    (the rule of benchmarks/bench_multires.py::_stamp)."""
    n_pe = units[0]
    return [dataclasses.replace(j, demand=(j.n_pe,) + tuple(
        min(u, max(0, int(round(0.5 * u * (j.n_pe / n_pe)))))
        for u in units[1:])) for j in jobs]


def bound_row(n_bytes: int, ops: int) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=n_bytes, word_ops=ops)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def cuda_time_ms(fn, reps: int, rounds: int = 7) -> float:
    """Median over rounds of the mean per-call time (CUDA events)."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        per_call.append(start.elapsed_time(stop) / reps)
    return float(np.median(per_call))


# Under the profiler the first few device events of a window can go
# missing: on some hosts its first 3-7, whatever the time since the
# window opened (the kernels under test when they came first, else
# empty kernels launched ahead of them), none on others.  So a counted
# window starts the tracer in a discarded warmup step of the profiler's
# schedule, opens with a burst of empty kernels of the library (not
# counted) that takes that loss, and closes with three more and a pause.
PROFILE_OPEN_KERNELS = 32
PROFILE_EDGE_S = 0.02


def profile_edge(n_kernels: int = 3) -> None:
    """``n_kernels`` empty kernels, a sync and a pause: the edge of a
    profiled window."""
    import torch
    from repro_torch.kernels import build
    lib = build.load()
    for _ in range(n_kernels):
        lib.availscan_empty(1, 32, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    time.sleep(PROFILE_EDGE_S)


@contextlib.contextmanager
def profiled_window():
    """A ``torch.profiler`` window over the card whose tracer already
    runs when it opens (a discarded warmup step first), opened by
    ``PROFILE_OPEN_KERNELS`` empty kernels and closed by three."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    prof = profile(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.start()
    try:
        profile_edge()
        prof.step()
        profile_edge(PROFILE_OPEN_KERNELS)
        yield prof
        torch.cuda.synchronize()
        profile_edge()
    finally:
        prof.stop()


def profiled_events(prof) -> list:
    """The device operations a :func:`profiled_window` saw, its own empty
    kernels left out."""
    return [e for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0
            and "empty_kernel" not in e.key]


def device_profile(fn, reps: int = 50):
    """``(ms, kernels, names)``: kernel time on the card per call (the
    sum of every kernel's self device time, None if the profiler saw
    none), the kernels the card ran per call, and their names, over one
    :func:`profiled_window`."""
    import torch
    fn()
    torch.cuda.synchronize()
    with profiled_window() as prof:
        for _ in range(reps):
            fn()
    events = profiled_events(prof)
    total_us = sum(e.self_device_time_total for e in events)
    return (total_us / reps / 1e3 if total_us > 0 else None,
            sum(e.count for e in events) / reps, sorted(e.key for e in events))


def device_ms(fn, reps: int = 50):
    return device_profile(fn, reps)[0]


def one_kernel_per_call(name: str, fn, reps: int = 200):
    """Fail unless every call of ``fn`` ran exactly one kernel on the
    card; ``(device ms, kernel name)``."""
    ms, per_call, names = device_profile(fn, reps)
    if per_call != 1.0 or len(names) != 1:
        fail(f"{name}: {per_call} kernels per call on the card ({names})")
    return ms, names[0]


def _us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


def smem_branch(times_np, W: int) -> str:
    """Which branch the select kernels take on this timeline: "shared"
    if the live records fit the shared-memory budget, else "global"."""
    from repro_torch.kernels import build
    n_live = int((times_np < T_INF).sum())
    cap = build.load().availscan_smem_rows(times_np.shape[0], W)
    return "shared" if n_live <= cap else "global"


def ptxas_report(log: str) -> dict:
    """Each kernel's ``-Xptxas -v`` report: mangled name -> registers,
    static shared-memory bytes, spill bytes and the report's lines."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = dict(lines=[line.strip()])
            continue
        if name is None:
            continue
        out[name]["lines"].append(line.strip())
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_static"] = int(m.group(1)) if m else 0
    return out


# each kernel's variant at the paper's shapes: R = 1 on 32 words (one
# word a lane), the session's multi-resource layout on 46 (two).  The
# many-candidate mode is the select body, in rectangle mode (kRects) for
# the rectangle kernels; their one-window mode (the early reject's entry)
# is its own kernel.
VARIANTS = {"availscan_select": "availscan_select_kernelILi1ELb0ELb0E",
            "availscan_select_mr": "availscan_select_kernelILi2ELb1ELb0E",
            "availscan": "availscan_select_kernelILi1ELb0ELb1E",
            "availscan_mr": "availscan_select_kernelILi2ELb1ELb1E"}
ONE_VARIANTS = {"availscan": "availscan_one_kernelILi1ELb0E",
                "availscan_mr": "availscan_one_kernelILi2ELb1E"}


def _report_of(report: dict, variant: str) -> dict:
    hit = [v for k, v in report.items() if variant in k]
    if not hit:
        fail(f"no ptxas report for {variant}")
    return hit[0]


def select_resources(report: dict, name: str, S: int, W: int) -> dict:
    """Registers, shared memory and spills of the many-candidate body's
    variant for ``name`` at S x W, from the ptxas report."""
    from repro_torch.kernels import build
    hit = _report_of(report, VARIANTS[name])
    rows = build.load().availscan_smem_rows(S, W)
    return dict(registers=hit.get("registers"),
                smem_static_bytes=hit.get("smem_static"),
                smem_dynamic_bytes=(rows * (W + 1) + 1) * 4,
                spill_bytes=hit.get("spill_bytes"))


def one_resources(report: dict, name: str) -> dict:
    """The same for the one-window kernel of ``name`` (no dynamic shared
    memory)."""
    hit = _report_of(report, ONE_VARIANTS[name])
    return dict(registers=hit.get("registers"),
                smem_static_bytes=hit.get("smem_static"),
                smem_dynamic_bytes=0, spill_bytes=hit.get("spill_bytes"))


def _flat(x):
    import torch
    if isinstance(x, tuple):
        return torch.cat([t.reshape(-1) for t in x])
    return x


def check_windows(label: str, starts, rects, rects_ref, one, one_ref) -> None:
    """A rectangle kernel at P = 1 against its plain version, exact, on
    the first, middle and last candidates of ``starts``: the rectangle
    mode on a one-candidate starts tensor (``rects``), and the one-window
    mode through the early reject's entry with the start as a host
    integer (``one``)."""
    import torch
    P = starts.shape[0]
    for i in sorted({0, P // 2, P - 1}):
        st = starts[i:i + 1]
        s = int(st[0])
        for mode, g, w in (("P = 1", rects(st), rects_ref(st)),
                           ("one", one(s), one_ref(s))):
            if not torch.equal(_flat(g), _flat(w)):
                fail(f"{label}: P = 1 ({mode}) differs at start "
                     f"{s}: {_flat(g).tolist()[:8]} vs "
                     f"{_flat(w).tolist()[:8]}")


def launch_floor(P: int) -> dict:
    """An empty kernel of the same library at the select kernels' launch
    shape for ``P`` candidates: per call (CUDA events) and on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    lib = build.load()
    per_block = lib.availscan_candidates_per_block()
    blocks = min(-(-P // per_block), lib.availscan_select_max_blocks())
    threads = 32 * per_block

    def call():
        lib.availscan_empty(blocks, threads,
                            torch.cuda.current_stream().cuda_stream)

    ms = cuda_time_ms(call, reps=200)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(203):
            call()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "empty_kernel" in e.key]
    # the mean over the launches the profiler saw
    dev_ms = (sum(e.self_device_time_total for e in ev)
              / max(1, sum(e.count for e in ev)) / 1e3) if ev else None
    return dict(launch_floor_ms=ms, launch_floor_device_ms=dev_ms,
                grid=blocks, block_threads=threads)


DESIGNS = {
    "availscan_select": "one launch, shared-memory staging",
    "availscan_select_mr": "one launch, shared-memory staging",
    "availscan": "starts tensor: the select body in rectangle mode; "
                 "early reject: one block on one window",
    "availscan_mr": "starts tensor: the select body in rectangle mode; "
                    "early reject: one block on one window"}


def kernel_phase(rng, dev, report: dict) -> dict:
    import torch
    from repro_torch.core import search as search_lib
    from repro_torch.core.resources import ResourceSpec
    from repro_torch.core.timeline import Timeline
    from repro_torch.core.words import to_int32
    from repro_torch.kernels import availscan as K
    from repro_torch.kernels import cases
    from repro_torch.kernels import ref as R

    n_checked = 0
    branches = {"shared": 0, "global": 0}

    def check_case(times_np, occ_np, starts, t_du, t_now, n_pe, n_req,
                   policies, label):
        nonlocal n_checked
        branches[smem_branch(times_np, occ_np.shape[1])] += 1
        times = torch.from_numpy(times_np).to(dev)
        occ = torch.from_numpy(to_int32(occ_np)).to(dev)
        if not isinstance(starts, torch.Tensor):
            starts = torch.from_numpy(np.asarray(starts, np.int32)).to(dev)
        got = K.availscan(times, occ, starts, t_du, t_now, n_pe)
        want = R.availscan_ref(times, occ, starts, t_du, t_now, n_pe)
        for name, g, w in zip(("n_free", "t_begin", "t_end"), got, want):
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:5, 0].tolist()
                fail(f"availscan {name} differs ({label}) at {bad}: "
                     f"{g[bad].tolist()} vs {w[bad].tolist()}")
        check_windows(
            f"availscan {label}", starts,
            lambda st: K.availscan(times, occ, st, t_du, t_now, n_pe),
            lambda st: R.availscan_ref(times, occ, st, t_du, t_now, n_pe),
            lambda x: K.availscan_one(times, occ, x, t_du, t_now, n_pe),
            lambda x: R.availscan_one_ref(times, occ, x, t_du, t_now, n_pe))
        for pid in policies:
            g = K.availscan_select(times, occ, starts, t_du, t_now, n_req,
                                   pid, n_pe)
            w = R.availscan_select_ref(times, occ, starts, t_du, t_now,
                                       n_req, pid, n_pe)
            if not torch.equal(g, w):
                fail(f"availscan_select differs ({label}, policy {pid}): "
                     f"{g.tolist()} vs {w.tolist()}")
        n_checked += 1

    all_pol = range(7)
    for n_pe in (1024, 1000, 2048, 64):
        for cap in (128, 1024, 4096):
            times_np, occ_np = random_timeline(rng, n_pe, cap, 0.9)
            span = int(times_np[times_np < T_INF][-1])
            t_r = int(rng.integers(0, max(1, span // 2)))
            t_du = int(rng.integers(1, 400))
            t_dl = t_r + t_du + int(rng.integers(0, span))
            tl = Timeline(torch.from_numpy(times_np).to(dev),
                          torch.from_numpy(to_int32(occ_np)).to(dev))
            starts = search_lib.candidate_starts(tl, t_r, t_du, t_dl)
            n_req = int(rng.integers(1, n_pe + 1))
            check_case(times_np, occ_np, starts, t_du, t_r, n_pe, n_req,
                       all_pol, f"n_pe={n_pe} S={cap}")
            # the same timeline, every candidate slot a random start,
            # with random dead holes (no compaction)
            rand = rng.integers(0, span + 1, 2 * cap + 2).astype(np.int32)
            rand[rng.random(rand.shape[0]) < 0.3] = T_INF
            check_case(times_np, occ_np, rand, t_du, 0, n_pe,
                       n_pe // 3, all_pol, f"random starts S={cap}")
        # edge cases at this n_pe
        W = (n_pe + 31) // 32
        empty_t = np.full(128, T_INF, np.int32)
        empty_o = np.zeros((128, W), np.uint32)
        check_case(empty_t, empty_o, [5, 9, T_INF, T_INF], 7, 0, n_pe,
                   n_pe, all_pol, "empty timeline")
        times_np, occ_np = random_timeline(rng, n_pe, 1024, 0.9)
        dead = np.full(2050, T_INF, np.int32)
        check_case(times_np, occ_np, dead, 5, 0, n_pe, 1, all_pol,
                   "all candidates dead")
        dead[1] = 17          # one live candidate, not at index 0
        check_case(times_np, occ_np, dead, 5, 0, n_pe, 1, all_pol,
                   "dead tiles around one live candidate")
        live = times_np[times_np < T_INF]
        check_case(times_np, occ_np, np.sort(live[:200]), 50, 0, n_pe,
                   n_pe + 1, all_pol, "infeasible request")
        check_case(times_np, occ_np,
                   [int(live[-1]), T_INF - 10, T_INF - 1, T_INF - 3000],
                   5000, 0, n_pe, 1, all_pol, "window at the horizon")
        far_t, far_o = cases.no_blocking_timeline(ResourceSpec((n_pe,)),
                                                  4096, 2000)
        check_case(far_t, far_o, [int(far_t[1000]), 7, int(far_t[10]), T_INF],
                   2, -5, n_pe, 1, all_pol, "no blocking record in 2,000")
    if not all(branches.values()):
        fail(f"the R = 1 cases missed a select branch: {branches}")
    print(f"kernel phase: {n_checked} cases exact (each: availscan in both "
          f"modes + availscan_select x policies); select branches: "
          f"{branches['shared']} shared-memory, {branches['global']} "
          f"global-memory (live records over the budget)")

    # ---- times at the paper's shape: S = 128, P = 258, n_pe = 1024
    n_pe, cap = PAPER_SHAPE["n_pe"], PAPER_SHAPE["capacity"]
    times_np, occ_np = random_timeline(rng, n_pe, cap, 0.2)
    tl = Timeline(torch.from_numpy(times_np).to(dev),
                  torch.from_numpy(to_int32(occ_np)).to(dev))
    t_du = 900
    span = int(times_np[times_np < T_INF][-1])
    starts = search_lib.candidate_starts(tl, 0, t_du, span + 4 * t_du)
    pid, n_req = 2, 256
    args = (tl.times, tl.occ, starts, t_du, 0)
    rows = {}
    for name, kern, plain, extra, out_bytes in (
            ("availscan", K.availscan, R.availscan_ref, (n_pe,),
             3 * 4 * starts.numel()),
            ("availscan_select", K.availscan_select, R.availscan_select_ref,
             (n_req, pid, n_pe), 8 * 4)):
        ms = cuda_time_ms(lambda: kern(*args, *extra), reps=200)
        plain_ms = cuda_time_ms(lambda: plain(*args, *extra), reps=20)
        dev_ms, kname = one_kernel_per_call(
            name, lambda: kern(*args, *extra))
        plain_dev_ms = device_ms(lambda: plain(*args, *extra), reps=10)
        g, w = kern(*args, *extra), plain(*args, *extra)
        g = torch.stack(g) if isinstance(g, tuple) else g
        w = torch.stack(w) if isinstance(w, tuple) else w
        err = int((g.long() - w.long()).abs().max())
        if err != 0:
            fail(f"{name} differs at the paper shape")
        n_bytes, ops = scan_work(times_np, occ_np, starts.cpu().numpy(),
                                 t_du)
        n_bytes += out_bytes
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT32_OPS_PER_S * 1e3
        rows[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/availscan.cu",
            replaces={
                "availscan": "src/repro/kernels/availscan.py:175",
                "availscan_select": "src/repro/kernels/availscan.py:406",
            }[name],
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, exact=True, device_ms=dev_ms,
            plain_device_ms=plain_dev_ms,
            shape=dict(S=cap, P=int(starts.numel()),
                       live=int((starts < T_INF).sum()), n_pe=n_pe),
            bytes=n_bytes, word_ops=ops, kernels_per_call=1,
            device_kernel=kname)
        rows[name].update(
            design=DESIGNS[name], **launch_floor(int(starts.numel())),
            **select_resources(report, name, cap, occ_np.shape[1]))
        print(f"{name}: per call {ms * 1e3:.2f} us (kernels on the card "
              f"{_us(dev_ms)}), plain {plain_ms * 1e3:.1f} us (on the card "
              f"{_us(plain_dev_ms)}), bound "
              f"{rows[name]['bound_ms'] * 1e6:.2f} ns "
              f"({rows[name]['bound_by']}; {n_bytes} B, {ops} word ops), "
              f"one kernel per call")
    print_floor(rows, ("availscan", "availscan_select"))
    return rows


def print_floor(rows: dict, names) -> None:
    r = rows[names[0]]
    print(f"launch floor: an empty kernel of {r['grid']} x "
          f"{r['block_threads']} threads: per call "
          f"{r['launch_floor_ms'] * 1e3:.2f} us, on the card "
          f"{_us(r['launch_floor_device_ms'])}")
    for name in names:
        r = rows[name]
        kernel = r["device_kernel"].split("::", 1)[-1].split("(")[0]
        print(f"  {name} ({kernel}): {r['registers']} "
              f"registers, {r['smem_static_bytes']} B static + "
              f"{r['smem_dynamic_bytes']} B dynamic shared memory, "
              f"{r['spill_bytes']} B spilled")


def kernel_phase_mr(rng, dev, rows: dict, report: dict) -> None:
    """Both multi-resource kernels against their plain versions, exact."""
    import torch
    from repro_torch.core import search as search_lib
    from repro_torch.core.resources import ResourceSpec, device_layout
    from repro_torch.core.timeline import Timeline
    from repro_torch.core.words import to_int32
    from repro_torch.kernels import availscan as K
    from repro_torch.kernels import cases
    from repro_torch.kernels import ref as R

    n_checked = 0
    branches = {"shared": 0, "global": 0}

    def check_case(spec, live, times_np, occ_np, starts, t_du, t_now,
                   n_req, label, infeasible=False):
        nonlocal n_checked
        if spec.R > 1:
            branches[smem_branch(times_np, occ_np.shape[1])] += 1
        times = torch.from_numpy(times_np).to(dev)
        occ = torch.from_numpy(to_int32(occ_np)).to(dev)
        if not isinstance(starts, torch.Tensor):
            starts = torch.from_numpy(np.asarray(starts, np.int32)).to(dev)
        valid = torch.from_numpy(spec.valid_mask_np(live)).to(dev)
        plane = device_layout(spec, dev).plane_of_word
        got = K.availscan_mr(times, occ, starts, valid, plane, spec.R, t_du,
                             t_now, n_pe=spec.n_pe)
        want = R.availscan_mr_ref(times, occ, starts, valid, plane, spec.R,
                                  t_du, t_now)
        for name, g, w in zip(("n_free", "n_free_tail", "t_begin", "t_end"),
                              got, want):
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:5, 0].tolist()
                fail(f"availscan_mr {name} differs ({label}) at {bad}")
        check_windows(
            f"availscan_mr {label}", starts,
            lambda st: K.availscan_mr(times, occ, st, valid, plane, spec.R,
                                      t_du, t_now, n_pe=spec.n_pe),
            lambda st: R.availscan_mr_ref(times, occ, st, valid, plane,
                                          spec.R, t_du, t_now),
            lambda x: K.availscan_one_mr(times, occ, x, valid, plane, spec.R,
                                         t_du, t_now, n_pe=spec.n_pe),
            lambda x: R.availscan_one_mr_ref(times, occ, x, valid, plane,
                                             spec.R, t_du, t_now))
        n_free, tail, t_begin, t_end = want
        demands = {(0,) * (spec.R - 1), tuple(u // 2 for u in spec.units[1:]),
                   spec.units[1:]}
        for d in sorted(demands):
            d_t = torch.tensor(d, dtype=torch.int32).to(dev)
            # the plain select's own feasibility, on the plain rectangles
            feasible = ((starts < T_INF) & (n_free >= n_req)
                        & (tail >= d_t[None, :]).all(dim=1))
            for pid in range(7):
                g = K.availscan_select_mr(times, occ, starts, valid, plane,
                                          d_t, t_du, t_now, n_req, pid,
                                          n_pe=spec.n_pe)
                w = R.select_row(starts, n_free, t_begin, t_end, feasible,
                                 pid)
                if not torch.equal(g, w):
                    fail(f"availscan_select_mr differs ({label}, policy "
                         f"{pid}, demand {d}): {g.tolist()} vs {w.tolist()}")
                if infeasible and d == spec.units[1:] and int(g[7]):
                    fail(f"{label}: a full secondary demand was feasible")
        w = R.availscan_select_mr_ref(times, occ, starts, valid, plane, d_t,
                                      t_du, t_now, n_req, 6)
        if not torch.equal(g, w):
            fail(f"availscan_select_mr differs from its plain version "
                 f"({label})")
        n_checked += 1

    for units, live in MR_LAYOUTS:
        spec = ResourceSpec(units)
        lu = None if live is None else live + units[1:]
        n_live = units[0] if live is None else live[0]
        for cap in MR_CAPACITIES:
            times_np, occ_np = random_timeline_mr(rng, spec, lu, cap, 0.9)
            span = int(times_np[times_np < T_INF][-1])
            t_r = int(rng.integers(0, max(1, span // 2)))
            t_du = int(rng.integers(1, 400))
            t_dl = t_r + t_du + int(rng.integers(0, span))
            tl = Timeline(torch.from_numpy(times_np).to(dev),
                          torch.from_numpy(to_int32(occ_np)).to(dev))
            starts = search_lib.candidate_starts(tl, t_r, t_du, t_dl)
            check_case(spec, lu, times_np, occ_np, starts, t_du, t_r,
                       int(rng.integers(1, n_live + 1)),
                       f"{units} live {live} S={cap}")
            rand = rng.integers(0, span + 1, 2 * cap + 2).astype(np.int32)
            rand[rng.random(rand.shape[0]) < 0.3] = T_INF
            check_case(spec, lu, times_np, occ_np, rand, t_du, 0,
                       n_live // 3, f"{units} random starts S={cap}")
        # edge cases on this layout
        W = spec.total_words
        empty_t = np.full(128, T_INF, np.int32)
        empty_o = np.zeros((128, W), np.uint32)
        check_case(spec, lu, empty_t, empty_o, [5, 9, T_INF, T_INF], 7, 0,
                   n_live, f"{units} empty timeline")
        times_np, occ_np = random_timeline_mr(rng, spec, lu, 1024, 0.9)
        dead = np.full(2050, T_INF, np.int32)
        check_case(spec, lu, times_np, occ_np, dead, 5, 0, 1,
                   f"{units} all candidates dead")
        dead[1] = 17
        check_case(spec, lu, times_np, occ_np, dead, 5, 0, 1,
                   f"{units} dead tiles around one live candidate")
        live_t = times_np[times_np < T_INF]
        check_case(spec, lu, times_np, occ_np, np.sort(live_t[:200]), 50, 0,
                   units[0] + 1, f"{units} infeasible request")
        check_case(spec, lu, times_np, occ_np,
                   [int(live_t[-1]), T_INF - 10, T_INF - 1, T_INF - 3000],
                   5000, 0, 1, f"{units} window at the horizon")
        far_t, far_o = cases.no_blocking_timeline(spec, 4096, 2000)
        check_case(spec, lu, far_t, far_o,
                   [int(far_t[1000]), 7, int(far_t[10]), T_INF], 2, -5, 1,
                   f"{units} no blocking record in 2,000")
        if spec.R > 1:
            # one unit of the last plane held over the whole horizon: a
            # one-PE request that asks for that whole plane fits nowhere
            hold = occ_np.copy()
            hold[:live_t.size, spec.word_offsets[-1]] |= np.uint32(1)
            check_case(spec, lu, times_np, hold, np.sort(live_t[:100]), 30,
                       0, 1, f"{units} only a secondary plane refuses",
                       infeasible=True)
    if not all(branches.values()):
        fail(f"the R > 1 cases missed a select branch: {branches}")
    print(f"multi-resource kernel phase: {n_checked} cases exact (each: "
          f"availscan_mr in both modes + availscan_select_mr x 7 policies x "
          f"demand tails);"
          f" R > 1 select branches: {branches['shared']} shared-memory, "
          f"{branches['global']} global-memory")

    # ---- times at the session's shape: S = 128, P = 258, (1024, 128, 64,
    # 256) = 46 words
    spec = ResourceSpec(MR_UNITS)
    lay = device_layout(spec, dev)
    times_np, occ_np = random_timeline_mr(rng, spec, None, 128, 0.2)
    tl = Timeline(torch.from_numpy(times_np).to(dev),
                  torch.from_numpy(to_int32(occ_np)).to(dev))
    t_du = 900
    span = int(times_np[times_np < T_INF][-1])
    starts = search_lib.candidate_starts(tl, 0, t_du, span + 4 * t_du)
    d_t = torch.tensor([u // 4 for u in MR_UNITS[1:]],
                       dtype=torch.int32).to(dev)
    pid, n_req = 2, 256
    base = (tl.times, tl.occ, starts, lay.valid_mask, lay.plane_of_word)
    calls = {
        "availscan_mr": (
            lambda: K.availscan_mr(*base, spec.R, t_du, 0, n_pe=1024),
            lambda: R.availscan_mr_ref(*base, spec.R, t_du, 0),
            4 * starts.numel() * (3 + spec.R - 1),
            "src/repro/kernels/availscan.py:253"),
        "availscan_select_mr": (
            lambda: K.availscan_select_mr(*base, d_t, t_du, 0, n_req, pid,
                                          n_pe=1024),
            lambda: R.availscan_select_mr_ref(*base, d_t, t_du, 0, n_req,
                                              pid),
            8 * 4, "src/repro/kernels/availscan.py:529"),
    }
    valid_np = spec.valid_mask_np().view(np.uint32)
    for name, (kern, plain, out_bytes, replaces) in calls.items():
        ms = cuda_time_ms(kern, reps=200)
        plain_ms = cuda_time_ms(plain, reps=20)
        dev_ms, kname = one_kernel_per_call(name, kern)
        plain_dev_ms = device_ms(plain, reps=10)
        g, w = kern(), plain()
        if isinstance(g, tuple):
            g = torch.cat([x.reshape(-1) for x in g])
            w = torch.cat([x.reshape(-1) for x in w])
        err = int((g.long() - w.long()).abs().max())
        if err != 0:
            fail(f"{name} differs at the session shape")
        n_bytes, ops = scan_work_mr(times_np, occ_np, starts.cpu().numpy(),
                                    t_du, valid_np, spec.R)
        rows[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/availscan.cu",
            replaces=replaces, launches=0, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=None, exact=True,
            device_ms=dev_ms, plain_device_ms=plain_dev_ms,
            shape=dict(S=128, P=int(starts.numel()),
                       live=int((starts < T_INF).sum()), units=MR_UNITS,
                       words=spec.total_words),
            kernels_per_call=1, device_kernel=kname,
            **bound_row(n_bytes + out_bytes, ops))
        r = rows[name]
        r.update(design=DESIGNS[name], **launch_floor(int(starts.numel())),
                 **select_resources(report, name, 128, spec.total_words))
        print(f"{name}: per call {ms * 1e3:.2f} us (kernels on the card "
              f"{_us(dev_ms)}), plain {plain_ms * 1e3:.1f} us (on the card "
              f"{_us(plain_dev_ms)}), bound {r['bound_ms'] * 1e6:.2f} ns "
              f"({r['bound_by']}; {r['bytes']} B, {ops} word ops), "
              f"one kernel per call")
    print_floor(rows, ("availscan_mr", "availscan_select_mr"))


def case_on_card(case, spec, live, dev):
    """A :class:`repro_torch.kernels.cases.SelectCase` as card tensors:
    ``(times, occ, starts, valid, plane_of_word, demand_tail)``."""
    import torch
    from repro_torch.core.resources import device_layout
    from repro_torch.core.words import to_int32
    valid = torch.from_numpy(spec.valid_mask_np(live)).to(dev)
    return (torch.from_numpy(case.times).to(dev),
            torch.from_numpy(to_int32(case.occ)).to(dev),
            torch.from_numpy(case.starts).to(dev), valid,
            device_layout(spec, dev).plane_of_word,
            torch.tensor(case.demand_tail, dtype=torch.int32).to(dev))


def select_seams(rng, dev, n_repeat: int) -> None:
    """Both select kernels against their plain versions, exact, where a
    one-launch kernel that combines one row per block can break: ties
    across blocks, all-infeasible rows with the live candidates spread
    over several blocks, candidate counts at a multiple of a block's
    candidates and one either side (up to the largest grid and past it),
    and ``n_repeat`` calls of varying P queued back to back, each after
    a call whose ticket counter must have reset."""
    import torch
    from repro_torch.core.resources import ResourceSpec, device_layout
    from repro_torch.core.words import to_int32
    from repro_torch.kernels import availscan as K
    from repro_torch.kernels import build, cases
    from repro_torch.kernels import ref as R

    lib = build.load()
    per_block = lib.availscan_candidates_per_block()
    max_blocks = lib.availscan_select_max_blocks()
    sizes = cases.seam_sizes(per_block, (1, 2, 33, max_blocks,
                                         max_blocks + 1))

    def pinned(case, row, label):
        """What the case's kind pins down about the winner."""
        P = case.starts.shape[0]
        last = (P - 1) // per_block * per_block
        best, feasible = int(row[3]), int(row[7])
        if case.label.startswith("tie spread") and last > 0:
            ok = feasible and best < last
        elif case.label.startswith("tie"):
            ok = feasible and best >= last
        elif case.label.startswith("infeasible"):
            ok = not feasible and best == last
        else:
            ok = True
        if not ok:
            fail(f"{label}: winner {best} (feasible {feasible}) breaks the "
                 f"case's seam")

    n_cases = 0
    for units, live in (((1024,), None), ((2048,), None),
                        (MR_UNITS, None), ((2048, 14336), None)):
        spec = ResourceSpec(units)
        for case in cases.seam_cases(rng, spec, live, 128, sizes,
                                     per_block):
            times, occ, starts, valid, plane, tail = case_on_card(
                case, spec, live, dev)
            label = f"{units} {case.label}"
            for pid in range(7):
                if spec.R == 1:
                    g = K.availscan_select(times, occ, starts, case.t_du,
                                           case.t_now, case.n_req, pid,
                                           spec.n_pe)
                    w = R.availscan_select_ref(times, occ, starts, case.t_du,
                                               case.t_now, case.n_req, pid,
                                               spec.n_pe)
                else:
                    g = K.availscan_select_mr(times, occ, starts, valid,
                                              plane, tail, case.t_du,
                                              case.t_now, case.n_req, pid,
                                              n_pe=spec.n_pe)
                    w = R.availscan_select_mr_ref(times, occ, starts, valid,
                                                  plane, tail, case.t_du,
                                                  case.t_now, case.n_req,
                                                  pid)
                if not torch.equal(g, w):
                    fail(f"select differs on {label}, policy {pid}: "
                         f"{g.tolist()} vs {w.tolist()}")
                pinned(case, w, label)
            n_cases += 1
    print(f"select seams: {n_cases} cases exact x 7 policies (ties across "
          f"blocks, all infeasible, many tiles; P in {sizes})")

    # back to back: every call's grid differs from the last one's
    for units in ((1024,), MR_UNITS):
        spec = ResourceSpec(units)
        times_np, occ_np = random_timeline_mr(rng, spec, None, 1024, 0.5)
        span = int(times_np[times_np < T_INF][-1])
        lay = device_layout(spec, dev)
        times = torch.from_numpy(times_np).to(dev)
        occ = torch.from_numpy(to_int32(occ_np)).to(dev)
        calls = []
        for _ in range(n_repeat):
            P = int(rng.integers(1, 3000))
            st = rng.integers(0, span + 1, P).astype(np.int32)
            st[rng.random(P) < 0.3] = T_INF
            st_t = torch.from_numpy(st).to(dev)
            pid = int(rng.integers(0, 7))
            n_req = int(rng.integers(1, spec.n_pe + 1))
            tail = torch.tensor([int(rng.integers(0, u + 1))
                                 for u in units[1:]],
                                dtype=torch.int32).to(dev)
            t_du = int(rng.integers(1, 400))
            args = (st_t, tail, t_du, n_req, pid)
            if spec.R == 1:
                out = K.availscan_select(times, occ, st_t, t_du, 0, n_req,
                                         pid, spec.n_pe)
            else:
                out = K.availscan_select_mr(times, occ, st_t, lay.valid_mask,
                                            lay.plane_of_word, tail, t_du, 0,
                                            n_req, pid, n_pe=spec.n_pe)
            calls.append((args, out))
        torch.cuda.synchronize()
        for (st_t, tail, t_du, n_req, pid), g in calls:
            if spec.R == 1:
                w = R.availscan_select_ref(times, occ, st_t, t_du, 0, n_req,
                                           pid, spec.n_pe)
            else:
                w = R.availscan_select_mr_ref(times, occ, st_t,
                                              lay.valid_mask,
                                              lay.plane_of_word, tail, t_du,
                                              0, n_req, pid)
            if not torch.equal(g, w):
                fail(f"back-to-back select on {units} differs at P="
                     f"{st_t.numel()}: {g.tolist()} vs {w.tolist()}")
        print(f"back to back: {n_repeat} calls on {units}, P from 1 to 2999,"
              f" queued without a sync, exact")


def main_path(jobs, dev, rows: dict, n_event_loop: int):
    import torch
    from repro_torch.core import search as search_lib
    from repro_torch.core.batch import StreamStats
    from repro_torch.core.scheduler import DeviceEngine
    from repro_torch.core.types import Policy, T_INF as TI
    from repro_torch.kernels import availscan as K
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.sim import simulate, simulate_batched

    stats = StreamStats()
    K.reset_launches()
    res = simulate_batched(jobs, 1024, Policy.PE_W, device=dev,
                           stats=stats)
    launches = dict(K.LAUNCHES)
    n = len(jobs)
    if launches["availscan_select"] < n:
        fail(f"availscan_select launched {launches['availscan_select']} "
             f"times for {n} requests")
    rows["availscan_select"]["launches"] = launches["availscan_select"]
    t0 = time.perf_counter()
    ref = simulate(jobs, 1024, Policy.PE_W, engine="host",
                   record_decisions=True)
    host_s = time.perf_counter() - t0
    if ref.decisions != res.decisions:
        diff = [i for i, (x, y) in enumerate(zip(ref.decisions,
                                                 res.decisions)) if x != y]
        fail(f"card decisions differ from the host loop at {diff[:10]} "
             f"({len(diff)}/{n})")
    if (ref.slowdowns, ref.busy_area) != (res.slowdowns, res.busy_area):
        fail("card slowdowns / busy area differ from the host loop")
    print(f"main path: {n} jobs, PE_W, 1024 PEs: acceptance "
          f"{res.acceptance_rate:.4f}, avg slowdown {res.avg_slowdown:.6f}, "
          f"card run {res.wall_seconds:.3f} s = "
          f"{n / res.wall_seconds:.1f} requests/s "
          f"(host oracle {host_s:.3f} s); identical to the host loop")
    print(f"main path: availscan_select launches {launches['availscan_select']}"
          f", host syncs {stats.host_syncs} = "
          f"{stats.host_syncs / n:.3f} per request, release passes "
          f"{stats.release_passes}, growths {stats.growths}, final capacity "
          f"{stats.capacity} records / {stats.pending_capacity} pending")

    # per-operation path: the event loop over DeviceEngine's three
    # paper operations (add / delete through timeline.update, find
    # through the kernel on the power-of-two search prefix)
    n_ops = min(n_event_loop, n)
    K.reset_launches()
    dev_loop = simulate(jobs[:n_ops], 1024, Policy.PE_W, engine="device",
                        device=dev, record_decisions=True)
    loop_launches = dict(K.LAUNCHES)
    if loop_launches["availscan_select"] < n_ops:
        fail(f"event loop: availscan_select launched "
             f"{loop_launches['availscan_select']} times for {n_ops} "
             f"requests")
    host_loop = simulate(jobs[:n_ops], 1024, Policy.PE_W, engine="host",
                         record_decisions=True)
    if host_loop.decisions != dev_loop.decisions or (
            host_loop.slowdowns, host_loop.busy_area) != (
            dev_loop.slowdowns, dev_loop.busy_area):
        fail("card event loop differs from the host event loop")
    rows["availscan_select"]["launches_event_loop"] = \
        loop_launches["availscan_select"]
    print(f"event loop: simulate(engine='device'), {n_ops} jobs, PE_W, "
          f"1024 PEs: acceptance {dev_loop.acceptance_rate:.4f}, card "
          f"{dev_loop.wall_seconds:.3f} s = "
          f"{n_ops / dev_loop.wall_seconds:.1f} requests/s (host "
          f"{host_loop.wall_seconds:.3f} s); availscan_select launches "
          f"{loop_launches['availscan_select']}; identical to the host loop")

    # rectangle query path: the kernel-backed availability_rectangles
    # over probe requests on a timeline the engine admitted
    n_admit = min(500, n - 64)
    eng = DeviceEngine(1024, capacity=128, device=dev)
    eng.admit_stream(jobs[:n_admit], Policy.PE_W)
    print(f"main path: engine after {n_admit} jobs: capacity "
          f"{eng.tl.capacity}, pending {eng.state.pending_capacity}, "
          f"records {int(eng.tl.n_valid())}")
    probes = jobs[n_admit:n_admit + 64]
    starts = [search_lib.candidate_starts(eng.tl, j.t_r, j.t_du, j.t_dl)
              for j in probes]
    K.reset_launches()
    got = [ops.availability_rectangles(eng.tl, s, j.t_du, j.t_a, 1024)
           for s, j in zip(starts, probes)]
    launches = dict(K.LAUNCHES)
    if launches["availscan"] < len(probes):
        fail(f"availscan launched {launches['availscan']} times for "
             f"{len(probes)} probes")
    rows["availscan"]["launches"] = launches["availscan"]
    for g, s, j in zip(got, starts, probes):
        w = R.availscan_ref(eng.tl.times, eng.tl.occ, s, j.t_du, j.t_a,
                            1024)
        if not all(torch.equal(a, b) for a, b in
                   zip((g.n_free, g.t_begin, g.t_end), w)):
            fail("rectangle query differs from the plain version")
        if not bool(((g.starts < TI) == g.valid).all()):
            fail("rectangle query validity mask wrong")
    print(f"rectangle query: {len(probes)} probes, availscan launches "
          f"{launches['availscan']}, exact")
    return res


def profile_steps(jobs, dev, n_steps: int = 300) -> None:
    """Where an admit step's time goes: one profiled stream of
    ``n_steps`` requests (wall clock, kernel launches, device busy) in a
    :func:`profiled_window`, its empty kernels left out."""
    import torch
    from repro_torch.core import batch as batch_lib
    from repro_torch.core import timeline as tl_lib
    from repro_torch.core.types import Policy

    batch = batch_lib.requests_to_batch(jobs[:n_steps], device=dev)
    state = tl_lib.init_state(128, 1024, 256, device=dev)
    batch_lib.admit_stream(state, batch, Policy.PE_W, n_pe=1024)   # warm
    torch.cuda.synchronize()
    with profiled_window() as prof:
        t0 = time.perf_counter()
        batch_lib.admit_stream(state, batch, Policy.PE_W, n_pe=1024)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = profiled_events(prof)
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    n_kernels = sum(e.count for e in events)
    print(f"profiled {n_steps} admit steps: wall {wall:.3f} s "
          f"({wall / n_steps * 1e3:.3f} ms/step, profiler on), device busy "
          f"{busy_s:.4f} s, idle share {1 - busy_s / wall:.4f}, "
          f"{n_kernels / n_steps:.1f} kernels/step")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / n_steps:8.2f} us/step "
              f"{e.count / n_steps:5.2f} x/step  {e.key[:90]}")


def paper_claims(dev, n_jobs: int = 1000) -> None:
    from repro_torch.core.types import ALL_POLICIES, Policy
    from repro_torch.sim import WorkloadParams, generate, simulate_batched

    jobs = generate(WorkloadParams(n_jobs=n_jobs, seed=11))
    acc, sd = {}, {}
    print(f"paper claims ({n_jobs} jobs, seed 11, 1024 PEs, card, "
          f"cross-checked):")
    for pol in ALL_POLICIES:
        r = simulate_batched(jobs, 1024, pol, device=dev, cross_check=True)
        acc[pol.value], sd[pol.value] = r.acceptance_rate, r.avg_slowdown
        print(f"  {pol.value:7s} acceptance {r.acceptance_rate:.4f} "
              f"slowdown {r.avg_slowdown:.4f} card {r.wall_seconds:.2f} s")
    best = max(acc.values())
    if acc[Policy.PE_W.value] < best - 0.01:
        fail(f"PE_W acceptance {acc['PE_W']:.4f} not within 0.01 of "
             f"the best {best:.4f}")
    if sd[Policy.FF.value] != min(sd.values()):
        fail(f"FF slowdown {sd['FF']:.4f} is not the lowest")
    print("paper claims: PE_W within 0.01 of the best acceptance, "
          "FF the lowest slowdown")


def _decisions(results):
    allocs = [a for r in results for a in r.allocations()]
    return allocs, [(a is not None, a.t_s if a is not None else -1)
                    for a in allocs]


def _first_diff(got, want) -> str:
    diff = [i for i, (x, y) in enumerate(zip(got, want)) if x != y]
    return f"at {diff[:10]} ({len(diff)}/{len(want)}; lengths " \
        f"{len(got)}/{len(want)})"


def session_path(jobs, dev, rows: dict) -> None:
    """The multi-resource session on the stamped paper stream."""
    import torch
    from repro_torch.api import ReservationService, ServiceConfig
    from repro_torch.core.hostsched import MultiResourceOracle
    from repro_torch.core.resources import ResourceSpec
    from repro_torch.core.types import Policy
    from repro_torch.kernels import availscan as K

    spec = ResourceSpec(MR_UNITS)
    n = len(jobs)
    sess = ReservationService(ServiceConfig(
        n_pe=1024, resources=MR_UNITS, policy=Policy.PE_W, use_kernel=True,
        chunk_size=64, ring_capacity=256, device=dev)).session()
    K.reset_launches()
    t0 = time.perf_counter()
    results = [sess.offer(jobs[i:i + 100], flush=False)
               for i in range(0, n, 100)]
    results.append(sess.flush())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    m = sess.metrics()
    allocs, got = _decisions(results)
    t0 = time.perf_counter()
    oracle = MultiResourceOracle(spec, Policy.PE_W, "none")
    want = oracle.run(jobs)
    host_s = time.perf_counter() - t0
    if got != want:
        fail(f"session decisions differ from the oracle {_first_diff(got, want)}")
    if sess.records() != oracle.records():
        fail("session records differ from the oracle's")
    if launches["availscan_select_mr"] != m["steps"] or m["steps"] < n:
        fail(f"availscan_select_mr launched {launches['availscan_select_mr']}"
             f" times for {m['steps']} admit steps ({n} requests)")
    if launches["availscan_select"] or launches["availscan"]:
        fail(f"single-resource kernels launched on the session: {launches}")
    rows["availscan_select_mr"]["launches"] = launches["availscan_select_mr"]
    acc = [(a, j) for a, j in zip(allocs, jobs) if a is not None]
    slow = [(a.t_s - j.t_r + j.t_du) / j.t_du for a, j in acc]
    print(f"session: {n} stamped jobs, PE_W, units {MR_UNITS}: acceptance "
          f"{len(acc) / n:.4f}, avg slowdown {np.mean(slow):.6f}, card run "
          f"{wall:.3f} s = {n / wall:.1f} requests/s (oracle {host_s:.3f} s)"
          f"; decisions and records identical to MultiResourceOracle")
    print(f"session: {m['chunks']} chunks, {m['steps']} admit steps "
          f"({m['steps'] - n} filler or re-run), availscan_select_mr "
          f"launches {launches['availscan_select_mr']}, host syncs "
          f"{m['host_syncs']} = {m['host_syncs'] / n:.3f} per request, "
          f"release passes {m['release_passes']}, growths {m['growths']}, "
          f"final capacity {m['capacity']} records / "
          f"{m['pending_capacity']} pending")
    rows["availscan_select_mr"]["session"] = dict(
        n=n, wall_s=wall, steps=m["steps"], host_syncs=m["host_syncs"],
        growths=m["growths"], capacity=m["capacity"])

    # rectangle query: the kernel-backed availability_rectangles over
    # probes on the timeline the session left
    from repro_torch.core import search as search_lib
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    tl, lane_valid = sess.engine.tl, sess.engine.state.lane_valid
    probes = jobs[-64:]
    starts = [search_lib.candidate_starts(tl, j.t_r, j.t_du, j.t_dl)
              for j in probes]
    K.reset_launches()
    got = [ops.availability_rectangles(tl, st, j.t_du, j.t_a, 1024,
                                       rspec=spec, valid_mask=lane_valid)
           for st, j in zip(starts, probes)]
    launches = dict(K.LAUNCHES)
    if launches["availscan_mr"] != len(probes):
        fail(f"availscan_mr launched {launches['availscan_mr']} times for "
             f"{len(probes)} probes")
    rows["availscan_mr"]["launches"] = launches["availscan_mr"]
    from repro_torch.core.resources import device_layout
    plane = device_layout(spec, tl.device).plane_of_word
    for g, st, j in zip(got, starts, probes):
        w = R.availscan_mr_ref(tl.times, tl.occ, st, lane_valid, plane,
                               spec.R, j.t_du, j.t_a)
        if not all(torch.equal(a, b) for a, b in zip(
                (g.n_free, g.n_free_tail, g.t_begin, g.t_end), w)):
            fail("multi-resource rectangle query differs from the plain "
                 "version")
    print(f"rectangle query: {len(probes)} probes on the session's "
          f"timeline ({int(tl.n_valid())} records), availscan_mr launches "
          f"{launches['availscan_mr']}, exact")


def profile_session(jobs, dev, n_jobs: int = 320) -> None:
    """Where a session's admit step goes: a warm session, then one
    offer of ``n_jobs`` requests in a :func:`profiled_window`, its empty
    kernels left out."""
    import torch
    from repro_torch.api import ReservationService, ServiceConfig
    from repro_torch.core.types import Policy

    sess = ReservationService(ServiceConfig(
        n_pe=1024, resources=MR_UNITS, policy=Policy.PE_W, use_kernel=True,
        chunk_size=64, ring_capacity=256, device=dev)).session()
    sess.offer(jobs[:n_jobs])
    before = sess.metrics()
    torch.cuda.synchronize()
    with profiled_window() as prof:
        t0 = time.perf_counter()
        sess.offer(jobs[n_jobs:2 * n_jobs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after = sess.metrics()
    steps = after["steps"] - before["steps"]
    syncs = after["host_syncs"] - before["host_syncs"]
    events = profiled_events(prof)
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    n_kernels = sum(e.count for e in events)
    print(f"profiled session: {steps} admit steps, wall {wall:.3f} s "
          f"({wall / steps * 1e3:.3f} ms/step, profiler on), device busy "
          f"{busy_s:.4f} s, idle share {1 - busy_s / wall:.4f}, "
          f"{n_kernels / steps:.1f} kernels/step, {syncs / steps:.3f} host "
          f"syncs/step")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / steps:8.2f} us/step "
              f"{e.count / steps:5.2f} x/step  {e.key[:90]}")


def session_variants(jobs_mr, jobs, dev, n_event_loop: int) -> None:
    """One-shot sessions for every policy, a heterogeneous lane and the
    per-operation event loop, each against the oracle."""
    from repro_torch.api import ReservationService, ServiceConfig
    from repro_torch.core.hostsched import MultiResourceOracle
    from repro_torch.core.resources import ResourceSpec
    from repro_torch.core.types import ALL_POLICIES, Policy
    from repro_torch.kernels import availscan as K
    from repro_torch.sim import simulate

    spec = ResourceSpec(MR_UNITS)
    few = jobs_mr[:150]
    K.reset_launches()
    for pol in ALL_POLICIES:
        sess = ReservationService(ServiceConfig(
            n_pe=1024, resources=MR_UNITS, policy=pol, use_kernel=True,
            chunk_size=None, device=dev)).session()
        _, got = _decisions([sess.offer(few)])
        oracle = MultiResourceOracle(spec, pol, "none")
        if got != oracle.run(few) or sess.records() != oracle.records():
            fail(f"one-shot session, {pol.value}: differs from the oracle")
    if K.LAUNCHES["availscan_select_mr"] < 7 * len(few):
        fail(f"one-shot sessions launched availscan_select_mr "
             f"{K.LAUNCHES['availscan_select_mr']} times")
    print(f"one-shot sessions: {len(few)} stamped jobs x 7 policies "
          f"identical to the oracle (availscan_select_mr launches "
          f"{K.LAUNCHES['availscan_select_mr']})")

    lane_jobs = jobs[:1000]
    K.reset_launches()
    t0 = time.perf_counter()
    sess = ReservationService(ServiceConfig(
        n_pe=1024, machine_sizes=(1000,), device=dev)).session()
    allocs, got = _decisions([sess.offer(lane_jobs)])
    wall = time.perf_counter() - t0
    oracle = MultiResourceOracle(ResourceSpec((1024,)), Policy.PE_W, "none",
                                 live_units=(1000,))
    want = oracle.run(lane_jobs)
    if got != want or sess.records() != oracle.records():
        fail(f"machine_sizes=(1000,) lane differs from the oracle "
             f"{_first_diff(got, want)}")
    if any(a is not None and max(a.pe_ids) >= 1000 for a in allocs):
        fail("a dead PE of the heterogeneous lane was allocated")
    if K.LAUNCHES["availscan_select_mr"] < len(lane_jobs):
        fail("the heterogeneous lane did not run availscan_select_mr")
    print(f"heterogeneous lane: machine_sizes=(1000,), {len(lane_jobs)} "
          f"paper jobs, acceptance {sum(g[0] for g in got) / len(got):.4f},"
          f" {len(lane_jobs) / wall:.1f} requests/s; identical to the oracle"
          f" (availscan_select_mr launches "
          f"{K.LAUNCHES['availscan_select_mr']})")

    loop_jobs = jobs_mr[:n_event_loop]
    K.reset_launches()
    res = simulate(loop_jobs, 1024, Policy.PE_W, engine="device",
                   engine_kwargs=dict(rspec=spec, use_kernel=True),
                   device=dev, record_decisions=True)
    n_launch = K.LAUNCHES["availscan_select_mr"]
    want = MultiResourceOracle(spec, Policy.PE_W, "none").run(loop_jobs)
    if res.decisions != want:
        fail(f"multi-resource event loop differs from the oracle "
             f"{_first_diff(res.decisions, want)}")
    if n_launch != len(loop_jobs):
        fail(f"event loop: {n_launch} availscan_select_mr launches for "
             f"{len(loop_jobs)} jobs")
    print(f"event loop: simulate(engine='device', rspec), {len(loop_jobs)} "
          f"stamped jobs: acceptance {res.acceptance_rate:.4f}, "
          f"{len(loop_jobs) / res.wall_seconds:.1f} requests/s; "
          f"availscan_select_mr launches {n_launch}; identical to the oracle")


def pruned_phase(rng, dev, rows: dict) -> None:
    """All four kernels against their plain versions, exact, on the
    candidate arrays the availability index hands them: dead holes in
    the middle, index 0 live and the rest dead to past the first
    128-candidate tile, only index 0 live, and P = 1 (the early reject's
    rectangle), at the paper's shapes; with nothing feasible every
    select names index 0, as the reference's do."""
    import torch
    from repro_torch.core.resources import ResourceSpec
    from repro_torch.kernels import availscan as K
    from repro_torch.kernels import cases
    from repro_torch.kernels import ref as R

    n_cases = 0
    for units in ((1024,), MR_UNITS):
        spec = ResourceSpec(units)
        for case in cases.pruned_cases(rng, spec, None, 128):
            times, occ, starts, valid, plane, tail = case_on_card(
                case, spec, None, dev)
            label = f"{units} {case.label}"
            args = (case.t_du, case.t_now)
            if spec.R == 1:
                g = K.availscan(times, occ, starts, *args, spec.n_pe)
                w = R.availscan_ref(times, occ, starts, *args, spec.n_pe)
            else:
                g = K.availscan_mr(times, occ, starts, valid, plane, spec.R,
                                   *args, n_pe=spec.n_pe)
                w = R.availscan_mr_ref(times, occ, starts, valid, plane,
                                       spec.R, *args)
            if not all(torch.equal(a, b) for a, b in zip(g, w)):
                fail(f"rectangles differ on {label}")
            if spec.R == 1:
                check_windows(
                    f"availscan {label}", starts,
                    lambda st: K.availscan(times, occ, st, *args, spec.n_pe),
                    lambda st: R.availscan_ref(times, occ, st, *args,
                                               spec.n_pe),
                    lambda x: K.availscan_one(times, occ, x, *args,
                                              spec.n_pe),
                    lambda x: R.availscan_one_ref(times, occ, x, *args,
                                                  spec.n_pe))
            else:
                check_windows(
                    f"availscan_mr {label}", starts,
                    lambda st: K.availscan_mr(times, occ, st, valid, plane,
                                              spec.R, *args, n_pe=spec.n_pe),
                    lambda st: R.availscan_mr_ref(times, occ, st, valid,
                                                  plane, spec.R, *args),
                    lambda x: K.availscan_one_mr(times, occ, x, valid, plane,
                                                 spec.R, *args,
                                                 n_pe=spec.n_pe),
                    lambda x: R.availscan_one_mr_ref(times, occ, x, valid,
                                                     plane, spec.R, *args))
            for pid in range(7):
                if spec.R == 1:
                    g = K.availscan_select(times, occ, starts, *args,
                                           case.n_req, pid, spec.n_pe)
                    w = R.availscan_select_ref(times, occ, starts, *args,
                                               case.n_req, pid, spec.n_pe)
                else:
                    g = K.availscan_select_mr(times, occ, starts, valid,
                                              plane, tail, *args, case.n_req,
                                              pid, n_pe=spec.n_pe)
                    w = R.availscan_select_mr_ref(times, occ, starts, valid,
                                                  plane, tail, *args,
                                                  case.n_req, pid)
                if not torch.equal(g, w):
                    fail(f"select differs on {label}, policy {pid}: "
                         f"{g.tolist()} vs {w.tolist()}")
                if not int(w[7]) and int(w[3]) != 0:
                    fail(f"{label}: nothing feasible names index {int(w[3])}")
            n_cases += 1
    print(f"pruned starts: {n_cases} cases, all four kernels exact x 7 "
          f"policies, the rectangle kernels in both modes (holes, a live "
          f"candidate past the 128 seam, only index 0 live, P = 1)")


def indexed_stream(jobs, off, dev, rows: dict) -> None:
    """The paper stream with the availability index (tile 16): the host
    loop's decisions and those of ``off`` (the main path's index-free
    run of the same jobs), the early-reject and pruned shares, and one
    ``availscan`` launch per early reject."""
    from repro_torch.core.batch import StreamStats
    from repro_torch.core.types import Policy
    from repro_torch.kernels import availscan as K
    from repro_torch.sim import simulate_batched

    n = len(jobs)
    stats = StreamStats(count_candidates=True)
    K.reset_launches()
    on = simulate_batched(jobs, 1024, Policy.PE_W, capacity=128,
                          index_tile=16, cross_check=True, device=dev,
                          stats=stats)
    launches = dict(K.LAUNCHES)
    if on.decisions != off.decisions:
        fail("the indexed paper stream decides unlike the index-free run")
    live, pruned = (int(x) for x in stats.candidates.cpu())
    searched = stats.steps - stats.early_rejects
    if launches["availscan"] != stats.early_rejects:
        fail(f"indexed stream: {launches['availscan']} availscan launches "
             f"for {stats.early_rejects} early rejects")
    if launches["availscan_select"] != searched or searched < 1:
        fail(f"indexed stream: {launches['availscan_select']} select "
             f"launches for {searched} full searches")
    rows["availscan"]["launches_indexed_stream"] = launches["availscan"]
    rows["availscan_select"]["launches_indexed_stream"] = \
        launches["availscan_select"]
    print(f"indexed paper stream: {n} jobs, PE_W, tile 16: identical to the "
          f"host loop and the index-free run; early rejects "
          f"{stats.early_rejects}/{stats.steps} steps = "
          f"{stats.early_rejects / stats.steps:.4f}; pruned {pruned}/{live} "
          f"live candidates = {pruned / max(live, 1):.4f}; launches: "
          f"availscan {launches['availscan']}, availscan_select "
          f"{launches['availscan_select']}; {n / on.wall_seconds:.1f} "
          f"requests/s on, {n / off.wall_seconds:.1f} off; host syncs "
          f"{stats.host_syncs / n:.3f} per request")


def saturated_jobs(n_fill: int = 240, n_probe: int = 480,
                   n_pe: int = 1024):
    """The reference's fill-then-reject stream
    (``benchmarks/bench_index.py::saturated_jobs``, 64 PEs) scaled to
    ``n_pe``: fills of (20 + k mod 12) x n_pe/64 PEs over
    ``[1000 + 2k, 1004 + 2k)``, all admitted, then zero-slack probes of
    48 x n_pe/64 PEs inside the filled horizon, none of which fits."""
    from repro_torch.core.types import ARRequest
    u = n_pe // 64
    jobs, t = [], 0
    for k in range(n_fill):
        t_r = 1000 + 2 * k
        jobs.append(ARRequest(t_a=t, t_r=t_r, t_du=4, t_dl=t_r + 4,
                              n_pe=(20 + k % 12) * u))
        t += 1
    span = max(2 * n_fill - 200, 100)
    for k in range(n_probe):
        t_r = 1100 + (k * 7) % span
        jobs.append(ARRequest(t_a=t, t_r=t_r, t_du=8, t_dl=t_r + 8,
                              n_pe=48 * u))
        t += 1
    return jobs


def _saturated_session(jobs, dev, n_fill: int, tile, units=None):
    """One session of the saturated stream at capacity 256: the fills as
    one offer, then the probes in offers of 60, each in a
    :func:`profiled_window` when the index is on.  Returns
    the session, its offers' results, the wall seconds, the launch counts,
    and the one-window kernels and all device operations (kernels and
    copies) the profiler saw in the probe windows."""
    import torch
    from repro_torch.api import ReservationService, ServiceConfig
    from repro_torch.core.types import Policy
    from repro_torch.kernels import availscan as K

    sess = ReservationService(ServiceConfig(
        n_pe=1024, policy=Policy.PE_W, capacity=256, chunk_size=None,
        index_tile=tile, device=dev,
        **({} if units is None else dict(resources=units)))).session()
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = [sess.offer(jobs[:n_fill])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    one_kernels = device_ops = 0
    for lo in range(n_fill, len(jobs), 60):
        with profiled_window() if tile else contextlib.nullcontext() as prof:
            t0 = time.perf_counter()
            results.append(sess.offer(jobs[lo:lo + 60]))
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
        if tile:
            events = profiled_events(prof)
            one_kernels += sum(e.count for e in events
                               if "availscan_one_kernel" in e.key)
            device_ops += sum(e.count for e in events)
    return sess, results, wall, dict(K.LAUNCHES), one_kernels, device_ops


def saturated_stream(dev, rows: dict, report: dict) -> None:
    """The saturated stream at capacity 256, index tile 32 and no index:
    every Decision field equal, at least 90 % of the probes rejected by
    the index, each of those one ``availscan`` kernel on the card (the
    one-window kernel, counted by the profiler); then the same stream
    stamped with the R = 4 demands against ``MultiResourceOracle``, one
    ``availscan_mr`` kernel per early reject.  On each stream's
    timeline the early reject's kernel is then timed at P = 1
    (:func:`one_window_row`).

    Only the indexed probes run under the profiler, 60 to a window: a
    window of all 720 steps holds some 200,000 kernels, and the profiler
    has been seen to lose a few of them."""
    import torch
    from repro_torch.core.batch import Decision
    from repro_torch.core.types import Policy

    jobs = saturated_jobs()
    n_fill, n_probe = 240, 480
    out = {tile: _saturated_session(jobs, dev, n_fill, tile)
           for tile in (32, None)}
    sess, res_on, wall_on, l_on, k_on, ops_on = out[32]
    _, res_off, wall_off, l_off, _, _ = out[None]
    dec_on, dec_off = (Decision(*(torch.cat(f) for f in zip(
        *[r.decision for r in res]))) for res in (res_on, res_off))
    for f, a, b in zip(dec_on._fields, dec_on, dec_off):
        if not torch.equal(a, b):
            fail(f"saturated stream: Decision.{f} differs with the index")
    n_acc = int(dec_on.accepted.sum())
    rejects = sess.metrics()["early_rejects"]
    if n_acc != n_fill or rejects < 0.9 * n_probe:
        fail(f"saturated stream: {n_acc} accepted, {rejects} early rejects "
             f"of {n_probe} probes")
    if l_on["availscan"] != rejects or k_on != rejects:
        fail(f"saturated stream: {l_on['availscan']} availscan launches, "
             f"{k_on} availscan_one_kernel kernels on the card for "
             f"{rejects} early rejects")
    rows["availscan"]["launches_saturated"] = l_on["availscan"]
    n = len(jobs)
    print(f"saturated stream: {n} jobs (240 fills, 480 probes of 768 PEs), "
          f"capacity 256: every Decision field equal with tile 32 and "
          f"without; early rejects {rejects}/{n_probe} probes; availscan "
          f"launches {l_on['availscan']} = one-window kernels on the card "
          f"{k_on}; {ops_on / n_probe:.2f} device operations per probe step "
          f"(kernels and copies); availscan_select launches "
          f"{l_on['availscan_select']} on, {l_off['availscan_select']} off; "
          f"{n / wall_on:.1f} requests/s on (profiler on for the probes), "
          f"{n / wall_off:.1f} off (a record, not a claim)")
    one_window_row(rows, report, "availscan", sess, jobs[n_fill:], None,
                   ops_on / n_probe)

    # the same stream stamped with the R = 4 demands: the early reject's
    # rectangle is the multi-resource kernel
    from repro_torch.core.hostsched import MultiResourceOracle
    from repro_torch.core.resources import ResourceSpec
    jobs_mr = stamp(jobs, MR_UNITS)
    sess, res, wall, launches, k_mr, ops_mr = _saturated_session(
        jobs_mr, dev, n_fill, 32, MR_UNITS)
    _, got = _decisions(res)
    oracle = MultiResourceOracle(ResourceSpec(MR_UNITS), Policy.PE_W, "none")
    want = oracle.run(jobs_mr)
    if got != want or sess.records() != oracle.records():
        fail(f"indexed multi-resource saturated stream differs from the "
             f"oracle {_first_diff(got, want)}")
    rejects = sess.metrics()["early_rejects"]
    if launches["availscan_mr"] != rejects or k_mr != rejects \
            or rejects < 0.9 * n_probe:
        fail(f"indexed multi-resource stream: {launches['availscan_mr']} "
             f"availscan_mr launches, {k_mr} availscan_one_kernel kernels on "
             f"the card for {rejects} early rejects")
    rows["availscan_mr"]["launches_saturated"] = launches["availscan_mr"]
    print(f"saturated stream, R = 4 {MR_UNITS}, tile 32: identical to "
          f"MultiResourceOracle; early rejects {rejects}/{n_probe} probes, "
          f"availscan_mr launches {launches['availscan_mr']} = one-window "
          f"kernels on the card {k_mr}; {ops_mr / n_probe:.2f} device "
          f"operations per probe step; availscan_select_mr "
          f"{launches['availscan_select_mr']}; {n / wall:.1f} requests/s "
          f"(profiler on for the probes)")
    one_window_row(rows, report, "availscan_mr", sess, jobs_mr[n_fill:],
                   ResourceSpec(MR_UNITS), ops_mr / n_probe)


def one_window_row(rows: dict, report: dict, name: str, sess, probes, spec,
                   ops_per_step: float) -> None:
    """The early reject's kernel at P = 1, where the path finds it: on
    the timeline the saturated stream left (just written, so in L2), at
    the probes' starts ``min(t_r, t_dl - t_du)``, in turn.  Exact on
    every probe; per call (CUDA events, host-bound), on the card and one
    kernel a call (profiler), the plain version, the launch floor at its
    grid, the bound from these probes' inputs, and the whole early
    reject as the search runs it (``search._rejected``: per call and
    kernels per call).  Goes into ``rows[name]["p1"]``."""
    import itertools
    import torch
    from repro_torch.core import search as search_lib
    from repro_torch.core.words import to_uint32
    from repro_torch.kernels import availscan as K
    from repro_torch.kernels import ref as R

    tl = sess.engine.tl
    starts = [min(j.t_r, j.t_dl - j.t_du) for j in probes]
    if spec is None:
        valid = None

        def kern(i):
            j = probes[i]
            return K.availscan_one(tl.times, tl.occ, starts[i], j.t_du,
                                   j.t_a, 1024)

        def plain(i):
            j = probes[i]
            return R.availscan_one_ref(tl.times, tl.occ, starts[i], j.t_du,
                                       j.t_a, 1024)
    else:
        from repro_torch.core.resources import device_layout
        valid = sess.engine.state.lane_valid
        plane = device_layout(spec, tl.device).plane_of_word

        def kern(i):
            j = probes[i]
            return K.availscan_one_mr(tl.times, tl.occ, starts[i], valid,
                                      plane, spec.R, j.t_du, j.t_a,
                                      n_pe=spec.n_pe)

        def plain(i):
            j = probes[i]
            return R.availscan_one_mr_ref(tl.times, tl.occ, starts[i], valid,
                                          plane, spec.R, j.t_du, j.t_a)

    for i in range(len(probes)):
        if not torch.equal(kern(i), plain(i)):
            fail(f"{name} (P = 1) differs from its plain version on the "
                 f"saturated timeline at probe {i}")

    def cycle(fn):
        it = itertools.cycle(range(len(probes)))
        return lambda: fn(next(it))

    def rejected(i):
        j = probes[i]
        return search_lib._rejected(tl, j.t_r, j.t_du, j.t_dl, j.t_a, 1024,
                                    spec, valid)

    ms = cuda_time_ms(cycle(kern), reps=200)
    plain_ms = cuda_time_ms(cycle(plain), reps=20)
    dev_ms, kname = one_kernel_per_call(f"{name} (P = 1)", cycle(kern))
    plain_dev_ms = device_ms(cycle(plain), reps=10)
    rej_ms = cuda_time_ms(cycle(rejected), reps=200)
    _, rej_per_call, rej_names = device_profile(cycle(rejected), reps=200)
    if rej_per_call != 1.0 or rej_names != [kname]:
        fail(f"the early reject ran {rej_per_call} kernels a call on the "
             f"card ({rej_names})")
    # the bound: what each probe's window needs, averaged over the probes
    times_np = tl.times.cpu().numpy()
    occ_np = to_uint32(tl.occ.cpu().numpy())
    W = occ_np.shape[1]
    work = []
    for s, j in zip(starts, probes):
        st = np.asarray([s], np.int32)
        if spec is None:
            work.append(scan_work(times_np, occ_np, st, j.t_du))
        else:
            work.append(scan_work_mr(times_np, occ_np, st, j.t_du,
                                     to_uint32(valid.cpu().numpy()), spec.R))
    out_bytes = 4 * ((6 if spec is None else spec.R + 5) + W)
    n_bytes = int(round(np.mean([w[0] for w in work]))) + out_bytes
    ops = int(round(np.mean([w[1] for w in work])))
    p1 = dict(shape=dict(S=int(times_np.size),
                         live=int((times_np < T_INF).sum()), P=1, words=W,
                         probes=len(probes)),
              launches=rows[name]["launches_saturated"], max_abs_err=0,
              ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
              plain_device_ms=plain_dev_ms, device_kernel=kname,
              early_reject_ms=rej_ms, early_reject_kernels=rej_per_call,
              device_ops_per_probe_step=ops_per_step,
              **bound_row(n_bytes, ops), **launch_floor(1),
              **one_resources(report, name))
    rows[name]["p1"] = p1
    print(f"{name} at P = 1 on the saturated timeline ({p1['shape']['live']}"
          f" live records, {len(probes)} probe starts in turn): per call "
          f"{ms * 1e3:.2f} us (on the card {_us(dev_ms)}, one kernel a call),"
          f" plain {plain_ms * 1e3:.1f} us (on the card "
          f"{_us(plain_dev_ms)}), bound {p1['bound_ms'] * 1e6:.3f} ns "
          f"({p1['bound_by']}; {n_bytes} B, {ops} word ops); launch floor "
          f"at 1 x 256 threads {p1['launch_floor_ms'] * 1e3:.2f} us per call,"
          f" {_us(p1['launch_floor_device_ms'])} on the card; "
          f"{p1['registers']} registers, {p1['smem_static_bytes']} B static "
          f"shared memory, {p1['spill_bytes']} B spilled; the early reject "
          f"as the search runs it: {rej_ms * 1e3:.2f} us per call, "
          f"{rej_per_call:.0f} kernel a call")


def pipelined_paths(jobs_mr, dev, rows: dict) -> None:
    """The eager chunk loop on a cut of the session stream, and a
    session that grows mid-stream on both loops: decisions and records
    equal to the oracle's and to each other, and each loop's counters
    equal to the same session's on the CPU (which the tests hold to the
    reference's loop of the same kind)."""
    from repro_torch.api import ReservationService, ServiceConfig
    from repro_torch.core.hostsched import MultiResourceOracle
    from repro_torch.core.resources import ResourceSpec
    from repro_torch.core.types import Policy
    from repro_torch.kernels import availscan as K

    spec = ResourceSpec(MR_UNITS)

    def run(jobs, donate, device, capacity=128, pending=256):
        sess = ReservationService(ServiceConfig(
            n_pe=1024, resources=MR_UNITS, policy=Policy.PE_W,
            capacity=capacity, pending_capacity=pending, chunk_size=64,
            ring_capacity=256, donate=donate, device=device)).session()
        t0 = time.perf_counter()
        results = [sess.offer(jobs[i:i + 100], flush=False)
                   for i in range(0, len(jobs), 100)]
        results.append(sess.flush())
        allocs, got = _decisions(results)
        return got, sess.records(), sess.metrics(), \
            time.perf_counter() - t0

    cut = jobs_mr[:2000]
    K.reset_launches()
    got, recs, m, wall = run(cut, False, dev)
    launches = K.LAUNCHES["availscan_select_mr"]
    oracle = MultiResourceOracle(spec, Policy.PE_W, "none")
    want = oracle.run(cut)
    if got != want or recs != oracle.records():
        fail(f"eager session differs from the oracle {_first_diff(got, want)}")
    if launches != m["steps"]:
        fail(f"eager session: {launches} select launches, {m['steps']} steps")
    rows["availscan_select_mr"]["launches_eager"] = launches
    K.reset_launches()
    got_p, recs_p, m_p, wall_p = run(cut, True, dev)
    if got_p != got or recs_p != recs:
        fail(f"pipelined and eager sessions differ on the {len(cut)}-job "
             f"cut")
    if K.LAUNCHES["availscan_select_mr"] != m_p["steps"]:
        fail("pipelined session: select launches differ from the steps")
    n = len(cut)
    print(f"eager (donate=False) and pipelined sessions: {n} stamped jobs, "
          f"both identical to the oracle; {n / wall:.1f} and "
          f"{n / wall_p:.1f} requests/s; host syncs {m['host_syncs']} = "
          f"{m['host_syncs'] / n:.3f} and {m_p['host_syncs']} = "
          f"{m_p['host_syncs'] / n:.3f} per request; availscan_select_mr "
          f"launches {launches} and {K.LAUNCHES['availscan_select_mr']}")

    # the stamped paper stream never needs more than 32 records or 32
    # pending slots, so the growing session starts at 16 of each
    grow = jobs_mr[:600]
    oracle = MultiResourceOracle(spec, Policy.PE_W, "none")
    want = oracle.run(grow)
    counters = {}
    for donate in (True, False):
        K.reset_launches()
        got, recs, m, wall = run(grow, donate, dev, 16, 16)
        if got != want or recs != oracle.records():
            fail(f"growing session (donate={donate}) differs from the "
                 f"oracle {_first_diff(got, want)}")
        if K.LAUNCHES["availscan_select_mr"] != m["steps"]:
            fail("growing session: select launches differ from the steps")
        _, _, m_cpu, _ = run(grow, donate, "cpu", 16, 16)
        keys = ("chunks", "growths", "capacity", "pending_capacity",
                "steps", "host_syncs", "accepted", "n_pending")
        if any(m[k] != m_cpu[k] for k in keys):
            fail(f"growing session (donate={donate}): counters on the card "
                 f"{[m[k] for k in keys]} vs the CPU "
                 f"{[m_cpu[k] for k in keys]}")
        counters[donate] = m
    if counters[True]["growths"] < 1 or counters[False]["growths"] < 1:
        fail("the growing session did not grow")
    print(f"growing session: {len(grow)} stamped jobs from capacity 16 "
          f"(16 pending slots), "
          f"pipelined and eager identical to the oracle and to each other; "
          f"growths {counters[True]['growths']} pipelined / "
          f"{counters[False]['growths']} eager, capacity "
          f"{counters[True]['capacity']}; counters equal to the CPU run's")


def session_verbs(jobs, dev) -> None:
    """cancel, cancel_many (with a repeat), snapshot/restore and tick on
    a short paper stream against the port's BackfillOracle (mode
    none)."""
    from repro_torch.api import ReservationService, ServiceConfig
    from repro_torch.core.hostsched import BackfillOracle
    from repro_torch.core.types import Policy

    sess = ReservationService(ServiceConfig(
        n_pe=1024, policy=Policy.PE_W, device=dev)).session()
    oracle = BackfillOracle(1024, Policy.PE_W, "none")
    first, rest = jobs[:150], jobs[150:300]
    allocs, got = _decisions([sess.offer(first)])
    if got != oracle.run(first):
        fail("session verbs: decisions differ from the oracle")
    last = first[-1].t_a
    live = [a for a in allocs if a is not None and a.t_e > last]
    if len(live) < 4:
        fail(f"session verbs: only {len(live)} pending reservations")

    def both(a):
        return sess.cancel(a), oracle.cancel(a.t_s, a.t_e, a.pe_ids)

    for a in (live[0], live[0]):
        ours, want = both(a)
        if ours != want:
            fail(f"cancel: {ours} vs the oracle's {want}")
    many = [live[1], live[2], live[1], live[0]]
    ours = sess.cancel_many(many)
    want = [oracle.cancel(a.t_s, a.t_e, a.pe_ids) for a in many]
    if ours != want or ours != [True, True, False, False]:
        fail(f"cancel_many: {ours} vs the oracle's {want}")
    if sess.records() != oracle.records():
        fail("records differ from the oracle after the cancels")
    snap = sess.snapshot()
    _, once = _decisions([sess.offer(rest)])
    sess.restore(snap)
    _, again = _decisions([sess.offer(rest)])
    want = oracle.run(rest)
    if once != again or again != want:
        fail("snapshot/restore: the replayed offer decides differently")
    t = rest[-1].t_a + 500
    sess.tick(t)
    oracle.tick(t)
    if sess.records() != oracle.records():
        fail("records differ from the oracle after tick")
    m = sess.metrics()
    print(f"session verbs: cancel x2, cancel_many {ours}, snapshot/restore "
          f"and tick on {len(first) + len(rest)} paper jobs identical to "
          f"BackfillOracle (cancelled {m['cancelled']}, released "
          f"{m['released']})")


def host_engines(jobs, dev) -> None:
    """Sessions on the host (numpy) and list engines make the device
    session's decisions and records."""
    from repro_torch.api import ReservationService, ServiceConfig
    from repro_torch.core.types import Policy

    for engine, n in (("host", 500), ("list", 200)):
        few = jobs[:n]
        t0 = time.perf_counter()
        host = ReservationService(ServiceConfig(
            n_pe=1024, policy=Policy.PE_W, engine=engine)).session()
        _, got = _decisions([host.offer(few)])
        host_s = time.perf_counter() - t0
        card = ReservationService(ServiceConfig(
            n_pe=1024, policy=Policy.PE_W, device=dev)).session()
        _, want = _decisions([card.offer(few)])
        if got != want or host.records() != card.records():
            fail(f"engine={engine!r} session differs from the device "
                 f"session {_first_diff(got, want)}")
        print(f"{engine} session: {n} paper jobs identical to the device "
              f"session ({n / host_s:.1f} requests/s on the host)")


# ---------------------------------------------------------------------------
# backfilling: the deferral queue through admit_stream_grow and a session
# ---------------------------------------------------------------------------

BF_QUEUE = 8              # deferral-queue entries of every backfill run
BF_JOBS = 400             # the backfill and tenancy phases' paper jobs
BF_OFFERS = (8, 50)       # the cancelling session: offers x requests each


def _state_records(state):
    from repro_torch.core.batch import mask32_to_ids
    return [(int(t), frozenset(mask32_to_ids(o)))
            for t, o in zip(state.tl.times.cpu().numpy(),
                            state.tl.occ.cpu().numpy()) if t < T_INF]


def _bf_stream(jobs, dev, mode, *, rspec=None, index_tile=None,
               tenants=None):
    """``admit_stream_grow`` of ``jobs`` under ``mode`` on the card (PE_W,
    capacity 128, 256 pending slots, a queue of ``BF_QUEUE`` entries; no
    queue under ``none``, as on the main path; ``tenants`` a TenantSpec
    whose table rides the state); launches counted."""
    import torch
    from repro_torch.core import batch as B
    from repro_torch.core import timeline as T
    from repro_torch.core.types import Policy
    from repro_torch.kernels import availscan as K
    from repro_torch.tenancy import init_table

    Q = 0 if mode == "none" else BF_QUEUE
    table = None if tenants is None else init_table(tenants, 256, Q, dev)
    state = T.init_state(128, 1024, 256, device=dev, park_capacity=Q,
                         rspec=rspec, index_tile=index_tile, tenants=table)
    batch = B.requests_to_batch(jobs, dev,
                                0 if rspec is None else rspec.R - 1,
                                with_tenant=tenants is not None)
    stats = B.StreamStats()
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    out, dec = B.admit_stream_grow(state, batch, Policy.PE_W, n_pe=1024,
                                   backfill=mode, stats=stats)
    acc, ts, parked = (x.cpu().numpy() for x in (dec.accepted, dec.t_s,
                                                 dec.parked))
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    return dict(out=out, dec=dec, stats=stats, wall=wall, launches=launches,
                trace=[(bool(a), int(t)) for a, t in zip(acc, ts)],
                parked=[bool(p) for p in parked])


def _searches(st) -> int:
    """Select launches a run needs: one per full admit search, plus the
    retry sweep's, the displacements' and the fleet probes' searches."""
    return (st.steps - st.early_rejects + st.retry_searches
            + st.displace_searches + st.probe_searches)


def _hold_bf(label, run, oracle, jobs, select: str) -> None:
    """A backfill run against ``oracle`` run on the same jobs: decisions,
    parked flags, records, queue and counters; one select launch per
    search."""
    from repro_torch.core.batch import parked_entries
    want = [oracle.admit(j) for j in jobs]
    if run["trace"] != [w[:2] for w in want]:
        fail(f"{label}: decisions differ from the oracle "
             f"{_first_diff(run['trace'], [w[:2] for w in want])}")
    if run["parked"] != [w[2] for w in want]:
        fail(f"{label}: parked flags differ from the oracle")
    out = run["out"]
    if _state_records(out) != oracle.records():
        fail(f"{label}: records differ from the oracle's")
    if parked_entries(out) != oracle.pending():
        fail(f"{label}: the deferral queue differs from the oracle's")
    got = (0, 0, 0) if not out.park_capacity else (
        int(out.n_parked), int(out.n_promoted), int(out.n_moved))
    if got != (oracle.n_parked, oracle.n_promoted, oracle.n_moved):
        fail(f"{label}: counters {got} vs the oracle's "
             f"{(oracle.n_parked, oracle.n_promoted, oracle.n_moved)}")
    st = run["stats"]
    if run["launches"][select] != _searches(st):
        fail(f"{label}: {run['launches'][select]} {select} launches for "
             f"{_searches(st)} searches ({st})")


def _bf_line(label, run, n) -> str:
    st = run["stats"]
    return (f"{label}: {n / run['wall']:.1f} requests/s, host syncs "
            f"{st.host_syncs} = {st.host_syncs / n:.3f} per request, "
            f"searches {st.steps} admit ({st.early_rejects} early rejects) + "
            f"{st.retry_searches} retry + {st.displace_searches} "
            f"displacement = {_searches(st)} select launches, "
            f"{st.displacements} displacements tried")


def backfill_streams(jobs, plain, dev, rows: dict) -> dict:
    """``none``, conservative and EASY on the paper stream through
    ``admit_stream_grow``, held against ``BackfillOracle``; conservative
    decides as the main path."""
    from repro_torch.core.hostsched import BackfillOracle
    from repro_torch.core.types import Policy

    n = len(jobs)
    runs = {m: _bf_stream(jobs, dev, m)
            for m in ("none", "conservative", "easy")}
    if runs["none"]["trace"] != plain.decisions:
        fail("backfill none: decisions differ from the main path")
    if runs["conservative"]["trace"] != plain.decisions:
        fail("conservative backfilling decides differently from the main "
             f"path {_first_diff(runs['conservative']['trace'], plain.decisions)}")
    for mode in ("none", "conservative", "easy"):
        _hold_bf(f"backfill {mode}", runs[mode],
                 BackfillOracle(1024, Policy.PE_W, mode,
                                park_capacity=BF_QUEUE), jobs,
                 "availscan_select")
        print(_bf_line(f"backfill {mode}", runs[mode], n))
    cons, easy = runs["conservative"], runs["easy"]
    if not int(cons["out"].n_parked) or int(cons["out"].n_moved):
        fail("conservative: nothing parked, or a reservation moved")
    if not int(easy["out"].n_parked) or not easy["stats"].displacements \
            or not int(easy["out"].n_moved):
        fail("EASY: nothing parked, no displacement tried, or none moved")
    for mode in ("conservative", "easy"):
        out = runs[mode]["out"]
        print(f"backfill {mode}: accepted {sum(a for a, _ in runs[mode]['trace'])}"
              f" of {n}, parked {int(out.n_parked)}, promoted "
              f"{int(out.n_promoted)}, moved {int(out.n_moved)}; identical "
              f"to BackfillOracle")
    rows["availscan_select"]["launches_backfill"] = {
        m: runs[m]["launches"]["availscan_select"] for m in runs}
    return runs


def backfill_session(jobs, dev, rows: dict) -> None:
    """An EASY pipelined session that cancels the queue's tail after each
    offer, held against the oracle doing the same; one snapshot and
    restore mid-stream."""
    import torch
    from repro_torch.api import ReservationService, ServiceConfig
    from repro_torch.core.hostsched import BackfillOracle
    from repro_torch.core.types import Policy
    from repro_torch.kernels import availscan as K

    n_offers, size = BF_OFFERS
    jobs = jobs[:n_offers * size]
    sess = ReservationService(ServiceConfig(
        n_pe=1024, policy=Policy.PE_W, capacity=128, pending_capacity=256,
        backfill="easy", backfill_queue=BF_QUEUE, chunk_size=64,
        ring_capacity=256, device=dev)).session()
    oracle = BackfillOracle(1024, Policy.PE_W, "easy",
                            park_capacity=BF_QUEUE)
    got, want, cancels = [], [], 0
    K.reset_launches()
    wall = 0.0
    for k in range(n_offers):
        piece = jobs[k * size:(k + 1) * size]
        t0 = time.perf_counter()
        if k == n_offers // 2:
            snap = sess.snapshot()
            once = _decisions([sess.offer(piece)])[1]
            sess.restore(snap)
        res = sess.offer(piece)
        got += _decisions([res])[1]
        tail = sess.pending()
        if tail:
            e = tail[-1]
            ok = sess.cancel(t_s=e["t_s"], t_e=e["t_e"], pe_ids=e["pe_ids"])
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        want += [oracle.admit(j)[:2] for j in piece]
        if k == n_offers // 2 and once != got[-size:]:
            fail("backfill session: the offer replayed after restore "
                 "decides differently")
        if tail != oracle.pending():
            fail(f"backfill session: the queue differs from the oracle's "
                 f"after offer {k}")
        if tail:
            if not ok or not oracle.cancel(e["t_s"], e["t_e"], e["pe_ids"]):
                fail(f"backfill session: cancelling {e} failed")
            cancels += 1
    launches = K.LAUNCHES["availscan_select"]
    if got != want:
        fail(f"backfill session: decisions differ from the oracle "
             f"{_first_diff(got, want)}")
    if sess.records() != oracle.records():
        fail("backfill session: records differ from the oracle's")
    m = sess.metrics()
    moves = {e: sum(1 for mv in oracle.moves if mv[4] == e)
             for e in ("retry", "displace")}
    if (m["n_parked"], m["n_promoted"], m["n_moved"]) != (
            oracle.n_parked, oracle.n_promoted, oracle.n_moved):
        fail(f"backfill session: counters differ from the oracle's "
             f"({m['n_parked']}, {m['n_promoted']}, {m['n_moved']})")
    if not moves["retry"] or not moves["displace"] or not m["n_parked"]:
        fail(f"backfill session: nothing parked or no move of a kind {moves}")
    # the snapshot's discarded offer ran its searches too
    st = sess._backend.stats
    if launches != _searches(st):
        fail(f"backfill session: {launches} select launches for "
             f"{_searches(st)} searches")
    rows["availscan_select"]["launches_backfill"]["session"] = launches
    n = len(jobs)
    print(f"backfill session (EASY, pipelined, chunks of 64): {n_offers} "
          f"offers of {size}, {cancels} cancels of the queue's tail: "
          f"accepted {sum(a for a, _ in got)}, moves {moves['retry']} by the "
          f"retry sweep and {moves['displace']} by displacement, parked "
          f"{m['n_parked']}; identical to BackfillOracle, snapshot/restore "
          f"replays alike; {(n + size) / wall:.1f} requests/s over the "
          f"session's verbs ({n + size} requests admitted, the replayed "
          f"offer included; the oracle excluded), host syncs "
          f"{m['host_syncs']} = {m['host_syncs'] / (n + size):.3f} per "
          f"request, select launches {launches} = "
          f"{m['steps']} steps - {m['early_rejects']} early rejects + "
          f"{m['retry_searches']} retry + {m['displace_searches']} "
          f"displacement searches")


def backfill_mr(jobs_mr, dev, rows: dict) -> dict:
    """EASY on the stamped paper stream at R = 4, held against
    ``MultiResourceOracle``."""
    from repro_torch.core.hostsched import MultiResourceOracle
    from repro_torch.core.resources import ResourceSpec
    from repro_torch.core.types import Policy

    spec = ResourceSpec(MR_UNITS)
    run = _bf_stream(jobs_mr, dev, "easy", rspec=spec)
    _hold_bf("backfill R = 4", run,
             MultiResourceOracle(spec, Policy.PE_W, "easy",
                                 park_capacity=BF_QUEUE), jobs_mr,
             "availscan_select_mr")
    out = run["out"]
    if not int(out.n_parked) or not run["stats"].displacements:
        fail("backfill R = 4: nothing parked or no displacement tried")
    rows["availscan_select_mr"]["launches_backfill"] = \
        run["launches"]["availscan_select_mr"]
    print(_bf_line("backfill R = 4 (EASY)", run, len(jobs_mr)))
    print(f"backfill R = 4: accepted {sum(a for a, _ in run['trace'])}, "
          f"parked {int(out.n_parked)}, moved {int(out.n_moved)}; identical "
          f"to MultiResourceOracle")
    return run


def backfill_indexed(jobs, easy, dev, rows: dict) -> dict:
    """EASY with the availability index (tile 16): every Decision field
    and the queue equal the index-free run's."""
    import torch
    from repro_torch.core.batch import parked_entries

    run = _bf_stream(jobs, dev, "easy", index_tile=16)
    for f in easy["dec"]._fields:
        if not torch.equal(getattr(run["dec"], f), getattr(easy["dec"], f)):
            fail(f"backfill indexed: Decision.{f} differs from the "
                 f"index-free run")
    if parked_entries(run["out"]) != parked_entries(easy["out"]):
        fail("backfill indexed: the queue differs from the index-free run")
    st = run["stats"]
    if run["launches"]["availscan_select"] != _searches(st) or \
            run["launches"]["availscan"] != st.early_rejects:
        fail(f"backfill indexed: launches {run['launches']} for {st}")
    rows["availscan"]["launches_backfill_indexed"] = \
        run["launches"]["availscan"]
    print(_bf_line("backfill EASY, index tile 16", run, len(jobs)))
    print(f"backfill indexed: identical to the index-free EASY run; "
          f"{st.early_rejects} early rejects, {st.reject_displacements} of "
          f"them followed by a displacement")
    return run


def backfill_profile(jobs, dev, n_steps: int = 300) -> None:
    """Kernels per EASY step in a :func:`profiled_window`, and the host
    syncs of a step whose queue stays idle against a ``none`` step."""
    import torch
    from repro_torch.core import batch as B
    from repro_torch.core import timeline as T
    from repro_torch.core.types import Policy

    def stream(js, mode, stats=None, policy=Policy.PE_W):
        state = T.init_state(128, 1024, 256, device=dev,
                             park_capacity=0 if mode == "none" else BF_QUEUE)
        return B.admit_stream(state, B.requests_to_batch(js, dev),
                              policy, mode, n_pe=1024, stats=stats)

    few = jobs[:n_steps]
    stream(few, "easy")                                            # warm
    torch.cuda.synchronize()
    stats = B.StreamStats()
    with profiled_window() as prof:
        t0 = time.perf_counter()
        out, _ = stream(few, "easy", stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = profiled_events(prof)
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    n_kernels = sum(e.count for e in events)
    print(f"profiled {n_steps} EASY steps: wall {wall:.3f} s "
          f"({wall / n_steps * 1e3:.3f} ms/step, profiler on), device busy "
          f"{busy_s:.4f} s, idle share {1 - busy_s / wall:.4f}, "
          f"{n_kernels / n_steps:.1f} kernels/step, "
          f"{stats.host_syncs / n_steps:.3f} host syncs/step, "
          f"{_searches(stats) / n_steps:.3f} searches/step, parked "
          f"{int(out.n_parked)}")
    # an idle queue: under First Fit one-PE requests start at their
    # ready time, so nothing ever parks
    idle = [dataclasses.replace(j, n_pe=1) for j in few]
    syncs = {}
    for mode in ("none", "easy"):
        st = B.StreamStats()
        out, dec = stream(idle, mode, st, Policy.FF)
        if mode == "easy" and (int(out.n_parked) or bool(dec.parked.any())):
            fail("idle-queue stream parked a request")
        syncs[mode] = st.host_syncs
    if syncs["easy"] != syncs["none"]:
        fail(f"an EASY step with an idle queue reads more than a none step: "
             f"{syncs}")
    print(f"idle queue ({n_steps} one-PE requests, First Fit, nothing "
          f"parks): host "
          f"syncs none {syncs['none']}, EASY {syncs['easy']}")


# ---------------------------------------------------------------------------
# multi-tenant admission: the quota gate, fair share, reaping, telemetry
# ---------------------------------------------------------------------------

N_TENANTS = 4              # tenant = i % 4, as benchmarks/bench_tenancy.py
TN_GRACE = 300             # the reaping session's grace window (seconds)


def tenanted(jobs):
    """The stream with ``tenant = i % N_TENANTS``."""
    return [dataclasses.replace(j, tenant=i % N_TENANTS)
            for i, j in enumerate(jobs)]


def tenant_spec(jobs, weights=(1.0, 4.0, 2.0, 1.0), grace=None):
    """The slice's spec: tenants 0 and 2 may use half of the PE-seconds
    they offer on this stream, tenant 1 holds at most 6 reservations."""
    from repro_torch.tenancy import TenantSpec
    offered = [0.0] * N_TENANTS
    for j in jobs:
        offered[j.tenant] += j.n_pe * j.t_du
    return TenantSpec(weights=weights,
                      quotas=(offered[0] / 2, None, offered[2] / 2, None),
                      max_live=(None, 6, None, None), grace=grace)


def _hold_table(label, table, accounts) -> None:
    """Every telemetry field of a device table against the oracle's
    accounts, bit for bit, and its ownership columns against ``live``."""
    from repro_torch.tenancy import snapshot
    got, want = snapshot(table), accounts.snapshot()
    for f, v in want.items():
        if not np.array_equal(np.asarray(got[f]), np.asarray(v)) or \
                np.asarray(got[f]).dtype != np.asarray(v).dtype:
            fail(f"{label}: tenant table field {f} {got[f]} differs from "
                 f"the oracle's {v}")
    owners = np.concatenate([table.pend_tenant.cpu().numpy(),
                             table.park_tenant.cpu().numpy()])
    held = np.bincount(owners[owners >= 0], minlength=N_TENANTS)
    if not np.array_equal(held, got["live"]):
        fail(f"{label}: owned slots {held} vs live {got['live']}")


def _same_run(label, run, base) -> None:
    """A tenanted run against the same stream's tenancy-free run: every
    Decision field, records, queue (owners stripped), queue counters and
    host syncs."""
    import torch
    from repro_torch.core.batch import parked_entries
    for f in base["dec"]._fields:
        if not torch.equal(getattr(run["dec"], f), getattr(base["dec"], f)):
            fail(f"{label}: Decision.{f} differs from the tenancy-free run")
    out, ref = run["out"], base["out"]
    if _state_records(out) != _state_records(ref):
        fail(f"{label}: records differ from the tenancy-free run")
    strip = [{k: v for k, v in e.items() if k not in ("tenant", "t_a")}
             for e in parked_entries(out)]
    if strip != parked_entries(ref):
        fail(f"{label}: the queue differs from the tenancy-free run")
    if out.park_capacity and (int(out.n_parked), int(out.n_promoted),
                              int(out.n_moved)) != (
            int(ref.n_parked), int(ref.n_promoted), int(ref.n_moved)):
        fail(f"{label}: queue counters differ from the tenancy-free run")
    st, st0 = run["stats"], base["stats"]
    if st.host_syncs != st0.host_syncs:
        fail(f"{label}: {st.host_syncs} host syncs against the "
             f"tenancy-free run's {st0.host_syncs}")


def tenancy_streams(jobs, bf, dev, rows: dict) -> None:
    """EASY on the tenanted paper stream with quotas, a live cap and
    skewed weights, held against ``TenantOracle``; the same limits with
    equal weights for the fair share's effect."""
    from repro_torch.core.hostsched import TenantOracle
    from repro_torch.core.types import Policy

    n = len(jobs)
    spec = tenant_spec(jobs)
    run = _bf_stream(jobs, dev, "easy", tenants=spec)
    oracle = TenantOracle(1024, Policy.PE_W, "easy", spec,
                          park_capacity=BF_QUEUE)
    _hold_bf("tenancy EASY", run, oracle, jobs, "availscan_select")
    table = run["out"].tenants
    _hold_table("tenancy EASY", table, oracle.accounts)
    q = table.n_quota_rejected.cpu().numpy()
    if not (q[0] and q[2] and q[1]):
        fail(f"tenancy EASY: gated rejections per tenant {q}: the quotas "
             f"of tenants 0 and 2 and the cap of tenant 1 must all bite")
    flat = _bf_stream(jobs, dev, "easy", tenants=tenant_spec(
        jobs, weights=(1.0,) * N_TENANTS))
    n_diff = sum(a != b for a, b in zip(run["trace"], flat["trace"]))
    rows["availscan_select"]["launches_tenancy"] = {
        "easy": run["launches"]["availscan_select"],
        "easy_equal_weights": flat["launches"]["availscan_select"]}
    print(_bf_line("tenancy EASY", run, n))
    print(_bf_line("backfill EASY (no tenants, same stream)", bf["easy"], n))
    m = {f: getattr(table, f).cpu().numpy().tolist() for f in (
        "n_accepted", "n_rejected", "n_quota_rejected", "n_parked")}
    print(f"tenancy EASY: quotas {spec.quotas}, max_live {spec.max_live}, "
          f"weights {spec.weights}: per tenant {m}; used "
          f"{table.used.cpu().numpy().tolist()}; identical to TenantOracle "
          f"(decisions, parked, records, queue with tenant/t_a, every "
          f"table field); {n_diff} of {n} decisions differ from the same "
          f"limits with equal weights")


def tenancy_neutral(jobs, plain, bf, dev, rows: dict) -> None:
    """Four equal weights and no limits: identical to the tenancy-free
    runs (EASY, ``none``, R = 4, index tile 16), host syncs included."""
    from repro_torch.tenancy import TenantSpec

    spec = TenantSpec(weights=(1.0,) * N_TENANTS)
    n = len(jobs)
    cases = (("easy", dict(), bf["easy"], "availscan_select"),
             ("none", dict(), bf["none"], "availscan_select"),
             ("easy", dict(rspec=_mr_spec()), bf["mr"], "availscan_select_mr"),
             ("easy", dict(index_tile=16), bf["indexed"],
              "availscan_select"))
    out = {}
    for mode, kw, base, select in cases:
        label = (f"tenancy neutral {mode}"
                 + (" R = 4" if "rspec" in kw else "")
                 + (" tile 16" if "index_tile" in kw else ""))
        js = stamp(jobs, MR_UNITS) if "rspec" in kw else jobs
        run = _bf_stream(js, dev, mode, tenants=spec, **kw)
        _same_run(label, run, base)
        st = run["stats"]
        if run["launches"][select] != _searches(st):
            fail(f"{label}: {run['launches'][select]} {select} launches for "
                 f"{_searches(st)} searches")
        if "index_tile" in kw:
            if run["launches"]["availscan"] != st.early_rejects:
                fail(f"{label}: {run['launches']['availscan']} availscan "
                     f"launches for {st.early_rejects} early rejects")
            rows["availscan"]["launches_tenancy_indexed"] = \
                run["launches"]["availscan"]
        if mode == "none" and run["trace"] != plain.decisions:
            fail(f"{label}: decisions differ from the main path")
        out[label] = run["launches"][select]
        print(_bf_line(label, run, n) + f"; identical to the tenancy-free "
              f"run ({base['stats'].host_syncs / n:.3f} syncs per request "
              f"there)")
    rows["availscan_select"]["launches_tenancy"].update(
        {k: v for k, v in out.items() if "R = 4" not in k})
    rows["availscan_select_mr"]["launches_tenancy"] = {
        k: v for k, v in out.items() if "R = 4" in k}


def _mr_spec():
    from repro_torch.core.resources import ResourceSpec
    return ResourceSpec(MR_UNITS)


def tenancy_session(jobs, dev, rows: dict) -> None:
    """A pipelined tenanted session with ``auto_release=False`` that reaps
    after each offer, against ``TenantOracle``; then idle telemetry
    polls, which must read nothing."""
    import torch
    from repro_torch.api import ReservationService, ServiceConfig
    from repro_torch.api import service as S
    from repro_torch.core.hostsched import TenantOracle
    from repro_torch.core.types import Policy
    from repro_torch.kernels import availscan as K

    n_offers, size = BF_OFFERS
    jobs = jobs[:n_offers * size]
    spec = tenant_spec(jobs, grace=TN_GRACE)
    sess = ReservationService(ServiceConfig(
        n_pe=1024, policy=Policy.PE_W, capacity=128, pending_capacity=256,
        chunk_size=64, ring_capacity=256, auto_release=False, tenants=spec,
        device=dev)).session()
    oracle = TenantOracle(1024, Policy.PE_W, "none", spec,
                          auto_release=False)
    got, want, reaped = [], [], []
    K.reset_launches()
    wall = 0.0
    for k in range(n_offers):
        piece = jobs[k * size:(k + 1) * size]
        t0 = time.perf_counter()
        res = sess.offer(piece)
        got += _decisions([res])[1]
        r = sess.tick(piece[-1].t_a)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        want += [oracle.admit(j)[:2] for j in piece]
        if r != oracle.reap(piece[-1].t_a):
            fail(f"tenancy session: reaped {r} after offer {k}, the oracle "
                 f"{oracle.n_reaped - sum(reaped)}")
        reaped.append(r)
    launches = K.LAUNCHES["availscan_select"]
    if got != want:
        fail(f"tenancy session: decisions differ from the oracle "
             f"{_first_diff(got, want)}")
    if sess.records() != oracle.records():
        fail("tenancy session: records differ from the oracle's")
    _hold_table("tenancy session", sess._backend._state.tenants,
                oracle.accounts)
    m = sess.metrics()
    if m["reaped"] != oracle.n_reaped or not oracle.n_reaped:
        fail(f"tenancy session: reaped {m['reaped']}, oracle "
             f"{oracle.n_reaped}")
    st = sess._backend.stats
    if launches != _searches(st):
        fail(f"tenancy session: {launches} select launches for "
             f"{_searches(st)} searches")
    refreshes = []
    real = S._StreamBackend._refresh_dev_metrics
    sess._backend._refresh_dev_metrics = \
        lambda: refreshes.append(1) or real(sess._backend)
    syncs = st.host_syncs
    for i in range(20):
        v = sess.metrics(tenant=i % N_TENANTS)
    if refreshes or st.host_syncs != syncs:
        fail(f"tenancy session: 20 idle polls refreshed {len(refreshes)} "
             f"times, {st.host_syncs - syncs} host syncs")
    rows["availscan_select"]["launches_tenancy"]["session"] = launches
    n = len(jobs)
    print(f"tenancy session (pipelined, chunks of 64, auto_release=False, "
          f"grace {TN_GRACE}): {n_offers} offers of {size}, a tick after "
          f"each: accepted {sum(a for a, _ in got)}, reaped {m['reaped']} "
          f"(n_reaped {m['tenants']['n_reaped'].tolist()}, live "
          f"{m['tenants']['live'].tolist()}); identical to TenantOracle; "
          f"{n / wall:.1f} requests/s over offer + tick, host syncs "
          f"{st.host_syncs} = {st.host_syncs / n:.3f} per request, select "
          f"launches {launches} = {st.steps} steps - {st.early_rejects} "
          f"early rejects; 20 idle metrics(tenant=i) polls: 0 refreshes, "
          f"0 host syncs (tenant 3: live {v['live']}, acc_ewma "
          f"{v['acc_ewma']})")


def tenancy_profile(jobs, dev, n_steps: int = 300) -> None:
    """Kernels per tenanted EASY step in a :func:`profiled_window`, next
    to the same steps without tenants."""
    import torch
    from repro_torch.core import batch as B
    from repro_torch.core import timeline as T
    from repro_torch.core.types import Policy
    from repro_torch.kernels import availscan as K
    from repro_torch.tenancy import init_table

    few = jobs[:n_steps]
    spec = tenant_spec(jobs)

    def stream(stats=None, tenants=True):
        table = init_table(spec, 256, BF_QUEUE, dev) if tenants else None
        state = T.init_state(128, 1024, 256, device=dev,
                             park_capacity=BF_QUEUE, tenants=table)
        return B.admit_stream(state, B.requests_to_batch(
            few, dev, with_tenant=tenants), Policy.PE_W, "easy", n_pe=1024,
            stats=stats)

    for tenants in (False, True):
        stream(tenants=tenants)                                   # warm
        torch.cuda.synchronize()
        stats = B.StreamStats()
        K.reset_launches()
        with profiled_window() as prof:
            t0 = time.perf_counter()
            out, _ = stream(stats, tenants)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if K.LAUNCHES["availscan_select"] != _searches(stats):
            fail(f"tenancy profile: {K.LAUNCHES['availscan_select']} "
                 f"select launches for {_searches(stats)} searches")
        events = profiled_events(prof)
        busy_s = sum(e.self_device_time_total for e in events) / 1e6
        n_kernels = sum(e.count for e in events)
        print(f"profiled {n_steps} EASY steps, tenants "
              f"{'on' if tenants else 'off'}: wall {wall:.3f} s "
              f"({wall / n_steps * 1e3:.3f} ms/step, profiler on), device "
              f"busy {busy_s:.4f} s, idle share {1 - busy_s / wall:.4f}, "
              f"{n_kernels / n_steps:.1f} kernels/step, "
              f"{stats.host_syncs / n_steps:.3f} host syncs/step, "
              f"{_searches(stats) / n_steps:.3f} searches/step")


GRID_LOADS = (0.75, 1.0, 1.25)   # the grid's arrival factors (Figs. 4-5)
GRID_JOBS = 300                  # jobs per paper-grid cell (paper: 10,000)
GRID_BF_JOBS = 200               # jobs per backfill / mix grid cell
ENS_SIZES = (1024, 768, 512)     # the ensemble session's machine sizes
ENS_OFFERS = (10, 60)            # its offers x requests per lane


def _grid_run(label, spec, dev, rows, kernel: str, **run):
    """``simulate_grid`` of ``spec`` on the card, cross-checked against
    the host oracles, launches counted; one select launch per step."""
    import torch
    from repro_torch.kernels import availscan as K
    from repro_torch.sim import simulate_grid

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    res = simulate_grid(spec, capacity=128, pending_capacity=256,
                        device=dev, record_decisions=True, **run)
    launches = dict(K.LAUNCHES)
    total = time.perf_counter() - t0
    m = res.metrics
    searches = (m["steps"] - m["early_rejects"]
                + m.get("retry_searches", 0) + m.get("displace_searches", 0))
    if launches[kernel] != searches or not launches[kernel]:
        fail(f"{label}: {launches[kernel]} {kernel} launches for "
             f"{searches} searches")
    n_req = int(res.n_jobs.sum())
    print(f"{label}: {res.n_cells} cells x {spec.n_jobs} jobs at "
          f"{spec.n_pe} PEs, accepted {int(res.n_accepted.sum())}/{n_req}; "
          f"identical to the host oracles in every cell (the call "
          f"{total:.1f} s with them); grid {res.wall_seconds:.3f} s = "
          f"{res.cells_per_sec:.3f} cells/s = "
          f"{n_req / res.wall_seconds:.1f} requests/s; {m['steps']} lane "
          f"steps, {kernel} launches {launches[kernel]}, host syncs "
          f"{m['host_syncs']} = {m['host_syncs'] / m['steps']:.3f} per lane "
          f"step, growths {m['growths']}, capacity {m['capacity']}")
    rows[kernel].setdefault("launches_grid", {})[label] = launches[kernel]
    return res


def grid_paper(dev, rows: dict) -> None:
    """The Section-6 matrix at the paper's width: 7 policies x 3 loads,
    one seed, 300 jobs a cell, held against the host event loop, and
    the paper's claims on it."""
    from repro_torch.core.types import ALL_POLICIES, Policy
    from repro_torch.sim import GridSpec, WorkloadParams

    spec = GridSpec(policies=ALL_POLICIES, arrival_factors=GRID_LOADS,
                    seeds=(0,), flex_factors=(3.0,), base=WorkloadParams(),
                    n_pe=1024, n_jobs=GRID_JOBS)
    res = _grid_run("grid_paper", spec, dev, rows, "availscan_select",
                    cross_check=True)
    acc, sd = res.policy_acceptance(), res.policy_slowdown()
    for p in res.policies:
        print(f"  {p:7s} acceptance {acc[p]:.4f} slowdown {sd[p]:.4f}")
    if acc[Policy.PE_W.value] < max(acc.values()) - 0.01:
        fail(f"grid_paper: PE_W acceptance {acc['PE_W']:.4f} not within "
             f"0.01 of the best {max(acc.values()):.4f}")
    if sd[Policy.FF.value] != min(sd.values()):
        fail(f"grid_paper: FF slowdown {sd['FF']:.4f} is not the lowest")
    print("grid_paper: PE_W within 0.01 of the best acceptance, FF the "
          "lowest slowdown")


def grid_profile(dev, n_jobs: int = GRID_JOBS) -> None:
    """Kernels, host syncs and the device's idle share per lane step: a
    3-lane grid (PE_W, FF, DU_B) of ``grid_paper``'s cells, ``n_jobs``
    jobs a lane from an empty timeline as :func:`profile_steps` runs
    them, in a counted :func:`profiled_window`."""
    import torch
    from repro_torch.core.types import Policy
    from repro_torch.sim import GridSpec, WorkloadParams, simulate_grid

    spec = GridSpec(policies=(Policy.PE_W, Policy.FF, Policy.DU_B),
                    arrival_factors=(1.0,), seeds=(0,), flex_factors=(3.0,),
                    base=WorkloadParams(), n_pe=1024, n_jobs=n_jobs)
    simulate_grid(spec, device=dev)                             # warm
    torch.cuda.synchronize()
    with profiled_window() as prof:
        t0 = time.perf_counter()
        res = simulate_grid(spec, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = profiled_events(prof)
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    n_kernels = sum(e.count for e in events)
    steps = res.metrics["steps"]
    print(f"profiled grid ({res.n_cells} lanes x {n_jobs} jobs): wall "
          f"{wall:.3f} s ({wall / steps * 1e3:.3f} ms per lane step, "
          f"profiler on), device busy {busy_s:.4f} s, idle share "
          f"{1 - busy_s / wall:.4f}, {n_kernels / steps:.1f} kernels and "
          f"{res.metrics['host_syncs'] / steps:.3f} host syncs per lane "
          f"step")


def grid_backfill(dev, rows: dict) -> None:
    """PE_W, DU_B and FF x {none, easy, conservative} at 1024 PEs, one
    load, against ``BackfillOracle``; conservative decides as none."""
    from repro_torch.core.types import Policy
    from repro_torch.sim import GridSpec, WorkloadParams

    spec = GridSpec(policies=(Policy.PE_W, Policy.DU_B, Policy.FF),
                    arrival_factors=(1.0,), seeds=(0,), flex_factors=(3.0,),
                    backfill_modes=("none", "easy", "conservative"),
                    base=WorkloadParams(), n_pe=1024, n_jobs=GRID_BF_JOBS,
                    park_capacity=BF_QUEUE)
    res = _grid_run("grid_backfill", spec, dev, rows, "availscan_select",
                    cross_check=True)
    b = {m: i for i, m in enumerate(res.backfill_modes)}
    for i, p in enumerate(res.policies):
        if res.decisions[i][b["conservative"]] != res.decisions[i][b["none"]]:
            fail(f"grid_backfill: {p} conservative decides unlike none")
        print(f"  {p:7s} accepted none / easy / conservative "
              + " / ".join(str(int(res.n_accepted[i, b[m]].sum()))
                           for m in ("none", "easy", "conservative")))
    print("grid_backfill: conservative decides as none for every policy")


def grid_mixes(dev, rows: dict) -> None:
    """A tenant-mix grid (none, and the skewed 4-tenant spec) against
    ``TenantOracle``, and a resource-mix grid on the R = 4 machine
    against ``MultiResourceOracle`` (the ``_mr`` select kernel)."""
    from repro_torch.core.types import Policy
    from repro_torch.sim import GridSpec, WorkloadParams, generate_filtered

    spec = GridSpec(policies=(Policy.PE_W, Policy.FF), arrival_factors=(1.0,),
                    seeds=(0,), flex_factors=(3.0,),
                    backfill_modes=("none", "easy"), base=WorkloadParams(),
                    n_pe=1024, n_jobs=GRID_BF_JOBS, park_capacity=BF_QUEUE)
    jobs = sorted(generate_filtered(spec.workload_params(1.0, 0, 3.0),
                                    max_pe=1024), key=lambda j: j.t_a)
    mixed = dataclasses.replace(spec, tenant_mixes=(
        None, tenant_spec(tenanted(jobs))))
    res = _grid_run("grid_mixes_tenants", mixed, dev, rows,
                    "availscan_select", cross_check=True)
    print(f"  accepted without / with the spec: "
          f"{res.n_accepted[..., 0].ravel().tolist()} / "
          f"{res.n_accepted[..., 1].ravel().tolist()}")
    if not (res.n_accepted[..., 1] < res.n_accepted[..., 0]).any():
        fail("grid_mixes: the tenant spec's limits never bit")
    rmix = GridSpec(policies=(Policy.PE_W, Policy.FF), arrival_factors=(1.0,),
                    seeds=(0,), flex_factors=(3.0,), base=WorkloadParams(),
                    n_pe=1024, n_jobs=GRID_BF_JOBS, resources=MR_UNITS,
                    resource_mixes=(None, (2.0, 1.0, 0.5)))
    res = _grid_run("grid_mixes_resources", rmix, dev, rows,
                    "availscan_select_mr", cross_check=True)
    print(f"  accepted PE-only / (2, 1, 0.5)-intensity demands: "
          f"{res.n_accepted[..., 0].ravel().tolist()} / "
          f"{res.n_accepted[..., 1].ravel().tolist()}")


def _lane(res, lane: int):
    """Lane ``lane``'s (accepted, t_s) decisions of an ensemble offer."""
    acc = res.decision.accepted[lane].cpu().numpy()
    ts = res.decision.t_s[lane].cpu().numpy()
    v = np.asarray(res.valid)[lane]
    return [(bool(a), int(t) if a else -1) for a, t in zip(acc[v], ts[v])]


def ensemble_session(jobs, dev, rows: dict) -> None:
    """A pipelined 3-lane session (machine sizes 1024 / 768 / 512,
    policies PE_W / FF / DU_B, chunks of 64), each lane held against a
    one-lane session of its size and policy; then a tick, a cancel on
    lane 1 and a snapshot / restore with a re-offer.  Then a 2-lane
    session with one tenanted lane that reaps (``auto_release=False``)."""
    import torch
    from repro_torch.api import ReservationService, ServiceConfig
    from repro_torch.core.batch import decisions_to_allocations
    from repro_torch.core.ensemble import lane_of
    from repro_torch.core.types import Policy
    from repro_torch.kernels import availscan as K

    n_offers, size = ENS_OFFERS
    jobs = jobs[:n_offers * size]
    pols = (Policy.PE_W, Policy.FF, Policy.DU_B)
    base = dict(n_pe=1024, capacity=128, pending_capacity=256, chunk_size=64,
                ring_capacity=256, device=dev)
    ens = ReservationService(ServiceConfig(
        lanes=3, machine_sizes=ENS_SIZES, **base)).session()
    ones = [ReservationService(ServiceConfig(
        machine_sizes=(m,), policy=p, **base)).session()
        for m, p in zip(ENS_SIZES, pols)]
    got, want = [[] for _ in pols], [[] for _ in pols]
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    last = None
    for k in range(n_offers - 1):
        piece = jobs[k * size:(k + 1) * size]
        last = ens.offer([piece] * 3, policy=pols)
        for e in range(3):
            got[e] += _lane(last, e)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.LAUNCHES["availscan_select_mr"]
    st = ens._backend.stats
    steps, syncs = st.steps, st.host_syncs
    if launches != steps or not launches:
        fail(f"ensemble_session: {launches} select_mr launches for "
             f"{steps} lane steps")
    for k in range(n_offers - 1):
        piece = jobs[k * size:(k + 1) * size]
        for e, one in enumerate(ones):
            want[e] += _decisions([one.offer(piece)])[1]
    for e in range(3):
        if got[e] != want[e]:
            fail(f"ensemble_session: lane {e} differs from its one-lane "
                 f"session {_first_diff(got[e], want[e])}")
        if ens.records(e) != ones[e].records():
            fail(f"ensemble_session: lane {e} records differ")
    n = 3 * (n_offers - 1) * size
    m = ens.metrics()
    # a tick at the median end of lane 1's pending reservations from its
    # last offer, then a cancel on lane 1 of the one that ends last
    t_last = jobs[(n_offers - 1) * size - 1].t_a
    allocs = sorted((a for a in decisions_to_allocations(
        lane_of(last.decision, 1)) if a is not None and a.t_e > t_last),
        key=lambda a: a.t_e)
    t = allocs[len(allocs) // 2].t_e
    released = ens.tick(t)
    if released != sum(one.tick(t) for one in ones) or not released:
        fail(f"ensemble_session: tick released {released}, unlike the "
             f"one-lane sessions")
    allocs = [a for a in allocs if a.t_e > t]
    if not allocs:
        fail("ensemble_session: lane 1 holds no pending reservation")
    if not (ens.cancel(allocs[-1], lane=1) and ones[1].cancel(allocs[-1])):
        fail("ensemble_session: the cancel on lane 1 found nothing")
    for e in range(3):
        if ens.records(e) != ones[e].records():
            fail(f"ensemble_session: lane {e} records differ after the "
                 f"tick and the cancel")
    # snapshot, offer, restore, offer again: the same decisions
    piece = jobs[(n_offers - 1) * size:]
    snap = ens.snapshot()
    res = ens.offer([piece] * 3, policy=pols)
    first = [_lane(res, e) for e in range(3)]
    ens.restore(snap)
    res = ens.offer([piece] * 3, policy=pols)
    again = [_lane(res, e) for e in range(3)]
    if first != again:
        fail("ensemble_session: the re-offer after restore decided "
             "differently")
    for e, one in enumerate(ones):
        if again[e] != _decisions([one.offer(piece)])[1]:
            fail(f"ensemble_session: lane {e}'s last offer differs from its "
                 f"one-lane session")
    rows["availscan_select_mr"].setdefault("launches_grid", {})[
        "ensemble_session"] = launches
    print(f"ensemble_session (pipelined, lanes {ENS_SIZES} PEs, "
          f"{'/'.join(p.value for p in pols)}, chunks of 64): "
          f"{n_offers - 1} offers of {size} a lane, accepted "
          f"{[sum(a for a, _ in g) for g in got]}; every lane identical to "
          f"its one-lane session; {n / wall:.1f} requests/s, "
          f"{steps} lane steps, select_mr launches {launches}, host "
          f"syncs {syncs} = {syncs / steps:.3f} per lane "
          f"step, growths {m['growths']}; tick released {released}, cancel "
          f"on lane 1, snapshot / restore / re-offer identical")
    _tenant_lanes(jobs, dev, base, rows)


def _tenant_lanes(jobs, dev, base, rows: dict) -> None:
    """``lanes=2`` with ``tenants=(spec, None)`` and ``auto_release=
    False``: lane 0 reaps with the spec's grace, lane 1 never does."""
    import torch
    from repro_torch.api import ReservationService, ServiceConfig
    from repro_torch.core.hostsched import TenantOracle
    from repro_torch.core.types import Policy
    from repro_torch.kernels import availscan as K

    tjobs = tenanted(jobs)
    spec = tenant_spec(tjobs, grace=TN_GRACE)
    base = dict(base, auto_release=False)
    ens = ReservationService(ServiceConfig(
        lanes=2, tenants=(spec, None), **base)).session()
    oracle = TenantOracle(1024, Policy.PE_W, "none", spec,
                          auto_release=False)
    plain = ReservationService(ServiceConfig(**base)).session()
    n_offers, size = ENS_OFFERS
    got, want, reaped = [[], []], [[], []], 0
    torch.cuda.synchronize()
    K.reset_launches()
    for k in range(n_offers):
        piece = tjobs[k * size:(k + 1) * size]
        bare = jobs[k * size:(k + 1) * size]      # tenant 0: lane 1
        res = ens.offer([piece, bare])
        for e in range(2):
            got[e] += _lane(res, e)
        want[0] += [oracle.admit(j)[:2] for j in piece]   # on the host
        r = ens.tick(piece[-1].t_a)
        if r != oracle.reap(piece[-1].t_a):
            fail(f"ensemble tenants: reaped {r} after offer {k}, the oracle "
                 f"otherwise")
        reaped += r
    torch.cuda.synchronize()
    launches = K.LAUNCHES["availscan_select"]
    st = ens._backend.stats
    if launches != _searches(st) or not launches:
        fail(f"ensemble tenants: {launches} select launches for "
             f"{_searches(st)} searches")
    # the one-lane session that lane 1 is held against runs after the
    # count is read, so its launches are not the ensemble's
    for k in range(n_offers):
        want[1] += _decisions([plain.offer(jobs[k * size:(k + 1) * size])])[1]
    for e, label in ((0, "TenantOracle"), (1, "the one-lane session")):
        if got[e] != want[e]:
            fail(f"ensemble tenants: lane {e} differs from {label} "
                 f"{_first_diff(got[e], want[e])}")
    if ens.records(0) != oracle.records() or \
            ens.records(1) != plain.records():
        fail("ensemble tenants: records differ")
    m = ens.metrics()
    tn = m["tenants"]
    if tn["n_reaped"][1].sum() or not reaped or \
            int(ens._backend.states[1].n_released):
        fail(f"ensemble tenants: reaping on lane 1 ({tn['n_reaped']}) or "
             f"none on lane 0 ({reaped})")
    want_tn = oracle.accounts.snapshot()
    for f, v in want_tn.items():
        if not np.array_equal(np.asarray(tn[f])[0], np.asarray(v)):
            fail(f"ensemble tenants: lane 0's {f} {tn[f][0]} differs from "
                 f"the oracle's {v}")
    rows["availscan_select"].setdefault("launches_grid", {})[
        "ensemble_tenants"] = launches
    print(f"ensemble tenants (lanes=2, tenants=(spec, None), grace "
          f"{TN_GRACE}, auto_release=False): accepted "
          f"{[sum(a for a, _ in g) for g in got]}, reaped {reaped} on lane 0 "
          f"only; {st.steps} lane steps, select launches {launches}, host "
          f"syncs {st.host_syncs}; lane 0 identical to TenantOracle (every telemetry field), "
          f"lane 1 to the one-lane session")


FLEET_JOBS = 300          # fleet_routing's paper jobs (the reference's gate: 1,000)
FLEET_PARTS = 4           # partitions of 256 PEs (8 words each)
PART_OFFERS = (20, 50)    # partition_sessions: offers x requests each
FLEET_BATCHES = (8, 25)   # fleet_jobs: submit_batch calls x jobs each


def _fleet_run(label, jobs, dev, rows, routing, policy, **kw):
    """``PartitionedCore.admit_stream_allocations`` of ``jobs`` on the
    card (1024 PEs in ``FLEET_PARTS`` partitions, capacity 128), launches
    counted; every launch must be one of the run's searches."""
    import torch
    from repro_torch.kernels import availscan as K
    from repro_torch.runtime import PartitionedCore

    core = PartitionedCore(1024, FLEET_PARTS, capacity=128, device=dev, **kw)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    allocs = core.admit_stream_allocations(jobs, policy, routing=routing)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    st = core.stats
    want_sel = _searches(st)
    want_one = st.early_rejects + st.probe_rejects
    if launches["availscan_select"] != want_sel or not want_sel or \
            launches["availscan"] != want_one:
        fail(f"{label}: {launches} launches for {want_sel} searches and "
             f"{want_one} early rejects ({st})")
    if (want_one > 0) != ("index_tile" in kw):
        fail(f"{label}: {want_one} early rejects")
    n = len(jobs)
    rows["availscan_select"].setdefault("launches_fleet", {})[label] = \
        launches["availscan_select"]
    if want_one:
        rows["availscan"].setdefault("launches_fleet", {})[label] = \
            launches["availscan"]
    print(f"{label}: {n} requests in {wall:.3f} s = {n / wall:.1f} "
          f"requests/s; accepted {sum(a is not None for a in allocs)}; "
          f"dispatches {core.dispatches}, match rounds "
          f"{core.last_match_rounds}, admit steps {st.steps}, probe "
          f"searches {st.probe_searches}, availscan_select launches "
          f"{launches['availscan_select']}, availscan (one window) launches "
          f"{launches['availscan']} ({st.early_rejects} commit + "
          f"{st.probe_rejects} probe early rejects), host syncs "
          f"{st.host_syncs} = {st.host_syncs / n:.3f} per request, growths "
          f"{st.growths}, capacity {core.states[0].tl.capacity}")
    return core, allocs


def _key(a):
    return None if a is None else (a.t_s, a.t_e, tuple(a.pe_ids))


def fleet_routing(jobs, dev, rows: dict) -> None:
    """The paper stream through the partitioned core under every routing
    (best acceptance fused, with the forced rounds protocol under PE_W
    and FF, and with the index), each held against the port's
    ``FleetRoutingOracle``: allocations and merged records."""
    from repro_torch.core.hostsched import FleetRoutingOracle
    from repro_torch.core.types import Policy

    runs = (("fleet_round_robin", "round_robin", Policy.PE_W, {}),
            ("fleet_least_loaded", "least_loaded", Policy.PE_W, {}),
            ("fleet_best_fused", "best_acceptance", Policy.PE_W, {}),
            ("fleet_best_rounds", "best_acceptance", Policy.PE_W,
             dict(match_rounds=8)),
            ("fleet_best_rounds_ff", "best_acceptance", Policy.FF,
             dict(match_rounds=8)),
            ("fleet_best_indexed", "best_acceptance", Policy.PE_W,
             dict(index_tile=32)))
    want = {}
    wide = sum(j.n_pe > 1024 // FLEET_PARTS for j in jobs)
    for label, routing, policy, kw in runs:
        core, allocs = _fleet_run(label, jobs, dev, rows, routing, policy,
                                  **kw)
        if (routing, policy) not in want:
            oracle = FleetRoutingOracle(1024, FLEET_PARTS)
            want[routing, policy] = (
                [_key(a) for a in oracle.admit_batch(jobs, policy, routing)],
                oracle.records())
        keys, recs = want[routing, policy]
        got = [_key(a) for a in allocs]
        if got != keys:
            fail(f"{label}: allocations differ from FleetRoutingOracle "
                 f"{_first_diff(got, keys)}")
        if core.records() != recs:
            fail(f"{label}: records differ from FleetRoutingOracle's")
        if any(a is not None for a, j in zip(allocs, jobs)
               if j.n_pe > 1024 // FLEET_PARTS):
            fail(f"{label}: a job wider than a partition was admitted")
        if kw.get("match_rounds") and not core.last_match_rounds:
            fail(f"{label}: the rounds protocol ran no round")
    print(f"fleet_routing: {len(jobs)} paper jobs ({wide} wider than a "
          f"{1024 // FLEET_PARTS}-PE partition, all rejected) on "
          f"{FLEET_PARTS} partitions; every run identical to "
          f"FleetRoutingOracle (allocations and merged records), the "
          f"indexed run to the index-free one")


def _replay_gated(reqs, accounts, oracle, ledger, seq, routing, policy):
    """The router's gate (``_PartitionBackend._offer_gated``) on the host:
    ``HostTenantAccounts`` plus ``FleetRoutingOracle``; ``ledger`` is the
    completion heap, ``seq`` its tie-break counter."""
    import heapq
    out = []
    for req in reqs:
        tid = accounts.clip_tid(req.tenant)
        if not accounts.allowed(tid, req.n_pe, req.t_du):
            accounts.record(tid, accepted=False, blocked=True, parked=False,
                            occ_frac=np.float32(0.0))
            out.append(None)
            continue
        alloc = oracle.admit_batch([req], policy, routing)[0]
        accounts.record(tid, accepted=alloc is not None, blocked=False,
                        parked=False, occ_frac=np.float32(0.0),
                        t_e=alloc.t_e if alloc else -1, t_r=req.t_r,
                        t_du=req.t_du, n_pe=req.n_pe)
        if alloc is not None:
            heapq.heappush(ledger, (alloc.t_e, next(seq), tid, alloc.t_s,
                                    alloc.pe_ids))
        out.append(alloc)
    return out


def _reap_replay(t, grace, accounts, oracle, ledger) -> int:
    """Overdue reaping at the router, on the host replay."""
    import heapq
    n = 0
    cpp = oracle.chips_per_part
    while ledger and ledger[0][0] <= t - grace:
        t_e, _, tid, t_s, ids = heapq.heappop(ledger)
        lane = ids[0] // cpp
        oracle.lanes[lane].delete_allocation(t_s, t_e,
                                             [p - lane * cpp for p in ids])
        oracle.load[lane] += np.float32(-(t_e - t_s) * len(ids))
        accounts.reap(tid)
        n += 1
    return n


def partition_sessions(jobs, dev, rows: dict) -> None:
    """Partitioned service sessions at 1024 PEs / ``FLEET_PARTS``
    partitions: an EASY round-robin session with a tick after each offer,
    a cancel and a snapshot / restore / re-offer, each lane held against
    a ``BackfillOracle`` fed its routed requests; then a tenanted
    best-acceptance session (``auto_release=False``, grace 300) reaping
    after each offer, held against a host replay of the router's gate."""
    import torch
    from repro_torch.api import ReservationService, ServiceConfig
    from repro_torch.core.hostsched import BackfillOracle, FleetRoutingOracle
    from repro_torch.core.types import Policy
    from repro_torch.kernels import availscan as K
    from repro_torch.tenancy import HostTenantAccounts

    n_offers, size = PART_OFFERS
    jobs = jobs[:n_offers * size]
    E, cpp = FLEET_PARTS, 1024 // FLEET_PARTS
    base = dict(n_pe=1024, n_partitions=E, capacity=128, chunk_size=None,
                device=dev)
    sess = ReservationService(ServiceConfig(
        backfill="easy", backfill_queue=BF_QUEUE, routing="round_robin",
        **base)).session()
    oracles = [BackfillOracle(cpp, Policy.PE_W, "easy",
                              park_capacity=BF_QUEUE) for _ in range(E)]

    def held(lane):
        return [(t, frozenset(p + lane * cpp for p in b))
                for t, b in oracles[lane].records()]

    def offer_both(piece, k0):
        res = sess.offer(piece)
        want = [None] * len(piece)
        for i, r in enumerate(piece):
            acc, t_s, _ = oracles[(k0 + i) % E].admit(r)
            want[i] = (acc, t_s if acc else -1)
        return _decisions([res])[1], want, res

    got_all, want_all, released, k0 = [], [], 0, 0
    snap = None
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    for k in range(n_offers):
        piece = jobs[k * size:(k + 1) * size]
        if k == n_offers // 2:
            snap = (sess.snapshot(), k0)
        got, want, res = offer_both(piece, k0)
        got_all += got
        want_all += want
        k0 += len(piece)
        if k == 2:
            # cancel the offer's reservation that ends last
            last = max((a for a in res.allocations() if a is not None),
                       key=lambda a: a.t_e)
            lane = last.pe_ids[0] // cpp
            if not sess.cancel(last) or not oracles[lane].cancel(
                    last.t_s, last.t_e, [p - lane * cpp for p in last.pe_ids]):
                fail("partition EASY session: the cancel found nothing")
        t = piece[-1].t_a
        released += sess.tick(t)
        for o in oracles:
            o.tick(t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    st = sess.engine.stats
    if got_all != want_all:
        fail(f"partition EASY session: decisions differ from the per-lane "
             f"BackfillOracles {_first_diff(got_all, want_all)}")
    from repro_torch.core.hostsched import merge_records
    if sess.records() != merge_records([held(e) for e in range(E)]):
        fail("partition EASY session: records differ from the oracles'")
    m = sess.metrics()
    pending = sum(len(o.pending()) for o in oracles)
    if m["n_parked_now"] != pending or not m["n_parked"]:
        fail(f"partition EASY session: {m['n_parked_now']} parked, the "
             f"oracles {pending}; {m['n_parked']} ever parked")
    if launches["availscan_select"] != _searches(st):
        fail(f"partition EASY session: {launches['availscan_select']} "
             f"select launches for {_searches(st)} searches")
    # the snapshot taken before offer n/2, restored, re-offers the rest
    # exactly as the uninterrupted run did
    first = got_all
    sess.restore(snap[0])
    k0 = snap[1]
    again = got_all[:(n_offers // 2) * size]
    for k in range(n_offers // 2, n_offers):
        piece = jobs[k * size:(k + 1) * size]
        again += _decisions([sess.offer(piece)])[1]
        sess.tick(piece[-1].t_a)
    if again != first:
        fail(f"partition EASY session: the re-offer after restore decided "
             f"differently {_first_diff(again, first)}")
    rows["availscan_select"].setdefault("launches_fleet", {})[
        "partition_easy"] = launches["availscan_select"]
    n = len(jobs)
    print(f"partition EASY session (round robin, {E} x {cpp} PEs, queue "
          f"{BF_QUEUE}): {n_offers} offers of {size}, a tick after each, a "
          f"cancel; accepted {sum(a for a, _ in got_all)}, parked "
          f"{m['n_parked']}, promoted {m['n_promoted']}, moved "
          f"{m['n_moved']}, released {released}; every lane identical to "
          f"its BackfillOracle; snapshot / restore / re-offer identical; "
          f"{n / wall:.1f} requests/s over offer + tick, admit steps "
          f"{st.steps}, select launches {launches['availscan_select']}, "
          f"host syncs {st.host_syncs} = {st.host_syncs / n:.3f} per "
          f"request, dispatches {m['dispatches']}")

    tjobs = tenanted(jobs)
    spec = tenant_spec(tjobs, grace=TN_GRACE)
    sess = ReservationService(ServiceConfig(
        auto_release=False, tenants=spec, routing="best_acceptance",
        **base)).session()
    accounts = HostTenantAccounts(spec, router=True)
    oracle = FleetRoutingOracle(1024, E)
    ledger, seq, got_all, want_all, reaped = [], itertools.count(), [], [], 0
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    for k in range(n_offers):
        piece = tjobs[k * size:(k + 1) * size]
        got_all += [_key(a) for a in sess.offer(piece).allocations()]
        want_all += [_key(a) for a in _replay_gated(
            piece, accounts, oracle, ledger, seq, "best_acceptance",
            Policy.PE_W)]
        t = piece[-1].t_a
        r = sess.tick(t)
        if r != _reap_replay(t, TN_GRACE, accounts, oracle, ledger):
            fail(f"partition tenants: reaped {r} after offer {k}, the "
                 f"replay otherwise")
        reaped += r
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    st = sess.engine.stats
    if got_all != want_all:
        fail(f"partition tenants: allocations differ from the host replay "
             f"{_first_diff(got_all, want_all)}")
    if sess.records() != oracle.records():
        fail("partition tenants: records differ from the host replay's")
    m = sess.metrics()
    for f, v in accounts.snapshot().items():
        if not np.array_equal(np.asarray(m["tenants"][f]), np.asarray(v)):
            fail(f"partition tenants: {f} {m['tenants'][f]} differs from "
                 f"the replay's {v}")
    if m["ledger_depth"] != len(ledger) or not reaped or \
            not m["tenants"]["n_quota_rejected"].sum():
        fail(f"partition tenants: ledger {m['ledger_depth']} vs "
             f"{len(ledger)}, reaped {reaped}, gated "
             f"{m['tenants']['n_quota_rejected']}")
    if launches["availscan_select"] != _searches(st):
        fail(f"partition tenants: {launches['availscan_select']} select "
             f"launches for {_searches(st)} searches")
    rows["availscan_select"].setdefault("launches_fleet", {})[
        "partition_tenants"] = \
        launches["availscan_select"]
    print(f"partition tenants (best acceptance, auto_release=False, grace "
          f"{TN_GRACE}): {n_offers} offers of {size}, a tick after each; "
          f"accepted {sum(a is not None for a in got_all)}, gated "
          f"{m['tenants']['n_quota_rejected'].tolist()}, reaped {reaped}, "
          f"ledger depth {m['ledger_depth']}; identical to the host replay "
          f"(allocations, records, every telemetry field); {n / wall:.1f} "
          f"requests/s, select launches {launches['availscan_select']} "
          f"({st.probe_searches} probes + {st.steps} admit steps), host "
          f"syncs {st.host_syncs} = {st.host_syncs / n:.3f} per request")


def _fleet_specs(n, seed):
    """``n`` jobs over the ten architectures and their applicable shapes."""
    from repro_torch.configs import ALL_SHAPES, ARCH_IDS, applicable, get_config
    rng = np.random.default_rng(seed)
    cells = [(a, s.name) for a in ARCH_IDS for s in ALL_SHAPES
             if applicable(get_config(a), s)[0]]
    out = []
    for _ in range(n):
        arch, shape = cells[int(rng.integers(len(cells)))]
        out.append(dict(arch=arch, shape=shape,
                        n_chips=int(rng.choice([8, 16, 32, 64, 128, 256])),
                        n_steps=int(rng.integers(200, 5000)),
                        deadline_slack=float(rng.choice([0.5, 1.0, 2.0, 4.0]))))
    return out


def _no_double_booking(label, f) -> None:
    """Live reservations never share a card at one time."""
    from repro_torch.runtime import JobState
    seen = {}
    for j in f.jobs.values():
        if j.state not in (JobState.RESERVED, JobState.RUNNING):
            continue
        for c in j.chips:
            for t0, t1 in seen.get(c, ()):
                if j.t_start < t1 and t0 < j.t_end:
                    fail(f"{label}: card {c} double-booked")
            seen.setdefault(c, []).append((j.t_start, j.t_end))


def _fleet_day(f, submit, label):
    """The scripted day: ``FLEET_BATCHES`` batches with the clock advanced
    30 min after each, 3 card failures, 3 stragglers, 2 rescales and 5
    malleable jobs; each pick a function of the fleet's own state."""
    from repro_torch.runtime import JobState
    n_batches, size = FLEET_BATCHES
    specs = _fleet_specs(n_batches * size, seed=19)
    live = (JobState.RESERVED, JobState.RUNNING)
    done = dict(fail=0, straggler=0, rescale=0, malleable=0)
    for b in range(n_batches):
        submit(f, specs[b * size:(b + 1) * size])
        _no_double_booking(label, f)
        held = sorted(j.job_id for j in f.jobs.values()
                      if j.state in live and j.chips)
        if b in (1, 4, 7) and held:
            f.fail_chip(f.jobs[held[0]].chips[-1])
            done["fail"] += 1
        if b in (2, 5, 6) and held:
            f.report_straggler(held[-1], slowdown=1.3)
            done["straggler"] += 1
        if b in (3, 6) and held:
            f.rescale(held[len(held) // 2], 32)
            done["rescale"] += 1
        if b in (0, 2, 4, 6, 7):
            f.submit_malleable("stablelm-1.6b", "train_4k", [16, 32, 64],
                               n_steps=2000 + 500 * b)
            done["malleable"] += 1
        _no_double_booking(label, f)
        f.advance(f.now + 1800)
    if list(done.values()) != [3, 3, 2, 5]:
        fail(f"{label}: the script ran {done}")
    f.advance(f.now + 10 ** 8)
    return ([(j.job_id, j.state.value, j.t_start, j.t_end, tuple(j.chips),
              j.preemptions, j.n_chips, j.partition)
             for j in sorted(f.jobs.values(), key=lambda j: j.job_id)],
            list(f.events))


def _oracle_of(core):
    """A ``FleetRoutingOracle`` holding the partitioned core's timelines
    (every lane's rows re-added as reservations), load and cursor."""
    from repro_torch.core.batch import mask32_to_ids
    from repro_torch.core.hostsched import FleetRoutingOracle
    oracle = FleetRoutingOracle(core.n_chips, core.n_partitions)
    for lane, s in enumerate(core.states):
        times = s.tl.times.cpu().numpy()
        occ = s.tl.occ.cpu().numpy()
        n = int((times < T_INF).sum())
        for i in range(n - 1):
            ids = mask32_to_ids(occ[i])
            if ids:
                oracle.lanes[lane].add_allocation(int(times[i]),
                                                  int(times[i + 1]), ids)
    oracle.load[:] = core._load_host
    oracle._rr = core._rr
    return oracle


def fleet_jobs(dev, rows: dict) -> None:
    """``FleetScheduler(n_chips=512)`` (2 pods x 256 cards) through the
    scripted day on the device engine against the host engine (job
    tables and event logs identical), then partitioned in two with every
    ``submit_batch`` held against ``FleetRoutingOracle``."""
    import torch
    from repro_torch.core.types import ARRequest
    from repro_torch.kernels import availscan as K
    from repro_torch.runtime import FleetScheduler, estimate_duration

    def plain_submit(f, specs):
        f.submit_batch(specs)

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    dev_day = _fleet_day(FleetScheduler(n_chips=512, engine="device",
                                        device=dev), plain_submit,
                         "fleet_jobs device")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev_launches = K.LAUNCHES["availscan_select"]
    if not dev_launches:
        fail("fleet_jobs: the device engine launched no select kernel")
    t0 = time.perf_counter()
    host_day = _fleet_day(FleetScheduler(n_chips=512, engine="host"),
                          plain_submit, "fleet_jobs host")
    host_wall = time.perf_counter() - t0
    if dev_day[0] != host_day[0]:
        fail(f"fleet_jobs: job tables differ between the device and host "
             f"engines {_first_diff(dev_day[0], host_day[0])}")
    if dev_day[1] != host_day[1]:
        fail(f"fleet_jobs: event logs differ "
             f"{_first_diff(dev_day[1], host_day[1])}")
    summary = {}
    for row in dev_day[0]:
        summary[row[1]] = summary.get(row[1], 0) + 1
    batches = [0, 0]

    def checked_submit(f, specs):
        oracle = _oracle_of(f.core)
        jobs = f.submit_batch(specs)
        reqs = [ARRequest(t_a=j.submit_time, t_r=j.ready, t_dl=j.deadline,
                          t_du=estimate_duration(j.arch, j.shape, j.n_chips,
                                                 j.n_steps),
                          n_pe=j.n_chips) for j in jobs]
        want = oracle.admit_batch(reqs, f.policy, f.routing)
        got = [None if j.chips == () else (j.t_start, j.t_end, j.chips)
               for j in jobs]
        if got != [None if a is None else (a.t_s, a.t_e, a.pe_ids)
                   for a in want]:
            fail(f"fleet_jobs partitioned: batch {batches[0]} differs from "
                 f"FleetRoutingOracle")
        batches[0] += 1
        batches[1] += sum(g is not None for g in got)

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    fleet = FleetScheduler(n_chips=512, n_partitions=2,
                           routing="best_acceptance", device=dev)
    part_day = _fleet_day(fleet, checked_submit, "fleet_jobs partitioned")
    torch.cuda.synchronize()
    part_wall = time.perf_counter() - t0
    part_launches = K.LAUNCHES["availscan_select"]
    st = fleet.core.stats
    if part_launches != _searches(st) or not part_launches:
        fail(f"fleet_jobs partitioned: {part_launches} select launches for "
             f"{_searches(st)} searches")
    rows["availscan_select"].setdefault("launches_fleet", {}).update(
        fleet_jobs_device=dev_launches, fleet_jobs_partitioned=part_launches)
    n_batches, size = FLEET_BATCHES
    print(f"fleet_jobs: FleetScheduler(n_chips=512), {n_batches} batches of "
          f"{size} jobs over the ten architectures, 3 card failures, 3 "
          f"stragglers, 2 rescales, 5 malleable jobs: final states "
          f"{summary}, {len(dev_day[1])} events; device engine identical "
          f"to the host engine (job tables, event logs); device {wall:.2f} s"
          f" (select launches {dev_launches}), host {host_wall:.2f} s; "
          f"partitioned in 2 (best acceptance): every batch identical to "
          f"FleetRoutingOracle ({batches[1]} reserved in {batches[0]} "
          f"batches), no card double-booked, {part_wall:.2f} s, select "
          f"launches {part_launches}, dispatches {fleet.core.dispatches}, "
          f"host syncs {st.host_syncs}; final states "
          f"{fleet.summary()}")


# ---------------------------------------------------------------------------
# the placement and serving phases
# ---------------------------------------------------------------------------


def placement_phase(jobs, dev, rows: dict) -> None:
    """A 4-lane ``simulate_grid`` (PE_W, FF x none / EASY, 200 jobs at
    1024 PEs) and a partitioned session (4 partitions of 256, least
    loaded, 8 offers of 50) under ``placement="auto"``, each equal to
    the same run under ``placement=None``: decisions, records, metrics."""
    import torch
    from repro_torch.api import ReservationService, ServiceConfig
    from repro_torch.core.types import Policy
    from repro_torch.kernels import availscan as K
    from repro_torch.launch.mesh import data_shards, make_lane_mesh
    from repro_torch.sim import GridSpec, WorkloadParams

    spec = GridSpec(policies=(Policy.PE_W, Policy.FF), arrival_factors=(1.0,),
                    seeds=(0,), flex_factors=(3.0,),
                    backfill_modes=("none", "easy"), base=WorkloadParams(),
                    n_pe=1024, n_jobs=GRID_BF_JOBS, park_capacity=BF_QUEUE)
    grids = {pl: _grid_run(f"placement_grid[{pl}]", spec, dev, rows,
                           "availscan_select", placement=pl)
             for pl in ("auto", None)}
    if grids["auto"].decisions != grids[None].decisions or not np.array_equal(
            grids["auto"].n_accepted, grids[None].n_accepted):
        fail("placement: the auto grid decides unlike placement=None")
    shards = grids["auto"].metrics["placement_shards"]
    if shards != data_shards(make_lane_mesh(4, device=dev)) or \
            grids[None].metrics["placement_shards"] != 1:
        fail(f"placement: {shards} shards for 4 lanes on "
             f"{torch.cuda.device_count()} card(s)")
    runs = {}
    for pl in ("auto", None):
        sess = ReservationService(ServiceConfig(
            n_pe=1024, n_partitions=FLEET_PARTS, routing="least_loaded",
            chunk_size=None, policy=Policy.PE_W, placement=pl,
            device=dev)).session()
        torch.cuda.synchronize()
        K.reset_launches()
        dec = []
        for i in range(8):
            r = sess.offer(jobs[i * 50:(i + 1) * 50])
            dec += [_key(a) for a in r.allocations()]
        launches = K.LAUNCHES["availscan_select"]
        m = sess.metrics()
        if not launches:
            fail(f"placement session [{pl}]: no availscan_select launch")
        runs[pl] = (dec, sess.records(), m["accepted"], m["partition_load"])
        rows["availscan_select"].setdefault("launches_placement", {})[
            f"partition_session[{pl}]"] = launches
        print(f"placement partition session [{pl}]: accepted "
              f"{m['accepted']}/{m['offered']}, availscan_select launches "
              f"{launches}, dispatches {m['dispatches']}")
    if runs["auto"] != runs[None]:
        fail("placement: the auto partition session decides unlike None")
    print(f"placement: auto ({shards} shard(s) on "
          f"{torch.cuda.device_count()} card(s)) == None on the grid and "
          f"the partition session")


PC_LANES = 4               # placement_cards: lanes of every session
PC_JOBS = 400              # placement_cards: paper jobs


def _cards(states) -> list:
    return sorted({str(s.tl.times.device) for s in states})


def _pc_grid(dev, placement):
    from repro_torch.core.types import Policy
    from repro_torch.sim import GridSpec, WorkloadParams, simulate_grid
    spec = GridSpec(policies=(Policy.PE_W, Policy.FF), arrival_factors=(1.0,),
                    seeds=(0,), flex_factors=(3.0,),
                    backfill_modes=("none", "easy"), base=WorkloadParams(),
                    n_pe=1024, n_jobs=200, park_capacity=8)
    res = simulate_grid(spec, placement=placement, record_decisions=True,
                        cross_check=placement is None, device=dev)
    return (res.decisions, res.n_accepted.tolist(),
            res.metrics["placement_shards"])


def _pc_ensemble(dev, placement, jobs):
    from repro_torch.api import ReservationService, ServiceConfig
    from repro_torch.core.batch import mask32_to_ids
    sess = ReservationService(ServiceConfig(
        n_pe=1024, lanes=PC_LANES, capacity=16, pending_capacity=16,
        chunk_size=64, ring_capacity=256, backfill="easy", placement=placement,
        device=dev)).session()
    streams = [jobs[e::PC_LANES] for e in range(PC_LANES)]
    half = len(streams[0]) // 2
    r = sess.offer([s[:half] for s in streams])
    out = {"first": np.asarray(r.decision.t_s.cpu()).tolist()}
    cards = _cards(sess.engine.states)
    # cancel lane 3's last accepted reservation
    acc = np.asarray(r.decision.accepted.cpu())[3]
    j = int(np.flatnonzero(acc)[-1])
    t_s = int(r.decision.t_s[3, j])
    out["cancel"] = sess.cancel(
        t_s=t_s, t_e=t_s + streams[3][j].t_du,
        pe_ids=mask32_to_ids(np.asarray(r.decision.pe_mask[3, j].cpu())),
        lane=3)
    if not out["cancel"]:
        fail(f"placement_cards: ensemble [{placement}]: the cancel found "
             f"nothing")
    sess.tick(int(streams[0][half].t_a))
    snap = sess.snapshot()
    r = sess.offer([s[half:] for s in streams])
    out["second"] = np.asarray(r.decision.t_s.cpu()).tolist()
    sess.restore(snap)
    r = sess.offer([s[half:] for s in streams])
    if np.asarray(r.decision.t_s.cpu()).tolist() != out["second"]:
        fail(f"placement_cards: ensemble [{placement}]: the restored "
             f"re-offer differs")
    m = sess.metrics()
    out["metrics"] = {k: m[k] for k in ("offered", "accepted", "growths",
                                        "capacity", "n_parked", "n_moved",
                                        "cancelled", "released")}
    out["records"] = [sess.records(e) for e in range(PC_LANES)]
    return out, m["placement_shards"], cards


def _pc_partitions(dev, placement, jobs, routing):
    from repro_torch.api import ReservationService, ServiceConfig
    sess = ReservationService(ServiceConfig(
        n_pe=1024, n_partitions=PC_LANES, routing=routing, chunk_size=None,
        placement=placement, device=dev)).session()
    keys = []
    for i in range(0, PC_JOBS, 50):
        keys += [_key(a) for a in sess.offer(jobs[i:i + 50]).allocations()]
    m = sess.metrics()
    return ((keys, sess.records(), m["accepted"], m["partition_load"]),
            _cards(sess.engine.states))


def placement_cards(dev) -> dict:
    """``--placement-cards``: every session of this phase under
    ``placement="auto"`` (lane ``i`` on card ``i // (E / d)``) against
    ``placement=None`` (every lane on ``dev``) over every local card: a
    4-lane ``simulate_grid`` (PE_W, FF x none / EASY, 200 jobs); a
    pipelined 4-lane EASY ensemble session (chunks of 64, capacity 16, a
    cancel on lane 3, ``tick``, snapshot / restore / re-offer); 4-lane
    partitioned sessions under least-loaded and best-acceptance routing
    (the ``[N, E]`` probe and the fused matcher read every lane).  Fails
    unless every decision, record and counter is equal and the lanes
    live on as many cards as the lane mesh has."""
    import torch
    from repro_torch.launch.mesh import local_device_count
    from repro_torch.sim import WorkloadParams, generate

    n_cards = local_device_count(dev)
    want = max(k for k in range(1, n_cards + 1) if PC_LANES % k == 0)
    print(f"placement_cards: {n_cards} card(s): "
          f"{[torch.cuda.get_device_name(i) for i in range(n_cards)]}")
    jobs = generate(WorkloadParams(n_jobs=PC_JOBS, seed=0))
    report = {"cards": n_cards, "lane_shards": want}
    t0 = time.perf_counter()
    g = {pl: _pc_grid(dev, pl) for pl in (None, "auto")}
    if g["auto"][:2] != g[None][:2] or g["auto"][2] != want:
        fail(f"placement_cards: grid auto {g['auto'][1:]} against None "
             f"{g[None][1:]}")
    report["grid_s"] = time.perf_counter() - t0
    print(f"placement_cards: grid auto ({want} shards) == None, accepted "
          f"{g[None][1]}")
    t0 = time.perf_counter()
    e = {pl: _pc_ensemble(dev, pl, jobs) for pl in (None, "auto")}
    if e["auto"][0] != e[None][0] or e["auto"][1] != want or \
            len(e["auto"][2]) != want:
        fail(f"placement_cards: ensemble auto on {e['auto'][2]} "
             f"({e['auto'][1]} shards) differs from None")
    report["ensemble_s"] = time.perf_counter() - t0
    print(f"placement_cards: ensemble session lanes on {e['auto'][2]}, == "
          f"None; {e[None][0]['metrics']}")
    for routing in ("least_loaded", "best_acceptance"):
        t0 = time.perf_counter()
        p = {pl: _pc_partitions(dev, pl, jobs, routing)
             for pl in (None, "auto")}
        if p["auto"][0] != p[None][0] or len(p["auto"][1]) != want:
            fail(f"placement_cards: partitions [{routing}] auto on "
                 f"{p['auto'][1]} differs from None")
        report[f"{routing}_s"] = time.perf_counter() - t0
        print(f"placement_cards: partition session [{routing}] lanes on "
              f"{p['auto'][1]}, == None; accepted {p[None][0][2]}")
    return report


SERVE_ARCHS = ("qwen3-4b", "granite-moe-1b-a400m", "zamba2-7b", "xlstm-1.3b",
               "seamless-m4t-medium", "llama-3.2-vision-11b")
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 64, 32
SERVE_TOL = 0.12          # bf16 decode vs forward (the reference's)
SERVE_TOL_INT8 = 0.25     # int8 KV decode vs forward (the reference's)
SERVE_CUT_LAYERS = 2      # the recurrent families' bf16 hold, full width
SERVE_F32_TOL = 1e-4      # the card vs the CPU, float32, TF32 off
SERVE_PROFILE_STEPS = 8


def set_gates(params, seed: int) -> None:
    """The vlm family's gates set to nonzero values (``|g|`` in [0.5,
    1.5), either sign) drawn from ``seed``: they start at zero, where a
    gated cross block returns its input whatever the image, and a check
    at zero would pass a port that ignored the image.  Other families
    are left as they are."""
    import torch
    if params.cfg.family != "vlm":
        return
    n = len(params.cross_layers)
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 1.5, (2, n)) * rng.choice([-1.0, 1.0], (2, n))
    with torch.no_grad():
        for blk, ga, gm in zip(params.cross_layers, g[0], g[1]):
            blk.gate_attn.fill_(float(ga))
            blk.gate_mlp.fill_(float(gm))


def _generate(params, cfg, prompt, gen: int, extra=None):
    """Greedy prefill + decode on the card: ``(tokens [B, gen], logits
    [B, gen, V] float32, prefill ms, decode ms per step)`` with a
    synchronise around each timed region; ``extra``: the encdec and vlm
    families' frontend inputs."""
    import torch
    from repro_torch.serve import engine

    prefill = engine.make_prefill_step(cfg, max_len=prompt.shape[1] + gen)
    decode = engine.make_decode_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt, extra)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    tok = engine.greedy_token(logits)
    toks, logs = [tok], [logits]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, tok, extra)
        tok = engine.greedy_token(logits)
        toks.append(tok)
        logs.append(logits)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    return (torch.cat(toks, 1), torch.stack(logs, 1), t_prefill * 1e3,
            t_decode / (gen - 1) * 1e3)


@contextlib.contextmanager
def recorded_routing():
    """Every MoE layer's expert ids, in call order, while it is open."""
    from repro_torch.models import moe as moe_lib
    real, log = moe_lib.route, []

    def route(p, xf, cfg):
        r = real(p, xf, cfg)
        log.append(r.expert_ids.sort(dim=-1).values)
        return r
    moe_lib.route = route
    try:
        yield log
    finally:
        moe_lib.route = real


def _same_routing(gen_log, fwd_log, n_layers: int, b: int, t: int,
                  gen: int):
    """bool ``[B, gen]``: whether generated position ``(b, i)`` took the
    same experts in every layer in the decode (the prefill's last
    position for ``i = 0``) as in the full forward."""
    import torch
    fwd = torch.stack([x.reshape(b, t + gen - 1, -1) for x in fwd_log])
    same = torch.ones((b, gen), dtype=torch.bool, device=fwd.device)
    pre = torch.stack([x.reshape(b, t, -1)[:, -1] for x in gen_log[:n_layers]])
    same[:, 0] = (pre == fwd[:, :, t - 1]).all(-1).all(0)
    for i in range(1, gen):
        step = torch.stack(gen_log[i * n_layers:(i + 1) * n_layers])
        same[:, i] = (step == fwd[:, :, t - 1 + i]).all(-1).all(0)
    return same


def _hold_decode(label, params, cfg, prompt, tokens, logits, tol,
                 gen_log=None, extra=None) -> str:
    """Each generated position's decode logits against one full forward
    over prompt + generated tokens: values within ``tol``, and the
    decode's token the forward's top-1 wherever the forward's top-two
    margin exceeds ``tol`` (closer pairs are near-ties, counted).  For
    MoE (``gen_log``: the decode's routing) the positions whose tokens
    took other experts in some layer than in the forward are counted and
    left out: the dispatch is discrete, and a rounding difference
    between the two paths moves a token across an expert boundary."""
    import torch
    from repro_torch.models import transformer as tf

    b, t = prompt.shape
    gen = tokens.shape[1]
    with torch.inference_mode(), recorded_routing() as fwd_log:
        seq = torch.cat([prompt, tokens[:, :-1].long()], 1)
        hid = tf.forward(params, cfg, seq, extra).hidden[:, t - 1:]
        ref = (hid @ params.head).float()
    held = torch.ones((b, gen), dtype=torch.bool, device=ref.device)
    if gen_log is not None:
        held = _same_routing(gen_log, fwd_log, cfg.n_layers, b, t, gen)
        if not bool(held.any()):
            fail(f"{label}: no generated position routes as the forward")
    err = (logits - ref).abs()
    bad = (err > tol + tol * ref.abs()) & held[..., None]
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > tol) & held
    agree = ref.argmax(-1) == tokens.long()
    if bool(bad.any()):
        fail(f"{label}: {int(bad.sum())} decode logits off the forward's by "
             f"more than {tol} (max {float(err[held].max()):.4f})")
    if bool((clear & ~agree).any()):
        fail(f"{label}: top-1 differs from the forward at "
             f"{int((clear & ~agree).sum())} positions with margin > {tol}")
    return (f"max |decode - forward| {float(err[held].max()):.4f} over "
            f"{int(held.sum())}/{held.numel()} positions"
            + ("" if gen_log is None else
               f" (the other {int((~held).sum())} routed differently)")
            + f", top-1 equal at {int(agree.sum())}/{agree.numel()} "
            f"({int((held & ~clear).sum())} held within the {tol} margin)")


def _nbytes(tree) -> int:
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return sum(_nbytes(v) for v in tree)


#: weights no decode step reads: the encoder and the image projection
#: (prefill only) and the cross layers' K / V projections (their K / V
#: are cached)
_PREFILL_ONLY = re.compile(r"^(enc_|img_proj)|^cross_layers\.\d+\.attn\.w[kv]$")


def _decode_bound(cfg, params, ctx: int) -> tuple:
    """(bytes, ms): the least a decode step moves, every weight the step
    reads read once (all but the embedding table and
    ``_PREFILL_ONLY``; the port's MoE reads every expert), the KV cache
    (every attention layer's, or every application of the hybrid's
    shared block) read at ``ctx`` positions, the encdec and vlm
    families' cross K / V read once, and the recurrent states (Mamba2,
    mLSTM, sLSTM) read and written once, over the HBM rate."""
    from repro_torch.launch import specs

    w = sum(p.numel() * p.element_size()
            for name, p in params.named_parameters()
            if not _PREFILL_ONLY.match(name)
            and (name != "tok_embed" or params.lm_head is None))
    cache = specs.decode_cache(cfg, SERVE_BATCH, ctx)
    kv = _nbytes(cache.get("attn", {})) + _nbytes(cache.get("cross_kv", ()))
    states = sum(_nbytes(cache[k]) for k in ("ssm", "mlstm", "slstm")
                 if k in cache)
    n = w + kv + 2 * states
    return n, n / HBM_BYTES_PER_S * 1e3


def _decode_profile(params, cfg, prompt, extra=None) -> tuple:
    """(kernels per decode step, device ms per step) over
    ``SERVE_PROFILE_STEPS`` steps in a counted :func:`profiled_window`."""
    import torch
    from repro_torch.serve import engine

    prefill = engine.make_prefill_step(cfg, max_len=prompt.shape[1]
                                       + SERVE_PROFILE_STEPS + 2)
    decode = engine.make_decode_step(cfg)
    logits, cache = prefill(params, prompt, extra)
    state = {"cache": cache, "tok": engine.greedy_token(logits)}

    def step():
        lg, state["cache"] = decode(params, state["cache"], state["tok"],
                                    extra)
        state["tok"] = engine.greedy_token(lg)
    ms, per_step, _ = device_profile(step, SERVE_PROFILE_STEPS)
    return per_step, ms


def serve_f32_cpu(dev) -> None:
    """The reduced float32 configs on the card against the same port on
    the CPU, the same weights (vlm gates set, :func:`set_gates`) and
    frontend inputs: prefill and decode logits within ``SERVE_F32_TOL``,
    greedy tokens equal (TF32 off)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in SERVE_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        cpu = tf.init_params(cfg, seed=0, device="cpu")
        set_gates(cpu, 0)
        card = copy.deepcopy(cpu).to(dev)
        g = torch.Generator().manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (2, 16), generator=g)
        extra = engine.frontend_inputs(cfg, 2, g)
        out = {}
        for name, p, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
            pre = engine.make_prefill_step(cfg, max_len=24)
            dec = engine.make_decode_step(cfg)
            logits, cache = pre(p, prompt.to(d),
                                {k: v.to(d) for k, v in extra.items()})
            logs, toks = [logits.cpu()], [engine.greedy_token(logits).cpu()]
            for _ in range(6):
                logits, cache = dec(p, cache, toks[-1].to(d))
                logs.append(logits.cpu())
                toks.append(engine.greedy_token(logits).cpu())
            out[name] = (torch.stack(logs), torch.cat(toks, 1))
        err = float((out["cpu"][0] - out["card"][0]).abs().max())
        if err > SERVE_F32_TOL or not torch.equal(out["cpu"][1],
                                                  out["card"][1]):
            fail(f"serve_f32[{arch}]: the card is {err} from the CPU, tokens "
                 f"{out['card'][1].tolist()} vs {out['cpu'][1].tolist()}")
        print(f"serve_f32[{cfg.name}]: the card equals the CPU within "
              f"{SERVE_F32_TOL} (max {err:.2e}) over prefill + 6 decode "
              f"steps, greedy tokens equal")


def _recurrent_drift(params, cfg, prompt, tokens, logits) -> str:
    """The hybrid and ssm families' bf16 decode against one full forward
    at full depth, measured: max ``|decode - forward|`` by generated
    position.  Position 0 is the prefill's logits, the same chunked
    forward over the prompt alone, so it is the forward's own spread
    between two sequence lengths on the card.  Held at full width by
    :func:`_hold_recurrent_bf16` at the depth where that spread is
    within the tolerance, and at full depth in float32 by
    :func:`_hold_recurrent_f32` (PERF.md section 6)."""
    import torch
    from repro_torch.models import transformer as tf

    t = prompt.shape[1]
    with torch.inference_mode():
        seq = torch.cat([prompt, tokens[:, :-1].long()], 1)
        ref = (tf.forward(params, cfg, seq).hidden[:, t - 1:]
               @ params.head).float()
    err = (logits - ref).abs()
    per_pos = err.amax(dim=(0, 2))
    bad = err > SERVE_TOL + SERVE_TOL * ref.abs()
    return (f"bf16 drift at full depth (measured; held at "
            f"{SERVE_CUT_LAYERS} layers in bf16 and at full depth in "
            f"float32): max |decode - forward| {float(per_pos.max()):.4f}, "
            f"at position 0 (prefill over {t} tokens against the forward "
            f"over {seq.shape[1]}) {float(per_pos[0]):.4f}; "
            f"{int(bad.sum())} of {bad.numel()} logits beyond {SERVE_TOL}")


def _hold_recurrent_bf16(arch, cfg, seed, prompt) -> str:
    """The recurrent families' bf16 decode held against their forward at
    full width, cut to ``SERVE_CUT_LAYERS`` layers (zamba2: the shared
    attention block and two Mamba2 layers; xlstm: an mLSTM and an sLSTM
    layer, ``slstm_every=2`` as in the reduced config): within
    ``SERVE_TOL`` at every generated position, top-1 at every clear
    margin.  Deeper, the card's forward alone, over the prompt and over
    prompt + generated tokens, moves by as much as the tolerance
    (``tools/bf16_drift.py``, the final hidden state: 0.10 after 4
    zamba2 layers and 0.27 after 8, 0.19 after 12 xlstm layers, 1.4 and
    1.6 at full depth), so no decode can be held to it there."""
    import torch
    from repro_torch.models import transformer as tf

    kw = dict(n_layers=SERVE_CUT_LAYERS)
    if cfg.family == "ssm":
        kw["slstm_every"] = SERVE_CUT_LAYERS
    c = dataclasses.replace(cfg, **kw)
    params = tf.init_params(c, seed=seed, device=prompt.device)
    toks, logits, _, _ = _generate(params, c, prompt, SERVE_GEN)
    held = _hold_decode(f"serve[{arch}, bfloat16, {SERVE_CUT_LAYERS} "
                        f"layers]", params, c, prompt, toks, logits,
                        SERVE_TOL)
    del params
    torch.cuda.empty_cache()
    print(f"serve[{arch}, bfloat16, {SERVE_CUT_LAYERS} layers]: {held}")
    return held


def _hold_recurrent_f32(arch, cfg, params, prompt) -> dict:
    """The recurrent families' decode held against their forward at full
    width in float32 (the bf16 weights widened in place, TF32 off):
    within ``SERVE_TOL`` at every generated position, top-1 at every
    clear margin.  In bf16 at full depth the card's rounding spread is
    larger than the tolerance: see :func:`_hold_recurrent_bf16`."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    c32 = dataclasses.replace(cfg, dtype="float32")
    params.float()
    _generate(params, c32, prompt, SERVE_GEN)                  # warm-up
    toks, logits, pre_ms, step_ms = _generate(params, c32, prompt, SERVE_GEN)
    held = _hold_decode(f"serve[{arch}, float32]", params, c32, prompt,
                        toks, logits, SERVE_TOL)
    row = dict(prefill_ms=pre_ms, decode_ms_per_step=step_ms,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"serve[{arch}, float32]: prefill {pre_ms:.2f} ms; decode "
          f"{step_ms:.3f} ms/step; peak memory {row['peak_mem_gb']:.2f} GB; "
          f"{held}")
    return row


def _cross_live(params, cfg, prompt, extra, seed: int) -> float:
    """The largest change of the full forward's logits that the cross
    path makes: vlm with the gates set (:func:`set_gates`) against the
    gates at zero; encdec with ``extra``'s audio frames against a second
    draw.  Fails unless it exceeds ``SERVE_TOL``."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine

    def logits(ex):
        with torch.inference_mode():
            return (tf.forward(params, cfg, prompt, ex).hidden
                    @ params.head).float()
    base = logits(extra)
    if cfg.family == "vlm":
        gates = [(b.gate_attn.clone(), b.gate_mlp.clone())
                 for b in params.cross_layers]
        with torch.no_grad():
            for b in params.cross_layers:
                b.gate_attn.zero_()
                b.gate_mlp.zero_()
        other = logits(extra)
        with torch.no_grad():
            for b, (ga, gm) in zip(params.cross_layers, gates):
                b.gate_attn.copy_(ga)
                b.gate_mlp.copy_(gm)
        what = "gates set vs gates zero"
    else:
        g = torch.Generator(device=prompt.device).manual_seed(seed + 1)
        other = logits(engine.frontend_inputs(cfg, prompt.shape[0], g,
                                              prompt.device))
        what = "audio frames vs a second draw"
    delta = float((base - other).abs().max())
    if not delta > SERVE_TOL:
        fail(f"serve[{cfg.name}]: the cross path moves the logits by "
             f"{delta} ({what}), not more than {SERVE_TOL}")
    print(f"serve[{cfg.name}]: cross path live: max |logit change| "
          f"{delta:.4f} ({what})")
    return delta


def serve_phase(dev, seed: int) -> dict:
    """qwen3-4b, granite-moe-1b-a400m, zamba2-7b, xlstm-1.3b,
    seamless-m4t-medium and llama-3.2-vision-11b at full width and
    depth, bfloat16, random weights from ``seed`` (the vlm gates set
    nonzero, :func:`set_gates`; the encdec and vlm families' frontend
    inputs from the seeded generator): greedy generation of
    ``SERVE_GEN`` tokens for ``SERVE_BATCH`` prompts of ``SERVE_PROMPT``
    through ``serve.engine`` (bf16 KV, and int8 for the attention
    families), timed after a warm-up, decode held against one full
    forward (MoE at ``capacity_factor=100`` for the check; the hybrid
    and ssm families in bf16 at full width cut to ``SERVE_CUT_LAYERS``
    layers, :func:`_hold_recurrent_bf16`, and at full depth in float32,
    :func:`_hold_recurrent_f32`, their full-depth bf16 drift measured),
    the decode step profiled, and its bound; for the encdec and vlm
    families the cross path shown live (:func:`_cross_live`)."""
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models import transformer as tf
    from repro_torch.roofline import analysis as roof
    from repro_torch.serve import engine

    out = {}
    for arch in SERVE_ARCHS:
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = tf.init_params(cfg, seed=seed, device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        set_gates(params, seed)
        g = torch.Generator(device=dev).manual_seed(seed)
        prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                               generator=g, device=dev)
        extra = engine.frontend_inputs(cfg, SERVE_BATCH, g, dev)
        n_params = sum(p.numel() for p in params.parameters())
        print(f"serve[{arch}]: {n_params / 1e9:.3f} G parameters "
              f"({cfg.dtype}) initialised in {t_init:.1f} s")
        ctx = SERVE_PROMPT + SERVE_GEN // 2
        # the int8 cache is the attention families' option; the
        # recurrent families are held in bf16
        attention = cfg.family in ("dense", "moe", "encdec", "vlm")
        kvs = ("bfloat16", "int8") if attention else ("bfloat16",)
        for kv in kvs:
            c = dataclasses.replace(cfg, kv_cache_dtype=kv)
            _generate(params, c, prompt, SERVE_GEN, extra)     # warm-up
            toks, logits, pre_ms, step_ms = _generate(params, c, prompt,
                                                      SERVE_GEN, extra)
            if toks.shape != (SERVE_BATCH, SERVE_GEN) or \
                    not bool(torch.isfinite(logits).all()) or \
                    not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
                fail(f"serve[{arch}, {kv}]: bad output {toks.shape}")
            check = c if cfg.family != "moe" else dataclasses.replace(
                c, capacity_factor=100.0)
            gen_log = None
            if check is not c:
                with recorded_routing() as gen_log:
                    toks, logits, _, _ = _generate(params, check, prompt,
                                                   SERVE_GEN)
            held = _hold_decode(f"serve[{arch}, {kv}]", params, check,
                                prompt, toks, logits,
                                SERVE_TOL if kv == "bfloat16"
                                else SERVE_TOL_INT8, gen_log, extra) \
                if attention else \
                _recurrent_drift(params, c, prompt, toks, logits)
            kernels, dev_ms = _decode_profile(params, c, prompt, extra)
            pre_fn = engine.make_prefill_step(c, max_len=SERVE_PROMPT
                                              + SERVE_GEN)
            pre_dev_ms, pre_kernels, _ = device_profile(
                lambda: pre_fn(params, prompt, extra), reps=1)
            n_bytes, bound_ms = _decode_bound(c, params, ctx)
            costs = roof.step_costs(c, ShapeConfig(
                "serve_decode", ctx, SERVE_BATCH, "decode"),
                {"data": 1, "model": 1}).terms(1)
            row = dict(prefill_ms=pre_ms, decode_ms_per_step=step_ms,
                       tokens_per_s=SERVE_BATCH / step_ms * 1e3,
                       device_ms_per_step=dev_ms,
                       idle_share=None if dev_ms is None
                       else 1 - dev_ms / step_ms,
                       kernels_per_step=kernels, bound_ms=bound_ms,
                       prefill_kernels=pre_kernels,
                       prefill_device_ms=pre_dev_ms,
                       bound_bytes=n_bytes,
                       roofline_memory_ms=costs["memory_s"] * 1e3,
                       roofline_compute_ms=costs["compute_s"] * 1e3,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            out[f"{arch}/{kv}"] = row
            idle = "not measured" if dev_ms is None \
                else f"{row['idle_share']:.4f}"
            print(f"serve[{arch}, {kv}]: prefill ({SERVE_BATCH} x "
                  f"{SERVE_PROMPT} tok) {pre_ms:.2f} ms in {pre_kernels:.0f} "
                  f"kernels ({_us(pre_dev_ms)} on the card); decode "
                  f"{step_ms:.3f} ms/step = {row['tokens_per_s']:.1f} tok/s "
                  f"(bound {bound_ms:.3f} ms: {n_bytes / 1e9:.3f} GB at "
                  f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; roofline.step_costs "
                  f"memory {row['roofline_memory_ms']:.3f} ms, compute "
                  f"{row['roofline_compute_ms']:.4f} ms); on the card "
                  f"{_us(dev_ms)} a step in {kernels:.1f} kernels, idle "
                  f"share {idle}; "
                  f"peak memory {row['peak_mem_gb']:.2f} GB; {held}; "
                  f"tokens[0,:8] {toks[0, :8].tolist()}")
        if cfg.family in ("hybrid", "ssm"):
            _hold_recurrent_bf16(arch, cfg, seed, prompt)
            out[f"{arch}/float32"] = _hold_recurrent_f32(arch, cfg, params,
                                                         prompt)
        if cfg.family in ("encdec", "vlm"):
            out[f"{arch}/cross_live_max_logit_change"] = _cross_live(
                params, cfg, prompt, extra, seed)
        del params
        torch.cuda.empty_cache()
    print(f"serve: {json.dumps(out)}")
    return out


TRAIN_F32_ARCHS = (("stablelm-1.6b", {}),
                   ("granite-moe-1b-a400m", {"capacity_factor": 100.0}),
                   ("zamba2-7b", {}), ("xlstm-1.3b", {}),
                   ("seamless-m4t-medium", {}), ("llama-3.2-vision-11b", {}))
TRAIN_F32_TOL = 1e-4      # the card vs the CPU, float32, TF32 off
TRAIN_F32_LR = 1e-5       # Adam's first step moves a weight by ~lr * sign(g)
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB = 8, 8, 256, 2
TRAIN_CKPT_EVERY = 4
TRAIN_RESUME_RTOL = 1e-3  # resumed losses vs the straight run's, bf16
BF16_FLOPS_PER_S = 989.4e12   # H100 SXM5 dense bf16 (roofline/analysis.py)


def train_f32_cpu(dev) -> None:
    """One microbatched train step (2 x 2 sequences of 16) of each
    family's reduced float32 config on the card against the same step
    on the CPU, the same weights and batch: loss and grad norm within
    ``TRAIN_F32_TOL`` relative, every parameter within it absolute (TF32
    off); the encdec and vlm families with their frontend inputs in the
    batch and the vlm gates set (:func:`set_gates`).  At ``TRAIN_F32_LR`` a gradient within rounding of zero that
    takes the other sign on one side moves its weight by 2e-5, inside
    the tolerance."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import frontend_shapes
    from repro_torch.train import optim
    from repro_torch.train import step as step_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch, kw in TRAIN_F32_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                  **kw)
        ocfg = optim.OptConfig(lr=TRAIN_F32_LR, warmup_steps=0,
                               total_steps=10)
        cpu, cpu_opt = step_lib.init_train_state(cfg, ocfg, 0, "cpu")
        set_gates(cpu, 0)
        card = copy.deepcopy(cpu).to(dev)
        card_opt = optim.init(card, ocfg)
        batch = TokenPipeline(cfg.vocab, 16, 4, microbatches=2,
                              extra_shapes=frontend_shapes(cfg),
                              seed=1).batch_at(0)
        step = step_lib.make_train_step(cfg, ocfg, 2)
        out = {}
        for name, p, o, d in (("cpu", cpu, cpu_opt, "cpu"),
                              ("card", card, card_opt, dev)):
            p, o, m = step(p, o, {k: torch.from_numpy(v).to(d)
                                  for k, v in batch.items()})
            out[name] = (float(m["loss"]), float(m["grad_norm"]),
                         [t.detach().cpu() for t in p.parameters()],
                         int(o.step))
        (l0, g0, p0, s0), (l1, g1, p1, s1) = out["cpu"], out["card"]
        dl, dg = abs(l1 - l0) / abs(l0), abs(g1 - g0) / abs(g0)
        dp = max(float((a - b).abs().max()) for a, b in zip(p0, p1))
        if not (dl <= TRAIN_F32_TOL and dg <= TRAIN_F32_TOL
                and dp <= TRAIN_F32_TOL and s0 == s1 == 1):
            fail(f"train_f32[{arch}]: the card is off the CPU: loss "
                 f"{l1} vs {l0}, grad norm {g1} vs {g0}, parameters by "
                 f"{dp}")
        print(f"train_f32[{cfg.name}]: the card equals the CPU within "
              f"{TRAIN_F32_TOL} over one 2-microbatch step: loss {l1:.6f} "
              f"(rel {dl:.1e}), grad norm {g1:.6f} (rel {dg:.1e}), "
              f"parameters max |diff| {dp:.1e}")


def train_phase(dev, seed: int) -> dict:
    """``stablelm-1.6b`` at full width and depth (bf16 weights, float32
    Adam moments) through ``launch.train.run``: ``TRAIN_STEPS`` steps of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens in ``TRAIN_MB`` microbatches
    with the loss falling, checkpoints every ``TRAIN_CKPT_EVERY`` steps
    in a temporary directory; the last checkpoint restored and held
    bit-equal against the live state; then the last checkpoint dropped
    and the run resumed from the one before, its losses held against
    the straight run's.  Its speed is the benchmark's
    (``perfbench/``), not this phase's."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import flatten
    from repro_torch.launch.train import run as train_run
    from repro_torch.models import transformer as tf

    ckpt = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    kw = dict(steps=TRAIN_STEPS, smoke=False, batch=TRAIN_BATCH,
              seq=TRAIN_SEQ, ckpt_dir=str(ckpt), ckpt_every=TRAIN_CKPT_EVERY,
              microbatches=TRAIN_MB, log_every=1, device=dev, seed=seed)
    row = {}
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train_run(TRAIN_ARCH, **kw)
        row["run_s"] = time.perf_counter() - t0
        row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        losses = out["losses"]
        if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)) or \
                not losses[-1] < losses[0]:
            fail(f"train[{TRAIN_ARCH}]: losses {losses} do not fall")
        params, opt = out["state"]
        n_params = sum(p.numel() for p in params.parameters())
        row.update(n_params=n_params, losses=losses)
        mgr = CheckpointManager(ckpt)
        if mgr.all_steps() != [TRAIN_STEPS - TRAIN_CKPT_EVERY, TRAIN_STEPS]:
            fail(f"train: checkpoints {mgr.all_steps()}")
        row["checkpoint_gb"] = sum(
            f.stat().st_size for f in ckpt.rglob("*.npy")) / 2 / 1e9
        # the last checkpoint against the live state, leaf by leaf
        t0 = time.perf_counter()
        live = tf.state_to_reference(params, opt)
        restored, step, meta = mgr.restore(
            tf.state_to_reference(params, opt, device="meta"), device="cpu")
        row["restore_s"] = time.perf_counter() - t0
        mine, back = flatten(live)[0], flatten(restored)[0]
        if step != TRAIN_STEPS or len(mine) != len(back) or not all(
                a.dtype == b.dtype and torch.equal(a, b.to(a.device))
                for a, b in zip(mine, back)):
            fail("train: the restored checkpoint is not the live state")
        del live, restored, mine, back, params, opt, out
        torch.cuda.empty_cache()
        # resume from the checkpoint before the last
        shutil.rmtree(ckpt / f"step_{TRAIN_STEPS:08d}")
        t0 = time.perf_counter()
        out2 = train_run(TRAIN_ARCH, **kw)
        row["resume_run_s"] = time.perf_counter() - t0
        want = losses[TRAIN_STEPS - TRAIN_CKPT_EVERY:]
        dl = max(abs(a - b) / abs(b) for a, b in zip(out2["losses"], want))
        if out2["resumed_from"] != TRAIN_STEPS - TRAIN_CKPT_EVERY or \
                len(out2["losses"]) != TRAIN_CKPT_EVERY or \
                dl > TRAIN_RESUME_RTOL:
            fail(f"train: resumed from {out2['resumed_from']} with losses "
                 f"{out2['losses']}, the straight run's {want}")
        row["resume_max_rel_loss_diff"] = dl
        print(f"train[{TRAIN_ARCH}]: {n_params / 1e9:.3f} G parameters "
              f"(bf16, float32 Adam state), {TRAIN_STEPS} steps of "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MB} microbatches: "
              f"losses {[round(x, 4) for x in losses]}; peak memory "
              f"{row['peak_mem_gb']:.2f} GB; checkpoint "
              f"{row['checkpoint_gb']:.2f} GB a step, restored bit-equal in "
              f"{row['restore_s']:.1f} s; resumed from step "
              f"{TRAIN_STEPS - TRAIN_CKPT_EVERY}, losses within "
              f"{dl:.1e} of the straight run's; run {row['run_s']:.1f} s, "
              f"resumed run {row['resume_run_s']:.1f} s")
        del out2
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    print(f"train: {json.dumps(row)}")
    return row


#: the dry-run cells whose step runs on ``meta`` in :func:`dryrun_phase`
#: (the rest record their specs only): the decode cells of both meshes,
#: and the encdec and vlm families' train step on one mesh (its shapes
#: are the same on both).  The other train cells and the 32k prefills
#: take from seconds to minutes of host dispatch each (PERF.md section 6)
DRYRUN_META_KINDS = ("decode",)
DRYRUN_META_CELLS = (("seamless-m4t-medium", "train_4k", False),
                     ("llama-3.2-vision-11b", "train_4k", False))


def dryrun_phase() -> dict:
    """The dry-run's sweep (``python -m repro_torch.launch.dryrun``) of
    all 80 cells (10 archs x 4 shapes x the 16 x 16 and 2 x 16 x 16
    meshes) on this machine's CPU, which has no JAX: every cell's specs,
    per-card argument bytes, analytic costs and roofline terms, and the
    step run on ``meta`` at full size in the decode cells and
    ``DRYRUN_META_CELLS``.  Fails unless 64 cells are ``OK``, 16
    ``SKIPPED`` (the ``long_500k`` cells of the full-attention archs)
    and none ``FAILED``, every decode cell memory-bound and every serve
    cell within 80 GB a card."""
    from repro_torch.configs import ALL_SHAPES, ARCH_IDS, shape_by_name
    from repro_torch.launch import dryrun

    recs, lines = [], []
    t0 = time.perf_counter()
    n = dryrun.sweep(
        dryrun.cells(ARCH_IDS, [s.name for s in ALL_SHAPES], (False, True)),
        None, run=lambda a, s, m: shape_by_name(s).kind in DRYRUN_META_KINDS
        or (a, s, m) in DRYRUN_META_CELLS, log=lines.append, records=recs)
    wall = time.perf_counter() - t0
    if n != {"ok": 64, "skipped": 16, "failed": 0}:
        fail(f"dryrun: {n}; {[x for x in lines if 'FAILED' in x][:3]}")
    ok = [r for r in recs if r["status"] == "OK"]
    for r in ok:
        if r["kind"] == "decode" and r["roofline"]["dominant"] != "memory":
            fail(f"dryrun: {r['arch']} {r['shape']} {r['mesh']} is "
                 f"{r['roofline']['dominant']}-bound")
        if r["kind"] != "train" and not r["memory"]["model_fits_80g_hbm"]:
            fail(f"dryrun: {r['arch']} {r['shape']} {r['mesh']} needs "
                 f"{r['memory']['model_per_device_total'] / 1e9:.1f} GB")
    runs = sorted((r["meta_run_s"], r["arch"], r["shape"], r["mesh"])
                  for r in ok if r["meta_run"])
    largest = max(ok, key=lambda r: r["memory"]["model_per_device_total"])
    row = {"ok": n["ok"], "skipped": n["skipped"], "failed": n["failed"],
           "wall_s": wall, "meta_runs": len(runs),
           "meta_run_s": sum(x[0] for x in runs),
           "slowest_meta_run": runs[-1] if runs else None,
           "largest_cell": [largest["arch"], largest["shape"],
                            largest["mesh"],
                            largest["memory"]["model_per_device_total"]]}
    print(f"dryrun: {n['ok']} ok, {n['skipped']} skipped, {n['failed']} "
          f"failed in {wall:.1f} s ({len(runs)} cells' steps run on meta "
          f"in {row['meta_run_s']:.1f} s, the slowest {runs[-1]}); every "
          f"decode cell memory-bound, every serve cell within 80 GB a card "
          f"(largest cell {row['largest_cell']})")
    print(f"dryrun: {json.dumps(row)}")
    return row


#: the phase groups ``--phases`` names, in the order they run, and the
#: groups whose results each needs
PHASES = ("main", "index", "claims", "session", "backfill", "tenancy",
          "ensemble", "fleet", "placement", "serve", "train", "dryrun",
          "service")
PHASE_NEEDS = {"index": ("main",), "backfill": ("main",),
               "tenancy": ("main", "backfill")}


def parse_phases(text) -> tuple:
    """The groups to run for ``--phases`` (all when ``None``), with the
    groups they need, in run order; ``ValueError`` on an unknown name."""
    if text is None:
        return PHASES
    names = [n.strip() for n in text.split(",") if n.strip()]
    bad = [n for n in names if n not in PHASES]
    if bad or not names:
        raise ValueError(f"unknown phase group(s) {bad or [text]}; "
                         f"known: {', '.join(PHASES)}")
    want = set(names)
    for n in names:
        want.update(PHASE_NEEDS.get(n, ()))
    return tuple(p for p in PHASES if p in want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-jobs", type=int, default=1_000,
                    help="jobs of the single-resource paper stream (also "
                    "the indexed stream's)")
    ap.add_argument("--n-event-loop", type=int, default=300,
                    help="jobs for the per-operation event loops")
    ap.add_argument("--n-session", type=int, default=1_000,
                    help="jobs for the multi-resource session")
    ap.add_argument("--placement-cards", action="store_true",
                    help="only build the kernels and hold lane placement "
                    "over every local card against one card")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phase groups to run after the "
                    "build and the kernel checks (default: all): "
                    + ", ".join(PHASES))
    args = ap.parse_args(argv)
    try:
        phases = parse_phases(args.phases)
    except ValueError as e:
        ap.error(str(e))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.sim import WorkloadParams, generate

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}, "
          f"numpy {np.__version__}")
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib_path}")
    log = lib_path.with_suffix(".log")
    if not log.exists():
        fail(f"no ptxas report beside {lib_path}")
    report = ptxas_report(log.read_text())
    for kname, rep in report.items():
        tag = "ptxas (select)" if "select_kernel" in kname else "ptxas"
        for line in rep["lines"]:
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {tag}: {line}")

    if args.placement_cards:
        print(json.dumps(placement_cards(dev)))
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    rows = kernel_phase(rng, dev, report)
    print(f"kernel phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernel_phase_mr(rng, dev, rows, report)
    print(f"multi-resource kernel phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    select_seams(rng, dev, N_REPEAT)
    print(f"select seams took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pruned_phase(rng, dev, rows)
    print(f"pruned starts took {time.perf_counter() - t0:.1f} s")

    if phases != PHASES:
        print(f"phase groups: {', '.join(phases)} (of {', '.join(PHASES)})")
    jobs = generate(WorkloadParams(n_jobs=args.n_jobs, seed=args.seed))
    paper = generate(WorkloadParams(n_jobs=max(args.n_session, 2000),
                                    seed=args.seed))
    jobs_mr = stamp(paper[:args.n_session], MR_UNITS)
    # the backfill and tenancy phases run the paper stream's first
    # BF_JOBS jobs: a prefix of the main path's, which decides them alike
    bf_jobs = jobs[:BF_JOBS]

    if "main" in phases:
        t0 = time.perf_counter()
        plain = main_path(jobs, dev, rows, args.n_event_loop)
        profile_steps(jobs, dev)
        print(f"main path took {time.perf_counter() - t0:.1f} s")

    if "index" in phases:
        t0 = time.perf_counter()
        indexed_stream(jobs, plain, dev, rows)
        saturated_stream(dev, rows, report)
        print(f"index phases took {time.perf_counter() - t0:.1f} s")

    if "claims" in phases:
        t0 = time.perf_counter()
        paper_claims(dev)
        print(f"paper claims took {time.perf_counter() - t0:.1f} s")

    if "session" in phases:
        t0 = time.perf_counter()
        session_path(jobs_mr, dev, rows)
        profile_session(jobs_mr, dev)
        session_variants(jobs_mr, paper, dev, args.n_event_loop)
        print(f"multi-resource session phases took "
              f"{time.perf_counter() - t0:.1f} s")

    if "backfill" in phases:
        t0 = time.perf_counter()
        bf_plain = dataclasses.replace(plain,
                                       decisions=plain.decisions[:BF_JOBS])
        bf = backfill_streams(bf_jobs, bf_plain, dev, rows)
        backfill_session(bf_jobs, dev, rows)
        bf["mr"] = backfill_mr(stamp(bf_jobs, MR_UNITS), dev, rows)
        bf["indexed"] = backfill_indexed(bf_jobs, bf["easy"], dev, rows)
        backfill_profile(bf_jobs, dev)
        print(f"backfill phases took {time.perf_counter() - t0:.1f} s")

    if "tenancy" in phases:
        t0 = time.perf_counter()
        tjobs = tenanted(bf_jobs)
        tenancy_streams(tjobs, bf, dev, rows)
        tenancy_neutral(tjobs, bf_plain, bf, dev, rows)
        tenancy_session(tjobs, dev, rows)
        tenancy_profile(tjobs, dev)
        print(f"tenancy phases took {time.perf_counter() - t0:.1f} s")

    if "ensemble" in phases:
        t0 = time.perf_counter()
        grid_paper(dev, rows)
        grid_profile(dev)
        grid_backfill(dev, rows)
        grid_mixes(dev, rows)
        ensemble_session(jobs, dev, rows)
        print(f"ensemble phases took {time.perf_counter() - t0:.1f} s")

    if "fleet" in phases:
        t0 = time.perf_counter()
        fleet_routing(jobs[:FLEET_JOBS], dev, rows)
        partition_sessions(jobs, dev, rows)
        fleet_jobs(dev, rows)
        print(f"fleet phases took {time.perf_counter() - t0:.1f} s")

    if "placement" in phases:
        t0 = time.perf_counter()
        placement_phase(jobs, dev, rows)
        print(f"placement phase took {time.perf_counter() - t0:.1f} s")

    if "serve" in phases:
        t0 = time.perf_counter()
        serve_f32_cpu(dev)
        serve_phase(dev, args.seed)
        print(f"serve phases took {time.perf_counter() - t0:.1f} s")

    if "train" in phases:
        t0 = time.perf_counter()
        train_f32_cpu(dev)
        train_phase(dev, args.seed)
        print(f"train phases took {time.perf_counter() - t0:.1f} s")

    if "dryrun" in phases:
        t0 = time.perf_counter()
        dryrun_phase()
        print(f"dryrun phase took {time.perf_counter() - t0:.1f} s")

    if "service" in phases:
        t0 = time.perf_counter()
        pipelined_paths(jobs_mr, dev, rows)
        session_verbs(paper, dev)
        host_engines(paper, dev)
        print(f"service phases took {time.perf_counter() - t0:.1f} s")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": list(rows.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
