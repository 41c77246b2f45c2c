"""Readings for a cell's limits, on the card: the program's, the control's
and each planted fault's gaps against the reference.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--out file.json]

Each seed runs the cell's set-up and first steps (no window), frees the
program, and runs the float32 reference; ``--control-seeds`` also runs the
reference in float8 (e4m3 operands) in the program's place, and
``--fault-seeds`` the program with each fault of ``faults.py`` planted.
One JSON line a reading on standard output; ``--out`` writes them all.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _seeds(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from perfbench import faults, harness
    from perfbench.drivers import train as drv

    cell = harness.resolve(args.workload)
    dev = torch.device("cuda", 0)
    mix, model = cell.mix, cell.config["model"]
    out = []
    cached = {}

    def reference(seed):
        if seed not in cached:
            gc.collect()
            torch.cuda.empty_cache()
            cached[seed] = drv.reference_readings(
                drv.Spec.from_model(model), mix, seed, dev)
        return cached[seed]

    def program(seed, fault=None):
        prog = drv.Program(model, mix, seed, dev)
        if fault:
            prog.step_fn = faults.FAULTS[fault](prog.step_fn, prog.cfg)
        got = drv.check_steps(prog)
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        return got

    def emit(kind, seed, got, t0):
        want = reference(seed)
        rec = {"kind": kind, "seed": seed, "checks": drv.compare(got, want),
               "losses": got["losses"], "ref_losses": want["losses"],
               "worst": _worst(got, want), "s": time.perf_counter() - t0,
               "left_out": _left_out(want)}
        print(json.dumps(rec), flush=True)
        out.append(rec)

    jobs = [("program", s, None) for s in _seeds(args.seeds)]
    jobs += [("control", s, None) for s in _seeds(args.control_seeds)]
    jobs += [(f, s, f) for s in _seeds(args.fault_seeds)
             for f in ("half_batch",)]
    jobs.sort(key=lambda j: j[1])            # one reference a seed
    for kind, seed, fault in jobs:
        t0 = time.perf_counter()
        if kind == "control":
            got = drv.reference_readings(drv.Spec.from_model(model), mix,
                                         seed, dev, precision="fp8")
        else:
            got = program(seed, fault)
        emit(kind, seed, got, t0)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


def _left_out(want):
    """Leaves the change leaves out: reference gradient under a thousandth
    of the median leaf's."""
    g = sorted(want["first_grad"].values())
    med = g[len(g) // 2] if len(g) % 2 else (g[len(g) // 2 - 1]
                                             + g[len(g) // 2]) / 2
    return [n for n, v in want["first_grad"].items() if v < 1e-3 * med]


def _worst(got, want):
    """The three leaves with the largest gap, for each leaf reading."""
    res = {}
    for key in ("first_grad", "change"):
        vals = sorted(want[key].values())
        med = vals[len(vals) // 2]
        gaps = sorted(((abs(got[key][n] - w) / max(w, med, 1e-30), n, w)
                       for n, w in want[key].items()), reverse=True)[:3]
        res[key] = [[n, g, w] for g, n, w in gaps]
    return res


if __name__ == "__main__":
    sys.exit(main())
