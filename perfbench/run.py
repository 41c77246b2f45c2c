"""Run one cell of the port's benchmark once, on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  With ``--trace 0`` the result line carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(from a profiled window).  The last line on standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
``correct`` compared, beside its limit); the checks are also the last
lines on standard error.  Exits non-zero, printing no result, without
enough CUDA devices or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "perfbench-cache"


def _env() -> None:
    """Fixed cache directories inside the checkout, set before torch loads."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != Path(here)]
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None, root: Path = ROOT, device=None) -> int:
    """One run; ``device`` (a test's CPU) skips the look for a card, and
    the check for JAX then reads only what the run itself loaded."""
    preloaded = set(sys.modules) if device is not None else set()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if device is None:
        _env()

    import torch

    from perfbench import harness

    cell = harness.resolve(args.workload, root)
    chips = cell.entry["chips"]
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < chips:
            print(f"perfbench: {chips} CUDA device(s) needed, {have} found",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    dev = torch.device(device)
    driver = harness.load_module(cell.driver_path, "driver")
    ctx = argparse.Namespace(
        device=dev, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), t_start=T_START, config=cell.config,
        mix=cell.mix, cell=cell)
    run = driver.run(ctx)

    verdict = harness.judge(run["checks"], cell.limits)
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            reader = harness.load_module(cell.reader_path(m["name"]),
                                         "metric")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": run["metrics"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": kind, "count": chips, **run["device"]}
    line = {"correct": verdict["correct"], "attempted": run["attempted"],
            "failed": run["failed"], "metrics": metrics, "device": device}
    if args.trace:
        line["breakdown"] = run["breakdown"]
    if dev.type == "cuda":
        line["card"] = _power_limit()
    line["notes"] = run.get("notes", {})
    line["checks"] = verdict["checks"]
    # after the window, the reference and every reader have run
    found = harness.forbidden_modules(set(sys.modules) - preloaded)
    if found:
        print(f"perfbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    for name, v in verdict["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
