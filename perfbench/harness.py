"""Resolving a cell of ``BENCHMARK.json`` to its files, and the result line.

Everything that belongs to one configuration, one traffic mix, one
per-layer metric or one cell is a file of its own, found by its name:

    configs/<config>.json     the configuration as it is run
    traffic/<mix>.json        the mix's parameters; ``driver`` names its driver
    drivers/<driver>.py       ``run(ctx) -> dict``
    metrics/<metric>.py       ``read(run) -> float or None``
    limits/<cell>.json        the limits of the numbers ``correct`` compares

so a later cell, configuration or metric is added by adding files and
entries, without editing a file that is here.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, Iterable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: top-level modules that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, prefix: str) -> ModuleType:
    """A driver or reader by file path (its name may hold '.' or '-')."""
    name = f"perfbench._{prefix}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One cell of the benchmark, resolved to its files."""

    name: str
    entry: Dict
    config: Dict
    mix: Dict
    limits: Dict[str, float]
    base: Path
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def driver_path(self) -> Path:
        return self.base / "drivers" / f"{self.mix['driver']}.py"

    def reader_path(self, metric: str) -> Path:
        return self.base / "metrics" / f"{metric}.py"


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` in ``root/BENCHMARK.json`` and every
    file it needs, under ``root/perfbench``."""
    bench = load_json(root / "BENCHMARK.json")
    base = root / "perfbench"
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    mix = load_json(base / "traffic" / f"{entry['traffic']}.json")
    return Cell(
        name=workload, entry=entry, config=config, mix=mix,
        limits=load_json(base / "limits" / f"{workload}.json"), base=base,
        end_to_end=[m for m in bench["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """Top-level names among the module ``names`` that are ``FORBIDDEN``,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops & set(FORBIDDEN))


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """Each number the cell's limits name beside its limit, and whether
    all hold; a reading without a limit is not compared."""
    missing = sorted(set(limits) - set(checks))
    if missing:
        raise KeyError(f"no reading for the limits {missing}")
    table = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return {"correct": ok, "checks": table}
