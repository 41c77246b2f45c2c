"""BENCHMARK.json against the contract's shapes, every cell resolved to its
files by name, and the import rules of the benchmark's sources."""
import ast
import json
import shutil
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.drivers import train as drv
from perfbench.yardstick.spec import Spec

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    from repro_torch.configs.base import ModelConfig
    cell = harness.resolve(name)
    assert cell.driver_path.is_file()
    assert hasattr(harness.load_module(cell.driver_path, "driver"), "run")
    for m in cell.per_layer:
        reader = harness.load_module(cell.reader_path(m["name"]), "metric")
        assert callable(reader.read)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    spec = Spec.from_model(cell.config["model"])
    cfg = ModelConfig(**cell.config["model"])
    assert (cfg.d_model, cfg.hd, cfg.vocab) == (spec.d_model, spec.hd,
                                                spec.vocab)
    readings = set(drv.compare(*[{
        "losses": [1.0], "first_grad": {"a": 1.0, "b": 2.0},
        "change": {"a": 1.0, "b": 2.0}}] * 2)) | {"nonfinite_losses"}
    assert "nonfinite_losses" in cell.limits
    assert len(cell.limits) >= 3 and set(cell.limits) <= readings
    conf = {c["name"]: c for c in BENCH["configs"]}[cell.entry["config"]]
    assert cell.config["source"] == conf["source"]
    assert cell.mix["batch"] % cell.mix["microbatches"] == 0


def test_names_units_and_limits_of_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 runs a cell, each allowed
    # run_seconds + 60 s, 2 x 90 s a cell to compile, 1,200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert harness.NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and len(c["reduced"]) <= 16
        for s in (c["why"], c["source"]):
            assert 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s
        for k in c["reduced"]:
            assert harness.NAME.match(k)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert harness.NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert harness.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert set(m["workloads"]) <= set(CELLS)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _sources():
    return sorted(harness.HERE.rglob("*.py"))


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".", 1)[0] not in harness.FORBIDDEN, (path, mod)


def test_reference_and_yardstick_import_nothing_of_the_program():
    for sub in ("reference", "yardstick"):
        for path in sorted((harness.HERE / sub).rglob("*.py")):
            for mod in _imports(path):
                assert mod.split(".", 1)[0] != "repro_torch", (path, mod)


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch.models", "jaxtyping",
                                      "torch"]) == []
    assert harness.forbidden_modules(["repro.sub", "jax", "flax.linen",
                                      "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                     "repro"]


def test_a_throwaway_cell_and_metric_resolve_from_new_files(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    base = tmp_path / "perfbench"
    model = dict(json.loads((base / "configs" / "stablelm-1.6b.json")
                            .read_text())["model"], n_layers=2)
    (base / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "source": "https://example.org/tiny",
         "model": model}))
    (base / "traffic" / "short-1k.json").write_text(json.dumps(
        {"driver": "train", "seq_len": 1024, "batch": 4, "microbatches": 2}))
    (base / "limits" / "tiny.short-1k.json").write_text(json.dumps(
        {"first_loss_gap": 1.0}))
    (base / "metrics" / "tokens_a_step.py").write_text(
        "def read(run):\n    return run['tokens_per_step']\n")
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": ["num_hidden_layers"],
                             "why": "a throwaway configuration"})
    bench["workloads"].append({"name": "tiny.short-1k", "config": "tiny",
                               "traffic": "short-1k", "chips": 1,
                               "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "tokens_a_step", "unit": "tokens",
                               "better": "higher", "source": "program_counter",
                               "layer": "train step", "moves": "tokens_per_s",
                               "workloads": ["tiny.short-1k"]})
    for m in bench["end_to_end"]:
        m.get("workloads", []).append("tiny.short-1k")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.resolve("tiny.short-1k", tmp_path)
    assert cell.config["model"]["n_layers"] == 2 and cell.mix["batch"] == 4
    assert [m["name"] for m in cell.per_layer] == ["tokens_a_step"]
    assert cell.driver_path == base / "drivers" / "train.py"
    reader = harness.load_module(cell.reader_path("tokens_a_step"), "metric")
    assert reader.read({"tokens_per_step": 4096}) == 4096
    assert harness.resolve(CELLS[0], tmp_path).name == CELLS[0]


def test_judge_holds_each_number_to_its_limit():
    ok = harness.judge({"a": 0.1, "b": 0.0}, {"a": 0.2, "b": 0})
    assert ok["correct"] and ok["checks"]["a"] == {"value": 0.1,
                                                   "limit": 0.2}
    assert not harness.judge({"a": 0.3, "b": 0.0}, {"a": 0.2, "b": 0})[
        "correct"]
    assert not harness.judge({"a": float("nan"), "b": 0.0},
                             {"a": 0.2, "b": 0})["correct"]
    with pytest.raises(KeyError):
        harness.judge({"a": 0.1}, {"a": 0.2, "b": 0})
    free = harness.judge({"a": 0.1, "b": 0.0, "c": 9.0}, {"a": 0.2, "b": 0})
    assert free["correct"] and set(free["checks"]) == {"a", "b"}

