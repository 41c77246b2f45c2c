"""The port stands alone and never falls back to the CPU on its own.

Importing every ``repro_torch`` module loads neither ``jax`` nor the
JAX package; without a card, entry points called with no device
raise; a tensor that is not on the CPU never reaches a plain version.
"""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.api import ReservationService, ServiceConfig
from repro_torch.core import batch, ensemble, scheduler, timeline
from repro_torch.core.resources import ResourceSpec, device_layout
from repro_torch.core.types import ARRequest, Policy
from repro_torch.kernels import availscan, ops
from repro_torch.sim import (GridSpec, pad_streams, run_policies, simulate,
                             simulate_batched, simulate_grid)
from repro_torch.tenancy import TenantSpec, init_table, lane_tables

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_the_port_loads_no_jax():
    mods = _port_modules()
    assert "repro_torch.kernels.availscan" in mods and len(mods) >= 15
    assert {"repro_torch.tenancy", "repro_torch.tenancy.table",
            "repro_torch.tenancy.telemetry", "repro_torch.core.ensemble",
            "repro_torch.sim.sweep", "repro_torch.sim.metrics"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(
    [*PORT.rglob("*.py"), ROOT / "chip_smoke.py",
     *(ROOT / "tools").glob("*.py")]), ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_importing_the_service_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.api\n"
        "from repro_torch.api import ReservationService, ServiceConfig\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_without_a_device_raise_when_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: None means cuda there")
    job = ARRequest(0, 0, 5, 10, 1)
    calls = [
        lambda: timeline.init_state(16, 8),
        lambda: timeline.empty(16, 8),
        lambda: scheduler.DeviceEngine(8),
        lambda: batch.requests_to_batch([job]),
        lambda: simulate_batched([job], 8, Policy.FF),
        lambda: simulate([job], 8, Policy.FF, engine="device"),
        lambda: simulate([job], 8, Policy.FF),
        lambda: run_policies([job], 8, [Policy.FF]),
        lambda: timeline.init_state(16, 8, device="cuda"),
        lambda: ReservationService(ServiceConfig(n_pe=8)).session(),
        lambda: ReservationService(ServiceConfig(
            n_pe=8, resources=(8, 2))).session(),
        lambda: scheduler.DeviceEngine(8, rspec=ResourceSpec((8, 2))),
        lambda: timeline.init_state(16, 8, index_tile=8),
        lambda: scheduler.DeviceEngine(8, index_tile=8),
        lambda: ReservationService(ServiceConfig(
            n_pe=8, index_tile=16)).session(),
        lambda: ReservationService(ServiceConfig(
            n_pe=8, donate=False)).session(),
        lambda: simulate_batched([job], 8, Policy.FF, index_tile=16),
        lambda: simulate_batched([job], 8, Policy.FF,
                                 cross_check_engine="list"),
        lambda: init_table(TenantSpec(weights=(1.0, 2.0)), 16, 4),
        lambda: init_table(TenantSpec(), 16, 0, device=None),
        lambda: scheduler.DeviceEngine(8, tenants=TenantSpec()),
        lambda: ReservationService(ServiceConfig(
            n_pe=8, tenants=TenantSpec(weights=(1.0, 1.0)))).session(),
        lambda: ReservationService(ServiceConfig(
            n_pe=8, tenants=TenantSpec(grace=5), auto_release=False,
            backfill="none")).session(),
        lambda: ensemble.init_ensemble(2, 16, 8),
        lambda: lane_tables((TenantSpec(), None), 16, 4),
        lambda: pad_streams([[job], []], 8),
        lambda: ReservationService(ServiceConfig(n_pe=8, lanes=2)).session(),
        lambda: ReservationService(ServiceConfig(
            n_pe=8, lanes=2, chunk_size=None, machine_sizes=(8, 6),
            backfill=("easy", "none"))).session(),
        lambda: ReservationService(ServiceConfig(
            n_pe=8, lanes=2, tenants=(TenantSpec(), None))).session(),
        lambda: simulate_grid(GridSpec(n_pe=8, n_jobs=4, seeds=(0,),
                                       arrival_factors=(1.0,))),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.warns(DeprecationWarning), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        scheduler.make_scheduler(8)
    # asking for the CPU works
    assert timeline.init_state(16, 8, device="cpu").tl.capacity == 16
    assert init_table(TenantSpec(), 16, 4, "cpu").pend_tenant.shape == (16,)
    assert len(ensemble.init_ensemble(2, 16, 8, device="cpu")) == 2


def test_host_engines_run_only_when_named():
    """``engine="host"`` / ``"list"`` are the reference's CPU engines,
    picked explicitly; nothing else reaches them."""
    job = ARRequest(0, 0, 5, 10, 1)
    for engine in ("host", "list"):
        s = ReservationService(ServiceConfig(n_pe=8, engine=engine)).session()
        assert s.offer([job]).n_accepted == 1
        assert type(s.engine) is scheduler.ENGINES[engine]
        assert simulate([job], 8, Policy.FF, engine=engine).n_accepted == 1
    assert ServiceConfig(n_pe=8).engine == "device"
    assert set(scheduler.ENGINES) == {"list", "host", "device"}


def test_kernel_wrappers_never_fall_back():
    tl = timeline.empty(16, 64, "cpu")
    starts = torch.tensor([0, 5], dtype=torch.int32)
    # the CUDA wrappers refuse CPU tensors
    with pytest.raises(ValueError, match="CUDA tensors"):
        availscan.availscan(tl.times, tl.occ, starts, 4, 0, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        availscan.availscan_select(tl.times, tl.occ, starts, 4, 0, 1, 0, 64)
    # a tensor off the CPU goes to the kernel wrapper, which raises,
    # rather than to the plain version
    meta = timeline.Timeline(tl.times.to("meta"), tl.occ.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.availability_rectangles(meta, starts.to("meta"), 4, 0, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.search_select(meta, starts.to("meta"), 4, 0, 1, 0, 64)
    # the multi-resource wrappers alike
    spec = ResourceSpec((64, 8))
    lay = device_layout(spec, torch.device("cpu"))
    mr = timeline.empty(16, 64, "cpu", words=spec.total_words)
    with pytest.raises(ValueError, match="CUDA tensors"):
        availscan.availscan_mr(mr.times, mr.occ, starts, lay.valid_mask,
                               lay.plane_of_word, 2, 4, 0, n_pe=64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        availscan.availscan_select_mr(
            mr.times, mr.occ, starts, lay.valid_mask, lay.plane_of_word,
            lay.zero_tail, 4, 0, 1, 0, n_pe=64)
    meta_mr = timeline.Timeline(mr.times.to("meta"), mr.occ.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.availability_rectangles(meta_mr, starts.to("meta"), 4, 0, 64,
                                    rspec=spec)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.search_select(meta_mr, starts.to("meta"), 4, 0, 1, 0, 64,
                          rspec=spec)
    assert set(availscan.LAUNCHES.values()) == {0}
    assert set(availscan.LAUNCHES) == {"availscan", "availscan_select",
                                       "availscan_mr", "availscan_select_mr"}
    # the CPU takes the plain version
    row = ops.search_select(tl, starts, 4, 0, 1, 0, 64)
    assert bool(row["found"]) and int(row["best"]) == 0
    row = ops.search_select(mr, starts, 4, 0, 1, 0, 64, rspec=spec,
                            demand_tail=torch.tensor([8], dtype=torch.int32))
    assert bool(row["found"]) and int(row["best"]) == 0
