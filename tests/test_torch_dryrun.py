"""The port's dry-run against the JAX package's, on the CPU.

``repro_torch.launch.dryrun`` writes one record per (arch x shape x
mesh) cell to a temporary directory: every cell present, none
``FAILED``, exactly the 16 ``long_500k`` skips of ``applicable``,
positive roofline terms and analytic collective bytes, every decode
cell memory-bound, every serve cell within the H100's 80 GB.  The
reference's side is computed in one subprocess that imports
``repro.launch.dryrun`` (so 512 host devices) and builds each cell's
shapes with ``jax.eval_shape``, its spec functions and
``_sharded_bytes``, without lowering: per-card argument bytes,
microbatches, input and cache shapes and the activation estimate equal
the port's in every cell.  The port's step runs on ``meta`` in a few
cheap cells here (``META_RUN``); the whole sweep with every step is
``python -m repro_torch.launch.dryrun``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import applicable as ref_applicable
from repro.configs import get_config as ref_config
from repro.configs import shape_by_name as ref_shape
from repro_torch.configs import (
    ALL_SHAPES,
    ARCH_IDS,
    ShapeConfig,
    applicable,
    get_config,
)
from repro_torch.launch import dryrun, specs
from repro_torch.models import transformer as tf
from repro_torch.serve import engine

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [s.name for s in ALL_SHAPES]
#: the (arch, shape) cells whose step runs on ``meta`` here, both meshes
META_RUN = {("seamless-m4t-medium", "decode_32k"),
            ("llama-3.2-vision-11b", "decode_32k"),
            ("zamba2-7b", "long_500k")}

# The reference's side of every cell, without lowering.  The import of
# repro.launch.dryrun sets XLA_FLAGS for 512 host devices before jax.
REF_SCRIPT = r'''
import json, sys
from repro.launch import dryrun as d
import jax, jax.numpy as jnp
from repro.configs import ALL_SHAPES, ARCH_IDS, applicable, get_config
from repro.launch import specs as specs_lib
from repro.launch.mesh import make_production_mesh
from repro.models import transformer as tf_lib
from repro.models.common import mesh_context
from repro.serve import engine as serve_lib
from repro.sharding import rules
from repro.train import optim as optim_lib


def name(path):
    out = []
    for p in path:
        for attr in ("key", "name", "idx"):
            if hasattr(p, attr):
                out.append(str(getattr(p, attr)))
                break
    return ".".join(out)


def shapes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {name(p): [list(l.shape), str(l.dtype)] for p, l in flat}


meshes = {m: make_production_mesh(multi_pod=m) for m in (False, True)}
out = []
for arch in ARCH_IDS:
    cfg = get_config(arch)
    params_s = jax.eval_shape(lambda k: tf_lib.init_params(cfg, k),
                              jax.ShapeDtypeStruct((2,), jnp.uint32))
    prefill_cache = None
    for shape in ALL_SHAPES:
        for multi in (False, True):
            rec = {"arch": arch, "shape": shape.name,
                   "mesh": "2x16x16" if multi else "16x16"}
            out.append(rec)
            ok, why = applicable(cfg, shape)
            if not ok:
                rec.update(status="SKIPPED", reason=why)
                continue
            mesh = meshes[multi]
            p_specs = rules.to_named(mesh, rules.param_specs(params_s))
            mb = specs_lib.default_microbatches(cfg, shape, mesh)
            mem = {"param_bytes": d._sharded_bytes(params_s, p_specs)}
            cache = None
            if shape.kind == "train":
                big = cfg.d_model >= 7000
                opt_cfg = optim_lib.OptConfig(
                    state_dtype="bfloat16" if big else "float32")
                opt_s = jax.eval_shape(
                    lambda p: optim_lib.init(p, opt_cfg), params_s)
                z = rules.to_named(mesh, rules.zero_specs(
                    rules.param_specs(params_s), params_s, mesh))
                mem["opt_state_bytes"] = d._sharded_bytes(
                    (opt_s.mu, opt_s.nu), (z, z))
                inputs, sh = specs_lib.train_batch_specs(cfg, shape, mesh,
                                                         mb)
                mem["batch_bytes"] = d._sharded_bytes(inputs, sh)
            elif shape.kind == "prefill":
                inputs, _ = specs_lib.serve_specs(cfg, shape, mesh)
                if prefill_cache is None:
                    step = serve_lib.make_prefill_step(
                        cfg, max_len=shape.seq_len)
                    extra = {k: v for k, v in inputs.items()
                             if k != "tokens"} or None
                    with mesh_context(mesh):
                        prefill_cache = jax.eval_shape(
                            step, params_s, inputs["tokens"], extra)[1]
                cache = prefill_cache
            else:
                in_s, in_sh = specs_lib.serve_specs(cfg, shape, mesh)
                mem["cache_bytes"] = d._sharded_bytes(in_s["cache"],
                                                      in_sh["cache"])
                cache = in_s["cache"]
                inputs = {k: v for k, v in in_s.items() if k != "cache"}
            rec.update(status="OK", microbatches=mb, memory=mem,
                       inputs=shapes(inputs),
                       act=d._activation_estimate(cfg, shape, mesh, mb))
            if cache is not None:
                rec["cache"] = shapes(cache)
json.dump(out, open(sys.argv[1], "w"))
'''


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every port test file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell_path(out, arch, shape, multi):
    return out / f"{arch}__{shape}__{'multi' if multi else 'single'}.json"


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The port's sweep of all 80 cells, written to a temporary
    directory and read back: ``{(arch, shape, mesh): record}``."""
    out = tmp_path_factory.mktemp("dryrun")
    n = dryrun.sweep(dryrun.cells(ARCH_IDS, SHAPES, (False, True)), out,
                     run=lambda a, s, _: (a, s) in META_RUN,
                     log=lambda _: None)
    assert n == {"ok": 64, "skipped": 16, "failed": 0}
    recs = [json.loads(p.read_text()) for p in sorted(out.glob("*.json"))]
    return {(r["arch"], r["shape"], r["mesh"]): r for r in recs}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's side of every cell, from one subprocess."""
    path = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(path)],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {(r["arch"], r["shape"], r["mesh"]): r
            for r in json.loads(path.read_text())}


def test_every_cell_present_and_green(records):
    assert len(records) == len(ARCH_IDS) * len(ALL_SHAPES) * 2
    by_status = {}
    for r in records.values():
        by_status.setdefault(r["status"], []).append(r)
    assert "FAILED" not in by_status, by_status.get("FAILED")
    skips = by_status.get("SKIPPED", [])
    assert all(r["shape"] == "long_500k" for r in skips)
    assert len(skips) == 16     # 8 full-attention archs x 2 meshes


def test_skips_match_applicability_rules(records):
    for (arch, shape, _), r in records.items():
        ok, why = applicable(get_config(arch), next(
            s for s in ALL_SHAPES if s.name == shape))
        assert (ok, why) == ref_applicable(ref_config(arch),
                                           ref_shape(shape))
        assert (r["status"] == "SKIPPED") == (not ok)
        if not ok:
            assert r["reason"] == why


def test_roofline_terms_and_analytic_collectives_positive(records):
    for r in records.values():
        if r["status"] != "OK":
            continue
        t, a = r["roofline"], r["analytic"]
        assert t["compute_s"] > 0 and t["memory_s"] > 0
        assert t["collective_s"] > 0
        assert t["dominant"] in ("compute", "memory", "collective")
        assert a["model_flops"] > 0
        assert a["coll_intra_bytes"] > 0
        assert a["coll_inter_bytes"] >= 0
        if r["mesh"] == "16x16" or r["kind"] == "train":
            # one pod: nothing crosses pods; two: the gradients do
            assert (a["coll_inter_bytes"] > 0) == (r["mesh"] != "16x16")


def test_decode_cells_are_memory_bound(records):
    for r in records.values():
        if r["status"] == "OK" and r["kind"] == "decode":
            assert r["roofline"]["dominant"] == "memory", \
                (r["arch"], r["shape"])


def test_serve_memory_fits_80g(records):
    for r in records.values():
        if r["status"] == "OK" and r["kind"] != "train":
            m = r["memory"]
            assert m["model_fits_80g_hbm"], (r["arch"], r["shape"],
                                             r["mesh"])
            assert m["model_per_device_total"] < dryrun.HBM_BYTES


def test_cells_equal_the_reference(records, reference):
    """Per-card argument bytes (each part), microbatches, input and
    cache shapes and dtypes, and the activation estimate, cell by cell."""
    assert sorted(records) == sorted(reference)
    for key, want in reference.items():
        got = records[key]
        assert got["status"] == want["status"], key
        if want["status"] != "OK":
            assert got["reason"] == want["reason"]
            continue
        mem = got["memory"]
        for part, n in want["memory"].items():
            assert mem[part] == n, (key, part)
        assert mem["model_args_bytes"] == sum(want["memory"].values())
        assert got["microbatches"] == want["microbatches"], key
        assert got["inputs"] == want["inputs"], key
        assert got.get("cache") == want.get("cache"), key
        assert mem["model_act_bytes"] == int(want["act"]), key
    # the meta runs: the decode cells, and the prefill caches below
    for (arch, shape), multi in ((c, m) for c in META_RUN
                                 for m in ("16x16", "2x16x16")):
        assert records[(arch, shape, multi)]["meta_run"]


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llama-3.2-vision-11b", "qwen3-4b"])
def test_prefill_on_meta_gives_the_decode_cache(arch):
    """At full width and depth on ``meta`` (a 256-token prompt stands in
    for the 32k one), the prefill's cache is the one ``specs.
    decode_cache`` gives the decode cells, leaf for leaf; and the
    prefill needs its frontend input."""
    cfg = get_config(arch)
    shape = ShapeConfig("prefill_256", 256, 2, "prefill")
    params = tf.Transformer(cfg, device="meta")
    inputs, _ = specs.serve_specs(cfg, shape,
                                  dryrun.make_placeholder_mesh())
    cache = dryrun._run_step(cfg, shape, params, None, None, inputs, 1)
    assert dryrun.shapes(cache) == dryrun.shapes(
        specs.decode_cache(cfg, 2, 256))
    if cfg.family in ("encdec", "vlm"):
        with pytest.raises(KeyError):
            engine.make_prefill_step(cfg)(params, inputs["tokens"])


def test_cli_runs_without_jax(tmp_path):
    """``python -m repro_torch.launch.dryrun`` with an importable ``jax``
    that raises: one vlm cell with its meta run, and the skip."""
    fake = tmp_path / "fake"
    (fake / "jax").mkdir(parents=True)
    (fake / "jax" / "__init__.py").write_text(
        "raise ImportError('the port must not import jax')\n")
    env = dict(os.environ, PYTHONPATH=f"{fake}:{ROOT / 'src'}",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama-3.2-vision-11b", "--shape", "decode_32k", "--mesh", "multi",
         "--out", str(tmp_path / "out")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dry-run complete: 1 ok, 0 skipped, 0 failed" in proc.stdout
    rec = json.loads(_cell_path(tmp_path / "out", "llama-3.2-vision-11b",
                                "decode_32k", True).read_text())
    assert rec["status"] == "OK" and rec["meta_run"] and rec["mesh"] == \
        "2x16x16"
    assert rec["cache"]["cross_kv.0"] == [[8, 128, 1601, 8, 128],
                                          "bfloat16"]
