"""Multi-pod dry-run: every (arch x shape x mesh) cell at full size.

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \
        [--out DIR] [--force] [--opt] [--no-run]

The port of ``repro/launch/dryrun.py``.  For each cell (10 archs x 4
shapes x the 16 x 16 and 2 x 16 x 16 production meshes) it records:

* ``status`` (``OK``, or ``SKIPPED`` with the ``reason`` of
  ``configs.applicable``) and the cell's ``microbatches``;
* the step's inputs (``inputs``: name -> shape and dtype) and its decode
  cache (``cache``: the prefill's output, the decode step's input);
* the exact per-card argument bytes (``memory``): the parameters under
  ``param_specs``; for train also the AdamW moments under
  ``zero_specs`` (bfloat16 moments where ``d_model >= 7000``) and the
  batch; for decode also the cache, each leaf's shard shape under its
  spec on the mesh; beside the modelled activation bytes and whether
  the total fits the NVIDIA H100 80GB HBM3 card's 80 GB;
* the analytic ``step_costs`` (``analytic``, with the collective bytes
  ``coll_intra_bytes`` / ``coll_inter_bytes``) and their roofline
  ``terms`` on the H100's constants (``roofline``).

What stands in for lowering: the parameters are a
``Transformer(cfg, device="meta")`` and the cell's step (the train step,
prefill, or one decode step) runs on ``meta`` inputs, so every shape is
checked at full size and nothing is allocated; the prefill's cache
shapes come from that run (``meta_run_s`` records its host seconds;
``--no-run`` skips it and records the cache the specs give).  The mesh
is the production shape over placeholder devices
(:func:`~repro_torch.launch.mesh.make_placeholder_mesh`).  Nothing is
compiled, so what the reference takes from its compiler has no
counterpart here and is not recorded: ``memory_analysis``,
``cost_analysis``, ``compile_s`` and the HLO text with its parsed
collectives (:func:`repro_torch.roofline.analysis.parse_collectives`
reads such text where there is some).

ZeRO places each stacked ``[L, ...]`` leaf of the reference's layout
(the checkpoints' layout, :func:`~repro_torch.models.transformer.
state_to_reference`), so every byte count is taken on that layout.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Iterable, Optional

import torch

from repro_torch.configs import (
    ALL_SHAPES,
    ARCH_IDS,
    applicable,
    get_config,
    shape_by_name,
)
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import Mesh, make_placeholder_mesh
from repro_torch.models import transformer as tf_lib
from repro_torch.roofline import analysis as roof
from repro_torch.serve import engine as serve_lib
from repro_torch.sharding import rules
from repro_torch.train import optim as optim_lib
from repro_torch.train import step as step_lib

#: the card's memory, bytes (NVIDIA H100 80GB HBM3)
HBM_BYTES = 80e9

OPT_OVERRIDES = dict(seq_parallel=True, moe_quant_dispatch=True,
                     kv_cache_dtype="int8")


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _pairs(structs, specs):
    """(tensor, spec) of every leaf, walking ``specs`` alongside
    ``structs`` (dicts by key, tuples and named tuples by position)."""
    if isinstance(structs, torch.Tensor):
        yield structs, specs
    elif isinstance(structs, dict):
        for k, v in structs.items():
            yield from _pairs(v, specs[k])
    else:
        if len(structs) != len(specs):
            raise ValueError(f"{len(structs)} entries, {len(specs)} specs")
        for v, sp in zip(structs, specs):
            yield from _pairs(v, sp)


def shapes(tree, prefix: str = "") -> Dict[str, list]:
    """``{path: [shape, dtype]}`` of a tree of tensors: dict keys,
    named-tuple fields and tuple indices joined by ``.``."""
    if isinstance(tree, torch.Tensor):
        return {prefix: [list(tree.shape), str(tree.dtype).split(".")[-1]]}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out: Dict[str, list] = {}
    for k, v in items:
        out.update(shapes(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def on_mesh(spec, mesh: Mesh):
    """``spec`` with the axes ``mesh`` lacks dropped (the reference's
    ``to_named``): the multi-pod rules' ``("pod", "data")`` reads
    ``"data"`` on one pod."""
    names = set(mesh.axis_names)
    axes = []
    for s in spec:
        if isinstance(s, (tuple, list)):
            kept = tuple(a for a in s if a in names)
            axes.append(rules._axes(kept) if kept else None)
        else:
            axes.append(s if s in names else None)
    return tuple(axes)


def _sharded_bytes(structs, specs, mesh: Mesh) -> int:
    """Exact per-card bytes of a tree of tensors under its specs."""
    sizes = mesh.shape
    total = 0
    for leaf, spec in _pairs(structs, specs):
        n = 1
        for i, dim in enumerate(leaf.shape):
            ax = spec[i] if i < len(spec) else None
            k = 1
            for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                k *= sizes[a]
            if dim % k:
                raise ValueError(f"dimension {dim} of {tuple(leaf.shape)} "
                                 f"does not divide over {ax} ({k})")
            n *= dim // k
        total += n * leaf.element_size()
    return total


def _activation_estimate(cfg, shape, mesh: Mesh, mb: int) -> float:
    """Modeled per-card peak activation bytes (bf16, rematerialised
    layers: one residual per layer per microbatch + one layer's working
    set)."""
    chips = mesh.size
    d = cfg.d_model
    n_lay = cfg.n_layers + cfg.n_enc_layers
    if shape.kind == "train":
        toks_mb = shape.global_batch * shape.seq_len / mb
        resid = n_lay * toks_mb * d * 2
        work = 6 * toks_mb * d * 2 + toks_mb * max(cfg.d_ff, d) * 2
        return (resid + work) / chips * 1.3
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        kv = (2 * n_lay * toks * cfg.n_kv_heads * cfg.hd * 2)
        work = 8 * toks * d * 2
        return (kv + work) / chips * 1.3
    toks = shape.global_batch
    return 4 * toks * d * max(cfg.n_layers, 1) * 2 / chips * 1.3


def _run_step(cfg, shape, params, opt_cfg, opt_state, inputs, mb):
    """The cell's step on ``meta``: returns the prefill's cache (else
    ``None``) after checking the outputs' shapes."""
    b = shape.global_batch
    if shape.kind == "train":
        params.requires_grad_(True)
        _, _, metrics = step_lib.make_train_step(cfg, opt_cfg, mb)(
            params, opt_state, inputs)
        if metrics["loss"].shape != () or metrics["grad_norm"].shape != ():
            raise ValueError(f"train step metrics {metrics}")
        return None
    if shape.kind == "prefill":
        extra = {k: v for k, v in inputs.items() if k != "tokens"} or None
        logits, cache = serve_lib.make_prefill_step(
            cfg, max_len=shape.seq_len)(params, inputs["tokens"], extra)
    else:
        extra = {k: v for k, v in inputs.items()
                 if k not in ("cache", "tokens")} or None
        logits, cache = serve_lib.make_decode_step(cfg)(
            params, inputs["cache"], inputs["tokens"], extra)
        cache = None
    if tuple(logits.shape) != (b, cfg.vocab):
        raise ValueError(f"logits {tuple(logits.shape)}")
    return cache


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               opt: bool = False, run: bool = True) -> dict:
    """One cell's record (module docstring); ``run=False`` skips the
    meta run of its step."""
    cfg = get_config(arch)
    if opt:
        cfg = dataclasses.replace(cfg, **OPT_OVERRIDES)
    shape = shape_by_name(shape_name)
    ok, why = applicable(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": _mesh_name(multi_pod), "kind": shape.kind}
    if not ok:
        rec.update(status="SKIPPED", reason=why)
        return rec

    mesh = make_placeholder_mesh(multi_pod=multi_pod)
    t0 = time.time()
    params = tf_lib.Transformer(cfg, device="meta")
    stacked = tf_lib.state_to_reference(params, device="meta")
    p_specs = rules.param_specs(stacked)
    mb = specs_lib.default_microbatches(cfg, shape, mesh)
    rec["microbatches"] = mb

    param_bytes = _sharded_bytes(
        stacked, _map_specs(p_specs, lambda s: on_mesh(s, mesh)), mesh)
    mem = {"param_bytes": param_bytes}
    opt_cfg = opt_state = None
    if shape.kind == "train":
        big = cfg.d_model >= 7000   # 1T-class: bf16 moments
        opt_cfg = optim_lib.OptConfig(
            state_dtype="bfloat16" if big else "float32")
        opt_state = optim_lib.init(params, opt_cfg)
        _, ref_opt = tf_lib.state_to_reference(params, opt_state,
                                               device="meta")
        z_specs = _map_specs(rules.zero_specs(p_specs, stacked, mesh),
                             lambda s: on_mesh(s, mesh))
        mem["opt_state_bytes"] = _sharded_bytes(
            (ref_opt.mu, ref_opt.nu), (z_specs, z_specs), mesh)
        inputs, in_specs = specs_lib.train_batch_specs(cfg, shape, mesh, mb)
        mem["batch_bytes"] = _sharded_bytes(inputs, in_specs, mesh)
        cache = None
    else:
        inputs, in_specs = specs_lib.serve_specs(cfg, shape, mesh)
        if shape.kind == "decode":
            cache = inputs["cache"]
            mem["cache_bytes"] = _sharded_bytes(cache, in_specs["cache"],
                                                mesh)
        else:
            cache = specs_lib.decode_cache(cfg, shape.global_batch,
                                           shape.seq_len)
    rec["specs_s"] = round(time.time() - t0, 3)
    rec["inputs"] = shapes({k: v for k, v in inputs.items()
                            if k != "cache"})
    if run:
        t0 = time.time()
        out = _run_step(cfg, shape, params, opt_cfg, opt_state, inputs, mb)
        rec["meta_run_s"] = round(time.time() - t0, 3)
        if out is not None:
            cache = out
    rec["meta_run"] = run
    if cache is not None:
        rec["cache"] = shapes(cache)
    args_dev = sum(mem.values())
    act_dev = _activation_estimate(cfg, shape, mesh, mb)
    costs = roof.step_costs(
        cfg, shape, mesh.shape, microbatches=mb,
        opt_state_bytes_per_param=(4 if cfg.d_model >= 7000 else 8))
    mem.update(model_args_bytes=args_dev, model_act_bytes=int(act_dev),
               model_per_device_total=int(args_dev + act_dev),
               model_fits_80g_hbm=bool(args_dev + act_dev < HBM_BYTES))
    rec.update(status="OK", memory=mem, analytic=dataclasses.asdict(costs),
               roofline=costs.terms(mesh.size))
    return rec


def _map_specs(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_specs(v, fn) for k, v in tree.items()}
    return fn(tree)


def cells(archs: Iterable[str], shapes_: Iterable[str],
          meshes: Iterable[bool]):
    """Every (arch, shape, multi_pod) in sweep order."""
    return [(a, s, m) for a in archs for s in shapes_ for m in meshes]


def sweep(todo, out: Optional[Path] = None, opt: bool = False,
          run=True, force: bool = True, log=print,
          records: Optional[list] = None) -> Dict[str, int]:
    """Record every cell of ``todo`` (:func:`cells`), each into
    ``out/<arch>__<shape>__<single|multi>.json`` when ``out`` is given
    (kept unless ``force``) and appended to ``records`` when that is a
    list.  ``run`` is a bool or a predicate of ``(arch, shape,
    multi_pod)`` choosing the cells whose step runs on ``meta``.  Returns the counts ``{"ok",
    "skipped", "failed"}``."""
    n = {"ok": 0, "skipped": 0, "failed": 0}
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    for arch, shape, multi in todo:
        tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
        path = None if out is None else out / f"{tag}.json"
        if path is not None and path.exists() and not force:
            log(f"[cached] {tag}")
            continue
        do_run = run(arch, shape, multi) if callable(run) else run
        t0 = time.time()
        try:
            rec = lower_cell(arch, shape, multi, opt=opt, run=do_run)
        except Exception as e:                     # noqa: BLE001
            rec = {"arch": arch, "shape": shape, "mesh": _mesh_name(multi),
                   "status": "FAILED", "error": str(e),
                   "traceback": traceback.format_exc()}
        rec["cell_s"] = round(time.time() - t0, 3)
        if records is not None:
            records.append(rec)
        if path is not None:
            path.write_text(json.dumps(rec, indent=2))
        st = rec["status"]
        n[st.lower()] += 1
        if st == "OK":
            r, m = rec["roofline"], rec["memory"]
            log(f"[dryrun] {tag} OK {rec['cell_s']}s "
                f"({'meta run' if do_run else 'specs only'}) "
                f"dom={r['dominant']} comp={r['compute_s']:.2e}s "
                f"mem={r['memory_s']:.2e}s coll={r['collective_s']:.2e}s "
                f"args={m['model_args_bytes'] / 1e9:.2f}GB "
                f"fits80={m['model_fits_80g_hbm']}")
        elif st == "SKIPPED":
            log(f"[dryrun] {tag} SKIPPED ({rec['reason'][:60]})")
        else:
            log(f"[dryrun] {tag} FAILED: {rec['error'][:200]}")
    log(f"dry-run complete: {n['ok']} ok, {n['skipped']} skipped, "
        f"{n['failed']} failed")
    return n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="beyond-paper perf knobs: SP + int8 MoE dispatch "
                         "+ int8 KV cache")
    ap.add_argument("--no-run", action="store_true",
                    help="record the specs only; run no step on meta")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shape_names = [s.name for s in ALL_SHAPES] if args.shape == "all" \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n = sweep(cells(archs, shape_names, meshes), Path(args.out),
              opt=args.opt, run=not args.no_run, force=args.force)
    if n["failed"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
