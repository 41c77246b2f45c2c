"""Meta-device input stand-ins and their specs for every dry-run cell.

The port of ``repro/launch/specs.py``.  Where the reference returns
``jax.ShapeDtypeStruct`` s and ``NamedSharding`` s, the port returns
tensors on the ``meta`` device (shapes and dtypes, nothing allocated)
and the placement rules' tuple specs
(:func:`repro_torch.sharding.rules.fit_sharding`), for the step each
cell runs:

* ``train``   -> ``train_step(params, opt_state, batch)`` with batch
  leaves ``[mb, B/mb, ...]`` (one microbatch at a time in the step);
* ``prefill`` -> ``prefill(params, tokens, extra)``;
* ``decode``  -> ``decode_step(params, cache, tokens, extra)`` with the
  cache shaped for ``seq_len`` context (the decode cells' semantics:
  one new token against a full KV cache / recurrent state).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import Mesh, data_shards
from repro_torch.models import transformer as tf_lib
from repro_torch.sharding.rules import Spec, _axes, fit_sharding

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                         mesh: Optional[Mesh]) -> int:
    if shape.kind != "train":
        return 1
    shards = data_shards(mesh) if mesh is not None else 1
    per_shard = max(shape.global_batch // shards, 1)
    # Larger models accumulate more to bound live activations.
    want = 8 if cfg.d_model >= 3584 else (4 if cfg.d_model >= 2048 else 2)
    return max(1, min(want, per_shard))


def _extra_struct(cfg: ModelConfig, batch_dims: Tuple[int, ...]
                  ) -> Dict[str, torch.Tensor]:
    extra: Dict[str, torch.Tensor] = {}
    if cfg.family == "encdec":
        extra["enc_frames"] = _meta(
            (*batch_dims, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        extra["image_embeds"] = _meta(
            (*batch_dims, cfg.vision_tokens, cfg.vision_dim), torch.bfloat16)
    return extra


def _bd(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                      microbatches: int):
    b_mb = shape.global_batch // microbatches
    structs: Dict[str, torch.Tensor] = {
        "tokens": _meta((microbatches, b_mb, shape.seq_len), torch.int32),
        "labels": _meta((microbatches, b_mb, shape.seq_len), torch.int32),
    }
    structs.update(_extra_struct(cfg, (microbatches, b_mb)))
    bd = _bd(mesh)
    shardings = {
        k: fit_sharding(mesh, v.shape, (None, bd) + (None,) * (v.dim() - 2))
        for k, v in structs.items()
    }
    return structs, shardings


def decode_cache(cfg: ModelConfig, batch: int, seq_len: int
                 ) -> Dict[str, Any]:
    """The decode cache of ``seq_len`` context on ``meta``: the family's
    :func:`~repro_torch.models.transformer.init_decode_cache` and, for
    the encdec and vlm families, the prefill's ``cross_kv`` (bfloat16
    ``[n_cross, B, S_src, Hkv, hd]`` K and V)."""
    cache = tf_lib.init_decode_cache(cfg, batch, seq_len, device=META)
    if cfg.family in ("encdec", "vlm"):
        src = cfg.enc_seq if cfg.family == "encdec" else cfg.vision_tokens
        n_cl = (cfg.n_layers if cfg.family == "encdec"
                else cfg.n_layers // cfg.cross_attn_every)
        shape = (n_cl, batch, src, cfg.n_kv_heads, cfg.hd)
        cache["cross_kv"] = (_meta(shape, torch.bfloat16),
                             _meta(shape, torch.bfloat16))
    return cache


def serve_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh):
    bd = _bd(mesh)
    b = shape.global_batch
    if shape.kind == "prefill":
        structs = {"tokens": _meta((b, shape.seq_len), torch.int32),
                   **_extra_struct(cfg, (b,))}
        shardings = {
            k: fit_sharding(mesh, v.shape, (bd,) + (None,) * (v.dim() - 1))
            for k, v in structs.items()
        }
        return structs, shardings
    # decode: cache for seq_len context + one token
    cache = decode_cache(cfg, b, shape.seq_len)
    structs = {"cache": cache, "tokens": _meta((b, 1), torch.int32),
               **_extra_struct(cfg, (b,))}
    shardings = {"cache": cache_shardings(cache, mesh),
                 "tokens": fit_sharding(mesh, (b, 1), (bd, None))}
    for k, v in structs.items():
        if k not in shardings:
            shardings[k] = fit_sharding(mesh, v.shape,
                                        (bd,) + (None,) * (v.dim() - 1))
    return structs, shardings


def cache_shardings(cache, mesh: Mesh):
    """Decode-cache specs: batch over the data axes; the first divisible
    trailing axis over ``"model"`` (S for attention caches, which is
    context-parallel decode; heads / state lanes for recurrent states).
    Axes that do not divide the mesh extent stay replicated.  Named
    tuples, tuples and dicts keep their structure; ``pos`` (0-d) is
    replicated."""
    bd = _bd(mesh)
    bd_n = 1
    for a in bd:
        bd_n *= mesh.shape[a]
    model_n = mesh.shape.get("model", 1)

    def spec(leaf: torch.Tensor) -> Spec:
        nd = leaf.dim()
        if nd == 0:
            return ()
        axes: list = [None] * nd
        b_ax = 1 if nd >= 2 else 0
        if bd and leaf.shape[b_ax] % bd_n == 0:
            axes[b_ax] = _axes(bd)
        for i in range(b_ax + 1, nd):
            if leaf.shape[i] % model_n == 0:
                axes[i] = "model"
                break
        return tuple(axes)

    def walk(node):
        if isinstance(node, torch.Tensor):
            return spec(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        return tuple(walk(v) for v in node)
    return walk(cache)
