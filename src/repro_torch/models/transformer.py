"""Model assembly: the dense and MoE families.

The port of ``repro/models/transformer.py`` for ``family`` in
``("dense", "moe")``:

    params = init_params(cfg, seed=0, device=dev)        # a Transformer
    out = forward(params, cfg, tokens, collect=True)     # hidden, aux, kv
    loss, metrics = loss_fn(params, cfg, batch)          # forward only
    logits, cache = prefill(params, cfg, tokens, max_len=T + n)
    logits, cache = decode_step(params, cfg, cache, tokens)

The reference stacks its layers ``[L, ...]`` and runs them under
``lax.scan``; the port holds one :class:`Block` per layer in an
``nn.ModuleList`` with the reference's leaf names (``layers.<i>.attn.wq``
is the reference's ``layers.attn.wq[i]``), and
:func:`params_from_reference` carries the reference's weights across.
The decode cache keeps the reference's stacked layout (``k`` / ``v``
``[L, B, S, Hkv, hd]``; ``pos`` a 0-d int32 tensor on the card), and
each step writes it in place.  Decode computes RoPE angles for the
current position only, where the reference indexes a ``1 << 20``-row
table that ``jit`` folds away.

``seq_parallel`` (a sharding constraint in the reference) changes
nothing on one device.  The other families (hybrid, ssm, encdec, vlm)
are not ported yet and raise :class:`NotImplementedError`.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (
    dense_init,
    embed_init,
    param,
    rms_norm,
    rope_angles,
)

#: the families this module runs
FAMILIES = ("dense", "moe")

#: the ROADMAP item that ports each other family
_UNPORTED = {
    "hybrid": "ROADMAP A17a (models/ssm.py, the hybrid family)",
    "ssm": "ROADMAP A17a (models/xlstm.py, the ssm family)",
    "encdec": "ROADMAP A17b (the encdec family)",
    "vlm": "ROADMAP A17b (the vlm family)",
}


def check_family(cfg: ModelConfig) -> None:
    """Refuse a family this module does not run (no fallback)."""
    if cfg.family in FAMILIES:
        return
    if cfg.family in _UNPORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet: "
            f"{_UNPORTED[cfg.family]}")
    raise ValueError(cfg.family)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# modules and init
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer: ``ln1``, ``attn``, ``ln2`` and ``mlp`` or ``moe``."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = param((d,), dtype, device)
        self.attn = attn_lib.Attention(cfg, dtype, device)
        self.ln2 = param((d,), dtype, device)
        if cfg.family == "moe":
            self.moe = moe_lib.MoE(cfg, dtype, device)
            self.mlp = None
        else:
            self.mlp = mlp_lib.MLP(d, cfg.d_ff, dtype, device)
            self.moe = None

    def reset(self, gen) -> None:
        self.ln1.fill_(1)
        self.attn.reset(gen)
        self.ln2.fill_(1)
        (self.moe if self.moe is not None else self.mlp).reset(gen)


class Transformer(nn.Module):
    """The parameters of a dense or MoE decoder: ``tok_embed``
    ``[V, d]``, ``final_norm``, ``lm_head`` ``[d, V]`` (absent with
    ``tie_embeddings``) and ``layers``.  Construction allocates without
    initialising (on ``device="meta"`` it allocates nothing)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        check_family(cfg)
        if device is None or torch.device(device).type != "meta":
            device = resolve_device(device)
        dt = _dtype(cfg)
        self.cfg = cfg
        self.tok_embed = param((cfg.vocab, cfg.d_model), dt, device)
        self.final_norm = param((cfg.d_model,), dt, device)
        self.lm_head = None if cfg.tie_embeddings else param(
            (cfg.d_model, cfg.vocab), dt, device)
        self.layers = nn.ModuleList(
            Block(cfg, dt, device) for _ in range(cfg.n_layers))

    @property
    def head(self) -> torch.Tensor:
        """The ``[d, V]`` output projection (tied: ``tok_embed.T``)."""
        return self.tok_embed.T if self.lm_head is None else self.lm_head

    def reset(self, gen: Optional[torch.Generator]) -> "Transformer":
        cfg = self.cfg
        self.tok_embed.copy_(embed_init(gen, self.tok_embed.shape,
                                        self.tok_embed.dtype,
                                        self.tok_embed.device))
        self.final_norm.fill_(1)
        if self.lm_head is not None:
            self.lm_head.copy_(dense_init(gen, self.lm_head.shape,
                                          cfg.d_model, self.lm_head.dtype,
                                          self.lm_head.device))
        for blk in self.layers:
            blk.reset(gen)
        return self


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Transformer:
    """Random weights from a seeded generator on ``device`` (``None``:
    cuda), drawn as the reference draws them: float32 normals scaled,
    then cast to ``cfg.dtype``; norms are ones."""
    model = Transformer(cfg, device)
    dev = model.tok_embed.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return model.reset(gen)


def _to_f32(a) -> np.ndarray:
    """A reference leaf as float32 (bfloat16 widens exactly)."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "V" or \
        a.dtype.name == "bfloat16" else a


def params_from_reference(tree: Mapping[str, Any], cfg: ModelConfig,
                          device: DeviceLike = None) -> Transformer:
    """The reference's ``init_params`` tree as the port's parameters.

    ``tree`` is the reference's nested dict with numpy (or array-like)
    leaves and its stacked ``[L, ...]`` layer leaves; layer ``i`` of the
    port takes row ``i`` of each.  bfloat16 arrays go through float32,
    which is exact both ways.
    """
    model = Transformer(cfg, device)
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(prefix + (k,), v)
            else:
                flat[prefix + (k,)] = _to_f32(v)
    walk((), tree)
    seen = set()
    for name, p in model.named_parameters():
        parts = tuple(name.split("."))
        if parts[0] == "layers":
            key, row = ("layers",) + parts[2:], int(parts[1])
            val = flat[key][row]
        else:
            key, val = parts, flat[parts]
        seen.add(key)
        if tuple(val.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {val.shape}, "
                             f"port shape {tuple(p.shape)}")
        p.copy_(torch.tensor(val).to(p.dtype))
    missing = set(flat) - seen
    if missing:
        raise ValueError(f"reference leaves with no port parameter: "
                         f"{sorted(missing)}")
    return model


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _ffn(blk: Block, x: torch.Tensor, cfg: ModelConfig):
    h = rms_norm(x, blk.ln2, cfg.norm_eps)
    if blk.moe is not None:
        return moe_lib.moe(blk.moe, h, cfg)
    return mlp_lib.mlp(blk.mlp, h), {}


def _attn_block(blk: Block, x, cfg, rope, window=0, return_kv=False):
    res = attn_lib.self_attention(
        blk.attn, rms_norm(x, blk.ln1, cfg.norm_eps), cfg, rope,
        window=window, return_kv=return_kv)
    h, kv = res if return_kv else (res, None)
    x = x + h
    h, aux = _ffn(blk, x, cfg)
    return x + h, aux, kv


def _attn_block_decode(blk: Block, x, cache, pos, cfg, rope, window=0):
    h, cache = attn_lib.decode_attention(
        blk.attn, rms_norm(x, blk.ln1, cfg.norm_eps), cache, pos, cfg,
        rope, window=window)
    x = x + h
    h, _ = _ffn(blk, x, cfg)
    return x + h, cache


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

class ForwardOut(NamedTuple):
    hidden: torch.Tensor
    aux: Dict[str, torch.Tensor]
    kv: Any           # per-layer roped (K, V) lists (collect=True) or None
    states: Any       # recurrent states: None for dense and MoE


def forward(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            extra: Optional[Dict[str, torch.Tensor]] = None,
            collect: bool = False) -> ForwardOut:
    """Full-sequence forward.  ``collect=True`` gathers each layer's
    roped K / V for the decode cache (``kv = (ks, vs)``, one tensor per
    layer).  ``extra`` (the other families' inputs) is unused here."""
    check_family(cfg)
    t = tokens.shape[1]
    x = params.tok_embed[tokens]
    rope = attn_lib.make_rope(cfg, max(t, 1), x.device)
    auxs, ks, vs = [], [], []
    for blk in params.layers:
        x, a, kv = _attn_block(blk, x, cfg, rope, return_kv=collect)
        auxs.append(a)
        if collect:
            ks.append(kv[0])
            vs.append(kv[1])
    aux: Dict[str, torch.Tensor] = {}
    if cfg.family == "moe":
        aux = {k: torch.stack([a[k] for a in auxs]).mean()
               for k in auxs[0]}
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return ForwardOut(hidden=x, aux=aux, kv=(ks, vs) if collect else None,
                      states=None)


def loss_fn(params: Transformer, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's training loss, forward only: masked next-token
    NLL (labels < 0 ignored) plus, for MoE, 0.01 x load balance and
    1e-3 x router z."""
    out = forward(params, cfg, batch["tokens"])
    logits = (out.hidden @ params.head).float()
    labels = batch["labels"]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).float()
    nll = torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
    loss = nll
    metrics = {"nll": nll}
    if "load_balance" in out.aux:
        loss = loss + 0.01 * out.aux["load_balance"] \
            + 1e-3 * out.aux["router_z"]
        metrics.update(out.aux)
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode
# ---------------------------------------------------------------------------

def _window(cfg: ModelConfig) -> int:
    return cfg.window if cfg.long_attention == "window" else 0


def _attn_cache_len(cfg: ModelConfig, max_len: int) -> int:
    if cfg.long_attention == "window":
        return min(max_len, cfg.window)
    return max_len


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Zero decode cache: ``pos`` and the stacked per-layer KV cache."""
    check_family(cfg)
    dev = resolve_device(device)
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "attn": attn_lib.init_cache(
                cfg, batch, _attn_cache_len(cfg, max_len), _dtype(cfg),
                dev, n_layers=cfg.n_layers)}


def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            extra: Optional[Dict[str, torch.Tensor]] = None,
            max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process the prompt, build the decode cache, return the last
    position's float32 logits ``[B, V]``."""
    b, t = tokens.shape
    max_len = max_len or t
    out = forward(params, cfg, tokens, extra, collect=True)
    logits = out.hidden[:, -1] @ params.head
    cache = init_decode_cache(cfg, b, max_len, tokens.device)
    cache["pos"].fill_(t)
    ks, vs = out.kv
    c = cache["attn"]
    take = min(t, c["k"].shape[2])
    for i, (k, v) in enumerate(zip(ks, vs)):
        k, v = k[:, t - take:t], v[:, t - take:t]
        if cfg.kv_cache_dtype == "int8":
            (k, k_sc), (v, v_sc) = attn_lib.quantize_kv(k), \
                attn_lib.quantize_kv(v)
            c["k_scale"][i, :, :take] = k_sc
            c["v_scale"][i, :, :take] = v_sc
        c["k"][i, :, :take] = k
        c["v"][i, :, :take] = v
    return logits.float(), cache


def decode_step(params: Transformer, cfg: ModelConfig,
                cache: Dict[str, Any], tokens: torch.Tensor,
                extra: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step.  tokens: [B, 1] -> float32 logits [B, V].

    Writes the step's K / V into ``cache`` in place and returns it with
    ``pos`` advanced; nothing crosses to the host.
    """
    check_family(cfg)
    pos = cache["pos"]
    b = tokens.shape[0]
    x = params.tok_embed[tokens]
    rope = rope_angles(cfg.hd, cfg.rope_theta, pos.expand(b, 1))
    window = _window(cfg)
    c = cache["attn"]
    for i, blk in enumerate(params.layers):
        x, _ = _attn_block_decode(
            blk, x, {name: t[i] for name, t in c.items()}, pos, cfg, rope,
            window=window)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = (x @ params.head)[:, 0].float()
    cache["pos"] = pos + 1
    return logits, cache
