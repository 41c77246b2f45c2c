"""Model assembly: the dense, MoE, hybrid, ssm, encdec and vlm families.

The port of ``repro/models/transformer.py``:

    params = init_params(cfg, seed=0, device=dev)        # a Transformer
    out = forward(params, cfg, tokens, extra, collect=True)
    loss, metrics = loss_fn(params, cfg, batch)          # training
    logits, cache = prefill(params, cfg, tokens, extra, max_len=T + n)
    logits, cache = decode_step(params, cfg, cache, tokens)

The reference stacks its layers ``[L, ...]`` and runs them under
``lax.scan``; the port holds one :class:`Block` per layer in an
``nn.ModuleList`` with the reference's leaf names (``layers.<i>.attn.wq``
is the reference's ``layers.attn.wq[i]``), and
:func:`params_from_reference` carries the reference's weights across
(:func:`state_to_reference` / :func:`state_from_reference` carry a
training state, Adam moments included, both ways).  zamba2 (hybrid) is
groups of [the one ``shared_attn`` block; ``attn_every`` Mamba2 layers]
plus a remainder; xLSTM (ssm) is groups of [mLSTM layers; one sLSTM
layer] (``slstm_layers``).  encdec (seamless) runs a bidirectional
encoder (``enc_embed_proj``, ``enc_layers``, ``enc_norm``) over the
stub frontend's ``extra["enc_frames"]`` ``[B, S, d]``, and each decoder
layer is followed by an ungated cross-attention block of
``cross_layers`` against its K / V.  vlm (llama-vision) projects
``extra["image_embeds"]`` ``[B, N, vision_dim]`` with ``img_proj`` and
follows every ``cross_attn_every``-th decoder layer with a gated cross
block: its attention and MLP outputs are scaled by ``tanh`` of the
float32 0-d ``gate_attn`` / ``gate_mlp``, which start at zero, so an
untrained model ignores the image.  The reference picks the cross
block with ``lax.cond`` inside its scan; the port picks it on the host
in its loop of layers.  Prefill stores every cross layer's K / V as
``cache["cross_kv"]`` (a ``(k, v)`` pair stacked ``[n_cross, B, S,
Hkv, hd]``), which decode reads and never recomputes.  The decode
cache keeps the reference's
stacked layout (``k`` / ``v`` ``[L, B, S, Hkv, hd]``, the recurrent
states ``[L, ...]``; ``pos`` a 0-d int32 tensor on the card), and each
step writes it in place.  Decode computes RoPE angles for the current
position only, where the reference indexes a ``1 << 20``-row table that
``jit`` folds away.

Under grad (training) every layer is rematerialised, as the reference's
``jax.checkpoint(..., nothing_saveable)``: ``torch.utils.checkpoint``
(non-reentrant) around each block, and for the hybrid family around
each group and each Mamba layer inside it, as the reference's nested
scans, and for the encdec / vlm families around each encoder layer
and each decoder layer with its cross block.  ``seq_parallel`` (a
sharding constraint in the reference) changes nothing on one device.

A :class:`~repro_torch.configs.base.LatentConfig` (Kimi K2) is a
decoder of latent-attention layers (:class:`~repro_torch.models.
attention.LatentAttention`): its first ``first_k_dense`` layers have a
dense SwiGLU of ``dense_d_ff`` (kind ``"mla_mlp"``), the rest an expert
layer with a shared expert and sigmoid routing (``"mla_moe"``); its loss
is the NLL alone.  It has no serving path yet: :func:`prefill`,
:func:`decode_step` and ``forward(collect=True)`` refuse it.

When the span registry is active (:mod:`repro_torch.spans`), training
records ``attention.fwd`` / ``.bwd`` around each self-attention call,
``moe.fwd`` / ``.bwd`` around each expert layer, ``layer.recompute``
around each rematerialised forward, and the counters
``moe.routed`` (every assignment the routers made), ``moe.assignments``
(those to experts held here: all of them but under an expert share)
and ``moe.dropped`` (those of them dropped past capacity).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import spans
from repro_torch.configs.base import LatentConfig, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.train.optim import OptState
from repro_torch.models.common import (
    apply_rope,
    dense_init,
    embed_init,
    param,
    rms_norm,
    rope_angles,
)

#: the families this module runs: all of the reference's
FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")


def check_family(cfg: ModelConfig) -> None:
    """Refuse a family the reference does not have."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _latent(cfg: ModelConfig) -> bool:
    return isinstance(cfg, LatentConfig)


def _refuse_serving(cfg: ModelConfig) -> None:
    if _latent(cfg):
        raise NotImplementedError(
            f"{cfg.name}: latent attention has no KV cache or decode path "
            f"yet; it trains only")


# ---------------------------------------------------------------------------
# modules and init
# ---------------------------------------------------------------------------

def _hybrid_groups(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_full_groups, group_size, remainder) for the zamba2 stack."""
    g = cfg.attn_every
    return cfg.n_layers // g, g, cfg.n_layers % g


def _xlstm_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_slstm, mlstm_per_group)."""
    every = cfg.slstm_every or (cfg.n_layers + 1)
    n_s = cfg.n_layers // every
    return n_s, every - 1


class Block(nn.Module):
    """One layer of ``kind``: ``ln1`` and then ``attn``, ``ln2`` and
    ``mlp`` (``"attn_mlp"``) or ``moe`` (``"attn_moe"``), or ``ssm``
    (``"mamba"``), ``mlstm`` or ``slstm``; ``"cross"`` is ``ln1``, a
    cross-attention ``attn`` (no qk-norm), ``ln2``, ``mlp`` and the
    float32 0-d gates ``gate_attn`` / ``gate_mlp``; ``"mla_mlp"`` /
    ``"mla_moe"`` are ``"attn_mlp"`` (with the ``dense_d_ff`` MLP) /
    ``"attn_moe"`` with latent attention.  The default kind is the dense
    or MoE family's layer."""

    def __init__(self, cfg: ModelConfig, dtype, device=None,
                 kind: Optional[str] = None):
        super().__init__()
        kind = kind or ("attn_moe" if cfg.family == "moe" else "attn_mlp")
        d = cfg.d_model
        self.ln1 = param((d,), dtype, device)
        self.attn = self.ln2 = self.mlp = self.moe = None
        self.ssm = self.mlstm = self.slstm = None
        self.gate_attn = self.gate_mlp = None
        if kind in ("mla_mlp", "mla_moe"):
            self.attn = attn_lib.LatentAttention(cfg, dtype, device)
            self.ln2 = param((d,), dtype, device)
            if kind == "mla_moe":
                self.moe = moe_lib.MoE(cfg, dtype, device)
            else:
                self.mlp = mlp_lib.MLP(d, cfg.dense_d_ff, dtype, device)
        elif kind in ("attn_mlp", "attn_moe", "cross"):
            self.attn = attn_lib.Attention(cfg, dtype, device,
                                           cross=kind == "cross")
            self.ln2 = param((d,), dtype, device)
            if kind == "attn_moe":
                self.moe = moe_lib.MoE(cfg, dtype, device)
            else:
                self.mlp = mlp_lib.MLP(d, cfg.d_ff, dtype, device)
            if kind == "cross":
                self.gate_attn = param((), torch.float32, device)
                self.gate_mlp = param((), torch.float32, device)
        elif kind == "mamba":
            self.ssm = ssm_lib.SSM(cfg, dtype, device)
        elif kind == "mlstm":
            self.mlstm = xlstm_lib.MLSTM(cfg, dtype, device)
        elif kind == "slstm":
            self.slstm = xlstm_lib.SLSTM(cfg, dtype, device)
        else:
            raise ValueError(kind)

    def reset(self, gen) -> None:
        self.ln1.fill_(1)
        if self.ln2 is not None:
            self.ln2.fill_(1)
        for g in (self.gate_attn, self.gate_mlp):
            if g is not None:
                g.zero_()
        for sub in (self.attn, self.mlp, self.moe, self.ssm, self.mlstm,
                    self.slstm):
            if sub is not None:
                sub.reset(gen)


class Transformer(nn.Module):
    """The parameters of a model: ``tok_embed`` ``[V, d]``,
    ``final_norm``, ``lm_head`` ``[d, V]`` (absent with
    ``tie_embeddings``) and ``layers`` (attention, Mamba2 or mLSTM
    blocks by family), plus the hybrid family's ``shared_attn`` block,
    the ssm family's ``slstm_layers``, the encdec family's
    ``enc_embed_proj`` ``[d, d]``, ``enc_layers``, ``enc_norm`` and
    ``cross_layers`` (one a decoder layer) and the vlm family's
    ``img_proj`` ``[vision_dim, d]`` and ``cross_layers`` (one every
    ``cross_attn_every`` layers).  Construction allocates without
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
        self.shared_attn = self.slstm_layers = None
        self.enc_embed_proj = self.enc_layers = self.enc_norm = None
        self.img_proj = self.cross_layers = None
        kind, n = None, cfg.n_layers
        if cfg.family == "encdec":
            kind = "attn_mlp"
            self.enc_embed_proj = param((cfg.d_model, cfg.d_model), dt,
                                        device)
            self.enc_layers = nn.ModuleList(
                Block(cfg, dt, device, "attn_mlp")
                for _ in range(cfg.n_enc_layers))
            self.enc_norm = param((cfg.d_model,), dt, device)
            self.cross_layers = nn.ModuleList(
                Block(cfg, dt, device, "cross") for _ in range(n))
        elif cfg.family == "vlm":
            kind = "attn_mlp"
            self.img_proj = param((cfg.vision_dim, cfg.d_model), dt, device)
            self.cross_layers = nn.ModuleList(
                Block(cfg, dt, device, "cross")
                for _ in range(n // cfg.cross_attn_every))
        elif cfg.family == "hybrid":
            kind = "mamba"
            self.shared_attn = Block(cfg, dt, device, "attn_mlp")
        elif cfg.family == "ssm":
            n_s, _ = _xlstm_groups(cfg)
            kind, n = "mlstm", cfg.n_layers - n_s
            if n_s:
                self.slstm_layers = nn.ModuleList(
                    Block(cfg, dt, device, "slstm") for _ in range(n_s))
        if _latent(cfg):
            self.layers = nn.ModuleList(
                Block(cfg, dt, device,
                      "mla_mlp" if i < cfg.first_k_dense else "mla_moe")
                for i in range(n))
        else:
            self.layers = nn.ModuleList(
                Block(cfg, dt, device, kind) for _ in range(n))

    @property
    def head(self) -> torch.Tensor:
        """The ``[d, V]`` output projection (tied: ``tok_embed.T``)."""
        return self.tok_embed.T if self.lm_head is None else self.lm_head

    @torch.no_grad()
    def reset(self, gen: Optional[torch.Generator]) -> "Transformer":
        cfg = self.cfg
        self.tok_embed.copy_(embed_init(gen, self.tok_embed.shape,
                                        self.tok_embed.dtype,
                                        self.tok_embed.device))
        self.final_norm.fill_(1)
        for w in (self.lm_head, self.enc_embed_proj, self.img_proj):
            if w is not None:
                w.copy_(dense_init(gen, w.shape, w.shape[0], w.dtype,
                                   w.device))
        if self.enc_norm is not None:
            self.enc_norm.fill_(1)
        for blk in self.modules():
            if isinstance(blk, Block):
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


# ---------------------------------------------------------------------------
# the reference's layout: weights and training state across
# ---------------------------------------------------------------------------

def _as_tensor(a) -> torch.Tensor:
    """A reference leaf as a tensor of its dtype (bfloat16 numpy arrays
    go through float32, which is exact)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flat_tree(tree: Mapping[str, Any]) -> Dict[Tuple[str, ...], Any]:
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(prefix + (k,), v)
            else:
                flat[prefix + (k,)] = v
    walk((), tree)
    return flat


def _stacked(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """The reference's key of a port leaf, and its layer row (``None``
    for an unstacked leaf): ``layers.3.attn.wq`` is row 3 of
    ``layers.attn.wq``."""
    parts = tuple(name.split("."))
    if len(parts) > 1 and parts[1].isdigit():
        return (parts[0],) + parts[2:], int(parts[1])
    return parts, None


def _first_rows(names) -> Dict[Tuple[str, ...], int]:
    """Each stacked key's first layer row: 0, but for a leaf only later
    layers have (a latent model's experts follow its dense layers)."""
    first: Dict[Tuple[str, ...], int] = {}
    for name in names:
        key, row = _stacked(name)
        if row is not None:
            first[key] = min(first.get(key, row), row)
    return first


def _load(targets: Mapping[str, torch.Tensor], tree: Mapping[str, Any]
          ) -> None:
    """Copy the reference tree's leaves into ``targets`` (port names),
    which must take every leaf, each at its shape."""
    flat = _flat_tree(tree)
    first = _first_rows(targets)
    seen = set()
    for name, p in targets.items():
        key, row = _stacked(name)
        if key not in flat:
            raise ValueError(f"{name}: no reference leaf {'.'.join(key)}")
        val = _as_tensor(flat[key] if row is None
                         else flat[key][row - first[key]])
        seen.add(key)
        if tuple(val.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {tuple(val.shape)}, "
                             f"port shape {tuple(p.shape)}")
        p.copy_(val.to(device=p.device, dtype=p.dtype))
    missing = set(flat) - seen
    if missing:
        raise ValueError(f"reference leaves with no port parameter: "
                         f"{sorted(missing)}")


@torch.no_grad()
def params_from_reference(tree: Mapping[str, Any], cfg: ModelConfig,
                          device: DeviceLike = None) -> Transformer:
    """The reference's ``init_params`` tree as the port's parameters.

    ``tree`` is the reference's nested dict with numpy (or array-like)
    leaves and its stacked ``[L, ...]`` layer leaves (``layers``,
    ``slstm_layers``, ``enc_layers``, ``cross_layers``: the gates
    ``[n]`` float32); layer ``i`` of the port takes row ``i`` of each,
    and unstacked leaves (``shared_attn``) go across as they are.
    bfloat16 arrays go through float32, which is exact both ways.
    """
    model = Transformer(cfg, device)
    _load(dict(model.named_parameters()), tree)
    return model


def _reference_tree(leaves: Mapping[str, torch.Tensor],
                    device) -> Dict[str, Any]:
    """Port-named tensors as the reference's nested dict, layer leaves
    stacked ``[L, ...]`` on ``device``."""
    flat: Dict[Tuple[str, ...], Any] = {}
    rows: Dict[Tuple[str, ...], Dict[int, torch.Tensor]] = {}
    for name, t in leaves.items():
        key, row = _stacked(name)
        t = t.detach().to(device)
        if row is None:
            flat[key] = t
        else:
            rows.setdefault(key, {})[row] = t
    for key, by_row in rows.items():
        flat[key] = torch.stack([by_row[i] for i in sorted(by_row)])
    tree: Dict[str, Any] = {}
    for key, t in flat.items():
        node = tree
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = t
    return tree


def state_to_reference(params: Transformer, opt_state=None,
                       device: DeviceLike = None):
    """The port's parameters (and optimiser state) in the reference's
    layout: its ``init_params`` nested dict with stacked ``[L, ...]``
    layer leaves, or ``(params_tree, OptState(step, mu_tree, nu_tree))``
    as the reference's ``(params, opt_state)``.  The stacked copies are
    made on ``device`` (default: the parameters'; ``"cpu"`` keeps a
    checkpoint's copy off the card, ``"meta"`` gives the structure
    only).  :class:`~repro_torch.checkpoint.CheckpointManager` flattens
    it in ``jax.tree.flatten``'s order, so both sides read its files."""
    dev = params.tok_embed.device if device is None else torch.device(device)
    tree = _reference_tree(dict(params.named_parameters()), dev)
    if opt_state is None:
        return tree
    return tree, OptState(step=opt_state.step.detach().to(dev),
                          mu=_reference_tree(opt_state.mu, dev),
                          nu=_reference_tree(opt_state.nu, dev))


@torch.no_grad()
def state_from_reference(state, cfg: ModelConfig,
                         params: Optional[Transformer] = None,
                         opt_state=None, device: DeviceLike = None):
    """The inverse of :func:`state_to_reference`.

    ``state`` is a reference params tree, or a ``(params_tree,
    opt_state)`` pair whose ``opt_state`` is ``(step, mu, nu)`` (the
    reference's ``OptState`` or the port's), with numpy, JAX or torch
    leaves.  The values are written into ``params`` / ``opt_state`` in
    place when they are given, else into new ones on ``device``
    (``None``: cuda; moments in the dtype of the state's).  Returns the
    parameters, or ``(params, OptState)``.
    """
    pair = isinstance(state, tuple) and not isinstance(state, Mapping)
    tree, opt = state if pair else (state, None)
    if params is None:
        params = Transformer(cfg, device)
    _load(dict(params.named_parameters()), tree)
    if opt is None:
        return params
    step, mu_tree, nu_tree = opt
    if opt_state is None:
        sdt = _as_tensor(next(iter(_flat_tree(mu_tree).values()))).dtype
        mu, nu = ({k: torch.empty(p.shape, dtype=sdt, device=p.device)
                   for k, p in params.named_parameters()} for _ in range(2))
        step_t = torch.zeros((), dtype=torch.int32,
                             device=params.tok_embed.device)
    else:
        mu, nu, step_t = opt_state.mu, opt_state.nu, opt_state.step
    _load(mu, mu_tree)
    _load(nu, nu_tree)
    step_t = step_t.clone()
    step_t.copy_(_as_tensor(step).reshape(()))
    return params, OptState(step=step_t, mu=mu, nu=nu)


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _ffn(blk: Block, x: torch.Tensor, cfg: ModelConfig):
    h = rms_norm(x, blk.ln2, cfg.norm_eps)
    if blk.moe is not None:
        with spans.layer("moe") as m:
            out, aux = moe_lib.moe(blk.moe, m.input(h), cfg)
        return m.output(out), aux
    return mlp_lib.mlp(blk.mlp, h), {}


def _attn_block(blk: Block, x, cfg, rope, window=0, return_kv=False):
    h = rms_norm(x, blk.ln1, cfg.norm_eps)
    with spans.layer("attention") as m:
        res = attn_lib.self_attention(blk.attn, m.input(h), cfg, rope,
                                      window=window, return_kv=return_kv)
    h, kv = res if return_kv else (res, None)
    x = x + m.output(h)
    h, aux = _ffn(blk, x, cfg)
    return x + h, aux, kv


def _attn_block_decode(blk: Block, x, cache, pos, cfg, rope, window=0):
    h, cache = attn_lib.decode_attention(
        blk.attn, rms_norm(x, blk.ln1, cfg.norm_eps), cache, pos, cfg,
        rope, window=window)
    x = x + h
    h, _ = _ffn(blk, x, cfg)
    return x + h, cache


def _cross_block(blk: Block, x, kv, cfg, gated: bool):
    """Cross-attention to ``kv`` and an MLP, each a residual branch;
    ``gated`` scales both branches by ``tanh`` of the block's gates."""
    h = attn_lib.cross_attention(
        blk.attn, rms_norm(x, blk.ln1, cfg.norm_eps), kv, cfg)
    if gated:
        h = h * torch.tanh(blk.gate_attn).to(h.dtype)
    x = x + h
    h = mlp_lib.mlp(blk.mlp, rms_norm(x, blk.ln2, cfg.norm_eps))
    if gated:
        h = h * torch.tanh(blk.gate_mlp).to(h.dtype)
    return x + h


def _cross_layer(blk: Block, cross: Optional[Block], kv, x, cfg, rope,
                 gated: bool, collect: bool):
    """A decoder layer and then, where ``cross`` is given, its cross
    block against ``kv``: ``(x, the layer's roped K / V or None)``."""
    x, _, self_kv = _attn_block(blk, x, cfg, rope, 0, collect)
    if cross is not None:
        x = _cross_block(cross, x, kv, cfg, gated)
    return x, self_kv


def _enc_layer(blk: Block, x, cfg, rope):
    """A bidirectional encoder layer: RoPE'd attention with no mask."""
    xn = rms_norm(x, blk.ln1, cfg.norm_eps)
    q = attn_lib._project_q(blk.attn, xn, cfg)
    k, v = attn_lib._project_kv(blk.attn, xn, cfg)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    h = attn_lib._sdpa(q, k, v, None, cfg.n_heads // cfg.n_kv_heads)
    y = x + attn_lib._out(blk.attn, h)
    return y + mlp_lib.mlp(blk.mlp, rms_norm(y, blk.ln2, cfg.norm_eps))


def _mamba_layer(blk: Block, x, cfg):
    y, st = ssm_lib.ssm_forward(blk.ssm, x, cfg)
    return x + y, st


def _mlstm_layer(blk: Block, x, cfg, collect: bool):
    out = xlstm_lib.mlstm_parallel(
        blk.mlstm, rms_norm(x, blk.ln1, cfg.norm_eps), cfg,
        return_state=collect)
    h, st = out if collect else (out, None)
    return x + h, st


def _remat(on: bool, fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    when ``on`` (the reference's ``jax.checkpoint`` with
    ``nothing_saveable``); the recompute is span ``layer.recompute``."""
    if on:
        return checkpoint(spans.rerun(fn), *args, use_reentrant=False)
    return fn(*args)


def _training(params: Transformer) -> bool:
    return torch.is_grad_enabled() and params.tok_embed.requires_grad


def _stack_states(kind, states: List[Any]):
    return kind(*(torch.stack(xs) for xs in zip(*states)))


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

class ForwardOut(NamedTuple):
    hidden: torch.Tensor
    aux: Dict[str, torch.Tensor]
    kv: Any           # per-layer roped (K, V) lists (collect=True) or None
    states: Any       # recurrent states (hybrid / ssm) or the cross
                      # layers' stacked (K, V) (encdec / vlm), collect=True


def _count_routing(per_layer: int, auxs) -> None:
    """Each expert layer's assignments: all the router made
    (``moe.routed``), those to experts held here (``moe.assignments``:
    the layer's ``held``, else all) and those of them dropped past
    capacity (``moe.dropped``: its ``dropped_frac`` of them, multiplied
    when read, so counting launches no kernel)."""
    for a in auxs:
        held = a.get("held", per_layer)
        spans.count("moe.routed", per_layer)
        spans.count("moe.assignments", held)
        spans.count("moe.dropped", a["dropped_frac"], scale=held)


def forward(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            extra: Optional[Dict[str, torch.Tensor]] = None,
            collect: bool = False) -> ForwardOut:
    """Full-sequence forward.  ``collect=True`` gathers the decode
    caches: each attention layer's (or shared-attention application's)
    roped K / V (``kv = (ks, vs)``, one tensor each) and the recurrent
    states, stacked ``[L, ...]`` (hybrid: an ``SSMState``; ssm:
    ``{"mlstm": MLSTMState, "slstm": SLSTMState or None}``; encdec /
    vlm: every cross layer's ``(K, V)``, each ``[n_cross, B, S, Hkv,
    hd]``).  ``extra`` holds the encdec family's ``enc_frames`` ``[B, S,
    d]`` or the vlm family's ``image_embeds`` ``[B, N, vision_dim]``
    (any float dtype; cast to the model's)."""
    check_family(cfg)
    if collect:
        _refuse_serving(cfg)
    extra = extra or {}
    t = tokens.shape[1]
    x = params.tok_embed[tokens]
    rope = attn_lib.make_rope(cfg, max(t, 1), x.device)
    remat = _training(params)
    aux: Dict[str, torch.Tensor] = {}
    kv_out, states_out = None, None
    if cfg.family in ("dense", "moe"):
        auxs, ks, vs = [], [], []
        for blk in params.layers:
            x, a, kv = _remat(remat, _attn_block, blk, x, cfg, rope, 0,
                              collect)
            auxs.append(a)
            if collect:
                ks.append(kv[0])
                vs.append(kv[1])
        if cfg.family == "moe" and not _latent(cfg):
            aux = {k: torch.stack([a[k] for a in auxs]).mean()
                   for k in auxs[0]}
        if cfg.family == "moe" and remat and spans.active():
            _count_routing(tokens.numel() * cfg.top_k,
                           [a for a in auxs if a])
        kv_out = (ks, vs) if collect else None
    elif cfg.family == "hybrid":
        x, kv_out, states_out = _hybrid_forward(params, cfg, x, rope,
                                                collect, remat)
    elif cfg.family == "ssm":
        x, states_out = _xlstm_forward(params, cfg, x, collect, remat)
    else:
        x, kv_out, states_out = _crossdec_forward(params, cfg, x, rope,
                                                  extra, collect, remat)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return ForwardOut(hidden=x, aux=aux, kv=kv_out, states=states_out)


def _encode(params, cfg, frames, rope, remat):
    """The bidirectional encoder over (stub) audio frame embeddings."""
    x = frames.to(_dtype(cfg)) @ params.enc_embed_proj
    for blk in params.enc_layers:
        x = _remat(remat, _enc_layer, blk, x, cfg, rope)
    return rms_norm(x, params.enc_norm, cfg.norm_eps)


def _cross_kvs(cross_layers, states, cfg) -> List[Tuple[torch.Tensor,
                                                        torch.Tensor]]:
    """Every cross-attention layer's K / V over ``states``."""
    return [attn_lib.encoder_kv(blk.attn, states, cfg)
            for blk in cross_layers]


def _cross_at(cfg: ModelConfig, i: int) -> Optional[int]:
    """The cross layer that follows decoder layer ``i``, or ``None``:
    every layer's (encdec), every ``cross_attn_every``-th layer's
    (vlm)."""
    if cfg.family == "encdec":
        return i
    every = cfg.cross_attn_every
    return i // every if (i + 1) % every == 0 else None


def _crossdec_forward(params, cfg, x, rope, extra, collect, remat):
    """The encdec and vlm decoders: each layer, then its cross block
    (if any) against the encoder's or the image's K / V."""
    if cfg.family == "encdec":
        # the encoder's frames outnumber the prompt: a longer table
        rope = attn_lib.make_rope(cfg, max(x.shape[1], cfg.enc_seq),
                                  x.device)
        src = _encode(params, cfg, extra["enc_frames"], rope, remat)
    else:
        src = extra["image_embeds"].to(_dtype(cfg)) @ params.img_proj
    kvs = _cross_kvs(params.cross_layers, src, cfg)
    gated = cfg.family == "vlm"
    ks, vs = [], []
    for i, blk in enumerate(params.layers):
        ci = _cross_at(cfg, i)
        cross, kv = (None, None) if ci is None else \
            (params.cross_layers[ci], kvs[ci])
        x, self_kv = _remat(remat, _cross_layer, blk, cross, kv, x, cfg,
                            rope, gated, collect)
        if collect:
            ks.append(self_kv[0])
            vs.append(self_kv[1])
    if not collect:
        return x, None, None
    return x, (ks, vs), (torch.stack([k for k, _ in kvs]),
                         torch.stack([v for _, v in kvs]))


def _hybrid_group(shared, layers, x, cfg, rope, window, collect, remat):
    x, _, kv = _attn_block(shared, x, cfg, rope, window, collect)
    sts = []
    for blk in layers:
        x, st = _remat(remat, _mamba_layer, blk, x, cfg)
        sts.append(st)
    return x, kv, sts


def _hybrid_forward(params, cfg, x, rope, collect, remat):
    """[shared-attn; G x mamba] x n_groups (+ the shared block and the
    remainder's Mamba layers)."""
    n_g, g, rem = _hybrid_groups(cfg)
    window = _window(cfg)
    ks, vs, states = [], [], []
    for i in range(n_g):
        x, kv, sts = _remat(remat, _hybrid_group, params.shared_attn,
                            list(params.layers[i * g:(i + 1) * g]), x, cfg,
                            rope, window, collect, remat)
        ks.append(kv)
        states.extend(sts)
    if rem:
        x, _, kv = _attn_block(params.shared_attn, x, cfg, rope, window,
                               collect)
        ks.append(kv)
        for blk in params.layers[n_g * g:]:
            x, st = _remat(remat, _mamba_layer, blk, x, cfg)
            states.append(st)
    if not collect:
        return x, None, None
    return (x, ([k for k, _ in ks], [v for _, v in ks]),
            _stack_states(ssm_lib.SSMState, states))


def _xlstm_forward(params, cfg, x, collect, remat):
    """[mLSTM x per_group; sLSTM] x n_slstm (+ the remaining mLSTM)."""
    n_s, per_group = _xlstm_groups(cfg)
    m_states, s_states = [], []

    def run(blks, x):
        for blk in blks:
            x, st = _remat(remat, _mlstm_layer, blk, x, cfg, collect)
            m_states.append(st)
        return x

    for gidx in range(n_s):
        x = run(params.layers[gidx * per_group:(gidx + 1) * per_group], x)
        sl = params.slstm_layers[gidx]
        h, s_st = xlstm_lib.slstm_forward(
            sl.slstm, rms_norm(x, sl.ln1, cfg.norm_eps), cfg)
        x = x + h
        s_states.append(s_st)
    x = run(params.layers[n_s * per_group:], x)
    if not collect:
        return x, None
    return x, {"mlstm": _stack_states(xlstm_lib.MLSTMState, m_states),
               "slstm": _stack_states(xlstm_lib.SLSTMState, s_states)
               if s_states else None}


def loss_fn(params: Transformer, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's training loss: masked next-token NLL (labels < 0
    ignored) plus, for MoE (not a latent config), 0.01 x load balance
    and 1e-3 x router z.  Differentiable; every layer is rematerialised
    under grad."""
    out = forward(params, cfg, batch["tokens"],
                  {k: v for k, v in batch.items()
                   if k not in ("tokens", "labels")})
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
    """Zero decode cache: ``pos`` and the family's stacked entries: the
    KV cache (``[L, B, S, Hkv, hd]``; hybrid: one entry per application
    of the shared block, a ``window``-slot ring under
    ``long_attention="window"``), ``ssm`` (hybrid) or ``mlstm`` /
    ``slstm`` (ssm) states.  The encdec and vlm families' ``cross_kv``
    is the prefill's (:func:`prefill`)."""
    check_family(cfg)
    _refuse_serving(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    cache: Dict[str, Any] = {
        "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    kv_len = _attn_cache_len(cfg, max_len)
    if cfg.family in ("dense", "moe", "encdec", "vlm"):
        cache["attn"] = attn_lib.init_cache(cfg, batch, kv_len, dt, dev,
                                            n_layers=cfg.n_layers)
    elif cfg.family == "hybrid":
        n_g, _, rem = _hybrid_groups(cfg)
        cache["attn"] = attn_lib.init_cache(cfg, batch, kv_len, dt, dev,
                                            n_layers=n_g + (1 if rem else 0))
        cache["ssm"] = ssm_lib.init_state(cfg, batch, dt, dev,
                                          n_layers=cfg.n_layers)
    else:
        n_s, _ = _xlstm_groups(cfg)
        cache["mlstm"] = xlstm_lib.init_mlstm_state(
            cfg, batch, dev, n_layers=cfg.n_layers - n_s)
        if n_s:
            cache["slstm"] = xlstm_lib.init_slstm_state(cfg, batch, dev,
                                                        n_layers=n_s)
    return cache


def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            extra: Optional[Dict[str, torch.Tensor]] = None,
            max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process the prompt, build the decode cache, return the last
    position's float32 logits ``[B, V]``.  ``extra``: the encdec and
    vlm families' frontend inputs (:func:`forward`)."""
    _refuse_serving(cfg)
    b, t = tokens.shape
    max_len = max_len or t
    out = forward(params, cfg, tokens, extra, collect=True)
    logits = out.hidden[:, -1] @ params.head
    cache = init_decode_cache(cfg, b, max_len, tokens.device)
    cache["pos"].fill_(t)
    if out.kv is not None:
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
    if cfg.family == "hybrid":
        cache["ssm"] = out.states
    elif cfg.family == "ssm":
        cache["mlstm"] = out.states["mlstm"]
        if out.states["slstm"] is not None:
            cache["slstm"] = out.states["slstm"]
    elif cfg.family in ("encdec", "vlm"):
        cache["cross_kv"] = out.states
    return logits.float(), cache


def decode_step(params: Transformer, cfg: ModelConfig,
                cache: Dict[str, Any], tokens: torch.Tensor,
                extra: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step.  tokens: [B, 1] -> float32 logits [B, V].

    Writes the step's K / V and recurrent states into ``cache`` in place
    and returns it with ``pos`` advanced; nothing crosses to the host.
    The encdec and vlm families read the prefill's ``cross_kv``;
    ``extra`` is unused, as in the reference.
    """
    check_family(cfg)
    _refuse_serving(cfg)
    pos = cache["pos"]
    b = tokens.shape[0]
    x = params.tok_embed[tokens]
    rope = rope_angles(cfg.hd, cfg.rope_theta, pos.expand(b, 1))
    if cfg.family in ("dense", "moe"):
        for i, blk in enumerate(params.layers):
            x = _attn_decode_at(blk, x, cache, i, pos, cfg, rope)
    elif cfg.family == "hybrid":
        x = _hybrid_decode(params, cfg, x, cache, pos, rope)
    elif cfg.family == "ssm":
        x = _xlstm_decode(params, cfg, x, cache)
    else:
        x = _crossdec_step(params, cfg, x, cache, pos, rope)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = (x @ params.head)[:, 0].float()
    cache["pos"] = pos + 1
    return logits, cache


def _attn_decode_at(blk, x, cache, i, pos, cfg, rope):
    """``blk``'s decode against entry ``i`` of the stacked KV cache."""
    x, _ = _attn_block_decode(
        blk, x, {name: t[i] for name, t in cache["attn"].items()}, pos,
        cfg, rope, window=_window(cfg))
    return x


def _write(dst, src) -> None:
    """Copy a state's fields into views of the stacked cache."""
    for d, s in zip(dst, src):
        d.copy_(s)


def _hybrid_decode(params, cfg, x, cache, pos, rope):
    n_g, g, rem = _hybrid_groups(cfg)
    st = cache["ssm"]

    def mamba(i, x):
        view = ssm_lib.SSMState(st.h[i], st.conv[i])
        y, new = ssm_lib.ssm_decode(params.layers[i].ssm, x, cfg, view)
        _write(view, new)
        return x + y

    for gi in range(n_g + (1 if rem else 0)):
        x = _attn_decode_at(params.shared_attn, x, cache, gi, pos, cfg,
                            rope)
        for i in range(gi * g, min((gi + 1) * g, cfg.n_layers)):
            x = mamba(i, x)
    return x


def _xlstm_decode(params, cfg, x, cache):
    n_s, per_group = _xlstm_groups(cfg)
    ms = cache["mlstm"]

    def mlstm(i, x):
        blk = params.layers[i]
        view = xlstm_lib.MLSTMState(*(t[i] for t in ms))
        h, new = xlstm_lib.mlstm_decode(
            blk.mlstm, rms_norm(x, blk.ln1, cfg.norm_eps), cfg, view)
        _write(view, new)
        return x + h

    for gidx in range(n_s):
        for i in range(gidx * per_group, (gidx + 1) * per_group):
            x = mlstm(i, x)
        sl = params.slstm_layers[gidx]
        view = xlstm_lib.SLSTMState(*(t[gidx] for t in cache["slstm"]))
        h, new = xlstm_lib.slstm_forward(
            sl.slstm, rms_norm(x, sl.ln1, cfg.norm_eps), cfg, state=view)
        _write(view, new)
        x = x + h
    for i in range(n_s * per_group, len(params.layers)):
        x = mlstm(i, x)
    return x


def _crossdec_step(params, cfg, x, cache, pos, rope):
    """The encdec and vlm decoders' step: each layer against its KV
    cache entry, then its cross block (if any) against the cached
    cross K / V."""
    ck, cv = cache["cross_kv"]
    gated = cfg.family == "vlm"
    for i, blk in enumerate(params.layers):
        x = _attn_decode_at(blk, x, cache, i, pos, cfg, rope)
        ci = _cross_at(cfg, i)
        if ci is not None:
            x = _cross_block(params.cross_layers[ci], x, (ck[ci], cv[ci]),
                             cfg, gated)
    return x
