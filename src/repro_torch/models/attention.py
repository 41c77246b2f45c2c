"""Grouped-query attention: training, prefill and cached decode paths.

The port of ``repro/models/attention.py``: GQA with any kv-head count,
optional qk-norm (qwen3), RoPE, the causal self-attention of a full
sequence (with the blockwise online-softmax path for long ones), the
cross-attention of the encdec and vlm families (decoder states against
precomputed encoder or image K / V: no RoPE, no causal mask) and the
one-token decode against a KV cache (full, or a ``window``-slot ring
buffer), in bfloat16 or int8.  :class:`LatentAttention` is the
multi-head latent attention (MLA) of a
:class:`~repro_torch.configs.base.LatentConfig` (training and the
full-sequence forward only; it has no cache).

Softmax runs in float32; logits are scaled by ``1/sqrt(hd)``.  Causal,
unwindowed self-attention (and MLA's) goes through
:func:`causal_attention`: the fused kernel of
:mod:`repro_torch.kernels.flash` on the card, the plain chain below on
the CPU.  The parameters keep the reference's layouts (``wq`` / ``wk`` /
``wv`` ``[d, H, hd]``, ``wo`` ``[H, hd, d]``), so the sharding rules and
the reference's weights apply leaf for leaf.

Decode updates the cache tensors in place (``index_copy_`` at the
slot) and returns the same dict: the reference's functional update is
a copy that XLA elides, and eagerly it would copy every layer's whole
cache each step.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import spans
from repro_torch.configs.base import LatentConfig, ModelConfig
from repro_torch.kernels import flash
from repro_torch.models.common import (
    apply_rope,
    dense_init,
    param,
    rms_norm,
    rope_freqs,
    rotate,
    yarn_inv_freq,
    yarn_mscale,
)

NEG_INF = -1e30


class Attention(nn.Module):
    """``wq`` / ``wk`` / ``wv`` / ``wo`` and, with ``qk_norm``, the
    per-head-dim ``q_norm`` / ``k_norm`` weights."""

    def __init__(self, cfg: ModelConfig, dtype, device=None,
                 cross: bool = False):
        super().__init__()
        d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = param((d, hq, hd), dtype, device)
        self.wk = param((d, hkv, hd), dtype, device)
        self.wv = param((d, hkv, hd), dtype, device)
        self.wo = param((hq, hd, d), dtype, device)
        if cfg.qk_norm and not cross:
            self.q_norm = param((hd,), dtype, device)
            self.k_norm = param((hd,), dtype, device)
        else:
            self.q_norm = self.k_norm = None

    def reset(self, gen) -> None:
        d, hq, hd = self.wq.shape
        for w, fan_in in ((self.wq, d), (self.wk, d), (self.wv, d),
                          (self.wo, hq * hd)):
            w.copy_(dense_init(gen, w.shape, fan_in, w.dtype, w.device))
        for w in (self.q_norm, self.k_norm):
            if w is not None:
                w.fill_(1)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("btd,dhk->bthk")`` as one matmul over the flat heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_q(p: Attention, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    q = _proj(x, p.wq)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
    return q


def _project_kv(p: Attention, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    k = _proj(x, p.wk)
    v = _proj(x, p.wv)
    if p.k_norm is not None:
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return k, v


def _out(p: Attention, o: torch.Tensor) -> torch.Tensor:
    """``einsum("bthk,hkd->btd")`` as one matmul."""
    h, k, d = p.wo.shape
    return o.flatten(-2) @ p.wo.reshape(h * k, d)


def _expand_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Repeat KV heads to the query-head count (``jnp.repeat`` on the
    head axis: each KV head serves ``n_rep`` consecutive query heads)."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], n_rep: int,
          scale: Optional[float] = None) -> torch.Tensor:
    """q, k: [B,T,Hq,hd], [B,S,Hkv,hd]; v: [B,S,Hkv,hd_v]; mask
    broadcastable [B,1,T,S].  Logits are scaled by ``scale``, or divided
    by ``sqrt(hd)`` without one."""
    hd = q.shape[-1]
    k = _expand_kv(k, n_rep)
    v = _expand_kv(v, n_rep)
    logits = torch.einsum("bthk,bshk->bhts", q, k).float()
    if scale is None:
        logits = logits / np.float32(np.sqrt(hd))
    else:
        logits = logits * np.float32(scale)
    if mask is not None:
        logits = logits + torch.where(
            mask, torch.zeros((), device=logits.device),
            torch.full((), NEG_INF, device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshk->bthk", probs, v)


# Above this many query positions, the full [T, S] score matrix is
# replaced by the blockwise online-softmax path.
BLOCKWISE_THRESHOLD = 8192
Q_BLOCK = 1024
KV_BLOCK = 1024


def _blockwise_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_rep: int, window: int = 0) -> torch.Tensor:
    """Causal online-softmax attention, O(Lq * S) memory per block.

    Query blocks in turn; each visits the KV blocks at or before it
    (the causal bound), as the reference's ``lax.map`` /
    ``fori_loop`` pair does, with the same dtypes: float32 running max
    and denominator, the accumulator in ``v``'s dtype.
    """
    b, t, hq, hd = q.shape
    s = k.shape[1]
    lq, lkv = min(Q_BLOCK, t), min(KV_BLOCK, s)
    nq = t // lq
    scale = np.float32(1.0 / np.sqrt(hd))
    dev = q.device
    outs = []
    for iq in range(nq):
        q_i = q[:, iq * lq:(iq + 1) * lq]
        q_pos = iq * lq + torch.arange(lq, device=dev)
        m = torch.full((b, hq, lq), -torch.inf, device=dev)
        den = torch.zeros((b, hq, lq), device=dev)
        acc = torch.zeros((b, hq, lq, hd), dtype=v.dtype, device=dev)
        n_blocks = (iq * lq + lq + lkv - 1) // lkv
        for jk in range(n_blocks):
            k_j = _expand_kv(k[:, jk * lkv:(jk + 1) * lkv], n_rep)
            v_j = _expand_kv(v[:, jk * lkv:(jk + 1) * lkv], n_rep)
            kv_pos = jk * lkv + torch.arange(lkv, device=dev)
            logits = torch.einsum("bthk,bshk->bhts", q_i,
                                  k_j).float() * scale
            mask = q_pos[:, None] >= kv_pos[None, :]
            if window:
                mask &= q_pos[:, None] - kv_pos[None, :] < window
            logits = logits + torch.where(
                mask, torch.zeros((), device=dev),
                torch.full((), NEG_INF, device=dev))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            den = den * corr + p.sum(dim=-1)
            acc = acc * corr[..., None].to(acc.dtype) + torch.einsum(
                "bhts,bshk->bhtk", p.to(v.dtype), v_j)
            m = m_new
        outs.append(acc / torch.clamp(den, min=1e-30)[..., None].to(
            acc.dtype))                                # [B,H,Lq,hd]
    out = torch.cat(outs, dim=2)                       # [B,H,T,hd]
    return out.transpose(1, 2)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_rep: int, scale: Optional[float] = None
                     ) -> torch.Tensor:
    """Causal attention over full sequences: q ``[B, T, Hq, hd]``, k ``[B,
    T, Hkv, hd]``, v ``[B, T, Hkv, hd_v]`` -> ``[B, T, Hq, hd_v]``, logits
    scaled by ``scale`` (``1 / sqrt(hd)`` without one).

    On a CUDA tensor, the fused kernel (:func:`repro_torch.kernels.flash.
    attention`: online softmax, no logits in device memory, its own
    backward), which raises on what it does not take; elsewhere the plain
    chain, :func:`_sdpa` with the causal mask, or :func:`_blockwise_sdpa`
    above ``BLOCKWISE_THRESHOLD`` without a ``scale``.  Counts
    ``attention.calls``, and ``attention.fused`` for the kernel's."""
    spans.count("attention.calls", 1)
    if q.is_cuda:
        spans.count("attention.fused", 1)
        return flash.attention(q, k, v, n_rep, scale)
    t = q.shape[1]
    if scale is None and t > BLOCKWISE_THRESHOLD and t % Q_BLOCK == 0:
        return _blockwise_sdpa(q, k, v, n_rep)
    idx = torch.arange(t, device=q.device)
    mask = idx[None, :, None] >= idx[None, None, :]
    return _sdpa(q, k, v, mask[:, None], n_rep, scale)


def self_attention(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                   rope: Tuple[torch.Tensor, torch.Tensor],
                   positions: Optional[torch.Tensor] = None,
                   window: int = 0, return_kv: bool = False):
    """Causal self-attention over a full sequence (train / prefill); a
    :class:`LatentAttention` layer goes to :func:`latent_attention`
    (training only: it has no KV cache to return)."""
    if isinstance(p, LatentAttention):
        return latent_attention(p, x, cfg, rope)
    t = x.shape[1]
    q = _project_q(p, x, cfg)
    k, v = _project_kv(p, x, cfg)
    cos, sin = rope
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if not window:
        out = causal_attention(q, k, v, n_rep)
    elif t > BLOCKWISE_THRESHOLD and t % Q_BLOCK == 0:
        out = _blockwise_sdpa(q, k, v, n_rep, window)
    else:
        idx = torch.arange(t, device=x.device)
        mask = idx[None, :, None] >= idx[None, None, :]
        mask = mask & (idx[None, :, None] - idx[None, None, :] < window)
        out = _sdpa(q, k, v, mask[:, None], n_rep)
    out = _out(p, out)
    if return_kv:
        return out, (k, v)
    return out


def cross_attention(p: Attention, x: torch.Tensor,
                    kv: Tuple[torch.Tensor, torch.Tensor], cfg: ModelConfig,
                    enc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attend from decoder states ``x`` ``[B, T, d]`` to precomputed
    encoder K / V ``[B, S, Hkv, hd]`` (:func:`encoder_kv`); ``enc_mask``
    ``[B, S]`` (True: attend) masks source positions."""
    k, v = kv
    q = _project_q(p, x, cfg)
    mask = None if enc_mask is None else enc_mask[:, None, None, :]
    out = _sdpa(q, k, v, mask, cfg.n_heads // cfg.n_kv_heads)
    return _out(p, out)


def encoder_kv(p: Attention, enc_out: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A cross-attention layer's K / V over the encoder's (or the
    projected image's) states ``[B, S, d]``."""
    return _project_kv(p, enc_out, cfg)


# ---------------------------------------------------------------------------
# cached decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device=None, n_layers: Optional[int] = None
               ) -> Dict[str, torch.Tensor]:
    """Zero KV cache ``[B, S, Hkv, hd]`` (``[L, B, S, Hkv, hd]`` with
    ``n_layers``), int8 with per-(position, head) bf16 scales when
    ``cfg.kv_cache_dtype == "int8"``."""
    lead = () if n_layers is None else (n_layers,)
    hkv, hd = cfg.n_kv_heads, cfg.hd
    int8 = cfg.kv_cache_dtype == "int8"
    store = torch.int8 if int8 else dtype
    shape = lead + (batch, max_len, hkv, hd)
    cache = {"k": torch.zeros(shape, dtype=store, device=device),
             "v": torch.zeros(shape, dtype=store, device=device)}
    if int8:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device)
    return cache


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[.., S, H, hd] -> (int8 values, bf16 per-(S, H) scales)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-9
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequant_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


def decode_attention(p: Attention, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                     cfg: ModelConfig,
                     rope: Tuple[torch.Tensor, torch.Tensor],
                     window: int = 0
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: write the KV cache at ``pos`` and attend.

    x: [B, 1, d]; cache k/v: [B, S, Hkv, hd]; pos: 0-d int tensor on
    the cache's device; ``rope``: the cos / sin angles at ``pos``,
    broadcastable against ``[B, 1, hd / 2]``
    (:func:`~repro_torch.models.common.rope_angles`).  With
    ``window > 0`` the cache is a ring buffer of ``S`` slots
    (sliding-window attention).  The cache is updated in place and
    returned.
    """
    s_max = cache["k"].shape[1]
    q = _project_q(p, x, cfg)
    k_new, v_new = _project_kv(p, x, cfg)
    cos, sin = rope
    q = rotate(q, cos[:, :, None], sin[:, :, None])
    k_new = rotate(k_new, cos[:, :, None], sin[:, :, None])
    slot = pos % max(s_max, 1) if window > 0 else pos
    at = slot.reshape(1).to(torch.long)
    if cfg.kv_cache_dtype == "int8":
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            cache[name].index_copy_(1, at, val)
        k = dequant_kv(cache["k"], cache["k_scale"], x.dtype)
        v = dequant_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        cache["k"].index_copy_(1, at, k_new)
        cache["v"].index_copy_(1, at, v_new)
        k, v = cache["k"], cache["v"]
    idx = torch.arange(s_max, device=x.device)
    if window:
        valid = (idx[None, :] <= slot) | (pos >= s_max)
    else:
        valid = idx[None, :] <= pos
    mask = valid[:, None, None, :]   # [1,1,1,S] broadcast over batch
    out = _sdpa(q, k, v, mask, cfg.n_heads // cfg.n_kv_heads)
    return _out(p, out), cache


def make_rope(cfg: ModelConfig, max_pos: int, device=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``[max_pos, dim / 2]`` cos / sin table: over the head dim, or
    for a latent config YaRN's over its rotary dims."""
    if not isinstance(cfg, LatentConfig):
        return rope_freqs(cfg.hd, max_pos, cfg.rope_theta, device)
    inv = yarn_inv_freq(cfg.qk_rope_head_dim, cfg.rope_theta,
                        cfg.yarn_factor, cfg.yarn_original,
                        cfg.yarn_beta_fast, cfg.yarn_beta_slow, device)
    ang = torch.arange(max_pos, dtype=torch.float32, device=device)[:, None] \
        * inv
    return torch.cos(ang), torch.sin(ang)


# ---------------------------------------------------------------------------
# multi-head latent attention
# ---------------------------------------------------------------------------

class LatentAttention(nn.Module):
    """MLA's leaves: ``wq_a`` ``[d, q_rank]``, ``q_norm`` ``[q_rank]``,
    ``wq_b`` ``[q_rank, H, nope + rope]``, ``wkv_a`` ``[d, kv_rank +
    rope]``, ``kv_norm`` ``[kv_rank]``, ``wkv_b`` ``[kv_rank, H, nope +
    v]`` and ``wo`` ``[H, v, d]``."""

    def __init__(self, cfg: LatentConfig, dtype, device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
        self.wq_a = param((d, rq), dtype, device)
        self.q_norm = param((rq,), dtype, device)
        self.wq_b = param((rq, h, nope + rope), dtype, device)
        self.wkv_a = param((d, rkv + rope), dtype, device)
        self.kv_norm = param((rkv,), dtype, device)
        self.wkv_b = param((rkv, h, nope + vd), dtype, device)
        self.wo = param((h, vd, d), dtype, device)

    def reset(self, gen) -> None:
        for w in (self.wq_a, self.wq_b, self.wkv_a, self.wkv_b):
            w.copy_(dense_init(gen, w.shape, w.shape[0], w.dtype, w.device))
        h, vd, _ = self.wo.shape
        self.wo.copy_(dense_init(gen, self.wo.shape, h * vd, self.wo.dtype,
                                 self.wo.device))
        self.q_norm.fill_(1)
        self.kv_norm.fill_(1)


def latent_scale(cfg: LatentConfig) -> float:
    """The softmax scale: ``(nope + rope) ** -0.5`` times the square of
    YaRN's ``mscale_all_dim`` scale."""
    m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
    return cfg.qk_head_dim ** -0.5 * m * m


def latent_attention(p: LatentAttention, x: torch.Tensor,
                     cfg: LatentConfig,
                     rope: Tuple[torch.Tensor, torch.Tensor]
                     ) -> torch.Tensor:
    """Causal MLA over a full sequence ``x`` ``[B, T, d]``: q from the
    normed compressed q, k_nope and v from the normed compressed kv, one
    rotary key ``k_pe`` shared by every head, scores at ``nope + rope``
    against values at ``v``, through :func:`causal_attention` (span
    ``attention.latent`` holds what comes before the scores)."""
    nope, rdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    with spans.span("attention.latent"):
        c_q = rms_norm(x @ p.wq_a, p.q_norm, cfg.norm_eps)
        q_nope, q_pe = _proj(c_q, p.wq_b).split([nope, rdim], dim=-1)
        c_kv, k_pe = (x @ p.wkv_a).split([cfg.kv_lora_rank, rdim], dim=-1)
        kv = _proj(rms_norm(c_kv, p.kv_norm, cfg.norm_eps), p.wkv_b)
        k_nope, v = kv.split([nope, cfg.v_head_dim], dim=-1)
        cos, sin = rope
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe[:, :, None], cos, sin)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(-1, -1, cfg.n_heads, -1)],
                      dim=-1)
    out = causal_attention(q, k, v, 1, latent_scale(cfg))
    return _out(p, out)
