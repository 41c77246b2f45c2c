"""xLSTM blocks: mLSTM (matrix memory, parallel+recurrent) and sLSTM.

The port of ``repro/models/xlstm.py``.  mLSTM training/prefill uses the
stabilised chunkwise-parallel form, with the matrix memory ``(C, n, m)``
carried from chunk to chunk; decode uses the O(1) recurrence over
``C``.  sLSTM keeps per-unit scalar memory with recurrent mixing and
runs as a loop over time (``T`` steps, each a handful of kernels,
where the reference has a ``lax.scan``).  Blocks follow the xLSTM
paper's pre-LN up/down-projection structure with a multiplicative gate
branch.

The gate weights (``w_if``, ``b_if``, ``w_x``, ``r_h``, ``bias``) are
float32 in a bfloat16 model, and the stabiliser ``m`` starts at
``-1e30``, not ``-inf``, so that ``max(|den|, exp(-m))`` and the
``exp`` of differences see the reference's values.  The keys' scale
``1 / sqrt(hd)`` and the chunk's ``Q . K`` are float32, as in the
recurrent decode, where the reference's parallel form rounds both to
bfloat16.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, param, rms_norm

MLSTM_CHUNK = 256
_M_INIT = -1e30


class MLSTMState(NamedTuple):
    c: torch.Tensor    # [B, H, K, V] matrix memory
    n: torch.Tensor    # [B, H, K]
    m: torch.Tensor    # [B, H]


class SLSTMState(NamedTuple):
    h: torch.Tensor    # [B, H, D]
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    h = cfg.n_heads
    return h, cfg.d_model // h


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """``w_qkv`` ``[d, H, 3 hd]``, float32 ``w_if`` ``[d, H, 2]`` and
    ``b_if`` ``[H, 2]``, ``w_gate`` / ``w_out`` ``[d, d]``, ``norm``
    ``[H, hd]``."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        h, hd = _heads(cfg)
        self.w_qkv = param((d, h, 3 * hd), dtype, device)
        self.w_if = param((d, h, 2), torch.float32, device)
        self.b_if = param((h, 2), torch.float32, device)
        self.w_gate = param((d, d), dtype, device)
        self.norm = param((h, hd), dtype, device)
        self.w_out = param((d, d), dtype, device)

    def reset(self, gen) -> None:
        d = self.w_qkv.shape[0]
        for w in (self.w_qkv, self.w_if, self.w_gate, self.w_out):
            w.copy_(dense_init(gen, w.shape, d, w.dtype, w.device))
        self.b_if[:, 0] = 0.0
        self.b_if[:, 1] = 3.0
        self.norm.fill_(1)


def _mlstm_proj(p: MLSTM, x: torch.Tensor, cfg: ModelConfig):
    d, h, e = p.w_qkv.shape
    qkv = (x @ p.w_qkv.reshape(d, h * e)).unflatten(-1, (h, e))
    q, k, v = torch.chunk(qkv, 3, dim=-1)                 # [B,T,H,hd]
    gates = (x.float() @ p.w_if.reshape(d, h * 2)).unflatten(
        -1, (h, 2)) + p.b_if
    return q, k, v, gates[..., 0], gates[..., 1]          # i, f [B,T,H]


def _mlstm_chunk(carry: MLSTMState, q_c, k_c, v_c, i_c, lf_c, tri):
    """One chunk of the stabilised form: ``[B,L,H,*]`` / ``[B,L,H]``."""
    fc = torch.cumsum(lf_c, dim=1)          # inclusive prefix
    # intra-chunk log weights D[t,s] = F_t - F_s + i_s   (s <= t)
    dmat = torch.where(tri, fc[:, :, None] - fc[:, None] + i_c[:, None],
                       torch.full((), _M_INIT, device=fc.device))
    m_intra = dmat.amax(dim=2)              # [B,L,H]
    m_inter = fc + carry.m[:, None]         # [B,L,H]
    m_t = torch.maximum(m_intra, m_inter)
    w = torch.exp(dmat - m_t[:, :, None])
    scores = torch.einsum("blhk,bshk->blsh", q_c.float(), k_c.float()) * w
    inter_scale = torch.exp(m_inter - m_t)  # [B,L,H]
    num = torch.einsum("blsh,bshv->blhv", scores, v_c.float())
    num = num + torch.einsum("blhk,bhkv->blhv", q_c.float(),
                             carry.c) * inter_scale[..., None]
    den = torch.sum(scores, dim=2) + torch.einsum(
        "blhk,bhk->blh", q_c.float(), carry.n) * inter_scale
    y = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]
    # ---- state carry ----
    f_tot = fc[:, -1]                       # [B,H]
    m_out = torch.maximum(f_tot + carry.m,
                          (fc[:, -1:] - fc + i_c).amax(dim=1))
    c_scale = torch.exp(f_tot + carry.m - m_out)
    s_scale = torch.exp((fc[:, -1:] - fc + i_c) - m_out[:, None])
    c_new = carry.c * c_scale[..., None, None] + torch.einsum(
        "blhk,blhv,blh->bhkv", k_c.float(), v_c.float(), s_scale)
    n_new = carry.n * c_scale[..., None] + torch.einsum(
        "blhk,blh->bhk", k_c.float(), s_scale)
    return MLSTMState(c_new, n_new, m_out), y


def mlstm_parallel(p: MLSTM, x: torch.Tensor, cfg: ModelConfig,
                   state: Optional[MLSTMState] = None,
                   return_state: bool = False):
    """Chunkwise-parallel stabilised form.  x: [B,T,d].

    Intra-chunk: quadratic decay-weighted attention (L x L).  Inter-
    chunk: the matrix memory (C, n, m) is carried from chunk to chunk,
    so peak memory is O(T*L) instead of O(T^2).  ``T`` must be a
    multiple of ``min(MLSTM_CHUNK, T)``.
    """
    b, t, d = x.shape
    h, hd = _heads(cfg)
    q, k, v, i_pre, f_pre = _mlstm_proj(p, x, cfg)
    k = k.float() / np.float32(np.sqrt(hd))
    log_f = F.logsigmoid(f_pre)                           # [B,T,H]
    if state is None:
        state = init_mlstm_state(cfg, b, device=x.device)

    L = min(MLSTM_CHUNK, t)
    if t % L:
        raise ValueError(f"sequence of {t} is not a multiple of the chunk "
                         f"{L}")
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    carry, ys = state, []
    for c in range(t // L):
        sl = slice(c * L, (c + 1) * L)
        carry, y = _mlstm_chunk(carry, q[:, sl], k[:, sl], v[:, sl],
                                i_pre[:, sl], log_f[:, sl], tri)
        ys.append(y.to(x.dtype))
    out = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    out = _mlstm_out(p, out, x, cfg)
    if return_state:
        return out, carry
    return out


def mlstm_decode(p: MLSTM, x: torch.Tensor, cfg: ModelConfig,
                 state: MLSTMState) -> Tuple[torch.Tensor, MLSTMState]:
    """One-token recurrence.  x: [B,1,d]."""
    h, hd = _heads(cfg)
    q, k, v, i_pre, f_pre = _mlstm_proj(p, x, cfg)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                   # [B,H,hd]
    i_pre, f_pre = i_pre[:, 0], f_pre[:, 0]               # [B,H]
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + state.m, i_pre)
    f_s = torch.exp(log_f + state.m - m_new)[..., None]
    i_s = torch.exp(i_pre - m_new)[..., None]
    kf = k.float() / np.float32(np.sqrt(hd))
    c_new = state.c * f_s[..., None] + i_s[..., None] * (
        kf[..., :, None] * v.float()[..., None, :])
    n_new = state.n * f_s + i_s * kf
    num = torch.einsum("bhk,bhkv->bhv", q.float(), c_new)
    den = torch.maximum(
        torch.abs(torch.einsum("bhk,bhk->bh", q.float(), n_new)),
        torch.exp(-m_new))
    out = (num / den[..., None]).to(x.dtype)[:, None]     # [B,1,H,hd]
    return _mlstm_out(p, out, x, cfg), MLSTMState(c_new, n_new, m_new)


def _mlstm_out(p: MLSTM, heads_out: torch.Tensor, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    b, t = x.shape[:2]
    heads_out = rms_norm(heads_out, p.norm, cfg.norm_eps)
    flat = heads_out.reshape(b, t, cfg.d_model)
    gate = F.silu(x @ p.w_gate)
    return (flat * gate) @ p.w_out


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None,
                     n_layers: Optional[int] = None) -> MLSTMState:
    """Zero memory, ``m`` at ``-1e30`` (``[L, ...]`` with ``n_layers``)."""
    h, hd = _heads(cfg)
    lead = () if n_layers is None else (n_layers,)
    return MLSTMState(
        c=torch.zeros(lead + (batch, h, hd, hd), dtype=torch.float32,
                      device=device),
        n=torch.zeros(lead + (batch, h, hd), dtype=torch.float32,
                      device=device),
        m=torch.full(lead + (batch, h), _M_INIT, dtype=torch.float32,
                     device=device),
    )


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """float32 ``w_x`` ``[d, H, 4 hd]``, ``r_h`` ``[H, hd, 4 hd]`` and
    ``bias`` ``[H, 4 hd]``; ``norm`` ``[H, hd]``, ``w_out`` ``[d, d]``."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        h, hd = _heads(cfg)
        self.w_x = param((d, h, 4 * hd), torch.float32, device)
        self.r_h = param((h, hd, 4 * hd), torch.float32, device)
        self.bias = param((h, 4 * hd), torch.float32, device)
        self.norm = param((h, hd), dtype, device)
        self.w_out = param((d, d), dtype, device)

    def reset(self, gen) -> None:
        d, _, _ = self.w_x.shape
        hd = self.r_h.shape[1]
        for w, fan_in in ((self.w_x, d), (self.r_h, hd), (self.w_out, d)):
            w.copy_(dense_init(gen, w.shape, fan_in, w.dtype, w.device))
        self.bias.zero_()
        self.norm.fill_(1)


def _slstm_step(p: SLSTM, s: SLSTMState, xg_t: torch.Tensor) -> SLSTMState:
    rg = torch.einsum("bhk,hke->bhe", s.h, p.r_h)
    g = xg_t + rg                                      # [B,H,4hd]
    zi, ii, fi, oi = torch.chunk(g, 4, dim=-1)
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    log_f = F.logsigmoid(fi)
    m_new = torch.maximum(log_f + s.m, ii)
    i_s = torch.exp(ii - m_new)
    f_s = torch.exp(log_f + s.m - m_new)
    c_new = f_s * s.c + i_s * z
    n_new = torch.clamp(f_s * s.n + i_s, min=1e-6)
    h_new = o * c_new / n_new
    return SLSTMState(h_new, c_new, n_new, m_new)


def slstm_forward(p: SLSTM, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[SLSTMState] = None
                  ) -> Tuple[torch.Tensor, SLSTMState]:
    """Recurrent loop over time.  x: [B,T,d]."""
    b, t, d = x.shape
    h, hd = _heads(cfg)
    if state is None:
        state = init_slstm_state(cfg, b, device=x.device)
    xg = (x.float() @ p.w_x.reshape(d, -1)).unflatten(
        -1, (h, 4 * hd)) + p.bias                      # [B,T,H,4hd]
    hs = []
    for i in range(t):
        state = _slstm_step(p, state, xg[:, i])
        hs.append(state.h)
    hs = torch.stack(hs, dim=1)                        # [B,T,H,hd]
    hs = rms_norm(hs.to(x.dtype), p.norm, cfg.norm_eps)
    return hs.reshape(b, t, d) @ p.w_out, state


def init_slstm_state(cfg: ModelConfig, batch: int, device=None,
                     n_layers: Optional[int] = None) -> SLSTMState:
    """Zero ``h`` / ``c``, ``n`` at 1e-6, ``m`` at ``-1e30``."""
    h, hd = _heads(cfg)
    shape = (() if n_layers is None else (n_layers,)) + (batch, h, hd)
    zero = torch.zeros(shape, dtype=torch.float32, device=device)
    return SLSTMState(h=zero, c=zero.clone(), n=zero + 1e-6,
                      m=torch.full(shape, _M_INIT, dtype=torch.float32,
                                   device=device))
