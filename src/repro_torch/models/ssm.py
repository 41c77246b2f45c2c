"""Mamba2 (SSD) block: chunked-parallel training, O(1) recurrent decode.

The port of ``repro/models/ssm.py``.  The selective state-space
recurrence with scalar-per-head decay

    h_t = exp(dt_t * A_h) h_{t-1} + dt_t * (B_t (x) x_t)
    y_t = C_t . h_t + D_h x_t

is computed chunk-parallel for training/prefill (intra-chunk
quasi-attention, the state carried from chunk to chunk) and as the
plain recurrence for decode.  B/C are a single shared group (G=1).

The decay math (the ``cumsum`` of log-decays and the ``exp`` of their
differences) runs in float32, with the causal mask applied before the
``exp`` (the reference's gradient is NaN where a masked difference
overflows; the values are the same), and ``a_log``, ``d_skip`` and
``dt_bias`` are float32 in a bfloat16 model, as in the reference.
In a bfloat16 model the chunk's ``C . B`` and decay weights, and the
decode's ``C . h``, stay float32, where the reference rounds them to
bfloat16 (and ``h`` before its product in the decode): the chunked
forward and the recurrent decode then agree far more closely than the
reference's two paths do (``tests/test_torch_serve.py::
test_bf16_decode_gap_within_the_references``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, param, rms_norm

CHUNK = 256


class SSMState(NamedTuple):
    h: torch.Tensor        # [B, H, P, N] float32 state
    conv: torch.Tensor     # [B, W-1, d_conv] conv tail


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


class SSM(nn.Module):
    """``w_in`` ``[d, 2 d_in + 2 N + H]``, ``conv_w`` ``[W, d_conv]``,
    ``conv_b``, float32 ``a_log`` / ``d_skip`` / ``dt_bias`` ``[H]``,
    ``norm`` ``[d_in]``, ``w_out`` ``[d_in, d]``."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        d_in, h, _, n = dims(cfg)
        d_conv = d_in + 2 * n          # conv runs over [x, B, C]
        self.w_in = param((d, 2 * d_in + 2 * n + h), dtype, device)
        self.conv_w = param((cfg.conv_width, d_conv), dtype, device)
        self.conv_b = param((d_conv,), dtype, device)
        self.a_log = param((h,), torch.float32, device)
        self.d_skip = param((h,), torch.float32, device)
        self.dt_bias = param((h,), torch.float32, device)
        self.norm = param((d_in,), dtype, device)
        self.w_out = param((d_in, d), dtype, device)

    def reset(self, gen) -> None:
        d, d_in = self.w_in.shape[0], self.norm.shape[0]
        width = self.conv_w.shape[0]
        for w, fan_in in ((self.w_in, d), (self.conv_w, width),
                          (self.w_out, d_in)):
            w.copy_(dense_init(gen, w.shape, fan_in, w.dtype, w.device))
        self.conv_b.zero_()
        h = self.a_log.shape[0]
        self.a_log.copy_(torch.log(torch.linspace(
            1.0, 16.0, h, dtype=torch.float32, device=self.a_log.device)))
        self.d_skip.fill_(1)
        self.dt_bias.zero_()
        self.norm.fill_(1)


def _split_proj(p: SSM, u: torch.Tensor, cfg: ModelConfig):
    d_in, _, _, n = dims(cfg)
    zxbcdt = u @ p.w_in
    return torch.split(zxbcdt, [d_in, d_in + 2 * n,
                                zxbcdt.shape[-1] - 2 * d_in - 2 * n], dim=-1)


def _conv(p: SSM, xbc: torch.Tensor, tail: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv over time; returns output and new tail."""
    w = p.conv_w                             # [W, C]
    width = w.shape[0]
    padded = torch.cat([tail, xbc], dim=1)
    out = 0
    for i in range(width):
        out = out + padded[:, i:padded.shape[1] - (width - 1 - i)] * w[i]
    out = F.silu(out + p.conv_b)
    new_tail = padded[:, -(width - 1):]
    return out, new_tail


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _gates(p: SSM, dt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = _softplus(dt.float() + p.dt_bias)
    a = -torch.exp(p.a_log)                  # [H], negative decay rates
    return dt, a


def _chunk(x_c, b_c, c_c, dt_c, h_in, a):
    """One chunk: x [B,L,H,P], b/c [B,L,N], dt [B,L,H], h [B,H,P,N]."""
    L = x_c.shape[1]
    da = dt_c * a                                        # [B,L,H]
    cum = torch.cumsum(da, dim=1)                        # log-decay prefix
    # intra-chunk quasi-attention
    cb = torch.einsum("bln,bsn->bls", c_c.float(), b_c.float())  # [B,L,L]
    rel = cum[:, :, None] - cum[:, None]                 # [B,L,L,H]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    # the reference masks after the exp (``where(tri, exp(rel), 0)``);
    # above the diagonal ``rel`` is a positive sum of decays that can
    # overflow, and the masked ``inf`` then makes its gradient NaN
    # (0 * inf).  Masking before the exp gives the same values and a
    # finite gradient.
    w_att = torch.exp(torch.where(tri[None, :, :, None], rel,
                                  torch.full((), -torch.inf,
                                             device=a.device)))
    w_att = w_att * cb[..., None]                        # [B,L,L,H]
    dx = x_c * dt_c[..., None]                           # [B,L,H,P]
    y_intra = torch.einsum("blsh,bshp->blhp", w_att, dx)
    # inter-chunk contribution from the carried state
    y_inter = torch.einsum("bln,bhpn->blhp", c_c.to(h_in.dtype), h_in) \
        * torch.exp(cum)[..., None]
    # state update
    dec_end = torch.exp(cum[:, -1])                      # [B,H]
    w_state = torch.exp(cum[:, -1:, :] - cum)            # [B,L,H]
    h_out = h_in * dec_end[:, :, None, None] + torch.einsum(
        "blhp,bln,blh->bhpn", dx.float(), b_c.float(), w_state)
    return (y_intra + y_inter).to(x_c.dtype), h_out


def ssm_forward(p: SSM, u: torch.Tensor, cfg: ModelConfig,
                state: Optional[SSMState] = None
                ) -> Tuple[torch.Tensor, SSMState]:
    """Full-sequence chunked forward.  u: [B, T, d].  ``T`` must be a
    multiple of the chunk ``min(CHUNK, T)``, as in the reference."""
    b, t, _ = u.shape
    d_in, h, p_dim, n = dims(cfg)
    z, xbc, dt = _split_proj(p, u, cfg)
    if state is None:
        tail = torch.zeros((b, cfg.conv_width - 1, xbc.shape[-1]),
                           dtype=xbc.dtype, device=u.device)
        h0 = torch.zeros((b, h, p_dim, n), dtype=torch.float32,
                         device=u.device)
    else:
        tail, h0 = state.conv, state.h
    xbc, new_tail = _conv(p, xbc, tail)
    x, bmat, cmat = torch.split(xbc, [d_in, n, n], dim=-1)
    x = x.reshape(b, t, h, p_dim)
    dtv, a = _gates(p, dt)

    L = min(CHUNK, t)
    if t % L:
        raise ValueError(f"sequence of {t} is not a multiple of the chunk "
                         f"{L}")
    nc = t // L
    h_c, ys = h0, []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        y, h_c = _chunk(x[:, sl], bmat[:, sl], cmat[:, sl], dtv[:, sl],
                        h_c, a)
        ys.append(y)
    y = torch.cat(ys, dim=1) if nc > 1 else ys[0]
    y = y + x * p.d_skip[None, None, :, None].to(x.dtype)
    y = y.reshape(b, t, d_in) * F.silu(z)
    y = rms_norm(y, p.norm, cfg.norm_eps)
    return y @ p.w_out, SSMState(h=h_c, conv=new_tail)


def ssm_decode(p: SSM, u: torch.Tensor, cfg: ModelConfig,
               state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """Single-token recurrent step.  u: [B, 1, d]."""
    b = u.shape[0]
    d_in, h, p_dim, n = dims(cfg)
    z, xbc, dt = _split_proj(p, u, cfg)
    xbc, new_tail = _conv(p, xbc, state.conv)
    x, bmat, cmat = torch.split(xbc, [d_in, n, n], dim=-1)
    x = x.reshape(b, 1, h, p_dim)[:, 0]                  # [B,H,P]
    dtv, a = _gates(p, dt)
    dtv = dtv[:, 0]                                      # [B,H]
    decay = torch.exp(dtv * a)                           # [B,H]
    h_new = state.h * decay[:, :, None, None] + torch.einsum(
        "bhp,bn,bh->bhpn", x.float(), bmat[:, 0].float(), dtv)
    y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].float(), h_new).to(x.dtype)
    y = y + x * p.d_skip[None, :, None].to(x.dtype)
    y = y.reshape(b, 1, d_in) * F.silu(z)
    y = rms_norm(y, p.norm, cfg.norm_eps)
    return y @ p.w_out, SSMState(h=h_new, conv=new_tail)


def init_state(cfg: ModelConfig, batch: int, dtype, device=None,
               n_layers: Optional[int] = None) -> SSMState:
    """Zero state (``[L, ...]`` stacked with ``n_layers``)."""
    d_in, h, p_dim, n = dims(cfg)
    lead = () if n_layers is None else (n_layers,)
    return SSMState(
        h=torch.zeros(lead + (batch, h, p_dim, n), dtype=torch.float32,
                      device=device),
        conv=torch.zeros(lead + (batch, cfg.conv_width - 1, d_in + 2 * n),
                         dtype=dtype, device=device),
    )
