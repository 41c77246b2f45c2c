"""Shared model building blocks: norms, RoPE, init, parameter counts.

The port's copy of ``repro/models/common.py``.  The reference threads
a logical-axis sharding context (``MeshContext``, ``shard``) through
its model code; on one device every constraint is the identity, so the
port has none, and the parameter placement rules live in
:mod:`repro_torch.sharding.rules`.  Initialisation draws from an
explicit :class:`torch.Generator` on the parameters' device.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def inv_freq(head_dim: int, theta: float,
             device=None) -> torch.Tensor:
    """The RoPE inverse frequencies, float32 ``[head_dim / 2]``."""
    return 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def rope_angles(head_dim: int, theta: float, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cos`` / ``sin`` at ``positions`` (any shape), ``[..., hd / 2]``.

    The same float32 ``pos * inv`` product a :func:`rope_freqs` table
    row holds, computed for the given positions only.
    """
    inv = inv_freq(head_dim, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def rope_freqs(head_dim: int, max_pos: int, theta: float,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``[max_pos, hd / 2]`` cos / sin table of positions 0..max_pos-1."""
    return rope_angles(head_dim, theta, torch.arange(
        max_pos, dtype=torch.float32, device=device))


def rotate(x: torch.Tensor, cos_t: torch.Tensor,
           sin_t: torch.Tensor) -> torch.Tensor:
    """Split-halves rotation of ``x`` ``[B, T, H, hd]`` by angles that
    broadcast against ``[B, T, H, hd / 2]``."""
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos_t - x2 * sin_t, x2 * cos_t + x1 * sin_t],
                    dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, T, H, hd]; cos/sin: [max_pos, hd/2]; positions: [B, T]."""
    if positions is None:
        cos_t = cos[: x.shape[1]][None, :, None, :]
        sin_t = sin[: x.shape[1]][None, :, None, :]
    else:
        cos_t = cos[positions][:, :, None, :]
        sin_t = sin[positions][:, :, None, :]
    return rotate(x, cos_t, sin_t)


def dense_init(gen: Optional[torch.Generator], shape: Sequence[int],
               fan_in: int, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    """float32 normal x ``1 / sqrt(fan_in)``, then cast."""
    scale = 1.0 / np.sqrt(max(fan_in, 1))
    return (torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def embed_init(gen: Optional[torch.Generator], shape: Sequence[int],
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """float32 normal x 0.02, then cast."""
    return (torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                        device=device) * 0.02).to(dtype)


def param(shape: Sequence[int], dtype, device) -> nn.Parameter:
    """An uninitialised, frozen parameter (serving computes no grads)."""
    return nn.Parameter(torch.empty(tuple(shape), dtype=dtype,
                                    device=device), requires_grad=False)


def count_params(params) -> int:
    """Parameter count of a module (or a mapping of arrays)."""
    if isinstance(params, nn.Module):
        return int(sum(p.numel() for p in params.parameters()))
    return int(sum(np.prod(p.shape) for p in params.values()))
