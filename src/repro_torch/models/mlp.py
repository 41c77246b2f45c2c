"""Gated (SwiGLU) feed-forward block: the port of ``repro/models/mlp.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import dense_init, param


class MLP(nn.Module):
    """``w_gate`` / ``w_up`` ``[d, f]``, ``w_down`` ``[f, d]``."""

    def __init__(self, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()
        self.w_gate = param((d_model, d_ff), dtype, device)
        self.w_up = param((d_model, d_ff), dtype, device)
        self.w_down = param((d_ff, d_model), dtype, device)

    def reset(self, gen) -> None:
        d, f = self.w_gate.shape
        for w, fan_in in ((self.w_gate, d), (self.w_up, d),
                          (self.w_down, f)):
            w.copy_(dense_init(gen, w.shape, fan_in, w.dtype, w.device))


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down
