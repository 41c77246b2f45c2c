"""AdamW with a warmup + cosine schedule and moments in ``state_dtype``.

The port of ``repro/train/optim.py``.  Parameters are a model's named
parameters (an ``nn.Module``) or a mapping of name to tensor; the
moments ``mu`` / ``nu`` are dicts under the same names, in
``state_dtype`` (float32 by default, bfloat16 for the
trillion-parameter config), and ``step`` is a 0-d int32 tensor on the
parameters' device.

:func:`update` computes each leaf's step in float32, as the reference
does, and writes the new parameters (cast to their dtype) and moments
in place: the reference's functional update is a copy that XLA elides,
and eagerly it would hold a second copy of the model and its moments.

Weight decay follows the reference's stacked layout.  The reference
decays a leaf when its ``ndim >= 2``, and it stacks every per-layer leaf
``[L, ...]``, so a layer's norm weights (``layers.ln1``, ``attn.q_norm``)
are 2-D there and decayed.  The port holds one module per layer, so a
leaf whose name carries a layer index (``layers.3.ln1``) counts one
dimension more (:func:`reference_ndim`); unstacked leaves (``final_norm``,
the hybrid family's ``shared_attn``) count their own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Tuple, Union

import torch
from torch import nn

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"    # "bfloat16" for the 1T config


class OptState(NamedTuple):
    step: torch.Tensor              # 0-d int32
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def named(params: Params) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters or of a mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """The leaf's rank in the reference, which stacks per-layer leaves:
    a name whose second part is a layer index has one axis more."""
    parts = name.split(".")
    return p.dim() + (len(parts) > 1 and parts[1].isdigit())


def decay_mask(params: Params) -> Dict[str, bool]:
    """Whether each leaf takes weight decay (the reference's
    ``p.ndim >= 2`` on its stacked leaf)."""
    return {k: reference_ndim(k, p) >= 2 for k, p in named(params).items()}


def init(params: Params, cfg: OptConfig) -> OptState:
    dt = getattr(torch, cfg.state_dtype)
    leaves = named(params)
    dev = next(iter(leaves.values())).device

    def zeros():
        return {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                for k, p in leaves.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=zeros(), nu=zeros())


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup then cosine decay to 0.1 x ``lr``; float32 from an int32
    step, as the reference computes it."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf."""
    sq = sum(torch.sum(torch.square(g.float())) for g in grads.values())
    return torch.sqrt(sq)


@torch.no_grad()
def update(grads: Mapping[str, torch.Tensor], state: OptState,
           params: Params, cfg: OptConfig
           ) -> Tuple[Params, OptState, torch.Tensor]:
    """One AdamW step; returns ``(params, state, grad_norm)``.

    ``grads`` maps each parameter's name to its gradient (any float
    dtype).  The parameters and the moments are written in place and
    returned; ``state.step`` is a new tensor.
    """
    dt = getattr(torch, cfg.state_dtype)
    leaves = named(params)
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    decay = decay_mask(leaves)
    for k, p in leaves.items():
        g = grads[k].float() * scale
        mu32 = state.mu[k].float() * b1 + (1 - b1) * g
        nu32 = state.nu[k].float() * b2 + (1 - b2) * g * g
        mhat = mu32 / bc1
        vhat = nu32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decay[k]:   # decoupled weight decay on (stacked) matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        state.mu[k].copy_(mu32.to(dt))
        state.nu[k].copy_(nu32.to(dt))
    return params, OptState(step=step, mu=state.mu, nu=state.nu), gnorm
