"""Training-step factory: remat + microbatched gradient accumulation.

The port of ``repro/train/step.py``.  ``make_train_step`` closes over
the config and returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``.  Batches arrive with a leading microbatch axis
``[mb, B/mb, ...]``; each microbatch's gradients are taken with
``torch.autograd.grad`` and summed in float32 (``.grad`` would sum them
in the parameters' dtype, bfloat16 for a bfloat16 model), then divided
by ``mb``, and one AdamW step follows (MaxText-style, as the
reference's ``lax.scan``).  With one microbatch the gradients go to the
optimiser in the parameters' dtype, as the reference's do.  Every layer
is rematerialised in the backward pass (``transformer.loss_fn`` under
grad).  The step updates the parameters and the moments in place
(:func:`repro_torch.train.optim.update`) and returns them.

Spans (:mod:`repro_torch.spans`, recorded only when it is active):
``train.step`` around the whole step (a new step id), ``train.fwd`` and
``train.bwd`` around each microbatch's loss and gradients,
``train.accumulate`` around the float32 sums and the division (more than
one microbatch), ``train.update`` around AdamW.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models import transformer as tf_lib
from repro_torch.train import optim as optim_lib


def _grads(loss: torch.Tensor, leaves) -> Tuple[torch.Tensor, ...]:
    # a leaf the loss does not reach (the hybrid family's unused Mamba
    # ``ln1``) gets zeros, as jax.grad gives it
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tuple(torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: optim_lib.OptConfig,
                    microbatches: int = 1) -> Callable:
    def train_step(params, opt_state: optim_lib.OptState,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[tf_lib.Transformer, optim_lib.OptState, Dict]:
        with spans.span("train.step", new_step=True):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        names, leaves = zip(*params.named_parameters())
        for p in leaves:
            p.requires_grad_(True)
        if microbatches == 1:
            mb = {k: v[0] for k, v in batch.items()}
            with spans.span("train.fwd"):
                loss, metrics = tf_lib.loss_fn(params, cfg, mb)
            with spans.span("train.bwd"):
                grads = _grads(loss, leaves)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in leaves]
            metrics = None
            for i in range(microbatches):
                with spans.span("train.fwd"):
                    loss, m = tf_lib.loss_fn(
                        params, cfg, {k: v[i] for k, v in batch.items()})
                with spans.span("train.bwd"):
                    mb_grads = _grads(loss, leaves)
                with spans.span("train.accumulate"):
                    for acc, g in zip(grads, mb_grads):
                        acc += g.float()
                del mb_grads        # before the next microbatch's forward
                m = {k: v.detach() for k, v in m.items()}
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in metrics}
            with spans.span("train.accumulate"):
                grads = [g / microbatches for g in grads]
            metrics = {k: v / microbatches for k, v in metrics.items()}
        with spans.span("train.update"):
            params, opt_state, gnorm = optim_lib.update(
                dict(zip(names, grads)), opt_state, params, opt_cfg)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, opt_cfg: optim_lib.OptConfig,
                     seed: int = 0, device: DeviceLike = None
                     ) -> Tuple[tf_lib.Transformer, optim_lib.OptState]:
    """Random weights from ``seed`` on ``device`` (``None``: cuda) and
    zero moments; the parameters require grad."""
    params = tf_lib.init_params(cfg, seed=seed, device=device)
    params.requires_grad_(True)
    return params, optim_lib.init(params, opt_cfg)
