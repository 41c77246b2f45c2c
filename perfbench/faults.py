"""Faults planted under the timed path, to show that ``correct`` catches
them (the card's calibration and the CPU tests).

Each wraps a train step ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` of a model config ``cfg``.  A training cell can have
two of them: it runs on one card (no exchange between chips to leave out)
and produces no tokens to alter.
"""
from __future__ import annotations

import torch


def unchanged_state(step, cfg):
    """The step returns its parameters and AdamW state unchanged, with the
    loss of a forward pass."""
    from repro_torch.models import transformer as tf_lib

    def broken(params, opt_state, batch):
        with torch.no_grad():
            _, metrics = tf_lib.loss_fn(params, cfg,
                                        {k: v[0] for k, v in batch.items()})
        return params, opt_state, metrics
    return broken


def half_batch(step, cfg):
    """The step sees the first half of each microbatch's rows; the loss is
    the mean over those."""
    def broken(params, opt_state, batch):
        return step(params, opt_state,
                    {k: v[:, : v.shape[1] // 2] for k, v in batch.items()})
    return broken


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch}
