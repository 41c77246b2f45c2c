"""Faults planted under a latent cell's timed path (Kimi K2's), as
``faults.py``'s are under the other cells'.

The latent cell's microbatches hold one row each, so ``faults.py``'s
half batch (the first half of each microbatch's rows) would leave them
empty.  Here half the batch is half of its microbatches: the step sees
the first half of them, each twice, so its loss and gradients are those
of half the rows, at the shapes the sound step runs.
"""
from __future__ import annotations


def half_batch(step, cfg):
    """The step sees the first half of the microbatches, each twice."""
    def broken(params, opt_state, batch):
        return step(params, opt_state, {
            k: v[: v.shape[0] // 2].repeat_interleave(2, dim=0)
            for k, v in batch.items()})
    return broken


FAULTS = {"half_batch": half_batch}
