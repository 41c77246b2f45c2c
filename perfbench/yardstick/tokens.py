"""The benchmark's token draw: a frozen copy of the port's
``data/pipeline.py`` ``TokenPipeline.batch_at`` (Zipf unigrams over a
capped support, with a Markov repeat), without its prefetch thread, and
with the Zipf exponent a parameter of the traffic mix.

``batch_at(seed, step, ...)`` is a pure function of its arguments, so the
program and the reference read the same batches.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def batch_at(seed: int, step: int, vocab: int, seq_len: int, batch: int,
             microbatches: int = 1, zipf_exponent: float = 1.0
             ) -> Dict[str, np.ndarray]:
    """``tokens`` / ``labels`` int32 ``[microbatches, batch / mb, seq_len]``.
    Unigram weights fall as ``rank ** -zipf_exponent``: 1.0 is the
    pipeline's draw, 0.0 an even one."""
    if batch % microbatches:
        raise ValueError("batch must divide into microbatches")
    support = min(vocab, 32_768)
    ranks = np.arange(1, support + 1, dtype=np.float64)
    weights = ranks ** -float(zipf_exponent)
    probs = weights / np.sum(weights)
    rng = np.random.default_rng((seed * 1_000_003 + step) * 65_537)
    base = rng.choice(support, size=(batch, seq_len + 1), p=probs)
    rep = rng.random((batch, seq_len + 1)) < 0.3
    shifted = np.roll(base, 1, axis=1) + 1
    tokens = np.where(rep, shifted % vocab, base).astype(np.int32)
    mb = microbatches
    return {"tokens": tokens[:, :-1].reshape(mb, batch // mb, seq_len),
            "labels": tokens[:, 1:].reshape(mb, batch // mb, seq_len)}
