"""Deterministic synthetic token pipeline, sharded per data-parallel rank.

The port's copy of ``repro/data/pipeline.py`` (pure numpy, so the port
keeps its own): each host produces only its DP shard of the global
batch from a seed + step index (restart-safe: the stream is a pure
function of (seed, step, dp_rank), so checkpoint restart replays
exactly), with a background prefetch thread keeping ``prefetch``
batches ready.  Batches are numpy arrays; the caller makes tensors on
its device (``torch.from_numpy(a).to(device)``).

The synthetic distribution is a Zipfian unigram mix with a Markov
component so that losses move meaningfully during the integration
tests (pure-uniform tokens give a flat loss surface).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class TokenPipeline:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 microbatches: int = 1, dp_rank: int = 0,
                 dp_size: int = 1, seed: int = 0,
                 extra_shapes: Optional[Dict] = None,
                 prefetch: int = 2):
        assert global_batch % (dp_size * microbatches) == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.mb = microbatches
        self.local_batch = global_batch // dp_size
        self.dp_rank = dp_rank
        self.seed = seed
        self.extra_shapes = extra_shapes or {}
        # Zipf-ish unigram distribution over a capped support
        support = min(vocab, 32_768)
        ranks = np.arange(1, support + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._support = support
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- pure batch function (restart-safe) ----------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.dp_rank)
        b, t = self.local_batch, self.seq_len
        base = rng.choice(self._support, size=(b, t + 1),
                          p=self._probs)
        # Markov smoothing: with p=0.3 repeat the previous token + 1
        rep = rng.random((b, t + 1)) < 0.3
        shifted = np.roll(base, 1, axis=1) + 1
        tokens = np.where(rep, shifted % self.vocab, base).astype(
            np.int32)
        batch = {
            "tokens": tokens[:, :-1].reshape(self.mb, b // self.mb, t),
            "labels": tokens[:, 1:].reshape(self.mb, b // self.mb, t),
        }
        for name, (shape, dtype) in self.extra_shapes.items():
            batch[name] = rng.standard_normal(
                (self.mb, b // self.mb, *shape)).astype(dtype) * 0.1
        return batch

    # -- prefetch thread ------------------------------------------------
    def start(self, from_step: int = 0) -> None:
        def worker():
            step = from_step
            while not self._stop.is_set():
                try:
                    self._q.put(self.batch_at(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def next_prefetched(self) -> Dict[str, np.ndarray]:
        return self._q.get()
