"""Deterministic synthetic token pipeline — port of
``repro.data.pipeline``.

``SyntheticLM`` and ``Prefetcher`` are the reference's, copied (numpy and
threads, no JAX): every (step, row) is a pure function of the seed, so a
restart resumes bit-identically from any step and each data shard makes
only its own rows. ``device_batch`` takes the place of
``make_global_batch``: one device, no mesh yet.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class SyntheticLM:
    """Zipfian token stream with a learnable bigram structure so the training
    loss actually decreases (tests assert it)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0):
        self.vocab, self.seq_len, self.global_batch = vocab, seq_len, global_batch
        self.seed = seed
        probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
        self._probs = probs / probs.sum()

    def batch_at(self, step: int, lo: int = 0, hi: int | None = None
                 ) -> np.ndarray:
        """Rows [lo, hi) of the global batch for `step` (shard-local gen)."""
        hi = self.global_batch if hi is None else hi
        # generate the full batch index stream cheaply but slice locally:
        # rows are independent streams keyed by (seed, step, row)
        out = np.empty((hi - lo, self.seq_len), np.int32)
        for i, row in enumerate(range(lo, hi)):
            r = np.random.default_rng((self.seed, step, row))
            toks = r.choice(self.vocab, size=self.seq_len, p=self._probs)
            # inject bigram structure: every odd position repeats f(prev)
            toks[1::2] = (toks[0::2] * 31 + 7) % self.vocab
            out[i] = toks
        return out


def device_batch(arrays: dict[str, np.ndarray],
                 device: torch.device) -> dict[str, torch.Tensor]:
    """Host numpy arrays -> tensors on ``device`` (the batch whole on one
    device; the counterpart of ``make_global_batch`` on a 1-device mesh)."""
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


class Prefetcher:
    """Background-thread prefetch of the next N batches."""

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
