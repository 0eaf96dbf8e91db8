"""Deterministic synthetic token pipeline — port of
``repro.data.pipeline``.

``SyntheticLM`` and ``Prefetcher`` are the reference's, copied (numpy and
threads, no JAX): every (step, row) is a pure function of the seed, so a
restart resumes bit-identically from any step and each data shard makes
only its own rows. ``device_batch`` puts a batch whole on one device;
``make_global_batch`` lays it out over a mesh as a DTensor sharded on the
batch dim, each rank holding only its own rows.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


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


def local_rows(mesh, global_batch: int) -> tuple[int, int]:
    """This rank's rows ``[lo, hi)`` of a ``global_batch``-row batch whose
    batch dim is split over the mesh's ``("pod", "data")`` axes (major to
    minor, as the reference's ``P(("pod", "data"))``). Raises a
    ``ValueError`` when they do not divide it."""
    names = mesh.mesh_dim_names
    n, r = 1, 0
    for a in ("pod", "data"):
        if a in names:
            size = mesh.size(names.index(a))
            n, r = n * size, r * size + mesh.get_local_rank(a)
    if global_batch % n:
        raise ValueError(f"a batch of {global_batch} rows does not split "
                         f"into {n} batch shards")
    per = global_batch // n
    return r * per, (r + 1) * per


def make_global_batch(mesh, arrays: dict[str, np.ndarray], *,
                      global_batch: int | None = None
                      ) -> dict[str, DTensor]:
    """Host numpy -> DTensors on ``mesh`` with the batch dim sharded over
    ``("pod", "data")``, built with ``DTensor.from_local`` from this rank's
    rows only (an axis of size 1 splits nothing: ``Replicate``).
    ``arrays`` holds the global arrays, or, with
    ``global_batch``, already just this rank's rows (``local_rows``; as
    ``SyntheticLM.batch_at(step, lo, hi)`` makes them, so that each data
    shard generates only its own slice)."""
    place = tuple(Shard(0) if a in ("pod", "data") and n > 1 else Replicate()
                  for a, n in zip(mesh.mesh_dim_names, mesh.shape))
    out = {}
    for k, v in arrays.items():
        b = global_batch if global_batch is not None else v.shape[0]
        lo, hi = local_rows(mesh, b)
        local = v if global_batch is not None else v[lo:hi]
        if local.shape[0] != hi - lo:
            raise ValueError(f"{k!r}: {local.shape[0]} local rows, expected "
                             f"{hi - lo}")
        t = torch.as_tensor(np.ascontiguousarray(local),
                            device=mesh.device_type)
        out[k] = DTensor.from_local(t, mesh, place, run_check=False)
    return out


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
