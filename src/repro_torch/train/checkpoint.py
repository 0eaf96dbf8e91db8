"""Checkpointing with atomic publish and async save — port of
``repro.train.checkpoint``.

Format: <dir>/step_<N>/
  manifest.json        — every leaf's shape and dtype, and the step
  <leaf-path>.npy      — one file per leaf

A tree is nested dicts, tuples and lists (``OptState`` included),
``QTensor``s (two leaves, ``q`` and ``scale``), tensors and Python ints.
numpy has no bfloat16: a bf16 tensor is stored as its raw 16 bits
(``uint16``), with ``"bfloat16"`` in the manifest, and restored bit for bit.
A save snapshots every leaf to host memory in the calling thread, then
writes the files (on a background thread when ``blocking=False``) into a
writer-unique staging directory and publishes it with ``os.replace``.

Across ranks: a save gathers every DTensor leaf whole (``full_tensor``, a
collective every rank takes part in) before anything else, so the writer
thread issues no collective; rank 0 writes, and a blocking save ends at a
barrier of every rank. ``restore`` puts each leaf back on the device and in
the dtype of the matching leaf of ``like_tree`` and, with ``shardings`` (a
tree of ``rules.NamedSharding`` of the same structure, on any mesh), lays
it out by them: the elastic restore, each rank keeping its slice of the
whole leaf it reads. Without them a DTensor leaf of ``like_tree`` keeps
its own layout.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.optim.adamw import QTensor
from repro_torch.sharding import rules

_SEP = "__"
_save_seq = itertools.count()


def _items(node):
    """(key, child) pairs of an inner node; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, QTensor):
        return [("q", node.q), ("scale", node.scale)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten(tree, prefix: tuple = ()) -> dict:
    items = _items(tree)
    if items is None:
        return {_SEP.join(prefix): tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, prefix + (k,)))
    return flat


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """Every rank waits for the others (nothing without a process
    group)."""
    if dist.is_initialized():
        dist.barrier()


def _to_host(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), \
                "bfloat16"
        return t.numpy().copy(), str(t.numpy().dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, tree, *, blocking: bool = True):
    """Save ``tree``; returns the writer thread when ``blocking=False``.

    The staging dir is writer-unique so a blocking save and a still-running
    async save of the same step never collide; os.replace publishes
    atomically and the loser's rename is a no-op failure we swallow.
    Every rank calls it (DTensor leaves are gathered here, in the calling
    thread, a leaf at a time); rank 0 keeps the host copies and writes,
    the others return None."""
    host = {}
    for k, v in _flatten(tree).items():                   # snapshot
        if isinstance(v, DTensor):
            v = v.full_tensor()          # a collective: every rank
        if _rank() == 0:
            host[k] = _to_host(v)
        del v
    if _rank() != 0:
        if blocking:
            barrier()
        return None
    out = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = out + f".tmp.{os.getpid()}.{next(_save_seq)}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step,
                "leaves": {k: {"shape": list(a.shape), "dtype": dt}
                           for k, (a, dt) in host.items()}}

    def write():
        for k, (a, _) in host.items():
            np.save(os.path.join(tmp, k + ".npy"), a)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        try:
            os.replace(tmp, out)  # atomic publish
        except OSError:
            # another writer already published this step
            shutil.rmtree(tmp, ignore_errors=True)

    if blocking:
        write()
        barrier()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1].split(".")[0]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and ".tmp" not in d]
    return max(steps) if steps else None


def _load(src: str, key: str, dtype: str, like, sharding=None):
    a = np.load(os.path.join(src, key + ".npy"))
    if tuple(a.shape) != tuple(np.shape(like)):
        raise ValueError(f"{key}: checkpoint shape {a.shape}, expected "
                         f"{tuple(np.shape(like))}")
    if not isinstance(like, torch.Tensor):
        return type(like)(a) if isinstance(like, (int, float)) else a
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if sharding is not None:
        return distribute_tensor(
            t.to(device=sharding.mesh.device_type, dtype=like.dtype),
            sharding.mesh, sharding.placements, src_data_rank=None)
    t = t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, DTensor):
        return distribute_tensor(t, like.device_mesh, like.placements,
                                 src_data_rank=None)
    return t


def restore_into(ckpt_dir: str, step: int, tree) -> None:
    """Copy the leaves saved at ``step`` into ``tree``'s plain tensors in
    place, one leaf at a time: each read from its file and put on its
    tensor's device before the next, so that neither the host nor the
    device holds a second copy of the whole tree (a checkpoint of
    deepseek-v3-671b at 4 layers is 30.2 GB of bf16 weights)."""
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    with torch.no_grad():
        for key, t in _flatten(tree).items():
            if isinstance(t, DTensor) or not isinstance(t, torch.Tensor):
                raise TypeError(f"{key}: restore_into takes plain tensors")
            t.copy_(_load(src, key, leaves[key]["dtype"], t))


def restore(ckpt_dir: str, step: int, like_tree, shardings=None):
    """The tree saved at ``step``, in the structure of ``like_tree``, each
    leaf on the device and in the dtype of ``like_tree``'s. ``shardings``
    (the same structure, a ``rules.NamedSharding`` at each tensor leaf;
    possibly for a different mesh than the checkpoint was saved from)
    lays the leaves out on its mesh: elastic re-sharding on load."""
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    shard_flat = _flatten(shardings) if shardings is not None else {}

    def build(node, prefix):
        items = _items(node)
        if items is None:
            key = _SEP.join(prefix)
            sh = shard_flat.get(key)
            return _load(src, key, leaves[key]["dtype"], node,
                         sh if isinstance(sh, rules.NamedSharding) else None)
        kids = [build(v, prefix + (k,)) for k, v in items]
        if isinstance(node, dict):
            return dict(zip(node.keys(), kids))
        if isinstance(node, QTensor):
            return QTensor(kids[0], kids[1], node.shape)
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*kids)
        return type(node)(kids)

    return build(like_tree, ())
