"""AdamW with optional block-quantized (int8) moments — port of
``repro.optim.adamw``.

Parameters, gradients and moments are flat dicts keyed by the LM's
parameter names. The arithmetic is the reference's, operation for
operation, in float32: the global-norm clip, the warmup-cosine schedule,
bias correction, decoupled weight decay on the leaves ``decay`` names, and
the int8 moment store (blockwise absmax over the last axis, 128 values a
block, one float32 scale each, round half to even). The int8 store is what
lets llama3-8b's training state fit one 80 GB card: float32 moments would
take 64 GB beside 32 GB of bf16 parameters and gradients.

Unlike the reference, which is functional, ``update`` writes the new
parameters into the given tensors in place and consumes ``grads`` leaf by
leaf, so that at most one leaf's float32 temporaries are alive at a time
and each gradient is freed once applied.

Parameters, gradients and moments may be DTensors on a mesh (the ZeRO-1
layout of ``train.loop.state_shardings``: the moments split over
``data`` where the parameter is not). The global norm then reduces each
leaf's partial sum of squares before the clip factor is taken. A float32
moment's update runs on local tensors in the moment's layout (the
gradient and the parameter are sliced to it, no communication) and is
redistributed to the parameter's layout for the in-place write, which
DTensor refuses across layouts. An int8 moment whose ``q`` and
``scale`` are laid out as the parameter, on dims other than the last (the
blocks' dim), updates each rank's rows on local tensors: a block never
spans two ranks (deepseek-v3-671b's experts, split over ("data",
"model"), whose whole float32 temporaries would fill a card). Otherwise
``q`` and ``scale`` may be split on different dims, so the update runs
on the gathered leaf, and the new ``q`` and ``scale`` are sliced back to
their layouts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

BLOCK = 128


# --- blockwise int8 quantization -------------------------------------------
@dataclasses.dataclass
class QTensor:
    """int8 moment store with the parameter's layout: ``q`` has its shape
    (last dim padded to a BLOCK multiple) and ``scale`` one float32 absmax
    per last-dim block. ``shape`` is the parameter's shape."""
    q: torch.Tensor        # int8, shape[:-1] + (padded last,)
    scale: torch.Tensor    # float32, shape[:-1] + (n_blocks,)
    shape: tuple

    def __repr__(self):
        return f"QTensor(shape={self.shape})"


def qtensor_shapes(shape: tuple) -> tuple[tuple, tuple]:
    """The shapes of ``quantize``'s ``q`` and ``scale`` for a tensor of
    ``shape`` (a scalar is taken as one value)."""
    shape = tuple(shape) or (1,)
    n_blocks = -(-shape[-1] // BLOCK)
    return shape[:-1] + (n_blocks * BLOCK,), shape[:-1] + (n_blocks,)


def quantize(x: torch.Tensor) -> QTensor:
    shape = tuple(x.shape)
    x = x.float()
    if x.dim() == 0:
        x = x[None]
    pad = (-x.shape[-1]) % BLOCK
    if pad:
        x = F.pad(x, (0, pad))
    blocks = x.reshape(*x.shape[:-1], -1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=-1) / 127.0
    q = torch.div(blocks, torch.clamp_min(scale[..., None], 1e-20)).round_()
    return QTensor(q.to(torch.int8).reshape(*x.shape[:-1], -1), scale, shape)


def dequantize(t: QTensor) -> torch.Tensor:
    blocks = t.q.reshape(*t.q.shape[:-1], -1, BLOCK).float()
    out = blocks.mul_(t.scale[..., None]).reshape(t.q.shape)
    if not t.shape:
        return out[0]
    return out[..., :t.shape[-1]].reshape(t.shape)


# --- AdamW -------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantized_state: bool = False     # int8 m/v
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Learning rate at ``step``: linear warmup, then cosine down to
    ``min_lr_frac``; a float32 scalar tensor, computed in float32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.clamp_max(warm, 1.0) * cos


class OptState(NamedTuple):
    step: int
    m: dict
    v: dict


def init(cfg: AdamWConfig, params: dict) -> OptState:
    def zero_like(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return quantize(z) if cfg.quantized_state else z
    return OptState(0, {k: zero_like(p) for k, p in params.items()},
                    {k: zero_like(p) for k, p in params.items()})


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32 (a
    DTensor's sum reduced over the mesh first: a plain tensor)."""
    total = None
    for x in tensors:
        sq = torch.sum(x.float().square())
        if isinstance(sq, DTensor):
            sq = sq.full_tensor()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _local(x: DTensor, like: DTensor) -> torch.Tensor:
    """x's local tensor in ``like``'s layout."""
    return x.redistribute(like.device_mesh, like.placements).to_local()


def _replicated(x: torch.Tensor, like: DTensor) -> DTensor:
    """The whole tensor ``x`` (equal on every rank) as a DTensor in
    ``like``'s layout: a local slice, no communication."""
    rep = (Replicate(),) * like.device_mesh.ndim
    return DTensor.from_local(x, like.device_mesh, rep).redistribute(
        like.device_mesh, like.placements)


def _adamw_leaf(cfg: AdamWConfig, g, m, v, p, clip, lr, b1c, b2c,
                decays: bool):
    """The reference's expressions for one leaf, on plain tensors: the
    new moments (float32) and the new parameter (float32)."""
    dev = p.device
    g = g.float() * clip.to(dev)
    # each product and sum rounded to float32 as there, evaluated in
    # place on owned copies
    mf = dequantize(m) if isinstance(m, QTensor) else m.clone()
    vf = dequantize(v) if isinstance(v, QTensor) else v.clone()
    mf.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    vf.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
    del g
    u = torch.div(mf, b1c.to(dev)).div_(
        torch.div(vf, b2c.to(dev)).sqrt_().add_(cfg.eps))
    if decays:
        u.add_(p.float() * cfg.weight_decay)
    return mf, vf, p.float() - u.mul_(lr.to(dev))


def _rows_local(m: QTensor, v: QTensor, p: DTensor) -> bool:
    """Whether int8 moments ``m`` and ``v`` of parameter ``p`` hold each
    rank's rows of ``p``: ``q``, ``scale`` and ``p`` in one layout that
    splits no last dim."""
    pl = tuple(p.placements)
    return p.dim() >= 1 and all(
        tuple(t.placements) == pl for q in (m, v) for t in (q.q, q.scale)) \
        and not any(isinstance(x, Shard) and x.dim % p.dim() == p.dim() - 1
                    for x in pl)


def _update_dtensor(cfg: AdamWConfig, g, m, v, p, clip, lr, b1c, b2c,
                    decays: bool):
    """One DTensor leaf: the new moments in their layouts; ``p`` written
    in place."""
    if isinstance(m, QTensor) and _rows_local(m, v, p):
        shape = tuple(p.to_local().shape)
        mf, vf, pn = _adamw_leaf(
            cfg, _local(g, p), *(QTensor(t.q.to_local(), t.scale.to_local(),
                                         shape) for t in (m, v)),
            p.to_local(), clip, lr, b1c, b2c, decays)
        p.to_local().copy_(pn.to(p.dtype))
        return [QTensor(*(DTensor.from_local(x, y.device_mesh, y.placements,
                                             shape=y.shape, stride=y.stride())
                          for x, y in ((t.q, like.q),
                                       (t.scale, like.scale))), like.shape)
                for t, like in ((quantize(mf), m), (quantize(vf), v))]
    if isinstance(m, QTensor):
        full = [QTensor(t.q.full_tensor(), t.scale.full_tensor(), t.shape)
                for t in (m, v)]
        mf, vf, pn = _adamw_leaf(cfg, g.full_tensor(), *full,
                                 p.full_tensor(), clip, lr, b1c, b2c, decays)
        new = []
        for t, like in ((quantize(mf), m), (quantize(vf), v)):
            new.append(QTensor(_replicated(t.q, like.q),
                               _replicated(t.scale, like.scale), t.shape))
        p.to_local().copy_(_replicated(pn.to(p.dtype), p).to_local())
        return new
    mf, vf, pn = _adamw_leaf(cfg, _local(g, m), m.to_local(), v.to_local(),
                             _local(p, m), clip, lr, b1c, b2c, decays)
    pn = DTensor.from_local(pn.to(p.dtype), m.device_mesh, m.placements,
                            shape=m.shape, stride=m.stride())
    p.to_local().copy_(_local(pn, p))
    return [DTensor.from_local(t, m.device_mesh, m.placements, shape=m.shape,
                               stride=m.stride()) for t in (mf, vf)]


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict, state: OptState, params: dict, *,
           decay: dict | None = None):
    """One AdamW step. Writes the new values into ``params``' tensors and
    returns ``(params, new_state, {"grad_norm", "lr"})``. ``grads`` is
    emptied as the leaves are updated. ``decay`` names the leaves that take
    weight decay (default: ``ndim >= 2``, the reference's rule)."""
    step = state.step + 1
    gnorm = global_norm(grads.values())
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                           1.0)
    lr = schedule(cfg, step)
    stepf = torch.tensor(step, dtype=torch.float32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf
    new_m, new_v = {}, {}
    for name, p in params.items():
        g = grads.pop(name)
        m, v = state.m[name], state.v[name]
        decays = decay[name] if decay is not None else p.dim() >= 2
        if isinstance(p, DTensor):
            new_m[name], new_v[name] = _update_dtensor(
                cfg, g, m, v, p, clip, lr, b1c, b2c, decays)
            continue
        mf, vf, pn = _adamw_leaf(cfg, g, m, v, p, clip, lr, b1c, b2c,
                                 decays)
        del g
        p.copy_(pn)
        del pn
        if cfg.quantized_state:
            mf, vf = quantize(mf), quantize(vf)
        new_m[name], new_v[name] = mf, vf
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step, new_m, new_v), metrics
