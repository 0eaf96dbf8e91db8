"""Error-feedback int8 gradient compression for the data-parallel
all-reduce — port of ``repro.optim.compress``.

Each data shard quantizes its local gradient to int8 (blockwise absmax,
256 values a block), all-reduces the int8 payload (as int32 accumulators
to avoid overflow), and keeps the quantization residual locally, adding it
back into the next step's gradient (error feedback — Karimireddy et al.,
2019). The arithmetic is the reference's, in float32: the codes are
all-reduced as int32, the scales (summed in rank order) and the shard
count as float32, and
``g_hat = psum(q) * (sum(scale) / n) / n``, ``err' = (g + err) - local
dequant``. The int32 accumulators move as many bytes as a float32
gradient; what shrinks is only what a later int8 wire format would send.

Where the reference runs inside ``shard_map`` over an axis name, these
functions take the group to reduce over: a ``ProcessGroup``, or a
``(DeviceMesh, dim name)`` pair such as ``(mesh, "data")``. The reference
does this in XLA, not in a Pallas kernel, so here it is plain torch.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

BLOCK = 256
# elements a single all-reduce call carries (1 GiB of int32); a longer
# payload goes in consecutive pieces, the same elementwise sums
CHUNK = 1 << 28


def process_group(group):
    """The ``ProcessGroup`` of ``group``: a ProcessGroup, or a
    ``(DeviceMesh, dim name)`` pair."""
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    return group


def _quantize(x: torch.Tensor):
    """(q (n_blocks, BLOCK) int8, scale (n_blocks,) float32, the local
    dequantization in x's shape) of float32 ``x``: absmax / 127 a block,
    round half to even, clip to +-127."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp_min(scale[:, None],
                                                         1e-20)),
                    -127, 127).to(torch.int8)
    deq = q.float() * scale[:, None]
    return q, scale, deq.reshape(-1)[:x.numel()].reshape(x.shape)


def tree_compressed_psum(grads: dict, errs: dict, group, *,
                         stacks: dict | None = None,
                         stats: dict | None = None):
    """``({name: g_hat}, {name: err'})`` of ``compressed_psum`` over every
    leaf of ``grads`` (with the matching leaf of ``errs``). The leaves'
    int32 codes go in one all-reduce, their scales in another and the
    count in a third; sums are elementwise, so this equals one reduction a
    leaf. ``stacks`` (``LM.reference_leaves()``: names in stack order,
    by the reference's leaf) quantizes the leaves stacked into one of the
    reference's as that one leaf, whose 256-value blocks run across the
    stacked blocks where one block's leaf is not a multiple of 256 (a norm
    gamma); without it, each leaf alone. ``stats``, where given, gets
    ``payload_bytes`` (what the three all-reduces carry) and
    ``dense_bytes`` (the float32 gradients they stand for)."""
    pg = process_group(group)
    groups = (list(stacks.values()) if stacks is not None
              else [[n] for n in grads])
    if sorted(n for g in groups for n in g) != sorted(grads):
        raise KeyError("stacks do not name the gradients' leaves")
    names = [tuple(g) for g in groups]
    quant, new_err = {}, {}
    for n in names:
        x = torch.cat([(grads[k].float() + errs[k]).reshape(-1) for k in n])
        q, scale, deq_local = _quantize(x)
        e = x - deq_local
        del x, deq_local
        at = 0
        for k in n:
            new_err[k] = e[at:at + grads[k].numel()].reshape(grads[k].shape)
            at += grads[k].numel()
        quant[n] = (q, scale)
    scales = torch.cat([quant[n][1] for n in names])
    q32 = torch.empty(sum(quant[n][0].numel() for n in names),
                      dtype=torch.int32, device=scales.device)
    at = 0
    for n in names:
        q = quant.pop(n)[0].reshape(-1)
        q32[at:at + q.numel()] = q
        at += q.numel()
    dev = scales.device
    count = torch.ones((), dtype=torch.float32, device=dev)
    world, rank = dist.get_world_size(pg), dist.get_rank(pg)
    # the scales are summed in rank order, as XLA's psum sums them, so
    # that every rank's sum is the reference's bit for bit: each rank's
    # scales go in its own row of a zero (world, n) buffer, the all-reduce
    # adds only zeros to them, and the rows are summed in order
    rows = torch.zeros((world, scales.numel()), dtype=torch.float32,
                       device=dev)
    rows[rank] = scales
    for buf in (q32, rows.view(-1), count.view(-1)):
        for at in range(0, buf.numel(), CHUNK):
            dist.all_reduce(buf[at:at + CHUNK], group=pg)
    if stats is not None:
        stats["payload_bytes"] = q32.numel() * 4 + rows.numel() * 4 + 4
        stats["dense_bytes"] = sum(g.numel() * 4 for g in grads.values())
    ssum = rows[0]
    for r in range(1, world):
        ssum = ssum + rows[r]
    mean_scale = ssum / count
    g_hat = {}
    qo = so = 0
    for n in names:
        nb = -(-sum(grads[k].numel() for k in n) // BLOCK)
        flat = (q32[qo:qo + nb * BLOCK].reshape(nb, BLOCK).float()
                * mean_scale[so:so + nb, None]).reshape(-1)
        qo, so = qo + nb * BLOCK, so + nb
        at = 0
        for k in n:
            g = grads[k]
            g_hat[k] = (flat[at:at + g.numel()].reshape(g.shape)
                        / count).to(g.dtype)
            at += g.numel()
    return g_hat, new_err


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group):
    """(mean-reduced g_hat, new local error) of one gradient over
    ``group``: g_hat = dequant(psum(quant(g + err))) / n ; err' = (g + err)
    - local dequant."""
    g_hat, new_err = tree_compressed_psum({"g": g}, {"g": err}, group)
    return g_hat["g"], new_err["g"]


def init_error(params: dict) -> dict:
    """float32 zeros in every parameter's shape, on its device."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
