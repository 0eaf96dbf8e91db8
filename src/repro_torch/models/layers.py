"""Neural layers of the port: norms, rope, GQA self- and cross-attention
with a decode cache, MLA, FFNs — port of ``repro.models.layers``.

Plain functions over parameter mappings (a dict of tensors or an
``nn.ParameterDict``), with the reference's ``(d_in, d_out)`` weight layout
so that ``dot`` is ``x @ w``. Weights are in ``cfg.dtype``; normalisation
and softmax run in float32; every product accumulates in float32 and is
rounded to the input dtype where the reference rounds:

* after every ``dot``;
* in ``rmsnorm`` before the gamma multiply;
* in rope after the float32 rotation;
* ``probs`` to v's dtype in ``_sdpa`` (the decode path);
* nowhere inside the flash kernel (prefill with ``attn_impl="flash"``).

Self-attention over a whole sequence (prefill, training) goes through K5
(``kernels.ops.flash_attention``) when ``cfg.attn_impl == "flash"``, and
its gradient through K6 and K7. On one device that is a model axis of 1,
so no mesh condition applies. Under a mesh, the activations are DTensors;
the port has no ambient mesh, so it reads the mesh from the input (q's
``device_mesh`` when it has a ``"model"`` dim), and the kernels run on
each rank's local heads inside a ``local_map`` region, under the
reference's condition (``_flash_shardable``); otherwise ``_sdpa`` runs,
on the same local heads where the model axis takes them and on the
DTensors where it does not. Decode uses ``_sdpa``, plain
torch as the reference's is plain XLA. The decode cache is updated in
place (``write_seq``; a cache split over its sequence dim, as
``rules.cache_spec`` lays out MLA's latents and k/v whose kv heads the
model axis does not divide, is written rank by rank). Every function
here is differentiable with ``torch.autograd``.
Neither cross-attention
(``attention(..., kv_src=...)``) nor MLA (``mla_attention``) takes K5: the
reference's call ``_sdpa`` (layers.py:225, :299).
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules

Params = Mapping[str, torch.Tensor]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over x's last axis, accumulated in float32, then cast to
    x's dtype. cuBLAS accumulates bf16 products in float32 (with reduced
    precision reductions switched off by the caller); on the CPU the
    product is taken in float32 explicitly. The meta device takes the
    card's ops: the dry run (``launch.dryrun``) counts the card's
    program there. On a mesh a row-parallel product's partial sums are
    reduced at once (``_reduced``)."""
    if x.dtype == torch.float32 or x.is_cuda or x.is_meta:
        return _reduced(torch.matmul(x, w))
    return _reduced(torch.matmul(x.float(), w.float())).to(x.dtype)


def _reduced(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's partial sums reduced to a replica, as GSPMD all-reduces
    after a row-parallel product; otherwise as it is. Left partial, the
    sum would carry through the residual stream, and DTensor may then
    gather the next product's weight whole instead of reducing."""
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        t = t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    return t


class _DotF32(torch.autograd.Function):
    """(N, K) @ (K, M) of bf16 card tensors, accumulated and returned in
    float32 (cuBLAS through ``torch.mm``'s ``out_dtype``). The backward
    takes the float32 cotangent through float32 products and rounds each
    gradient to its input's dtype, as JAX transposes a ``dot_general``
    with ``preferred_element_type=float32``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g, w.float().T).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(x.float().T, g).to(w.dtype)
        return dx, dw


def _dot_f32_mesh(x: DTensor, w: DTensor) -> DTensor:
    """``_DotF32`` of (N, K) and (K, M) DTensors in a ``local_map``
    region (DTensor has no rule for ``mm`` with ``out_dtype``): K whole on
    every rank, each rank the product of its rows and columns; a mesh dim
    that splits x's rows or w's columns leaves the other operand's
    gradient a partial sum over it."""
    mesh = x.device_mesh
    xp, wp = [], []
    for px, pw in zip(x.placements, w.placements):
        rows = isinstance(px, Shard) and px.dim == 0
        cols = isinstance(pw, Shard) and pw.dim == 1 and not rows
        xp.append(Shard(0) if rows else Replicate())
        wp.append(Shard(1) if cols else Replicate())
    out = [a if isinstance(a, Shard) else Shard(1) if isinstance(b, Shard)
           else Replicate() for a, b in zip(xp, wp)]
    x_grad = [Partial() if isinstance(b, Shard) else a
              for a, b in zip(xp, wp)]
    w_grad = [Partial() if isinstance(a, Shard) else b
              for a, b in zip(xp, wp)]
    return local_map(_DotF32.apply, out_placements=out,
                     in_placements=(xp, wp),
                     in_grad_placements=(x_grad, w_grad), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in float32 (the unembedding);
    on the meta device as on the card (``dot``)."""
    if x.dtype == torch.bfloat16 and (x.is_cuda or x.is_meta):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        out = (_dot_f32_mesh(x2, w) if isinstance(x2, DTensor)
               else _DotF32.apply(x2, w))
        return out.reshape(*lead, w.shape[-1])
    return torch.matmul(x.float(), w.float())


# --- init helpers ------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    """(d_in, d_out) normal * d_in**-0.5 in ``dtype``, drawn on the
    generator's device. Not JAX's bits: weights are carried across by
    ``convert.lm_params_from_numpy`` where parity matters."""
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(d_in ** -0.5).to(dtype)


def attn_shapes(cfg: ModelConfig, d_kv_in: int | None = None) -> dict:
    """d_kv_in: the source width of k and v (cross-attention); default
    d_model (the reference's ``attn_init``)."""
    D, hd = cfg.d_model, cfg.hd
    d_kv_in = d_kv_in or D
    return {"wq": (D, cfg.n_heads * hd), "wk": (d_kv_in, cfg.n_kv_heads * hd),
            "wv": (d_kv_in, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, D)}


def ffn_shapes(cfg: ModelConfig) -> dict:
    return {"w1": (cfg.d_model, cfg.d_ff), "w3": (cfg.d_model, cfg.d_ff),
            "w2": (cfg.d_ff, cfg.d_model)}


def init_dense(gen: torch.Generator | None, shapes: dict, cfg: ModelConfig,
               device) -> dict:
    """Weights of the given (d_in, d_out) shapes, drawn in order with
    ``dense_init``; uninitialised when ``gen`` is None (a converter fills
    them)."""
    dt = dtype_of(cfg)
    if gen is None:
        return {k: torch.empty(s, dtype=dt, device=device)
                for k, s in shapes.items()}
    return {k: dense_init(gen, *s, dt) for k, s in shapes.items()}


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return init_dense(gen, attn_shapes(cfg), cfg, gen.device)


def frozen(tensors: dict) -> nn.ParameterDict:
    """Inference weights: parameters that take no gradient."""
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


# --- RMSNorm ------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """The model's RMSNorm (reference layers.py:45): normalised in float32,
    rounded to x's dtype, then scaled by gamma in x's dtype. Not K8, whose
    gamma multiply is in float32 before the rounding."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * gamma.to(x.dtype)


# --- RoPE ---------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integers."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs         # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                           # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- Attention (GQA, optional window) -------------------------------------------
# materialising (S, T) logits beyond this many query rows switches to the
# exact q-chunked path (bounds live memory to (B, H, CHUNK, T)).
_Q_CHUNK = 4096
# under autograd the chunks are this many rows, any S, and each chunk's
# logits and probabilities are recomputed in the backward
# (``torch.utils.checkpoint``): one chunk's (B, H, CHUNK, T) float32
# tensors held at a time, not every row's (deepseek-v3-671b's 128 MLA
# heads at 4,095 tokens: 8.6 GB a tensor a sequence whole, about five of
# them live in its backward)
_Q_GRAD_CHUNK = 512


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
          window: int | None, q_pos: torch.Tensor | None = None,
          kv_len: int | None = None) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, T, Hkv, D) -> (B, S, H, D), the grouped
    einsum form: q is seen as (B, S, Hkv, G, D), so query head h reads kv
    head h // G, as K5 does.

    q_pos: (S,) absolute query positions (decode: the cache length);
    kv_len: number of valid kv entries (decode with a preallocated cache).

    DTensors on a mesh with a ``"model"`` dim run on each rank's local
    heads (``_on_local_heads``) where the model axis takes the heads, as
    the reference's GSPMD keeps them split; otherwise on the DTensors.
    """
    if model_mesh(q) is not None:
        out = _on_local_heads(
            lambda ql, kl, vl: _sdpa(ql, kl, vl, causal=causal,
                                     window=window, q_pos=q_pos,
                                     kv_len=kv_len), q, k, v, head_dim=2)
        if out is not None:
            return out
    b, s, h, d = q.shape
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    chunk = _Q_GRAD_CHUNK if grad else _Q_CHUNK
    if s > chunk and (grad or s % chunk == 0):
        if q_pos is None:
            q_pos = torch.arange(s, device=q.device)

        def rows(qc, pc):
            return _sdpa(qc, k, v, causal=causal, window=window, q_pos=pc,
                         kv_len=kv_len)
        run = ((lambda qc, pc: checkpoint(rows, qc, pc, use_reentrant=False))
               if grad else rows)
        return torch.cat([run(q[:, i:i + chunk], q_pos[i:i + chunk])
                          for i in range(0, s, chunk)], dim=1)
    t, hkv = k.shape[1], k.shape[2]
    # the reference's GQA rule: the grouped form, unless a model axis
    # that does not divide the kv heads would lose its head sharding in
    # training / prefill; then k and v are repeated to every query head
    mesh = model_mesh(q)
    m = rules.model_axis_size(mesh) if mesh is not None else 1
    if not (s == 1 or hkv % m == 0 or hkv == h):
        k = torch.repeat_interleave(k, h // hkv, dim=2)
        v = torch.repeat_interleave(v, h // hkv, dim=2)
        hkv = h
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) * (d ** -0.5)
    qi = (q_pos if q_pos is not None
          else torch.arange(s, device=q.device))[:, None]
    ki = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    if kv_len is not None:
        mask &= ki < kv_len
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


def model_mesh(x: torch.Tensor):
    """The ``DeviceMesh`` of ``x`` when x is a DTensor on a mesh with a
    ``"model"`` dim, else None (the port's stand-in for the reference's
    ambient mesh)."""
    if isinstance(x, DTensor) and "model" in (x.device_mesh.mesh_dim_names
                                              or ()):
        return x.device_mesh
    return None


def _heads_shardable(h: int, hkv: int, m: int) -> bool:
    """Whether a model axis of m ranks can take h query heads (each rank
    runs its local heads): m divides h, and the kv heads either divide
    too or, replicated, map to a contiguous, rank-constant set for each
    rank's query heads."""
    if h % m:
        return False
    h_loc = h // m
    if hkv % m == 0:
        return True
    g = h // hkv
    return g % h_loc == 0 or h_loc % g == 0


def _flash_shardable(cfg: ModelConfig, mesh) -> bool:
    """The flash path under a mesh needs a model axis that divides the
    query heads (each rank runs the kernels on its local heads); with no
    mesh it always runs."""
    return mesh is None or _heads_shardable(
        cfg.n_heads, cfg.n_kv_heads, rules.model_axis_size(mesh))


class _DenseGrad(torch.autograd.Function):
    """The identity, its gradient made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _on_local_heads(attend, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, *, head_dim: int):
    """``attend(q, k, v)`` on each rank's local heads, in a ``local_map``
    region (the reference's ``shard_map``, layers.py:107-150): q with its
    batch over the data axes and its heads (dim ``head_dim`` of the 4-d
    layout) over ``model``; k and v with their heads over ``model`` when
    it divides them, else whole, each rank slicing the kv heads its query
    heads attend to (and their gradients partial sums over ``model``).
    None when the model axis cannot take the heads."""
    mesh = model_mesh(q)
    m = rules.model_axis_size(mesh)
    b, h, hkv = q.shape[0], q.shape[head_dim], k.shape[head_dim]
    if not _heads_shardable(h, hkv, m):
        return None
    ba = rules.batch_axes(mesh)
    if not ba or b % math.prod(rules.sizes(mesh)[a] for a in ba):
        ba = None
    h_loc = h // m
    kv_sharded = hkv % m == 0

    def place(heads):
        spec = [ba, None, None, None]
        spec[head_dim] = heads
        return rules.placements(rules.Spec(*spec), mesh)

    q_place = place("model")
    kv_place = place("model" if kv_sharded else None)
    kv_grad = tuple(Partial() if not kv_sharded and n == "model" else p
                    for n, p in zip(mesh.mesh_dim_names, kv_place))

    def local(ql, kl, vl):
        # the gradients leave the region contiguous: DTensor takes a
        # reshape's backward as a view of each rank's local gradient
        ql, kl, vl = (_DenseGrad.apply(t) for t in (ql, kl, vl))
        if not kv_sharded and hkv != h:
            # slice the kv heads this rank's q heads attend to
            r = mesh.get_local_rank("model")
            g = h // hkv
            n_kv_loc = max(h_loc // g, 1)
            start = (r * h_loc) // g
            kl = kl.narrow(head_dim, start, n_kv_loc)
            vl = vl.narrow(head_dim, start, n_kv_loc)
        return attend(ql, kl, vl)

    return local_map(local, out_placements=list(q_place),
                     in_placements=(q_place, kv_place, kv_place),
                     in_grad_placements=(q_place, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, window: int | None) -> torch.Tensor:
    """(B, S, H, D) attention through K5 (and, under autograd, K6 and K7);
    the kernels read the (B, H, S, D) views in place and write their
    outputs in their inputs' layouts. DTensors on a mesh with a
    ``"model"`` dim run on each rank's local heads
    (``_on_local_heads``)."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def attend(ql, kl, vl):
        return kops.flash_attention(ql, kl, vl, causal=causal,
                                    window=window)

    if model_mesh(q) is None:
        return attend(qt, kt, vt).transpose(1, 2)
    return _on_local_heads(attend, qt, kt, vt, head_dim=1).transpose(1, 2)


def _split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd). A DTensor whose last dim is split
    over more ranks than divide n is first gathered on those mesh dims:
    DTensor cannot split a head."""
    if isinstance(t, DTensor):
        last = t.dim() - 1
        pl = list(t.placements)
        split = [i for i, p in enumerate(pl)
                 if isinstance(p, Shard) and p.dim == last]
        if n % math.prod(t.device_mesh.shape[i] for i in split):
            for i in split:
                pl[i] = Replicate()
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(*t.shape[:-1], n, hd)


def write_seq(cache: torch.Tensor, idx: int, new: torch.Tensor) -> None:
    """``cache[:, idx:idx + S] = new`` in place, the reference's
    ``dynamic_update_slice_in_dim`` on axis 1 (S = ``new.shape[1]``; the
    caller checks the bounds). A DTensor cache split over that axis is
    written in a ``local_map`` region: each rank writes the part of
    ``[idx, idx + S)`` that falls in its own shard, from the matching rows
    of ``new`` (whole over the axes that split the cache's). DTensor's
    own slice of a split dim gathers a copy, and the assignment would
    land in it and be lost. Any other cache takes the slice assignment."""
    split = isinstance(cache, DTensor) and any(
        isinstance(p, Shard) and p.dim == 1 for p in cache.placements)
    if not split:
        cache[:, idx:idx + new.shape[1]] = new
        return
    mesh, place = cache.device_mesh, list(cache.placements)
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    shape, off = compute_local_shape_and_global_offset(cache.shape, mesh,
                                                       place)
    lo, hi = off[1], off[1] + shape[1]
    a, b = max(idx, lo), min(idx + new.shape[1], hi)

    def local(cl, nl):
        if a < b:
            cl[:, a - lo:b - lo] = nl[:, a - idx:b - idx]
        return cl

    new_place = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                 for p in place]
    local_map(local, out_placements=place, in_placements=(place, new_place),
              device_mesh=mesh, redistribute_inputs=True)(cache, new)


def attention(p: Params, cfg: ModelConfig, x: torch.Tensor, *, kv_src=None,
              positions: torch.Tensor | None = None, causal: bool = True,
              cache: dict | None = None, use_rope: bool = True):
    """Self- or cross-attention. x: (B, S, D). Returns (out, cache').

    cache: None (no cache) or {k, v, len} with preallocated (B, T, Hkv, hd)
    buffers; k/v of this call are written at ``len`` in place and the cache
    comes back with ``len + S``.
    kv_src: (B, T, Dsrc) for cross-attention: k and v from it, no rope on
    either side, no cache, every key attended (``_sdpa``, never K5, as the
    reference's ``use_flash`` demands ``kv_src is None``).
    """
    B, S, _ = x.shape
    hd = cfg.hd
    if kv_src is not None:
        if cache is not None:
            raise ValueError("cross-attention takes no cache")
        T = kv_src.shape[1]
        q = _split_heads(dot(x, p["wq"]), cfg.n_heads, hd)
        k = _split_heads(dot(kv_src, p["wk"]), cfg.n_kv_heads, hd)
        v = _split_heads(dot(kv_src, p["wv"]), cfg.n_kv_heads, hd)
        out = _sdpa(q, k, v, causal=False, window=cfg.attn_window)
        return dot(out.reshape(B, S, cfg.n_heads * hd), p["wo"]), None
    q = _split_heads(dot(x, p["wq"]), cfg.n_heads, hd)
    k = _split_heads(dot(x, p["wk"]), cfg.n_kv_heads, hd)
    v = _split_heads(dot(x, p["wv"]), cfg.n_kv_heads, hd)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    use_flash = (cfg.attn_impl == "flash" and S > 1
                 and _flash_shardable(cfg, model_mesh(q)))
    if cache is not None:
        idx = int(cache["len"])
        ck, cv = cache["k"], cache["v"]
        if idx + S > ck.shape[1]:
            raise ValueError(f"cache of length {ck.shape[1]} cannot take "
                             f"{S} more entries at position {idx}")
        write_seq(ck, idx, k)
        write_seq(cv, idx, v)
        if use_flash:
            # prefill starts from an empty cache (idx == 0), so attention
            # over the in-flight k/v equals attention over the cache
            out = _flash_sdpa(q, k, v, causal=True, window=cfg.attn_window)
        else:
            out = _sdpa(q, ck, cv, causal=True, window=cfg.attn_window,
                        q_pos=positions, kv_len=idx + S)
        new_cache = {"k": ck, "v": cv, "len": idx + S}
        return dot(out.reshape(B, S, cfg.n_heads * hd), p["wo"]), new_cache
    if use_flash:
        out = _flash_sdpa(q, k, v, causal=causal, window=cfg.attn_window)
    else:
        out = _sdpa(q, k, v, causal=causal, window=cfg.attn_window)
    return dot(out.reshape(B, S, cfg.n_heads * hd), p["wo"]), None


# --- MLA (deepseek multi-head latent attention) -----------------------------
def mla_shapes(cfg: ModelConfig) -> dict:
    D, H, R = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {"wdq": (D, cfg.q_lora_rank), "wuq": (cfg.q_lora_rank,
                                                 H * (dn + dr)),
            "wdkv": (D, R), "wkr": (D, dr), "wuk": (R, H * dn),
            "wuv": (R, H * dv), "wo": (H * dv, D)}


def _einsum_f32(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of the operands in float32 (exact for bf16), the
    result float32: the reference's ``preferred_element_type`` einsums."""
    return torch.einsum(eq, *(x.float() for x in xs))


def _mla_absorbed(q_nope, q_rope, wuk, wuv, ckv, ckr, *,
                  positions: torch.Tensor, kv_len: int, scale: float):
    """MLA's absorbed form over the cached latents: q taken into the
    latent space through wuk (R, H, dn), scored against ckv (B, T, R) and
    ckr (B, T, dr) (the first ``kv_len`` positions, causal at
    ``positions``), the weighted latents taken out through wuv (R, H, dv):
    (B, S, H, dv) in q's dtype. DTensors on a mesh with a ``"model"``
    dim that divides the heads run on each rank's local heads in a
    ``local_map`` region, the latents whole on every rank (as ``_sdpa``
    takes k and v the axis cannot split)."""
    dtype = q_nope.dtype

    def core(qn, qr, uk, uv, kv, kr):
        q_c = _einsum_f32("bshd,rhd->bshr", qn, uk).to(dtype)
        logits = (_einsum_f32("bshr,btr->bhst", q_c, kv)
                  + _einsum_f32("bshd,btd->bhst", qr, kr)) * scale
        ki = torch.arange(kv.shape[1], device=kv.device)[None, None, None, :]
        qi = positions[None, None, :, None]
        logits = torch.where((ki < kv_len) & (ki <= qi), logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(dtype)
        del logits
        o_c = _einsum_f32("bhst,btr->bshr", probs, kv).to(dtype)
        return _einsum_f32("bshr,rhd->bshd", o_c, uv).to(dtype)

    mesh = model_mesh(q_nope)
    if mesh is None or q_nope.shape[2] % rules.model_axis_size(mesh):
        return core(q_nope, q_rope, wuk, wuv, ckv, ckr)
    ba = rules.batch_axes(mesh)
    if not ba or q_nope.shape[0] % math.prod(rules.sizes(mesh)[a]
                                             for a in ba):
        ba = None
    q_place = rules.placements(rules.Spec(ba, None, "model", None), mesh)
    w_place = rules.placements(rules.Spec(None, "model", None), mesh)
    c_place = rules.placements(rules.Spec(ba, None, None), mesh)
    return local_map(core, out_placements=list(q_place),
                     in_placements=(q_place, q_place, w_place, w_place,
                                    c_place, c_place),
                     device_mesh=mesh, redistribute_inputs=True)(
        q_nope, q_rope, wuk, wuv, ckv, ckr)


def mla_attention(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                  positions: torch.Tensor | None = None,
                  cache: dict | None = None):
    """Multi-head latent attention (reference layers.py:251-325). x:
    (B, S, D). Returns (out, cache').

    Without a cache (training) the full form: nope and rope concatenated
    into one head dim of dn + dr, through ``_sdpa`` (never K5, as in the
    reference), v's head dim dv. With a cache {kv_c (B, T, R), k_rope
    (B, T, dr), len} (prefill and decode) the absorbed form: q is taken
    into the latent space through wuk and scored against the cached
    kv_c and k_rope, which this call's are written into in place at
    ``len``; the output comes back through wuv.
    """
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    R = cfg.kv_lora_rank
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = dot(dot(x, p["wdq"]), p["wuq"]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv_c = dot(x, p["wdkv"])                                  # (B, S, R)
    k_rope = apply_rope(dot(x, p["wkr"])[:, :, None, :], positions,
                        cfg.rope_theta)                       # (B, S, 1, dr)
    scale = (dn + dr) ** -0.5

    if cache is None:
        k_nope = dot(kv_c, p["wuk"]).reshape(B, S, H, dn)
        v = dot(kv_c, p["wuv"]).reshape(B, S, H, dv)
        # q'.k' = nope.nope + rope.rope, and _sdpa's scale (dn+dr)^-0.5
        # is ``scale``
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope.to(k_nope.dtype).expand(
            B, S, H, dr)], dim=-1)
        out = _sdpa(q_full, k_full, v, causal=True, window=None)
        return dot(out.reshape(B, S, H * dv), p["wo"]), None

    idx = int(cache["len"])
    ckv, ckr = cache["kv_c"], cache["k_rope"]
    if idx + S > ckv.shape[1]:
        raise ValueError(f"cache of length {ckv.shape[1]} cannot take "
                         f"{S} more entries at position {idx}")
    write_seq(ckv, idx, kv_c)
    write_seq(ckr, idx, k_rope[:, :, 0, :])
    out = _mla_absorbed(q_nope, q_rope, p["wuk"].reshape(R, H, dn),
                        p["wuv"].reshape(R, H, dv), ckv, ckr,
                        positions=positions, kv_len=idx + S, scale=scale)
    new_cache = {"kv_c": ckv, "k_rope": ckr, "len": idx + S}
    return dot(out.reshape(B, S, H * dv), p["wo"]), new_cache


# --- FFN (swiglu / geglu) -------------------------------------------------------
def ffn(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    gate = dot(x, p["w1"])
    if cfg.ffn_kind == "geglu":
        act = F.gelu(gate.float(), approximate="tanh").to(x.dtype)
    else:
        act = gate * torch.sigmoid(gate)      # jax.nn.silu: x * sigmoid(x)
    return dot(act * dot(x, p["w3"]), p["w2"])

