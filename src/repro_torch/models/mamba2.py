"""Mamba2 (SSD) block — port of ``repro.models.mamba2``: the chunked
parallel scan for training and prefill, the O(1)-state recurrence for
decode. Used by zamba2's hybrid stack.

State-space: h_t = exp(A*dt_t) h_{t-1} + dt_t * B_t x_t ;  y_t = C_t h_t + D x_t
with per-head scalar A (Mamba2 restriction), B/C shared across heads
(n_groups=1), head dim P, state dim N.

Training and prefill use the SSD chunked algorithm (``_ssd_chunked``): the
intra-chunk quadratic ("attention") term, each chunk's final state, a
recurrence over chunks (a Python loop where the reference scans), then the
inter-chunk term. Every product is a plain torch op, as the reference's
are XLA ops: no kernel runs here.

Where the reference writes a three- or four-operand ``einsum``, the port
takes explicit pairwise products in a fixed order, so that a float32 sum
follows the same order wherever it runs (``torch.einsum`` would choose its
path through ``opt_einsum`` where that package is installed). The
intra-chunk decay exp(cum_i - cum_j) is taken of the masked difference
(-inf above the diagonal): the same values as the reference's
``where(mask, exp(cum_i - cum_j), 0)``, whose unselected entries overflow
to inf within a 256-token chunk and make its gradient NaN. softplus is
``logaddexp(x, 0)`` (``jax.nn.softplus``), not ``F.softplus``'s thresholded
form.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dot, dtype_of, init_dense, rmsnorm

Params = Mapping[str, torch.Tensor]

CHUNK = 256          # the reference's SSD chunk (mamba2_forward's default)


def mamba2_dims(cfg: ModelConfig):
    """(d_inner, heads H, head dim P, state N)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def mamba2_init(gen: torch.Generator | None, cfg: ModelConfig,
                device) -> dict:
    """The reference's leaves (mamba2.py:28-45): the projections in_zx,
    in_bc, in_dt and out_proj (normal * d_in**-0.5) and conv_w (normal *
    0.2) in ``cfg.dtype``, drawn in that order on the generator's device;
    float32 a_log 0, d_skip 1, dt_bias 0 and norm_g 1. The projections are
    uninitialised where ``gen`` is None (a converter fills them). Not
    JAX's bits."""
    D = cfg.d_model
    d_inner, H, _, N = mamba2_dims(cfg)
    dt = dtype_of(cfg)
    p = init_dense(gen, {"in_zx": (D, 2 * d_inner), "in_bc": (D, 2 * N),
                         "in_dt": (D, H)}, cfg, device)
    shape = (cfg.ssm_conv, d_inner + 2 * N)
    if gen is None:
        p["conv_w"] = torch.empty(shape, dtype=dt, device=device)
    else:
        p["conv_w"] = torch.randn(shape, generator=gen, device=device,
                                  dtype=torch.float32).mul_(0.2).to(dt)
    f32 = dict(dtype=torch.float32, device=device)
    p["a_log"] = torch.zeros(H, **f32)                # A = -exp(a_log)
    p["d_skip"] = torch.ones(H, **f32)
    p["dt_bias"] = torch.zeros(H, **f32)
    p["norm_g"] = torch.ones(d_inner, **f32)
    p.update(init_dense(gen, {"out_proj": (d_inner, D)}, cfg, device))
    return p


def mamba2_init_state(cfg: ModelConfig, batch: int, device) -> dict:
    """The decode state: ``conv`` (B, ssm_conv, d_inner + 2N) in
    ``cfg.dtype``, the last conv inputs, and ``ssm`` (B, H, N, P) float32,
    zeros."""
    d_inner, H, P, N = mamba2_dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv, d_inner + 2 * N),
                                dtype=dtype_of(cfg), device=device),
            "ssm": torch.zeros((batch, H, N, P), dtype=torch.float32,
                               device=device)}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(exp(x) + 1) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def _causal_conv(conv_in: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The causal depthwise conv of (B, S, C) ``conv_in`` with the (k, C)
    taps ``w``: explicit pad + shifts, summed left to right in x's dtype
    (the reference's Python ``sum``)."""
    k, S = w.shape[0], conv_in.shape[1]
    padded = _pad_seq(conv_in, k - 1, 0)
    conv = padded[:, 0:S] * w[0]
    for i in range(1, k):
        conv = conv + padded[:, i:i + S] * w[i]
    return conv


def _causal_conv_mesh(conv_in: DTensor, w: DTensor) -> DTensor:
    """``_causal_conv`` of DTensors in a ``local_map`` region, so that no
    sharding rule of pad or of the shifted products is asked (torch
    2.11's redistribution planner fails on the pad's): the batch and the
    channels keep their placements and the sequence is whole on every
    rank; the taps are split with the channels, and their gradient is a
    partial sum over the mesh dims that split the batch. The output is
    laid out as the input."""
    last = conv_in.dim() - 1
    xp = [p if isinstance(p, Shard) and p.dim in (0, last) else Replicate()
          for p in conv_in.placements]
    wp = [Shard(1) if isinstance(p, Shard) and p.dim == last
          else Replicate() for p in xp]
    w_grad = [Partial() if isinstance(p, Shard) and p.dim == 0 else q
              for p, q in zip(xp, wp)]
    return local_map(_causal_conv, out_placements=xp,
                     in_placements=(xp, wp), in_grad_placements=(xp, w_grad),
                     device_mesh=conv_in.device_mesh,
                     redistribute_inputs=True)(conv_in, w)


def _pad_seq(t: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """(B, S, ...) ``t`` zero-padded on its sequence dim. A DTensor is
    padded in a ``local_map`` region, its sequence whole on every rank and
    its other dims' splits kept (torch 2.11's planner fails on pad's
    rule)."""
    def pad(x):
        return torch.nn.functional.pad(
            x, (0, 0) * (x.dim() - 2) + (before, after))
    if not isinstance(t, DTensor):
        return pad(t)
    pl = [p if isinstance(p, Shard) and p.dim != 1 else Replicate()
          for p in t.placements]
    return local_map(pad, out_placements=pl, in_placements=(pl,),
                     in_grad_placements=(pl,), device_mesh=t.device_mesh,
                     redistribute_inputs=True)(t)


def _readout(c: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The decode step's y = C h: (B, N) ``c`` and (B, H, N, P) ``h`` ->
    (B, H, P), one matrix product a (batch, head)."""
    return torch.matmul(c[:, None, None, :], h)[:, :, 0]


def _readout_mesh(c: DTensor, h: DTensor) -> DTensor:
    """``_readout`` of DTensors in a ``local_map`` region: both with their
    batch split as it is and every other dim whole (the heads gathered),
    the output laid out so. A sharding rule would flatten the batch and
    head dims of a head-split h, which torch 2.11 refuses."""
    def batch_only(t):
        return [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in t.placements]
    hp = batch_only(h)
    return local_map(_readout, out_placements=hp,
                     in_placements=(batch_only(c), hp),
                     device_mesh=h.device_mesh,
                     redistribute_inputs=True)(c, h)


def _ssd_chunked(x, dt_, A, B, C, chunk: int):
    """SSD chunked scan (reference mamba2.py:48-95).
    x: (b, s, h, p); dt_: (b, s, h) float32 > 0; A: (h,) < 0; B, C:
    (b, s, n); s a multiple of ``chunk``. Returns (y (b, s, h, p) in x's
    dtype, the final state (b, h, n, p) float32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt_.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()

    da = dtc * A                                      # (b,nc,l,h) log-decay
    cum = torch.cumsum(da, dim=2)                     # within-chunk cumsum
    cum_h = cum.permute(0, 1, 3, 2)                   # (b,nc,h,l)
    # intra-chunk ("attention") term: L[i,j] = exp(cum_i - cum_j) for i>=j,
    # laid out (b,nc,h,i,j); the masked difference is -inf, so exp gives
    # the reference's 0 there and a finite gradient
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    diff = cum_h[..., :, None] - cum_h[..., None, :]
    Lmat = torch.exp(torch.where(mask, diff, float("-inf")))
    del diff
    CB = torch.matmul(Cc, Bc.transpose(-1, -2))       # (b,nc,i,j)
    # sum_j (CB[i,j] L[i,j,h]) (dt[j,h] x[j,h,p])
    W = CB[:, :, None] * Lmat                         # (b,nc,h,i,j)
    xdt = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)      # (b,nc,h,j,p)
    y_intra = torch.matmul(W, xdt)                    # (b,nc,h,i,p)
    del W, Lmat

    # chunk-final states: S_c = sum_j exp(cum_L - cum_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)        # (b,nc,l,h)
    xw = xc * (decay_to_end * dtc)[..., None]                # (b,nc,l,h,p)
    states = torch.matmul(Bc.transpose(-1, -2),
                          xw.reshape(b, nc, chunk, h * p))   # (b,nc,n,h*p)
    states = states.reshape(b, nc, n, h, p).permute(0, 1, 3, 2, 4)
    chunk_decay = torch.exp(torch.sum(da, dim=2))            # (b,nc,h)

    # the reference's lax.scan over chunks: h_in[c] is the state entering
    # chunk c
    h_prev = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h_prev)
        h_prev = h_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                          # (b,nc,h,n,p)

    # inter-chunk contribution: y_i += C_i exp(cum_i) h_in
    y_inter = torch.matmul(Cc[:, :, None], h_in) * torch.exp(cum_h)[..., None]
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
    return y.to(x.dtype), h_prev


def _ssd_mesh(x: DTensor, dt_: DTensor, A: DTensor, B: DTensor,
              C: DTensor, chunk: int):
    """``_ssd_chunked`` of DTensors in a ``local_map`` region: each rank
    scans its batch rows and its heads (every head's scan is its own; B
    and C are shared by the heads), the sequence whole. A mesh dim splits
    the heads where x or dt splits them, the batch where x does. y is
    laid out as x with the heads split, the final state (b, h, n, p) so;
    A's gradient is a partial sum over the batch's mesh dims, B's and C's
    over the heads'. The sharding rules of the scan's batched products
    would flatten a head-split dim with others, which torch 2.11
    refuses."""
    def split(t, d):
        return [isinstance(p, Shard) and p.dim == d for p in t.placements]
    rows = split(x, 0)
    heads = [(a or b) and not r for a, b, r in zip(split(x, 2), split(dt_, 2),
                                                    rows)]

    def place(b_dim, h_dim, partial_over=None):
        out = []
        for r, h in zip(rows, heads):
            if r and b_dim is not None:
                out.append(Shard(b_dim))
            elif h and h_dim is not None:
                out.append(Shard(h_dim))
            elif partial_over == "rows" and r or partial_over == "heads" \
                    and h:
                out.append(Partial())
            else:
                out.append(Replicate())
        return out

    xp, dtp, ap, bcp = place(0, 2), place(0, 2), place(None, 0), \
        place(0, None)
    return local_map(
        lambda *t: _ssd_chunked(*t, chunk),
        out_placements=(place(0, 2), place(0, 1)),
        in_placements=(xp, dtp, ap, bcp, bcp),
        in_grad_placements=(xp, dtp, place(None, 0, "rows"),
                            place(0, None, "heads"), place(0, None, "heads")),
        device_mesh=x.device_mesh, redistribute_inputs=True)(
            x, dt_, A, B, C)


def mamba2_forward(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                   chunk: int = CHUNK, state: dict | None = None,
                   return_state: bool = False):
    """x: (B, S, D) (reference mamba2.py:98-166). ``state`` None: the
    chunked parallel path (training; prefill with ``return_state``, which
    also gives the decode state after the prompt). ``state`` a dict: one
    decode step (S == 1), the O(1) update. Returns (y (B, S, D), state or
    None).

    A training sequence that is no multiple of the chunk is zero-padded
    for the scan, as in the reference. A prefill longer than the chunk
    must be a multiple of it, since the padded tail would decay the final
    state: the reference asserts, the port raises a ``ValueError`` before
    any work."""
    B, S, _ = x.shape
    d_inner, H, P, N = mamba2_dims(cfg)
    k = cfg.ssm_conv
    if state is None:
        chunk = min(chunk, S)
        pad = (-S) % chunk
        if return_state and pad:
            raise ValueError(f"a prefill of {S} tokens: its length must be "
                             f"at most the SSD chunk {chunk} or a multiple "
                             f"of it")
    zx = dot(x, p["in_zx"])
    z, xin = zx[..., :d_inner], zx[..., d_inner:]
    bc = dot(x, p["in_bc"])
    dt_ = dot(x, p["in_dt"])
    conv_in = torch.cat([xin, bc], dim=-1)                # (B,S,din+2N)
    w = p["conv_w"].to(x.dtype)
    A = -torch.exp(p["a_log"])

    if state is None:
        conv = (_causal_conv_mesh(conv_in, w) if isinstance(conv_in, DTensor)
                else _causal_conv(conv_in, w))
        conv = silu(conv.float()).to(x.dtype)
        xin, Bc, Cc = (conv[..., :d_inner], conv[..., d_inner:d_inner + N],
                       conv[..., d_inner + N:])
        dts = softplus(dt_.float() + p["dt_bias"])
        if pad:
            xin, Bc, Cc, dts = (_pad_seq(t, 0, pad)
                                for t in (xin, Bc, Cc, dts))
        xh = xin.reshape(B, S + pad, H, P)
        y, h_final = (_ssd_mesh if isinstance(xh, DTensor)
                      else _ssd_chunked)(xh, dts, A, Bc, Cc, chunk)
        y = y[:, :S] + xh[:, :S] * p["d_skip"][:, None].to(x.dtype)
        y = y.reshape(B, S, d_inner)
        y = rmsnorm(y * silu(z.float()).to(x.dtype), p["norm_g"],
                    cfg.norm_eps)
        out = dot(y, p["out_proj"])
        if not return_state:
            return out, None
        # the decode state after the prompt: the final SSM state and the
        # last k conv inputs (zero-padded on the left when S < k)
        tail = conv_in[:, -k:] if S >= k else _pad_seq(conv_in, k - S, 0)
        return out, {"conv": tail, "ssm": h_final}

    # --- decode: S == 1, O(1) state update ---
    conv_buf = torch.cat([state["conv"][:, 1:], conv_in], dim=1)
    conv = torch.sum(conv_buf * w[None], dim=1, keepdim=True)
    conv = silu(conv.float()).to(x.dtype)
    xin, Bc, Cc = (conv[..., :d_inner], conv[..., d_inner:d_inner + N],
                   conv[..., d_inner + N:])
    dt1 = softplus(dt_.float() + p["dt_bias"])[:, 0]              # (B,H)
    xh = xin.reshape(B, H, P).float()
    dec = torch.exp(dt1 * A)                                       # (B,H)
    # h' = h dec + dt B x^T, as (dt x) then the outer product with B
    inject = Bc[:, 0].float()[:, None, :, None] * (dt1[..., None]
                                                   * xh)[:, :, None, :]
    h_new = state["ssm"] * dec[..., None, None] + inject          # (B,H,N,P)
    c = Cc[:, 0].float()
    y = (_readout_mesh(c, h_new) if isinstance(h_new, DTensor)
         else _readout(c, h_new))
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = rmsnorm(y * silu(z.float()).to(x.dtype), p["norm_g"], cfg.norm_eps)
    return dot(y, p["out_proj"]), {"conv": conv_buf, "ssm": h_new}
