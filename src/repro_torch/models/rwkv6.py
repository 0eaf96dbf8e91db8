"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix
— port of ``repro.models.rwkv6``.

Recurrence per head (state S in R^{N x N}, N = head size):
  S_t = diag(w_t) S_{t-1} + k_t^T v_t
  y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(decay_t)) data-dependent (the Finch novelty vs RWKV-5).

Training and prefill run the recurrence one token at a time in float32 (a
Python loop where the reference scans over time); decode is one step of
it. On a mesh whose model axis divides the heads the loop runs on each
rank's heads in a ``local_map`` region (``_wkv``). No kernel runs here. The reference's own simplifications are kept as
they are: one learned per-channel token-shift mix in place of the
published low-rank one; the gate reads the ``mix_v`` mix (there is no
``mix_g``); ``u_bonus`` scales the key axis n of k^T v; the RMSNorm after
the WKV runs over all of d_model, not per head; and time-mix takes
(1 - m) in float32 before the cast where channel-mix takes it in x's
dtype.
"""
from __future__ import annotations

from typing import Mapping

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dot, dtype_of, init_dense, model_mesh,
                                       rmsnorm)
from repro_torch.sharding import rules

Params = Mapping[str, torch.Tensor]

HEAD_N = 64


def rwkv_dims(cfg: ModelConfig):
    """(heads H, head size N = 64)."""
    if cfg.d_model % HEAD_N:
        raise ValueError(f"{cfg.arch_id}: d_model {cfg.d_model} is not a "
                         f"multiple of the RWKV head size {HEAD_N}")
    return cfg.d_model // HEAD_N, HEAD_N


def rwkv6_init(gen: torch.Generator | None, cfg: ModelConfig,
               device) -> dict:
    """The reference's leaves (rwkv6.py:29-53): the float32 per-channel
    mixes (0.5), ``w_bias`` (-6), ``u_bonus`` (H, N) zeros and ``ln_g``
    ones; the projections wr, wk, wv, wg, ww (scale 1e-3), wo, ck, cv, cr
    in ``cfg.dtype`` (normal * d_in**-0.5 but ww), drawn in that order on
    the generator's device, uninitialised where ``gen`` is None. Not JAX's
    bits."""
    D = cfg.d_model
    H, N = rwkv_dims(cfg)

    def full(value, shape=(D,)):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    square = init_dense(gen, {"wr": (D, D), "wk": (D, D), "wv": (D, D),
                              "wg": (D, D)}, cfg, device)
    if gen is None:
        ww = torch.empty((D, D), dtype=dtype_of(cfg), device=device)
    else:                      # the decay projection: normal * 1e-3
        ww = torch.randn((D, D), generator=gen, device=device,
                         dtype=torch.float32).mul_(1e-3).to(dtype_of(cfg))
    rest = init_dense(gen, {"wo": (D, D), "ck": (D, cfg.d_ff),
                            "cv": (cfg.d_ff, D), "cr": (D, D)}, cfg, device)
    return {"mix_r": full(0.5), "mix_k": full(0.5), "mix_v": full(0.5),
            "mix_w": full(0.5), **square, "ww": ww, "w_bias": full(-6.0),
            "u_bonus": full(0.0, (H, N)), "wo": rest["wo"],
            "ln_g": full(1.0), "cmix_k": full(0.5), "ck": rest["ck"],
            "cv": rest["cv"],
            "cr": rest["cr"]}


def rwkv6_block_state(cfg: ModelConfig, batch: int, device) -> dict:
    """A block's carried state, zeros: ``tm_prev`` and ``cm_prev`` (B, 1,
    D) in ``cfg.dtype`` (the last token each mix saw), ``wkv`` (B, H, N,
    N) float32."""
    H, N = rwkv_dims(cfg)
    dt = dtype_of(cfg)
    return {"tm_prev": torch.zeros((batch, 1, cfg.d_model), dtype=dt,
                                   device=device),
            "wkv": torch.zeros((batch, H, N, N), dtype=torch.float32,
                               device=device),
            "cm_prev": torch.zeros((batch, 1, cfg.d_model), dtype=dt,
                                   device=device)}


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1} with carry-in ``prev`` (B, 1, D)."""
    return torch.cat([prev, x[:, :-1, :]], dim=1)


def wkv_step(s_prev: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, w: torch.Tensor, u: torch.Tensor):
    """One token of the WKV recurrence (reference rwkv6.py:76-83): r, k, v
    and the decay w (B, H, N) float32, the state (B, H, N, N), ``u_bonus``
    (H, N) along the key axis n. Returns (out (B, H, N), the new
    state)."""
    kv = k[..., :, None] * v[..., None, :]                    # (B,H,N,N)
    out = torch.matmul(r[..., None, :], s_prev + u[..., None] * kv)
    return out[..., 0, :], w[..., None] * s_prev + kv


def _scan(s_prev, r, k, v, w, u):
    """``wkv_step`` over the S tokens of r, k, v, w (B, S, H, N): (y (B,
    S, H, N), the last state)."""
    ys = []
    for t in range(r.shape[1]):
        out, s_prev = wkv_step(s_prev, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(out)
    return torch.stack(ys, dim=1), s_prev


def _wkv(s_prev, r, k, v, w, u):
    """``_scan``; DTensors on a mesh whose ``"model"`` dim divides the
    heads run in a ``local_map`` region, each rank its batch rows and its
    heads (every head's recurrence is its own), u's gradient a partial sum
    over the batch's mesh dims. The sharding rule of ``wkv_step``'s
    batched product would flatten a head-split dim with the batch, which
    torch 2.11 refuses."""
    mesh = model_mesh(r)
    if mesh is None or r.shape[2] % rules.model_axis_size(mesh):
        return _scan(s_prev, r, k, v, w, u)
    ba = rules.batch_axes(mesh)
    if not ba or r.shape[0] % math.prod(rules.sizes(mesh)[a] for a in ba):
        ba = None
    if not isinstance(s_prev, DTensor):     # training's zero state
        s_prev = DTensor.from_local(s_prev, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    x_place = rules.placements(rules.Spec(ba, None, "model", None), mesh)
    s_place = rules.placements(rules.Spec(ba, "model", None, None), mesh)
    u_place = rules.placements(rules.Spec("model", None), mesh)
    split = rules.placements(rules.Spec(ba), mesh)
    u_grad = [Partial() if not isinstance(b, Replicate) else a
              for a, b in zip(u_place, split)]
    return local_map(_scan, out_placements=(x_place, s_place),
                     in_placements=(s_place,) + (x_place,) * 4 + (u_place,),
                     in_grad_placements=(s_place,) + (x_place,) * 4
                     + (u_grad,), device_mesh=mesh,
                     redistribute_inputs=True)(s_prev, r, k, v, w, u)


def time_mix(p: Params, cfg: ModelConfig, x: torch.Tensor, state: dict):
    """x: (B, S, D); state: {tm_prev (B, 1, D), wkv (B, H, N, N) float32}
    (reference rwkv6.py:62-98). Returns (out (B, S, D), {tm_prev, wkv})."""
    B, S, D = x.shape
    H, N = rwkv_dims(cfg)
    xp = _shift(x, state["tm_prev"])

    def mix(m):
        return x * m.to(x.dtype) + xp * (1 - m).to(x.dtype)

    r = dot(mix(p["mix_r"]), p["wr"]).reshape(B, S, H, N)
    k = dot(mix(p["mix_k"]), p["wk"]).reshape(B, S, H, N)
    v = dot(mix(p["mix_v"]), p["wv"]).reshape(B, S, H, N)
    g = dot(mix(p["mix_v"]), p["wg"]).float()
    g = g * torch.sigmoid(g)                                  # silu
    wdec = dot(mix(p["mix_w"]), p["ww"]).float() + p["w_bias"]
    w = torch.exp(-torch.exp(wdec)).reshape(B, S, H, N)       # (0,1) decay

    y, s_prev = _wkv(state["wkv"], r.float(), k.float(), v.float(), w,
                     p["u_bonus"])
    y = y.reshape(B, S, D)                                    # (B,S,D) f32
    y = rmsnorm(y.to(x.dtype), p["ln_g"], cfg.norm_eps)
    y = (y.float() * g).to(x.dtype)
    return dot(y, p["wo"]), {"tm_prev": x[:, -1:, :], "wkv": s_prev}


def channel_mix(p: Params, cfg: ModelConfig, x: torch.Tensor, state: dict):
    """x: (B, S, D); state: {cm_prev (B, 1, D)} (reference
    rwkv6.py:101-108). Returns (out (B, S, D), {cm_prev})."""
    xp = _shift(x, state["cm_prev"])
    m = p["cmix_k"].to(x.dtype)
    xm = x * m + xp * (1 - m)
    k = torch.relu(dot(xm, p["ck"]).float())
    k = (k * k).to(x.dtype)
    r = torch.sigmoid(dot(xm, p["cr"]).float()).to(x.dtype)
    return r * dot(k, p["cv"]), {"cm_prev": x[:, -1:, :]}
