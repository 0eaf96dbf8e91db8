"""Public wrappers around the port's CUDA kernels — port of
``repro.kernels.ops``: padding, layout, and the global reductions the
kernels consume. The TOPSIS wrappers (K1-K4) come first; RMSNorm (K8) and
flash attention (K5 forward, K6 and K7 backward) follow them.

K1's wrapper pads the criteria axis to ``C_PAD = 8`` and launches the
kernel, which computes what XLA computed outside the Pallas call — weight
normalisation, column norms, the masked ideal points — and the -inf
itself. K2-K4's wrappers compute those reductions in plain torch, pad and
launch the kernel (``repro_torch.kernels.topsis_cuda``); ``-inf`` goes over
invalid rows, written by K3 and K4 themselves and after K2 by
``fill_invalid``.
On CUDA tensors that is the hand-written kernel; on CPU tensors the
kernel's plain PyTorch version (the path the CPU tests take). Inputs may be
numpy arrays or tensors; ``device=None`` keeps a tensor input where it is
and sends numpy input to the card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.core import topsis as _topsis
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_cuda as _fc
from repro_torch.kernels import rmsnorm_cuda as _rc
from repro_torch.kernels import topsis_cuda as _tc

C_PAD = _tc.C_PAD
_EPS = 1e-12


def _device_for(x, device) -> torch.device:
    if device is not None or not isinstance(x, torch.Tensor):
        return resolve_device(device)
    return x.device


def as_f32(x, device: torch.device) -> torch.Tensor:
    """float32 tensor on ``device`` from a tensor or an array (a read-only
    array, such as a broadcast view, is copied first)."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.astype(np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def as_mask(x, device: torch.device) -> torch.Tensor | None:
    """bool tensor on ``device`` (None stays None)."""
    if x is None:
        return None
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x, dtype=torch.bool, device=device)


def _pad_c(x: torch.Tensor) -> torch.Tensor:
    """(..., c) -> contiguous (..., C_PAD), zero-filled."""
    c = x.shape[-1]
    if c > C_PAD:
        raise ValueError(f"at most {C_PAD} criteria, got {c}")
    if c == C_PAD:
        return x.contiguous()
    return F.pad(x, (0, C_PAD - c))


def _criteria(mats, c: int, device: torch.device) -> torch.Tensor:
    """float32 criteria tensor with ``c`` real columns, either already
    padded to C_PAD (the scheduler's resident mirror: used in place) or
    with exactly ``c`` columns."""
    m = as_f32(mats, device)
    if m.shape[-1] not in (c, C_PAD):
        raise ValueError(f"criteria tensor has {m.shape[-1]} columns; "
                         f"expected {c} (the benefit mask) or {C_PAD}")
    return m


def _norm_weights(weights, shape: tuple, device) -> torch.Tensor:
    w = as_f32(weights, device)
    w = torch.broadcast_to(w, shape)
    return w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), _EPS)


def _inv_norm(m: torch.Tensor) -> torch.Tensor:
    """(..., N, c) -> (..., c) reciprocal column norms."""
    norms = torch.sqrt(torch.sum(m * m, dim=-2))
    return 1.0 / torch.clamp_min(norms, _EPS)


fill_invalid = _tc.fill_invalid


# Each ``*_operands`` function prepares one kernel's arguments — for K2-K4
# the global reductions — and the C_PAD padding. K1's, K3's and K4's
# return the kernel's arguments, the mask and the number of real criteria
# among them, and the kernel writes the -inf itself; K2's return them with
# the validity mask, and its public wrapper writes -inf over invalid rows
# after the kernel. chip_smoke.py feeds the same operands to a kernel and
# to its plain version.
def single_operands(matrix, weights, benefit, *, valid=None, device=None):
    """K1's arguments for an (N, C) matrix: ``(x, weights, benefit, valid,
    c)`` with ``x`` the (N, C_PAD) float32 criteria on the device (an
    already padded contiguous tensor — a row of the scheduler's resident
    mirror — is used in place), the raw (C,) weights and the benefit mask
    as host arrays (the kernel takes them by value), ``valid`` the (N,)
    mask or None and ``c = C``."""
    dev = _device_for(matrix, device)
    benefit = np.asarray(benefit, dtype=bool)
    c = len(benefit)
    x = _pad_c(_criteria(matrix, c, dev))
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    return x, np.asarray(weights, dtype=np.float32), benefit, \
        as_mask(valid, dev), c


def topsis_closeness(matrix, weights, benefit, *, valid=None,
                     device=None) -> torch.Tensor:
    """(N,) closeness for an (N, C) decision matrix; C <= 8 (both the
    paper's 5-criteria matrix and the carbon-extended 6-criteria one fit
    the kernel's C_PAD = 8 padding). ``valid`` is an optional (N,)
    feasibility mask: invalid rows are excluded from the ideal points and
    returned as -inf — identical semantics to
    ``repro_torch.core.topsis.closeness``. One launch of K1, which does the
    reductions and the fill itself."""
    return _tc.single(*single_operands(matrix, weights, benefit, valid=valid,
                                       device=device))


def batched_operands(mats, weights, benefit, *, valid=None, device=None):
    """K2 operands for a (P, N, C) queue tensor."""
    dev = _device_for(mats, device)
    benefit = np.asarray(benefit, dtype=bool)
    c = len(benefit)
    m = _criteria(mats, c, dev)
    p = m.shape[0]
    valid = as_mask(valid, dev)
    w = _norm_weights(weights, (p, c), dev)
    inv_norm = _inv_norm(m[..., :c])                              # (P, C)
    v = m[..., :c] * inv_norm[:, None, :] * w[:, None, :]
    a_pos, a_neg = _topsis.masked_ideal_points(v, benefit, valid)  # (P, C)
    return tuple(map(_pad_c, (m, inv_norm, w, a_pos, a_neg))), valid


def topsis_closeness_batched(mats, weights, benefit, *, valid=None,
                             device=None) -> torch.Tensor:
    """(P, N) closeness for a (P, N, C) queue tensor; C <= 8. Per-pod
    column norms and ideal points are global reductions in torch; the
    kernel streams the (node blocks x pods) grid. ``weights`` is (C,)
    shared or (P, C) per pod; ``valid`` an optional (P, N) feasibility
    mask (excluded from ideals, -inf in the result). K2."""
    args, valid = batched_operands(mats, weights, benefit, valid=valid,
                                   device=device)
    return fill_invalid(_tc.batched(*args), valid)


def grid_operands(mats, weights, benefit, *, valid=None, device=None):
    """K4 operands for a (P, N, C) queue tensor under (S, C) weights:
    ``(x, inv_norm, w, a_pos, a_neg, valid, c)`` with ``valid`` the (P, N)
    mask every scheme shares (or None).

    The ideal points come without the (S, P, N, C) weighted tensor: for a
    fixed weight, rounding ``u * w`` is monotone in ``u`` (non-decreasing
    for w >= 0, non-increasing for w < 0), so the masked max and min of
    ``v = u * w`` over a pod's nodes are ``w`` times the masked max or min
    of ``u = x * inv_norm`` — the same floats as reducing v itself. A pod
    with no valid node gets ``masked_ideal_points``' +-inf."""
    dev = _device_for(mats, device)
    benefit = np.asarray(benefit, dtype=bool)
    c = len(benefit)
    m = _criteria(mats, c, dev)
    p = m.shape[0]
    ws = as_f32(weights, dev)
    if ws.dim() != 2 or ws.shape[-1] != c:
        raise ValueError(f"weights must be (S, {c}), got {tuple(ws.shape)}")
    s = ws.shape[0]
    ws = ws / torch.clamp_min(torch.sum(ws, dim=-1, keepdim=True), _EPS)
    valid = as_mask(valid, dev)
    inv_norm = _inv_norm(m[..., :c])                              # (P, C)
    u = m[..., :c] * inv_norm[:, None, :]                         # (P, N, C)
    if valid is None:
        u_hi, u_lo = torch.amax(u, dim=1), torch.amin(u, dim=1)
    else:
        keep = valid[..., None]
        u_hi = torch.amax(torch.where(keep, u, -torch.inf), dim=1)
        u_lo = torch.amin(torch.where(keep, u, torch.inf), dim=1)
    w3 = ws[:, None, :]                                           # (S, 1, C)
    up = w3 >= 0
    v_hi = torch.where(up, w3 * u_hi, w3 * u_lo)                  # (S, P, C)
    v_lo = torch.where(up, w3 * u_lo, w3 * u_hi)
    ben = torch.as_tensor(benefit, device=dev)
    a_pos = torch.where(ben, v_hi, v_lo)
    a_neg = torch.where(ben, v_lo, v_hi)
    if valid is not None:
        inf = torch.tensor(torch.inf, device=dev)
        some = torch.any(valid, dim=1)[:, None]                   # (P, 1)
        a_pos = torch.where(some, a_pos, torch.where(ben, -inf, inf))
        a_neg = torch.where(some, a_neg, torch.where(ben, inf, -inf))
    wsp = torch.broadcast_to(w3, (s, p, c))
    return tuple(map(_pad_c, (m, inv_norm, wsp, a_pos, a_neg))) + (valid, c)


def topsis_closeness_grid(mats, weights, benefit, *, valid=None,
                          device=None) -> torch.Tensor:
    """(S, P, N) closeness for a (P, N, C) queue tensor under an (S, C)
    weight-scheme grid; C <= 8. Column norms are scheme-independent and
    computed once per pod, and so are the masked column extremes the
    per-(scheme, pod) ideal points are read from; the kernel reads each
    criteria row once and scores it under all S schemes. ``valid`` is the
    usual (P, N) feasibility mask, shared by every scheme. K4."""
    return _tc.grid(*grid_operands(mats, weights, benefit, valid=valid,
                                   device=device))


def kinds_operands(mats_kinds, kind_idx, weights, benefit, *, valid=None,
                   device=None):
    """K3 operands: ``(kind_idx, x, inv_norm, w, a_pos, a_neg, valid, c)``
    with ``kind_idx`` int32 on the device, ``x`` the (K, N, C_PAD) kind
    tensor (an already padded contiguous one is used in place) and
    ``valid`` the (P, N) mask or None."""
    dev = _device_for(mats_kinds, device)
    benefit = np.asarray(benefit, dtype=bool)
    c = len(benefit)
    m = _criteria(mats_kinds, c, dev)
    k = m.shape[0]
    kidx_np = np.asarray(kind_idx.cpu() if isinstance(kind_idx, torch.Tensor)
                         else kind_idx)
    if kidx_np.size and (kidx_np.min() < 0 or kidx_np.max() >= k):
        raise IndexError(f"kind_idx out of range for {k} kinds")
    kidx = torch.as_tensor(kidx_np.astype(np.int32), device=dev)
    p = kidx.shape[0]
    valid = as_mask(valid, dev)
    w = _norm_weights(weights, (p, c), dev)
    inv_norm = _inv_norm(m[..., :c])[kidx.long()]                 # (P, C)
    v = m[..., :c][kidx.long()] * inv_norm[:, None, :] * w[:, None, :]
    a_pos, a_neg = _topsis.masked_ideal_points(v, benefit, valid)  # (P, C)
    return (kidx,) + tuple(map(_pad_c, (m, inv_norm, w, a_pos, a_neg))) \
        + (valid, c)


def topsis_closeness_kinds(mats_kinds, kind_idx, weights, benefit, *,
                           valid=None, device=None) -> torch.Tensor:
    """(P, N) closeness from a deduplicated (K, N, C) kind tensor plus a
    (P,) pod->kind index; C <= 8. The incremental batch path: the fleet
    criteria cache keeps one matrix per workload *kind*, so the kernel
    streams K criteria tensors instead of P near-duplicate pod copies.
    ``mats_kinds`` may already be padded to (K, N, C_PAD) — the
    scheduler's resident device mirror is, and is then read in place.

    Per-pod column norms are gathered from per-kind norms — bitwise equal
    to the per-pod reduction because each pod's rows ARE its kind's rows.
    Ideal points stay per pod (``valid`` differs pod to pod); ``weights``
    is (C,) shared or (P, C) per pod; invalid -> -inf. K3."""
    return _tc.kinds(*kinds_operands(mats_kinds, kind_idx, weights, benefit,
                                     valid=valid, device=device))


# --- RMSNorm ----------------------------------------------------------------
def _as_tensor(x, device: torch.device) -> torch.Tensor:
    """A tensor (its dtype kept) or an array (float32 stays float32) on
    ``device``."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x, device=device)


def rmsnorm(x, gamma, eps: float = 1e-6, *, device=None) -> torch.Tensor:
    """Fused RMSNorm over the last axis of x (any leading shape) through K8:
    ``x * rsqrt(mean(x^2) + eps) * gamma`` in float32, in x's dtype. On the
    card the kernel takes any width, so nothing is padded."""
    dev = _device_for(x, device)
    x = _as_tensor(x, dev)
    gamma = as_f32(gamma, dev).contiguous()
    d = x.shape[-1]
    out = _rc.rmsnorm(x.reshape(-1, d).contiguous(), gamma, eps)
    return out.reshape(x.shape)


# --- Flash attention ----------------------------------------------------------
class FlashAttention(torch.autograd.Function):
    """K5 forward, K6 and K7 backward: the counterpart of the reference's
    ``_flash_core`` custom_vjp (ops.py:262-288). The forward saves q, k, v,
    out and lse; the backward computes dd = rowsum(do * out) and runs K6
    (dq) and K7 (dk, dv). The bindings are looked up at call time, so a
    caller may route them (chip_smoke.py does, to run the plain versions).
    On CPU tensors both directions take the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float, causal: bool,
                window: int | None):
        out, lse = _fc.flash_fwd(q, k, v, sm_scale=sm_scale, causal=causal,
                                 window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(sm_scale=sm_scale, causal=causal, window=window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fc.flash_bwd(q, k, v, out, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None


def padded_head_dim(d: int) -> int:
    """The smallest head dim the flash kernels take that holds ``d``: D
    in (128, 256] pads to 256, as the reference pads to the next multiple
    of 128 lanes. Above 256, where the reference would pad to 384, it
    raises: no dense registry architecture has such a head dim."""
    for dp in _fc.HEAD_DIMS:
        if dp >= d:
            return dp
    raise ValueError(f"head dim {d} > {_fc.HEAD_DIMS[-1]} is not supported "
                     f"by the flash kernels")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, sm_scale: float | None = None,
                    device=None) -> torch.Tensor:
    """(B, H, S, D) GQA flash attention through K5, differentiable through
    K6 and K7 (``FlashAttention``); k and v are (B, Hkv, S, D).
    ``sm_scale`` defaults to 1/sqrt(D). Returns ``out`` in q's dtype. The
    kernels mask their own ragged edges, so S is not padded; a head dim
    the kernels do not take (any D <= 256, as the reference pads D to a
    multiple of 128 lanes) is zero-padded to the next one they do, on
    every device, and
    ``out`` (and through autograd dq, dk, dv) sliced back to D: zero
    columns change neither q.k nor the kept columns of p.v. Otherwise
    ``out`` has q's memory layout."""
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("flash_attention takes local tensors; a DTensor "
                        "reaches it only through a local_map region "
                        "(models.layers._flash_sdpa)")
    dev = _device_for(q, device)
    q, k, v = (_as_tensor(t, dev) for t in (q, k, v))
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    dp = padded_head_dim(d)
    if dp != d:
        q, k, v = (F.pad(t, (0, dp - d)) for t in (q, k, v))
    out = FlashAttention.apply(q, k, v, float(sm_scale), bool(causal),
                               window)
    return out if dp == d else out[..., :d]
