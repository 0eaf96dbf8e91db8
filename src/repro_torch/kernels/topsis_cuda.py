"""Bindings for the TOPSIS CUDA kernels in ``csrc/topsis.cu``.

Each of the four kernels has here:

* a wrapper (``single``, ``batched``, ``kinds``, ``grid``) that takes the
  kernel's own layout — criteria row-major ``(..., N, C_PAD)`` float32,
  small operands ``(..., C_PAD)`` float32 — checks device, dtype, shape and
  contiguity, allocates the output with ``torch.empty`` and launches the
  kernel on the current stream;
* a plain PyTorch version (``*_plain``) of the same function. A wrapper
  runs it only when its tensors lie on the CPU; for CUDA tensors it
  launches the kernel or raises.
* K1 (``single``) takes an (N, C_PAD) matrix with the raw weights and
  the benefit mask (host values, passed to the kernel by value), the (N,)
  mask ``valid`` (or None) and the number ``c`` of real criteria, and does
  the whole decision in one launch of one thread block cluster: the
  weight normalisation, the column norms, the masked ideal points, the
  closeness and the -inf. Its plain version (``single_plain``) is
  ``single_reductions_plain`` + ``closeness_plain`` + ``fill_invalid``.
* K3 and K4 (``kinds``, ``grid``) also take the (P, N) feasibility mask
  ``valid`` (or None) and write -inf where it is False, and the number
  ``c`` of real criteria, which is all they sum; K2 sums all ``C_PAD`` and
  leaves the fill to its caller (``fill_invalid``).
* a launch count (``LAUNCHES[name]``), raised by one where the wrapper
  launches its kernel and nowhere else.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``
(``kernels/cubuild.py``). Nothing is built or imported from CUDA when this
module is imported.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import cubuild

C_PAD = 8
MAX_PODS = 65535          # gridDim.y limit: one block row per pod
_EPS = 1e-12
# K1's cluster (csrc/topsis.cu: K1_CLUSTER, K1_THREADS, QUAD): SINGLE_CLUSTER
# CTAs of SINGLE_THREADS threads, 4 nodes a thread.
SINGLE_THREADS = 512
SINGLE_CLUSTER = 16
_QUAD = 4


def single_resident_rows() -> int:
    """The largest N whose rows K1's cluster holds in registers between
    its two passes; above it each CTA reads its rows again in the scoring
    pass."""
    return SINGLE_CLUSTER * SINGLE_THREADS * _QUAD


class SingleWeights(ctypes.Structure):
    """K1's by-value weights (``struct SingleWeights`` of csrc/topsis.cu):
    the raw weights of the real criteria, and bit j of ``benefit`` set
    when criterion j is a benefit."""
    _fields_ = [("w", ctypes.c_float * C_PAD), ("benefit", ctypes.c_uint)]


# The Pallas kernel each CUDA kernel replaces (file:line of its body).
REPLACES = {
    "topsis_single": "src/repro/kernels/topsis_pallas.py:30",
    "topsis_batched": "src/repro/kernels/topsis_pallas.py:72",
    "topsis_kinds": "src/repro/kernels/topsis_pallas.py:172",
    "topsis_grid": "src/repro/kernels/topsis_pallas.py:115",
}
LAUNCHES: dict[str, int] = {name: 0 for name in REPLACES}

_PTR, _I32 = cubuild.PTR, cubuild.I32
SIGNATURES = {
    "topsis_single": [_PTR] * 3 + [_I32, SingleWeights] + [_I32] * 2
    + [_PTR],
    # K1's launch floor: the empty kernel in K1's cluster shape (timed by
    # chip_smoke.py, never launched by the port)
    "topsis_cluster_floor": [_I32, _PTR],
    "topsis_batched": [_PTR] * 6 + [_I32, _I32, _I32, _PTR],
    "topsis_kinds": [_PTR, _I32] + [_PTR] * 7 + [_I32] * 4 + [_PTR],
    "topsis_grid": [_PTR] * 7 + [_I32] * 5 + [_PTR],
}
LIBRARY = cubuild.CudaLibrary("topsis", SIGNATURES)
SOURCE = LIBRARY.source
# csrc/topsis_math_check.cu: K1's, K3's and K4's branch-free square root
# and division (csrc/topsis_math.cuh) against IEEE sqrtf and '/' on the card.
MATH_CHECK = cubuild.CudaLibrary("topsis_math_check",
                                 {"topsis_math_check": [_PTR, _I32, _PTR]})


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> cubuild.CudaLibrary:
    """Compile ``csrc/topsis.cu`` (once per source version) and load it."""
    return LIBRARY.load()


def math_check(device: torch.device) -> dict[str, int]:
    """Run csrc/topsis_math_check.cu on ``device``: mismatches of
    ``sqrt_in`` against sqrtf over every float of its range and of
    ``div_in`` against '/' over 2^32 sampled quotients, with the counts
    tried. Both mismatch counts must be 0."""
    if device.type != "cuda":
        raise ValueError(f"the math check runs on the card, not {device}")
    counts = torch.zeros(4, dtype=torch.int64, device=device)
    MATH_CHECK.call("topsis_math_check", counts.data_ptr(),
                    *cubuild.stream(device))
    bad_sqrt, bad_div, n_sqrt, n_div = counts.tolist()
    return dict(sqrt_mismatches=bad_sqrt, div_mismatches=bad_div,
                sqrt_tried=n_sqrt, div_tried=n_div)


def _launch(name: str, *args) -> None:
    LIBRARY.call(name, *args)
    LAUNCHES[name] += 1


# --- argument checks ------------------------------------------------------------
def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
           dtype: torch.dtype = torch.float32) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device.type == "cuda" and t.numel() and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (float4 loads)")


def _check_c(c) -> None:
    if isinstance(c, bool) or not isinstance(c, int) or not 1 <= c <= C_PAD:
        raise ValueError(f"c (real criteria) must be an int in 1..{C_PAD}, "
                         f"got {c!r}")


def _valid_ptr(valid, shape: tuple, device: torch.device) -> int | None:
    """The mask's pointer (None for no mask: a null pointer)."""
    if valid is None:
        return None
    _check("valid", valid, shape, device, torch.bool)
    return valid.data_ptr()


def _check_x(x: torch.Tensor, ndim: int) -> None:
    if not isinstance(x, torch.Tensor) or x.dim() != ndim \
            or x.shape[-1] != C_PAD:
        raise ValueError(f"criteria tensor must be {ndim}-d with last axis "
                         f"{C_PAD}, got "
                         f"{tuple(getattr(x, 'shape', ()))}")
    if x.shape[-2] >= 2 ** 31:
        raise ValueError(f"at most 2**31 - 1 nodes, got {x.shape[-2]}")


# --- the plain PyTorch versions ---------------------------------------------------
def fill_invalid(cc: torch.Tensor, valid: torch.Tensor | None):
    """-inf over the invalid entries of a closeness tensor."""
    return cc if valid is None else torch.where(valid, cc, -torch.inf)


def closeness_plain(x: torch.Tensor, inv_norm: torch.Tensor, w: torch.Tensor,
                    a_pos: torch.Tensor, a_neg: torch.Tensor,
                    c: int = C_PAD) -> torch.Tensor:
    """(..., N, 8) rows, (..., 8) small operands -> (..., N): the closeness
    arithmetic of every kernel over the first ``c`` criteria, in the
    kernel's operation order (the squares summed one criterion at a time,
    so padded criteria, all zero, add exact zeros)."""
    u = x[..., :c] * inv_norm[..., None, :c]
    v = u * w[..., None, :c]
    dp = v - a_pos[..., None, :c]
    dn = v - a_neg[..., None, :c]
    sp, sn = dp[..., 0] * dp[..., 0], dn[..., 0] * dn[..., 0]
    for j in range(1, c):
        sp = sp + dp[..., j] * dp[..., j]
        sn = sn + dn[..., j] * dn[..., j]
    d_pos, d_neg = torch.sqrt(sp), torch.sqrt(sn)
    denom = d_pos + d_neg
    cc = d_neg / torch.clamp_min(denom, _EPS)
    return torch.where(denom <= _EPS, 0.5, cc)


def _host_weights(weights, benefit, c: int) -> tuple[np.ndarray, np.ndarray]:
    """K1's raw weights (float32) and benefit mask as (c,) host arrays."""
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    if isinstance(benefit, torch.Tensor):
        benefit = benefit.detach().cpu().numpy()
    w = np.asarray(weights, dtype=np.float32).reshape(-1)
    ben = np.asarray(benefit, dtype=bool).reshape(-1)
    if w.shape != (c,) or ben.shape != (c,):
        raise ValueError(f"K1 takes {c} weights and {c} benefit flags, got "
                         f"{w.shape[0]} and {ben.shape[0]}")
    return w, ben


def normalized_weights(weights) -> np.ndarray:
    """w / max(sum(w), 1e-12) in float32, the sum taken in order: K1's
    normalisation, bit for bit."""
    w = np.asarray(weights, dtype=np.float32)
    total = np.float32(0.0)
    for v in w:
        total = np.float32(total + v)
    return w / np.maximum(total, np.float32(_EPS))


def single_params(weights, benefit, c: int) -> SingleWeights:
    """The by-value struct K1 takes (checks that there are ``c`` of
    each)."""
    w, ben = _host_weights(weights, benefit, c)
    bits = sum(1 << int(j) for j in np.flatnonzero(ben))
    return SingleWeights((ctypes.c_float * C_PAD)(*w.tolist()), bits)


def single_reductions_plain(x, weights, benefit, valid=None, c=C_PAD):
    """K1's global reductions in plain torch on x's device — what the TPU
    design left to XLA and the kernel now computes itself: the normalised
    weights, the reciprocal column norms over all N rows and the masked
    ideal points, each (C_PAD,), zero past ``c``. The ideal points come from
    the masked column extremes of x, as in the kernel: for inv_norm >= 0
    rounding ``x * inv_norm`` is non-decreasing in x and rounding ``u * w``
    monotone in u with w's sign, so they are the floats
    ``masked_ideal_points`` gives on v = x * inv_norm * w, a zero's sign
    aside. No valid row: a+ = -inf / +inf and a- = +inf / -inf by
    ``benefit``."""
    w_np, ben_np = _host_weights(weights, benefit, c)
    dev = x.device
    xc = x[:, :c]
    w = torch.as_tensor(normalized_weights(w_np), device=dev)
    inv_norm = 1.0 / torch.clamp_min(torch.sqrt(torch.sum(xc * xc, dim=0)),
                                     _EPS)
    if valid is None:
        x_hi, x_lo = torch.amax(xc, dim=0), torch.amin(xc, dim=0)
    else:
        keep = valid[:, None]
        x_hi = torch.amax(torch.where(keep, xc, -torch.inf), dim=0)
        x_lo = torch.amin(torch.where(keep, xc, torch.inf), dim=0)
    u_hi, u_lo = x_hi * inv_norm, x_lo * inv_norm
    up = w >= 0
    v_hi = torch.where(up, u_hi * w, u_lo * w)
    v_lo = torch.where(up, u_lo * w, u_hi * w)
    ben = torch.as_tensor(ben_np, device=dev)
    a_pos = torch.where(ben, v_hi, v_lo)
    a_neg = torch.where(ben, v_lo, v_hi)
    if valid is not None:
        some = torch.any(valid)
        inf = torch.tensor(torch.inf, device=dev)
        a_pos = torch.where(some, a_pos, torch.where(ben, -inf, inf))
        a_neg = torch.where(some, a_neg, torch.where(ben, inf, -inf))
    pad = (0, C_PAD - c)
    return tuple(torch.nn.functional.pad(t, pad)
                 for t in (inv_norm, w, a_pos, a_neg))


def single_plain(x, weights, benefit, valid=None, c=C_PAD) -> torch.Tensor:
    """K1: (N, 8) rows, (c,) raw weights and benefit flags, (N,) mask or
    None -> (N,) closeness over the first ``c`` criteria, -inf where
    ``valid`` is False: ``single_reductions_plain``, ``closeness_plain``,
    ``fill_invalid``."""
    if x.shape[0] == 0:
        return x.new_empty((0,))
    operands = single_reductions_plain(x, weights, benefit, valid, c)
    return fill_invalid(closeness_plain(x, *operands, c), valid)


def batched_plain(x, inv_norm, w, a_pos, a_neg) -> torch.Tensor:
    """K2: (P, N, 8), four (P, 8) -> (P, N)."""
    return closeness_plain(x, inv_norm, w, a_pos, a_neg)


def kinds_plain(kind_idx, x, inv_norm, w, a_pos, a_neg, valid=None,
                c=C_PAD) -> torch.Tensor:
    """K3: kind_idx (P,), (K, N, 8), four (P, 8), mask (P, N) or None ->
    (P, N); NaN over a pod whose kind is outside [0, K), then -inf where
    ``valid`` is False."""
    k = x.shape[0]
    kidx = kind_idx.long()
    known = (kidx >= 0) & (kidx < k)
    rows = x[torch.where(known, kidx, 0)] if k else \
        x.new_zeros((kidx.shape[0],) + tuple(x.shape[1:]))
    cc = closeness_plain(rows, inv_norm, w, a_pos, a_neg, c)
    return fill_invalid(torch.where(known[:, None], cc, torch.nan), valid)


def grid_plain(x, inv_norm, w, a_pos, a_neg, valid=None,
               c=C_PAD) -> torch.Tensor:
    """K4: (P, N, 8), inv_norm (P, 8), w/a_pos/a_neg (S, P, 8), mask (P, N)
    or None -> (S, P, N), -inf where ``valid`` is False."""
    return fill_invalid(closeness_plain(x[None], inv_norm[None], w, a_pos,
                                        a_neg, c), valid)


# --- the wrappers -------------------------------------------------------------------
def single(x: torch.Tensor, weights, benefit,
           valid: torch.Tensor | None = None, c: int = C_PAD) -> torch.Tensor:
    """K1 (replaces ``_topsis_kernel`` and the reductions around it): an
    (N, 8) matrix whose first ``c`` criteria are real, with ``c`` raw
    weights and benefit flags (host values, or tensors read back to the
    host), -> (N,) closeness, -inf where the (N,) bool ``valid`` is False.
    One launch of one cluster of SINGLE_CLUSTER CTAs."""
    _check_x(x, 2)
    _check_c(c)
    params = single_params(weights, benefit, c)
    if not cubuild.on_card(x):
        return single_plain(x, weights, benefit, valid, c)
    n = x.shape[0]
    _check("x", x, (n, C_PAD), x.device)
    valid_ptr = _valid_ptr(valid, (n,), x.device)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if n:
        _launch("topsis_single", x.data_ptr(), valid_ptr, out.data_ptr(), n,
                params, c, *cubuild.stream(x.device))
    return out


def batched(x: torch.Tensor, inv_norm: torch.Tensor, w: torch.Tensor,
            a_pos: torch.Tensor, a_neg: torch.Tensor) -> torch.Tensor:
    """K2 (replaces ``_topsis_batched_kernel``): (P, N, 8) -> (P, N)."""
    _check_x(x, 3)
    if not cubuild.on_card(x):
        return batched_plain(x, inv_norm, w, a_pos, a_neg)
    p, n, _ = x.shape
    if p > MAX_PODS:
        raise ValueError(f"at most {MAX_PODS} pods per launch, got {p}")
    _check("x", x, (p, n, C_PAD), x.device)
    for nm, t in (("inv_norm", inv_norm), ("w", w), ("a_pos", a_pos),
                  ("a_neg", a_neg)):
        _check(nm, t, (p, C_PAD), x.device)
    out = torch.empty((p, n), dtype=torch.float32, device=x.device)
    if p and n:
        _launch("topsis_batched", x.data_ptr(), inv_norm.data_ptr(),
                w.data_ptr(), a_pos.data_ptr(), a_neg.data_ptr(),
                out.data_ptr(), n, p, *cubuild.stream(x.device))
    return out


def kinds(kind_idx: torch.Tensor, x: torch.Tensor, inv_norm: torch.Tensor,
          w: torch.Tensor, a_pos: torch.Tensor, a_neg: torch.Tensor,
          valid: torch.Tensor | None = None, c: int = C_PAD) -> torch.Tensor:
    """K3 (replaces ``_topsis_kinds_kernel``): kind_idx (P,) int32 into a
    (K, N, 8) per-kind tensor -> (P, N) over the first ``c`` criteria. A
    kind outside [0, K) gives NaN over that pod's row; -inf where the
    (P, N) bool ``valid`` is False."""
    _check_x(x, 3)
    _check_c(c)
    if not cubuild.on_card(x):
        return kinds_plain(kind_idx, x, inv_norm, w, a_pos, a_neg, valid, c)
    k, n, _ = x.shape
    if not isinstance(kind_idx, torch.Tensor) or kind_idx.dim() != 1:
        raise ValueError("kind_idx must be a 1-d tensor")
    p = kind_idx.shape[0]
    if p > MAX_PODS:
        raise ValueError(f"at most {MAX_PODS} pods per launch, got {p}")
    _check("kind_idx", kind_idx, (p,), x.device, torch.int32)
    _check("x", x, (k, n, C_PAD), x.device)
    for nm, t in (("inv_norm", inv_norm), ("w", w), ("a_pos", a_pos),
                  ("a_neg", a_neg)):
        _check(nm, t, (p, C_PAD), x.device)
    valid_ptr = _valid_ptr(valid, (p, n), x.device)
    out = torch.empty((p, n), dtype=torch.float32, device=x.device)
    if p and n:
        _launch("topsis_kinds", kind_idx.data_ptr(), k, x.data_ptr(),
                inv_norm.data_ptr(), w.data_ptr(), a_pos.data_ptr(),
                a_neg.data_ptr(), valid_ptr, out.data_ptr(), n, p, c,
                *cubuild.stream(x.device))
    return out


def grid(x: torch.Tensor, inv_norm: torch.Tensor, w: torch.Tensor,
         a_pos: torch.Tensor, a_neg: torch.Tensor,
         valid: torch.Tensor | None = None, c: int = C_PAD) -> torch.Tensor:
    """K4 (replaces ``_topsis_grid_kernel``): (P, N, 8) under S schemes ->
    (S, P, N) over the first ``c`` criteria; inv_norm (P, 8), w/a_pos/a_neg
    (S, P, 8); -inf where the (P, N) bool ``valid``, shared by every
    scheme, is False."""
    _check_x(x, 3)
    _check_c(c)
    if not cubuild.on_card(x):
        return grid_plain(x, inv_norm, w, a_pos, a_neg, valid, c)
    p, n, _ = x.shape
    if not isinstance(w, torch.Tensor) or w.dim() != 3:
        raise ValueError("w must be a 3-d (S, P, 8) tensor")
    s = w.shape[0]
    if p > MAX_PODS:
        raise ValueError(f"at most {MAX_PODS} pods per launch, got {p}")
    _check("x", x, (p, n, C_PAD), x.device)
    _check("inv_norm", inv_norm, (p, C_PAD), x.device)
    for nm, t in (("w", w), ("a_pos", a_pos), ("a_neg", a_neg)):
        _check(nm, t, (s, p, C_PAD), x.device)
    valid_ptr = _valid_ptr(valid, (p, n), x.device)
    out = torch.empty((s, p, n), dtype=torch.float32, device=x.device)
    if s and p and n:
        _launch("topsis_grid", x.data_ptr(), inv_norm.data_ptr(),
                w.data_ptr(), a_pos.data_ptr(), a_neg.data_ptr(), valid_ptr,
                out.data_ptr(), n, p, s, c, *cubuild.stream(x.device))
    return out
