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
* K3 and K4 (``kinds``, ``grid``) also take the (P, N) feasibility mask
  ``valid`` (or None) and write -inf where it is False, and the number
  ``c`` of real criteria, which is all they sum; K1 and K2 sum all
  ``C_PAD`` and leave the fill to their caller (``fill_invalid``).
* a launch count (``LAUNCHES[name]``), raised by one where the wrapper
  launches its kernel and nowhere else.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``
(``kernels/cubuild.py``). Nothing is built or imported from CUDA when this
module is imported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cubuild

C_PAD = 8
MAX_PODS = 65535          # gridDim.y limit: one block row per pod
_EPS = 1e-12

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
    "topsis_single": [_PTR] * 6 + [_I32, _I32, _PTR],
    "topsis_batched": [_PTR] * 6 + [_I32, _I32, _I32, _PTR],
    "topsis_kinds": [_PTR, _I32] + [_PTR] * 7 + [_I32] * 4 + [_PTR],
    "topsis_grid": [_PTR] * 7 + [_I32] * 5 + [_PTR],
}
LIBRARY = cubuild.CudaLibrary("topsis", SIGNATURES)
SOURCE = LIBRARY.source
# csrc/topsis_math_check.cu: K3's and K4's branch-free square root and
# division (csrc/topsis_math.cuh) against IEEE sqrtf and '/' on the card.
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


def single_plain(x, inv_norm, w, a_pos, a_neg) -> torch.Tensor:
    """K1: (N, 8), four (8,) -> (N,)."""
    return closeness_plain(x, inv_norm, w, a_pos, a_neg)


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
def single(x: torch.Tensor, inv_norm: torch.Tensor, w: torch.Tensor,
           a_pos: torch.Tensor, a_neg: torch.Tensor) -> torch.Tensor:
    """K1 (replaces ``_topsis_kernel``): (N, 8) -> (N,) closeness."""
    _check_x(x, 2)
    if not cubuild.on_card(x):
        return single_plain(x, inv_norm, w, a_pos, a_neg)
    n = x.shape[0]
    _check("x", x, (n, C_PAD), x.device)
    for nm, t in (("inv_norm", inv_norm), ("w", w), ("a_pos", a_pos),
                  ("a_neg", a_neg)):
        _check(nm, t, (C_PAD,), x.device)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if n:
        _launch("topsis_single", x.data_ptr(), inv_norm.data_ptr(),
                w.data_ptr(), a_pos.data_ptr(), a_neg.data_ptr(),
                out.data_ptr(), n, *cubuild.stream(x.device))
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
