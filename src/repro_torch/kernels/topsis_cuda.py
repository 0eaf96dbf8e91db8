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
    "topsis_kinds": [_PTR, _I32] + [_PTR] * 6 + [_I32, _I32, _I32, _PTR],
    "topsis_grid": [_PTR] * 6 + [_I32, _I32, _I32, _I32, _PTR],
}
LIBRARY = cubuild.CudaLibrary("topsis", SIGNATURES)
SOURCE = LIBRARY.source


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> cubuild.CudaLibrary:
    """Compile ``csrc/topsis.cu`` (once per source version) and load it."""
    return LIBRARY.load()


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


def _check_x(x: torch.Tensor, ndim: int) -> None:
    if not isinstance(x, torch.Tensor) or x.dim() != ndim \
            or x.shape[-1] != C_PAD:
        raise ValueError(f"criteria tensor must be {ndim}-d with last axis "
                         f"{C_PAD}, got "
                         f"{tuple(getattr(x, 'shape', ()))}")
    if x.shape[-2] >= 2 ** 31:
        raise ValueError(f"at most 2**31 - 1 nodes, got {x.shape[-2]}")


# --- the plain PyTorch versions ---------------------------------------------------
def closeness_plain(x: torch.Tensor, inv_norm: torch.Tensor, w: torch.Tensor,
                    a_pos: torch.Tensor, a_neg: torch.Tensor) -> torch.Tensor:
    """(..., N, 8) rows, (..., 8) small operands -> (..., N): the closeness
    arithmetic of every kernel, in the kernel's operation order."""
    u = x * inv_norm[..., None, :]
    v = u * w[..., None, :]
    dp = v - a_pos[..., None, :]
    dn = v - a_neg[..., None, :]
    d_pos = torch.sqrt(torch.sum(dp * dp, dim=-1))
    d_neg = torch.sqrt(torch.sum(dn * dn, dim=-1))
    denom = d_pos + d_neg
    cc = d_neg / torch.clamp_min(denom, _EPS)
    return torch.where(denom <= _EPS, 0.5, cc)


def single_plain(x, inv_norm, w, a_pos, a_neg) -> torch.Tensor:
    """K1: (N, 8), four (8,) -> (N,)."""
    return closeness_plain(x, inv_norm, w, a_pos, a_neg)


def batched_plain(x, inv_norm, w, a_pos, a_neg) -> torch.Tensor:
    """K2: (P, N, 8), four (P, 8) -> (P, N)."""
    return closeness_plain(x, inv_norm, w, a_pos, a_neg)


def kinds_plain(kind_idx, x, inv_norm, w, a_pos, a_neg) -> torch.Tensor:
    """K3: kind_idx (P,), (K, N, 8), four (P, 8) -> (P, N)."""
    return closeness_plain(x[kind_idx.long()], inv_norm, w, a_pos, a_neg)


def grid_plain(x, inv_norm, w, a_pos, a_neg) -> torch.Tensor:
    """K4: (P, N, 8), inv_norm (P, 8), w/a_pos/a_neg (S, P, 8) -> (S, P, N)."""
    return closeness_plain(x[None], inv_norm[None], w, a_pos, a_neg)


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
          w: torch.Tensor, a_pos: torch.Tensor,
          a_neg: torch.Tensor) -> torch.Tensor:
    """K3 (replaces ``_topsis_kinds_kernel``): kind_idx (P,) int32 into a
    (K, N, 8) per-kind tensor -> (P, N). A kind outside [0, K) gives NaN
    over that pod's row."""
    _check_x(x, 3)
    if not cubuild.on_card(x):
        return kinds_plain(kind_idx, x, inv_norm, w, a_pos, a_neg)
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
    out = torch.empty((p, n), dtype=torch.float32, device=x.device)
    if p and n:
        _launch("topsis_kinds", kind_idx.data_ptr(), k, x.data_ptr(),
                inv_norm.data_ptr(), w.data_ptr(), a_pos.data_ptr(),
                a_neg.data_ptr(), out.data_ptr(), n, p, *cubuild.stream(x.device))
    return out


def grid(x: torch.Tensor, inv_norm: torch.Tensor, w: torch.Tensor,
         a_pos: torch.Tensor, a_neg: torch.Tensor) -> torch.Tensor:
    """K4 (replaces ``_topsis_grid_kernel``): (P, N, 8) under S schemes ->
    (S, P, N); inv_norm (P, 8), w/a_pos/a_neg (S, P, 8)."""
    _check_x(x, 3)
    if not cubuild.on_card(x):
        return grid_plain(x, inv_norm, w, a_pos, a_neg)
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
    out = torch.empty((s, p, n), dtype=torch.float32, device=x.device)
    if s and p and n:
        _launch("topsis_grid", x.data_ptr(), inv_norm.data_ptr(),
                w.data_ptr(), a_pos.data_ptr(), a_neg.data_ptr(),
                out.data_ptr(), n, p, s, *cubuild.stream(x.device))
    return out
