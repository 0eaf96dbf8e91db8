"""Binding of K8, the fused RMSNorm CUDA kernel in ``csrc/rmsnorm.cu``.

* ``rmsnorm`` is the wrapper: (R, D) rows in float32 or bfloat16 and a
  (D,) float32 gamma; it checks them, allocates the output with
  ``torch.empty`` and launches the kernel on the current stream. On CPU
  tensors it runs ``rmsnorm_plain`` instead; on CUDA tensors it launches the
  kernel or raises. Rows whose width is a multiple of 16 bytes take the
  kernel's register path, which reads x and gamma in 16-byte pieces: their
  data must then be 16-byte aligned (the wrapper raises otherwise).
* ``rmsnorm_plain`` is the plain PyTorch version (``ref.rmsnorm_ref``).
* ``LAUNCHES`` counts the wrapper's launches; ``REPLACES`` names the
  Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cubuild
from repro_torch.kernels.ref import rmsnorm_ref

NAME = "rmsnorm_fwd"
REPLACES = "src/repro/kernels/rmsnorm_pallas.py:19"
LAUNCHES = {NAME: 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ALIGN = 16                       # bytes of one vector load
_P, _I = cubuild.PTR, cubuild.I32
SIGNATURES = {NAME: [_I, _P, _P, _P, _I, _I, cubuild.F32, _I, _P]}
LIBRARY = cubuild.CudaLibrary("rmsnorm", SIGNATURES)


def reset_launches() -> None:
    LAUNCHES[NAME] = 0


rmsnorm_plain = rmsnorm_ref


def _check_aligned(x: torch.Tensor, gamma: torch.Tensor) -> None:
    """Raise unless x's and gamma's data are 16-byte aligned, where rows of
    x are a multiple of 16 bytes wide (the kernel's register path)."""
    if x.shape[-1] * x.element_size() % ALIGN:
        return
    for name, t in (("x", x), ("gamma", gamma)):
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name}'s data is not {ALIGN}-byte aligned")


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """K8 (replaces ``_rmsnorm_kernel``): (R, D) -> (R, D) in x's dtype."""
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("x must be a 2-d (rows, D) tensor")
    r, d = x.shape
    if not isinstance(gamma, torch.Tensor) or tuple(gamma.shape) != (d,):
        raise ValueError(f"gamma must be a ({d},) tensor")
    if not cubuild.on_card(x):
        return rmsnorm_plain(x, gamma, eps)
    if x.dtype not in _DTYPES:
        raise TypeError(f"dtype {x.dtype} not supported; float32 or bfloat16")
    if gamma.dtype != torch.float32 or gamma.device != x.device:
        raise TypeError(f"gamma must be float32 on {x.device}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("x and gamma must be contiguous")
    if r >= 2 ** 31:
        raise ValueError("at most 2**31 - 1 rows")
    _check_aligned(x, gamma)
    y = torch.empty_like(x)
    if r and d:
        LIBRARY.call(NAME, _DTYPES[x.dtype], x.data_ptr(), gamma.data_ptr(),
                     y.data_ptr(), r, d, float(eps),
                     *cubuild.stream(x.device))
        LAUNCHES[NAME] += 1
    return y
