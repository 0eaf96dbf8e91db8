"""Binding of K5, the flash-attention forward CUDA kernel in
``csrc/flash_attention.cu``.

* ``flash_fwd`` is the wrapper: it checks device, dtype, shapes and strides,
  allocates ``out`` (in ``q``'s memory layout) and ``lse`` with
  ``torch.empty`` and launches the kernel on the current stream. On CPU
  tensors it runs ``flash_fwd_plain`` instead; on CUDA tensors it launches
  the kernel or raises.
* ``flash_fwd_plain`` is the plain PyTorch version of the same function.
* ``LAUNCHES`` counts the wrapper's launches; ``REPLACES`` names the
  Pallas kernel.

Layout is the reference's: q (B, H, Sq, D), k and v (B, Hkv, Skv, D), any
strides with a contiguous head-dim axis (a ``(B, S, H, D)`` tensor seen
through ``transpose(1, 2)`` is taken as it is).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cubuild

NAME = "flash_attention_fwd"
REPLACES = "src/repro/kernels/flash_attention.py:29"
HEAD_DIMS = (32, 64, 80, 128)
MAX_BATCH_HEADS = 65535          # gridDim.y: one block row per (b, h)
NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)
LAUNCHES = {NAME: 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = cubuild.PTR, cubuild.I32, cubuild.I64
SIGNATURES = {NAME: [_I] + [_P] * 5 + [_I] * 6 + [_L] * 12
              + [cubuild.F32, _I, _I, _I, _I, _P]}
LIBRARY = cubuild.CudaLibrary("flash_attention", SIGNATURES)


def reset_launches() -> None:
    LAUNCHES[NAME] = 0


def mask(sq: int, skv: int, *, causal: bool, window: int | None,
         kv_len: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query attends."""
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(skv, device=device)[None, :]
    m = ki < kv_len
    if causal:
        m = m & (ki <= qi)
    if window is not None:
        m = m & (ki > qi - window)
    return torch.broadcast_to(m, (sq, skv))


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float, causal: bool = True,
                    window: int | None = None, kv_len: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch: float32 logits from
    ``q * sm_scale``, the kernel's mask, float32 probabilities through the
    P.V product, ``out`` in q's dtype and ``lse`` (B, H, Sq) float32."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kv_len = skv if kv_len is None else kv_len
    g = h // hkv
    qg = (q.float() * sm_scale).reshape(b, hkv, g, sq, d)
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float())
    ok = mask(sq, skv, causal=causal, window=window, kv_len=kv_len,
              device=q.device)
    s = torch.where(ok, s, NEG_BIG)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    lm = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    acc = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    out = (acc / lm).to(q.dtype).reshape(b, h, sq, d)
    lse = (m + torch.log(lm)).reshape(b, h, sq)
    return out, lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_len: int, window: int | None) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-d tensor (B, H, S, D)")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch or head dim")
    if k.shape[1] < 1 or h % k.shape[1]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[1]} kv heads")
    if not 0 <= kv_len <= k.shape[2]:
        raise ValueError(f"kv_len {kv_len} outside [0, {k.shape[2]}]")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              sm_scale: float, causal: bool = True,
              window: int | None = None, kv_len: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 (replaces ``_flash_kernel``): (out (B, H, Sq, D) in q's dtype,
    lse (B, H, Sq) float32)."""
    kv_len = k.shape[2] if kv_len is None else kv_len
    _check(q, k, v, kv_len, window)
    if not cubuild.on_card(q):
        return flash_fwd_plain(q, k, v, sm_scale=sm_scale, causal=causal,
                               window=window, kv_len=kv_len)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} not supported; float32 or bfloat16")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; one of {HEAD_DIMS}")
    if b * h > MAX_BATCH_HEADS:
        raise ValueError(f"B*H = {b * h} > {MAX_BATCH_HEADS}")
    if max(sq, skv) >= 2 ** 31:
        raise ValueError("sequence longer than 2**31 - 1")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head-dim axis must be contiguous")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b and h and sq:
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        LIBRARY.call(NAME, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, hkv,
                     sq, skv, d, *strides, float(sm_scale), int(causal),
                     0 if window is None else int(window), int(kv_len),
                     *cubuild.stream(q.device))
        LAUNCHES[NAME] += 1
    return out, lse
