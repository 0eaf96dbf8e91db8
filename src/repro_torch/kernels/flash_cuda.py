"""Bindings of the flash-attention CUDA kernels: K5, the forward in
``csrc/flash_attention.cu``, and K6 (dq) / K7 (dk, dv), the backward in
``csrc/flash_attention_bwd.cu``.

* ``flash_fwd`` (K5), ``flash_bwd_dq`` (K6) and ``flash_bwd_dkv`` (K7) are
  the wrappers: they check device, dtype, shapes and strides, allocate
  their outputs with ``torch.empty`` (in the memory layout of the input
  they mirror) and launch the kernel on the current stream. On CPU tensors
  they run the plain version instead; on CUDA tensors they launch the
  kernel or raise. ``flash_bwd`` computes ``dd = rowsum(do * out)`` and
  calls K6 and K7.
* ``flash_fwd_plain`` and ``flash_bwd_plain`` are the plain PyTorch
  versions of the same functions. They compute in float32 (in float64 for
  float64 inputs, which only the CPU takes) and loop over (batch, kv head)
  so that no (B, H, Sq, Skv) tensor is ever whole.
* ``LAUNCHES`` counts each wrapper's launches; ``REPLACES`` names each
  Pallas kernel; ``smem_bytes`` gives the dynamic shared memory a launch
  takes (the build reports only static shared memory).

Layout is the reference's: q and do (B, H, Sq, D), k and v (B, Hkv, Skv,
D), any strides with a contiguous head-dim axis (a ``(B, S, H, D)`` tensor
seen through ``transpose(1, 2)`` is taken as it is); lse and dd are
(B, H, Sq) float32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cubuild

NAME = "flash_attention_fwd"
DQ = "flash_attention_bwd_dq"
DKV = "flash_attention_bwd_dkv"
SMEM = "flash_attention_fwd_smem"
BWD_SMEM = "flash_attention_bwd_smem"
REPLACES = {NAME: "src/repro/kernels/flash_attention.py:29",
            DQ: "src/repro/kernels/flash_attention.py:135",
            DKV: "src/repro/kernels/flash_attention.py:167"}
HEAD_DIMS = (32, 64, 80, 128, 256)
MAX_BATCH_HEADS = 65535          # gridDim.y: one block row per (b, h)
MAX_SEQ = 64 * 65535             # gridDim.y of K7 (bf16): 64-key tiles
ALIGN = 16                       # bytes: TMA (bf16 K5), cp.async (K6, K7)
NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)
LAUNCHES = {NAME: 0, DQ: 0, DKV: 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = cubuild.PTR, cubuild.I32, cubuild.I64
_TAIL = [cubuild.F32, _I, _I, _I, _I, _P]
SIGNATURES = {NAME: [_I] + [_P] * 5 + [_I] * 6 + [_L] * 12 + _TAIL,
              SMEM: [_I, _I]}
BWD_SIGNATURES = {DQ: [_I] + [_P] * 7 + [_I] * 6 + [_L] * 15 + _TAIL,
                  DKV: [_I] + [_P] * 8 + [_I] * 6 + [_L] * 18 + _TAIL,
                  BWD_SMEM: [_I, _I, _I]}
LIBRARY = cubuild.CudaLibrary("flash_attention", SIGNATURES)
BWD_LIBRARY = cubuild.CudaLibrary("flash_attention_bwd", BWD_SIGNATURES)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def smem_bytes(name: str, dtype: torch.dtype, d: int) -> int:
    """Dynamic shared memory (bytes) a launch of kernel ``name`` (NAME,
    DQ or DKV) at head dim ``d`` in ``dtype`` takes; 0 for a head dim that
    is not built. Builds the library."""
    if name == NAME:
        return LIBRARY.load().lib.flash_attention_fwd_smem(_DTYPES[dtype], d)
    return BWD_LIBRARY.load().lib.flash_attention_bwd_smem(
        _DTYPES[dtype], d, int(name == DKV))


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


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or float64 where it is float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _groups(q: torch.Tensor, k: torch.Tensor):
    """(b, kv head, slice of its query heads) for every kv head."""
    b, h = q.shape[:2]
    hkv = k.shape[1]
    g = h // hkv
    for bi in range(b):
        for kh in range(hkv):
            yield bi, kh, slice(kh * g, (kh + 1) * g)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float, causal: bool = True,
                    window: int | None = None, kv_len: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's function in plain torch: float32 logits from ``q * sm_scale``,
    the kernel's mask, float32 probabilities through the P.V product,
    ``out`` in q's dtype and ``lse`` (B, H, Sq) float32."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    kv_len = skv if kv_len is None else kv_len
    ok = mask(sq, skv, causal=causal, window=window, kv_len=kv_len,
              device=q.device)
    wide = torch.promote_types(q.dtype, torch.float32)
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=wide, device=q.device)
    for bi, kh, hs in _groups(q, k):
        s = torch.matmul(_wide(q[bi, hs]) * sm_scale, _wide(k[bi, kh]).T)
        s = torch.where(ok, s, NEG_BIG)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.where(ok, torch.exp(s - m), 0.0)
        del s
        lm = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
        out[bi, hs] = (torch.matmul(p, _wide(v[bi, kh])) / lm).to(q.dtype)
        lse[bi, hs] = (m + torch.log(lm))[..., 0]
    return out, lse


def _bwd_plain(q, k, v, do, lse, dd, *, sm_scale, causal, window, kv_len):
    """(dq, dk, dv) from lse and dd = rowsum(do * out): the function of K6
    and K7 in plain torch, in q's dtype."""
    sq, skv = q.shape[2], k.shape[2]
    ok = mask(sq, skv, causal=causal, window=window, kv_len=kv_len,
              device=q.device)
    wide = torch.promote_types(q.dtype, torch.float32)
    dq = torch.empty(q.shape, dtype=wide, device=q.device)
    dk = torch.empty(k.shape, dtype=wide, device=q.device)
    dv = torch.empty(v.shape, dtype=wide, device=q.device)
    for bi, kh, hs in _groups(q, k):
        qf, dof = _wide(q[bi, hs]), _wide(do[bi, hs])          # (G, Sq, D)
        kf, vf = _wide(k[bi, kh]), _wide(v[bi, kh])            # (Skv, D)
        s = torch.matmul(qf, kf.T) * sm_scale                   # (G, Sq, Skv)
        p = torch.where(ok, torch.exp(s - lse[bi, hs, :, None]), 0.0)
        del s
        dp = torch.matmul(dof, vf.T)
        ds = p * (dp - dd[bi, hs, :, None]) * sm_scale
        del dp
        dq[bi, hs] = torch.matmul(ds, kf)
        dk[bi, kh] = torch.einsum("gqt,gqd->td", ds, qf)
        dv[bi, kh] = torch.einsum("gqt,gqd->td", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    *, sm_scale: float, causal: bool = True,
                    window: int | None = None, kv_len: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of K5 (K6 and K7 together) in plain torch, as
    ``flash_attention_bwd_blocks`` computes it: ``dd = rowsum(do * out)``,
    ``s = (q.k) * sm_scale``, ``p = exp(s - lse)`` on valid keys and 0
    elsewhere, ``ds = p * (do.v - dd) * sm_scale``; dq = ds.k, dk = ds^T.q
    and dv = p^T.do, dk and dv summed over each kv head's query heads.
    Returns (dq, dk, dv) in q's dtype."""
    kv_len = k.shape[2] if kv_len is None else kv_len
    dd = torch.sum(_wide(do) * _wide(out), dim=-1)
    return _bwd_plain(q, k, v, do, lse, dd, sm_scale=sm_scale, causal=causal,
                      window=window, kv_len=kv_len)


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


def _check_card(*tensors: tuple[str, torch.Tensor]) -> None:
    """What the CUDA kernels take: float32 or bf16, a built head dim,
    B*H block rows, at most MAX_SEQ positions, one device, contiguous head
    dims; for bf16, which the kernels read in 16-byte pieces (TMA boxes
    in K5, cp.async in K6 and K7), 16-byte aligned data and batch, head
    and row strides. ``tensors`` starts with ("q", q) and ("k", k)."""
    (_, q), (_, k) = tensors[:2]
    b, h, sq, d = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} not supported; float32 or bfloat16")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; one of {HEAD_DIMS}")
    if b * h > MAX_BATCH_HEADS:
        raise ValueError(f"B*H = {b * h} > {MAX_BATCH_HEADS}")
    if max(sq, k.shape[2]) > MAX_SEQ:
        raise ValueError(f"sequence longer than {MAX_SEQ}")
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head-dim axis must be contiguous")
        if t.dtype == torch.bfloat16:
            _check_aligned(name, t)


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """Raise unless every row of ``t`` starts on ALIGN bytes: its data
    pointer, and its batch, head and row strides (of axes longer than 1)."""
    if t.data_ptr() % ALIGN:
        raise ValueError(f"{name}'s data is not {ALIGN}-byte aligned")
    for axis in range(3):
        if t.shape[axis] > 1 and t.stride(axis) * t.element_size() % ALIGN:
            raise ValueError(f"{name}'s stride {t.stride(axis)} along axis "
                             f"{axis} is not a multiple of {ALIGN} bytes")


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
    _check_card(("q", q), ("k", k), ("v", v))
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
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


def _bwd_operands(q, k, v, do, lse, dd, kv_len, window):
    """Checks the backward's operands for the card; returns do, lse and dd
    as the kernels take them (``do`` copied with ``.contiguous()`` only if
    its head-dim axis is strided, lse and dd only if they are not
    contiguous)."""
    _check(q, k, v, kv_len, window)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    rows = q.shape[:3]
    for name, t in (("lse", lse), ("dd", dd)):
        if t.shape != rows or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {tuple(rows)}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if do.stride(3) != 1:
        do = do.contiguous()
    _check_card(("q", q), ("k", k), ("v", v), ("do", do))
    return do, lse.contiguous(), dd.contiguous()


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, dd: torch.Tensor, *,
                 sm_scale: float, causal: bool = True,
                 window: int | None = None, kv_len: int | None = None
                 ) -> torch.Tensor:
    """K6 (replaces ``_flash_bwd_dq_kernel``): dq (B, H, Sq, D) in q's
    dtype and layout, from lse and dd = rowsum(do * out)."""
    kv_len = k.shape[2] if kv_len is None else kv_len
    if not cubuild.on_card(q):
        _check(q, k, v, kv_len, window)
        return _bwd_plain(q, k, v, do, lse, dd, sm_scale=sm_scale,
                          causal=causal, window=window, kv_len=kv_len)[0]
    do, lse, dd = _bwd_operands(q, k, v, do, lse, dd, kv_len, window)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    if b and h and sq:
        strides = [s for t in (q, k, v, do, dq) for s in t.stride()[:3]]
        BWD_LIBRARY.call(DQ, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         dd.data_ptr(), dq.data_ptr(), b, h, hkv, sq, skv, d,
                         *strides, float(sm_scale), int(causal),
                         0 if window is None else int(window), int(kv_len),
                         *cubuild.stream(q.device))
        LAUNCHES[DQ] += 1
    return dq


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, dd: torch.Tensor, *,
                  sm_scale: float, causal: bool = True,
                  window: int | None = None, kv_len: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 (replaces ``_flash_bwd_dkv_kernel``): (dk, dv), each (B, Hkv,
    Skv, D) in k's dtype and layout, summed over every query head of the
    GQA group."""
    kv_len = k.shape[2] if kv_len is None else kv_len
    if not cubuild.on_card(q):
        _check(q, k, v, kv_len, window)
        return _bwd_plain(q, k, v, do, lse, dd, sm_scale=sm_scale,
                          causal=causal, window=window, kv_len=kv_len)[1:]
    do, lse, dd = _bwd_operands(q, k, v, do, lse, dd, kv_len, window)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if b and hkv and skv:
        strides = [s for t in (q, k, v, do, dk, dv) for s in t.stride()[:3]]
        BWD_LIBRARY.call(DKV, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         dd.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
                         hkv, sq, skv, d, *strides, float(sm_scale),
                         int(causal), 0 if window is None else int(window),
                         int(kv_len), *cubuild.stream(q.device))
        LAUNCHES[DKV] += 1
    return dk, dv


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
              sm_scale: float, causal: bool = True,
              window: int | None = None, kv_len: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of K5: ``dd = rowsum(do * out)`` in float32 (outside
    the kernels, as in the reference), then K6 and K7. On CPU tensors,
    ``flash_bwd_plain``."""
    if not cubuild.on_card(q):
        return flash_bwd_plain(q, k, v, out, lse, do, sm_scale=sm_scale,
                               causal=causal, window=window, kv_len=kv_len)
    dd = torch.sum(do.float() * out.float(), dim=-1)
    kw = dict(sm_scale=sm_scale, causal=causal, window=window, kv_len=kv_len)
    dq = flash_bwd_dq(q, k, v, do, lse, dd, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, dd, **kw)
    return dq, dk, dv
