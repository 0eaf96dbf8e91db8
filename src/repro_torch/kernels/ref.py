"""Pure-torch oracles for the port's kernels — port of
``repro.kernels.ref``. The semantic ground truth the wrapper sweeps in
tests/test_torch_kernels.py, test_torch_flash.py and test_torch_rmsnorm.py
are held against."""
from __future__ import annotations

import torch

_EPS = 1e-12


# --- TOPSIS batch scoring ---------------------------------------------------
def topsis_closeness_ref(matrix: torch.Tensor, weights: torch.Tensor,
                         benefit: torch.Tensor) -> torch.Tensor:
    """Closeness coefficients for an (N, C) decision matrix.

    Mirrors repro_torch.core.topsis.closeness without the valid-mask path
    (the fleet batch-scorer filters infeasible slices before scoring).
    """
    benefit = torch.as_tensor(benefit, dtype=torch.bool, device=matrix.device)
    weights = weights / torch.clamp_min(torch.sum(weights), _EPS)
    norms = torch.sqrt(torch.sum(matrix * matrix, dim=0, keepdim=True))
    v = matrix / torch.clamp_min(norms, _EPS) * weights
    a_pos = torch.where(benefit, torch.amax(v, dim=0), torch.amin(v, dim=0))
    a_neg = torch.where(benefit, torch.amin(v, dim=0), torch.amax(v, dim=0))
    d_pos = torch.sqrt(torch.sum((v - a_pos) ** 2, dim=1))
    d_neg = torch.sqrt(torch.sum((v - a_neg) ** 2, dim=1))
    cc = d_neg / torch.clamp_min(d_pos + d_neg, _EPS)
    return torch.where(d_pos + d_neg <= _EPS, 0.5, cc)


# --- RMSNorm ----------------------------------------------------------------
def rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms * gamma.float()).to(x.dtype)


# --- Flash attention (causal / full) ----------------------------------------
def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, sm_scale: float | None = None,
                  window: int | None = None) -> torch.Tensor:
    """(B, H, S, D) x (B, Hkv, S, D) -> (B, H, S, D); GQA broadcast when
    H > Hkv; optional sliding window (mixtral)."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    if hkv != h:
        rep = h // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = torch.where(mask, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
