"""Pure-torch oracle for the TOPSIS kernels — port of the TOPSIS part of
``repro.kernels.ref``. The semantic ground truth the wrapper sweeps in
tests/test_torch_kernels.py are held against."""
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
