"""TOPSIS engine in PyTorch — port of ``repro.core.topsis``.

TOPSIS (Technique for Order Preference by Similarity to Ideal Solution)
ranks N alternatives (cluster nodes) over C criteria:

  1. vector-normalize the decision matrix column-wise,
  2. apply criterion weights,
  3. form the ideal (A+) and anti-ideal (A-) alternatives,
  4. compute Euclidean distances d+ and d-,
  5. closeness coefficient  CC_i = d-_i / (d+_i + d-_i)  in [0, 1],
  6. rank descending by CC.

The torch functions take tensors on any device and broadcast over leading
batch axes, so one :func:`closeness` serves a single (N, C) matrix, a
(P, N, C) pod queue and an (S, P, N, C) scheme grid alike (the reference
needs ``jax.vmap`` for the batch forms). They are the semantic reference
for the CUDA kernels in ``repro_torch.kernels`` (which consume precomputed
column norms). The ``*_np`` functions are the float64 numpy reference,
copied verbatim from ``repro.core.topsis``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-12


class TopsisResult(NamedTuple):
    closeness: torch.Tensor   # (..., N) closeness coefficient per alternative
    ranking: torch.Tensor     # (..., N) indices, best alternative first
    d_pos: torch.Tensor       # (..., N) distance to ideal
    d_neg: torch.Tensor       # (..., N) distance to anti-ideal
    weighted: torch.Tensor    # (..., N, C) weighted normalized matrix


def _bool(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(mask, dtype=torch.bool, device=like.device)


def normalize_matrix(matrix: torch.Tensor) -> torch.Tensor:
    """Column-wise vector normalization: r_ij = x_ij / ||x_:j||_2.

    Zero columns normalize to zero (all alternatives equal on that
    criterion → it contributes nothing to the ranking).
    """
    norms = torch.sqrt(torch.sum(matrix * matrix, dim=-2, keepdim=True))
    return matrix / torch.clamp_min(norms, _EPS)


def ideal_points(weighted: torch.Tensor, benefit: torch.Tensor):
    """Ideal / anti-ideal rows. ``benefit`` is a (C,) bool mask:
    True → higher is better (max enters A+), False → cost criterion."""
    benefit = _bool(benefit, weighted)
    col_max = torch.amax(weighted, dim=-2)
    col_min = torch.amin(weighted, dim=-2)
    a_pos = torch.where(benefit, col_max, col_min)
    a_neg = torch.where(benefit, col_min, col_max)
    return a_pos, a_neg


def masked_ideal_points(weighted: torch.Tensor, benefit: torch.Tensor,
                        valid: torch.Tensor | None):
    """Ideal / anti-ideal rows with infeasible alternatives excluded from
    BOTH reference points: invalid rows are replaced with the worst possible
    value for A+ and the best possible value for A- so they can never define
    either extreme. The single source of this rule — the kernel wrappers in
    ``repro_torch.kernels.ops`` share it (``closeness_np`` mirrors it in
    numpy)."""
    if valid is None:
        return ideal_points(weighted, benefit)
    benefit = _bool(benefit, weighted)
    valid = _bool(valid, weighted)
    inf = torch.tensor(torch.inf, dtype=weighted.dtype, device=weighted.device)
    worst = torch.where(benefit, -inf, inf)
    best = torch.where(benefit, inf, -inf)
    a_pos, _ = ideal_points(torch.where(valid[..., None], weighted, worst),
                            benefit)
    _, a_neg = ideal_points(torch.where(valid[..., None], weighted, best),
                            benefit)
    return a_pos, a_neg


def closeness(matrix: torch.Tensor, weights: torch.Tensor,
              benefit: torch.Tensor,
              valid: torch.Tensor | None = None) -> TopsisResult:
    """Full TOPSIS pipeline on a (..., N, C) decision matrix with (..., C)
    weights (leading axes broadcast: a (P, N, C) queue with (P, C)
    per-pod weights is the batched form).

    ``valid`` is an optional (..., N) bool mask for alternatives that
    survived filtering (infeasible nodes). Invalid rows are excluded from
    the ideal points and receive closeness -inf so they never rank first.
    """
    weights = weights / torch.clamp_min(
        torch.sum(weights, dim=-1, keepdim=True), _EPS)
    r = normalize_matrix(matrix)
    v = r * weights[..., None, :]

    a_pos, a_neg = masked_ideal_points(v, benefit, valid)

    d_pos = torch.sqrt(torch.sum((v - a_pos[..., None, :]) ** 2, dim=-1))
    d_neg = torch.sqrt(torch.sum((v - a_neg[..., None, :]) ** 2, dim=-1))
    cc = d_neg / torch.clamp_min(d_pos + d_neg, _EPS)
    # Degenerate case: single feasible alternative or all-equal matrix.
    cc = torch.where(d_pos + d_neg <= _EPS, 0.5, cc)
    if valid is not None:
        cc = torch.where(_bool(valid, cc), cc, -torch.inf)
    ranking = torch.argsort(-cc, dim=-1, stable=True)
    return TopsisResult(cc, ranking, d_pos, d_neg, v)


def select(matrix: torch.Tensor, weights: torch.Tensor,
           benefit: torch.Tensor,
           valid: torch.Tensor | None = None) -> torch.Tensor:
    """Index of the best alternative (argmax closeness)."""
    return closeness(matrix, weights, benefit, valid).ranking[..., 0]


def batched_closeness(mats: torch.Tensor, ws: torch.Tensor,
                      benefit: torch.Tensor,
                      valids: torch.Tensor | None = None) -> TopsisResult:
    """P concurrent pods, each with its own (N, C) matrix and (C,) weights:
    (P, N, C), (P, C), (P, N) -> per-pod results (the reference's
    ``jax.vmap(closeness)``; here the batch axis simply broadcasts)."""
    return closeness(mats, ws, benefit, valids)


def batched_closeness_np(mats, ws, benefit, valids=None) -> "np.ndarray":
    """(P, N) closeness via a per-pod :func:`closeness_np` loop — the
    reference semantics the batched jax/pallas backends must match."""
    import numpy as np
    out = [closeness_np(m, w, benefit,
                        None if valids is None else valids[i]).closeness
           for i, (m, w) in enumerate(zip(mats, ws))]
    return np.stack(out, axis=0)


# --- Weight-scheme grid: (S schemes x P pods x N nodes) in one pass -------
def closeness_grid(mats: torch.Tensor, ws: torch.Tensor,
                   benefit: torch.Tensor,
                   valids: torch.Tensor | None = None) -> torch.Tensor:
    """(S, P, N) closeness for a (P, N, C) queue tensor under an (S, C)
    weight-scheme grid. Row ``s`` computes exactly what
    :func:`batched_closeness` computes for ``ws[s]``: the queue gains a
    leading scheme axis and broadcasts against the weights, so
    normalization, ideal points and distances are per scheme. ``valids``
    is the usual (P, N) feasibility mask (shared by all schemes; invalid
    -> -inf)."""
    return closeness(mats[None], ws[:, None, :], benefit,
                     None if valids is None else valids[None]).closeness


def closeness_grid_np(mats, ws, benefit, valids=None) -> "np.ndarray":
    """(S, P, N) numpy reference for :func:`closeness_grid`: a per-scheme
    loop of :func:`batched_closeness_np`, so row ``s`` is bitwise equal to
    scoring the queue under ``ws[s]`` alone — the oracle the jax and pallas
    grid paths are verified against (1e-5, float32 device math)."""
    import numpy as np
    ws = np.asarray(ws, dtype=np.float64)
    p = len(mats)
    return np.stack([
        batched_closeness_np(mats, np.broadcast_to(w, (p, w.shape[-1])),
                             benefit, valids)
        for w in ws], axis=0)


def _weighted_and_ideals_np(matrix, weights, benefit, valid):
    """The numpy pipeline up to the distance step: weighted normalized
    matrix plus the (masked) ideal / anti-ideal rows — shared verbatim by
    :func:`closeness_np` and :func:`explain_np` so the explanation is an
    exact decomposition of the scores the scheduler acted on."""
    import numpy as np
    matrix = np.asarray(matrix, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    weights = weights / max(weights.sum(), _EPS)
    benefit = np.asarray(benefit, dtype=bool)
    norms = np.sqrt((matrix * matrix).sum(axis=0, keepdims=True))
    v = matrix / np.maximum(norms, _EPS) * weights
    if valid is not None:
        valid = np.asarray(valid, dtype=bool)
        worst = np.where(benefit, -np.inf, np.inf)
        best = np.where(benefit, np.inf, -np.inf)
        vw = np.where(valid[:, None], v, worst)
        vb = np.where(valid[:, None], v, best)
        a_pos = np.where(benefit, vw.max(axis=0), vw.min(axis=0))
        a_neg = np.where(benefit, vb.min(axis=0), vb.max(axis=0))
    else:
        a_pos = np.where(benefit, v.max(axis=0), v.min(axis=0))
        a_neg = np.where(benefit, v.min(axis=0), v.max(axis=0))
    return v, a_pos, a_neg, valid


def closeness_np(matrix, weights, benefit, valid=None):
    """NumPy mirror of :func:`closeness` for latency-critical single
    decisions on CPU (the per-pod scheduler hot path, where jnp dispatch
    overhead dominates the 4-node matrices of the paper's cluster).
    Semantics are identical; tests assert equivalence."""
    import numpy as np
    v, a_pos, a_neg, valid = _weighted_and_ideals_np(matrix, weights,
                                                     benefit, valid)
    # inf/inf -> nan is expected when NO row is valid (both ideals are
    # +-inf); the nan closeness is masked to -inf below
    with np.errstate(invalid="ignore"):
        d_pos = np.sqrt(((v - a_pos) ** 2).sum(axis=1))
        d_neg = np.sqrt(((v - a_neg) ** 2).sum(axis=1))
        cc = d_neg / np.maximum(d_pos + d_neg, _EPS)
        cc = np.where(d_pos + d_neg <= _EPS, 0.5, cc)
    if valid is not None:
        cc = np.where(valid, cc, -np.inf)
    return TopsisResult(cc, np.argsort(-cc), d_pos, d_neg, v)


def _cc_row_np(row, a_pos, a_neg):
    """Closeness of one weighted-normalized row against fixed ideal points
    (same arithmetic and degenerate rule as :func:`closeness_np`)."""
    import numpy as np
    d_pos = float(np.sqrt(((row - a_pos) ** 2).sum()))
    d_neg = float(np.sqrt(((row - a_neg) ** 2).sum()))
    if d_pos + d_neg <= _EPS:
        return 0.5
    return d_neg / max(d_pos + d_neg, _EPS)


def explain_np(matrix, weights, benefit, valid=None, criteria_names=None):
    """Per-criterion attribution of the winner-vs-runner-up closeness gap.

    Telescoping decomposition: starting from the runner-up's weighted
    normalized row, swap one criterion at a time to the winner's value
    (criteria order) and recompute closeness against the *fixed* ideal
    points of the actual decision. Each swap's closeness delta is that
    criterion's contribution; the deltas sum exactly (up to float
    round-off) to ``cc_winner - cc_runner_up``, so "why did TOPSIS pick
    this node" reads off as C signed numbers. Numpy path only — the
    jax/pallas engines return closeness without the weighted
    intermediates.

    Returns a dict: winner / runner-up indices and closeness, the gap,
    and one ``{criterion, delta_cc, winner_value, runner_up_value}``
    entry per criterion (raw decision-matrix values, not the normalized
    ones). With fewer than two feasible alternatives ``runner_up`` is
    None and ``contributions`` is empty.
    """
    import numpy as np
    matrix = np.asarray(matrix, dtype=np.float64)
    res = closeness_np(matrix, weights, benefit, valid)
    v, a_pos, a_neg, _ = _weighted_and_ideals_np(matrix, weights, benefit,
                                                 valid)
    n_c = matrix.shape[-1]
    if criteria_names is None:
        criteria_names = [f"criterion_{j}" for j in range(n_c)]
    # first max on both picks — the scheduler's argmax tie-break, which
    # res.ranking (unstable argsort) does not guarantee on exact ties
    winner = int(np.argmax(res.closeness))
    feasible = int(np.isfinite(res.closeness).sum())
    if feasible < 2:
        return {"winner": winner, "runner_up": None,
                "closeness_winner": float(res.closeness[winner]),
                "closeness_runner_up": None, "gap": None,
                "contributions": []}
    rest = res.closeness.copy()
    rest[winner] = -np.inf
    runner = int(np.argmax(rest))
    row = v[runner].copy()
    cc_prev = _cc_row_np(row, a_pos, a_neg)
    contributions = []
    for j in range(n_c):
        row[j] = v[winner, j]
        cc_j = _cc_row_np(row, a_pos, a_neg)
        contributions.append({
            "criterion": str(criteria_names[j]),
            "delta_cc": cc_j - cc_prev,
            "winner_value": float(matrix[winner, j]),
            "runner_up_value": float(matrix[runner, j]),
        })
        cc_prev = cc_j
    return {"winner": winner, "runner_up": runner,
            "closeness_winner": float(res.closeness[winner]),
            "closeness_runner_up": float(res.closeness[runner]),
            "gap": float(res.closeness[winner] - res.closeness[runner]),
            "contributions": contributions}
