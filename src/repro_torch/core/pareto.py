"""Pareto frontier engine over TOPSIS weighting schemes — port of
``repro.core.pareto`` (a copy, imports rewritten; the metric collectors
score on the ``cuda`` backend by default, ``scenario_metrics`` in batch
rounds).

The paper's headline result (up to 39.1% energy savings) depends on *which*
weighting scheme an operator picks, but it only evaluates five fixed
vectors. This module sweeps the whole trade-off surface instead: generate a
simplex-lattice grid of weight vectors, score every scheme in ONE fused
dispatch (``BatchScheduler.select_many_grid`` — the (S, P, N) closeness
tensor from ``topsis.closeness_grid`` / the weight-grid kernel K4),
collect per-scheme cost metrics (energy / carbon / mean latency /
unschedulable rate), and filter to the Pareto-optimal set with an exact
dominance pass. ``FrontierAtlas.dominant_scheme(regime)`` then answers "which
weights should this cluster run under this carbon regime".

Two metric collectors with different fidelity/cost trade-offs:

  placement_metrics — one-round what-if: the whole queue placed under every
      scheme off one fleet snapshot, metrics read from the decision tensor
      (predicted energy / runtime / emission of the greedy placements).
      Scales to thousands of schemes — this is the fused grid path.
  scenario_metrics  — engine-exact: one full ``run_scenario`` per NAMED
      scheme (serial; the event engine rebinds state between decisions, so
      only the scoring step parallelizes across schemes, not the dynamics).
      Use for the final handful of frontier survivors, not the full grid.

All metrics are cost-direction (lower is better); negate any benefit metric
before handing it to :func:`pareto_mask`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.core.weighting import validate_weights, weights_for

# The frontier's metric axes, all cost-direction. carbon_g is present only
# when a carbon signal is attached (the collectors drop it otherwise).
METRIC_KEYS = ("energy_kj", "carbon_g", "mean_latency_s",
               "unschedulable_rate")


# --- simplex-lattice weight grids -------------------------------------------
def grid_size(n: int, criteria: int = 5) -> int:
    """Number of points in the {n, criteria} simplex lattice:
    C(n + criteria - 1, criteria - 1) compositions of n."""
    return math.comb(n + criteria - 1, criteria - 1)


def lattice_n_for(min_schemes: int, criteria: int = 5) -> int:
    """Smallest lattice degree n whose grid has >= ``min_schemes`` points."""
    n = 1
    while grid_size(n, criteria) < min_schemes:
        n += 1
    return n


def _compositions(n: int, parts: int):
    """All compositions of n into ``parts`` non-negative ints, first part
    descending — the grid's deterministic lexicographic order."""
    if parts == 1:
        yield (n,)
        return
    for k in range(n, -1, -1):
        for rest in _compositions(n - k, parts - 1):
            yield (k,) + rest


def weight_grid(n: int, criteria: int = 5) -> np.ndarray:
    """The {n, criteria} simplex-lattice weight grid: every vector with
    entries k/n (k non-negative integers summing to n), as a
    (grid_size(n, criteria), criteria) float64 array in deterministic
    lexicographic order. Rows are normalized at generation (``w / w.sum()``)
    so every scheme passes :func:`repro_torch.core.weighting.validate_weights` —
    the same check the schedulers apply to user grids. ``n=1`` yields
    exactly the ``criteria`` unit vectors (one all-in scheme per criterion);
    the paper's calibrated schemes are interior points of finer lattices."""
    if n < 1:
        raise ValueError(f"lattice degree n must be >= 1, got {n}")
    if criteria not in (5, 6):
        raise ValueError(f"criteria must be 5 or 6 (see validate_weights), "
                         f"got {criteria}")
    out = np.array(list(_compositions(n, criteria)), dtype=np.float64)
    out /= out.sum(axis=1, keepdims=True)
    return validate_weights(out, name="weight_grid")


def weight_grid_upto(n_schemes: int, criteria: int = 5) -> np.ndarray:
    """Exactly ``n_schemes`` rows: the finest lattice that reaches the count,
    truncated to its first ``n_schemes`` points (lexicographic prefix —
    deterministic, so benchmark cells at S=512/4096 are reproducible)."""
    full = weight_grid(lattice_n_for(n_schemes, criteria), criteria)
    return full[:n_schemes]


# --- exact dominance filtering ----------------------------------------------
def pareto_mask(metrics) -> np.ndarray:
    """(S,) bool mask of the Pareto-optimal rows of an (S, M) cost-metric
    matrix: row i survives iff no row j weakly dominates it (``j <= i`` on
    every metric AND ``j < i`` on at least one). Exact comparisons, no
    tolerance; identical rows never dominate each other, so ties all stay
    on the front; a single point is trivially optimal."""
    m = np.asarray(metrics, dtype=np.float64)
    if m.ndim != 2:
        raise ValueError(f"metrics must be (S, M), got shape {m.shape}")
    if not np.isfinite(m).all():
        raise ValueError("metrics must be finite to compare dominance")
    le = (m[:, None, :] <= m[None, :, :]).all(axis=-1)   # [j, i]: j <= i
    lt = (m[:, None, :] < m[None, :, :]).any(axis=-1)    # [j, i]: j < i
    return ~(le & lt).any(axis=0)


@dataclass
class SchemePoint:
    """One weighting scheme and its measured cost metrics."""
    index: int
    weights: np.ndarray
    metrics: dict[str, float]
    name: str | None = None

    def as_dict(self) -> dict:
        return {"index": self.index, "name": self.name,
                "weights": [round(float(w), 6) for w in self.weights],
                "metrics": {k: float(v) for k, v in self.metrics.items()}}


@dataclass
class ParetoFrontier:
    """Exact dominance filter over one scheme-metric table (one regime)."""
    points: list[SchemePoint]
    metric_names: tuple[str, ...]
    mask: np.ndarray = field(init=False)
    front: list[SchemePoint] = field(init=False)

    def __post_init__(self):
        matrix = np.array([[p.metrics[k] for k in self.metric_names]
                           for p in self.points], dtype=np.float64)
        self._matrix = matrix
        self.mask = pareto_mask(matrix)
        self.front = [p for p, keep in zip(self.points, self.mask) if keep]

    def dominant(self) -> SchemePoint:
        """The frontier's balanced pick: among Pareto-optimal points, the
        one minimizing the mean min-max-normalized cost across metrics
        (normalization spans the WHOLE point set, so the pick is stable
        under removing dominated points). Deterministic: exact-score ties
        break to the lowest scheme index."""
        lo = self._matrix.min(axis=0)
        span = np.maximum(self._matrix.max(axis=0) - lo, 1e-300)
        scores = ((self._matrix - lo) / span).mean(axis=1)
        scores = np.where(self.mask, scores, np.inf)
        return self.points[int(np.argmin(scores))]

    def as_dict(self) -> dict:
        return {"metrics": list(self.metric_names),
                "n_schemes": len(self.points),
                "n_front": int(self.mask.sum()),
                "dominant": self.dominant().as_dict(),
                "front": [p.as_dict() for p in self.front]}


class FrontierAtlas:
    """Per-regime frontier collection: sweep the same scheme grid under
    several operating regimes (carbon signals, fleet mixes, loads) and look
    up the scheme an operator should run in each."""

    def __init__(self):
        self.frontiers: dict[str, ParetoFrontier] = {}

    def add(self, regime: str, frontier: ParetoFrontier) -> None:
        self.frontiers[regime] = frontier

    def dominant_scheme(self, regime: str) -> SchemePoint:
        """The balanced Pareto-optimal scheme for ``regime`` (see
        :meth:`ParetoFrontier.dominant`)."""
        try:
            return self.frontiers[regime].dominant()
        except KeyError:
            raise KeyError(
                f"unknown regime {regime!r}; swept regimes: "
                f"{sorted(self.frontiers)}") from None

    def to_report(self) -> dict:
        """The frontier payload ``repro_torch.telemetry.report.html_report``
        renders as a table + scatter section."""
        return {regime: f.as_dict() for regime, f in self.frontiers.items()}


# --- metric collection -------------------------------------------------------
def points_from_placements(ws, assignments, mats, inten=None,
                           names: Sequence[str] | None = None
                           ) -> list[SchemePoint]:
    """Per-scheme :class:`SchemePoint` metrics read off the decision tensor:
    ``assignments[s][i]`` is pod i's node under scheme s (None = unplaced),
    ``mats`` the (P, N, C) decision tensor the placements were scored on
    (CRITERIA_NAMES order: col 0 predicted runtime s, col 1 predicted task
    energy J, col 5 emission rate W·g/kWh when ``inten`` is given). Shared
    by :func:`placement_metrics` and the pareto sweep benchmark so both
    derive frontier membership from identical arithmetic."""
    points = []
    for s, assign in enumerate(assignments):
        placed = [(i, a) for i, a in enumerate(assign) if a is not None]
        energy_j = sum(mats[i, a, 1] for i, a in placed)
        # mean predicted runtime of the placed work; 0.0 when nothing
        # placed — the unschedulable_rate of 1.0 flags that degenerate row
        latency = (sum(mats[i, a, 0] for i, a in placed) / len(placed)
                   if placed else 0.0)
        metrics = {"energy_kj": float(energy_j / 1e3),
                   "mean_latency_s": float(latency),
                   "unschedulable_rate":
                       1.0 - len(placed) / max(len(assign), 1)}
        if inten is not None:
            # rate column is W x g/kWh; x runtime(s) / 3.6e6 -> grams
            metrics["carbon_g"] = float(sum(
                mats[i, a, 5] * mats[i, a, 0] for i, a in placed) / 3.6e6)
        points.append(SchemePoint(
            index=s, weights=np.asarray(ws[s], dtype=np.float64),
            metrics=metrics,
            name=None if names is None else names[s]))
    return points


def placement_metrics(pods, nodes, schemes, scheduler=None,
                      backend: str = "cuda", carbon_signal=None,
                      now: float = 0.0,
                      names: Sequence[str] | None = None,
                      device=None) -> list[SchemePoint]:
    """One-round what-if metrics for every scheme in one fused dispatch.

    ``select_many_grid`` scores the queue under all S schemes at once and
    walks an independent greedy ledger per scheme; each scheme's metrics
    are then read off the decision tensor for its placements — predicted
    task energy (kJ), mean predicted runtime (s, the placement-latency
    proxy; 0.0 when a scheme places nothing, which its unschedulable_rate
    of 1.0 flags), emission of the placed work (g, only with a signal:
    rate column x runtime), and the unplaced fraction. These are the
    criteria the scheduler itself trades off, so the frontier is exactly
    the scheduler's own preference surface — engine-exact dynamics
    (idle energy, deferrals) need :func:`scenario_metrics`.

    Without a ``scheduler`` one is built on ``backend`` and ``device``:
    ``cuda`` scores the grid through K4 on ``device`` (``None`` is the
    card, raising when there is none).
    """
    from repro_torch.core.scheduler import (BatchScheduler, _as_table,
                                            decision_matrix_batch)
    if scheduler is None:
        scheduler = BatchScheduler(scheme="general", backend=backend,
                                   carbon_signal=carbon_signal,
                                   device=device)
    table = _as_table(nodes)
    ws = scheduler._weight_grid(schemes)
    assignments, _ = scheduler.select_many_grid(pods, table, ws, now=now)
    signal = scheduler.carbon_signal
    inten = (signal.intensities(table.region, now)
             if signal is not None else None)
    mats = decision_matrix_batch(pods, table, carbon_intensity=inten)
    return points_from_placements(ws, assignments, mats, inten=inten,
                                  names=names)


def scenario_metrics(schemes: Sequence[str], arrivals_factory,
                     cluster_factory=None, carbon=None, autoscale=None,
                     batch: bool = True, batch_backend: str = "cuda",
                     device=None) -> list[SchemePoint]:
    """Engine-exact per-scheme metrics: one full ``run_scenario`` per NAMED
    scheme, serially — the event engine's feedback loop (binds change the
    next decision's fleet state) can't be batched across schemes, which is
    exactly why :func:`placement_metrics` exists for the wide sweep.
    ``arrivals_factory`` is called once per scheme (fresh arrival process,
    same seed => identical workload). By default (``batch=True``) the
    rounds score on ``batch_backend`` on ``device`` (``None`` is the card,
    raising when there is none); ``batch=False`` asks for the reference's
    per-pod decisions, numpy on the host, and ignores both."""
    from repro_torch.cluster.simulator import run_scenario
    points = []
    for s, scheme in enumerate(schemes):
        kwargs = {} if cluster_factory is None else {
            "cluster_factory": cluster_factory}
        res = run_scenario(arrivals_factory(), scheme, carbon=carbon,
                           autoscale=autoscale, batch=batch,
                           batch_backend=batch_backend, device=device,
                           **kwargs)
        metrics = {"energy_kj": float(res.energy_kj("topsis")),
                   "mean_latency_s": float(res.mean_exec_time_s("topsis")),
                   "unschedulable_rate": float(res.unschedulable_rate())}
        if carbon is not None:
            metrics["carbon_g"] = float(res.total_carbon_g("topsis"))
        points.append(SchemePoint(
            index=s, weights=weights_for(scheme, carbon=carbon is not None),
            metrics=metrics, name=scheme))
    return points


def frontier_for(points: Sequence[SchemePoint]) -> ParetoFrontier:
    """Frontier over whatever metric keys the points actually carry (in
    METRIC_KEYS order) — collectors drop carbon_g without a signal."""
    present = tuple(k for k in METRIC_KEYS if k in points[0].metrics)
    return ParetoFrontier(list(points), present)
