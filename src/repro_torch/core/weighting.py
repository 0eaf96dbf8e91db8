"""Weighting schemes (paper Table III) + the adaptive weighting module (§III.A).

The paper names four schemes but does not publish the weight vectors; the
vectors below are our calibration (DESIGN.md §7), ordered as
``criteria.CRITERIA_NAMES``: (execution_time, energy, cores, memory, balance).
"""
from __future__ import annotations

import numpy as np

# Vectors calibrated against paper Table VI (scripts/calibrate.py);
# normalized at use. Order: (exec_time, energy, cores, memory, balance).
SCHEMES: dict[str, np.ndarray] = {
    # Equal importance to all five metrics ("general (balanced)").
    "general": np.array([0.20, 0.20, 0.20, 0.20, 0.20]),
    # Prioritize power consumption.
    "energy_centric": np.array([0.2016, 0.3352, 0.0505, 0.0505, 0.0869]),
    # Emphasize execution speed.
    "performance_centric": np.array([0.2250, 0.1696, 0.1732, 0.1732, 0.2158]),
    # Balance overall resource utilization and energy efficiency.
    "resource_efficient": np.array([0.1348, 0.3605, 0.1876, 0.1876, 0.2383]),
}

SCHEME_NAMES = tuple(SCHEMES)

# Carbon-aware schemes (beyond-paper, repro_torch.core.carbon): six weights, the
# sixth on the carbon-rate criterion. Requires a carbon signal — the
# schedulers reject these schemes without one. carbon_centric chases clean
# regions first; carbon_energy_balanced splits sustainability weight between
# joules and grams.
# Order: (exec_time, energy, cores, memory, balance, carbon_rate).
CARBON_SCHEMES: dict[str, np.ndarray] = {
    "carbon_centric": np.array([0.15, 0.10, 0.04, 0.04, 0.07, 0.60]),
    "carbon_energy_balanced": np.array([0.15, 0.25, 0.05, 0.05, 0.10, 0.40]),
}

CARBON_SCHEME_NAMES = tuple(CARBON_SCHEMES)


def validate_weights(w, name: str | None = None) -> np.ndarray:
    """Validate one weight vector or an (S, C) stack of them and return the
    float64 array. A valid vector has 5 or 6 entries (the paper criteria,
    optionally extended with carbon_rate), every entry finite and
    non-negative, and sums to 1 within 1e-6 — the registry schemes are
    stored unnormalized by design but leave :func:`weights_for` already
    normalized, and the simplex-lattice grid (the reference's ``repro.core.pareto``)
    normalizes at generation, so everything the schedulers consume passes.
    User-supplied grids that don't raise a ValueError naming the first
    offending row instead of silently skewing the ranking."""
    w = np.asarray(w, dtype=np.float64)
    label = name or "weights"
    if w.ndim not in (1, 2):
        raise ValueError(f"{label} must be a (C,) vector or (S, C) grid, "
                         f"got shape {w.shape}")
    rows = w[None] if w.ndim == 1 else w
    if rows.shape[-1] not in (5, 6):
        raise ValueError(
            f"{label} must have 5 weights (paper criteria) or 6 (with "
            f"carbon_rate), got {rows.shape[-1]}")
    for i, row in enumerate(rows):
        where = label if w.ndim == 1 else f"{label}[{i}]"
        if not np.isfinite(row).all():
            raise ValueError(f"{where} has non-finite entries: {row}")
        if (row < 0.0).any():
            raise ValueError(f"{where} has negative entries: {row}")
        total = float(row.sum())
        if abs(total - 1.0) > 1e-6:
            raise ValueError(
                f"{where} sums to {total:.6f}, not 1 (±1e-6) — normalize "
                f"it (w / w.sum()) before handing it to the scheduler")
    return w


def scheme_grid(schemes: "tuple[str, ...]" = SCHEME_NAMES,
                carbon: bool = False) -> np.ndarray:
    """(S, C) stack of :func:`weights_for` rows — the paper's named schemes
    expressed as a weight grid, so the fused grid scorer recovers the fixed
    per-scheme results as a special case (tests pin this bitwise)."""
    return np.stack([weights_for(s, carbon=carbon) for s in schemes])


def weights_for(scheme: str, carbon: bool = False) -> np.ndarray:
    """Normalized weight vector for a scheme.

    With ``carbon=True`` (a carbon signal is attached) the paper's 5-weight
    schemes are padded with a zero carbon weight — the 6-criteria ranking is
    then bitwise identical to the 5-criteria one. Carbon schemes are always
    6 weights (``carbon`` is implied).
    """
    if scheme in CARBON_SCHEMES:
        w = CARBON_SCHEMES[scheme]
        return w / w.sum()
    try:
        w = SCHEMES[scheme]
    except KeyError as e:
        raise ValueError(
            f"unknown weighting scheme {scheme!r}; choose from "
            f"{sorted(SCHEMES) + sorted(CARBON_SCHEMES)}") from e
    if carbon:
        w = np.concatenate([w, [0.0]])
    return w / w.sum()


def adaptive_weights(scheme: str, cluster_utilization: float,
                     carbon: bool = False) -> np.ndarray:
    """Adaptive weighting module (paper §III.A): 'dynamically adjusts criteria
    weights based on system conditions'.

    As cluster utilization rises toward saturation, placement quality is
    increasingly determined by *fit* rather than *preference*: we shift weight
    from the energy criterion toward cores/memory/balance, mirroring the
    paper's observation (§V.C) that high competition 'may require hybrid
    approaches balancing energy awareness with resource efficiency'. The
    carbon weight (6-criteria schemes) is left untouched — grid intensity
    does not depend on cluster load.
    """
    w = weights_for(scheme, carbon=carbon).copy()
    u = float(np.clip(cluster_utilization, 0.0, 1.0))
    # Linear pull of up to 50% of the energy weight once utilization > 0.6.
    pull = 0.5 * max(0.0, (u - 0.6) / 0.4) * w[1]
    w[1] -= pull
    w[2:5] += pull / 3.0
    return w / w.sum()
