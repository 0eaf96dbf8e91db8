"""Grid carbon-intensity signals (port of ``repro.core.carbon``, first part).

GreenPod optimizes *energy*; the sustainability metric operators report is
*carbon*, which varies by grid region and hour. This module supplies the
time-varying signal layer the carbon-aware scheduling stack consumes:

``CarbonSignal`` — gCO2/kWh as a function of ``(region, t)``:

  * ``ConstantCarbon``   — flat per-region intensities (annual averages),
  * ``SinusoidalCarbon`` — diurnal sinusoid with per-region phase offsets
    (solar-heavy grids dip mid-day at their local noon).

Every signal exposes exact interval integrals (``integral``), which is
what lets ``PowerTimeline`` integrate power x intensity over a run
without time-stepping error. The port's schedulers only call
``.intensities(regions, now)``, so any object with that method serves as a
signal.

Carbon from energy: grams = joules x (gCO2/kWh) / 3.6e6 (``carbon_grams``).

Not yet ported (ROADMAP Queue 1): ``TraceCarbon``, ``CarbonPolicy`` and the
``CarbonScheduling`` engine policy.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

J_PER_KWH = 3.6e6

# Default fleet regions: synthetic fleets spread nodes round-robin across
# these (cluster.node.make_fleet / make_scenario_cluster); the paper's 4-node
# cluster keeps the single "default" region, so paper-mode runs see a flat
# signal axis and reproduce bitwise.
DEFAULT_REGIONS: tuple[str, ...] = ("us-east", "us-west", "eu-west",
                                    "ap-south")


def carbon_grams(energy_j: float, intensity_g_per_kwh: float) -> float:
    """Operational carbon of ``energy_j`` joules drawn at a (constant)
    grid intensity."""
    return energy_j * intensity_g_per_kwh / J_PER_KWH


class CarbonSignal:
    """Grid carbon intensity (gCO2/kWh) per region over time.

    Implementations must be deterministic pure functions of ``(region, t)``
    so scenario runs replay exactly, and must provide *exact* interval
    integrals: ``integral(region, t0, t1)`` returns ``∫ I(region, t) dt``
    in gCO2·s/kWh, which multiplied by a constant power (W) and divided by
    ``J_PER_KWH`` yields grams — the primitive ``PowerTimeline`` carbon
    accounting is built on.
    """

    def intensity(self, region: str, t: float) -> float:
        raise NotImplementedError

    def integral(self, region: str, t0: float, t1: float) -> float:
        """Exact ``∫_{t0}^{t1} intensity(region, t) dt`` (gCO2·s/kWh)."""
        raise NotImplementedError

    def intensities(self, regions: Sequence[str], t: float) -> np.ndarray:
        """(N,) intensity column for a fleet's per-node regions (one
        evaluation per *unique* region, broadcast to the node axis)."""
        cache = {r: self.intensity(r, t) for r in set(regions)}
        return np.asarray([cache[r] for r in regions], dtype=np.float64)

    def fleet_min(self, regions: Sequence[str], t: float) -> float:
        """Lowest current intensity over a set of regions — the engine's
        'is there a dip anywhere' deferral test."""
        return min(self.intensity(r, t) for r in set(regions))


class ConstantCarbon(CarbonSignal):
    """Flat intensities: one default value plus optional per-region
    overrides. The degenerate signal — carbon-aware scoring under it
    reduces to power-aware scoring."""

    def __init__(self, intensity: float = 400.0,
                 per_region: dict[str, float] | None = None):
        if intensity < 0.0:
            raise ValueError(f"intensity must be >= 0, got {intensity}")
        self.default = float(intensity)
        self.per_region = {k: float(v) for k, v in (per_region or {}).items()}
        for r, v in self.per_region.items():
            if v < 0.0:
                raise ValueError(f"intensity for region {r!r} must be >= 0, "
                                 f"got {v}")

    def intensity(self, region: str, t: float) -> float:
        return self.per_region.get(region, self.default)

    def integral(self, region: str, t0: float, t1: float) -> float:
        return self.intensity(region, t0) * (t1 - t0)


class SinusoidalCarbon(CarbonSignal):
    """Diurnal sinusoid: ``base + amplitude * sin(2π (t + phase) / period)``
    with a per-region phase offset (regions peak at different wall-clock
    hours). ``amplitude <= base`` keeps the signal non-negative, which in
    turn keeps the analytic integral exact (no clipping)."""

    def __init__(self, base: float = 300.0, amplitude: float = 200.0,
                 period_s: float = 86400.0, phase_s: float = 0.0,
                 region_phase_s: dict[str, float] | None = None):
        if period_s <= 0.0:
            raise ValueError(f"period_s must be positive, got {period_s}")
        if not 0.0 <= amplitude <= base:
            raise ValueError("need 0 <= amplitude <= base for a non-negative "
                             f"signal, got amplitude={amplitude} base={base}")
        self.base = float(base)
        self.amplitude = float(amplitude)
        self.period_s = float(period_s)
        self.phase_s = float(phase_s)
        self.region_phase_s = {k: float(v)
                               for k, v in (region_phase_s or {}).items()}

    def _phase(self, region: str) -> float:
        return self.phase_s + self.region_phase_s.get(region, 0.0)

    def intensity(self, region: str, t: float) -> float:
        w = 2.0 * math.pi / self.period_s
        return self.base + self.amplitude * math.sin(w * (t + self._phase(region)))

    def integral(self, region: str, t0: float, t1: float) -> float:
        # ∫ base + A sin(w (t + φ)) dt = base Δt - (A/w)[cos(w(t1+φ)) - cos(w(t0+φ))]
        w = 2.0 * math.pi / self.period_s
        phi = self._phase(region)
        return (self.base * (t1 - t0)
                - self.amplitude / w * (math.cos(w * (t1 + phi))
                                        - math.cos(w * (t0 + phi))))


def diurnal_fleet_signal(regions: Sequence[str] = DEFAULT_REGIONS,
                         base: float = 300.0, amplitude: float = 200.0,
                         period_s: float = 86400.0, phase_s: float = 0.0,
                         stagger_s: float | None = None) -> SinusoidalCarbon:
    """Convenience: one diurnal sinusoid with region phases staggered by
    ``stagger_s`` (default: evenly around the period) — the multi-timezone
    fleet a carbon-aware scheduler can chase the sun across."""
    if stagger_s is None:
        stagger_s = period_s / max(len(regions), 1)
    return SinusoidalCarbon(
        base=base, amplitude=amplitude, period_s=period_s, phase_s=phase_s,
        region_phase_s={r: i * stagger_s for i, r in enumerate(regions)})

