"""Grid carbon-intensity signals and the carbon-aware scheduling policy —
port of ``repro.core.carbon`` (a copy, imports rewritten).

GreenPod optimizes *energy*; the sustainability metric operators report is
*carbon*, which varies by grid region and hour. This module supplies the
time-varying signal layer the carbon-aware scheduling stack consumes:

1. ``CarbonSignal`` — gCO2/kWh as a function of ``(region, t)``, with three
   implementations mirroring the ``ArrivalProcess`` family in
   ``repro_torch.cluster.workload``:

     * ``ConstantCarbon``   — flat per-region intensities (annual averages),
     * ``SinusoidalCarbon`` — diurnal sinusoid with per-region phase offsets
       (solar-heavy grids dip mid-day at their local noon),
     * ``TraceCarbon``      — replayable piecewise-constant JSON traces
       (e.g. recorded electricityMaps / WattTime series).

   Every signal exposes exact interval integrals (``integral``), which is
   what lets ``PowerTimeline`` integrate power x intensity over a run
   without time-stepping error.

2. ``CarbonPolicy`` — the knobs the event-driven engine consumes: the
   signal itself, a deferral threshold (deferrable pods wait, bounded by
   their deadline, until the fleet-minimum intensity dips below it), an
   optional preemption threshold (a running deferrable task is evicted and
   requeued when its node's regional signal spikes above it), and the
   cadence of carbon-check wake events.

Carbon from energy: grams = joules x (gCO2/kWh) / 3.6e6 (``carbon_grams``).
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
import os
from typing import Sequence

import numpy as np

from repro_torch.core import telemetry
from repro_torch.core.policy import CARBON_CHECK, Event, SchedulingPolicy

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


class TraceCarbon(CarbonSignal):
    """Replayable piecewise-constant intensity trace: entries
    ``{"t": float, "intensity": float, "region": str}`` (region defaults to
    ``"default"``). Each region's intensity holds its most recent reading;
    before a region's first reading the first value applies. Regions absent
    from the trace fall back to the ``"default"`` region's series.

    Mirrors ``TraceArrivals``: :meth:`from_file` loads a JSON list (``str``
    or ``pathlib.Path``), entries are validated up front with messages
    naming the offending entry's index (and the source file when loaded
    from one), and a fixed trace replays to the identical signal every run.
    """

    def __init__(self, entries: "list[dict]", source: str | None = None):
        prefix = f"{source}: " if source else ""
        series: dict[str, list[tuple[float, float]]] = {}
        for i, e in enumerate(entries):
            where = f"{prefix}carbon trace entry {i} ({e!r})"
            if not isinstance(e, dict):
                raise ValueError(f"{where}: expected an object with 't' "
                                 f"and 'intensity' fields")
            try:
                t_ok = math.isfinite(float(e["t"])) and float(e["t"]) >= 0.0
            except (KeyError, TypeError, ValueError):
                t_ok = False
            if not t_ok:
                raise ValueError(
                    f"{where}: needs a finite non-negative 't'")
            try:
                i_ok = (math.isfinite(float(e["intensity"]))
                        and float(e["intensity"]) >= 0.0)
            except (KeyError, TypeError, ValueError):
                i_ok = False
            if not i_ok:
                raise ValueError(f"{where}: needs a finite non-negative "
                                 f"'intensity' (gCO2/kWh)")
            region = e.get("region", "default")
            if not isinstance(region, str) or not region:
                raise ValueError(f"{where}: 'region' must be a non-empty "
                                 f"string")
            series.setdefault(region, []).append(
                (float(e["t"]), float(e["intensity"])))
        if not series:
            raise ValueError(f"{prefix}carbon trace has no entries")
        self.series = {r: sorted(pts) for r, pts in series.items()}
        self._times = {r: [t for t, _ in pts] for r, pts in self.series.items()}

    @classmethod
    def from_file(cls, path) -> "TraceCarbon":
        """Load a JSON trace; ``path`` may be a ``str`` or any
        ``os.PathLike`` (``pathlib.Path``). Validation errors are prefixed
        with the file path and the offending entry's index."""
        with open(path) as f:
            return cls(json.load(f), source=os.fspath(path))

    def _pts(self, region: str) -> list[tuple[float, float]]:
        pts = self.series.get(region)
        if pts is None:
            pts = self.series.get("default")
        if pts is None:
            raise ValueError(f"region {region!r} not in carbon trace and no "
                             f"'default' region series to fall back to "
                             f"(have {sorted(self.series)})")
        return pts

    def intensity(self, region: str, t: float) -> float:
        pts = self._pts(region)
        times = self._times.get(region, self._times.get("default"))
        i = bisect.bisect_right(times, t) - 1
        return pts[max(i, 0)][1]

    def integral(self, region: str, t0: float, t1: float) -> float:
        pts = self._pts(region)
        # start at the piece containing t0 and stop once past t1 instead of
        # scanning the whole trace (hot path of timeline carbon accounting)
        times = self._times.get(region, self._times.get("default"))
        k0 = max(bisect.bisect_right(times, t0) - 1, 0)
        total = 0.0
        for k in range(k0, len(pts)):
            s, val = pts[k]
            e = pts[k + 1][0] if k + 1 < len(pts) else math.inf
            if k == 0:
                s = -math.inf          # first reading extends backwards
            lo, hi = max(s, t0), min(e, t1)
            if hi > lo:
                total += val * (hi - lo)
            if e >= t1:
                break
        return total


@dataclasses.dataclass(frozen=True)
class CarbonPolicy:
    """Carbon configuration for the event-driven engine
    (``repro_torch.cluster.simulator.run_scenario``).

    * ``signal`` alone attaches the sixth (carbon-rate) criterion to the
      TOPSIS schedulers and carbon accounting to the run's
      ``PowerTimeline`` — placements of zero-carbon-weight schemes are
      bitwise unchanged.
    * ``defer_threshold``: while the fleet-minimum intensity exceeds it,
      deferrable pods wait (bounded by ``Pod.deadline_s`` past arrival)
      for a dip; the engine wakes every ``check_interval_s`` to re-test,
      and always exactly at a waiting pod's deadline.
    * ``preempt_threshold``: a running deferrable task whose node's
      regional intensity spikes above it is evicted and requeued (at most
      once per pod, never past its deadline); its timeline segment is
      truncated at the eviction instant.
    """

    signal: CarbonSignal
    defer_threshold: float = math.inf        # gCO2/kWh
    preempt_threshold: float | None = None   # gCO2/kWh
    check_interval_s: float = 300.0

    def __post_init__(self):
        if self.check_interval_s <= 0.0:
            raise ValueError(f"check_interval_s must be positive, "
                             f"got {self.check_interval_s}")
        if math.isnan(self.defer_threshold):
            # NaN would silently disable deferral (every > compares False)
            raise ValueError("defer_threshold must not be NaN; use the "
                             "default inf to turn deferral off")
        if self.preempt_threshold is not None and not (
                self.preempt_threshold >= 0.0):
            raise ValueError(f"preempt_threshold must be >= 0, "
                             f"got {self.preempt_threshold}")


class CarbonScheduling(SchedulingPolicy):
    """Carbon temporal shifting as a kernel policy: the engine-side logic
    of :class:`CarbonPolicy`, expressed through the
    :class:`~repro_torch.core.policy.SchedulingPolicy` hook protocol.

    * ``on_arrival``     — rejects deferrable pods without a finite
      positive deadline (an unbounded deadline would let the wake loop
      spin forever under a never-dipping signal).
    * ``on_round_start`` — the *preemption* event: running deferrable
      tasks whose node's regional intensity spiked above
      ``preempt_threshold`` are evicted (at most once per pod, never past
      their deadline), their ledger entries truncated at ``t``, and the
      pods requeued with a same-node restart block for the instant.
    * ``filter_pending`` — the *deferral* event: while the fleet-minimum
      intensity exceeds ``defer_threshold``, deferrable pods sit the
      round out, bounded by their deadline.
    * ``next_wake_time`` — CARBON_CHECK events at the policy cadence
      while pods defer or preemptable tasks run, and exactly at every
      held pod's deadline (a deferred pod never starts past it).

    One instance drives one run (it accumulates the once-per-pod
    preemption set); ``run_scenario`` constructs a fresh one per call.

    The carbon_rate criterion itself needs no hook here: the schedulers'
    incremental caches (``repro_torch.core.scheduler.FleetCriteriaCache``) cache
    the time-invariant power factor per node and refresh the intensity
    product whenever decision time moves — the column is never stale with
    respect to the signal, and eviction/requeue dirties the touched nodes
    through the FleetState mutators like any other capacity change.
    """

    def __init__(self, policy: CarbonPolicy):
        self.policy = policy
        self.preempted: set[int] = set()   # uids evicted once already
        self.fleet_regions: list[str] = []

    @property
    def carbon_signal(self) -> CarbonSignal:
        return self.policy.signal

    def bind(self, sim) -> None:
        self.fleet_regions = sorted({n.region for n in sim.state.nodes})

    def on_clock(self, sim, t: float) -> None:
        tel = telemetry.active()
        if tel.enabled:
            # observer-only: the grid-intensity timeline each region saw,
            # sampled at the clock instants the engine actually visited
            for region in self.fleet_regions:
                tel.record("carbon_intensity_g_per_kwh", t,
                           self.policy.signal.intensity(region, t),
                           region=region)

    def on_arrival(self, sim, pod, t: float) -> None:
        if pod.deferrable and not (math.isfinite(pod.deadline_s)
                                   and pod.deadline_s > 0.0):
            raise ValueError(
                f"deferrable pod {pod.uid} needs a finite positive "
                f"deadline_s, got {pod.deadline_s}")

    def _preemptable(self, sim, task, t: float) -> bool:
        """Still-running deferrable task, not yet preempted, deadline
        ahead — the class the preemption spike test applies to."""
        return (task.end_s > t and task.pod.deferrable
                and task.pod.uid not in self.preempted
                and t < sim.deadline(task.pod))

    def on_round_start(self, sim, t: float) -> None:
        pol = self.policy
        if pol.preempt_threshold is None:
            return
        st = sim.state
        victims = [task for task in st.running
                   if self._preemptable(sim, task, t)
                   and pol.signal.intensity(st.nodes[task.node_index].region,
                                            t) > pol.preempt_threshold]
        if not victims:
            return
        st.pending.extend(sim.evict(victims, t))
        for task in victims:
            self.preempted.add(task.uid)
            sim.block_restart(task.uid, task.node_index, t)
        st.preemptions += len(victims)
        telemetry.active().inc("policy_preemptions",
                               value=float(len(victims)),
                               policy=type(self).__name__)

    def filter_pending(self, sim, pods, t: float):
        pol = self.policy
        if not any(p.deferrable for p in pods):
            return []
        if pol.signal.fleet_min(self.fleet_regions, t) <= pol.defer_threshold:
            return []
        return [p for p in pods
                if p.deferrable and t < sim.deadline(p) - 1e-12]

    def next_wake_time(self, sim, t: float, held) -> Event | None:
        pol = self.policy
        cands = [sim.deadline(p) for p in held]
        if held:
            cands.append(t + pol.check_interval_s)
        if pol.preempt_threshold is not None and any(
                self._preemptable(sim, task, t)
                for task in sim.state.running):
            cands.append(t + pol.check_interval_s)
        cands = [c for c in cands if c > t]
        return Event.make(min(cands), CARBON_CHECK) if cands else None
