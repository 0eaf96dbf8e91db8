"""Flight recorder: structured telemetry for the scheduling engine.

The paper's headline claim — up to 39.1% energy savings "despite slight
scheduling latency" — is exactly the trade-off an operator must be able to
*see*: per-decision latency, why TOPSIS picked a node, where energy and
carbon went over time. This module is the substrate: a :class:`Telemetry`
registry of counters, gauges, histograms (fixed log-spaced buckets for
latencies), and nestable timed spans, consumed by the instrumented hot
layers (``cluster/engine.py``, ``core/scheduler.py``, ``core/energy.py``)
and exported by the reference's ``repro.telemetry.export`` (JSON snapshot,
Prometheus text exposition, Perfetto trace; not yet ported).

Design constraints (the pure-observer invariant):

* **Disabled costs ~nothing.** The module-level default is a
  :class:`NullTelemetry` whose methods are no-ops; instrumented code calls
  ``telemetry.active()`` and never branches on whether recording is on.
  Heavier rollups (per-node energy gauges) guard on ``tel.enabled``.
* **Enabled changes nothing.** Telemetry is write-only from the
  simulation's point of view: wall-clock times live only in telemetry
  output, never in sim state, so golden scenarios reproduce bitwise with
  recording on (tests/test_telemetry.py pins this across all three
  backends and the full policy matrix). The one wall-time quantity that
  predates telemetry — ``PodRecord.scheduling_time_s`` — is measured by
  the same :class:`Span` objects (a span times even when recording is
  off), so decision latency has exactly one code path.

Metric names follow Prometheus conventions (``[a-zA-Z_][a-zA-Z0-9_]*``,
labels as keyword arguments)::

    tel = telemetry.enable()
    tel.inc("engine_events", kind="arrival")
    tel.set_gauge("engine_pending_depth", 12)
    tel.record("engine_pending_depth", t_sim, 12)   # sim-time timeline
    with tel.span("scheduler_decision", backend="numpy") as sp:
        ...
    sp.duration_s            # wall seconds, also observed into the
                             # "scheduler_decision_seconds" histogram

Timelines (:class:`TimeSeries`, via :meth:`Telemetry.record`) are keyed on
the **simulation clock**, never wall time: the recorded values are sim
quantities (queue depths, fleet power, cumulative energy), so the same
scenario records bit-identical series on every backend, and recording one
can never perturb the run (tests/test_timeline.py pins both). Memory is
bounded per series by deterministic decimation (see :class:`TimeSeries`).
Because the sim clock restarts at zero each run, timelines describe **one
run**: the engine calls :meth:`Telemetry.clear_series` at run start, so a
registry shared across runs (table6's factorial) keeps the latest run's
series while counters / gauges / histograms keep aggregating.
"""
from __future__ import annotations

import math
import time
from contextlib import contextmanager

__all__ = [
    "Telemetry", "NullTelemetry", "Histogram", "Span", "TimeSeries",
    "log_buckets", "DEFAULT_LATENCY_BUCKETS", "DEFAULT_SERIES_MAX_POINTS",
    "active", "enable", "disable", "enabled", "NULL",
]


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds covering ``[lo, hi]`` with
    ``per_decade`` buckets per decade. The edges are exact powers
    ``10**(k / per_decade)`` so two registries configured alike always
    agree on bucket boundaries."""
    if not (0.0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    k0 = round(math.log10(lo) * per_decade)
    k1 = round(math.log10(hi) * per_decade)
    return tuple(10.0 ** (k / per_decade) for k in range(k0, k1 + 1))


# Decision latencies span ~1 us (a cached numpy row view) to seconds (a
# cold pallas interpret-mode dispatch): six decades, 4 buckets per decade.
DEFAULT_LATENCY_BUCKETS = log_buckets(1e-6, 10.0, per_decade=4)


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Histogram:
    """Fixed-bucket histogram: ``edges`` are ascending upper bounds, an
    observation lands in the first bucket whose edge is >= the value
    (Prometheus ``le`` semantics); values above the last edge land in the
    overflow (+Inf) bucket. ``counts`` has ``len(edges) + 1`` entries."""

    __slots__ = ("name", "labels", "edges", "counts", "sum", "count",
                 "min", "max")

    def __init__(self, name: str, labels: dict | None = None,
                 edges: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS):
        self.name = name
        self.labels = dict(labels or {})
        self.edges = tuple(edges)
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError(f"histogram edges must be strictly ascending, "
                             f"got {edges}")
        self.counts = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        lo, hi = 0, len(self.edges)
        while lo < hi:                      # first edge >= value
            mid = (lo + hi) // 2
            if self.edges[mid] < value:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1
        self.sum += value
        self.count += 1
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def cumulative(self) -> list[int]:
        """Cumulative counts per ``le`` edge plus the +Inf total — the
        Prometheus exposition shape."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def snapshot(self) -> dict:
        return {"name": self.name, "labels": dict(self.labels),
                "edges": list(self.edges), "counts": list(self.counts),
                "sum": self.sum, "count": self.count,
                "min": None if self.count == 0 else self.min,
                "max": None if self.count == 0 else self.max}


class Gauge:
    """Last-write-wins sample with running min/max/sample-count, so a
    sampled series (pending-queue depth at each clock advance) keeps its
    envelope without storing the series."""

    __slots__ = ("name", "labels", "value", "min", "max", "samples")

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.samples = 0

    def set(self, value: float) -> None:
        self.value = value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.samples += 1

    def snapshot(self) -> dict:
        return {"name": self.name, "labels": dict(self.labels),
                "value": self.value, "samples": self.samples,
                "min": None if self.samples == 0 else self.min,
                "max": None if self.samples == 0 else self.max}


# Default per-series point budget: plenty for an operator chart, small
# enough that a registry full of series stays a few hundred KB.
DEFAULT_SERIES_MAX_POINTS = 512


class TimeSeries:
    """A metric timeline keyed on the simulation clock.

    ``record(t, value)`` appends one sample; repeated samples at the same
    sim instant overwrite (rounds can repeat at one clock instant via the
    backoff step — last write wins), and time must never run backwards.

    Memory is bounded by **deterministic decimation**: whenever the stored
    points exceed ``max_points``, every other interior point is dropped
    (the first and the most recent point are always kept). The surviving
    points are a function of the append sequence alone — no randomness, no
    wall clock — so the same scenario decimates to the identical series on
    every backend, and the series endpoints are always exact."""

    __slots__ = ("name", "labels", "max_points", "samples", "_t", "_v")

    def __init__(self, name: str, labels: dict | None = None,
                 max_points: int = DEFAULT_SERIES_MAX_POINTS):
        if max_points < 4:
            raise ValueError(f"max_points must be >= 4, got {max_points}")
        self.name = name
        self.labels = dict(labels or {})
        self.max_points = max_points
        self.samples = 0            # total record() calls, pre-decimation
        self._t: list[float] = []
        self._v: list[float] = []

    def __len__(self) -> int:
        return len(self._t)

    def record(self, t: float, value: float) -> None:
        self.samples += 1
        if self._t:
            last = self._t[-1]
            if t < last:
                raise ValueError(
                    f"series {self.name!r}: sim time ran backwards "
                    f"({t} < {last})")
            if t == last:
                self._v[-1] = value
                return
        self._t.append(t)
        self._v.append(value)
        if len(self._t) > self.max_points:
            # drop every other interior point; keep index 0 and the last
            last_i = len(self._t) - 1
            keep = list(range(0, last_i, 2))
            if keep[-1] != last_i:
                keep.append(last_i)
            self._t = [self._t[i] for i in keep]
            self._v = [self._v[i] for i in keep]

    @property
    def times(self) -> tuple[float, ...]:
        return tuple(self._t)

    @property
    def values(self) -> tuple[float, ...]:
        return tuple(self._v)

    def points(self) -> list[tuple[float, float]]:
        return list(zip(self._t, self._v))

    def snapshot(self) -> dict:
        return {"name": self.name, "labels": dict(self.labels),
                "t": list(self._t), "values": list(self._v),
                "samples": self.samples, "max_points": self.max_points}


class Span:
    """One nestable timed span. A span *always* times (``duration_s`` is
    valid after the ``with`` block even under :class:`NullTelemetry`) —
    instrumented code reads the duration from here so wall-clock
    measurement has one code path — but it is only *recorded* (span log +
    ``<name>_seconds`` histogram) by an active :class:`Telemetry`."""

    __slots__ = ("name", "labels", "t0", "duration_s", "depth", "_tel")

    def __init__(self, tel: "NullTelemetry", name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.t0 = 0.0
        self.duration_s = 0.0
        self.depth = 0
        self._tel = tel

    def __enter__(self) -> "Span":
        self._tel._start_span(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.duration_s = time.perf_counter() - self.t0
        self._tel._finish_span(self)


class NullTelemetry:
    """The disabled default: every recording method is a no-op, ``span``
    still hands back a timing :class:`Span` (see there). ``enabled`` lets
    call sites skip building expensive rollups entirely."""

    enabled = False

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        pass

    def set_gauge(self, name: str, value: float, **labels) -> None:
        pass

    def observe(self, name: str, value: float, **labels) -> None:
        pass

    def record(self, name: str, t: float, value: float, **labels) -> None:
        pass

    def clear_series(self) -> None:
        pass

    def span(self, name: str, **labels) -> Span:
        return Span(self, name, labels)

    def _start_span(self, span: Span) -> None:
        pass

    def _finish_span(self, span: Span) -> None:
        pass


class Telemetry(NullTelemetry):
    """The live registry. One instance records one run (or any scope the
    caller wants); ``snapshot()`` is the JSON-ready view the exporters
    consume."""

    enabled = True

    def __init__(self,
                 latency_buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS,
                 series_max_points: int = DEFAULT_SERIES_MAX_POINTS):
        self.latency_buckets = tuple(latency_buckets)
        self.series_max_points = series_max_points
        self.counters: dict[tuple, list] = {}     # key -> [name, labels, val]
        self.gauges: dict[tuple, Gauge] = {}
        self.histograms: dict[tuple, Histogram] = {}
        self.timeseries: dict[tuple, TimeSeries] = {}
        self.spans: list[dict] = []               # completed spans, log order
        self._span_stack: list[Span] = []
        self._epoch = time.perf_counter()

    # --- counters / gauges / histograms --------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = (name, _labels_key(labels))
        cell = self.counters.get(key)
        if cell is None:
            self.counters[key] = [name, labels, value]
        else:
            cell[2] += value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = (name, _labels_key(labels))
        g = self.gauges.get(key)
        if g is None:
            g = self.gauges[key] = Gauge(name, labels)
        g.set(value)

    def observe(self, name: str, value: float, **labels) -> None:
        key = (name, _labels_key(labels))
        h = self.histograms.get(key)
        if h is None:
            h = self.histograms[key] = Histogram(name, labels,
                                                 self.latency_buckets)
        h.observe(value)

    def record(self, name: str, t: float, value: float, **labels) -> None:
        """Append one sim-time sample to the named :class:`TimeSeries`."""
        key = (name, _labels_key(labels))
        s = self.timeseries.get(key)
        if s is None:
            s = self.timeseries[key] = TimeSeries(name, labels,
                                                  self.series_max_points)
        s.record(t, value)

    def histogram(self, name: str, **labels) -> Histogram | None:
        """The named histogram cell (None if nothing observed yet)."""
        return self.histograms.get((name, _labels_key(labels)))

    def series(self, name: str, **labels) -> TimeSeries | None:
        """The named timeline cell (None if nothing recorded yet)."""
        return self.timeseries.get((name, _labels_key(labels)))

    def series_names(self) -> list[str]:
        """Sorted distinct timeline metric names."""
        return sorted({s.name for s in self.timeseries.values()})

    def clear_series(self) -> None:
        """Drop every timeline (the engine calls this at run start: the
        sim clock restarts at zero each run, so series never span runs —
        unlike counters/gauges/histograms, which keep aggregating)."""
        self.timeseries.clear()

    def counter_value(self, name: str, **labels) -> float:
        cell = self.counters.get((name, _labels_key(labels)))
        return cell[2] if cell is not None else 0.0

    # --- spans ---------------------------------------------------------------
    def span(self, name: str, **labels) -> Span:
        return Span(self, name, labels)

    def _start_span(self, span: Span) -> None:
        span.depth = len(self._span_stack)
        self._span_stack.append(span)

    def _finish_span(self, span: Span) -> None:
        if self._span_stack and self._span_stack[-1] is span:
            self._span_stack.pop()
        self.spans.append({"name": span.name, "labels": span.labels,
                           "start_s": span.t0 - self._epoch,
                           "duration_s": span.duration_s,
                           "depth": span.depth})
        self.observe(f"{span.name}_seconds", span.duration_s, **span.labels)

    # --- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-ready view of every metric (spans summarized by their
        histograms; the raw span log stays on ``self.spans``)."""
        return {
            "counters": [{"name": n, "labels": dict(lb), "value": v}
                         for n, lb, v in self.counters.values()],
            "gauges": [g.snapshot() for g in self.gauges.values()],
            "histograms": [h.snapshot() for h in self.histograms.values()],
            "series": [s.snapshot() for s in self.timeseries.values()],
            "spans": len(self.spans),
        }


# --- module-level active registry -------------------------------------------
NULL = NullTelemetry()
_active: NullTelemetry = NULL


def active() -> NullTelemetry:
    """The registry instrumented code records into — :data:`NULL` unless a
    caller enabled one."""
    return _active


def enable(tel: Telemetry | None = None) -> Telemetry:
    """Install ``tel`` (or a fresh :class:`Telemetry`) as the active
    registry and return it."""
    global _active
    _active = tel if tel is not None else Telemetry()
    return _active


def disable() -> NullTelemetry:
    """Back to the no-op default; returns the registry that was active."""
    global _active
    prev = _active
    _active = NULL
    return prev


@contextmanager
def enabled(tel: Telemetry | None = None):
    """``with telemetry.enabled() as tel:`` — record for one scope."""
    tel = enable(tel)
    try:
        yield tel
    finally:
        if _active is tel:
            disable()
