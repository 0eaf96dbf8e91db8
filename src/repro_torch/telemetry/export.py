"""Exporters: JSON snapshot, Prometheus text exposition, Perfetto trace —
port of ``repro.telemetry.export`` (a copy, imports rewritten).

Three operator-facing views of one run:

* :func:`json_snapshot` — the :class:`~repro_torch.core.telemetry.Telemetry`
  registry as a JSON-ready dict (counters, gauges, histograms, optionally
  the raw span log).
* :func:`prometheus_text` — the same registry in the Prometheus text
  exposition format (the format the ROADMAP's online-serving status
  surface will serve); :func:`parse_prometheus` is the matching reader,
  used by the round-trip tests and usable by any scraper-side tooling.
* :func:`perfetto_trace` — a whole simulation timeline
  (:class:`~repro_torch.cluster.engine.SimResult`) as Chrome trace-event JSON
  loadable in ``ui.perfetto.dev``: one track group per node carrying its
  task spans (one lane per concurrency level) and power-state intervals,
  plus one track per policy carrying its processed events as instants and
  counter tracks ("C" events) for the recorded power / queue / carbon
  series. :func:`validate_trace` checks the trace-event schema invariants
  the tests pin (known phases, sorted timestamps, matched B/E pairs per
  track, strictly increasing numeric counter samples).

Everything here reads sim state and telemetry; nothing writes back — the
exporters sit strictly on the observer side of the pure-observer
invariant.
"""
from __future__ import annotations

import json
import math
import re

_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Which policy track each kernel event kind belongs to (unknown kinds get
# a track of their own, so future policies' events surface unchanged).
_KIND_TRACKS = {
    "arrival": "kernel",
    "completion": "kernel",
    "carbon_check": "carbon",
    "wake_done": "autoscale",
    "consolidate_tick": "autoscale",
}


# --- JSON snapshot -----------------------------------------------------------
def json_snapshot(tel, include_spans: bool = False) -> dict:
    """The registry as a JSON-ready dict. ``include_spans`` appends the raw
    span log (name, labels, start offset, duration, nesting depth) — useful
    for debugging, omitted by default because it grows with the run."""
    out = tel.snapshot()
    if include_spans:
        out["span_log"] = list(tel.spans)
    return out


# --- Prometheus text exposition ----------------------------------------------
def _esc(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _labels_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"metric name {name!r} is not a valid Prometheus "
                         f"name ([a-zA-Z_][a-zA-Z0-9_]*)")
    return name


def _fmt(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    return repr(float(value))


def prometheus_text(tel) -> str:
    """The registry in the Prometheus text exposition format (version
    0.0.4): counters, gauges, and histograms with cumulative ``le``
    buckets plus ``_sum`` / ``_count`` series."""
    lines: list[str] = []
    seen_type: set[str] = set()

    def typeline(name: str, kind: str) -> None:
        if name not in seen_type:
            lines.append(f"# TYPE {_check_name(name)} {kind}")
            seen_type.add(name)

    for name, labels, value in tel.counters.values():
        typeline(name, "counter")
        lines.append(f"{name}{_labels_str(labels)} {_fmt(value)}")
    for g in tel.gauges.values():
        typeline(g.name, "gauge")
        lines.append(f"{g.name}{_labels_str(g.labels)} {_fmt(g.value)}")
    # gauge min/max/samples envelopes as companion families (each family
    # contiguous, per the exposition format's grouping rule)
    for suffix, attr in (("_min", "min"), ("_max", "max"),
                         ("_samples", "samples")):
        for g in tel.gauges.values():
            if not g.samples:
                continue
            typeline(f"{g.name}{suffix}", "gauge")
            lines.append(f"{g.name}{suffix}{_labels_str(g.labels)} "
                         f"{_fmt(getattr(g, attr))}")
    for h in tel.histograms.values():
        typeline(h.name, "histogram")
        ls = dict(h.labels)
        cum = h.cumulative()
        for edge, c in zip(h.edges, cum):
            lines.append(f"{h.name}_bucket"
                         f"{_labels_str({**ls, 'le': _fmt(edge)})} {c}")
        lines.append(f"{h.name}_bucket{_labels_str({**ls, 'le': '+Inf'})} "
                     f"{cum[-1]}")
        lines.append(f"{h.name}_sum{_labels_str(ls)} {_fmt(h.sum)}")
        lines.append(f"{h.name}_count{_labels_str(ls)} {h.count}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)'
    r'(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$')
_LABEL_RE = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)='
                       r'"(?P<v>(?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> dict:
    """Parse a text exposition back into ``{(name, ((k, v), ...)): value}``
    — the inverse of :func:`prometheus_text` (used by the round-trip tests;
    histogram series appear under their ``_bucket`` / ``_sum`` / ``_count``
    names)."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        labels = {}
        if m.group("labels"):
            for lm in _LABEL_RE.finditer(m.group("labels")):
                labels[lm.group("k")] = (lm.group("v")
                                         .replace(r'\"', '"')
                                         .replace(r'\n', "\n")
                                         .replace(r'\\', "\\"))
        raw = m.group("value")
        value = math.inf if raw == "+Inf" else (
            -math.inf if raw == "-Inf" else float(raw))
        out[(m.group("name"), tuple(sorted(labels.items())))] = value
    return out


# --- Perfetto / Chrome trace-event export ------------------------------------
def _assign_lanes(spans: list[tuple[float, float, object]]) -> list[int]:
    """Greedy interval partitioning: spans (start, end, payload) sorted by
    start are packed into the fewest lanes such that no lane's spans
    overlap — each lane then carries strictly sequential spans, so B/E
    pairs nest trivially."""
    lane_end: list[float] = []
    lanes: list[int] = []
    for start, end, _ in spans:
        for li, le in enumerate(lane_end):
            if le <= start:
                lane_end[li] = end
                lanes.append(li)
                break
        else:
            lane_end.append(end)
            lanes.append(len(lane_end) - 1)
    return lanes


def perfetto_trace(result, trace_name: str = "scenario", tel=None) -> dict:
    """A :class:`~repro_torch.cluster.engine.SimResult` as Chrome trace-event /
    Perfetto JSON (load at ``ui.perfetto.dev``).

    Layout: one process per node — thread 0 is its power-state track
    (IDLE / ASLEEP / WAKING intervals from the elastic state ledger, wake
    surges as instants), threads 1..L are task lanes (every record a B/E
    span named ``pod <uid> (<scheduler>)``, concurrency split across
    lanes so pairs always nest) — plus one "policies" process with one
    thread per policy track (kernel / carbon / autoscale) carrying the
    processed event log as instants, and one "counters" process whose "C"
    events render power / queue / carbon as Perfetto counter tracks.
    Counter values come from ``tel``'s recorded :class:`TimeSeries` when a
    telemetry registry is passed; otherwise the fleet power and carbon
    series are derived from the result's ledger, so every trace carries at
    least the power counter. Timestamps are simulation microseconds; the
    export never mutates the result."""
    timeline = result._timeline()
    node_names: set[str] = {r.node for r in result.records}
    node_names.update(iv.node for iv in timeline.state_intervals)
    node_names.update(w.node for w in timeline.wake_transitions)
    nodes = sorted(node_names)
    pid_of = {n: i + 1 for i, n in enumerate(nodes)}

    meta: list[dict] = []
    events: list[dict] = []

    def us(t: float) -> float:
        return t * 1e6

    def span(pid: int, tid: int, name: str, start: float, end: float,
             cat: str, args: dict | None = None) -> None:
        events.append({"ph": "B", "ts": us(start), "pid": pid, "tid": tid,
                       "name": name, "cat": cat, "args": args or {}})
        events.append({"ph": "E", "ts": us(end), "pid": pid, "tid": tid,
                       "name": name, "cat": cat})

    def instant(pid: int, tid: int, name: str, t: float, cat: str,
                args: dict | None = None) -> None:
        events.append({"ph": "i", "s": "t", "ts": us(t), "pid": pid,
                       "tid": tid, "name": name, "cat": cat,
                       "args": args or {}})

    for n in nodes:
        pid = pid_of[n]
        meta.append({"ph": "M", "pid": pid, "name": "process_name",
                     "args": {"name": f"node {n}"}})
        meta.append({"ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
                     "args": {"name": "power state"}})

    # task spans: one lane per concurrency level per node
    by_node: dict[str, list[tuple[float, float, object]]] = {}
    for r in result.records:
        if r.runtime_s > 0.0:
            by_node.setdefault(r.node, []).append(
                (r.start_s, r.start_s + r.runtime_s, r))
    for n, spans in by_node.items():
        spans.sort(key=lambda s: (s[0], s[1]))
        lanes = _assign_lanes(spans)
        for li in range(max(lanes) + 1):
            meta.append({"ph": "M", "pid": pid_of[n], "tid": 1 + li,
                         "name": "thread_name",
                         "args": {"name": f"tasks (lane {li})"}})
        for (start, end, r), li in zip(spans, lanes):
            span(pid_of[n], 1 + li, f"pod {r.pod.uid} ({r.pod.scheduler})",
                 start, end, "task",
                 {"energy_j": r.energy_j, "node_class": r.node_class,
                  "deferrable": r.pod.deferrable})

    # power-state intervals + wake surges on each node's power track
    for iv in timeline.state_intervals:
        span(pid_of[iv.node], 0, iv.state, iv.start_s, iv.end_s, "state",
             {"power_w": iv.power_w})
    for w in timeline.wake_transitions:
        instant(pid_of[w.node], 0, "wake surge", w.t_s, "state",
                {"energy_j": w.energy_j})

    # one track per policy carrying its processed events
    pol_pid = len(nodes) + 1
    meta.append({"ph": "M", "pid": pol_pid, "name": "process_name",
                 "args": {"name": "policies"}})
    tracks: dict[str, int] = {}
    for t, kind, payload in (result.events or []):
        track = _KIND_TRACKS.get(kind, kind)
        tid = tracks.get(track)
        if tid is None:
            tid = tracks[track] = len(tracks)
            meta.append({"ph": "M", "pid": pol_pid, "tid": tid,
                         "name": "thread_name", "args": {"name": track}})
        instant(pol_pid, tid, kind, t, "event",
                {} if payload is None else {"payload": payload})

    # counter tracks ("C" events): one per recorded series (or the
    # ledger-derived power/carbon series when no registry is passed)
    cnt_pid = len(nodes) + 2
    counter_series: list[tuple[str, list[tuple[float, float]]]] = []
    if tel is not None and getattr(tel, "timeseries", None):
        for s in tel.timeseries.values():
            name = s.name + _labels_str(s.labels)
            counter_series.append((name, s.points()))
    else:
        edges, watts = timeline.power_series(None)
        if len(edges):
            pts = [(float(t), float(w))
                   for t, w in zip(edges[:-1], watts)]
            pts.append((float(edges[-1]), float(watts[-1])))
            counter_series.append(("fleet_power_w", pts))
        if timeline.carbon_signal is not None:
            c_edges, grams = timeline.carbon_series(None)
            if len(c_edges):
                counter_series.append(
                    ("fleet_carbon_cum_g",
                     [(float(t), float(g))
                      for t, g in zip(c_edges, grams)]))
    if counter_series:
        meta.append({"ph": "M", "pid": cnt_pid, "name": "process_name",
                     "args": {"name": "counters"}})
        for name, pts in counter_series:
            for t, v in pts:
                events.append({"ph": "C", "ts": us(t), "pid": cnt_pid,
                               "tid": 0, "name": name, "cat": "counter",
                               "args": {"value": float(v)}})

    # sorted timestamps; at equal instants close spans before opening the
    # next one so back-to-back B/E pairs on a lane stay matched
    events.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "E" else 1))
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": {"name": trace_name}}


def write_perfetto(result, path, trace_name: str = "scenario",
                   tel=None) -> str:
    """Write :func:`perfetto_trace` JSON to ``path`` (conventionally
    ``*.trace.json``); returns the path."""
    trace = perfetto_trace(result, trace_name=trace_name, tel=tel)
    with open(path, "w") as f:
        json.dump(trace, f)
    return str(path)


_PHASES = frozenset("BEiMC")


def validate_trace(trace) -> dict:
    """Check the trace-event schema invariants: known phases, numeric
    non-negative timestamps, timestamps sorted over the non-metadata
    stream, per (pid, tid) track B/E pairs that match like parentheses
    with equal names and are all closed at the end, and — per
    (pid, tid, name) counter track — "C" events carrying a non-empty dict
    of finite numeric args with strictly increasing timestamps. Raises
    ``ValueError`` on the first violation; returns summary counts."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    last_ts = -math.inf
    stacks: dict[tuple, list] = {}
    counter_ts: dict[tuple, float] = {}
    n_spans = n_instants = n_counters = 0
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in _PHASES:
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or not math.isfinite(ts) \
                or ts < 0.0:
            raise ValueError(f"event {i}: bad ts {ts!r}")
        if ts < last_ts:
            raise ValueError(f"event {i}: ts {ts} < previous {last_ts} "
                             f"(trace not sorted)")
        last_ts = ts
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append(ev)
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                raise ValueError(f"event {i}: E with no open B on track "
                                 f"{key}")
            b = stack.pop()
            if b.get("name") != ev.get("name"):
                raise ValueError(
                    f"event {i}: E name {ev.get('name')!r} does not match "
                    f"open B name {b.get('name')!r} on track {key}")
            n_spans += 1
        elif ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                raise ValueError(f"event {i}: counter with no args")
            for k, v in args.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)) \
                        or not math.isfinite(v):
                    raise ValueError(f"event {i}: counter arg {k}={v!r} "
                                     f"is not a finite number")
            track = (ev.get("pid"), ev.get("tid"), ev.get("name"))
            prev = counter_ts.get(track)
            if prev is not None and ts <= prev:
                raise ValueError(
                    f"event {i}: counter track {track} ts {ts} <= "
                    f"previous {prev} (must be strictly increasing)")
            counter_ts[track] = ts
            n_counters += 1
        else:
            n_instants += 1
    open_tracks = {k: len(v) for k, v in stacks.items() if v}
    if open_tracks:
        raise ValueError(f"unclosed B events at end of trace: {open_tracks}")
    return {"events": len(events), "spans": n_spans,
            "instants": n_instants, "counters": n_counters,
            "tracks": len(stacks)}
