"""Cross-run benchmark regression gating — port of
``repro.telemetry.baseline`` (a copy).

A recorded ``BENCH_*.json`` (see ``benchmarks/``) is a list of result
cells — one dict per swept configuration, mixing identity keys (profile,
backend, n_nodes, ...) with measured metrics (timings, energies, carbon).
:func:`compare_reports` diffs a freshly produced report cell-by-cell
against a committed baseline under per-metric relative thresholds and
returns a verdict dict; ``benchmarks/run.py --check`` drives it and exits
nonzero on any regression.

Metric kinds:

* ``timing`` — wall-clock measurements, inherently noisy and one-sided:
  only a slowdown beyond the threshold trips (default +75% relative);
  a comparable speedup is flagged ``improved`` (informational). Timing
  comparisons are **provenance-aware**: a pallas cell measured in
  interpret mode is never compared against a compiled baseline (and vice
  versa), and a report whose ``jax_platform`` differs from the baseline's
  skips timing metrics entirely — those numbers describe different
  machines.
* ``exact`` — deterministic simulation outputs (energy kJ, carbon g,
  counts). Any relative drift beyond 1e-6 trips, in either direction:
  the simulator is bitwise-reproducible, so a "better" energy number in
  a bench sweep still means the physics changed.

Unknown float-valued cell keys are never silently dropped: they are
excluded from cell identity and listed in the verdict's
``unchecked_metrics`` so a new metric gets a threshold assigned instead
of drifting unwatched. Cells present on only one side land in
``missing_in_current`` / ``missing_in_baseline`` (warnings, not
failures — sweep grids legitimately grow).

:func:`append_history` / :func:`history_entries` maintain the
``benchmarks/history/`` JSONL trajectory: one line per recorded sweep or
check verdict, so the bench history is a queryable series rather than a
single overwritten snapshot.
"""
from __future__ import annotations

import json
import os

TIMING_DEFAULT_REL = 0.75      # one-sided: trips when >75% slower
EXACT_DEFAULT_REL = 1e-6       # two-sided drift bound

# metric name -> (kind, relative threshold); every measured key in the
# four BENCH_*.json shapes appears here, so anything numeric that doesn't
# is surfaced as unchecked rather than silently compared or dropped
METRICS: dict[str, tuple[str, float]] = {
    # BENCH_scheduling.json
    "ms_total": ("timing", TIMING_DEFAULT_REL),
    "us_per_pod": ("timing", TIMING_DEFAULT_REL),
    # BENCH_scenarios.json
    "energy_topsis_kj": ("exact", EXACT_DEFAULT_REL),
    "energy_default_kj": ("exact", EXACT_DEFAULT_REL),
    "dyn_energy_topsis_j": ("exact", EXACT_DEFAULT_REL),
    "idle_energy_topsis_j": ("exact", EXACT_DEFAULT_REL),
    "unschedulable_rate": ("exact", EXACT_DEFAULT_REL),
    "energy_series_points": ("exact", EXACT_DEFAULT_REL),
    "mean_sched_time_topsis_ms": ("timing", TIMING_DEFAULT_REL),
    "mean_sched_time_default_ms": ("timing", TIMING_DEFAULT_REL),
    # BENCH_carbon.json
    "carbon_topsis_g": ("exact", EXACT_DEFAULT_REL),
    "carbon_default_g": ("exact", EXACT_DEFAULT_REL),
    "carbon_series_points": ("exact", EXACT_DEFAULT_REL),
    "mean_deferral_latency_s": ("exact", EXACT_DEFAULT_REL),
    "preemptions": ("exact", EXACT_DEFAULT_REL),
    # BENCH_autoscale.json
    "fleet_energy_kj": ("exact", EXACT_DEFAULT_REL),
    "fleet_idle_energy_kj": ("exact", EXACT_DEFAULT_REL),
    "fleet_carbon_g": ("exact", EXACT_DEFAULT_REL),
    "horizon_s": ("exact", EXACT_DEFAULT_REL),
    "mean_start_delay_s": ("exact", EXACT_DEFAULT_REL),
    "mean_exec_time_topsis_s": ("exact", EXACT_DEFAULT_REL),
    "migrations": ("exact", EXACT_DEFAULT_REL),
    "sleeps": ("exact", EXACT_DEFAULT_REL),
    "wakes": ("exact", EXACT_DEFAULT_REL),
    # BENCH_pareto.json — timings one-sided; frontier membership is
    # backend-independent float64 arithmetic, gated exactly
    "ms_fused": ("timing", TIMING_DEFAULT_REL),
    "ms_serial": ("timing", TIMING_DEFAULT_REL),
    "us_per_scheme_fused": ("timing", TIMING_DEFAULT_REL),
    "frontier_size": ("exact", EXACT_DEFAULT_REL),
    "frontier_checksum": ("exact", EXACT_DEFAULT_REL),
}

# per-cell annotations that are neither identity nor gated metrics
IGNORED_KEYS = frozenset({
    "interpret_mode",              # provenance flag, consumed by gating
    "speedup_vs_rebuild",          # derived ratio of two timings
    "speedup_fused_vs_serial",     # derived ratio of two timings
    "max_closeness_err_vs_numpy",  # pinned by its own sweep tolerance
})


def cell_key(cell: dict) -> tuple:
    """A cell's identity: its non-metric, non-ignored keys — the swept
    configuration axes. Float-valued unknowns are excluded (they are
    almost certainly unregistered metrics, and float identity would make
    every comparison a miss)."""
    return tuple(sorted(
        (k, v) for k, v in cell.items()
        if k not in METRICS and k not in IGNORED_KEYS
        and not isinstance(v, float)))


def _unknown_metrics(cell: dict) -> list[str]:
    return [k for k, v in cell.items()
            if k not in METRICS and k not in IGNORED_KEYS
            and isinstance(v, float)]


def _fmt_key(key: tuple) -> str:
    return "/".join(f"{k}={v}" for k, v in key)


def _interpret_flag(cell: dict, provenance: dict) -> bool:
    """Effective interpret-mode flag for a cell's timing metrics: the
    per-cell annotation when present, else the report-level pallas flag
    for pallas cells (non-pallas backends always compile)."""
    if "interpret_mode" in cell:
        return bool(cell["interpret_mode"])
    if cell.get("backend") == "pallas":
        return bool(provenance.get("pallas_interpret", False))
    return False


def compare_reports(current: dict, baseline: dict,
                    thresholds: dict | None = None) -> dict:
    """Diff a fresh benchmark report against a baseline.

    Both arguments are parsed BENCH_*.json dicts (``results`` list plus
    optional ``provenance``). ``thresholds`` overrides per-metric
    relative thresholds by name. Returns the verdict dict described in
    the module docstring; ``verdict["status"]`` is ``"regression"`` iff
    at least one gated metric tripped."""
    cur_prov = current.get("provenance") or {}
    base_prov = baseline.get("provenance") or {}
    platform_gate = None
    if (cur_prov.get("jax_platform") and base_prov.get("jax_platform")
            and cur_prov["jax_platform"] != base_prov["jax_platform"]):
        platform_gate = (f"jax_platform {cur_prov['jax_platform']} != "
                         f"baseline {base_prov['jax_platform']}")

    cur_cells = {cell_key(c): c for c in current.get("results") or []}
    base_cells = {cell_key(c): c for c in baseline.get("results") or []}
    rows: list[dict] = []
    unchecked: set[str] = set()
    regressions = 0
    for key in sorted(cur_cells, key=_fmt_key):
        cur = cur_cells[key]
        unchecked.update(_unknown_metrics(cur))
        base = base_cells.get(key)
        if base is None:
            continue
        interp_skip = None
        cur_flag = _interpret_flag(cur, cur_prov)
        base_flag = _interpret_flag(base, base_prov)
        if cur_flag != base_flag:
            interp_skip = (f"interpret_mode {cur_flag} vs baseline "
                           f"{base_flag}")
        for metric, (kind, default_rel) in METRICS.items():
            if metric not in cur or metric not in base:
                continue
            thr = (thresholds or {}).get(metric, default_rel)
            cv, bv = float(cur[metric]), float(base[metric])
            rel = (cv - bv) / max(abs(bv), 1e-12)
            row = {"cell": _fmt_key(key), "metric": metric,
                   "current": cv, "baseline": bv, "rel_delta": rel,
                   "threshold": thr, "kind": kind, "status": "ok",
                   "reason": None}
            if kind == "timing" and platform_gate:
                row["status"], row["reason"] = "skipped", platform_gate
            elif kind == "timing" and interp_skip:
                row["status"], row["reason"] = "skipped", interp_skip
            elif kind == "timing":
                if rel > thr:
                    row["status"] = "regression"
                elif rel < -thr:
                    row["status"] = "improved"
            else:
                if abs(rel) > thr:
                    row["status"] = "regression"
            if row["status"] == "regression":
                regressions += 1
            rows.append(row)
    return {
        "bench": current.get("bench") or baseline.get("bench"),
        "status": "regression" if regressions else "pass",
        "regressions": regressions,
        "rows": rows,
        "missing_in_current": sorted(
            _fmt_key(k) for k in base_cells.keys() - cur_cells.keys()),
        "missing_in_baseline": sorted(
            _fmt_key(k) for k in cur_cells.keys() - base_cells.keys()),
        "unchecked_metrics": sorted(unchecked),
    }


def format_verdict(verdict: dict, verbose: bool = False) -> str:
    """Human-readable verdict: one headline, then every non-ok row (all
    rows with ``verbose``)."""
    counts: dict[str, int] = {}
    for row in verdict["rows"]:
        counts[row["status"]] = counts.get(row["status"], 0) + 1
    head = (f"[{verdict['status'].upper()}] {verdict['bench']}: "
            + ", ".join(f"{n} {s}" for s, n in sorted(counts.items()))
            if verdict["rows"] else
            f"[{verdict['status'].upper()}] {verdict['bench']}: "
            f"no comparable cells")
    lines = [head]
    for row in verdict["rows"]:
        if row["status"] == "ok" and not verbose:
            continue
        lines.append(
            f"  {row['status']:>10}  {row['cell']} {row['metric']}: "
            f"{row['current']:.6g} vs {row['baseline']:.6g} "
            f"({row['rel_delta']:+.2%}, limit {row['threshold']:g})"
            + (f" [{row['reason']}]" if row["reason"] else ""))
    for name, keys in (("missing_in_current",
                        verdict["missing_in_current"]),
                       ("missing_in_baseline",
                        verdict["missing_in_baseline"])):
        if keys:
            lines.append(f"  note: {len(keys)} cell(s) {name}")
    if verdict["unchecked_metrics"]:
        lines.append("  note: unchecked metrics (no threshold "
                     "registered): "
                     + ", ".join(verdict["unchecked_metrics"]))
    return "\n".join(lines)


# --- benchmark history (JSONL trajectory) ------------------------------------
def append_history(entry: dict, path) -> str:
    """Append one JSON line to the history file at ``path`` (parent
    directories created); returns the path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(entry, sort_keys=True) + "\n")
    return str(path)


def history_entries(path) -> list[dict]:
    """Parse a history JSONL back into a list of dicts (missing file is
    an empty history; malformed lines raise)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
