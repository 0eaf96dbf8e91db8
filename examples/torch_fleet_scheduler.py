"""Beyond-paper, on the PyTorch port: GreenPod TOPSIS as the placement
engine of a GPU fleet, and the scheduler's fleet-scale layers on the card.
The port's counterpart of ``examples/fleet_scheduler.py``, section by
section, with the cuda backend where the reference takes jax:

- dry-run records (``repro_torch.launch.dryrun``) as jobs placed on a fleet
  of L4, A100 and H100 slices (the port's ``fleet.GENERATIONS``), and a
  straggler's re-placement;
- ``BatchScheduler.select_many`` over 64 pods x 2,048 nodes on numpy and on
  the card (an unattached NodeTable: the full-rebuild round, kernel K2);
- event-driven, carbon-aware and autoscaled scenarios whose batch rounds
  and wake scorings run kernel K3;
- the telemetry flight recorder and its Perfetto trace, per-criterion
  attribution (``explain``, numpy), the operator HTML report and the
  benchmark regression gate;
- a 512-scheme Pareto frontier in two carbon regimes (kernel K4).

Files (the trace and the two reports) go to ``--out-dir``, by default a
fresh temporary directory.

Run: PYTHONPATH=src python examples/torch_fleet_scheduler.py [dryrun_dir]
         [--device cpu] [--out-dir DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

from repro_torch.cluster.node import make_fleet, make_scenario_cluster
from repro_torch.cluster.simulator import run_scenario
from repro_torch.cluster.workload import WORKLOADS, Pod, PoissonArrivals
from repro_torch.core import pareto, telemetry
from repro_torch.core.carbon import (CarbonPolicy, ConstantCarbon,
                                     diurnal_fleet_signal)
from repro_torch.core.elastic import AutoscalePolicy, always_on_fleet_idle_kj
from repro_torch.core.scheduler import BACKENDS, BatchScheduler
from repro_torch.device import resolve_device
from repro_torch.launch import fleet
from repro_torch.telemetry.baseline import compare_reports, format_verdict
from repro_torch.telemetry.export import write_perfetto
from repro_torch.telemetry.report import write_html_report

N_NODES, N_PODS = 2048, 64
SCENARIO_NODES = 64
FRONTIER_SCHEMES, FRONTIER_PODS, FRONTIER_NODES = 512, 24, 128
# the reference's demo jobs, placed when no dry-run records are found
DEMO_JOBS = [("llama3-8b", "train_4k", 256, 1.5, 12.0, 8.0, 8e9),
             ("gemma-7b", "prefill_32k", 256, 0.6, 3.5, 1.7, 8e9),
             ("rwkv6-1.6b", "decode_32k", 256, 1e-5, 1e-3, 4e-4, 1e9)]


def new_fleet():
    """The reference's five slices on the port's GPU generations: its
    frugal class (v5e) as L4, its balanced one (v4) as A100, its fast and
    hungry one (v5p) as H100."""
    return [fleet.Slice("l4-0", 256, 256, "l4"),
            fleet.Slice("l4-1", 256, 256, "l4"),
            fleet.Slice("a100-0", 256, 256, "a100"),
            fleet.Slice("h100-0", 256, 256, "h100"),
            fleet.Slice("h100-1", 512, 512, "h100")]


def queue_of(n):
    return [Pod(i, WORKLOADS[("light", "medium", "complex")[i % 3]],
                "topsis") for i in range(n)]


def scenario_numbers(res, carbon=False):
    """What the scenario sections compare between backends (the carbon
    where the run had a signal)."""
    return {"energy_kj": res.energy_kj("topsis"),
            "default_energy_kj": res.energy_kj("default"),
            "carbon_g": res.total_carbon_g("topsis") if carbon else None,
            "wakes": res.wakes, "sleeps": res.sleeps,
            "migrations": res.migrations, "preemptions": res.preemptions,
            "placements": sorted((r.pod.uid, r.pod.scheduler, r.node,
                                  r.start_s) for r in res.records)}


def main(argv=None, *, scenario=None, batch_scheduler=BatchScheduler
         ) -> dict:
    """The tour; returns its numbers by section. ``scenario(name)`` gives
    a context manager entered around each named ``run_scenario`` call;
    ``batch_scheduler`` is the class the one-shot queue and the frontier
    score with (a subclass that records its calls, say)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dryrun_dir", nargs="?", default="experiments/dryrun")
    ap.add_argument("--backend", default="cuda", choices=BACKENDS,
                    help="the batch rounds' and the frontier's backend")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out-dir", default=None,
                    help="where the trace and the reports go (default: a "
                         "fresh temporary directory)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    backend = args.backend
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="fleet_scheduler_")
    os.makedirs(out_dir, exist_ok=True)
    scenario = scenario or (lambda name: contextlib.nullcontext())
    out = {"device": str(dev), "backend": backend, "out_dir": out_dir}

    def run(name, arrivals, scheme, cluster_factory, **kw):
        kw.setdefault("batch_backend", backend)
        with scenario(name):
            return run_scenario(arrivals, scheme,
                                cluster_factory=cluster_factory, batch=True,
                                device=dev, **kw)

    # --- jobs on the GPU fleet ----------------------------------------------
    jobs = fleet.load_jobs(args.dryrun_dir)
    if not jobs:
        # standalone demo jobs if no dry-run artifacts exist yet
        jobs = [fleet.Job(*j) for j in DEMO_JOBS]
    print(f"{len(jobs)} jobs loaded from {args.dryrun_dir}")
    out["jobs"] = len(jobs)
    out["placements"] = {}
    for scheme in ("energy_centric", "performance_centric"):
        slices = new_fleet()
        placed = fleet.schedule_queue(jobs[:5], slices, scheme)
        print(f"\n--- scheme: {scheme}")
        rows = []
        for job, idx in placed:
            where = slices[idx].name if idx is not None else "UNSCHEDULABLE"
            step, energy = (fleet.job_on_slice(job, slices[idx])
                            if idx is not None
                            else (float("nan"), float("nan")))
            print(f"  {job.arch:22s} {job.shape:12s} -> {where:8s} "
                  f"step={step:9.3e}s energy={energy / 1e3:9.2f} kJ")
            rows.append((job.arch, job.shape, where, step, energy))
        out["placements"][scheme] = rows

    # --- straggler mitigation -------------------------------------------------
    slices = new_fleet()
    job = jobs[0]
    cur, _ = fleet.place(job, slices, "energy_centric")
    print(f"\njob {job.arch}/{job.shape} initially on {slices[cur].name}")
    new = fleet.replace_slice(job, slices, cur, "energy_centric")
    print(f"straggler alert -> degraded {slices[cur].name} (health "
          f"{slices[cur].health:.1f}x), re-placed on {slices[new].name}")
    out["straggler"] = (slices[cur].name, slices[new].name)

    # --- fleet-scale batched scheduling -----------------------------------------
    # one TOPSIS pass scores the whole queue against thousands of nodes; an
    # unattached NodeTable takes the full-rebuild round (K2 on the card)
    table = make_fleet(N_NODES, seed=0, utilization=0.3)
    queue = queue_of(N_PODS)
    print(f"\n--- batched fleet scheduling: {N_PODS} pods x {N_NODES} nodes")
    out["select_many"] = {}
    for b in dict.fromkeys(("numpy", backend)):
        sched = batch_scheduler("energy_centric", backend=b, device=dev)
        sched.select_many(queue, table)            # warm up
        t0 = time.perf_counter()
        assignments, diag = sched.select_many(queue, table)
        dt = time.perf_counter() - t0
        placed = sum(a is not None for a in assignments)
        print(f"  {b:6s}: {placed}/{N_PODS} placed in {dt * 1e3:7.2f} ms "
              f"({diag['per_pod_time_s'] * 1e6:.0f} us/pod)")
        out["select_many"][b] = {"placed": placed, "ms": dt * 1e3,
                                 "assignments": list(assignments)}

    # --- event-driven scenario: Poisson bursts, time-resolved energy ------------
    arrivals = PoissonArrivals(rate_per_s=0.2, n_bursts=6, burst_size=12,
                               seed=0)
    res = run("event", arrivals, "energy_centric",
              lambda: make_scenario_cluster("edge_heavy", SCENARIO_NODES,
                                            seed=0))
    print(f"\n--- event-driven scenario: {arrivals.total_pods()} pods in "
          f"{arrivals.n_bursts} Poisson bursts on {SCENARIO_NODES} "
          f"edge-heavy nodes")
    summary = res.summary()
    sched_stats = summary["schedulers"]
    print(f"  unschedulable rate: {summary['unschedulable_rate']:.3f}   "
          f"TOPSIS {sched_stats['topsis']['energy_kj']:.2f} kJ vs "
          f"default {sched_stats['default']['energy_kj']:.2f} kJ")
    print(f"  TOPSIS per-pod mean: "
          f"{sched_stats['topsis']['mean_energy_kj']:.3f} kJ, "
          f"{sched_stats['topsis']['mean_sched_time_ms']:.2f} ms/decision, "
          f"allocation {sched_stats['topsis']['allocation']}")
    edges, joules = res.energy_series("topsis")
    for k in range(0, len(edges), max(1, len(edges) // 6)):
        print(f"  t={edges[k]:8.1f}s  cumulative TOPSIS energy "
              f"{joules[k] / 1e3:7.3f} kJ")
    out["scenarios"] = {"event": dict(
        scenario_numbers(res),
        unschedulable_rate=summary["unschedulable_rate"])}

    # --- carbon-aware scheduling: grid signals, deferral, preemption ------------
    period = 1800.0
    signal = diurnal_fleet_signal(base=300.0, amplitude=200.0,
                                  period_s=period, phase_s=period / 4.0,
                                  stagger_s=period / 16.0)
    policy = CarbonPolicy(signal, defer_threshold=300.0,
                          preempt_threshold=450.0, check_interval_s=30.0)

    def carbon_arrivals():
        return PoissonArrivals(rate_per_s=0.2, n_bursts=6, burst_size=12,
                               seed=0, deferrable_share=0.5,
                               deadline_s=period / 2.0)

    def mixed_fleet():
        return make_scenario_cluster("mixed", SCENARIO_NODES, seed=0)

    print(f"\n--- carbon-aware scenario: staggered diurnal signal on "
          f"{SCENARIO_NODES} mixed nodes")
    for scheme in ("energy_centric", "carbon_centric"):
        res = run(f"carbon_{scheme}", carbon_arrivals(), scheme, mixed_fleet,
                  carbon=policy)
        print(f"  {scheme:22s}: {res.energy_kj('topsis'):6.2f} kJ  "
              f"{res.total_carbon_g('topsis'):6.3f} gCO2  "
              f"defer {res.mean_deferral_latency_s('topsis'):5.1f}s  "
              f"preemptions {res.preemptions}")
        out["scenarios"][f"carbon_{scheme}"] = dict(
            scenario_numbers(res, carbon=True),
            defer_s=res.mean_deferral_latency_s("topsis"))
    edges, grams = res.carbon_series("topsis")
    for k in range(0, len(edges), max(1, len(edges) // 4)):
        print(f"  t={edges[k]:8.1f}s  cumulative TOPSIS carbon "
              f"{grams[k]:7.4f} g")

    # --- elastic fleet: idle-timeout sleep + TOPSIS-driven consolidation --------
    def elastic_arrivals():
        return PoissonArrivals(rate_per_s=0.2, n_bursts=6, burst_size=12,
                               seed=0)

    print(f"\n--- elastic fleet: idle-timeout + consolidation on "
          f"{SCENARIO_NODES} mixed nodes")
    idle, names = {}, {}
    for key, name, pol in (
            ("always_on", "no policy (always-on)", None),
            ("idle_timeout", "idle-timeout 60s",
             AutoscalePolicy(idle_timeout_s=60.0)),
            ("consolidation", "+ consolidation",
             AutoscalePolicy(idle_timeout_s=60.0,
                             consolidate_interval_s=30.0,
                             consolidate_util_below=0.3))):
        res = run(f"elastic_{key}", elastic_arrivals(), "energy_centric",
                  mixed_fleet, autoscale=pol)
        horizon = max(r.start_s + r.runtime_s for r in res.records)
        if pol is None:
            # lifecycle-free engine: every node draws idle power all run long
            idle_kj = always_on_fleet_idle_kj(mixed_fleet(), horizon)
        else:
            idle_kj = res.fleet_idle_energy_kj()
        idle[key], names[key] = idle_kj, name
        print(f"  {name:22s}: fleet idle {idle_kj:7.2f} kJ  "
              f"wakes {res.wakes:2d}  sleeps {res.sleeps:2d}  "
              f"migrations {res.migrations:2d}")
        out["scenarios"][f"elastic_{key}"] = dict(scenario_numbers(res),
                                                  idle_kj=idle_kj)
    for key in ("idle_timeout", "consolidation"):
        print(f"  {names[key]:22s}: "
              f"{100.0 * (1.0 - idle[key] / idle['always_on']):.1f}% less "
              f"fleet idle energy than the always-on baseline")

    # --- flight recorder: telemetry, decision latency, Perfetto trace -----------
    with telemetry.enabled() as tel:
        res = run("recorder", carbon_arrivals(), "carbon_centric",
                  mixed_fleet, carbon=policy,
                  autoscale=AutoscalePolicy(idle_timeout_s=60.0))
    print("\n--- flight recorder: carbon+autoscale scenario, telemetry on")
    events = {k: int(tel.counter_value("engine_events", kind=k))
              for k in ("arrival", "completion", "carbon_check", "wake_done")}
    print("  events: " + "  ".join(f"{k}={v}" for k, v in events.items()))
    rounds = len([s for s in tel.spans if s["name"] == "engine_round"])
    holds = int(tel.counter_value("policy_deferred_pods",
                                  policy="CarbonScheduling"))
    wakes = int(tel.counter_value("policy_node_wakes",
                                  policy="AutoscaleScheduling"))
    print(f"  rounds {rounds}  deferral holds {holds}  wakes {wakes}")
    hist = tel.histogram("scheduler_batch_seconds", scheduler="topsis-batch",
                         backend=backend)
    if hist is not None:
        print(f"  batch decision latency ({hist.count} rounds, "
              f"min {hist.min * 1e3:.2f} ms, max {hist.max * 1e3:.2f} ms):")
        for edge, c in zip(hist.edges, hist.counts):
            if c:
                print(f"    le {edge * 1e3:9.3f} ms : {'#' * c} {c}")
    trace_path = write_perfetto(
        res, os.path.join(out_dir, "fleet_scheduler.trace.json"),
        trace_name="carbon+autoscale demo")
    print(f"  wrote {trace_path} — open at https://ui.perfetto.dev")
    out["scenarios"]["recorder"] = scenario_numbers(res, carbon=True)
    out["recorder"] = {"events": events, "rounds": rounds, "holds": holds,
                       "wakes": wakes,
                       "batch_rounds": hist.count if hist else 0,
                       "trace": str(trace_path)}

    # --- why TOPSIS picked that node: per-criterion attribution -----------------
    # explain=True (numpy scoring, as in the reference) records, per
    # decision, how each criterion moved the winner-vs-runner-up gap
    res = run("explain", elastic_arrivals(), "energy_centric", mixed_fleet,
              batch_backend="numpy", explain=True)
    exp = max((e for e in res.explanations if e["runner_up"] is not None),
              key=lambda e: abs(e["gap"]))
    print(f"\n--- decision explainability: pod {exp['pod']} -> "
          f"{exp['node']} (runner-up {exp['runner_up_node']}, "
          f"gap {exp['gap']:+.4f} closeness)")
    for c in sorted(exp["contributions"], key=lambda c: -abs(c["delta_cc"])):
        print(f"  {c['criterion']:16s} delta_cc {c['delta_cc']:+.4f}   "
              f"winner {c['winner_value']:10.4f}  vs  "
              f"runner-up {c['runner_up_value']:10.4f}")
    out["explain"] = {"pod": exp["pod"], "node": exp["node"],
                      "runner_up": exp["runner_up_node"], "gap": exp["gap"],
                      "deltas": {c["criterion"]: c["delta_cc"]
                                 for c in exp["contributions"]}}

    # --- operator HTML report + benchmark regression gate -----------------------
    with telemetry.enabled() as tel:
        res = run("report", elastic_arrivals(), "energy_centric",
                  mixed_fleet, batch_backend="numpy", explain=True)
    report_path = write_html_report(
        os.path.join(out_dir, "fleet_scheduler_report.html"), tel=tel,
        result=res, title="fleet scheduler demo")
    print(f"\n--- operator report: wrote {report_path} "
          f"({len(tel.timeseries)} series charted) — open in a browser")
    out["report"] = {"path": str(report_path),
                     "series": len(tel.timeseries)}

    cells = [{"profile": "mixed", "n_nodes": 8, "backend": "numpy",
              "energy_topsis_kj": 10.0, "mean_sched_time_topsis_ms": 5.0}]
    baseline = {"bench": "demo_sweep", "results": cells}
    drifted = {"bench": "demo_sweep",
               "results": [dict(cells[0], energy_topsis_kj=10.4,
                                mean_sched_time_topsis_ms=6.0)]}
    print("\n--- regression gate: 4% energy drift trips, 20% timing "
          "noise does not")
    verdict = compare_reports(drifted, baseline)
    print(format_verdict(verdict))
    out["gate"] = verdict

    # --- Pareto frontier: 512 weighting schemes in one fused dispatch ----------
    frontier_pods = queue_of(FRONTIER_PODS)
    frontier_nodes = make_scenario_cluster("mixed", FRONTIER_NODES, seed=0)
    ws = pareto.weight_grid_upto(FRONTIER_SCHEMES, criteria=6)
    # a mild regional split vs a hard one (flat intensities would make
    # carbon proportional to energy and collapse the trade-off)
    regimes = {"mild split (300±100)": ConstantCarbon(300.0, per_region={
                   "eu-west": 200.0, "ap-south": 400.0}),
               "hard split (50 vs 700)": ConstantCarbon(400.0, per_region={
                   "eu-west": 50.0, "ap-south": 700.0})}
    atlas = pareto.FrontierAtlas()
    print(f"\n--- Pareto frontier: {len(ws)} weighting schemes x "
          f"{len(frontier_pods)} pods x {len(frontier_nodes)} nodes per "
          f"regime")
    out["frontier"] = {}
    for regime, sig in regimes.items():
        sched = batch_scheduler(scheme="general", backend=backend,
                                carbon_signal=sig, device=dev)
        points = pareto.placement_metrics(frontier_pods, frontier_nodes, ws,
                                          scheduler=sched)
        front = pareto.frontier_for(points)
        atlas.add(regime, front)
        dom = atlas.dominant_scheme(regime)
        w = ", ".join(f"{v:.2f}" for v in dom.weights)
        print(f"  {regime:24s}: {len(front.front):3d}/{len(points)} "
              f"Pareto-optimal; dominant scheme #{dom.index} w=[{w}]")
        print(f"    "
              f"{'  '.join(f'{k}={v:.4g}' for k, v in dom.metrics.items())}")
        out["frontier"][regime] = {
            "front": len(front.front), "mask": front.mask,
            "dominant": dom.index, "metrics": [p.metrics for p in points]}
    report_path = write_html_report(
        os.path.join(out_dir, "fleet_frontier_report.html"),
        frontier=atlas.to_report(), title="weighting-scheme frontier")
    print(f"  wrote {report_path} — frontier scatter + table per regime")
    out["frontier_report"] = str(report_path)
    return out


if __name__ == "__main__":
    main()
