#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the TOPSIS CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version at main-path shapes, then
drives the GreenPod scheduling path end to end on the card — a
15,000-node fleet taking eight bursts of 512 pods through
``run_scenario(..., batch=True)`` on the ``cuda`` backend — checking every
batch round against the ``torch`` and float64 ``numpy`` backends and the
whole run against a ``numpy`` run. Phases print one line each; the line
before the last JSON line is the kernel table; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
Without a CUDA device, or outside a checkout, it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_NODES = 15000          # GKE's documented per-cluster node limit
BURST = 512
N_BURSTS = 8
GRID_S, GRID_P = 64, 64
TOL = 1e-5               # float32 kernels vs float32 plain / float64 numpy
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12         # H100 SXM data sheet, non-tensor float32
SOURCE = "src/repro_torch/kernels/csrc/topsis.cu"


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(tag, /, **fields):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, reps, warmup=3):
    """Mean device milliseconds per call, from CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def raw_launch(name, args, out):
    """A zero-argument call of kernel ``name``'s C entry point on ``args``
    and ``out`` — the launch the ``topsis_cuda`` wrapper makes, without its
    Python-side argument checks (the wrapper has just accepted these very
    tensors), so that back-to-back launches time the device and not the
    host. Returns the CUDA error code."""
    import torch

    from repro_torch.kernels import topsis_cuda as tc
    fn = getattr(tc.build().lib, name)
    tail = (out.device.index, torch.cuda.current_stream().cuda_stream)
    if name == "topsis_kinds":
        kidx, x, *small = args
        raw = (kidx.data_ptr(), x.shape[0], x.data_ptr(),
               *(t.data_ptr() for t in small), out.data_ptr(), x.shape[1],
               kidx.shape[0]) + tail
    else:
        x, *small = args
        ptrs = (x.data_ptr(), *(t.data_ptr() for t in small), out.data_ptr())
        sizes = {"topsis_single": (x.shape[0],),
                 "topsis_batched": (x.shape[1], x.shape[0]),
                 "topsis_grid": (x.shape[1], x.shape[0],
                                 args[2].shape[0])}[name]
        raw = ptrs + sizes + tail
    return lambda: fn(*raw)


def bound(bytes_moved, flops):
    """Least time for the work on the card (ms) and what sets it."""
    t_b, t_o = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def max_err(got, want):
    """Checks the -inf pattern and finiteness; returns max |got - want|
    over finite entries."""
    import torch
    check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
          "-inf pattern differs")
    fin = torch.isfinite(want)
    check(bool(torch.isfinite(got[fin]).all()), "non-finite closeness")
    return float((got[fin].double() - want[fin].double()).abs().max())


# --- phase 1-2 ----------------------------------------------------------------
def device_phase():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    phase("device", nvidia_smi=repr(smi), name=repr(name), count=count,
          torch=torch.__version__, cuda=torch.version.cuda)
    return smi, name, count


def build_phase():
    from repro_torch.kernels import topsis_cuda
    lib = topsis_cuda.build()
    ptxas = [ln.strip() for ln in lib.ptxas_log.splitlines()
             if "Compiling entry" in ln or "registers" in ln
             or "spill" in ln]
    phase("build", seconds=f"{lib.build_seconds:.2f}", library=lib.path.name)
    for ln in ptxas:
        print(f"[build] ptxas {ln}", flush=True)


# --- phase 3: kernels against their plain versions ---------------------------
def kernel_phase(dev):
    import numpy as np
    import torch

    from repro_torch.cluster.node import FleetState, make_scenario_cluster
    from repro_torch.cluster.workload import WORKLOADS
    from repro_torch.core.carbon import diurnal_fleet_signal
    from repro_torch.core.criteria import benefit_mask, criteria_matrix
    from repro_torch.core.criteria import greenpod_criteria
    from repro_torch.core.weighting import weights_for
    from repro_torch.kernels import ops
    from repro_torch.kernels import topsis_cuda as tc

    rng = np.random.default_rng(0)
    fleet = FleetState.from_nodes(make_scenario_cluster("mixed", N_NODES,
                                                        seed=0))
    n = len(fleet)
    specs = list(WORKLOADS.values())
    inten = diurnal_fleet_signal().intensities(fleet.region, 3600.0)
    kinds5 = np.stack([criteria_matrix(s.cpu_request, s.mem_request,
                                       s.base_time_s, fleet) for s in specs])
    kinds6 = np.stack([criteria_matrix(s.cpu_request, s.mem_request,
                                       s.base_time_s, fleet,
                                       carbon_intensity=inten)
                       for s in specs])
    b5 = benefit_mask()
    b6 = benefit_mask(greenpod_criteria(carbon=True))
    w5, w6 = weights_for("energy_centric"), weights_for("energy_centric",
                                                        carbon=True)
    kidx = rng.integers(0, len(specs), BURST)
    valid = rng.random((BURST, n)) > 0.1          # ~10% invalid nodes
    grid_w = rng.dirichlet(np.ones(5), GRID_S)
    k = len(specs)

    def f_row(c):       # operations per (pod, node) and scheme
        return 8 * c + 5

    cases = [
        ("topsis_single", tc.single, tc.single_plain,
         ops.single_operands(kinds5[0], w5, b5, valid=valid[0], device=dev),
         bound(n * 5 * 4 + 4 * 5 * 4 + n * 4, n * f_row(5)),
         dict(N=n, C=5), 400),
        ("topsis_batched", tc.batched, tc.batched_plain,
         ops.batched_operands(kinds5[kidx], w5, b5, valid=valid, device=dev),
         bound(BURST * n * 5 * 4 + 4 * BURST * 5 * 4 + BURST * n * 4,
               BURST * n * f_row(5)),
         dict(P=BURST, N=n, C=5), 100),
        ("topsis_kinds", tc.kinds, tc.kinds_plain,
         ops.kinds_operands(kinds5, kidx, w5, b5, valid=valid, device=dev),
         bound(k * n * 5 * 4 + BURST * 4 + 4 * BURST * 5 * 4
               + BURST * n * 4, BURST * n * f_row(5)),
         dict(K=k, P=BURST, N=n, C=5), 200),
        ("topsis_kinds", tc.kinds, tc.kinds_plain,
         ops.kinds_operands(kinds6, kidx, w6, b6, valid=valid, device=dev),
         bound(k * n * 6 * 4 + BURST * 4 + 4 * BURST * 6 * 4
               + BURST * n * 4, BURST * n * f_row(6)),
         dict(K=k, P=BURST, N=n, C=6), 200),
        ("topsis_grid", tc.grid, tc.grid_plain,
         ops.grid_operands(kinds5[kidx[:GRID_P]], grid_w, b5,
                           valid=valid[:GRID_P], device=dev),
         bound(GRID_P * n * 5 * 4 + GRID_P * 5 * 4
               + 3 * GRID_S * GRID_P * 5 * 4 + GRID_S * GRID_P * n * 4,
               GRID_P * n * 5 + GRID_S * GRID_P * n * (f_row(5) - 5)),
         dict(S=GRID_S, P=GRID_P, N=n, C=5), 50),
    ]
    table = {}
    for name, kernel, plain, (args, vmask), (b_ms, b_by), shape, reps \
            in cases:
        before = tc.LAUNCHES[name]
        out = kernel(*args)
        got = ops.fill_invalid(out, vmask)
        want = ops.fill_invalid(plain(*args), vmask)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(err <= TOL, f"{name} {shape}: max abs err {err} > {TOL}")
        launch = raw_launch(name, args, torch.empty_like(out))
        ms = cuda_ms(launch, reps)
        check(launch() == 0, f"{name}: timed launch failed")
        wrapper_ms = cuda_ms(lambda: kernel(*args), reps)
        plain_ms = cuda_ms(lambda: plain(*args), max(reps // 10, 5))
        # the wrapper's counter: the check launch plus warm-up and timed
        # launches (the raw C launches bypass it, and the main path's
        # counts start from 0 in the slice phase)
        phase("kernels", kernel=name, **shape, max_abs_err=f"{err:.3e}",
              ms=f"{ms:.6f}", wrapper_ms=f"{wrapper_ms:.6f}",
              plain_ms=f"{plain_ms:.6f}", bound_ms=f"{b_ms:.6f}",
              bound_us=f"{1e3 * b_ms:.3f}", bound_by=b_by,
              wrapper_launches=tc.LAUNCHES[name] - before)
        row = table.setdefault(name, dict(
            name=name, route="cuda", source=SOURCE,
            replaces=tc.REPLACES[name], launches=0, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
        row["max_abs_err"] = max(row["max_abs_err"], err)
    return table


# --- phase 4: the slice ---------------------------------------------------------
def near_tie_walk(cc_ref, got, pods, table, blocked):
    """Walk the queue with the ledger of the assignment ``got``. At each
    pod, the float64 reference's pick under that same ledger must be
    ``got``'s pick, or a node whose float64 closeness is within TOL of it
    (a near-tie). Returns the number of near-ties and the largest float64
    closeness gap among them."""
    import numpy as np
    order = np.argsort(-cc_ref, kind="stable", axis=-1)
    free_cpu, free_mem = table.free_cpu.copy(), table.free_mem.copy()
    ties, max_gap = 0, 0.0
    for i, pod in enumerate(pods):
        forbid = blocked[i] if blocked is not None else None
        want = None
        for j in order[i]:
            if np.isneginf(cc_ref[i, j]):
                break
            if forbid is not None and int(j) == forbid:
                continue
            if free_cpu[j] >= pod.cpu - 1e-9 and free_mem[j] >= pod.mem - 1e-9:
                want = int(j)
                break
        pick = got[i]
        if pick != want:
            check(pick is not None and want is not None,
                  f"pod {pod.uid}: placed {pick}, reference {want}")
            check(free_cpu[pick] >= pod.cpu - 1e-9
                  and free_mem[pick] >= pod.mem - 1e-9 and pick != forbid,
                  f"pod {pod.uid}: node {pick} does not fit")
            gap = abs(cc_ref[i, want] - cc_ref[i, pick])
            check(gap <= TOL, f"pod {pod.uid}: node {pick} vs reference "
                  f"{want}, float64 closeness gap {gap} > {TOL}")
            ties += 1
            max_gap = max(max_gap, float(gap))
        if pick is not None:
            free_cpu[pick] -= pod.cpu
            free_mem[pick] -= pod.mem
    return ties, max_gap


def make_checked_scheduler(dev, stats):
    """A BatchScheduler that, after every cuda round, scores the same queue
    on the same fleet with the torch (card) and numpy backends and holds
    the round to them; at the middle round it also drives the weight grid
    (K4), a full-rebuild round (K2) and per-pod GreenPod decisions (K1) on
    the live fleet."""
    import numpy as np

    from repro_torch.cluster.node import NodeTable
    from repro_torch.core import scheduler as S

    class CheckedBatchScheduler(S.BatchScheduler):
        def attach(self, fleet):
            super().attach(fleet)
            self.checkers = {}
            for backend in ("torch", "numpy"):
                chk = S.BatchScheduler(self.scheme, backend=backend,
                                       device=dev)
                chk.attach(fleet)
                self.checkers[backend] = chk

        def select_many(self, pods, nodes, now=0.0, blocked=None,
                        exclude=None, explain=False):
            assign, diag = super().select_many(pods, nodes, now=now,
                                               blocked=blocked,
                                               exclude=exclude)
            rnd = len(stats["rounds"])
            cc = diag["closeness"]
            ccs = {b: c.score_queue(pods, nodes, now=now, exclude=exclude)
                   for b, c in self.checkers.items()}
            errs = {b: max_err_np(cc, ccs[b]) for b in ccs}
            check(max(errs.values()) <= TOL,
                  f"round {rnd}: cuda vs {errs} > {TOL}")
            ties, gap = near_tie_walk(ccs["numpy"], assign, pods, nodes,
                                      blocked)
            t_assign = S._greedy_assign(ccs["torch"], pods, nodes, blocked)
            stats["rounds"].append(dict(
                err_torch=errs["torch"], err_numpy=errs["numpy"],
                ties=ties, tie_gap=gap, same_as_torch=t_assign == assign,
                ties_torch=near_tie_walk(ccs["numpy"], t_assign, pods,
                                         nodes, blocked)[0]))
            if rnd == N_BURSTS // 2:
                self._drive_other_kernels(pods, nodes, now, cc, stats)
            return assign, diag

        def _drive_other_kernels(self, pods, fleet, now, cc, stats):
            # K4: the weight grid on the live fleet (incremental path)
            ws = np.random.default_rng(1).dirichlet(np.ones(5), GRID_S)
            g_assign, g_diag = self.select_many_grid(pods[:GRID_P], fleet,
                                                     ws, now=now)
            g_ref = self.checkers["numpy"].score_queue_grid(
                pods[:GRID_P], fleet, ws, now=now)
            stats["grid_err"] = max_err_np(g_diag["closeness"], g_ref)
            check(stats["grid_err"] <= TOL, f"grid err {stats['grid_err']}")
            check(len(g_assign) == GRID_S, "grid assignments")
            # K2: a full-rebuild round on a snapshot of the same fleet
            snap = NodeTable.from_nodes(fleet.nodes)
            r_assign, r_diag = S.BatchScheduler(
                self.scheme, backend="cuda", device=dev).select_many(
                    pods, snap, now=now)
            stats["rebuild_err"] = max_err_np(r_diag["closeness"], cc)
            check(stats["rebuild_err"] <= TOL, "rebuild vs incremental")
            stats["rebuild_ties"], _ = near_tie_walk(
                self.checkers["numpy"].score_queue(pods, fleet, now=now),
                r_assign, pods, snap, None)
            # K1: per-pod GreenPod decisions on the live fleet
            g = S.GreenPodScheduler(self.scheme, backend="cuda", device=dev)
            g.attach(fleet)
            ref = S.GreenPodScheduler(self.scheme, backend="numpy")
            for pod in pods[:4]:
                idx, d = g.select(pod, fleet, now=now)
                ridx, rd = ref.select(pod, fleet, now=now)
                err = max_err_np(d["closeness"], rd["closeness"])
                check(err <= TOL, f"GreenPod cuda vs numpy {err}")
                check(idx == ridx or abs(rd["closeness"][idx]
                                         - rd["closeness"][ridx]) <= TOL,
                      f"GreenPod pick {idx} vs {ridx}")

    return CheckedBatchScheduler


def make_timed_scheduler(dev, stats):
    """A BatchScheduler that records each round's own times — the whole
    round (its ``scheduler_batch`` span) and its ``score_queue`` call —
    and, on the cuda backend after the middle round, times that round's
    parts again on the same inputs: the torch operand reductions, the
    kernel alone, the device->host copy of the (P, N) closeness, and the
    host greedy."""
    import torch

    from repro_torch.core import scheduler as S
    from repro_torch.kernels import ops
    from repro_torch.kernels import topsis_cuda as tc

    class TimedBatchScheduler(S.BatchScheduler):
        def score_queue(self, pods, nodes, now=0.0, exclude=None):
            t0 = time.perf_counter()
            cc = super().score_queue(pods, nodes, now=now, exclude=exclude)
            self.score_s = time.perf_counter() - t0    # ends in a D2H copy
            return cc

        def select_many(self, pods, nodes, now=0.0, blocked=None,
                        exclude=None, explain=False):
            assign, diag = super().select_many(pods, nodes, now=now,
                                               blocked=blocked,
                                               exclude=exclude)
            stats["rounds"].append(dict(score_s=self.score_s,
                                        round_s=diag["scheduling_time_s"]))
            if self.backend == "cuda" \
                    and len(stats["rounds"]) == N_BURSTS // 2 + 1:
                t0 = time.perf_counter()
                self._parts(pods, nodes, now, exclude)
                stats["breakdown_s"] = time.perf_counter() - t0
            return assign, diag

        def _parts(self, pods, nodes, now, exclude):
            # the cache is synced and the fleet unchanged: the same inputs
            kind_idx = self._cache.sync(pods, now)[0]
            valid = self._valid(pods, nodes, exclude)
            ws = self.weights(nodes)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            args, vmask = ops.kinds_operands(self._dev, kind_idx, ws,
                                             self._benefit, valid=valid,
                                             device=dev)
            torch.cuda.synchronize()
            stats["operands_s"] = time.perf_counter() - t0
            out = tc.kinds(*args)
            launch = raw_launch("topsis_kinds", args, torch.empty_like(out))
            stats["kernel_s"] = cuda_ms(launch, 20) / 1e3
            stats["wrapper_s"] = cuda_ms(lambda: tc.kinds(*args), 20) / 1e3
            out = ops.fill_invalid(out, vmask)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = out.cpu().numpy()
            stats["d2h_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            S._greedy_assign(host, pods, nodes)
            stats["greedy_s"] = time.perf_counter() - t0

    return TimedBatchScheduler


def max_err_np(got, want):
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape, f"shape {got.shape} vs {want.shape}")
    check(np.array_equal(np.isneginf(got), np.isneginf(want)),
          "-inf pattern differs")
    fin = np.isfinite(want)
    check(bool(np.isfinite(got[fin]).all()), "non-finite closeness")
    return float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0


@contextlib.contextmanager
def engine_scheduler(cls):
    """Route ``simulate``'s BatchScheduler through ``cls`` for one run."""
    from repro_torch.cluster import engine
    saved = engine.BatchScheduler
    engine.BatchScheduler = cls
    try:
        yield
    finally:
        engine.BatchScheduler = saved


def slice_phase(dev):
    import numpy as np
    import torch

    from repro_torch.cluster.node import make_scenario_cluster
    from repro_torch.cluster.simulator import run_scenario
    from repro_torch.cluster.workload import PoissonArrivals
    from repro_torch.kernels import topsis_cuda as tc

    def run(backend, **kw):
        arrivals = PoissonArrivals(rate_per_s=0.2, n_bursts=N_BURSTS,
                                   burst_size=BURST, topsis_share=1.0,
                                   seed=0)
        t0 = time.perf_counter()
        res = run_scenario(
            arrivals, "energy_centric",
            cluster_factory=lambda: make_scenario_cluster("mixed", N_NODES,
                                                          seed=0),
            batch=True, batch_backend=backend, **kw)
        if backend != "numpy":
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # the main path: counts set to 0 just before, read just after
    checked = {"rounds": []}
    torch.cuda.reset_peak_memory_stats()
    tc.reset_launches()
    with engine_scheduler(make_checked_scheduler(dev, checked)):
        res_cuda, wall_checked = run("cuda", device=dev)
    launches = dict(tc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rounds = checked["rounds"]
    ties = sum(r["ties"] for r in rounds)
    check(len(rounds) > 0, "no batch rounds")
    check(launches["topsis_kinds"] == len(rounds),
          f"K3 launches {launches['topsis_kinds']} != rounds {len(rounds)}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    timed_np = {"rounds": []}
    with engine_scheduler(make_timed_scheduler(dev, timed_np)):
        res_np, wall_np = run("numpy")
    timed = {"rounds": []}
    with engine_scheduler(make_timed_scheduler(dev, timed)):
        res_timed, wall_cuda = run("cuda", device=dev)
    check(len(timed["rounds"]) == len(rounds), "timed run rounds differ")

    def placements(res):
        return [(r.pod.uid, r.node, r.start_s) for r in res.records]

    same = placements(res_cuda) == placements(res_np)
    e_cuda, e_np = (res_cuda.mean_energy_kj("topsis"),
                    res_np.mean_energy_kj("topsis"))
    if ties == 0:
        check(same, "cuda placements differ from numpy with no near-tie")
        check(res_cuda.unschedulable_rate() == res_np.unschedulable_rate(),
              "unschedulable_rate differs")
        check(abs(e_cuda - e_np) <= 1e-9 * abs(e_np),
              f"mean_energy_kj differs: {e_cuda} vs {e_np}")
    else:
        first = next(i for i, r in enumerate(rounds) if r["ties"])
        phase("slice", near_ties=ties, first_divergent_round=first,
              placements_equal=same)
    check(placements(res_timed) == placements(res_cuda),
          "the timed cuda run placed differently from the checked one")
    placed = len({r.pod.uid for r in res_cuda.records})
    check(placed + res_cuda.unschedulable == N_BURSTS * BURST,
          "pods lost")
    check(np.isfinite(e_cuda) and e_cuda > 0, "energy not finite")
    phase("slice", nodes=N_NODES, rounds=len(rounds), pods_placed=placed,
          unschedulable_rate=res_cuda.unschedulable_rate(),
          mean_energy_kj_topsis=repr(e_cuda), numpy_mean_energy_kj=repr(e_np),
          placements_equal_numpy=same, near_ties=ties,
          max_near_tie_gap=f"{max(r['tie_gap'] for r in rounds):.3e}",
          rebuild_near_ties=checked["rebuild_ties"],
          near_ties_torch=sum(r["ties_torch"] for r in rounds),
          max_err_vs_torch=f"{max(r['err_torch'] for r in rounds):.3e}",
          max_err_vs_numpy=f"{max(r['err_numpy'] for r in rounds):.3e}",
          grid_err=f"{checked['grid_err']:.3e}",
          rebuild_err=f"{checked['rebuild_err']:.3e}",
          launches=json.dumps(launches, separators=(",", ":")),
          max_memory_allocated=peak)
    t = timed["rounds"]
    wall_cuda -= timed["breakdown_s"]

    def median(key, rounds=t):
        return float(np.median([r[key] for r in rounds]))
    phase("slice", wall_s_cuda=f"{wall_cuda:.3f}",
          wall_s_cuda_checked=f"{wall_checked:.3f}",
          wall_s_numpy=f"{wall_np:.3f}",
          pods_per_s_run_cuda=f"{placed / wall_cuda:.1f}",
          pods_per_s_run_numpy=f"{placed / wall_np:.1f}",
          rounds_timed=len(t),
          round_s_median=f"{median('round_s'):.6f}",
          round_s_max=f"{max(r['round_s'] for r in t):.6f}",
          round_pods_per_s=f"{BURST / median('round_s'):.1f}",
          numpy_round_s_median=f"{median('round_s', timed_np['rounds']):.6f}",
          round_score_queue_s_median=f"{median('score_s'):.6f}",
          mid_round_operands_s=f"{timed['operands_s']:.6f}",
          mid_round_kernel_s=f"{timed['kernel_s']:.6f}",
          mid_round_kernel_wrapper_s=f"{timed['wrapper_s']:.6f}",
          mid_round_d2h_s=f"{timed['d2h_s']:.6f}",
          mid_round_greedy_s=f"{timed['greedy_s']:.6f}",
          rounds_same_as_torch=sum(r["same_as_torch"] for r in rounds))
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc" / "topsis.cu").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    smi, name, count = device_phase()
    build_phase()
    table = kernel_phase(dev)
    launches = slice_phase(dev)
    for row in table.values():
        row["launches"] = launches[row["name"]]
    phase("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(smi)
    print(json.dumps({"kernels": list(table.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
