#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from
``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all started
together; the bf16 tensor-core instantiations of K5, K6 and K7 at D = 128
and D = 256 must not spill) and holds each against its plain PyTorch
version at main-path shapes, the flash-attention backward (K6, K7)
included, at llama3-8b's head dim (128) and gemma-7b's (256), and K8 at
every width path. The bf16 cases run K5's, K6's and K7's tensor-core
instantiations (mma.sync with p and ds split into bf16 halves); the
float32 cases and the float32 model runs below hold the float32 FMA
instantiations. Then it drives the port's main paths on
the card:

* the GreenPod scheduling path — a 15,000-node fleet taking eight bursts
  of 512 pods through ``run_scenario(..., batch=True)`` on the ``cuda``
  backend — checking every batch round against the ``torch`` and float64
  ``numpy`` backends and the whole run against a ``numpy`` run (K1-K4);
* the per-pod GreenPod path on the same fleet — 64 pods decided one at a
  time, each bound before the next, on ``cuda`` (one K1 launch a
  decision, on the resident mirror), ``torch`` and ``numpy`` — each
  decision held to numpy on the same fleet, timed per backend, and one
  clean decision profiled: K1 must be its only kernel;
* the scheduling round with the carbon and autoscale policies on the same
  fleet and arrivals (half of the pods deferrable, ``carbon_centric``):
  ``run_scenario(batch=True)`` on ``cuda`` — K3 at C = 6 with an exclude
  mask, once a round and once a queue-pressure wake's scoring — then on
  ``numpy``, which must reach the same placements, event log, counters,
  energy and carbon once it follows the cuda run's float64 near-tie
  breaks (each shown to be one); every policy mechanism must act, and the
  cuda run once more with telemetry (after the timed runs) must record the
  run's counters and export them to Prometheus text and an HTML report;
* the Pareto frontier layer: ``placement_metrics`` for 64 pods under 64
  weight schemes of six criteria on the same fleet (one K4 launch; the
  frontier equal to numpy's), and ``scenario_metrics`` for three schemes
  through the engine (K3), equal to numpy's;
* the llama3-8b serving path at full width and depth with seeded random
  weights — 8 requests of 1024-2048 prompt tokens in waves of 4 through
  ``serve.engine.Engine``, prefill through the flash-attention kernel (K5)
  — checking every prefill and decode logit row against the same model
  with K5's plain version, teacher-forced on the kernel run's tokens; then
  the same in float32 at a tight limit, which a control with the
  probabilities rounded to bf16 must fail;
* ``launch.serve --smoke`` through its own entry point, whose head dim
  (8) the flash wrapper pads to 32, through K5;
* the gemma-7b serving path the same way (28 layers, 16 heads of head
  dim 256, geglu, tied embeddings): K5 at D = 256;
* the llama3-8b training path at full width and depth — 3 AdamW steps
  (int8 moments) on one 4096-token sequence through ``launch.train``'s
  functions, every layer's attention through K5 forward, K5 again in the
  per-layer recompute, K6 and K7 — checked against the same 3 steps with
  attention on the plain versions (and, for the spread, in float64); then
  4 layers in float32 at tight limits, which a control with a planted K7
  fault must fail;
* the gemma-7b training path the same way (K5, K6, K7 at D = 256), then 2
  layers in float32, where a K7 writing only the first 128 columns of dK
  and dV must fail; then the checkpoint / restart round trip of the fault
  Supervisor at the smoke size (head dim 8, padded).

K3 and K4 write the -inf over infeasible nodes themselves and sum only the
real criteria: each is held against its plain version masked and
unmasked, at C = 5 and 6 and at a ragged N (15,001 nodes), K3 also for
one pod at C = 6 (a wake's scoring), and timed masked and unmasked beside
the unfused pair (the kernel, then the fill).
K1 does its own reductions and fill in one cluster launch: it is held to
its plain version from 1 to 65,536 nodes (past what the cluster holds on
chip), with one valid node and none, and timed beside its launch floor
and the unfused launches it replaces.

The kernel checks are shown to reject planted faults: the K1, K3 and K4
plain versions without their fill or over one criterion fewer, K1's with
its ideal points over all rows or its norms over the valid rows only, K5
with p rounded to bf16 or a key tile dropped, K8 rounded before its gamma
multiply, K6/K7 with dk and dv from one head of each GQA group, ds
without its dd term, dq without its diagonal key tile, or (bf16) ds
rounded to bf16 before K6's product, p or ds rounded to bf16 before K7's;
at D = 256 also K5 and K7 with only the first 128 columns of their
outputs.

Phases print one line each; the line before the last JSON line is the
kernel table (one row per kernel, and one more per flash kernel for its
D = 256 instantiation, named ``<kernel>_d256``, whose launches are the
gemma-7b paths'); the last line is ``{"ok": true, "device": {...}}``. Any
failure exits non-zero before it. Without a CUDA device, or outside a
checkout, it exits non-zero at once.

    python3 chip_smoke.py --perpod-only

runs only the per-pod decisions, in a checkout that holds a copy of this
script (another commit's, to compare its per-pod path with this one's).
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import shutil
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
BF16_FLOPS = 989e12        # H100 SXM data sheet, dense bf16 tensor cores
SOURCE = "src/repro_torch/kernels/csrc/topsis.cu"
CSRC = "src/repro_torch/kernels/csrc"

# K5 / K8 against their plain versions. float32: |got - want| <= 2e-5 +
# 2e-5 |want|, another summation order (the reference's kernel-sweep
# tolerance). bfloat16: both sides are float32 results rounded once, so
# they may differ by one output ulp (<= 2**-7 |want|, plus 1e-4 where want
# is near 0), and only where the two float32 values straddle a rounding
# boundary: on at most BF16_FLIP_SHARE of the elements. A kernel that
# rounds an intermediate to bf16 (p before P.V, x before the gamma
# multiply) flips about 40% of them. lse is float32 in both.
F32_TOL = 2e-5
BF16_ATOL, BF16_RTOL, BF16_FLIP_SHARE = 1e-4, 2 ** -7, 1e-2
# K5 inputs: q has standard deviation K5_Q_STD and k, v 1, so the logits
# have standard deviation 2 and attention is peaked (out of the order of
# v, not a near-uniform mean that hides a dropped key tile).
K5_Q_STD = 2.0
K5_TILE = 64             # BK of csrc/flash_attention.cu
# The serving slice: llama3-8b, 8 requests in waves of 4.
SERVE_ARCH = "llama3-8b"
SERVE_REQUESTS, SERVE_SLOTS, SERVE_NEW = 8, 4, 32
SERVE_PROMPT = (1024, 2048)          # prompt lengths, inclusive
# bf16 logits at full depth, kernel path vs plain path (and the top-2 gap
# that makes a differing argmax a near-tie). Both paths round to bf16 at
# the same points, but their float32 sums run in another order, and the
# one-ulp flips that follow compound over 32 layers: the plain path itself
# lies 0.089 from the same model with float64 attention (PERF.md). 5e-2
# holds at the 2-layer SMOKE depth, where the CPU tests check it. This
# limit cannot tell a kernel that rounds p to bf16 (the same flips, more
# often); the float32 comparison below does.
LOGIT_TOL = 0.2
# The same weights upcast to float32, teacher-forced on the bf16 run's
# tokens: K5's float32 instantiation against its plain version, within
# F32_LOGIT_TOL; the plain version with p rounded to bf16 before P.V (the
# control) must lie beyond it.
F32_LOGIT_TOL = 1e-3
PROFILE_STEPS = 8        # decode steps under the profiler
# K5 cases: (tag, B, H, Hkv, S, D, dtype, window, timed reps): (a) the
# serving shape, (b) float32, (c) window 64, (d) a ragged S. Every head dim
# the kernel is built for is then checked at K5_SMALL = (B, H, Hkv, S).
# Planted faults are held to the check at (a) and (b).
# (e) and (f) are gemma-7b's serving shape (H = Hkv = 16, D = 256) in bf16
# and float32. Planted faults are held to the check at (a), (b), (e), (f).
K5_CASES = [("a", 4, 32, 8, 2048, 128, "bfloat16", None, 10),
            ("b", 1, 32, 8, 2048, 128, "float32", None, 10),
            ("c", 4, 32, 8, 2048, 128, "bfloat16", 64, 20),
            ("d", 4, 32, 8, 1000, 128, "bfloat16", None, 20),
            ("e", 4, 16, 16, 2048, 256, "bfloat16", None, 10),
            ("f", 1, 16, 16, 2048, 256, "float32", None, 10)]
K5_FAULT_CASES = ("a", "b", "e", "f")
K5_SMALL = (2, 8, 2, 333)            # a GQA group of 4, every head dim
WIDE_D = 256                         # gemma-7b's head dim
# the D = 256 controls: an output with only its first HALF_D columns
# written (the rest zero), as from a kernel that split D between warps and
# lost one half
HALF_D = 128
K8_SHAPE = (4 * 2048, 4096)          # rows of a 4 x 2048 prefill, d_model
# K8 at K8_ROWS rows of each width, in 16-byte vectors (8 bf16, 4 float32),
# that picks one instantiation of its register path (1 to 16 vectors a
# thread, 1 to 8 warps a row), then past it, then a width of no whole
# vector (the other kernel).
K8_ROWS, K8_VECTORS = 33, (1, 3, 64, 96, 256, 512, 1024, 2048, 4096, 8192)
# K6/K7 cases: (tag, B, H, Hkv, S, D, dtype, window, timed reps): the
# training shape (one 4096-token sequence, the model sees 4095), then
# float32 with window 64, each at llama3-8b's and at gemma-7b's heads.
# Every head dim is then checked at K5_SMALL.
# bf16 gradients are held to agreement()'s one-ulp rule, float32 ones to
# BWD_F32_REL of the largest |grad| (float32 sums in another order).
BWD_CASES = [("train", 1, 32, 8, 4095, 128, "bfloat16", None, 5),
             ("f32_window", 1, 32, 8, 1000, 128, "float32", 64, 10),
             ("gemma_train", 1, 16, 16, 4095, 256, "bfloat16", None, 5),
             ("gemma_f32_window", 1, 16, 16, 1000, 256, "float32", 64, 10)]
BWD_F32_REL = 1e-4
# The training slice: launch.train's code path at full width and depth.
TRAIN_STEPS = 3
TRAIN_ARGV = ["--seq-len", "4096", "--global-batch", "1", "--n-micro", "1",
              "--lr", "3e-4", "--steps", str(TRAIN_STEPS), "--device",
              "cuda"]
GEMMA_ARCH = "gemma-7b"
# bf16 at full depth, kernel run vs plain run (relative): step-1 loss,
# step-1 grad norm, and the loss of every step. Both round to bf16 at the
# same points; their float32 sums run in another order, and the one-ulp
# flips compound over 32 layers and, after step 1, through AdamW's
# sign-like first updates. The limits are ~10x the spread between the
# plain path and float64 attention (6.6e-6, 1.5e-4, 1.5e-3 on an H100;
# PERF.md), which the script prints beside them.
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_LOSSES_RTOL = 1e-4, 2e-3, 1e-2
# float32 at full width, F32_TRAIN_LAYERS layers (gemma-7b:
# GEMMA_F32_LAYERS; its 256000 x 3072 float32 embedding and its moments
# take 12.6 GB), float32 moments: step-1 gradients of every leaf within
# F32_GRAD_REL of its largest |g|, losses of every step within
# F32_LOSS_RTOL; a K7 with a planted fault must fail.
F32_TRAIN_LAYERS, F32_GRAD_REL, F32_LOSS_RTOL = 4, 1e-4, 1e-5
GEMMA_F32_LAYERS = 2


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

    def ptr(t):
        return None if t is None else t.data_ptr()
    if name == "topsis_single":
        x, w, benefit, valid, c = args
        raw = (x.data_ptr(), ptr(valid), out.data_ptr(), x.shape[0],
               tc.single_params(w, benefit, c), c) + tail
    elif name == "topsis_kinds":
        kidx, x, *small, valid, c = args
        raw = (kidx.data_ptr(), x.shape[0], x.data_ptr(),
               *(t.data_ptr() for t in small), ptr(valid), out.data_ptr(),
               x.shape[1], kidx.shape[0], c) + tail
    elif name == "topsis_grid":
        x, *small, valid, c = args
        raw = (x.data_ptr(), *(t.data_ptr() for t in small), ptr(valid),
               out.data_ptr(), x.shape[1], x.shape[0], small[1].shape[0],
               c) + tail
    else:
        x, *small = args
        ptrs = (x.data_ptr(), *(t.data_ptr() for t in small), out.data_ptr())
        raw = ptrs + (x.shape[1], x.shape[0]) + tail
    return lambda: fn(*raw)


def bound(bytes_moved, flops, peak=FP32_FLOPS):
    """Least time for the work on the card (ms) and what sets it."""
    t_b, t_o = bytes_moved / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def agreement(got, want):
    """(passes, max |got - want|, share of elements that differ) of a
    kernel's output against its plain version, by the limits above."""
    import torch
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{got.shape} {got.dtype} vs {want.shape} {want.dtype}")
    g, w = got.double(), want.double()
    err = (g - w).abs()
    share = float((got != want).double().mean())
    if got.dtype == torch.bfloat16:
        ok = bool((err <= BF16_ATOL + BF16_RTOL * w.abs()).all()) \
            and share <= BF16_FLIP_SHARE
    else:
        ok = bool((err <= F32_TOL + F32_TOL * w.abs()).all())
    return ok, float(err.max()), share


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


def ptxas_entry(ptxas_log, kernel):
    """(bytes of spill stores, registers) ptxas reports for the entry
    whose mangled name contains ``kernel`` (None where it reports none)."""
    import re
    lines = ptxas_log.splitlines()
    spill = regs = None
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and kernel in ln:
            for nxt in lines[i + 1:i + 4]:
                m = re.search(r"(\d+) bytes spill stores", nxt)
                spill = int(m.group(1)) if m else spill
                m = re.search(r"Used (\d+) registers", nxt)
                regs = int(m.group(1)) if m else regs
            break
    return spill, regs


def build_phase():
    """Start one nvcc per source, then load each library; the tensor-core
    kernels' D = 128 and D = 256 instantiations must not spill."""
    from repro_torch.kernels import flash_cuda, rmsnorm_cuda, topsis_cuda
    libs = [m.LIBRARY for m in (topsis_cuda, flash_cuda, rmsnorm_cuda)] \
        + [flash_cuda.BWD_LIBRARY, topsis_cuda.MATH_CHECK]
    t0 = time.perf_counter()
    for lib in libs:
        lib.start()
    for lib in libs:
        lib.load()
        ptxas = [ln.strip() for ln in lib.ptxas_log.splitlines()
                 if "Compiling entry" in ln or "registers" in ln
                 or "spill" in ln]
        phase("build", seconds=f"{lib.build_seconds:.2f}",
              library=lib.path.name)
        for ln in ptxas:
            print(f"[build] ptxas {ln}", flush=True)
    import torch
    for lib, kernel, name in (
            (flash_cuda.LIBRARY, "flash_fwd_kernel", flash_cuda.NAME),
            (flash_cuda.BWD_LIBRARY, "flash_bwd_dq_kernel", flash_cuda.DQ),
            (flash_cuda.BWD_LIBRARY, "flash_bwd_dkv_kernel",
             flash_cuda.DKV)):
        for d in (128, WIDE_D):
            for dtype, mangled in ((torch.bfloat16, "I13__nv_bfloat16"),
                                   (torch.float32, "If")):
                n, regs = ptxas_entry(lib.ptxas_log,
                                      f"{kernel}{mangled}Li{d}E")
                tag = "bf16" if dtype == torch.bfloat16 else "f32"
                if dtype == torch.bfloat16:
                    check(n == 0, f"{kernel}<bf16, {d}> spills {n} bytes")
                phase("build", kernel=f"{kernel}<{tag},{d}>",
                      spill_store_bytes=n, registers=regs,
                      dynamic_smem_bytes=flash_cuda.smem_bytes(name, dtype,
                                                               d))
    # K1: every <C, VEC> instantiation, none may spill
    k1 = {}
    for c in range(1, 9):
        for vec in (1, 0):
            n, regs = ptxas_entry(topsis_cuda.LIBRARY.ptxas_log,
                                  f"topsis_single_kernelILi{c}ELb{vec}EE")
            check(n == 0, f"topsis_single_kernel<{c},{vec}> spills {n} bytes")
            k1[f"{c},{vec}"] = regs
    phase("build", kernel="topsis_single_kernel<C,VEC>",
          spill_store_bytes=0, registers_max=max(k1.values()),
          registers=json.dumps(k1, separators=(",", ":")))
    phase("build", all_seconds=f"{time.perf_counter() - t0:.2f}")


# --- phase 3: kernels against their plain versions ---------------------------
def control(got, want):
    """How a planted-fault control's output compares with the kernel's:
    "pattern" where the -inf pattern differs, else the max abs error."""
    try:
        return max_err(got, want)
    except SmokeFailure as e:
        if "-inf pattern" not in str(e):
            raise
        return "pattern"


def kernel_phase(dev, smi):
    """K1-K4 against their plain versions at the slice's shapes (K1:
    ``k1_cases``). K3 and K4
    take the mask (the -inf fill is theirs) and the number of real
    criteria: each runs masked, as the main path does, and unmasked (the
    function without the fill, timed beside the unfused pair: that launch,
    then ``fill_invalid``), at C = 5 and 6, and at a ragged N (not a
    multiple of 4: the kernels' scalar path).
    Two controls must fail: the plain version without its fill (the -inf
    pattern) and the plain version over C - 1 criteria (TOL)."""
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

    # K3's and K4's branch-free square root and division: the IEEE bits
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ieee = tc.math_check(dev)
    phase("kernels", math_check=json.dumps(ieee, separators=(",", ":")),
          seconds=f"{time.perf_counter() - t0:.3f}")
    check(ieee["sqrt_mismatches"] == 0 and ieee["div_mismatches"] == 0,
          f"branch-free sqrt / division differ from IEEE: {ieee}")

    rng = np.random.default_rng(0)
    specs = list(WORKLOADS.values())

    def kind_tensor(nodes, carbon):
        fleet = FleetState.from_nodes(make_scenario_cluster("mixed", nodes,
                                                            seed=0))
        inten = (diurnal_fleet_signal().intensities(fleet.region, 3600.0)
                 if carbon else None)
        return np.stack([criteria_matrix(s.cpu_request, s.mem_request,
                                         s.base_time_s, fleet,
                                         carbon_intensity=inten)
                         for s in specs])
    kinds5, kinds6 = kind_tensor(N_NODES, False), kind_tensor(N_NODES, True)
    n = kinds5.shape[1]
    b5 = benefit_mask()
    b6 = benefit_mask(greenpod_criteria(carbon=True))
    w5, w6 = weights_for("energy_centric"), weights_for("energy_centric",
                                                        carbon=True)
    kidx = rng.integers(0, len(specs), BURST)
    valid = rng.random((BURST, n)) > 0.1          # ~10% invalid nodes
    grid_w = rng.dirichlet(np.ones(5), GRID_S)
    k = len(specs)
    # one node more than N_NODES: N % 4 != 0, K3's and K4's scalar path
    kinds5r = kind_tensor(N_NODES + 1, False)
    valid_r = rng.random((BURST, n + 1)) > 0.1
    grid_w6 = rng.dirichlet(np.ones(6), GRID_S)

    def f_row(c):       # operations per (pod, node) and scheme
        return 8 * c + 5

    def kinds_bound(c, nn, masked, p=BURST):  # + a mask byte a (pod, node)
        used = len(set(kidx[:p].tolist()))   # only the pods' kinds are read
        return bound(used * nn * c * 4 + p * 4 + 4 * p * c * 4
                     + p * nn * (4 + masked), p * nn * f_row(c))

    def grid_bound(c, nn, masked):
        return bound(GRID_P * nn * c * 4 + GRID_P * c * 4
                     + 3 * GRID_S * GRID_P * c * 4 + GRID_P * nn * masked
                     + GRID_S * GRID_P * nn * 4,
                     GRID_P * nn * c + GRID_S * GRID_P * nn * (f_row(c) - c))

    def unmasked(args):
        return args[:-2] + (None, args[-1])

    table = {"topsis_single": k1_cases(dev, smi, kinds5, kinds6, kinds5r,
                                       valid[0], valid_r[0], w5, w6, b5, b6)}

    # K2: the kernel, then the wrapper's fill over its output
    cases = [
        ("topsis_batched", tc.batched, tc.batched_plain,
         ops.batched_operands(kinds5[kidx], w5, b5, valid=valid, device=dev),
         bound(BURST * n * 5 * 4 + 4 * BURST * 5 * 4 + BURST * n * 4,
               BURST * n * f_row(5)),
         dict(P=BURST, N=n, C=5), 100),
    ]
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
        table[name] = dict(
            name=name, route="cuda", source=SOURCE,
            replaces=tc.REPLACES[name], launches=0, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None)

    # K3, K4: the fill fused. (name, kernel, plain, args, the mask of the
    # unfused pair (unmasked cases), bound, shape, timed reps, controls).
    # Each kernel's first case is the main path's (masked, C = 5): its
    # numbers make the kernel's row; every case's error counts.
    k3 = ops.kinds_operands(kinds5, kidx, w5, b5, valid=valid, device=dev)
    k3c6 = ops.kinds_operands(kinds6, kidx, w6, b6, valid=valid, device=dev)
    k4 = ops.grid_operands(kinds5[kidx[:GRID_P]], grid_w, b5,
                           valid=valid[:GRID_P], device=dev)
    k4c6 = ops.grid_operands(kinds6[kidx[:GRID_P]], grid_w6, b6,
                             valid=valid[:GRID_P], device=dev)
    k3s = dict(K=k, P=BURST)
    k4s = dict(S=GRID_S, P=GRID_P)
    fused = [
        ("topsis_kinds", k3, None, kinds_bound(5, n, 1),
         dict(**k3s, N=n, C=5, mask=True), 200, True),
        ("topsis_kinds", unmasked(k3), k3[-2], kinds_bound(5, n, 0),
         dict(**k3s, N=n, C=5, mask=False), 200, False),
        ("topsis_kinds", k3c6, None, kinds_bound(6, n, 1),
         dict(**k3s, N=n, C=6, mask=True), 200, False),
        ("topsis_kinds", unmasked(k3c6), k3c6[-2], kinds_bound(6, n, 0),
         dict(**k3s, N=n, C=6, mask=False), 200, False),
        # a queue-pressure wake's scoring: one pod, C = 6, masked
        ("topsis_kinds",
         ops.kinds_operands(kinds6, kidx[:1], w6, b6, valid=valid[:1],
                            device=dev),
         None, kinds_bound(6, n, 1, p=1), dict(K=k, P=1, N=n, C=6, mask=True),
         200, False),
        ("topsis_kinds",
         ops.kinds_operands(kinds5r, kidx, w5, b5, valid=valid_r, device=dev),
         None, kinds_bound(5, n + 1, 1),
         dict(**k3s, N=n + 1, C=5, mask=True), 200, False),
        ("topsis_grid", k4, None, grid_bound(5, n, 1),
         dict(**k4s, N=n, C=5, mask=True), 50, True),
        ("topsis_grid", unmasked(k4), k4[-2], grid_bound(5, n, 0),
         dict(**k4s, N=n, C=5, mask=False), 50, False),
        ("topsis_grid", k4c6, None, grid_bound(6, n, 1),
         dict(**k4s, N=n, C=6, mask=True), 50, False),
        ("topsis_grid",
         ops.grid_operands(kinds5r[kidx[:GRID_P]], grid_w, b5,
                           valid=valid_r[:GRID_P], device=dev),
         None, grid_bound(5, n + 1, 1),
         dict(**k4s, N=n + 1, C=5, mask=True), 50, False),
    ]
    kernels = {"topsis_kinds": (tc.kinds, tc.kinds_plain),
               "topsis_grid": (tc.grid, tc.grid_plain)}
    for name, args, pair_mask, (b_ms, b_by), shape, reps, controls \
            in fused:
        kernel, plain = kernels[name]
        before = tc.LAUNCHES[name]
        got = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(err <= TOL, f"{name} {shape}: max abs err {err} > {TOL}")
        extra = {}
        if controls:
            nofill = control(got, plain(*unmasked(args)))
            fewer = control(got, plain(*args[:-1], args[-1] - 1))
            check(nofill == "pattern",
                  f"{name}: the plain version without its fill passed")
            check(fewer == "pattern" or fewer > TOL,
                  f"{name}: the plain version over C - 1 criteria passed "
                  f"({fewer})")
            extra = dict(control_no_fill="rejected(-inf pattern)",
                         control_c_minus_1=f"rejected({fewer:.3e})")
        del want
        out = torch.empty_like(got)
        launch = raw_launch(name, args, out)
        ms = cuda_ms(launch, reps)
        check(launch() == 0, f"{name}: timed launch failed")
        if pair_mask is not None:
            def fill():
                return ops.fill_invalid(out, pair_mask)
            extra["fill_ms"] = f"{cuda_ms(fill, reps):.6f}"
            extra["unfused_pair_ms"] = \
                f"{cuda_ms(lambda: (launch(), fill()), reps):.6f}"
        wrapper_ms = cuda_ms(lambda: kernel(*args), reps)
        plain_ms = cuda_ms(lambda: plain(*args), max(reps // 10, 5))
        phase("kernels", kernel=name, **shape, max_abs_err=f"{err:.3e}",
              ms=f"{ms:.6f}", wrapper_ms=f"{wrapper_ms:.6f}",
              plain_ms=f"{plain_ms:.6f}", bound_ms=f"{b_ms:.6f}",
              bound_us=f"{1e3 * b_ms:.3f}", bound_by=b_by,
              share_of_bound=f"{b_ms / ms:.3f}", **extra,
              wrapper_launches=tc.LAUNCHES[name] - before)
        row = table.setdefault(name, dict(
            name=name, route="cuda", source=SOURCE,
            replaces=tc.REPLACES[name], launches=0, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        del got, out
        torch.cuda.empty_cache()
    return table


# K1's cases: the main path's (the slice's fleet, one pod's mask), unmasked,
# C = 6, a ragged N, N = 1, one valid node, none, the top of the reference
# scheduling sweep (past the rows a cluster holds on chip), and OUTLIER, a
# case whose invalid nodes hold values beyond every valid node's (as a full
# node does), on which the four controls run.
K1_BIG_N = 65536          # benchmarks/scheduling_time.py's largest N
K1_REPS, K1_PLAIN_REPS = 2000, 100


def k1_bound(n, c, masked):
    """K1's least time: x's c real columns and the mask read once, the
    output written once; pass A's 3 and pass B's 8 c + 5 operations a node
    and criterion at the float32 peak."""
    return bound(n * (4 * c + masked + 4), n * (11 * c + 5))


def k1_cases(dev, smi, kinds5, kinds6, kinds5r, valid, valid_r, w5, w6, b5,
             b6):
    """The fused K1 against its plain version
    (``single_reductions_plain``, ``closeness_plain``, ``fill_invalid``) on
    the card, within TOL; four planted controls must be rejected. The main
    case is timed: the kernel (CUDA events over K1_REPS back-to-back
    launches), its launch floor (the empty kernel in the same cluster
    shape, timed the same way), the plain version and the unfused launches
    it replaces, and the device times of K1 and of the empty kernel by the
    profiler. Returns the kernel table's row."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import topsis_cuda as tc

    rng = np.random.default_rng(7)
    n = kinds5.shape[1]

    def on_card(mat, w, b, mask):
        return ops.single_operands(mat, w, b, valid=mask, device=dev)

    one = np.zeros(n, bool)
    one[7777] = True
    big = rng.uniform(0.05, 10.0, (K1_BIG_N, 5))
    out_valid = rng.random(n) > 0.1
    outlier = np.where(out_valid[:, None], rng.uniform(0.05, 10.0, (n, 5)),
                       rng.uniform(10.0, 30.0, (n, 5)))
    cases = [
        ("main", on_card(kinds5[0], w5, b5, valid), True),
        ("unmasked", on_card(kinds5[0], w5, b5, None), False),
        ("c6", on_card(kinds6[0], w6, b6, valid), True),
        ("ragged", on_card(kinds5r[0], w5, b5, valid_r), True),
        ("n1", on_card(kinds5[0][:1], w5, b5, np.ones(1, bool)), True),
        ("one_valid", on_card(kinds5[0], w5, b5, one), True),
        ("no_valid", on_card(kinds5[0], w5, b5, np.zeros(n, bool)), True),
        ("big", on_card(big, w5, b5, rng.random(K1_BIG_N) > 0.1), True),
        ("outlier", on_card(outlier, w5, b5, out_valid), True),
    ]
    row = None
    errs = {}
    for tag, args, masked in cases:
        x, w, b, mask, c = args
        nn = x.shape[0]
        before = tc.LAUNCHES["topsis_single"]
        got = tc.single(*args)
        want = tc.single_plain(*args)
        torch.cuda.synchronize()
        check(tc.LAUNCHES["topsis_single"] == before + 1,
              f"K1 {tag}: not one launch")
        if bool(torch.isfinite(want).any()):
            err = max_err(got, want)
        else:                                   # no valid node: all -inf
            check(bool(torch.isneginf(got).all()), f"K1 {tag}: not all -inf")
            err = 0.0
        check(err <= TOL, f"K1 {tag}: max abs err {err} > {TOL}")
        errs[tag] = err
        b_ms, b_by = k1_bound(nn, c, masked)
        out = torch.empty_like(got)
        launch = raw_launch("topsis_single", args, out)
        reps = K1_REPS if tag in ("main", "big", "ragged") else 200
        ms = cuda_ms(launch, reps, warmup=20)
        check(launch() == 0, f"K1 {tag}: timed launch failed")
        torch.cuda.synchronize()
        check(torch.equal(out, got), f"K1 {tag}: the timed launches differ")
        extra = {}
        if tag == "main":
            extra = k1_timings(dev, args, out)
            device_us = float(extra["device_us"])
            extra["share_of_bound_device"] = f"{1e3 * b_ms / device_us:.4f}"
        if tag == "outlier":
            extra = k1_controls(args, got)
        resident = nn <= tc.single_resident_rows()
        phase("kernels", kernel="topsis_single", case=tag, N=nn, C=c,
              mask=mask is not None, resident=resident,
              max_abs_err=f"{err:.3e}", ms=f"{ms:.6f}",
              bound_ms=f"{b_ms:.6f}", bound_us=f"{1e3 * b_ms:.3f}",
              bound_by=b_by, share_of_bound=f"{b_ms / ms:.4f}", **extra,
              card=repr(smi))
        if tag == "main":
            row = dict(name="topsis_single", route="cuda", source=SOURCE,
                       replaces=tc.REPLACES["topsis_single"], launches=0,
                       max_abs_err=0.0, ms=ms,
                       plain_ms=float(extra["plain_ms"]), bound_ms=b_ms,
                       bound_by=b_by, library_ms=None)
        del got, want, out
    row["max_abs_err"] = max(errs.values())
    return row


def kernel_device_us(fn, name, reps=200):
    """Mean device time (us) of the kernels whose name holds ``name`` over
    ``reps`` calls of ``fn``, by torch.profiler (NaN where it records
    none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and name in ev.key:
            total += ev.self_device_time_total
            count += ev.count
    return total / count if count else float("nan")


def k1_timings(dev, args, out):
    """The main case's times beside the kernel's: launch floor, plain
    version, the unfused launches, the wrapper, and the device times of K1
    and of the empty kernel by the profiler. Back-to-back launches from
    Python are bound by the host's launch rate at this size, so ``ms`` and
    ``launch_floor_ms`` read the host; the device times read the kernel."""
    import torch

    from repro_torch.kernels import topsis_cuda as tc
    x, w, b, mask, c = args
    floor_fn = tc.LIBRARY.lib.topsis_cluster_floor
    stream = torch.cuda.current_stream().cuda_stream

    def floor():
        return floor_fn(dev.index, stream)

    def unfused():
        operands = tc.single_reductions_plain(x, w, b, mask, c)
        return tc.fill_invalid(tc.closeness_plain(x, *operands, c), mask)
    floor_ms = cuda_ms(floor, K1_REPS, warmup=20)
    check(floor() == 0, "K1's launch floor did not launch")
    device_us = kernel_device_us(raw_launch("topsis_single", args, out),
                                 "topsis_single_kernel")
    floor_us = kernel_device_us(floor, "cluster_floor")
    check(math.isfinite(device_us) and math.isfinite(floor_us),
          f"the profiler recorded no K1 ({device_us}) or floor ({floor_us}) "
          f"device time")
    wrapper_ms = cuda_ms(lambda: tc.single(*args), 1000)
    plain_ms = cuda_ms(lambda: tc.single_plain(*args), K1_PLAIN_REPS)
    return dict(cluster=tc.SINGLE_CLUSTER, launch_floor_ms=f"{floor_ms:.6f}",
                device_us=f"{device_us:.3f}",
                floor_device_us=f"{floor_us:.3f}",
                wrapper_ms=f"{wrapper_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
                unfused_ms=f"{cuda_ms(unfused, K1_PLAIN_REPS):.6f}")


def k1_controls(args, got):
    """Four planted faults in plain torch, each of which must be rejected
    (the -inf pattern, or an error beyond TOL): no -inf fill, the ideal
    points over all rows, the norms over the valid rows only, C - 1
    criteria."""
    from repro_torch.kernels import topsis_cuda as tc
    x, w, b, mask, c = args
    ops_ok = tc.single_reductions_plain(x, w, b, mask, c)
    ops_all_rows = tc.single_reductions_plain(x, w, b, None, c)
    # norms (and the ideal points built on them) over the valid rows only
    ops_valid_rows = tc.single_reductions_plain(x[mask], w, b, None, c)
    controls = {
        "no_fill": tc.closeness_plain(x, *ops_ok, c),
        "ideal_all_rows": tc.fill_invalid(
            tc.closeness_plain(x, *ops_all_rows, c), mask),
        "norms_valid_rows": tc.fill_invalid(
            tc.closeness_plain(x, *ops_valid_rows, c), mask),
        "c_minus_1": tc.single_plain(x, w[:c - 1], b[:c - 1], mask, c - 1),
    }
    fields = {}
    for name, want in controls.items():
        res = control(got, want)
        check(res == "pattern" or res > TOL,
              f"K1 control {name} passed ({res})")
        fields[f"control_{name}"] = ("rejected(-inf pattern)"
                                     if res == "pattern"
                                     else f"rejected({res:.3e})")
    return fields


# --- phase 3b: K5 and K8 against their plain versions ---------------------------
def _attention_case(dev, gen, b, h, hkv, s, d, dtype):
    import torch
    q, k, v = (torch.randn((b, n, s, d), generator=gen, device=dev)
               for n in (h, hkv, hkv))
    return q.mul_(K5_Q_STD).to(dtype), k.to(dtype), v.to(dtype)


def attention_pairs(s, window):
    """Valid (query, key) pairs of a causal (optionally windowed) s x s
    mask: the work K5 does after skipping masked tiles' arithmetic."""
    if window is None:
        return s * (s + 1) // 2
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def attention_fault(q, k, v, *, sm_scale, causal=True, window=None,
                    kv_len=None, fault="p_bf16"):
    """K5's function with a planted fault, in plain torch: ``p_bf16``
    rounds the normalised probabilities to bf16 before P.V (what ``_sdpa``
    does); ``diagonal_tile`` drops the keys of each query's own K5_TILE
    tile; ``half_d`` writes only out's first HALF_D columns (the rest 0).
    Returns (out, lse) as ``flash_fwd`` does."""
    import torch

    from repro_torch.kernels import flash_cuda as fc
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = (q.float() * sm_scale).reshape(b, hkv, h // hkv, sq, d)
    z = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float())
    ok = fc.mask(sq, skv, causal=causal, window=window,
                 kv_len=skv if kv_len is None else kv_len, device=q.device)
    if fault == "diagonal_tile":
        qt = torch.arange(sq, device=q.device)[:, None] // K5_TILE
        ok = ok & (torch.arange(skv, device=q.device)[None, :] // K5_TILE
                   != qt)
    z = torch.where(ok, z, fc.NEG_BIG)
    m = torch.amax(z, dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(z - m), 0.0)
    del z
    lm = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    if fault == "p_bf16":
        acc = torch.einsum("bkgqt,bktd->bkgqd",
                           (p / lm).to(torch.bfloat16).float(), v.float())
    else:
        acc = torch.einsum("bkgqt,bktd->bkgqd", p, v.float()) / lm
    if fault == "half_d":
        acc[..., HALF_D:] = 0
    out = acc.to(q.dtype).reshape(b, h, sq, d)
    return out, (m + torch.log(lm)).reshape(b, h, sq)


def row_name(name, d):
    """The kernel table's row of kernel ``name`` at head dim ``d``: the
    D = 256 instantiations have rows of their own."""
    return f"{name}_d{WIDE_D}" if d == WIDE_D else name


def k5_agreement(out, lse, pout, plse):
    """(passes, max |out err|, max |lse err|, share of out elements that
    differ) of K5's (out, lse) against the plain version's."""
    ok_o, err, share = agreement(out, pout)
    ok_l, err_lse, _ = agreement(lse, plse)
    return ok_o and ok_l, err, err_lse, share


def lm_kernel_phase(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_cuda as fc
    from repro_torch.kernels import rmsnorm_cuda as rc
    from repro_torch.models import layers

    gen = torch.Generator(device=dev).manual_seed(0)
    table = {}
    for tag, b, h, hkv, s, d, dname, window, reps in K5_CASES:
        dtype = getattr(torch, dname)
        q, k, v = _attention_case(dev, gen, b, h, hkv, s, d, dtype)
        scale = d ** -0.5
        kw = dict(sm_scale=scale, causal=True, window=window)
        out, lse = fc.flash_fwd(q, k, v, **kw)
        pout, plse = fc.flash_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        ok, err, err_lse, share = k5_agreement(out, lse, pout, plse)
        check(ok, f"K5 {tag}: out err {err} (differing share {share}), "
              f"lse err {err_lse}, beyond the {dname} limits")
        faults = {}
        if tag in K5_FAULT_CASES:
            for fault in ("p_bf16", "diagonal_tile") + (
                    ("half_d",) if d == WIDE_D else ()):
                f_ok, f_err, f_lse, f_share = k5_agreement(
                    *attention_fault(q, k, v, **kw, fault=fault), pout, plse)
                check(not f_ok, f"K5 {tag}: the check passed planted fault "
                      f"{fault} (out err {f_err}, share {f_share})")
                faults[fault] = f"{f_err:.3e}/{f_lse:.3e}/{f_share:.4f}"
        ms = cuda_ms(lambda: fc.flash_fwd(q, k, v, **kw), reps)
        plain_ms = cuda_ms(lambda: fc.flash_fwd_plain(q, k, v, **kw), 3,
                           warmup=1)
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                q, k, v, is_causal=True, scale=scale, enable_gqa=True)
        else:
            allowed = fc.mask(s, s, causal=True, window=window, kv_len=s,
                              device=dev)
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                q, k, v, attn_mask=allowed, scale=scale, enable_gqa=True)
        lib_err = float((lib().float() - pout.float()).abs().max())
        library_ms = cuda_ms(lib, reps)
        elt = q.element_size()
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * elt \
            + lse.numel() * 4
        flops = 4 * d * b * h * attention_pairs(s, window)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS if dtype ==
                           torch.bfloat16 else FP32_FLOPS)
        phase("kernels", kernel="flash_attention_fwd", case=tag, B=b, H=h,
              Hkv=hkv, S=s, D=d, dtype=dname, window=window,
              max_abs_err=f"{err:.3e}", lse_max_abs_err=f"{err_lse:.3e}",
              differing_share=f"{share:.2e}",
              max_abs_out=f"{float(pout.float().abs().max()):.3f}",
              library_max_abs_err=f"{lib_err:.3e}", ms=f"{ms:.6f}",
              plain_ms=f"{plain_ms:.6f}", library_ms=f"{library_ms:.6f}",
              bound_ms=f"{b_ms:.6f}", bound_by=b_by,
              tflops=f"{flops / ms / 1e9:.2f}")
        if faults:
            # out err / lse err / share of out elements that differ
            phase("kernels", kernel="flash_attention_fwd", case=tag,
                  planted_faults_rejected=",".join(faults),
                  **{f"{f}_err": r for f, r in faults.items()})
        rname = row_name(fc.NAME, d)
        row = table.setdefault(rname, dict(
            name=rname, route="cuda",
            source=f"{CSRC}/flash_attention.cu", replaces=fc.REPLACES[fc.NAME],
            launches=0, max_abs_err=max(err, err_lse), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms))
        row["max_abs_err"] = max(row["max_abs_err"], err, err_lse)
        del q, k, v, out, lse, pout, plse
        torch.cuda.empty_cache()
    # every other head dim the kernel is built for, at a small shape
    for d in fc.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _attention_case(dev, gen, *K5_SMALL, d, dtype)
            for causal, window in ((True, None), (False, None), (True, 48)):
                kw = dict(sm_scale=d ** -0.5, causal=causal, window=window)
                ok, err, err_lse, share = k5_agreement(
                    *fc.flash_fwd(q, k, v, **kw),
                    *fc.flash_fwd_plain(q, k, v, **kw))
                check(ok, f"K5 D={d} {dtype} causal={causal} "
                      f"window={window}: out err {err} (share {share}), "
                      f"lse err {err_lse}")
                row = table[row_name(fc.NAME, d)]
                row["max_abs_err"] = max(row["max_abs_err"], err, err_lse)
    phase("kernels", kernel="flash_attention_fwd", head_dims_checked=str(
        fc.HEAD_DIMS).replace(" ", ""),
          shape="B={},H={},Hkv={},S={}".format(*K5_SMALL))
    rows, d = K8_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
        g = torch.randn(d, generator=gen, device=dev)
        y = rc.rmsnorm(x, g, 1e-6)
        yp = rc.rmsnorm_plain(x, g, 1e-6)
        torch.cuda.synchronize()
        dname = str(dtype).split(".")[1]
        ok, err, share = agreement(y, yp)
        check(ok, f"K8 {dname}: err {err} (differing share {share})")
        fault = {}
        if dtype == torch.bfloat16:
            # the model's RMSNorm, which rounds before the gamma multiply
            f_ok, f_err, f_share = agreement(layers.rmsnorm(x, g, 1e-6), yp)
            check(not f_ok, "K8: the check passed the model's RMSNorm")
            fault = dict(model_rmsnorm_err=f"{f_err:.3e}/{f_share:.4f}")
        ms = cuda_ms(lambda: rc.rmsnorm(x, g, 1e-6), 100)
        plain_ms = cuda_ms(lambda: rc.rmsnorm_plain(x, g, 1e-6), 20)
        gl = g.to(dtype)
        library_ms = cuda_ms(lambda: F.rms_norm(x, (d,), gl, 1e-6), 100)
        # the same bytes moved by a plain device copy: the memory rate the
        # card reaches in practice, beside the data sheet's in the bound
        dst = torch.empty_like(x)
        copy_ms = cuda_ms(lambda: dst.copy_(x), 100)
        del dst
        nbytes = 2 * x.numel() * x.element_size() + g.numel() * 4
        b_ms, b_by = bound(nbytes, 4 * rows * d)
        phase("kernels", kernel="rmsnorm_fwd", R=rows, D=d, dtype=dname,
              max_abs_err=f"{err:.3e}", differing_share=f"{share:.2e}",
              **fault, ms=f"{ms:.6f}",
              plain_ms=f"{plain_ms:.6f}", library_ms=f"{library_ms:.6f}",
              copy_ms=f"{copy_ms:.6f}", bound_ms=f"{b_ms:.6f}",
              bound_by=b_by, gb_per_s=f"{nbytes / ms / 1e6:.1f}")
        row = table.setdefault("rmsnorm_fwd", dict(
            name="rmsnorm_fwd", route="cuda", source=f"{CSRC}/rmsnorm.cu",
            replaces=rc.REPLACES, launches=0, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms))
        row["max_abs_err"] = max(row["max_abs_err"], err)
    # every path of K8 at a small row count
    widths = []
    for dtype in (torch.bfloat16, torch.float32):
        n = 16 // torch.tensor([], dtype=dtype).element_size()
        for d in [n * v for v in K8_VECTORS] + [3 * n + 1]:
            x = torch.randn((K8_ROWS, d), generator=gen, device=dev).to(dtype)
            g = torch.randn(d, generator=gen, device=dev)
            ok, err, share = agreement(rc.rmsnorm(x, g, 1e-6),
                                       rc.rmsnorm_plain(x, g, 1e-6))
            check(ok, f"K8 {dtype} D={d}: err {err} (differing share "
                  f"{share})")
            table["rmsnorm_fwd"]["max_abs_err"] = max(
                table["rmsnorm_fwd"]["max_abs_err"], err)
            widths.append(d)
    phase("kernels", kernel="rmsnorm_fwd", rows=K8_ROWS,
          widths_checked=",".join(map(str, widths)))
    return table


# --- phase 3c: K6 and K7 against their plain version ------------------------------
def _bwd_fault(q, k, v, do, lse, dd, *, sm_scale, causal=True, window=None,
               kv_len=None, fault):
    """The backward of K5 from lse and dd in plain torch, with a planted
    fault: ``first_head`` sums dk and dv over the first query head of each
    GQA group only; ``no_dd`` leaves the dd term out of ds;
    ``diagonal_tile`` drops each query's own K5_TILE key tile from dq (K6
    without its diagonal tile); ``dsk_bf16`` rounds ds to bf16 before
    dS.K (K6 without the hi/lo split of its tensor-core operand),
    ``p_bf16`` rounds p to bf16 before P^T.dO and ``ds_bf16`` rounds ds to
    bf16 before dS^T.Q (K7 without it); ``half_d`` writes only the first
    HALF_D columns of dk and dv (the rest 0). Returns (dq, dk, dv)."""
    import torch

    from repro_torch.kernels import flash_cuda as fc
    hkv, skv = k.shape[1], k.shape[2]
    sq, g = q.shape[2], q.shape[1] // hkv
    ok = fc.mask(sq, skv, causal=causal, window=window,
                 kv_len=skv if kv_len is None else kv_len, device=q.device)
    ok_dq = ok
    if fault == "diagonal_tile":
        qt = torch.arange(sq, device=q.device)[:, None] // K5_TILE
        ok_dq = ok & (torch.arange(skv, device=q.device)[None, :] // K5_TILE
                      != qt)
    n = 1 if fault == "first_head" else g

    def rounded(x, which):
        return x.to(torch.bfloat16).float() if fault == which else x

    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    for bi in range(q.shape[0]):
        for kh in range(hkv):
            hs = slice(kh * g, (kh + 1) * g)
            qf, dof = q[bi, hs].float(), do[bi, hs].float()
            kf, vf = k[bi, kh].float(), v[bi, kh].float()
            s = torch.matmul(qf, kf.T) * sm_scale
            p = torch.where(ok, torch.exp(s - lse[bi, hs, :, None]), 0.0)
            del s
            dp = torch.matmul(dof, vf.T)
            if fault != "no_dd":
                dp = dp - dd[bi, hs, :, None]
            ds = p * dp * sm_scale
            del dp
            dq[bi, hs] = torch.matmul(
                rounded(torch.where(ok_dq, ds, 0.0), "dsk_bf16"), kf)
            dk[bi, kh] = torch.einsum("gqt,gqd->td",
                                      rounded(ds[:n], "ds_bf16"), qf[:n])
            dv[bi, kh] = torch.einsum("gqt,gqd->td",
                                      rounded(p[:n], "p_bf16"), dof[:n])
    if fault == "half_d":
        dk[..., HALF_D:] = 0
        dv[..., HALF_D:] = 0
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def grad_agreement(got, want):
    """(passes, max |got - want|, share of elements that differ) of a
    kernel's gradient against the plain version's: bf16 by agreement()'s
    one-ulp rule, float32 within BWD_F32_REL of the largest |want|."""
    import torch
    if got.dtype == torch.bfloat16:
        return agreement(got, want)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{got.shape} {got.dtype} vs {want.shape} {want.dtype}")
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    return (err <= BWD_F32_REL * scale, err,
            float((got != want).double().mean()))


def bwd_kernel_phase(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_cuda as fc

    gen = torch.Generator(device=dev).manual_seed(1)
    table = {}
    names = ("dq", "dk", "dv")
    for tag, b, h, hkv, s, d, dname, window, reps in BWD_CASES:
        dtype = getattr(torch, dname)
        q, k, v = _attention_case(dev, gen, b, h, hkv, s, d, dtype)
        do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        scale = d ** -0.5
        kw = dict(sm_scale=scale, causal=True, window=window)
        out, lse = fc.flash_fwd(q, k, v, **kw)
        dd = torch.sum(do.float() * out.float(), dim=-1)
        got = (fc.flash_bwd_dq(q, k, v, do, lse, dd, **kw),
               *fc.flash_bwd_dkv(q, k, v, do, lse, dd, **kw))
        want = fc.flash_bwd_plain(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        res = dict(zip(names, map(grad_agreement, got, want)))
        for n, (ok, err, share) in res.items():
            check(ok, f"K6/K7 {tag} d{n}: err {err} (differing share "
                  f"{share}) beyond the {dname} limit")
        faults, split = {}, {}
        # one head per group is no fault where the group is one head (MHA:
        # gemma-7b); at D = 256 the half-D control takes its place here,
        # and first_head is held at D = 256 at K5_SMALL (a group of 4)
        controls = (("first_head",) if h > hkv else ()) \
            + ("no_dd", "diagonal_tile") \
            + (("half_d",) if d == WIDE_D else ()) \
            + (("dsk_bf16", "p_bf16", "ds_bf16") if dtype == torch.bfloat16
               else ())
        for fault in controls:
            f_res = list(map(grad_agreement, _bwd_fault(
                q, k, v, do, lse, dd, **kw, fault=fault), want))
            check(not all(r[0] for r in f_res), f"K6/K7 {tag}: the check "
                  f"passed planted fault {fault}")
            faults[fault] = "/".join(f"{r[1]:.3e}" for r in f_res)
            if fault == "dsk_bf16":
                # the share of dq elements that differ from plain, beside
                # the kernel's (the split's control)
                split[fault] = f"{f_res[0][2]:.4f}"
            elif fault in ("p_bf16", "ds_bf16"):
                # the share of dk / dv elements that differ from plain,
                # beside the kernel's (the split's controls)
                split[fault] = "/".join(f"{r[2]:.4f}" for r in f_res[1:])
        dq_ms = cuda_ms(lambda: fc.flash_bwd_dq(q, k, v, do, lse, dd, **kw),
                        reps)
        dkv_ms = cuda_ms(lambda: fc.flash_bwd_dkv(q, k, v, do, lse, dd, **kw),
                         reps)
        plain_ms = cuda_ms(lambda: fc.flash_bwd_plain(q, k, v, out, lse, do,
                                                      **kw), 3, warmup=1)
        library_ms, lib_err = None, None
        if window is None:
            # the yardstick: autograd's backward of SDPA, dq, dk and dv
            # together (never called by the port)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                               scale=scale, enable_gqa=True)
            lib = lambda: torch.autograd.grad(      # noqa: E731
                o, leaves, do, retain_graph=True)
            lib_err = max(float((x.float() - w.float()).abs().max())
                          for x, w in zip(lib(), want))
            library_ms = cuda_ms(lib, reps)
            del o, leaves
        elt = q.element_size()
        pairs = attention_pairs(s, window)
        # inputs q, do, k, v (elt) and lse, dd (float32); outputs
        inputs = (2 * q.numel() + k.numel() + v.numel()) * elt \
            + 2 * lse.numel() * 4
        peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        rows = {fc.DQ: (dq_ms, bound(inputs + q.numel() * elt,
                                     6 * d * b * h * pairs, peak),
                        6 * d * b * h * pairs, ("dq",)),
                fc.DKV: (dkv_ms, bound(inputs + 2 * k.numel() * elt,
                                       8 * d * b * h * pairs, peak),
                         8 * d * b * h * pairs, ("dk", "dv"))}
        for name, (ms, (b_ms, b_by), flops, outs) in rows.items():
            err = max(res[n][1] for n in outs)
            phase("kernels", kernel=name, case=tag, B=b, H=h, Hkv=hkv, S=s,
                  D=d, dtype=dname, window=window,
                  **{f"d{n[1:]}_max_abs_err": f"{res[n][1]:.3e}"
                     for n in outs},
                  **{f"d{n[1:]}_differing_share": f"{res[n][2]:.2e}"
                     for n in outs},
                  ms=f"{ms:.6f}", plain_ms_dq_dk_dv=f"{plain_ms:.6f}",
                  library_ms_dq_dk_dv=(None if library_ms is None
                                       else f"{library_ms:.6f}"),
                  library_max_abs_err=(None if lib_err is None
                                       else f"{lib_err:.3e}"),
                  bound_ms=f"{b_ms:.6f}", bound_by=b_by,
                  tflops=f"{flops / ms / 1e9:.2f}")
            rname = row_name(name, d)
            row = table.setdefault(rname, dict(
                name=rname, route="cuda",
                source=f"{CSRC}/flash_attention_bwd.cu",
                replaces=fc.REPLACES[name], launches=0, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms))
            row["max_abs_err"] = max(row["max_abs_err"], err)
        # dq / dk / dv max |err| of each planted fault
        phase("kernels", kernel="flash_attention_bwd", case=tag,
              planted_faults_rejected=",".join(faults),
              **{f"{f}_err": r for f, r in faults.items()},
              max_abs_grad="/".join(f"{float(w.float().abs().max()):.3f}"
                                    for w in want))
        if split:
            phase("kernels", kernel="flash_attention_bwd_dq", case=tag,
                  dq_differing_share=f"{res['dq'][2]:.4f}",
                  control_dsk_bf16_dq_differing_share=split.pop("dsk_bf16"),
                  flip_share_limit=BF16_FLIP_SHARE)
            phase("kernels", kernel="flash_attention_bwd_dkv", case=tag,
                  dk_dv_differing_share=f"{res['dk'][2]:.4f}/"
                  f"{res['dv'][2]:.4f}",
                  **{f"control_{f}_dk_dv_differing_share": r
                     for f, r in split.items()},
                  flip_share_limit=BF16_FLIP_SHARE)
        del q, k, v, do, out, lse, dd, got, want
        torch.cuda.empty_cache()
    # every head dim the kernels are built for, at a small shape
    small_faults = []
    for d in fc.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _attention_case(dev, gen, *K5_SMALL, d, dtype)
            do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
            for causal, window, kv_len in ((True, None, None),
                                           (False, None, 300),
                                           (True, 48, None)):
                kw = dict(sm_scale=d ** -0.5, causal=causal, window=window,
                          kv_len=kv_len)
                out, lse = fc.flash_fwd(q, k, v, **kw)
                got = fc.flash_bwd(q, k, v, out, lse, do, **kw)
                want = fc.flash_bwd_plain(q, k, v, out, lse, do, **kw)
                for n, g_, w_, name in zip(names, got, want,
                                           (fc.DQ, fc.DKV, fc.DKV)):
                    ok, err, share = grad_agreement(g_, w_)
                    check(ok, f"K6/K7 D={d} {dtype} causal={causal} "
                          f"window={window} kv_len={kv_len} d{n}: err {err} "
                          f"(share {share})")
                    row = table[row_name(name, d)]
                    row["max_abs_err"] = max(row["max_abs_err"], err)
                if d == WIDE_D and causal and window is None:
                    # D = 256 with a GQA group of 4: the controls that a
                    # group of one cannot hold
                    dd = torch.sum(do.float() * out.float(), dim=-1)
                    for fault in ("first_head", "half_d"):
                        f_res = list(map(grad_agreement, _bwd_fault(
                            q, k, v, do, lse, dd, **kw, fault=fault), want))
                        check(not all(r[0] for r in f_res),
                              f"K6/K7 D={d} {dtype}: the check passed "
                              f"planted fault {fault}")
                    small_faults.append(str(dtype).split(".")[1])
    phase("kernels", kernel="flash_attention_bwd", head_dims_checked=str(
        fc.HEAD_DIMS).replace(" ", ""),
          shape="B={},H={},Hkv={},S={}".format(*K5_SMALL),
          d256_planted_faults_rejected="first_head,half_d",
          d256_fault_dtypes=",".join(small_faults))
    return table


# --- phase 4: the slice ---------------------------------------------------------
def scenario_fleet():
    """The slice's fleet: GKE's documented per-cluster node limit."""
    from repro_torch.cluster.node import make_scenario_cluster
    return make_scenario_cluster("mixed", N_NODES, seed=0)


def placements(res):
    return [(r.pod.uid, r.node, r.start_s) for r in res.records]


def make_checked_scheduler(dev, stats):
    """A BatchScheduler that, after every cuda round, scores the same queue
    on the same fleet with the torch (card) and numpy backends and holds
    the round to them; at the middle round it also drives the weight grid
    (K4), a full-rebuild round (K2) and per-pod GreenPod decisions (K1) on
    the live fleet."""
    import numpy as np

    from repro_torch.cluster.parity import max_err_np, near_tie_walk
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
            args = ops.kinds_operands(self._dev, kind_idx, ws,
                                      self._benefit, valid=valid, device=dev)
            torch.cuda.synchronize()
            stats["operands_s"] = time.perf_counter() - t0
            # the round's launch: the mask in, the -inf fill fused
            out = tc.kinds(*args)
            launch = raw_launch("topsis_kinds", args, torch.empty_like(out))
            stats["kernel_s"] = cuda_ms(launch, 20) / 1e3
            stats["wrapper_s"] = cuda_ms(lambda: tc.kinds(*args), 20) / 1e3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = out.cpu().numpy()
            stats["d2h_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            S._greedy_assign(host, pods, nodes)
            stats["greedy_s"] = time.perf_counter() - t0

    return TimedBatchScheduler


def slice_phase(dev):
    import numpy as np
    import torch

    from repro_torch.cluster.parity import engine_scheduler
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
            cluster_factory=scenario_fleet,
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


# --- phase 4b: the per-pod decisions ------------------------------------------
PERPOD_PODS = 64


def perpod_phase(dev, smi, compare=False):
    """The per-pod GreenPod path (the paper's scheduler, §III, and the
    scheduling time of §IV.C): the first PERPOD_PODS pods of the slice's
    arrival process decided one at a time on the slice's 15,000-node
    fleet, each bound before the next (the rescore after every bind), for
    the cuda and torch backends (attached, on the card: K1 on the resident
    mirror, or plain torch) and numpy, each on its own copy of the fleet.
    Every cuda and torch decision is held to a numpy scheduler attached to
    the same fleet: closeness within TOL, the same node or a near-tie.
    Prints each backend's decision wall times (host clock; each decision
    ends in its device-to-host copy), the device kernels of clean-fleet
    cuda decisions by ``torch.profiler`` (``profile_clean_decisions``, in
    a child process) and the steps of a decision (``decision_parts``).
    Returns the cuda run's launch counts.

    ``compare`` (``--perpod-only``: this script copied into another
    checkout, such as the parent commit's, to time its per-pod path) warms
    each device backend up with one untimed run first, reports the
    profiled decisions' kernels without requiring K1 alone, and leaves out
    the step-by-step breakdown, which reads this package's internals."""
    import numpy as np
    import torch

    from repro_torch.cluster.node import FleetState
    from repro_torch.cluster.parity import max_err_np
    from repro_torch.cluster.workload import PoissonArrivals
    from repro_torch.core import scheduler as S
    from repro_torch.kernels import topsis_cuda as tc

    arrivals = PoissonArrivals(rate_per_s=0.2, n_bursts=N_BURSTS,
                               burst_size=BURST, topsis_share=1.0, seed=0)
    pods = [p for _, burst in arrivals.events() for p in burst]
    pods = pods[:PERPOD_PODS]

    def run(backend):
        fleet = FleetState.from_nodes(scenario_fleet())
        sched = S.GreenPodScheduler("energy_centric", backend=backend,
                                    device=None if backend == "numpy"
                                    else dev)
        sched.attach(fleet)
        ref = None
        if backend != "numpy":
            ref = S.GreenPodScheduler("energy_centric", backend="numpy")
            ref.attach(fleet)
        res = dict(walls=[], picks=[], err=0.0, ties=0, gap=0.0)
        tc.reset_launches()
        for pod in pods:
            t0 = time.perf_counter()
            idx, diag = sched.select(pod, fleet)
            res["walls"].append(time.perf_counter() - t0)
            if ref is not None:
                ridx, rdiag = ref.select(pod, fleet)
                cc = rdiag["closeness"]
                res["err"] = max(res["err"],
                                 max_err_np(diag["closeness"], cc))
                if idx != ridx:
                    gap = abs(cc[ridx] - cc[idx])
                    check(gap <= TOL, f"perpod {backend}: pod {pod.uid} "
                          f"node {idx} vs {ridx}, gap {gap} > {TOL}")
                    res["ties"] += 1
                    res["gap"] = max(res["gap"], float(gap))
            check(idx is not None, f"perpod {backend}: pod {pod.uid} "
                  f"unschedulable")
            fleet.bind(idx, pod.cpu, pod.mem)
            res["picks"].append(idx)
        res["launches"] = dict(tc.LAUNCHES)
        res.update(sched=sched, fleet=fleet)
        return res

    if compare:                    # the build and the first launches
        run("cuda")
        run("torch")
    runs = {b: run(b) for b in ("cuda", "torch", "numpy")}
    for backend, res in runs.items():
        k1 = res["launches"]["topsis_single"]
        check(k1 == (PERPOD_PODS if backend == "cuda" else 0),
              f"perpod {backend}: K1 launched {k1} times")
        check(sum(res["launches"].values()) == k1,
              f"perpod {backend}: other kernels launched {res['launches']}")
        same = res["picks"] == runs["numpy"]["picks"]
        if res["ties"] == 0:
            check(same, f"perpod {backend}: placements differ from numpy "
                  f"with no near-tie")
        walls = 1e3 * np.asarray(res["walls"])
        phase("perpod", backend=backend, nodes=N_NODES, decisions=len(walls),
              k1_launches=k1, wall_ms_median=f"{np.median(walls):.6f}",
              wall_ms_p90=f"{np.percentile(walls, 90):.6f}",
              wall_ms_min=f"{walls.min():.6f}",
              wall_ms_max=f"{walls.max():.6f}",
              max_err_vs_numpy=f"{res['err']:.3e}", near_ties=res["ties"],
              max_near_tie_gap=f"{res['gap']:.3e}",
              placements_equal_numpy=same, card=repr(smi))

    # clean-fleet cuda decisions under the profiler, in a fresh process:
    # in this one, after the phases before, torch.profiler has recorded no
    # device activity at all (H100, torch 2.11)
    prof = None
    for _ in range(PROFILE_ATTEMPTS):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), PROFILE_FLAG],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode == 0 and lines:
            prof = json.loads(lines[-1])
            if prof["kernels"] or prof["copies"]:
                break
    check(prof is not None, f"the profiling process failed: {proc.stderr}")
    kernels = prof["kernels"]
    check(compare or (sum(kernels.values()) == PERPOD_PROFILED
                      and all("topsis_single_kernel" in k for k in kernels)),
          f"{PERPOD_PROFILED} clean cuda decisions ran {kernels} "
          f"(and {prof['copies']} copies), not one K1 each")
    phase("perpod", clean_decisions_profiled=PERPOD_PROFILED,
          kernels_per_decision=sum(kernels.values()) / PERPOD_PROFILED,
          copies_per_decision=prof["copies"] / PERPOD_PROFILED,
          k1_device_us=f"{prof['k1_device_us']:.3f}",
          device_us_per_decision=f"{prof['device_us'] / PERPOD_PROFILED:.3f}",
          kernel_names=json.dumps(list(kernels)), card=repr(smi))
    if compare:
        return runs["cuda"]["launches"]
    sched, fleet = runs["cuda"]["sched"], runs["cuda"]["fleet"]
    parts = decision_parts(dev, sched, fleet, pods[:PERPOD_PARTS])
    phase("perpod", breakdown_decisions=PERPOD_PARTS,
          **{f"{k}_ms_median": f"{1e3 * float(np.median(v)):.6f}"
             for k, v in parts.items()}, card=repr(smi))
    return runs["cuda"]["launches"]


PERPOD_PARTS = 16
PERPOD_PROFILED = 4
PROFILE_FLAG = "--profile-clean-decisions"
PERPOD_FLAG = "--perpod-only"
PROFILE_ATTEMPTS = 2


def profile_clean_decisions():
    """The child process of ``perpod_phase``: on the slice's fleet, an
    attached cuda GreenPod scheduler decides and binds a few pods, then
    one more decision consumes the last bind's dirty column, and the next
    PERPOD_PROFILED (no bind between: a clean fleet) run under
    torch.profiler. Prints the device kernels by name with their counts,
    the copies, K1's mean device time and the device time of every kernel
    and copy together as one JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cluster.node import FleetState
    from repro_torch.cluster.workload import PoissonArrivals
    from repro_torch.core import scheduler as S
    dev = torch.device("cuda", 0)
    pods = PoissonArrivals(rate_per_s=0.2, n_bursts=1, burst_size=8,
                           topsis_share=1.0, seed=0).events()[0][1]
    fleet = FleetState.from_nodes(scenario_fleet())
    sched = S.GreenPodScheduler("energy_centric", backend="cuda", device=dev)
    sched.attach(fleet)
    for pod in pods:
        idx, _ = sched.select(pod, fleet)
        fleet.bind(idx, pod.cpu, pod.mem)
    sched.select(pods[0], fleet)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PERPOD_PROFILED):
            sched.select(pods[0], fleet)
        torch.cuda.synchronize()
    kernels, copies, k1_us, device_us = {}, 0, 0.0, 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us += ev.self_device_time_total
        if ev.key.startswith(("Memcpy", "Memset")):
            copies += ev.count
            continue
        kernels[ev.key] = kernels.get(ev.key, 0) + ev.count
        if "topsis_single_kernel" in ev.key:
            k1_us += ev.self_device_time_total / ev.count
    print(json.dumps(dict(kernels=kernels, copies=copies,
                          k1_device_us=k1_us, device_us=device_us)))


def decision_parts(dev, sched, fleet, pods):
    """The steps of ``GreenPodScheduler.select`` on the cuda backend, each
    timed on the host clock (synchronised after device work), over a few
    decisions, each bound before the next, as in the run: the feasibility
    mask, the cache sync (the bound node's column), the mirror update,
    the weights, K1's arguments (the mask's upload), K1, the copy back,
    the argmax."""
    import numpy as np
    import torch

    from repro_torch.core import scheduler as S
    from repro_torch.kernels import ops
    from repro_torch.kernels import topsis_cuda as tc
    parts = collections.defaultdict(list)

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        parts[name].append(time.perf_counter() - t0)
        return res
    for pod in pods:
        valid = step("fits", lambda: fleet.fits(pod.cpu, pod.mem))
        kind_idx, dirty, moved, grew = step(
            "cache_sync", lambda: sched._cache.sync([pod], 0.0))
        sched._dev = step("mirror", lambda: S._sync_mirror(
            sched._dev, sched._cache, dirty, moved, grew, sched.device))
        w = step("weights", lambda: sched.weights(fleet))
        args = step("operands", lambda: ops.single_operands(
            sched._dev[int(kind_idx[0])], w, sched._benefit, valid=valid,
            device=dev))
        out = step("k1", lambda: tc.single(*args))
        host = step("d2h", lambda: out.cpu().numpy())
        idx = step("argmax", lambda: int(np.argmax(host)))
        fleet.bind(idx, pod.cpu, pod.mem)
    parts["sum"] = [sum(v) for v in zip(*parts.values())]
    return parts


# --- phase 4c: the scheduling round under both policies ----------------------
# The policies of tests/engine_golden_spec.py at fleet scale
# (``repro_torch.cluster.parity.policy_knobs``). Half of the slice's pods
# are deferrable, with a 300 s deadline.
POLICY_SCHEME = "carbon_centric"
ELASTIC_TIMED = ("states", "advance_to", "write_states",
                 "exclude_for_deadline")
# the policies' engine hooks, timed for their share of a run's wall time
# (AutoscaleScheduling's on_round_end holds the wake scorings' time)
HOOKS_TIMED = {"AutoscaleScheduling": ("on_clock", "on_round_start",
                                       "exclude_mask", "exclude_for",
                                       "on_round_end", "next_wake_time"),
               "CarbonScheduling": ("on_round_start", "filter_pending",
                                    "next_wake_time")}
# [pareto]: the first PARETO_P pods of the slice's first burst under the
# first PARETO_S points of the 6-criteria weight lattice; then three named
# schemes (one carbon-blind) through the engine over PARETO_BURSTS bursts
PARETO_S, PARETO_P, PARETO_BURSTS = 64, 64, 2
PARETO_SCHEMES = ("energy_centric", "carbon_centric",
                  "carbon_energy_balanced")


def policy_arrivals(n_bursts=N_BURSTS):
    from repro_torch.cluster.workload import PoissonArrivals
    return PoissonArrivals(rate_per_s=0.2, n_bursts=n_bursts,
                           burst_size=BURST, topsis_share=1.0, seed=0,
                           deferrable_share=0.5, deadline_s=300.0)


@contextlib.contextmanager
def timed_methods(cls, names, totals):
    """Add each call's host seconds of ``cls.<name>`` to ``totals[name]``
    and count it in ``totals[name + "_calls"]`` for one block (a nested
    call counts in both)."""
    from repro_torch.cluster.parity import patched

    def timer(name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                totals[name] += time.perf_counter() - t0
                totals[name + "_calls"] += 1
        return timed
    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(patched(cls, name,
                                        timer(name, getattr(cls, name))))
        yield


def policy_run(dev, backend, replay=None):
    """The [policy] scenario through ``run_scenario`` on ``backend``, with
    every scoring call recorded (``make_policy_scheduler``, which takes
    ``replay``) and the policies' hooks and the ElasticFleet's per-node
    loops timed. Returns the result and the record; ``wall`` leaves out
    the replay check's time."""
    import torch

    from repro_torch.cluster import parity as Q
    from repro_torch.cluster.simulator import run_scenario
    from repro_torch.core import carbon as C
    from repro_torch.core import elastic as E
    stats = dict(Q.policy_stats(), elastic=collections.Counter(),
                 **{cls: collections.Counter() for cls in HOOKS_TIMED})
    carbon, autoscale = Q.policy_knobs()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(Q.engine_scheduler(
            Q.make_policy_scheduler(stats, replay)))
        stack.enter_context(Q.wake_scoring(stats))
        stack.enter_context(timed_methods(E.ElasticFleet, ELASTIC_TIMED,
                                          stats["elastic"]))
        for cls, hooks in HOOKS_TIMED.items():
            owner = getattr(C if cls.startswith("Carbon") else E, cls)
            stack.enter_context(timed_methods(owner, hooks, stats[cls]))
        res = run_scenario(policy_arrivals(), POLICY_SCHEME,
                           cluster_factory=scenario_fleet, batch=True,
                           batch_backend=backend, carbon=carbon,
                           autoscale=autoscale, device=dev)
    if backend != "numpy":
        torch.cuda.synchronize()
    stats["wall"] = time.perf_counter() - t0 - stats["check_s"]
    return res, stats


def policy_phase(dev, smi):
    """The scheduling round with both policies at full size: the slice's
    fleet and arrivals (half of the pods deferrable) under
    ``carbon_centric`` with the carbon and autoscale policies, through
    ``run_scenario(batch=True)`` on cuda, then on numpy following the cuda
    run's near-tie breaks (``parity.make_policy_scheduler``): the two runs
    must then end equal — placements, start times, event log, counters,
    energy and carbon — then, after both timed runs, on cuda again with
    telemetry recording. K3 runs at C = 6 with an exclude mask on every
    call: once a round and once a wake scoring. Returns the first cuda
    run's launch counts."""
    import torch

    from repro_torch.kernels import topsis_cuda as tc

    torch.cuda.reset_peak_memory_stats()
    tc.reset_launches()
    res_cuda, cu = policy_run(dev, "cuda")
    launches = dict(tc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    res_np, nps = policy_run(dev, "numpy", replay=cu["calls"])
    tel = policy_telemetry_run(dev)
    return policy_checks(smi, tel, res_cuda, cu, launches, peak, res_np, nps)


def policy_checks(smi, tel, res_cuda, cu, launches, peak, res_np, nps):
    """[policy]'s checks and lines (see ``policy_phase``); returns the cuda
    run's launch counts."""
    import numpy as np

    rounds = [c for c in cu["calls"] if not c["wake"]]
    wakes = [c for c in cu["calls"] if c["wake"]]
    check(cu["criteria"] == {6}, f"criteria per call {cu['criteria']}")
    check(all(c["mask"] for c in cu["calls"]),
          "a policy call scored without an exclude mask")
    check(all(c["pods"] == 1 for c in wakes), "a wake scored several pods")
    check(launches["topsis_kinds"] == len(rounds) + len(wakes),
          f"K3 launches {launches['topsis_kinds']} != rounds {len(rounds)} "
          f"+ wake scorings {len(wakes)}")
    check(sum(launches.values()) == launches["topsis_kinds"],
          f"other kernels launched in the policy run: {launches}")

    def counters(r):
        return dict(unschedulable=r.unschedulable, preemptions=r.preemptions,
                    migrations=r.migrations, wakes=r.wakes, sleeps=r.sleeps)

    def energies(r):
        return dict(topsis_carbon_g=r.total_carbon_g("topsis"),
                    fleet_energy_kj=r.fleet_energy_kj(),
                    fleet_carbon_g=r.fleet_carbon_g())
    check(len(nps["calls"]) == len(cu["calls"]),
          f"numpy scored {len(nps['calls'])} times, cuda {len(cu['calls'])}")
    ties = sum(c["ties"] for c in nps["calls"])
    check(placements(res_cuda) == placements(res_np)
          and res_cuda.events == res_np.events,
          "cuda placements or events differ from numpy's beyond near-ties")
    check(counters(res_cuda) == counters(res_np),
          f"counters {counters(res_cuda)} vs {counters(res_np)}")
    e_cu, e_np = energies(res_cuda), energies(res_np)
    for key, want in e_np.items():
        check(abs(e_cu[key] - want) <= 1e-9 * abs(want),
              f"{key}: {e_cu[key]} vs {want}")

    check(tel["placements"] == placements(res_cuda)
          and tel["events"] == res_cuda.events,
          "recording telemetry changed the cuda run")
    fired = dict(counters(res_cuda), deferred_pods=tel["deferred_pods"],
                 drained_tasks=tel["drained_tasks"])
    for key in ("deferred_pods", "preemptions", "wakes", "sleeps",
                "drained_tasks"):
        check(fired[key] > 0, f"the policies never acted: {key} = 0")

    def med(calls):
        return float(np.median([c["s"] for c in calls])) if calls else 0.0
    np_rounds = [c for c in nps["calls"] if not c["wake"]]
    np_wakes = [c for c in nps["calls"] if c["wake"]]
    engine_rounds = cu["AutoscaleScheduling"]["on_clock_calls"]
    phase("policy", nodes=N_NODES, scheme=POLICY_SCHEME, criteria=6,
          engine_rounds=engine_rounds, scoring_rounds=len(rounds),
          per_pod_mask_rounds=sum(c["mask"] == 2 for c in rounds),
          round_pods_median=float(np.median([c["pods"] for c in rounds])),
          wake_scorings=len(wakes), k3_launches=launches["topsis_kinds"],
          records=len(res_cuda.records), **fired,
          placements_and_events_equal_numpy=True, near_ties=ties,
          near_tie_calls=sum(c["ties"] > 0 for c in nps["calls"]),
          near_ties_in_wakes=sum(c["ties"] for c in nps["calls"]
                                 if c["wake"]),
          max_near_tie_gap=f"{max(c['gap'] for c in nps['calls']):.3e}",
          max_err_vs_numpy=f"{max(c['err'] for c in nps['calls']):.3e}",
          topsis_carbon_g=repr(e_cu["topsis_carbon_g"]),
          fleet_energy_kj=repr(e_cu["fleet_energy_kj"]),
          fleet_carbon_g=repr(e_cu["fleet_carbon_g"]),
          max_memory_allocated=peak, card=repr(smi))
    phase("policy", wall_s_cuda=f"{cu['wall']:.3f}",
          wall_s_numpy=f"{nps['wall']:.3f}",
          wall_s_cuda_telemetry=f"{tel['wall_s']:.3f}",
          replay_check_s=f"{nps['check_s']:.3f}",
          round_s_median_cuda=f"{med(rounds):.6f}",
          round_s_median_numpy=f"{med(np_rounds):.6f}",
          wake_scorings_s_cuda=f"{sum(c['s'] for c in wakes):.6f}",
          wake_scorings_s_numpy=f"{sum(c['s'] for c in np_wakes):.6f}",
          wake_s_median_cuda=f"{med(wakes):.6f}",
          wake_s_median_numpy=f"{med(np_wakes):.6f}",
          dirty_columns_median=float(np.median(cu["dirty"])),
          dirty_columns_max=int(max(cu["dirty"])),
          dirty_columns_total=int(sum(cu["dirty"])), card=repr(smi))
    for tag, st in (("cuda", cu), ("numpy", nps)):
        el = st["elastic"]
        wake_s = sum(c["s"] + c["check_s"] for c in st["calls"]
                     if c["wake"])
        hooks = {cls: sum(st[cls][h] for h in names)
                 for cls, names in HOOKS_TIMED.items()}
        hooks["AutoscaleScheduling"] -= wake_s
        phase("policy", backend=tag, elastic_fleet_host=True,
              **{f"{k}_s": f"{el[k]:.3f}" for k in ELASTIC_TIMED},
              **{f"{k}_ms_per_round": f"{1e3 * el[k] / engine_rounds:.3f}"
                 for k in ELASTIC_TIMED},
              **{f"{k}_calls": el[f"{k}_calls"] for k in ELASTIC_TIMED},
              **{f"{cls}_hooks_s": f"{s:.3f}" for cls, s in hooks.items()},
              **{f"{cls}_share_of_wall": f"{s / st['wall']:.3f}"
                 for cls, s in hooks.items()},
              scoring_s=f"{sum(c['s'] for c in st['calls']):.3f}",
              wall_s=f"{st['wall']:.3f}")
    phase("policy", telemetry_counters=tel["counters"],
          telemetry_gauges=tel["gauges"],
          prometheus_samples=tel["prometheus_samples"],
          prometheus_round_trip=True, html_report_bytes=tel["html_bytes"])
    return launches


def policy_telemetry_run(dev):
    """The [policy] cuda run once more with telemetry recording: the
    registry's ``policy_preemptions`` and ``policy_node_sleeps`` must equal
    the run's counters, its Prometheus text must parse back to every
    counter and gauge, and ``html_report`` must render the run. Returns
    the placements and the event log (``policy_checks`` holds them to the
    first cuda run), what the policies did by the registry, and the run's
    wall time."""
    import torch

    from repro_torch.cluster.parity import policy_knobs
    from repro_torch.cluster.simulator import run_scenario
    from repro_torch.core import telemetry
    from repro_torch.telemetry import (html_report, parse_prometheus,
                                       prometheus_text)
    carbon, autoscale = policy_knobs()
    with telemetry.enabled() as tel:
        t0 = time.perf_counter()
        res = run_scenario(policy_arrivals(), POLICY_SCHEME,
                           cluster_factory=scenario_fleet, batch=True,
                           batch_backend="cuda", carbon=carbon,
                           autoscale=autoscale, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(tel.counter_value("policy_preemptions", policy="CarbonScheduling")
          == res.preemptions, "policy_preemptions != preemptions")
    check(tel.counter_value("policy_node_sleeps",
                            policy="AutoscaleScheduling") == res.sleeps,
          "policy_node_sleeps != sleeps")
    parsed = parse_prometheus(prometheus_text(tel))
    want = {(n, tuple(sorted(lb.items()))): v
            for n, lb, v in tel.counters.values()}
    want.update({(g.name, tuple(sorted(g.labels.items()))): g.value
                 for g in tel.gauges.values()})
    lost = [k for k, v in want.items() if parsed.get(k) != v]
    check(not lost, f"Prometheus round trip lost {lost[:3]}")
    html = html_report(tel, res)
    check(html.startswith("<html>") and html.endswith("</html>")
          and "<svg" in html, "html_report did not render the run's charts")
    return dict(placements=placements(res), events=res.events, wall_s=wall,
                deferred_pods=tel.counter_value("policy_deferred_pods",
                                                policy="CarbonScheduling"),
                drained_tasks=tel.counter_value("policy_drained_tasks",
                                                policy="AutoscaleScheduling"),
                counters=len(tel.counters), gauges=len(tel.gauges),
                prometheus_samples=len(parsed), html_bytes=len(html))


def pareto_phase(dev, smi):
    """The frontier layer on K4, then on the engine: ``placement_metrics``
    for the first PARETO_P pods of the slice's first burst on the slice's
    fleet under the first PARETO_S points of the 6-criteria weight lattice
    with the [policy] signal, on cuda (one K4 launch) and on numpy; then
    ``scenario_metrics`` for PARETO_SCHEMES with the carbon policy over
    PARETO_BURSTS bursts of the [policy] arrivals, on cuda and on numpy
    (following the cuda runs' near-tie breaks, as in [policy]). The
    frontiers must be equal: the first up to float64 near-ties that a
    greedy walk shows, the second exactly, with its metrics. Returns the
    cuda calls' launch counts."""
    import numpy as np

    from repro_torch.cluster.node import NodeTable
    from repro_torch.cluster import parity as Q
    from repro_torch.cluster.workload import PoissonArrivals
    from repro_torch.core import pareto
    from repro_torch.core import scheduler as S
    from repro_torch.kernels import topsis_cuda as tc

    pods = PoissonArrivals(rate_per_s=0.2, n_bursts=1, burst_size=BURST,
                           topsis_share=1.0, seed=0).events()[0][1]
    pods = pods[:PARETO_P]
    nodes = scenario_fleet()
    grid = pareto.weight_grid_upto(PARETO_S, criteria=6)
    carbon, _ = Q.policy_knobs()
    seen = {}

    class RecordingBatchScheduler(S.BatchScheduler):
        def select_many_grid(self, pods, nodes, schemes, now=0.0,
                             exclude=None):
            assign, diag = super().select_many_grid(pods, nodes, schemes,
                                                    now=now, exclude=exclude)
            seen[self.backend] = (assign, diag["closeness"])
            return assign, diag

    walls, points, launches = {}, {}, collections.Counter()
    with Q.patched(S, "BatchScheduler", RecordingBatchScheduler):
        for backend in ("cuda", "numpy"):
            tc.reset_launches()
            t0 = time.perf_counter()
            points[backend] = pareto.placement_metrics(
                pods, nodes, grid, backend=backend,
                carbon_signal=carbon.signal, device=dev)
            walls[backend] = time.perf_counter() - t0
            if backend == "cuda":
                launches.update(tc.LAUNCHES)
    check(launches["topsis_grid"] == 1 and sum(launches.values()) == 1,
          f"placement_metrics launched {dict(launches)}, not K4 once")
    (a_cu, cc_cu), (a_np, cc_np) = seen["cuda"], seen["numpy"]
    err = Q.max_err_np(cc_cu, cc_np)
    check(err <= TOL, f"placement_metrics closeness: cuda vs numpy {err}")
    table = NodeTable.from_nodes(nodes)
    ties, schemes_differ = 0, 0
    for s in range(len(grid)):
        if a_cu[s] != a_np[s]:
            schemes_differ += 1
            ties += Q.near_tie_walk(cc_np[s], a_cu[s], pods, table, None)[0]
    fronts = {b: pareto.frontier_for(p) for b, p in points.items()}
    for b, p in points.items():
        check(all(np.isfinite(v) for pt in p for v in pt.metrics.values()),
              f"placement_metrics {b}: a metric is not finite")
    same = bool(np.array_equal(fronts["cuda"].mask, fronts["numpy"].mask))
    check(same or ties > 0, "placement_metrics frontiers differ with no "
          "near-tie")
    phase("pareto", call="placement_metrics", S=len(grid), P=len(pods),
          N=N_NODES, C=6, k4_launches=launches["topsis_grid"],
          max_err_vs_numpy=f"{err:.3e}", schemes_placed_differently=
          schemes_differ, near_ties=ties, frontier_masks_equal=same,
          frontier_cuda=int(fronts["cuda"].mask.sum()),
          frontier_numpy=int(fronts["numpy"].mask.sum()),
          wall_s_cuda=f"{walls['cuda']:.3f}",
          wall_s_numpy=f"{walls['numpy']:.3f}", card=repr(smi))

    # the named schemes through the engine: numpy follows the cuda runs'
    # near-tie breaks, so the metrics and the frontiers must be equal
    runs = {}
    for backend in ("cuda", "numpy"):
        stats = Q.policy_stats()
        replay = runs["cuda"][3]["calls"] if backend == "numpy" else None
        tc.reset_launches()
        t0 = time.perf_counter()
        with Q.engine_scheduler(Q.make_policy_scheduler(stats, replay)):
            pts = pareto.scenario_metrics(
                PARETO_SCHEMES, lambda: policy_arrivals(PARETO_BURSTS),
                cluster_factory=scenario_fleet, carbon=carbon, batch=True,
                batch_backend=backend, device=dev)
        wall = time.perf_counter() - t0 - stats["check_s"]
        runs[backend] = (pts, wall, dict(tc.LAUNCHES), stats)
    (p_cu, wall_cu, l_cu, s_cu), (p_np, wall_np, _, s_np) = (runs["cuda"],
                                                             runs["numpy"])
    check(l_cu["topsis_kinds"] == len(s_cu["calls"])
          and sum(l_cu.values()) == l_cu["topsis_kinds"],
          f"scenario_metrics launched {l_cu} for {len(s_cu['calls'])} rounds")
    check(len(s_np["calls"]) == len(s_cu["calls"]),
          "scenario_metrics: numpy scored another number of rounds")
    check([p.metrics for p in p_cu] == [p.metrics for p in p_np],
          "scenario_metrics: metrics differ beyond near-ties")
    launches.update(l_cu)
    f_cu, f_np = pareto.frontier_for(p_cu), pareto.frontier_for(p_np)
    check(np.array_equal(f_cu.mask, f_np.mask),
          f"scenario_metrics frontiers differ: {f_cu.mask} vs {f_np.mask}")
    phase("pareto", call="scenario_metrics", schemes=",".join(PARETO_SCHEMES),
          bursts=PARETO_BURSTS, k3_launches=l_cu["topsis_kinds"],
          near_ties=sum(c["ties"] for c in s_np["calls"]),
          max_err_vs_numpy=f"{max(c['err'] for c in s_np['calls']):.3e}",
          frontier=int(f_cu.mask.sum()), metrics_equal_numpy=True,
          metrics=json.dumps([p.metrics for p in p_cu]),
          wall_s_cuda=f"{wall_cu:.3f}", wall_s_numpy=f"{wall_np:.3f}",
          card=repr(smi))
    return launches


# --- phase 5: the serving slice ----------------------------------------------------
class RecordingLM:
    """The LM as ``Engine`` sees it, recording each call's input tokens,
    logits and wall time (the host clock around work that ends in a
    synchronise)."""

    def __init__(self, model):
        self.model = model
        self.calls = []

    def _record(self, kind, tokens, fn):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = fn()
        torch.cuda.synchronize()
        self.calls.append(dict(kind=kind, tokens=tokens, logits=logits,
                               seconds=time.perf_counter() - t0))
        return logits, cache

    def prefill(self, tokens, max_len):
        return self._record("prefill", tokens,
                            lambda: self.model.prefill(tokens, max_len))

    def decode(self, cache, tokens):
        return self._record("decode", tokens.clone(),
                            lambda: self.model.decode(cache, tokens))


@contextlib.contextmanager
def kernel_route(**fns):
    """Route bindings of ``flash_cuda`` (``flash_fwd=...``,
    ``flash_bwd=...``, ``flash_bwd_dkv=...``) to other functions for one
    run: the same model, weights and rounding points, with the attention
    arithmetic done by them."""
    from repro_torch.kernels import flash_cuda
    saved = {name: getattr(flash_cuda, name) for name in fns}
    for name, fn in fns.items():
        setattr(flash_cuda, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(flash_cuda, name, fn)


def attention_route(fn):
    """Route K5's binding to ``fn`` for one run."""
    return kernel_route(flash_fwd=fn)


def teacher_forced(model, calls, max_len):
    """The logits of every recorded call, replayed on ``model`` with the
    recorded input tokens."""
    out, cache = [], None
    for call in calls:
        if call["kind"] == "prefill":
            logits, cache = model.prefill(call["tokens"], max_len)
        else:
            logits, cache = model.decode(cache, call["tokens"])
        out.append(logits)
    return out


def max_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def compare_logits(got, want, stats, tol):
    """Every row of ``got`` within ``tol`` of ``want``; where the argmax
    differs, the plain path's top-2 gap is a near-tie (<= ``tol``)."""
    import torch
    check(got.shape == want.shape, f"logits {got.shape} vs {want.shape}")
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    err = float((got - want).abs().max())
    stats["max_err"] = max(stats["max_err"], err)
    check(err <= tol, f"logits differ by {err} > {tol}")
    a_got, a_want = got.argmax(-1), want.argmax(-1)
    for i in torch.nonzero(a_got != a_want).flatten().tolist():
        gap = float(want[i, a_want[i]] - want[i, a_got[i]])
        check(gap <= tol, f"argmax {int(a_got[i])} vs plain "
              f"{int(a_want[i])}: plain gap {gap} > {tol}")
        stats["near_ties"] += 1
        stats["max_tie_gap"] = max(stats["max_tie_gap"], gap)
    stats["rows"] += got.shape[0]


def compare_runs(got, want, tol):
    """compare_logits over every call of two teacher-forced runs."""
    stats = dict(max_err=0.0, near_ties=0, max_tie_gap=0.0, rows=0)
    for g, w in zip(got, want, strict=True):
        compare_logits(g, w, stats, tol)
    return stats


def float32_model(model):
    """``model`` with its weights upcast to float32 in place: the same
    function with every bf16 rounding point a no-op."""
    import dataclasses
    model.float()
    model.cfg = dataclasses.replace(model.cfg, dtype="float32")
    return model


def device_ms(fn):
    """Device time (ms) of everything ``fn`` launches, by torch.profiler,
    split into K5, K6, K7, matrix products (cuBLAS's gemm / gemv / nvjet
    kernels, CUTLASS) and the rest; None
    where the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {"k5": 0.0, "k6": 0.0, "k7": 0.0, "gemm": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        group = ("k5" if "flash_fwd_kernel" in name else
                 "k6" if "flash_bwd_dq_kernel" in name else
                 "k7" if "flash_bwd_dkv_kernel" in name else
                 "gemm" if any(t in name for t in ("gemm", "gemv", "xmma",
                                                   "cutlass", "nvjet"))
                 else "other")
        split[group] += ev.self_device_time_total / 1e3
    return split if sum(split.values()) > 0 else None


def serve_phase(dev, arch=SERVE_ARCH):
    """``arch`` at full width and depth, served through ``Engine`` with K5
    on every prefill, against the plain path; then in float32 with the
    p-rounding control. Returns its launch counts."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_cuda, rmsnorm_cuda
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine, Request

    cfg = registry.config(arch, attn_impl="flash")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    lengths = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1,
                           SERVE_REQUESTS)
    reqs = [Request(i, rng.integers(2, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=SERVE_NEW, eos_id=-1)
            for i, n in enumerate(lengths)]
    max_len = int(lengths.max()) + SERVE_NEW
    rec = RecordingLM(model)
    eng = Engine(rec, batch_slots=SERVE_SLOTS, max_len=max_len)

    # the main path: counts set to 0 just before, read just after
    flash_cuda.reset_launches()
    rmsnorm_cuda.reset_launches()
    t0 = time.perf_counter()
    results = eng.serve(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {**flash_cuda.LAUNCHES, **rmsnorm_cuda.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()

    waves = -(-SERVE_REQUESTS // SERVE_SLOTS)
    check(launches[flash_cuda.NAME] == cfg.n_layers * waves,
          f"K5 launches {launches[flash_cuda.NAME]} != n_layers x waves "
          f"{cfg.n_layers * waves}")
    check(launches[rmsnorm_cuda.NAME] == 0, "K8 ran on the serving path")
    check(launches[flash_cuda.DQ] == launches[flash_cuda.DKV] == 0,
          "K6/K7 ran on the serving path")
    check(sorted(r.uid for r in results) == list(range(SERVE_REQUESTS)),
          "requests lost")
    for r in results:
        check(len(r.tokens) == SERVE_NEW, f"request {r.uid}: "
              f"{len(r.tokens)} tokens")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab)).all()),
              f"request {r.uid}: token out of range")

    # the same requests on K5's plain version, teacher-forced on the
    # kernel run's tokens
    kernel_logits = [c["logits"] for c in rec.calls]
    with attention_route(flash_cuda.flash_fwd_plain):
        plain = teacher_forced(model, rec.calls, max_len)
    check(flash_cuda.LAUNCHES[flash_cuda.NAME] == cfg.n_layers * waves,
          "a comparison run launched K5")
    stats = compare_runs(kernel_logits, plain, LOGIT_TOL)

    prefill_s = [c["seconds"] for c in rec.calls if c["kind"] == "prefill"]
    decode_s = [c["seconds"] for c in rec.calls if c["kind"] == "decode"]

    # where the time goes: device time of the last wave's prefill and of
    # its first decode steps, against the unprofiled host-clock times
    last = [c for c in rec.calls if c["kind"] == "prefill"][-1]
    state = {}

    def prefill():
        state["logits"], state["cache"] = model.prefill(last["tokens"],
                                                        max_len)

    def decode():
        tok = torch.argmax(state["logits"], dim=-1)
        for _ in range(PROFILE_STEPS):
            logits, state["cache"] = model.decode(state["cache"], tok)
            tok = torch.argmax(logits, dim=-1)

    split_pre, split_dec = device_ms(prefill), device_ms(decode)
    for tag, split, wall_ms in (
            ("prefill", split_pre, 1e3 * prefill_s[-1]),
            ("decode_step", split_dec and {k: v / PROFILE_STEPS for k, v in
                                           split_dec.items()},
             1e3 * float(np.median(decode_s)))):
        if split is None:
            phase("serve", arch=arch, profile=tag,
                  device_time="not recorded")
            continue
        busy = sum(split.values())
        phase("serve", arch=arch, profile=tag, wall_ms=f"{wall_ms:.3f}",
              device_ms=f"{busy:.3f}", k5_ms=f"{split['k5']:.3f}",
              gemm_ms=f"{split['gemm']:.3f}",
              other_ms=f"{split['other']:.3f}",
              device_idle_share=f"{max(0.0, 1 - busy / wall_ms):.3f}")
    prefill_tok = sum(c["tokens"].size for c in rec.calls
                      if c["kind"] == "prefill")
    n_tok = sum(len(r.tokens) for r in results)
    phase("serve", arch=arch, n_layers=cfg.n_layers,
          params=n_params, requests=SERVE_REQUESTS, slots=SERVE_SLOTS,
          waves=waves, prompt_lengths=",".join(map(str, lengths)),
          max_new_tokens=SERVE_NEW, max_len=max_len,
          init_s=f"{init_s:.3f}", serve_s=f"{serve_s:.3f}",
          tokens=n_tok, tokens_per_s=f"{n_tok / serve_s:.2f}",
          prefill_s_per_wave=",".join(f"{x:.4f}" for x in prefill_s),
          prefill_padded_tokens_per_s=f"{prefill_tok / sum(prefill_s):.1f}",
          decode_steps=len(decode_s),
          decode_ms_median=f"{1e3 * float(np.median(decode_s)):.3f}",
          decode_ms_max=f"{1e3 * max(decode_s):.3f}",
          max_memory_allocated=peak,
          launches=json.dumps(launches, separators=(",", ":")))
    phase("serve", arch=arch, compared_rows=stats["rows"],
          max_abs_logit=f"{max(float(x.abs().max()) for x in plain):.4f}",
          max_logit_err_vs_plain=f"{stats['max_err']:.4e}",
          logit_tol=LOGIT_TOL, near_ties=stats["near_ties"],
          max_near_tie_gap=f"{stats['max_tie_gap']:.4e}")

    # the same weights in float32: K5's float32 instantiation against its
    # plain version, and the control (p rounded to bf16) beyond the limit
    del plain, kernel_logits, state
    t0 = time.perf_counter()
    float32_model(model)
    torch.cuda.empty_cache()
    before = flash_cuda.LAUNCHES[flash_cuda.NAME]
    k32 = teacher_forced(model, rec.calls, max_len)
    check(flash_cuda.LAUNCHES[flash_cuda.NAME] - before
          == cfg.n_layers * waves, "the float32 run did not launch K5 "
          "once per layer and prefill")
    with attention_route(flash_cuda.flash_fwd_plain):
        p32 = teacher_forced(model, rec.calls, max_len)
    with attention_route(attention_fault):
        c32 = teacher_forced(model, rec.calls, max_len)
    control = max_diff(c32, p32)
    phase("serve", arch=arch, dtype="float32",
          max_logit_err_vs_plain=f"{max_diff(k32, p32):.4e}",
          control_p_bf16_vs_plain=f"{control:.4e}",
          logit_tol=F32_LOGIT_TOL, seconds=f"{time.perf_counter() - t0:.1f}",
          max_memory_allocated=torch.cuda.max_memory_allocated())
    stats32 = compare_runs(k32, p32, F32_LOGIT_TOL)
    check(control > F32_LOGIT_TOL, f"the control (p rounded to bf16) lies "
          f"within {F32_LOGIT_TOL} of the plain path: {control}")
    phase("serve", arch=arch, dtype="float32",
          compared_rows=stats32["rows"],
          near_ties=stats32["near_ties"],
          max_near_tie_gap=f"{stats32['max_tie_gap']:.4e}")
    del model, rec, eng, k32, p32, c32
    _free()
    return launches


def serve_smoke_phase(dev):
    """``python -m repro_torch.launch.serve --smoke``, the launcher's own
    entry point on the card: the SMOKE head dim (8) is none the kernels
    take, so ``ops.flash_attention`` pads it to 32 and every prefill runs
    K5. Returns its launch counts."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_cuda, ops
    from repro_torch.launch import serve

    cfg = registry.smoke_config(SERVE_ARCH)
    # the main path: counts set to 0 just before, read just after
    flash_cuda.reset_launches()
    results = serve.main(["--arch", SERVE_ARCH, "--smoke"])
    launches = dict(flash_cuda.LAUNCHES)
    check(launches[flash_cuda.NAME] > 0, "launch.serve --smoke did not run "
          "K5")
    check(all(len(r.tokens) > 0 and bool(((r.tokens >= 0)
                                          & (r.tokens < cfg.vocab)).all())
              for r in results), "launch.serve --smoke: bad tokens")
    phase("serve_smoke", arch=SERVE_ARCH, head_dim=cfg.hd,
          padded_head_dim=ops.padded_head_dim(cfg.hd), requests=len(results),
          tokens=sum(len(r.tokens) for r in results),
          launches=json.dumps(launches, separators=(",", ":")))
    return launches


# --- phase 6: the training slice ----------------------------------------------------
def _plain64_fwd(q, k, v, **kw):
    """K5's plain version in float64, rounded back: a third correct
    evaluation, for the spread of the bf16 comparison."""
    from repro_torch.kernels import flash_cuda as fc
    out, lse = fc.flash_fwd_plain(q.double(), k.double(), v.double(), **kw)
    return out.to(q.dtype), lse.float()


def _plain64_bwd(q, k, v, out, lse, do, **kw):
    from repro_torch.kernels import flash_cuda as fc
    grads = fc.flash_bwd_plain(*(t.double() for t in (q, k, v, out, lse,
                                                      do)), **kw)
    return tuple(g.to(q.dtype) for g in grads)


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def full_depth_run(tag, route, profile=False, arch=SERVE_ARCH):
    """TRAIN_STEPS steps of launch.train's code path (``build`` then
    ``train_steps``) for ``arch`` with the flash bindings routed by
    ``route``; the launch counts of each step, the peak device memory and,
    with ``profile``, the time split of one more step."""
    import torch

    from repro_torch.kernels import flash_cuda as fc
    from repro_torch.launch import train as lt
    from repro_torch.optim import adamw
    from repro_torch.train import loop as tl

    args = lt.parse(["--arch", arch] + TRAIN_ARGV + ["--quantized-state"])
    _free()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    with kernel_route(**route):
        t0 = time.perf_counter()
        r = lt.build(args)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        out["params"] = sum(p.numel() for p in r.model.parameters())
        last = {}

        def on_step(h):
            h["launches"] = {k: n - last.get(k, 0)
                             for k, n in fc.LAUNCHES.items()}
            last.update(fc.LAUNCHES)
            phase("train", arch=arch, run=tag, step=h["step"],
                  loss=f"{h['loss']:.6f}",
                  grad_norm=f"{h['grad_norm']:.6f}", lr=f"{h['lr']:.6e}",
                  time_s=f"{h['time_s']:.3f}",
                  launches=json.dumps(h["launches"], separators=(",", ":")))

        # the main path: counts set to 0 just before, read just after
        fc.reset_launches()
        out["hist"] = lt.train_steps(r, 0, TRAIN_STEPS, on_step=on_step)
        out["launches"] = dict(fc.LAUNCHES)
        out["peak"] = torch.cuda.max_memory_allocated()
        if profile:
            n = TRAIN_STEPS
            t0 = time.perf_counter()
            out["split"] = device_ms(lambda: lt.train_steps(r, n, n + 1))
            out["profiled_wall_s"] = time.perf_counter() - t0
            # the same step's two halves on the host clock, unprofiled
            batch = r.data_fn(n + 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, grads = tl.microbatch_grads(r.model, r.state["params"],
                                              batch, 1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            adamw.update(r.ocfg, grads, r.state["opt_state"],
                         r.state["params"], decay=r.model.decays())
            torch.cuda.synchronize()
            out["grads_s"], out["update_s"] = t1 - t0, time.perf_counter() - t1
        del r
    _free()
    return out


def train_phase(dev, arch=SERVE_ARCH):
    """``arch`` training at full width and depth, kernel run against the
    plain run; returns the kernel run's launch counts."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_cuda as fc

    n_layers = registry.config(arch).n_layers
    kern = full_depth_run("kernel", {}, profile=True, arch=arch)
    for h in kern["hist"]:
        check(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]),
              f"step {h['step']}: loss {h['loss']} grad_norm "
              f"{h['grad_norm']}")
        want = {fc.NAME: 2 * n_layers, fc.DQ: n_layers, fc.DKV: n_layers}
        got = {k: h["launches"][k] for k in want}
        check(got == want, f"step {h['step']}: launches {got} != {want} "
              f"(forward + recompute, dq, dk/dv per layer)")
    launches = kern["launches"]
    plain = full_depth_run("plain", dict(flash_fwd=fc.flash_fwd_plain,
                                         flash_bwd=fc.flash_bwd_plain),
                           arch=arch)
    check(sum(plain["launches"].values()) == 0, "the plain run launched a "
          "flash kernel")
    spread = full_depth_run("plain_float64", dict(flash_fwd=_plain64_fwd,
                                                  flash_bwd=_plain64_bwd),
                            arch=arch)
    k1, p1, s1 = kern["hist"][0], plain["hist"][0], spread["hist"][0]
    cmp = dict(
        step1_loss_rel=_rel(k1["loss"], p1["loss"]),
        step1_grad_norm_rel=_rel(k1["grad_norm"], p1["grad_norm"]),
        losses_rel=max(_rel(a["loss"], b["loss"]) for a, b in
                       zip(kern["hist"], plain["hist"], strict=True)))
    spr = dict(
        step1_loss_rel=_rel(p1["loss"], s1["loss"]),
        step1_grad_norm_rel=_rel(p1["grad_norm"], s1["grad_norm"]),
        losses_rel=max(_rel(a["loss"], b["loss"]) for a, b in
                       zip(plain["hist"], spread["hist"], strict=True)))
    # the profiler slows the host several-fold, so the device's idle share
    # is taken against the last unprofiled step's wall time
    split, wall = kern["split"], kern["hist"][-1]["time_s"]
    if split is None:
        phase("train", arch=arch, profile="step", device_time="not recorded")
    else:
        busy = sum(split.values())
        phase("train", arch=arch, profile="step", wall_ms=f"{1e3 * wall:.3f}",
              profiled_wall_ms=f"{1e3 * kern['profiled_wall_s']:.3f}",
              device_ms=f"{busy:.3f}",
              **{f"{k}_ms": f"{v:.3f}" for k, v in split.items()},
              device_idle_share=f"{max(0.0, 1 - busy / (1e3 * wall)):.3f}")
    phase("train", arch=arch, n_layers=n_layers, params=kern["params"],
          seq_len=4096, tokens_per_step=4095, steps=TRAIN_STEPS,
          quantized_state=True, init_s=f"{kern['init_s']:.3f}",
          step_s=",".join(f"{h['time_s']:.3f}" for h in kern["hist"]),
          plain_step_s=",".join(f"{h['time_s']:.3f}" for h in plain["hist"]),
          tokens_per_s=f"{4095 / kern['hist'][-1]['time_s']:.1f}",
          grads_s=f"{kern['grads_s']:.3f}", update_s=f"{kern['update_s']:.3f}",
          max_memory_allocated=kern["peak"],
          plain_max_memory_allocated=plain["peak"],
          launches=json.dumps(launches, separators=(",", ":")))
    phase("train", arch=arch, compare="kernel_vs_plain",
          **{k: f"{v:.3e}" for k, v in cmp.items()},
          limits=f"{TRAIN_LOSS_RTOL}/{TRAIN_GNORM_RTOL}/{TRAIN_LOSSES_RTOL}")
    phase("train", arch=arch, compare="plain_vs_float64_attention",
          **{k: f"{v:.3e}" for k, v in spr.items()})
    check(cmp["step1_loss_rel"] <= TRAIN_LOSS_RTOL, f"step-1 loss: kernel "
          f"{k1['loss']} vs plain {p1['loss']}")
    check(cmp["step1_grad_norm_rel"] <= TRAIN_GNORM_RTOL, f"step-1 grad "
          f"norm: kernel {k1['grad_norm']} vs plain {p1['grad_norm']}")
    check(cmp["losses_rel"] <= TRAIN_LOSSES_RTOL, f"losses differ by "
          f"{cmp['losses_rel']} relative")
    return launches


def f32_run(route, steps, arch=SERVE_ARCH, layers=F32_TRAIN_LAYERS):
    """``steps`` steps of ``arch`` in float32 at ``layers`` layers from
    launch.train's ``build``: the step-1 gradients (through the loop's
    microbatch_grads and adamw.update, kept) and the losses of every
    step."""
    import torch

    from repro_torch.launch import train as lt
    from repro_torch.optim import adamw
    from repro_torch.train import loop as tl

    args = lt.parse(["--arch", arch] + TRAIN_ARGV + [
        "--layers", str(layers), "--dtype", "float32"])
    _free()
    with kernel_route(**route):
        r = lt.build(args)
        loss, _, grads = tl.microbatch_grads(r.model, r.state["params"],
                                             r.data_fn(0), 1)
        kept = dict(grads)
        p, o, _ = adamw.update(r.ocfg, grads, r.state["opt_state"],
                               r.state["params"], decay=r.model.decays())
        r.state = {"params": p, "opt_state": o}
        losses = [float(loss)]
        losses += [h["loss"] for h in lt.train_steps(r, 1, steps)]
        torch.cuda.synchronize()
        del r, p, o
    _free()
    return kept, losses


def leaf_errors(got, want):
    """Largest |got - want| / max |want| over the leaves, and its leaf."""
    worst = (0.0, "")
    for n, w in want.items():
        rel = float((got[n] - w).abs().max()) / max(float(w.abs().max()),
                                                     1e-30)
        worst = max(worst, (rel, n))
    return worst


def f32_train_phase(dev, arch=SERVE_ARCH, layers=F32_TRAIN_LAYERS,
                    control="first_head"):
    """Full width, ``layers`` layers, float32 weights and moments: the
    kernels against the plain versions at tight limits, and a control with
    a planted K7 fault beyond them: ``first_head`` (dk, dv from one head
    per group) where the GQA group has several heads, ``half_d`` (only the
    first HALF_D columns of dk and dv) at D = 256."""
    import torch

    from repro_torch.kernels import flash_cuda as fc

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    before = dict(fc.LAUNCHES)
    g_k, l_k = f32_run({}, TRAIN_STEPS, arch, layers)
    check(all(fc.LAUNCHES[k] > before[k] for k in before),
          "the float32 run did not launch K5, K6 and K7")
    g_p, l_p = f32_run(dict(flash_fwd=fc.flash_fwd_plain,
                            flash_bwd=fc.flash_bwd_plain), TRAIN_STEPS, arch,
                       layers)
    grad_rel, grad_leaf = leaf_errors(g_k, g_p)
    loss_rel = max(_rel(a, b) for a, b in zip(l_k, l_p, strict=True))
    del g_k
    _free()

    def faulty_dkv(q, k, v, do, lse, dd, **kw):
        return _bwd_fault(q, k, v, do, lse, dd, **kw, fault=control)[1:]

    g_c, _ = f32_run(dict(flash_bwd_dkv=faulty_dkv), 1, arch, layers)
    ctl_rel, ctl_leaf = leaf_errors(g_c, g_p)
    del g_c, g_p
    _free()
    phase("train", arch=arch, dtype="float32", n_layers=layers,
          steps=TRAIN_STEPS, losses=",".join(f"{x:.7f}" for x in l_k),
          step1_grad_rel_err=f"{grad_rel:.3e}", worst_leaf=grad_leaf,
          losses_rel_err=f"{loss_rel:.3e}",
          **{f"control_k7_{control}_grad_rel_err": f"{ctl_rel:.3e}"},
          control_worst_leaf=ctl_leaf,
          limits=f"{F32_GRAD_REL}/{F32_LOSS_RTOL}",
          seconds=f"{time.perf_counter() - t0:.1f}",
          max_memory_allocated=torch.cuda.max_memory_allocated())
    check(grad_rel <= F32_GRAD_REL, f"float32 step-1 gradient of "
          f"{grad_leaf} off by {grad_rel} of its largest value")
    check(loss_rel <= F32_LOSS_RTOL, f"float32 losses differ by {loss_rel}")
    check(ctl_rel > F32_GRAD_REL, f"the control (K7 with {control}) lies "
          f"within {F32_GRAD_REL}: {ctl_rel}")


def supervisor_phase(dev):
    """The fault Supervisor on the card at the smoke size: a fault at step
    3 restarts from the step-2 checkpoint, and the run ends where an
    uninterrupted one does."""
    import torch

    from repro_torch.launch import train as lt
    from repro_torch.train import checkpoint, fault

    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    args = lt.parse(["--smoke", "--device", "cuda", "--steps", "6",
                     "--global-batch", "4", "--seq-len", "64",
                     "--n-micro", "2", "--quantized-state"])
    armed = [True]

    def hook(step):
        if step == 3 and armed[0]:
            armed[0] = False
            raise RuntimeError("injected fault")

    try:
        r = lt.build(args)
        sup = fault.Supervisor(ckpt_dir=str(ckpt), ckpt_every=2,
                               max_restarts=1)
        final, hist = sup.run(state=r.state, step_fn=r.step_fn,
                              data_fn=r.data_fn, n_steps=6, fault_hook=hook)
        steps = [h["step"] for h in hist]
        check(steps == [0, 1, 2, 2, 3, 4, 5], f"steps run {steps}")
        check(checkpoint.latest_step(str(ckpt)) == 6, "no final checkpoint")
        back = checkpoint.restore(str(ckpt), 6, final)
        for n, p in final["params"].items():
            check(torch.equal(back["params"][n], p), f"restored {n} differs")
        ref = lt.build(args)
        ref_hist = lt.train_steps(ref, 0, 6)
        err = max(_rel(h["loss"], ref_hist[h["step"]]["loss"]) for h in hist)
        check(err <= 1e-6, f"restarted run's losses differ by {err}")
        p_err = max(float((final["params"][n] - p).abs().max().detach())
                    for n, p in ref.state["params"].items())
        check(p_err <= 1e-6, f"restarted run ends {p_err} from the "
              f"uninterrupted one")
        phase("train", supervisor="restart", steps_run=",".join(
            map(str, steps)), restarted_loss_rel_err=f"{err:.3e}",
              final_param_max_abs_err=f"{p_err:.3e}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


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
    if not all((ROOT / CSRC / f).is_file()
               for f in ("topsis.cu", "topsis_math.cuh",
                         "topsis_math_check.cu", "flash_attention.cu",
                         "rmsnorm.cu", "flash_attention_bwd.cu",
                         "mma_bf16.cuh")):
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    if sys.argv[1:] == [PROFILE_FLAG]:       # perpod_phase's child
        profile_clean_decisions()
        return 0
    if sys.argv[1:] == [PERPOD_FLAG]:        # the per-pod path alone
        smi, _, _ = device_phase()
        perpod_phase(torch.device("cuda", 0), smi, compare=True)
        phase("done", perpod_only=True)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    smi, name, count = device_phase()
    build_phase()
    table = kernel_phase(dev, smi)
    table.update(lm_kernel_phase(dev))
    table.update(bwd_kernel_phase(dev))
    # each main path's counts, summed: slice (K1-K4), the per-pod
    # decisions (K1), the policy round (K3), the frontier layer (K4, K3),
    # serve (K5), the smoke-size serving launcher (K5), train (K5, K6,
    # K7), for llama3-8b (head dim 128) and gemma-7b (256); the D = 256
    # rows count gemma's
    launches = collections.Counter(slice_phase(dev))
    launches.update(perpod_phase(dev, smi))
    launches.update(policy_phase(dev, smi))
    launches.update(pareto_phase(dev, smi))
    launches.update(serve_phase(dev))
    launches.update(serve_smoke_phase(dev))
    wide = collections.Counter(serve_phase(dev, GEMMA_ARCH))
    launches.update(train_phase(dev))
    f32_train_phase(dev)
    wide.update(train_phase(dev, GEMMA_ARCH))
    f32_train_phase(dev, GEMMA_ARCH, GEMMA_F32_LAYERS, control="half_d")
    supervisor_phase(dev)
    launches.update(wide)
    launches.update({row_name(n, WIDE_D): c for n, c in wide.items()})
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
