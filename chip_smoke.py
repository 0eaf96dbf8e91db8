#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from
``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all started
together; the bf16 tensor-core instantiations of K5, K6 and K7 at D = 64,
D = 128 and D = 256 must not spill) and holds each against its plain
PyTorch version at main-path shapes, the flash-attention backward (K6, K7)
included, at llama3-8b's head dim (128), gemma-7b's (256) and
whisper-base's (64, bidirectional at its encoder's 1500 frames), and K8
at every width path. The bf16 cases run K5's, K6's and K7's tensor-core
instantiations (wgmma from TMA-loaded shared memory in warp-
specialised warpgroups, one producer and two consumers, with p, and in
K6 and K7 ds, split into bf16 halves); K7 must give bitwise-equal dk and
dv over two launches at the training and local-head shapes, and every
K6/K7 line names its factor over SDPA's backward; the float32 cases and
the float32 model runs below hold the float32 FMA instantiations. Then
it drives the port's main paths on the card:

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
  first two bursts on cuda once more, with telemetry and without (after
  the timed runs), must give the same run, the recorded one its counters
  exported to Prometheus text and an HTML report;
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
  and dV must fail;
* ``[moe]``, the MoE family at published widths: mixtral-8x7b served at 8
  of its 32 layers (8 requests of 4096-8192 prompt tokens in 2 waves of
  4, 32 new tokens; K5 with its 4096-key window cutting, ``_sdpa`` with
  the window in decode) against the plain path, whose routing follows the
  kernel run's where each difference is a near-tie (``RoutingRecorder``),
  then 2 layers in float32 with a no-window control; mixtral-8x7b trained
  at 4 layers on one 8192-token sequence (K5, K6, K7 with the window) the
  same way; deepseek-v3-671b served at its 3 ``mla_dense`` layers and 1
  ``mla_moe`` layer (256 experts, top-8, a shared expert; MLA takes no
  kernel), and its absorbed MLA decode held to the prefill and to the
  full form in float32;
* ``[whisper]`` and ``[vision]``, cross-attention at published widths:
  whisper-base served at full depth (6 + 6 layers, head dim 64; 8
  requests of 4-224 prompt tokens in 2 waves of 4, 64 new tokens, 1500
  frames through ``Engine``'s extra_inputs; K5 bidirectional in the
  encoder, causal in the decoder's prefill, cross-attention through
  ``_sdpa``) against the plain path, then 2 + 2 layers in float32 with
  controls (the encoder made causal, other frames); trained at full depth
  (16 sequences of 448 tokens a step; K5, K6 and K7 bidirectional in the
  encoder); llama-3.2-vision-90b served at 2 of its 20 groups (10 dense
  blocks, 2 gated cross-attention blocks, gates 0.5; 1601 vision tokens)
  against the plain path, with other vision tokens at gates 0 (no move)
  and 0.5 (a move), and trained at 1 group on one 4096-token sequence;
* ``[zamba2]`` and ``[rwkv]``, the state-space family at published widths:
  zamba2-7b served at 27 of its 81 layers (4 groups of 6 Mamba2 blocks
  and the one shared attention block, then 3 Mamba2 blocks; 8 requests of
  1024-2048 prompt tokens in 2 waves of 4, each wave's longest 2048, 32
  new tokens; K5 at head dim 112, zero-padded to 128, in the shared block
  of every group) against the plain path, then 9 layers in float32 with
  a control at the padded head dim's softmax scale, and its O(1) decode
  state against the chunked scan (controls: the SSM state zeroed, the conv
  buffer not shifted); trained at 27 layers on one 4096-token sequence
  (K5, K6, K7 in the shared block); rwkv6-1.6b served at 6 of its 24
  layers (no kernel on its path), held in float32 at 2 layers against the
  same weights on the CPU (controls: u_bonus on the value axis, the wkv
  state zeroed) and trained at 6 layers on 8 x 256 tokens a step;
* then the checkpoint / restart round trip of the fault Supervisor at the
  smoke size (head dim 8, padded);
* ``[dist]``, training on a device mesh: llama3-8b at full width, 2
  layers, bf16, one 4095-token sequence a rank, (a) through
  ``make_train_step`` and ``make_compressed_dp_step`` on a one-rank NCCL
  mesh, equal to the one-device step (K5, K6 and K7 in the ``local_map``
  region; the one-shard compression rule bit for bit), (b) through the
  compressed step on two gloo ranks sharing the card (spawned here),
  against one process on both rows, with the int32 sums, g_hat and error
  feedback's running sum checked (a control drops the residual). K5, K6
  and K7 at one rank's local heads of a (1, 2) mesh are timed as kernel
  cases (``tp2``); no card path runs that shape (DTensor's collectives
  over gloo on CUDA tensors crash), so their rows are printed on
  ``[dist]`` lines and not in the kernel table line;
* ``[dryrun]``, the dry-run roofline and the GPU-fleet placement: (a)
  ``launch.dryrun``'s llama3-8b ``train_4k`` and ``decode_32k`` cells on
  the fake 256-rank production mesh at full size, each in a process of
  its own (started after the build, CPU-only, beside the card phases):
  both ``ok``, the peak per device within the card's 80 GB; (b) one
  training step of llama3-8b at full width, 2 layers (``[dist]``'s
  configuration, einsum attention), counted on meta and on the card by
  ``launch.op_analysis``: the counts equal exactly, the argument bytes
  are the real tensors' bytes, the measured step is at or above its
  roofline bound, the predicted peak within [0.5, 2]x the card's; (c)
  ``launch.fleet`` places (a)'s jobs on a fleet of L4, A100 and H100
  slices under the four schemes, and a degraded slice's job moves;
* ``[examples]``, the repo's four examples as the port's entry points
  (``examples/torch_*.py``), each ``main`` on the card at the reference's
  sizes: the quickstart's hand-made decision (K1) equal to numpy's or a
  near-tie; the fleet tour on (a)'s records (K2 in its 64 x 2,048 queue,
  K3 in its scenarios, K4 in its 512-scheme frontier), then again on
  numpy following the cuda run's near-tie breaks (``cluster.parity``):
  every scenario's numbers equal, the queue's and the frontier's picks
  equal or near-ties; train_lm's 300 steps with a failure and a restart
  (K5, K6, K7), the loss falling, its first 3 losses within
  TRAIN_LOSSES_RTOL of the same steps on the kernels' plain versions;
  serve_lm's 12 requests (K5 in each prefill), its float32 logits within
  F32_LOGIT_TOL of the same calls on K5's plain version. Each example's
  launch counts are printed, each count of its path above 0.

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
outputs; at D = 112 (zamba2's, zero-padded to 128 by the wrapper) K5, K6
and K7 with the padded D's softmax scale.

Phases print one line each; the line before the last JSON line is the
kernel table (one row per kernel, and one more per flash kernel for its
D = 256 instantiation, named ``<kernel>_d256``, whose launches are the
gemma-7b paths', one for its D = 64 instantiation, ``<kernel>_d64``,
whose launches are the whisper-base paths', one for mixtral-8x7b's
windowed shapes, ``<kernel>_w4096``, whose launches are the mixtral
paths', and one for zamba2-7b's head dim 112 behind the wrapper's pad,
``<kernel>_d112``, whose launches are the zamba2 paths'); the last line
is ``{"ok": true, "device": {...}}``. Any
failure exits non-zero before it. Without a CUDA device, or outside a
checkout, it exits non-zero at once.

    python3 chip_smoke.py --perpod-only

runs only the per-pod decisions, in a checkout that holds a copy of this
script (another commit's, to compare its per-pod path with this one's).

    python3 chip_smoke.py --moe-only

runs the build, the windowed K5/K6/K7 cases (mixtral's shapes, rows
``<kernel>_w4096``) and the ``[moe]`` phases alone.

    python3 chip_smoke.py --cross-only

runs the build, the bidirectional K5/K6/K7 cases (whisper's shapes, rows
``<kernel>_d64``) and the ``[whisper]`` and ``[vision]`` phases alone.

    python3 chip_smoke.py --ssm-only

runs the build, the D = 112 K5/K6/K7 cases (zamba2's shapes, rows
``<kernel>_d112``) and the ``[zamba2]`` and ``[rwkv]`` phases alone.

    python3 chip_smoke.py --dist-only

runs the build, K5 at case (a), K6/K7 at the training case, the
local-head cases and the ``[dist]`` phase alone, and ends with the same
last line as the whole script.

    python3 chip_smoke.py --kernels-only

runs the build and the flash and RMSNorm kernel phases alone (every K5,
K6, K7 and K8 case, row and planted fault, the local-head cases and
zamba2's D = 112 included) and prints their kernel table line, each
row's ``launches`` 0 (no main path runs), before the same last line as
the whole script.

    python3 chip_smoke.py --examples-only

runs the build and the ``[examples]`` phase alone (the fleet tour on its
demo jobs: no dry-run records), and ends with the same last line as the
whole script.

    python3 chip_smoke.py --dryrun-only

runs the ``[dryrun]`` phase alone (no kernel runs on its path, so
nothing is built), and ends with the same last line as the whole
script.

    python3 chip_smoke.py --mesh-only

runs ``[mesh]``, training on four cards, one NCCL rank a card (spawned
here after the build, so that the ranks only load the libraries): K5, K6
and K7 at one rank's local heads (``tp2``: H 16, Hkv 4; ``tp4``: H 8,
Hkv 2; ``tp2_w4096``: mixtral's, window 4096, 8191 tokens) timed on card
0 beside their plain versions and SDPA, and held to their plain versions
on every card (K7 bit for bit over two launches); (a) llama3-8b at full
width and depth through ``launch.train``'s path (``make_train_step``,
ZeRO-1, int8 moments) on (data=2, model=2), 2 x 4096 tokens a step, and
(b) on (1, 4), each held to one process on card 0 running the same
sequences (losses within 1e-2), with step time, tokens a second, NCCL's
time from the profiler and each card's peak (under 80 GB); (c) [dist]'s
compressed data-parallel step on (4, 1), held as [dist] (b) holds it,
with the all-reduce's seconds and bytes over NCCL; (d) the elastic
restore: 2 layers saved at (2, 2) after step 2, restored at (1, 4) and
(4, 1) bit for bit, step 3 within 1e-2 of the (2, 2) run's; (e)
mixtral-8x7b at 4 layers on (2, 2), one 8192-token sequence a data
rank, held to one process that follows the mesh's expert choices (each
difference a near-tie), with the share of each card's MoE work that
serves its own data shard; and one (2, 2) step of (a) at 2 layers
(einsum attention) counted by ``launch.op_analysis`` on meta under a
fake 4-rank group and on every card, equal exactly, the measured step
at or above its roofline bound, the predicted peak within [0.5, 2]x.
With fewer than four cards it exits non-zero at once. The whole
script's run does not include it.

    python3 chip_smoke.py --mesh-families

runs the rest of the families on four cards the same way (a mode of its
own beside ``--mesh-only``, whose runs with these would take most of the
script's 1,200 s): K5, K6 and K7 at their local heads on (2, 2)
(``tp2_d256``: gemma-7b's H 8 at D = 256; ``tp2_d112``: zamba2-7b's H 16
at D = 112 through the wrapper's pad; ``tp2_d64``: whisper-base's encoder,
B 8, H 4, 1500 frames, bidirectional; ``tp2_vlm``: llama-3.2-vision-90b's
H 32 on 4 kv heads) timed on card 0 and held on every card; then, on
(2, 2) through ``launch.train``'s path under each family's plan
(``launch.dryrun.PLANS``: n_micro, fsdp, int8 moments), 3 steps at full
width: (f) gemma-7b, 28 layers, 4 x 4096 tokens, n_micro 2, float32
moments; (g) zamba2-7b, 27 of 81 layers, 4 x 4096, n_micro 2; (h)
whisper-base whole, 16 x 448 tokens with 1500 frames each; (i)
llama-3.2-vision-90b at 1 of 20 groups, 16 x 4096 tokens with 1601 vision
tokens each, fsdp, int8 moments, n_micro 8. Each card's K5, K6 and K7
launches a step must be the model's (twice, once, once a flash layer a
microbatch) and its peak under 80 GB. Each is held to one process on card
0 at the depth one card holds the plan at (gemma-7b: 4 layers, in a
second mesh run beside the timed one): free-running, the first two
steps' losses within 1e-2; the third step's loss within 1e-4 of one
process's at the weights the mesh saved after two (the vision run, whose
plan no card holds, at the seeded weights for its first step too). (j)
llama3-8b at 2 layers on (2, 2), n_micro 2, int8 moments, 4 x 4096
tokens, under ``fault.Supervisor`` with ``shardings=``, a checkpoint
every 2 steps and a fault at step 3: the history's steps must be [0, 1,
2, 2, 3, 4] and the final parameters and moments the uninterrupted
run's bit for bit. With fewer than four cards it exits non-zero at once.

    python3 chip_smoke.py --mesh-serve

runs serving on four cards (a mode of its own: the whole script's time is
nearly full), one NCCL rank a card, the model's parameters laid out by
the sharding rules and served through ``Engine`` on their mesh: K5 at
one rank's serving heads (``tp4_serve``: B 4, H 8, Hkv 2, S 2048 on (1,
4); ``tp2_serve``: B 2, H 16, Hkv 4 on (2, 2)) timed on card 0 beside its
plain version and SDPA and held on every card; then (k) llama3-8b whole,
bf16, seeded weights, on (1, 4) and on (2, 2), [serve]'s traffic (8
requests of 1024-2048 prompt tokens in waves of 4, 32 new tokens), each
card's K5 launched once a layer a wave, with prefill seconds a wave,
decode ms a step, tokens a second, NCCL's profiled seconds and each
card's peak (under 80 GB), held to one process on card 0 teacher-forced
on the mesh's tokens (logits within 0.2, a differing argmax a near-tie),
then 2 layers in float32 on (1, 4) within 1e-3 of one process, a control
whose decode writes no k/v lying beyond it; (l) deepseek-v3-671b at its 3
mla_dense and 1 mla_moe layers on (2, 2), its latent cache split over T
on every card (8 requests of 512-1024 tokens, 16 new), held to one
process that follows the mesh's expert choices (each difference a
near-tie), no kernel on its path, and MLA's decode invariant on the mesh
in float32 with the decode's write dropped as its control; and one (2,
2) decode step of (k) at 2 layers (einsum attention) counted by
``launch.op_analysis`` on meta under a fake 4-rank group and on every
card, equal exactly, the measured step at or above its roofline bound.
With fewer than four cards it exits non-zero at once.

    python3 chip_smoke.py --mesh-remaining

trains the last three registry architectures on four cards as
``--mesh-families`` trains its families (a mode of its own): K5, K6 and
K7 at ``tp2`` and ``tp2_g7`` (deepseek-coder-33b's H 28 on Hkv 4, a GQA
group of 7) timed on card 0 and held on every card, with a planted input
whose query head h reads kv head h // 8 that the checks must reject;
then on (2, 2) through ``launch.train``'s path, 3 steps at full width:
(m) deepseek-v3-671b at 4 layers (3 mla_dense, 1 mla_moe), 16 x 4096
tokens, under its optimised plan (``launch.dryrun.OPT_PLANS``: the 256
experts 64 a card over ("data", "model"), the slot rows re-sharded over
those axes, a bf16 accumulator, int8 moments, n_micro 8, the MoE
dispatched in one group a data rank), K5-K7 launched 0 times, each
card's share of its experts' kept choices from its own rows; held to one
process on card 0, which cannot step the plan (15.11e9 parameters), by
its loss and gradient norm at the seeded weights and at the weights the
mesh saved after two steps (bf16 accumulator, one row a microbatch in a
group of its own as each data rank takes it, with its microbatch's
load-balancing loss, following the mesh's expert choices; at the seeded
weights two faults planted in its gradient, one of which the 2e-3 limit
must reject); (n) deepseek-coder-33b
at 12 of 62 layers, 8 x 4096 tokens, n_micro 4, float32 moments; (o)
minitron-8b whole (32 layers, a 256,000-token vocabulary), 4 x 4096,
n_micro 2; both held to one process at 4 layers as ``--mesh-families``
holds gemma-7b; and one (2, 2) step of (m) counted on meta under a fake
4-rank group (as each rank) and on every card, equal exactly. With fewer
than four cards it exits non-zero at once.
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
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_NODES = 15000          # GKE's documented per-cluster node limit
BURST = 512
N_BURSTS = 8
# [policy]'s telemetry rerun takes the first TELEMETRY_BURSTS bursts (every
# policy mechanism acts within them), beside a cuda run of the same bursts
# without telemetry, which it must equal
TELEMETRY_BURSTS = 2
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
# the keys the planted diagonal_tile faults drop (from K5's out and K6's
# dq): each query's own tile of 64
K5_TILE = 64
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
# A model whose bf16 logits carry a larger spread than llama3-8b's is held
# to the same ratio of its own: the limit is SPREAD_RATIO times the plain
# path's distance from the same model with float64 attention, measured in
# the same run (llama3-8b: 0.2 against 0.089), and never below LOGIT_TOL.
# zamba2-7b takes it: 81 bf16 layers whose gated Mamba2 blocks grow an
# attention output's one-ulp flips (kernel vs plain 0.2375 on an H100,
# PERF.md); its float32 run holds K5 at 1e-3.
SPREAD_RATIO = 2.25
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
# (w) is mixtral-8x7b's prefill: a 4096-key sliding window that cuts, 8192
# tokens deep; its rows in the kernel table are ``<kernel>_w4096``.
K5_CASES.append(("w", 4, 32, 8, 8192, 128, "bfloat16", 4096, 5))
# (whisper) is whisper-base's encoder: 8 heads of head dim 64 over its
# 1500 frames, bidirectional; its rows in the kernel table are
# ``<kernel>_d64``.
K5_CASES.append(("whisper", 4, 8, 8, 1500, 64, "bfloat16", None, 20))
# cases with causal=False (tp2_d64: whisper's encoder on one rank's heads)
BIDIRECTIONAL = ("whisper", "whisper_train", "tp2_d64")
K5_FAULT_CASES = ("a", "b", "e", "f", "whisper")
K5_SMALL = (2, 8, 2, 333)            # a GQA group of 4, every head dim
# The bf16 K5's tile edges (128 query rows and 128 keys a tile; 64 keys at
# D = 256), at every head dim and K5_SMALL's heads: S on both sides of a
# tile, a window of 48 and of 64 (a band inside one tile, and one that
# ends on a 64-key edge), and kv_len < S (negative: S less that many).
K5_EDGE_S = (127, 128, 129, 1000)
K5_EDGE_MASKS = ((True, None, None), (False, None, None), (True, 48, None),
                 (True, 64, None), (True, None, -37), (False, None, -37))
WIDE_D = 256                         # gemma-7b's head dim
NARROW_D = 64                        # whisper-base's head dim
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
# (window) is mixtral-8x7b's training shape: one 8192-token sequence (the
# model sees 8191), window 4096.
BWD_CASES.append(("window", 1, 32, 8, 8191, 128, "bfloat16", 4096, 3))
WINDOW_ROW = 4096        # mixtral-8x7b's attn_window: the windowed rows
# (whisper_train) is whisper-base's encoder in training: a global batch of
# 16, 1500 frames, bidirectional.
BWD_CASES.append(("whisper_train", 16, 8, 8, 1500, 64, "bfloat16", None,
                  5))
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
# PERF.md), which the script prints beside them for llama3-8b.
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_LOSSES_RTOL = 1e-4, 2e-3, 1e-2
# float32 at full width, F32_TRAIN_LAYERS layers (gemma-7b:
# GEMMA_F32_LAYERS; its 256000 x 3072 float32 embedding and its moments
# take 12.6 GB), float32 moments: step-1 gradients of every leaf within
# F32_GRAD_REL of its largest |g|, losses of every step within
# F32_LOSS_RTOL; a K7 with a planted fault must fail.
F32_TRAIN_LAYERS, F32_GRAD_REL, F32_LOSS_RTOL = 4, 1e-4, 1e-5
GEMMA_F32_LAYERS = 2
# The MoE slice. mixtral-8x7b served at MIXTRAL_SERVE_LAYERS of its 32
# layers (23.5e9 parameters, ~47 GB of bf16 weights; one 80 GB card), 8
# requests in 2 waves of 4 with prompts of MIXTRAL_PROMPT tokens, so every
# wave's prefill crosses the 4096-key window, and MIXTRAL_NEW new tokens;
# a float32 rerun at MIXTRAL_F32_LAYERS layers; trained at
# MIXTRAL_TRAIN_LAYERS layers on one 8192-token sequence.
MOE_FLAG = "--moe-only"
KERNELS_FLAG = "--kernels-only"
MIXTRAL_ARCH = "mixtral-8x7b"
# 8 layers (16 before [dryrun] came): the script's limit (PERF.md §7)
MIXTRAL_SERVE_LAYERS, MIXTRAL_F32_LAYERS = 8, 2
MIXTRAL_PROMPT, MIXTRAL_NEW = (4096, 8192), 32
MIXTRAL_TRAIN_LAYERS, MIXTRAL_SEQ = 4, 8192
# A routing flip: a (layer, token) whose set of top-k experts differs
# between the kernel run and the plain run. One flip changes its token's
# output and, through attention and capacity slots, every later layer's
# routing (at 16 layers, 2.7% of the selections differ without following,
# gaps up to 0.33; PERF.md). So the plain run takes the kernel
# run's choices (``RoutingRecorder(lead=...)``, as ``cluster/parity.py``
# has numpy follow cuda's near-tie breaks) and each place where its own
# choice differs must be a near-tie: the kernel's worst choice at most
# ROUTE_TIE_TOL below the plain run's own k-th best selection score
# (softmax gates, in [0, 1]). Every request's logits are then held to
# LOGIT_TOL.
ROUTE_TIE_TOL = 0.05
# deepseek-v3-671b served at its 3 mla_dense layers and 1 mla_moe layer
# (256 experts, top-8, a shared expert; ~15e9 parameters), 8 requests of
# DEEPSEEK_PROMPT tokens in 2 waves of 4, DEEPSEEK_NEW new tokens. Then
# the reference's decode invariant (tests/test_archs.py:84-106) in
# float32 at 2 layers (n_dense_layers 1) and capacity factor 16 (no
# drops), B = 2, s = 64: the absorbed decode of token s after a prefill of
# s tokens against the prefill of s + 1 tokens, and against the full
# (training) form, within MLA_TOL.
DEEPSEEK_ARCH = "deepseek-v3-671b"
DEEPSEEK_SERVE_LAYERS, DEEPSEEK_PROMPT, DEEPSEEK_NEW = 4, (512, 1024), 16
MLA_CHECK = dict(n_layers=2, n_dense_layers=1, capacity_factor=16.0,
                 dtype="float32")
MLA_B, MLA_S, MLA_TOL = 2, 64, 1e-3
# The cross-attention slice. whisper-base at full width and depth (6 + 6
# layers, head dim 64): 8 requests in 2 waves of 4 with prompts of
# WHISPER_PROMPT tokens, WHISPER_NEW new tokens and a cache of
# WHISPER_MAX_LEN (its published decoder context, n_text_ctx), the same
# frames for every wave (``Engine``'s extra_inputs); a float32 rerun at
# WHISPER_F32's depth; trained WHISPER_TRAIN (a step: 16 sequences of 448
# tokens, 1500 frames each).
# llama-3.2-vision-90b at full width, depth cut to VISION_SERVE_LAYERS
# (2 groups: 10 dense blocks and 2 gated cross-attention blocks), its gates set to VISION_GATE (at their zero init tanh(0)
# erases the cross-attention branch); trained at VISION_TRAIN_LAYERS (one
# group) on one VISION_SEQ-token sequence. Frames and vision tokens are
# normal * 0.1 float32 from numpy (tests/test_archs.py). Controls: the
# float32 whisper logits must move by at least CAUSAL_MOVE with the
# encoder made causal and by at least FRAMES_MOVE with other frames; the
# vision logits must not move with other vision tokens at gates 0
# (GATE_CLOSED_TOL) and must move by at least VISION_MOVE at VISION_GATE.
# Frames of normal * 0.1 are a small change beside the encoder's
# unit-scale sinusoid positions, and the cross-attention averages over
# 1500 frames or 1601 vision tokens whose keys barely differ: in float32
# other frames moved whisper's prefill logits by 0.055 at 2 + 2 layers,
# other vision tokens a 5- or 20-block VLM's at d_model 1024 and 2048 by
# 0.0046-0.010 (CPU runs of the same code). So the limits sit 10x
# above the float32 logit limit (FRAMES_MOVE) and 1000x above the closed
# gate's (VISION_MOVE), each several times below what the model gives.
# (K5 with p rounded to bf16 is rejected at whisper's shape in the kernel
# phase; in the float32 model at 2 + 2 layers it moves the logits by
# 1.007e-3, too close to F32_LOGIT_TOL to be held there.)
CROSS_FLAG = "--cross-only"
WHISPER_ARCH, VISION_ARCH = "whisper-base", "llama-3.2-vision-90b"
WHISPER_PROMPT, WHISPER_NEW, WHISPER_MAX_LEN = (4, 224), 64, 448
WHISPER_F32 = dict(n_layers=2, n_encoder_layers=2)
WHISPER_TRAIN = dict(seq_len=448, batch=16)
# 2 groups (4 before [dryrun] came): the script's limit (PERF.md §7)
VISION_SERVE_LAYERS, VISION_PROMPT, VISION_NEW = 10, (1024, 2048), 32
VISION_TRAIN_LAYERS, VISION_SEQ = 5, 4096
VISION_GATE = 0.5
CAUSAL_MOVE, FRAMES_MOVE, VISION_MOVE = 0.1, 1e-2, 1e-3
GATE_CLOSED_TOL = 1e-6
# The state-space slice. zamba2-7b's shared attention block at head dim
# ZAMBA_D (3584 / 32), which ops.flash_attention zero-pads to the D = 128
# instantiation: K5 at the serving shape (ZAMBA_K5: B, H = Hkv, S), K6 and
# K7 at the training shape (ZAMBA_BWD), each timed bare (on inputs padded
# beforehand), through the wrapper (the pad, the kernel and the slice;
# under autograd for K6 + K7), beside its plain version and SDPA at D = 112;
# rows ``<kernel>_d112``. A control with the padded D's softmax scale
# (128**-0.5 for 112**-0.5) must fail. Served at ZAMBA_LAYERS of its 81
# (4 groups of 6 Mamba2 blocks and the shared block, then a 3-block tail;
# 81 before [dryrun] came: the script's limit) with ZAMBA_NEW new
# tokens and prompts of ZAMBA_PROMPT tokens, each wave's longest exactly
# ZAMBA_PROMPT[1] (a prefill longer than the 256-token SSD chunk must be
# a multiple of it);
# in float32 at ZAMBA_F32 (1 group + a 3-block tail) against the plain
# path with the scale control; decode against prefill in float32 at that
# depth (ZAMBA_DECODE: B, S tokens then one step against S + 1) within
# SSM_DECODE_TOL, and controls (the SSM state zeroed, the conv buffer not
# shifted) beyond it; trained at ZAMBA_LAYERS on one 4096-token sequence.
# rwkv6-1.6b (24 layers, d 2048, 32 heads of 64; no kernel) served the
# same way at RWKV_LAYERS, then in float32 at RWKV_F32_LAYERS: the card's
# prefill and decode logits against the same weights on the CPU
# (RWKV_CARD_TOL), decode against prefill (SSM_DECODE_TOL) with controls
# (the wkv state zeroed, u_bonus on the value axis); trained at
# RWKV_LAYERS on
# RWKV_TRAIN, step 1 held card against CPU at RWKV_F32_LAYERS in float32
# on RWKV_CPU_STEP's batch (RWKV_CARD_TOL relative). The constant-
# initialised leaves (a_log, d_skip, dt_bias, u_bonus, w_bias, the mixes)
# are drawn from SSM_NOISE's ranges (seeded), as the CPU tests draw them.
SSM_FLAG = "--ssm-only"
ZAMBA_ARCH, RWKV_ARCH = "zamba2-7b", "rwkv6-1.6b"
ZAMBA_D = 112
ZAMBA_LAYERS = 27        # 4 groups of 6 + the shared block, then 3
ZAMBA_K5 = (4, 32, 2048)
ZAMBA_BWD = (1, 32, 4095)
ZAMBA_PROMPT, ZAMBA_NEW = (1024, 2048), 32
ZAMBA_F32 = dict(n_layers=9)
ZAMBA_DECODE = (2, 255)
SSM_DECODE_TOL = 1e-3
RWKV_PROMPT, RWKV_NEW = (1024, 2048), 32
RWKV_F32_LAYERS, RWKV_CARD_TOL = 2, 1e-4
RWKV_CHECK_S = 64
# 256 tokens a sequence (512 until PR 22): its host-bound WKV loop is
# ~14 s a step at 512, and the script's limit is near (PERF.md §7)
RWKV_TRAIN = dict(seq_len=256, batch=8)
# served and trained at 6 of its 24 layers (12 before): no kernel runs
# on its path, and its host-bound loop's time is the script's margin
# under its limit on a slow host (PERF.md §7)
RWKV_LAYERS = 6
RWKV_CPU_STEP = dict(batch=2, seq_len=128)
SSM_NOISE = {"a_log": (-1.0, 0.5), "d_skip": (0.5, 1.5),
             "dt_bias": (-1.0, 0.5), "u_bonus": (-0.5, 0.5),
             "w_bias": (-7.0, -3.0), "mix_r": (0.1, 0.9),
             "mix_k": (0.1, 0.9), "mix_v": (0.1, 0.9), "mix_w": (0.1, 0.9),
             "cmix_k": (0.1, 0.9)}


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
    kernels' D = 64, D = 128 and D = 256 instantiations must not spill."""
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
        for d in (NARROW_D, 128, WIDE_D):
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


def attention_pairs(s, window, causal=True):
    """Valid (query, key) pairs of a causal (optionally windowed) or
    bidirectional s x s mask: the work K5 does after skipping masked
    tiles' arithmetic."""
    if not causal:
        return s * s
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


def row_name(name, d, window=None, tag=None):
    """The kernel table's row of kernel ``name`` at head dim ``d``: the
    D = 256 and D = 64 instantiations have rows of their own, and so have
    mixtral's windowed shapes, zamba2's D = 112 (padded to 128) and one
    rank's local heads (the cases MESH_TAGS: ``tp2`` on a (1, 2) or (2, 2)
    mesh, ``tp4`` on (1, 4), ``tp2_w4096`` mixtral's on (2, 2), and the
    families' FAMILY_TAGS on (2, 2), the serving SERVE_TAGS on (1, 4) and
    (2, 2), REMAIN_TAGS on (2, 2))."""
    if tag in MESH_TAGS + SERVE_TAGS + REMAIN_TAGS:
        return f"{name}_{tag}"
    if window == WINDOW_ROW:
        return f"{name}_w{WINDOW_ROW}"
    return f"{name}_d{d}" if d in (NARROW_D, WIDE_D, ZAMBA_D) else name


def k5_agreement(out, lse, pout, plse):
    """(passes, max |out err|, max |lse err|, share of out elements that
    differ) of K5's (out, lse) against the plain version's."""
    ok_o, err, share = agreement(out, pout)
    ok_l, err_lse, _ = agreement(lse, plse)
    return ok_o and ok_l, err, err_lse, share


def sdpa_backend(fn):
    """(backend, its longest device kernel) of the SDPA call ``fn``, read
    from the kernel names torch.profiler records: ``cudnn``, ``flash``,
    ``efficient`` (CUTLASS ``fmha``) or ``math`` (anything else)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return "not_recorded", None
    top = max(evs, key=lambda e: e.self_device_time_total).key
    name = top.lower()
    backend = ("cudnn" if "cudnn" in name else
               "flash" if "flash" in name else
               "efficient" if "fmha" in name or "efficient" in name else
               "math")
    return backend, top.replace(" ", "")[:72]


def lm_kernel_phase(dev, cases=K5_CASES, small=True):
    """K5 at ``cases`` against its plain version, with planted faults at
    K5_FAULT_CASES and, where a window cuts, a control without it; then,
    with ``small``, every head dim at K5_SMALL and K8 at every width."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_cuda as fc
    from repro_torch.kernels import rmsnorm_cuda as rc
    from repro_torch.models import layers

    gen = torch.Generator(device=dev).manual_seed(0)
    table = {}
    for tag, b, h, hkv, s, d, dname, window, reps in cases:
        dtype = getattr(torch, dname)
        q, k, v = _attention_case(dev, gen, b, h, hkv, s, d, dtype)
        scale = d ** -0.5
        causal = tag not in BIDIRECTIONAL
        kw = dict(sm_scale=scale, causal=causal, window=window)
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
        if window is not None:
            # the control: every causal key attended, the window dropped
            f_ok, f_err, f_lse, f_share = k5_agreement(
                *fc.flash_fwd_plain(q, k, v, **dict(kw, window=None)),
                pout, plse)
            check(not f_ok, f"K5 {tag}: the check passed the control "
                  f"without the window (out err {f_err})")
            faults["no_window"] = f"{f_err:.3e}/{f_lse:.3e}/{f_share:.4f}"
        if not causal:
            # the control: the causal mask where every key is attended
            f_ok, f_err, f_lse, f_share = k5_agreement(
                *fc.flash_fwd_plain(q, k, v, **dict(kw, causal=True)),
                pout, plse)
            check(not f_ok, f"K5 {tag}: the check passed the causal control "
                  f"(out err {f_err})")
            faults["causal"] = f"{f_err:.3e}/{f_lse:.3e}/{f_share:.4f}"
        ms = cuda_ms(lambda: fc.flash_fwd(q, k, v, **kw), reps)
        plain_ms = cuda_ms(lambda: fc.flash_fwd_plain(q, k, v, **kw), 3,
                           warmup=1)
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                q, k, v, is_causal=causal, scale=scale, enable_gqa=True)
        else:
            allowed = fc.mask(s, s, causal=True, window=window, kv_len=s,
                              device=dev)
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                q, k, v, attn_mask=allowed, scale=scale, enable_gqa=True)
        lib_err = float((lib().float() - pout.float()).abs().max())
        library_ms = cuda_ms(lib, reps)
        backend, lib_kernel = sdpa_backend(lib)
        elt = q.element_size()
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * elt \
            + lse.numel() * 4
        flops = 4 * d * b * h * attention_pairs(s, window, causal)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS if dtype ==
                           torch.bfloat16 else FP32_FLOPS)
        phase("kernels", kernel="flash_attention_fwd", case=tag, B=b, H=h,
              Hkv=hkv, S=s, D=d, dtype=dname, causal=causal, window=window,
              max_abs_err=f"{err:.3e}", lse_max_abs_err=f"{err_lse:.3e}",
              differing_share=f"{share:.2e}",
              max_abs_out=f"{float(pout.float().abs().max()):.3f}",
              library_max_abs_err=f"{lib_err:.3e}", ms=f"{ms:.6f}",
              plain_ms=f"{plain_ms:.6f}", library_ms=f"{library_ms:.6f}",
              library_factor=f"{ms / library_ms:.3f}",
              library_backend=backend, library_kernel=lib_kernel,
              bound_ms=f"{b_ms:.6f}", bound_by=b_by,
              tflops=f"{flops / ms / 1e9:.2f}")
        if faults:
            # out err / lse err / share of out elements that differ
            phase("kernels", kernel="flash_attention_fwd", case=tag,
                  planted_faults_rejected=",".join(faults),
                  **{f"{f}_err": r for f, r in faults.items()})
        rname = row_name(fc.NAME, d, window, tag)
        row = table.setdefault(rname, dict(
            name=rname, route="cuda",
            source=f"{CSRC}/flash_attention.cu", replaces=fc.REPLACES[fc.NAME],
            launches=0, max_abs_err=max(err, err_lse), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms, library_factor=ms / library_ms))
        row["max_abs_err"] = max(row["max_abs_err"], err, err_lse)
        del q, k, v, out, lse, pout, plse
        torch.cuda.empty_cache()
    if not small:
        return table
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
    # the bf16 tile's edges at every head dim
    b, h, hkv, _ = K5_SMALL
    n_edge = 0
    for d in fc.HEAD_DIMS:
        for s in K5_EDGE_S:
            q, k, v = _attention_case(dev, gen, b, h, hkv, s, d,
                                      torch.bfloat16)
            for causal, window, short in K5_EDGE_MASKS:
                kw = dict(sm_scale=d ** -0.5, causal=causal, window=window,
                          kv_len=None if short is None else s + short)
                ok, err, err_lse, share = k5_agreement(
                    *fc.flash_fwd(q, k, v, **kw),
                    *fc.flash_fwd_plain(q, k, v, **kw))
                check(ok, f"K5 edge D={d} S={s} causal={causal} "
                      f"window={window} kv_len={kw['kv_len']}: out err {err} "
                      f"(share {share}), lse err {err_lse}")
                row = table[row_name(fc.NAME, d)]
                row["max_abs_err"] = max(row["max_abs_err"], err, err_lse)
                n_edge += 1
    phase("kernels", kernel="flash_attention_fwd", dtype="bfloat16",
          tile_edges_checked=n_edge, S=",".join(map(str, K5_EDGE_S)),
          masks="causal,bidirectional,window48,window64,kv_len-37,"
                "bidirectional_kv_len-37",
          shape="B={},H={},Hkv={}".format(b, h, hkv))
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


def bwd_kernel_phase(dev, cases=BWD_CASES, small=True):
    """K6 and K7 at ``cases`` against their plain version, with planted
    faults and, where a window cuts, a control without it; then, with
    ``small``, every head dim at K5_SMALL."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_cuda as fc

    gen = torch.Generator(device=dev).manual_seed(1)
    table = {}
    names = ("dq", "dk", "dv")
    for tag, b, h, hkv, s, d, dname, window, reps in cases:
        dtype = getattr(torch, dname)
        q, k, v = _attention_case(dev, gen, b, h, hkv, s, d, dtype)
        do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        scale = d ** -0.5
        causal = tag not in BIDIRECTIONAL
        kw = dict(sm_scale=scale, causal=causal, window=window)
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
        if tag in K7_DETERMINISTIC:
            # one block writes each dk, dv row once, summing in a fixed
            # order: a second launch gives the same bits
            again = fc.flash_bwd_dkv(q, k, v, do, lse, dd, **kw)
            torch.cuda.synchronize()
            same = [bool(torch.equal(a, g_)) for a, g_ in zip(again,
                                                             got[1:])]
            check(all(same), f"K7 {tag}: dk, dv differ between two "
                  f"launches (equal: {same})")
            phase("kernels", kernel=fc.DKV, case=tag,
                  deterministic="bitwise", launches_compared=2)
            del again
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
        if window is not None:
            # the control: every causal key attended, the window dropped
            f_res = list(map(grad_agreement, fc.flash_bwd_plain(
                q, k, v, out, lse, do, **dict(kw, window=None)), want))
            check(not all(r[0] for r in f_res), f"K6/K7 {tag}: the check "
                  f"passed the control without the window")
            faults["no_window"] = "/".join(f"{r[1]:.3e}" for r in f_res)
        if not causal:
            # the control: the causal mask where every key is attended
            f_res = list(map(grad_agreement, fc.flash_bwd_plain(
                q, k, v, out, lse, do, **dict(kw, causal=True)), want))
            check(not all(r[0] for r in f_res), f"K6/K7 {tag}: the check "
                  f"passed the causal control")
            faults["causal"] = "/".join(f"{r[1]:.3e}" for r in f_res)
        dq_ms = cuda_ms(lambda: fc.flash_bwd_dq(q, k, v, do, lse, dd, **kw),
                        reps)
        dkv_ms = cuda_ms(lambda: fc.flash_bwd_dkv(q, k, v, do, lse, dd, **kw),
                         reps)
        plain_ms = cuda_ms(lambda: fc.flash_bwd_plain(q, k, v, out, lse, do,
                                                      **kw), 3, warmup=1)
        # the yardstick: autograd's backward of SDPA, dq, dk and dv
        # together (never called by the port); a window as a boolean mask
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        if window is None:
            o = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                               scale=scale, enable_gqa=True)
        else:
            allowed = fc.mask(s, s, causal=True, window=window, kv_len=s,
                              device=dev)
            o = F.scaled_dot_product_attention(*leaves, attn_mask=allowed,
                                               scale=scale, enable_gqa=True)
        lib = lambda: torch.autograd.grad(      # noqa: E731
            o, leaves, do, retain_graph=True)
        lib_err = max(float((x.float() - w.float()).abs().max())
                      for x, w in zip(lib(), want))
        library_ms = cuda_ms(lib, reps)
        backend, lib_kernel = sdpa_backend(lib)
        del o, leaves
        elt = q.element_size()
        pairs = attention_pairs(s, window, causal)
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
                  D=d, dtype=dname, causal=causal, window=window,
                  **{f"d{n[1:]}_max_abs_err": f"{res[n][1]:.3e}"
                     for n in outs},
                  **{f"d{n[1:]}_differing_share": f"{res[n][2]:.2e}"
                     for n in outs},
                  ms=f"{ms:.6f}", plain_ms_dq_dk_dv=f"{plain_ms:.6f}",
                  library_ms_dq_dk_dv=f"{library_ms:.6f}",
                  library_factor=f"{(dq_ms + dkv_ms) / library_ms:.3f}",
                  library_max_abs_err=f"{lib_err:.3e}",
                  library_backend=backend, library_kernel=lib_kernel,
                  bound_ms=f"{b_ms:.6f}", bound_by=b_by,
                  tflops=f"{flops / ms / 1e9:.2f}")
            rname = row_name(name, d, window, tag)
            row = table.setdefault(rname, dict(
                name=rname, route="cuda",
                source=f"{CSRC}/flash_attention_bwd.cu",
                replaces=fc.REPLACES[name], launches=0, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms,
                library_factor=(dq_ms + dkv_ms) / library_ms))
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
    if not small:
        return table
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


# --- phase 3d: K5, K6 and K7 at head dim 112, behind the wrapper's pad -----------
def pad_scale_fwd(q, k, v, **kw):
    """K5's plain version with the softmax scale of the padded head dim
    (what a wrapper that took the scale after padding would pass): the
    D = 112 control."""
    from repro_torch.kernels import flash_cuda as fc
    return fc.flash_fwd_plain(q, k, v, **dict(kw,
                                             sm_scale=q.shape[-1] ** -0.5))


def padded_kernel_phase(dev, k5=None, bwd=None):
    """K5 at ``k5`` (tag, B, H = Hkv, S, timed reps; default zamba2's
    serving shape, ZAMBA_K5) and K6 / K7 at ``bwd`` (default its training
    shape, ZAMBA_BWD) at head dim ZAMBA_D, which no kernel is built for:
    through
    ``ops.flash_attention`` (zero-padded to 128, the output sliced back;
    under autograd for K6 and K7) and bare on inputs padded beforehand,
    each against the plain version at D = 112, with a control at the
    padded D's scale; timed beside SDPA at D = 112; K7 twice where the
    tag is in K7_DETERMINISTIC. Returns the ``<kernel>_d112`` rows (a
    local-head tag's: ``<kernel>_<tag>``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_cuda as fc
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(2)
    d, dp = ZAMBA_D, ops.padded_head_dim(ZAMBA_D)
    scale = d ** -0.5
    kw = dict(sm_scale=scale, causal=True, window=None)
    table = {}

    def padded(*ts):
        return [F.pad(t, (0, dp - d)).contiguous() for t in ts]

    # K5 at the serving shape
    tag, b, h, s, reps = k5 or ("zamba2",) + ZAMBA_K5 + (10,)
    q, k, v = _attention_case(dev, gen, b, h, h, s, d, torch.bfloat16)
    pout, plse = fc.flash_fwd_plain(q, k, v, **kw)
    wrapped = ops.flash_attention(q, k, v, causal=True)
    qp, kp, vp = padded(q, k, v)
    out, lse = fc.flash_fwd(qp, kp, vp, **kw)
    torch.cuda.synchronize()
    ok, err, err_lse, share = k5_agreement(out[..., :d].contiguous(), lse,
                                           pout, plse)
    check(ok, f"K5 d{d} (bare, padded): out err {err} (share {share}), "
          f"lse err {err_lse}")
    w_ok, w_err, w_share = agreement(wrapped, pout)
    check(w_ok, f"K5 d{d} through the wrapper: err {w_err} (share "
          f"{w_share})")
    check(bool((out[..., d:] == 0).all()), f"K5 d{d}: the padded columns "
          f"of out are not zero")
    c_ok, c_err, c_lse, _ = k5_agreement(
        *[t[..., :d].contiguous() if t.dim() == 4 else t
          for t in pad_scale_fwd(qp, kp, vp, **kw)], pout, plse)
    check(not c_ok, f"K5 d{d}: the check passed the padded-scale control")
    ms = cuda_ms(lambda: fc.flash_fwd(qp, kp, vp, **kw), reps)
    wrapper_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True),
                         reps)
    plain_ms = cuda_ms(lambda: fc.flash_fwd_plain(q, k, v, **kw), 3,
                       warmup=1)
    lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
        q, k, v, is_causal=True, scale=scale)
    lib_err = float((lib().float() - pout.float()).abs().max())
    library_ms = cuda_ms(lib, reps)
    backend, lib_kernel = sdpa_backend(lib)
    pairs = attention_pairs(s, None)
    # q, k, v and out at the model's D, lse float32
    nbytes = 4 * q.numel() * q.element_size() + lse.numel() * 4
    flops = 4 * d * b * h * pairs
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    phase("kernels", kernel=fc.NAME, case=tag, B=b, H=h, Hkv=h, S=s,
          D=d, padded_D=dp, dtype="bfloat16", causal=True,
          max_abs_err=f"{err:.3e}", lse_max_abs_err=f"{err_lse:.3e}",
          differing_share=f"{share:.2e}", wrapper_max_abs_err=f"{w_err:.3e}",
          control_pad_scale_err=f"{c_err:.3e}/{c_lse:.3e}",
          library_max_abs_err=f"{lib_err:.3e}", ms=f"{ms:.6f}",
          wrapper_ms=f"{wrapper_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
          library_ms=f"{library_ms:.6f}",
          library_factor=f"{ms / library_ms:.3f}", library_backend=backend,
          library_kernel=lib_kernel, bound_ms=f"{b_ms:.6f}", bound_by=b_by,
          tflops=f"{flops / ms / 1e9:.2f}",
          padded_share_of_work=f"{1 - d / dp:.3f}")
    rname = row_name(fc.NAME, d, tag=tag)
    table[rname] = dict(
        name=rname, route="cuda", source=f"{CSRC}/flash_attention.cu",
        replaces=fc.REPLACES[fc.NAME], launches=0,
        max_abs_err=max(err, err_lse, w_err), ms=ms, wrapper_ms=wrapper_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms, library_factor=ms / library_ms,
        library_backend=backend)
    del q, k, v, qp, kp, vp, out, lse, pout, plse, wrapped
    torch.cuda.empty_cache()

    # K6 and K7 at the training shape
    tag, b, h, s, reps = bwd or ("zamba2_train",) + ZAMBA_BWD + (5,)
    q, k, v = _attention_case(dev, gen, b, h, h, s, d, torch.bfloat16)
    do = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    qp, kp, vp, dop = padded(q, k, v, do)
    out, lse = fc.flash_fwd(qp, kp, vp, **kw)
    dd = torch.sum(dop.float() * out.float(), dim=-1)
    # the plain backward at D = 112 from K5's out and lse, as the kernels
    # (and, through autograd, the wrapper) take them
    pout = out[..., :d].contiguous()
    want = fc.flash_bwd_plain(q, k, v, pout, lse, do, **kw)
    bare = (fc.flash_bwd_dq(qp, kp, vp, dop, lse, dd, **kw),
            *fc.flash_bwd_dkv(qp, kp, vp, dop, lse, dd, **kw))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=True)
    wrap = lambda: torch.autograd.grad(         # noqa: E731
        o, leaves, do, retain_graph=True)
    through = wrap()
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv")
    res = {}
    for n, g_bare, g_wrap, w in zip(names, bare, through, want):
        check(bool((g_bare[..., d:] == 0).all()), f"K6/K7 d{d}: padded "
              f"columns of {n} are not zero")
        ok, err, share = grad_agreement(g_bare[..., :d].contiguous(), w)
        check(ok, f"K6/K7 d{d} {n} (bare, padded): err {err} (share "
              f"{share})")
        w_ok, w_err, _ = grad_agreement(g_wrap, w)
        check(w_ok, f"K6/K7 d{d} {n} through the wrapper: err {w_err}")
        res[n] = (err, share, w_err)
    c_res = [grad_agreement(g, w) for g, w in zip(fc.flash_bwd_plain(
        q, k, v, pout, lse, do, **dict(kw, sm_scale=dp ** -0.5)), want)]
    check(not all(r[0] for r in c_res), f"K6/K7 d{d}: the check passed "
          f"the padded-scale control")
    if tag in K7_DETERMINISTIC:
        again = fc.flash_bwd_dkv(qp, kp, vp, dop, lse, dd, **kw)
        _sync(dev)
        same = [bool(torch.equal(a, g_)) for a, g_ in zip(again, bare[1:])]
        check(all(same), f"K7 {tag}: dk, dv differ between two launches "
              f"(equal: {same})")
        phase("kernels", kernel=fc.DKV, case=tag, deterministic="bitwise",
              launches_compared=2)
        del again
    dq_ms = cuda_ms(lambda: fc.flash_bwd_dq(qp, kp, vp, dop, lse, dd, **kw),
                    reps)
    dkv_ms = cuda_ms(lambda: fc.flash_bwd_dkv(qp, kp, vp, dop, lse, dd,
                                              **kw), reps)
    wrapper_ms = cuda_ms(wrap, reps)
    plain_ms = cuda_ms(lambda: fc.flash_bwd_plain(q, k, v, pout, lse, do,
                                                  **kw), 3, warmup=1)
    sl = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    so = F.scaled_dot_product_attention(*sl, is_causal=True, scale=scale)
    lib = lambda: torch.autograd.grad(          # noqa: E731
        so, sl, do, retain_graph=True)
    lib_err = max(float((x.float() - w.float()).abs().max())
                  for x, w in zip(lib(), want))
    library_ms = cuda_ms(lib, reps)
    backend, lib_kernel = sdpa_backend(lib)
    pairs = attention_pairs(s, None)
    elt = q.element_size()
    inputs = 4 * q.numel() * elt + 2 * lse.numel() * 4
    rows = {fc.DQ: (dq_ms, bound(inputs + q.numel() * elt,
                                 6 * d * b * h * pairs, BF16_FLOPS),
                    ("dq",)),
            fc.DKV: (dkv_ms, bound(inputs + 2 * q.numel() * elt,
                                   8 * d * b * h * pairs, BF16_FLOPS),
                     ("dk", "dv"))}
    for name, (ms, (b_ms, b_by), outs) in rows.items():
        err = max(max(res[n][0], res[n][2]) for n in outs)
        phase("kernels", kernel=name, case=tag, B=b, H=h, Hkv=h,
              S=s, D=d, padded_D=dp, dtype="bfloat16", causal=True,
              **{f"{n}_max_abs_err": f"{res[n][0]:.3e}" for n in outs},
              **{f"{n}_differing_share": f"{res[n][1]:.2e}" for n in outs},
              **{f"{n}_wrapper_max_abs_err": f"{res[n][2]:.3e}"
                 for n in outs},
              control_pad_scale_err="/".join(f"{r[1]:.3e}" for r in c_res),
              ms=f"{ms:.6f}", wrapper_ms_dq_dk_dv=f"{wrapper_ms:.6f}",
              plain_ms_dq_dk_dv=f"{plain_ms:.6f}",
              library_ms_dq_dk_dv=f"{library_ms:.6f}",
              library_factor=f"{(dq_ms + dkv_ms) / library_ms:.3f}",
              wrapper_library_factor=f"{wrapper_ms / library_ms:.3f}",
              library_max_abs_err=f"{lib_err:.3e}", library_backend=backend,
              library_kernel=lib_kernel, bound_ms=f"{b_ms:.6f}",
              bound_by=b_by)
        rname = row_name(name, d, tag=tag)
        table[rname] = dict(
            name=rname, route="cuda",
            source=f"{CSRC}/flash_attention_bwd.cu",
            replaces=fc.REPLACES[name], launches=0, max_abs_err=err, ms=ms,
            wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms,
            library_factor=(dq_ms + dkv_ms) / library_ms,
            library_backend=backend)
    del q, k, v, do, qp, kp, vp, dop, out, lse, dd, bare, through, want
    del pout, o, leaves, so, sl
    torch.cuda.empty_cache()
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
    energy and carbon — then, after both timed runs, the first
    TELEMETRY_BURSTS bursts on cuda without and with telemetry recording.
    K3 runs at C = 6 with an exclude mask on every call: once a round and
    once a wake scoring. Returns the first cuda run's launch counts."""
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

    check(tel["placements"] == tel["bare_placements"]
          and tel["events"] == tel["bare_events"],
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
          telemetry_bursts=TELEMETRY_BURSTS,
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
    """The [policy] cuda run over its first TELEMETRY_BURSTS bursts, once
    without and once with telemetry recording: the registry's
    ``policy_preemptions`` and ``policy_node_sleeps`` must equal the run's
    counters, its Prometheus text must parse back to every counter and
    gauge, and ``html_report`` must render the run. Returns the two runs'
    placements and event logs (``policy_checks`` holds them equal),
    what the policies did by the registry, and the recorded run's wall
    time."""
    import torch

    from repro_torch.cluster.parity import policy_knobs
    from repro_torch.cluster.simulator import run_scenario
    from repro_torch.core import telemetry
    from repro_torch.telemetry import (html_report, parse_prometheus,
                                       prometheus_text)
    carbon, autoscale = policy_knobs()

    def run():
        return run_scenario(policy_arrivals(TELEMETRY_BURSTS), POLICY_SCHEME,
                            cluster_factory=scenario_fleet, batch=True,
                            batch_backend="cuda", carbon=carbon,
                            autoscale=autoscale, device=dev)
    bare = run()
    with telemetry.enabled() as tel:
        t0 = time.perf_counter()
        res = run()
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
                bare_placements=placements(bare), bare_events=bare.events,
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
    synchronise); ``on_call`` runs before each call."""

    def __init__(self, model, on_call=None):
        self.model = model
        self.calls = []
        self.on_call = on_call

    def _record(self, kind, tokens, fn):
        import torch
        if self.on_call is not None:
            self.on_call()
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


class RoutingRecorder:
    """Every ``moe.route`` call of a run, grouped by model call (a prefill
    or a decode step; ``mark`` opens the next): per route call, the
    (G, S, K) chosen experts. With ``lead`` (another run's recorder over
    the same calls) the run takes the lead's choices instead of its own,
    as ``cluster/parity.py`` has numpy follow cuda's near-tie breaks, and
    counts, per model call, the (layer, token) selections where its own
    set differs (``flips``) and how far below its own k-th best score
    (under its own scores) the lead's worst choice lies at most
    (``gaps``)."""

    def __init__(self, lead=None):
        self.calls, self.flips, self.gaps = [], [], []
        self.lead = lead
        self.compared = 0

    def mark(self):
        self.calls.append([])
        self.flips.append(0)
        self.gaps.append(0.0)

    @contextlib.contextmanager
    def hook(self):
        import torch

        from repro_torch.models import moe
        route = moe.route

        def recording(p, cfg, x_flat):
            own = route(p, cfg, x_flat)
            if self.lead is None:
                self.calls[-1].append(own.idx)
                return own
            lead = self.lead.calls[len(self.calls) - 1][len(self.calls[-1])]
            self.calls[-1].append(lead)
            differ = (torch.sort(own.idx, dim=-1)[0]
                      != torch.sort(lead, dim=-1)[0]).any(-1)
            self.compared += differ.numel()
            self.flips[-1] += int(differ.sum())
            if bool(differ.any()):
                _, sel = moe.selection_scores(p, x_flat)
                kth = torch.gather(sel, -1, own.idx[..., -1:])
                gap = (kth - torch.gather(sel, -1, lead)).amax(-1)
                self.gaps[-1] = max(self.gaps[-1], float(gap[differ].max()))
            return route(p, cfg, x_flat, choices=lead)

        moe.route = recording
        try:
            yield self
        finally:
            moe.route = route


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
    """Route K5's binding to ``fn`` for one run (None: the kernel)."""
    return kernel_route(flash_fwd=fn) if fn else contextlib.nullcontext()


def teacher_forced(model, calls, max_len, on_call=None):
    """The logits of every recorded call, replayed on ``model`` with the
    recorded input tokens; ``on_call`` runs before each."""
    out, cache = [], None
    for call in calls:
        if on_call is not None:
            on_call()
        if call["kind"] == "prefill":
            logits, cache = model.prefill(call["tokens"], max_len)
        else:
            logits, cache = model.decode(cache, call["tokens"])
        out.append(logits)
    return out


def replay(model, calls, max_len, fwd=None, lead=None):
    """``teacher_forced`` with K5's binding routed to ``fwd`` (None: the
    kernel); an MoE model's routing recorded, following ``lead``'s
    choices where given. Returns (logits, recorder or None)."""
    rec = RoutingRecorder(lead) if model.cfg.is_moe else None
    with attention_route(fwd), (rec.hook() if rec
                                else contextlib.nullcontext()):
        logits = teacher_forced(model, calls, max_len,
                                rec.mark if rec else None)
    return logits, rec


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


def follow_check(rec, tag, arch, what, held=None):
    """Print and check a following run's routing differences: those of
    its first ``held`` model calls (default: all) each a near-tie within
    ROUTE_TIE_TOL; the rest's largest gap is printed beside."""
    if rec is None:
        return
    held = len(rec.gaps) if held is None else held
    gap = max(rec.gaps[:held], default=0.0)
    phase(tag, arch=arch, routing=what, selections_compared=rec.compared,
          selections_differing=sum(rec.flips),
          held_calls=held, max_flip_score_gap=f"{gap:.4e}",
          later_max_flip_score_gap=f"{max(rec.gaps[held:], default=0.0):.4e}",
          flip_gap_limit=ROUTE_TIE_TOL)
    check(gap <= ROUTE_TIE_TOL, f"{what}: a routing difference {gap} below "
          f"the k-th score, beyond {ROUTE_TIE_TOL}")


def float32_model(model):
    """``model`` with its weights upcast to float32 in place: the same
    function with every bf16 rounding point a no-op."""
    import dataclasses
    model.float()
    model.cfg = dataclasses.replace(model.cfg, dtype="float32")
    return model


def device_ms(fn, top=None, cpu=True):
    """Device time (ms) of everything ``fn`` launches, by torch.profiler
    (recording the host's ops too unless ``cpu`` is off),
    split into K5, K6, K7, matrix products (cuBLAS's gemm / gemv / nvjet
    kernels, CUTLASS), gathers, scatters, sorts and scans (``dispatch``:
    the MoE's routing, dispatch and combine, and the embedding lookup),
    NCCL's collective kernels and the rest; None where the profiler
    records no device time. With a list ``top``, the 8 longest kernels
    (name, ms) are put in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {"k5": 0.0, "k6": 0.0, "k7": 0.0, "gemm": 0.0, "dispatch": 0.0,
             "nccl": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        group = ("nccl" if "nccl" in name else
                 "k5" if "flash_fwd_kernel" in name else
                 "k6" if "flash_bwd_dq_kernel" in name else
                 "k7" if "flash_bwd_dkv_kernel" in name else
                 "gemm" if any(t in name for t in ("gemm", "gemv", "xmma",
                                                   "cutlass", "nvjet"))
                 else "dispatch" if any(t in name for t in (
                     "index", "scatter", "gather", "sort", "scan"))
                 else "other")
        split[group] += ev.self_device_time_total / 1e3
    if top is not None:
        evs = sorted((ev for ev in prof.key_averages()
                      if ev.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)[:8]
        top.extend((ev.key.replace(" ", "")[:60],
                    round(ev.self_device_time_total / 1e3, 3)) for ev in evs)
    return split if sum(split.values()) > 0 else None


def no_window_fwd(q, k, v, **kw):
    """K5's plain version with the window dropped (every causal key): the
    windowed model's float32 control."""
    from repro_torch.kernels import flash_cuda as fc
    return fc.flash_fwd_plain(q, k, v, **dict(kw, window=None))


def flash_layers(model):
    """The blocks of ``model`` whose prefill runs K5: its GQA
    self-attention blocks (an encoder's included; a VLM group's dense
    blocks; zamba2's shared block once a group), not MLA's, no
    cross-attention, no Mamba2 or RWKV block."""
    def runs(b):
        if b.kind == "vlm_group":
            return len(b.selfs)
        if b.kind in ("mamba_group", "mamba", "rwkv"):
            return int(b.kind == "mamba_group")
        return int(not b.kind.startswith("mla"))
    return sum(runs(b) for b in model.blocks)


def causal_fwd(q, k, v, **kw):
    """K5's plain version with every call causal: a bidirectional
    encoder's control."""
    from repro_torch.kernels import flash_cuda as fc
    return fc.flash_fwd_plain(q, k, v, **dict(kw, causal=True))


def with_inputs(calls, **inputs):
    """Recorded calls with the prefill batches' inputs replaced (other
    frames or vision tokens, as numpy arrays)."""
    return [dict(c, tokens={**c["tokens"], **inputs})
            if c["kind"] == "prefill" else c for c in calls]


def cross_extra(cfg, b, seed):
    """A batch's cross-attended inputs for ``cfg`` (``frames`` /
    ``vision``): normal * 0.1 float32 (b, T, d_model) from numpy."""
    import numpy as np

    from repro_torch.models.lm import cross_inputs
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=(b, *shape)) * 0.1).astype(np.float32)
            for k, shape in cross_inputs(cfg).items()}


def serve_requests(vocab, prompt, new, lengths=None):
    """SERVE_REQUESTS requests of ``new`` tokens (no end token), their
    prompt lengths drawn from ``prompt`` (inclusive) unless ``lengths``
    gives them, the tokens in [2, vocab): (lengths, requests)."""
    import numpy as np

    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(0)
    drawn = rng.integers(prompt[0], prompt[1] + 1, SERVE_REQUESTS)
    lengths = drawn if lengths is None else np.asarray(lengths)
    return lengths, [Request(i, rng.integers(2, vocab, n).astype(np.int32),
                             max_new_tokens=new, eos_id=-1)
                     for i, n in enumerate(lengths)]


def serve_phase(dev, arch=SERVE_ARCH, *, layers=None, prompt=SERVE_PROMPT,
                new=SERVE_NEW, max_len=None, f32=None,
                controls=(("p_bf16", attention_fault, None, F32_LOGIT_TOL),),
                prepare=None, checks=None, tag="serve", lengths=None,
                profile=("prefill", "decode"), spread=False):
    """``arch`` at full width (at ``layers`` layers; default all), served
    through ``Engine`` (with ``cross_extra`` inputs where the arch
    cross-attends) with K5 on every GQA layer's prefill, against the
    plain path teacher-forced on the kernel run's tokens (an MoE model's
    plain run following the kernel run's routing, each difference a
    near-tie); ``checks(model, rec, max_len)`` then runs on the bf16
    model. Then in float32 (``f32``: None upcasts the model in place, a
    dict builds a fresh one with those config overrides, False skips)
    against the plain path, with ``controls``: (name, a K5 binding, the
    inputs of its prefills (None: the run's), a limit it must lie beyond).
    ``prepare(model)`` runs on each model built. An MLA or RWKV model (no
    K5 launch) is checked for finite logits only. ``lengths`` gives the
    prompt lengths in place of draws from ``prompt``; without
    ``profile`` names what torch.profiler records (the last wave's
    prefill, PROFILE_STEPS decode steps after it); with
    ``spread`` the bf16 limit is SPREAD_RATIO times the plain path's
    distance from float64 attention (at least LOGIT_TOL). Returns its
    launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_cuda, rmsnorm_cuda
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine

    cfg = registry.config(arch, attn_impl="flash",
                          **({"n_layers": layers} if layers else {}))
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, device=dev, seed=0)
    if prepare is not None:
        prepare(model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    n_gqa = flash_layers(model)
    lengths, reqs = serve_requests(cfg.vocab, prompt, new, lengths)
    max_len = max_len or int(lengths.max()) + new
    routes = RoutingRecorder() if cfg.is_moe else None
    rec = RecordingLM(model, routes.mark if routes else None)
    extra = cross_extra(cfg, SERVE_SLOTS, 1)
    eng = Engine(rec, batch_slots=SERVE_SLOTS, max_len=max_len,
                 extra_inputs=extra)

    # the main path: counts set to 0 just before, read just after
    with routes.hook() if routes else contextlib.nullcontext():
        flash_cuda.reset_launches()
        rmsnorm_cuda.reset_launches()
        t0 = time.perf_counter()
        results = eng.serve(reqs)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = {**flash_cuda.LAUNCHES, **rmsnorm_cuda.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()

    waves = -(-SERVE_REQUESTS // SERVE_SLOTS)
    check(launches[flash_cuda.NAME] == n_gqa * waves,
          f"K5 launches {launches[flash_cuda.NAME]} != GQA layers x waves "
          f"{n_gqa * waves}")
    check(launches[rmsnorm_cuda.NAME] == 0, "K8 ran on the serving path")
    check(launches[flash_cuda.DQ] == launches[flash_cuda.DKV] == 0,
          "K6/K7 ran on the serving path")
    check(sorted(r.uid for r in results) == list(range(SERVE_REQUESTS)),
          "requests lost")
    for r in results:
        check(len(r.tokens) == new, f"request {r.uid}: "
              f"{len(r.tokens)} tokens")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab)).all()),
              f"request {r.uid}: token out of range")
    for c in rec.calls:
        check(bool(torch.isfinite(c["logits"]).all()), "non-finite logits")

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

    top = []
    if "prefill" in profile:
        split_pre = device_ms(prefill, top)
    else:
        prefill()
        split_pre = "not profiled"
    split_dec = (device_ms(decode) if "decode" in profile
                 else "not profiled")
    del state
    if top:
        phase(tag, arch=arch, profile="prefill_longest_kernels_ms",
              kernels=json.dumps(top, separators=(",", ":")))
    for what, split, wall_ms in (
            ("prefill", split_pre, 1e3 * prefill_s[-1]),
            ("decode_step", split_dec if not isinstance(split_dec, dict)
             else {k: v / PROFILE_STEPS for k, v in split_dec.items()},
             1e3 * float(np.median(decode_s)))):
        if split is None or isinstance(split, str):
            phase(tag, arch=arch, profile=what,
                  device_time=split or "not recorded")
            continue
        busy = sum(split.values())
        phase(tag, arch=arch, profile=what, wall_ms=f"{wall_ms:.3f}",
              device_ms=f"{busy:.3f}", k5_ms=f"{split['k5']:.3f}",
              gemm_ms=f"{split['gemm']:.3f}",
              dispatch_ms=f"{split['dispatch']:.3f}",
              other_ms=f"{split['other']:.3f}",
              device_idle_share=f"{max(0.0, 1 - busy / wall_ms):.3f}")
    prefill_tok = sum(c["tokens"]["tokens"].size for c in rec.calls
                      if c["kind"] == "prefill")
    n_tok = sum(len(r.tokens) for r in results)
    phase(tag, arch=arch, n_layers=cfg.n_layers,
          n_encoder_layers=cfg.n_encoder_layers or None,
          params=n_params, requests=SERVE_REQUESTS, slots=SERVE_SLOTS,
          waves=waves, prompt_lengths=",".join(map(str, lengths)),
          cross_inputs=",".join(f"{k}:{'x'.join(map(str, a.shape))}"
                                for k, a in extra.items()) or None,
          max_new_tokens=new, max_len=max_len, window=cfg.attn_window,
          capacity_factor=cfg.capacity_factor if cfg.is_moe else None,
          init_s=f"{init_s:.3f}", serve_s=f"{serve_s:.3f}",
          tokens=n_tok, tokens_per_s=f"{n_tok / serve_s:.2f}",
          prefill_s_per_wave=",".join(f"{x:.4f}" for x in prefill_s),
          prefill_padded_tokens_per_s=f"{prefill_tok / sum(prefill_s):.1f}",
          decode_steps=len(decode_s),
          decode_ms_median=f"{1e3 * float(np.median(decode_s)):.3f}",
          decode_ms_max=f"{1e3 * max(decode_s):.3f}",
          max_memory_allocated=peak,
          launches=json.dumps(launches, separators=(",", ":")))
    if n_gqa == 0:
        # no kernel on this path: the plain path is the same computation
        del model, rec, eng
        _free()
        return launches

    # the same requests on K5's plain version, teacher-forced on the
    # kernel run's tokens (an MoE model following the kernel run's
    # routing, each difference a near-tie)
    kernel_logits = [c["logits"] for c in rec.calls]
    before = flash_cuda.LAUNCHES[flash_cuda.NAME]
    plain, plain_routes = replay(model, rec.calls, max_len,
                                 flash_cuda.flash_fwd_plain, lead=routes)
    check(flash_cuda.LAUNCHES[flash_cuda.NAME] == before,
          "a comparison run launched K5")
    follow_check(plain_routes, tag, arch, "plain_follows_kernel")
    tol = LOGIT_TOL
    if spread:
        # the plain path's own spread: the same calls with float64
        # attention rounded back
        f64, _ = replay(model, rec.calls, max_len, _plain64_fwd)
        spread_err = max_diff(plain, f64)
        del f64
        tol = max(LOGIT_TOL, SPREAD_RATIO * spread_err)
        by_kind = {k: max((float((g - w).abs().max()) for g, w, c in zip(
            kernel_logits, plain, rec.calls) if c["kind"] == k),
            default=0.0) for k in ("prefill", "decode")}
        phase(tag, arch=arch, check="spread",
              plain_vs_float64_attention=f"{spread_err:.4e}",
              spread_ratio=SPREAD_RATIO, logit_tol=f"{tol:.4e}",
              **{f"{k}_max_logit_err_vs_plain": f"{v:.4e}"
                 for k, v in by_kind.items()})
    stats = compare_runs(kernel_logits, plain, tol)
    phase(tag, arch=arch, compared_rows=stats["rows"],
          max_abs_logit=f"{max(float(x.abs().max()) for x in plain):.4f}",
          max_logit_err_vs_plain=f"{stats['max_err']:.4e}",
          logit_tol=f"{tol:.4g}", near_ties=stats["near_ties"],
          max_near_tie_gap=f"{stats['max_tie_gap']:.4e}")
    del plain, kernel_logits, plain_routes
    if checks is not None:
        checks(model, rec, max_len)
    if f32 is False:
        del model, rec, eng
        _free()
        return launches

    # the same weights in float32 (upcast in place, or a fresh model with
    # the f32 overrides): K5's float32 instantiation against its plain
    # version, and each control (routing on its own) beyond its limit
    t0 = time.perf_counter()
    if f32 is None:
        float32_model(model)
    else:
        rec.model = eng.model = None
        del model
        _free()
        torch.cuda.reset_peak_memory_stats()
        model = LM(dataclasses.replace(cfg, dtype="float32", **f32),
                   device=dev, seed=0)
        if prepare is not None:
            prepare(model)
    _free()
    n32 = flash_layers(model)
    before = flash_cuda.LAUNCHES[flash_cuda.NAME]
    k32, k32_routes = replay(model, rec.calls, max_len)
    check(flash_cuda.LAUNCHES[flash_cuda.NAME] - before == n32 * waves,
          "the float32 run did not launch K5 once per layer and prefill")
    p32, p32_routes = replay(model, rec.calls, max_len,
                             flash_cuda.flash_fwd_plain, lead=k32_routes)
    ctl = {}
    for name, fwd, inputs, _ in controls:
        calls = rec.calls if inputs is None else with_inputs(rec.calls,
                                                             **inputs)
        c32, _ = replay(model, calls, max_len, fwd)
        ctl[name] = max_diff(c32, p32)
        del c32
    phase(tag, arch=arch, dtype="float32", n_layers=model.cfg.n_layers,
          n_encoder_layers=model.cfg.n_encoder_layers or None,
          max_logit_err_vs_plain=f"{max_diff(k32, p32):.4e}",
          **{f"control_{n}_vs_plain": f"{v:.4e}" for n, v in ctl.items()},
          logit_tol=F32_LOGIT_TOL,
          control_limits=",".join(str(c[3]) for c in controls),
          seconds=f"{time.perf_counter() - t0:.1f}",
          max_memory_allocated=torch.cuda.max_memory_allocated())
    follow_check(p32_routes, tag, arch, "float32_plain_follows_kernel")
    stats32 = compare_runs(k32, p32, F32_LOGIT_TOL)
    for name, _, _, limit in controls:
        check(ctl[name] > limit, f"the control ({name}) lies within {limit} "
              f"of the plain path: {ctl[name]}")
    phase(tag, arch=arch, dtype="float32",
          compared_rows=stats32["rows"],
          near_ties=stats32["near_ties"],
          max_near_tie_gap=f"{stats32['max_tie_gap']:.4e}")
    del model, rec, eng, k32, p32
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


def _sync(dev):
    """Wait for ``dev``'s work (nothing to wait for on the CPU)."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev):
    """``max_memory_allocated`` on a card; 0 on the CPU."""
    import torch
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def train_argv(arch, layers=None, seq_len=4096, batch=1):
    """launch.train's arguments for ``arch``'s training slice: ``batch``
    ``seq_len``-token sequences a step, at ``layers`` layers (default:
    all)."""
    argv = ["--arch", arch] + TRAIN_ARGV
    argv[argv.index("--seq-len") + 1] = str(seq_len)
    argv[argv.index("--global-batch") + 1] = str(batch)
    return argv + (["--layers", str(layers)] if layers else [])


def train_inputs(cfg, batch):
    """launch.train's ``extra_inputs`` for ``cfg``: the cross-attended
    inputs of each step (``cross_extra`` seeded by the step), or None."""
    from repro_torch.models.lm import cross_inputs
    if not cross_inputs(cfg):
        return None
    return lambda step: cross_extra(cfg, batch, 1000 + step)


def full_depth_run(tag, route, profile=False, arch=SERVE_ARCH, argv=None,
                   line="train", lead=None, prepare=None, trace=True,
                   halves="grads", quantized=True):
    """TRAIN_STEPS steps of launch.train's code path (``build`` then
    ``train_steps``) for ``arch`` (with ``argv``, default
    ``train_argv(arch)``, and int8 moments unless ``quantized`` is off,
    when ``argv`` says; an arch that cross-attends with
    ``train_inputs``) with the flash bindings routed by ``route``;
    ``prepare(model)`` runs on the model built. Returns the launch counts
    of each step, the peak device memory and, with ``profile``, the time
    split of one more step (by torch.profiler, unless ``trace`` is off) and
    its two halves on the host clock (``halves="update"``: the AdamW update
    alone, on zero gradients, without the gradients' pass). An MoE model's routing over the steps is
    recorded (``routes``), following ``lead``'s (another run's
    ``routes``) where given."""
    import torch

    from repro_torch.kernels import flash_cuda as fc
    from repro_torch.launch import train as lt
    from repro_torch.optim import adamw
    from repro_torch.train import loop as tl

    args = lt.parse((argv or train_argv(arch))
                    + (["--quantized-state"] if quantized else []))
    _free()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    with kernel_route(**route):
        t0 = time.perf_counter()
        r = lt.build(args, train_inputs(lt.config(args), args.global_batch))
        if prepare is not None:
            prepare(r.model)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        out["params"] = sum(p.numel() for p in r.model.parameters())
        out["flash_layers"] = flash_layers(r.model)
        last = {}

        routes = RoutingRecorder(lead) if r.cfg.is_moe else None

        def on_step(h):
            if routes:
                routes.mark()                   # the next step's calls
            h["launches"] = {k: n - last.get(k, 0)
                             for k, n in fc.LAUNCHES.items()}
            last.update(fc.LAUNCHES)
            phase(line, arch=arch, run=tag, step=h["step"],
                  loss=f"{h['loss']:.6f}", aux=f"{h['aux']:.6f}",
                  grad_norm=f"{h['grad_norm']:.6f}", lr=f"{h['lr']:.6e}",
                  time_s=f"{h['time_s']:.3f}",
                  launches=json.dumps(h["launches"], separators=(",", ":")))

        # the main path: counts set to 0 just before, read just after
        with routes.hook() if routes else contextlib.nullcontext():
            if routes:
                routes.mark()
            fc.reset_launches()
            out["hist"] = lt.train_steps(r, 0, TRAIN_STEPS, on_step=on_step)
            out["launches"] = dict(fc.LAUNCHES)
        out["routes"] = routes
        out["peak"] = torch.cuda.max_memory_allocated()
        if profile:
            n = TRAIN_STEPS
            out["split"] = "not profiled"
            if trace:
                t0 = time.perf_counter()
                out["split"] = device_ms(lambda: lt.train_steps(r, n, n + 1))
                out["profiled_wall_s"] = time.perf_counter() - t0
            # the step's two halves on the host clock, unprofiled
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if halves == "grads":
                _, _, grads = tl.microbatch_grads(
                    r.model, r.state["params"], r.data_fn(n + 1), 1)
            else:
                grads = {k: torch.zeros_like(p)
                         for k, p in r.state["params"].items()}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            adamw.update(r.ocfg, grads, r.state["opt_state"],
                         r.state["params"], decay=r.model.decays())
            torch.cuda.synchronize()
            out["update_s"] = time.perf_counter() - t1
            out["grads_s"] = (f"{t1 - t0:.3f}" if halves == "grads"
                              else "not measured")
        del r
    _free()
    return out


def train_phase(dev, arch=SERVE_ARCH, layers=None, seq_len=4096,
                tag="train", batch=1, prepare=None, trace=True, spread=True):
    """``arch`` training at full width and depth (or ``layers`` layers) on
    ``batch`` ``seq_len``-token sequences a step, kernel run against the
    plain run (an MoE model's following the kernel run's routing);
    ``prepare(model)`` runs on each model built; without ``trace`` no
    step is profiled; with ``spread`` the same steps with float64
    attention give the plain path's own spread (printed beside, not
    held). Returns the kernel run's launch counts."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_cuda as fc

    cfg = registry.config(arch)
    n_layers = layers or cfg.n_layers
    argv = train_argv(arch, layers, seq_len, batch)
    t0 = time.perf_counter()
    kern = full_depth_run("kernel", {}, profile=True, arch=arch, argv=argv,
                          line=tag, prepare=prepare, trace=trace)
    n_flash = kern["flash_layers"]
    for h in kern["hist"]:
        check(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]),
              f"step {h['step']}: loss {h['loss']} grad_norm "
              f"{h['grad_norm']}")
        want = {fc.NAME: 2 * n_flash, fc.DQ: n_flash, fc.DKV: n_flash}
        got = {k: h["launches"][k] for k in want}
        check(got == want, f"step {h['step']}: launches {got} != {want} "
              f"(forward + recompute, dq, dk/dv per layer)")
    launches = kern["launches"]
    # an MoE model's plain runs follow the kernel run's routing; each
    # difference in step 1, where both runs have the same weights, a
    # near-tie (ROUTE_TIE_TOL). After it, Adam's sign-like first updates
    # have moved the two runs' weights apart by up to a step an element,
    # so later differences are not attention's alone: printed, not held.
    plain = full_depth_run("plain", dict(flash_fwd=fc.flash_fwd_plain,
                                         flash_bwd=fc.flash_bwd_plain),
                           arch=arch, argv=argv, line=tag,
                           lead=kern["routes"], prepare=prepare)
    follow_check(plain["routes"], tag, arch, "plain_follows_kernel", held=1)
    check(sum(plain["launches"].values()) == 0, "the plain run launched a "
          "flash kernel")
    def gaps(a, b):
        return dict(
            step1_loss_rel=_rel(a[0]["loss"], b[0]["loss"]),
            step1_grad_norm_rel=_rel(a[0]["grad_norm"], b[0]["grad_norm"]),
            losses_rel=max(_rel(x["loss"], y["loss"])
                           for x, y in zip(a, b, strict=True)))
    k1, p1 = kern["hist"][0], plain["hist"][0]
    cmp = gaps(kern["hist"], plain["hist"])
    spr = None
    if spread:
        f64 = full_depth_run("plain_float64", dict(flash_fwd=_plain64_fwd,
                                                   flash_bwd=_plain64_bwd),
                             arch=arch, argv=argv, line=tag,
                             lead=kern["routes"], prepare=prepare)
        follow_check(f64["routes"], tag, arch, "float64_follows_kernel",
                     held=1)
        spr = gaps(plain["hist"], f64["hist"])
    # the profiler slows the host several-fold, so the device's idle share
    # is taken against the last unprofiled step's wall time
    split, wall = kern["split"], kern["hist"][-1]["time_s"]
    if split is None or isinstance(split, str):
        phase(tag, arch=arch, profile="step",
              device_time=split or "not recorded")
    else:
        busy = sum(split.values())
        phase(tag, arch=arch, profile="step", wall_ms=f"{1e3 * wall:.3f}",
              profiled_wall_ms=f"{1e3 * kern['profiled_wall_s']:.3f}",
              device_ms=f"{busy:.3f}",
              **{f"{k}_ms": f"{v:.3f}" for k, v in split.items()},
              device_idle_share=f"{max(0.0, 1 - busy / (1e3 * wall)):.3f}")
    tokens = batch * (seq_len - 1)
    phase(tag, arch=arch, n_layers=n_layers,
          n_encoder_layers=cfg.n_encoder_layers or None,
          params=kern["params"], global_batch=batch,
          seq_len=seq_len, tokens_per_step=tokens, steps=TRAIN_STEPS,
          window=cfg.attn_window, quantized_state=True,
          init_s=f"{kern['init_s']:.3f}",
          step_s=",".join(f"{h['time_s']:.3f}" for h in kern["hist"]),
          plain_step_s=",".join(f"{h['time_s']:.3f}" for h in plain["hist"]),
          tokens_per_s=f"{tokens / kern['hist'][-1]['time_s']:.1f}",
          grads_s=kern["grads_s"], update_s=f"{kern['update_s']:.3f}",
          max_memory_allocated=kern["peak"],
          plain_max_memory_allocated=plain["peak"],
          launches=json.dumps(launches, separators=(",", ":")))
    phase(tag, arch=arch, compare="kernel_vs_plain",
          **{k: f"{v:.3e}" for k, v in cmp.items()},
          limits=f"{TRAIN_LOSS_RTOL}/{TRAIN_GNORM_RTOL}/{TRAIN_LOSSES_RTOL}")
    if spr is not None:
        phase(tag, arch=arch, compare="plain_vs_float64_attention",
              **{k: f"{v:.3e}" for k, v in spr.items()})
    phase(tag, arch=arch, seconds=f"{time.perf_counter() - t0:.1f}")
    check(cmp["step1_loss_rel"] <= TRAIN_LOSS_RTOL, f"step-1 loss: "
          f"kernel {k1['loss']} vs plain {p1['loss']}")
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


def mla_phase(dev):
    """deepseek-v3-671b's MLA in float32 at MLA_CHECK's size: the
    reference's decode invariant (the absorbed decode of token s after a
    prefill of s tokens against the prefill of s + 1 tokens, itself
    absorbed) and the same logits from the full form (the training path,
    through ``_sdpa``), each within MLA_TOL; a control decoding another
    token must lie beyond it. No flash kernel runs."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_cuda
    from repro_torch.models.lm import LM

    cfg = registry.config(DEEPSEEK_ARCH, attn_impl="flash", **MLA_CHECK)
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        1, cfg.vocab, (MLA_B, MLA_S + 1)), device=dev)
    flash_cuda.reset_launches()
    _, cache = model.prefill(toks[:, :MLA_S], MLA_S + 4)
    inc, _ = model.decode(cache, toks[:, MLA_S])
    _, cache = model.prefill(toks[:, :MLA_S], MLA_S + 4)
    other, _ = model.decode(cache, (toks[:, MLA_S] + 1) % cfg.vocab)
    full, _ = model.prefill(toks, MLA_S + 4)
    with torch.no_grad():
        hidden, _ = model.hidden(toks)
        form = model._unembed(hidden[:, -1:])[:, 0]
    torch.cuda.synchronize()
    check(sum(flash_cuda.LAUNCHES.values()) == 0, "MLA launched a flash "
          "kernel")
    err = float((inc - full).abs().max())
    err_form = float((inc - form).abs().max())
    ctl = float((other - full).abs().max())
    phase("moe", arch=DEEPSEEK_ARCH, check="mla_decode", dtype="float32",
          n_layers=cfg.n_layers, n_dense_layers=cfg.n_dense_layers,
          capacity_factor=cfg.capacity_factor, params=n_params, B=MLA_B,
          s=MLA_S, max_abs_logit=f"{float(full.abs().max()):.4f}",
          decode_vs_prefill=f"{err:.4e}",
          decode_vs_full_form=f"{err_form:.4e}",
          control_other_token=f"{ctl:.4e}", tol=MLA_TOL,
          seconds=f"{time.perf_counter() - t0:.1f}",
          max_memory_allocated=torch.cuda.max_memory_allocated())
    check(bool(torch.isfinite(inc).all() & torch.isfinite(form).all()),
          "non-finite MLA logits")
    check(err <= MLA_TOL, f"absorbed decode vs prefill: {err} > {MLA_TOL}")
    check(err_form <= MLA_TOL, f"absorbed decode vs the full form: "
          f"{err_form} > {MLA_TOL}")
    check(ctl > MLA_TOL, f"the control (another token) lies within "
          f"{MLA_TOL}: {ctl}")
    del model, cache
    _free()


def moe_phases(dev):
    """The MoE slice on the card: mixtral-8x7b served (K5 with the window
    cutting) and trained (K5-K7), deepseek-v3-671b served (MLA, no
    kernel) and its MLA decode checked. Returns mixtral's launch
    counts."""
    from repro_torch.kernels import flash_cuda

    t0 = time.perf_counter()
    launches = collections.Counter(serve_phase(
        dev, MIXTRAL_ARCH, layers=MIXTRAL_SERVE_LAYERS, prompt=MIXTRAL_PROMPT,
        new=MIXTRAL_NEW, f32={"n_layers": MIXTRAL_F32_LAYERS},
        controls=(("no_window", no_window_fwd, None, F32_LOGIT_TOL),),
        tag="moe"))
    phase("moe", arch=MIXTRAL_ARCH, path="serve",
          seconds=f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    launches.update(train_phase(dev, MIXTRAL_ARCH, MIXTRAL_TRAIN_LAYERS,
                                MIXTRAL_SEQ, tag="moe", spread=False))
    phase("moe", arch=MIXTRAL_ARCH, path="train",
          seconds=f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    ds = serve_phase(dev, DEEPSEEK_ARCH, layers=DEEPSEEK_SERVE_LAYERS,
                     prompt=DEEPSEEK_PROMPT, new=DEEPSEEK_NEW, tag="moe")
    check(ds[flash_cuda.NAME] == 0, "deepseek-v3's MLA launched K5")
    mla_phase(dev)
    phase("moe", arch=DEEPSEEK_ARCH, path="serve",
          seconds=f"{time.perf_counter() - t0:.1f}")
    return launches


def set_gates(model, value):
    """Every VLM group's x_gate and xffn_gate set to ``value``."""
    import torch
    with torch.no_grad():
        for blk in model.blocks:
            blk.x_gate.fill_(value)
            blk.xffn_gate.fill_(value)


def gate_controls(model, rec, max_len):
    """The first wave's prefill again with other vision tokens: at gates 0
    (tanh(0) erases the cross-attention branch) the logits must not move
    (GATE_CLOSED_TOL), at VISION_GATE they must move by VISION_MOVE."""
    batch = [c for c in rec.calls if c["kind"] == "prefill"][0]["tokens"]
    other = {**batch, **cross_extra(model.cfg, SERVE_SLOTS, 2)}
    moved = {}
    for gate in (0.0, VISION_GATE):
        set_gates(model, gate)
        a, _ = model.prefill(batch, max_len)
        b, _ = model.prefill(other, max_len)
        moved[gate] = float((a - b).abs().max())
    set_gates(model, VISION_GATE)
    phase("vision", arch=VISION_ARCH, check="gates",
          other_vision_at_gate_0=f"{moved[0.0]:.4e}",
          other_vision_at_gate_0_limit=GATE_CLOSED_TOL,
          **{f"other_vision_at_gate_{VISION_GATE}": f"{moved[VISION_GATE]:.4e}"},
          move_limit=VISION_MOVE)
    check(moved[0.0] <= GATE_CLOSED_TOL, f"at gates 0 other vision tokens "
          f"moved the logits by {moved[0.0]}")
    check(moved[VISION_GATE] >= VISION_MOVE, f"at gates {VISION_GATE} other "
          f"vision tokens moved the logits by {moved[VISION_GATE]} only")


def cross_phases(dev):
    """The cross-attention slice on the card: whisper-base served and
    trained at full width and depth (K5 bidirectional in the encoder at
    D = 64, K6/K7 bidirectional in training), llama-3.2-vision-90b served
    at 4 groups and trained at 1 (K5-K7 at D = 128 in the dense blocks;
    the gated cross-attention through ``_sdpa``). Returns (whisper's
    launch counts, vision's)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_cuda as fc
    t0 = time.perf_counter()
    other_frames = cross_extra(registry.config(WHISPER_ARCH), SERVE_SLOTS, 3)
    whisper = collections.Counter(serve_phase(
        dev, WHISPER_ARCH, prompt=WHISPER_PROMPT, new=WHISPER_NEW,
        max_len=WHISPER_MAX_LEN, f32=WHISPER_F32,
        controls=(("encoder_causal", causal_fwd, None, CAUSAL_MOVE),
                  ("other_frames", fc.flash_fwd_plain, other_frames,
                   FRAMES_MOVE)),
        tag="whisper"))
    phase("whisper", arch=WHISPER_ARCH, path="serve",
          seconds=f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    whisper.update(train_phase(dev, WHISPER_ARCH, tag="whisper",
                               spread=False, **WHISPER_TRAIN))
    phase("whisper", arch=WHISPER_ARCH, path="train",
          seconds=f"{time.perf_counter() - t0:.1f}")

    def gated(model):
        set_gates(model, VISION_GATE)
    t0 = time.perf_counter()
    vision = collections.Counter(serve_phase(
        dev, VISION_ARCH, layers=VISION_SERVE_LAYERS, prompt=VISION_PROMPT,
        new=VISION_NEW, f32=False, prepare=gated, checks=gate_controls,
        tag="vision"))
    phase("vision", arch=VISION_ARCH, path="serve",
          seconds=f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    vision.update(train_phase(dev, VISION_ARCH, VISION_TRAIN_LAYERS,
                              VISION_SEQ, tag="vision", prepare=gated,
                              spread=False))
    phase("vision", arch=VISION_ARCH, path="train",
          seconds=f"{time.perf_counter() - t0:.1f}")
    return whisper, vision


def perturb_ssm_leaves(model, seed=0):
    """Every constant-initialised Mamba2 / RWKV leaf of ``model`` (by name,
    SSM_NOISE) drawn uniform from its range, float32, from numpy's
    generator at ``seed``: at their constant inits (A = -1, u_bonus 0,
    every mix 0.5) a wrong axis or a swapped mix could not show. A
    DTensor leaf (a model on a mesh) takes its slice of the same
    values."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in SSM_NOISE:
                t = torch.from_numpy(rng.uniform(
                    *SSM_NOISE[leaf], tuple(p.shape)).astype(np.float32))
                if isinstance(p, DTensor):
                    t = distribute_tensor(t.to(p.to_local().device),
                                          p.device_mesh, p.placements,
                                          src_data_rank=None)
                p.copy_(t)


def ssm_caches(cache, key):
    """The ``key`` state leaves of every state-space segment of a decode
    cache (zamba2's groups and tail: ``conv`` / ``ssm``; rwkv6: ``wkv``)."""
    for seg, node in cache.items():
        if seg == "len":
            continue
        node = node.get("mambas", node)
        leaf = node["m"].get(key) if "m" in node else node.get(key)
        if leaf is not None:
            yield leaf


def zero_ssm(cache):
    """The control: the SSM states zeroed before decode."""
    for t in ssm_caches(cache, "ssm"):
        t.zero_()


def unshifted_conv(cache):
    """The control: the cached conv inputs [c0, c1, c2, c3] moved one row
    back to [c0, c0, c1, c2], so decode's shift leaves [c0, c1, c2, new],
    the window of a decode that did not shift out the oldest input."""
    for t in ssm_caches(cache, "conv"):
        t[..., 1:, :] = t[..., :-1, :].clone()


def zero_wkv(cache):
    """The control: the WKV states zeroed before decode."""
    for t in ssm_caches(cache, "wkv"):
        t.zero_()


def value_axis_wkv_step(s_prev, r, k, v, w, u):
    """``rwkv6.wkv_step`` with ``u_bonus`` on the value axis m of k^T v
    (the reference scales the key axis n): the RWKV control."""
    import torch
    kv = k[..., :, None] * v[..., None, :]
    out = torch.matmul(r[..., None, :], s_prev + u[..., None, :] * kv)
    return out[..., 0, :], w[..., None] * s_prev + kv


def decode_vs_prefill(model, toks, s, corrupt=None):
    """|last logits of (prefill s tokens, decode token s) - those of a
    prefill of s + 1 tokens|; ``corrupt(cache)`` runs between the prefill
    and the decode."""
    _, cache = model.prefill(toks[:, :s], s + 4)
    if corrupt is not None:
        corrupt(cache)
    inc, _ = model.decode(cache, toks[:, s])
    full, _ = model.prefill(toks[:, :s + 1], s + 4)
    return float((inc - full).abs().max())


def ssm_decode_phase(dev, arch, over, b, s, controls, tag):
    """``arch`` in float32 at ``over`` (perturbed), K5 on the shared
    block's prefill: the O(1) decode state against the chunked scan or
    recurrence (S tokens then one step against S + 1, within
    SSM_DECODE_TOL), and each control (name -> corrupt(cache)) beyond
    it."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.models.lm import LM

    cfg = registry.config(arch, attn_impl="flash", dtype="float32", **over)
    _free()
    t0 = time.perf_counter()
    model = LM(cfg, device=dev, seed=0)
    perturb_ssm_leaves(model)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        1, cfg.vocab, (b, s + 1)), device=dev)
    err = decode_vs_prefill(model, toks, s)
    ctl = {n: decode_vs_prefill(model, toks, s, fn)
           for n, fn in controls.items()}
    phase(tag, arch=arch, check="decode_vs_prefill", dtype="float32",
          n_layers=cfg.n_layers, B=b, s=s, decode_vs_prefill=f"{err:.4e}",
          **{f"control_{n}": f"{v:.4e}" for n, v in ctl.items()},
          tol=SSM_DECODE_TOL, seconds=f"{time.perf_counter() - t0:.1f}")
    check(err <= SSM_DECODE_TOL, f"{arch}: decode after a prefill of {s} "
          f"lies {err} from the prefill of {s + 1}")
    for n, v in ctl.items():
        check(v > SSM_DECODE_TOL, f"{arch}: the control ({n}) lies within "
              f"{SSM_DECODE_TOL}: {v}")
    del model
    _free()


def zamba2_phases(dev):
    """zamba2-7b on the card: served at ZAMBA_LAYERS (K5 at head dim 112
    in the shared block of each group) against the plain path, then in
    float32 at ZAMBA_F32 with the padded-scale control; decode against
    prefill with its state controls; trained at ZAMBA_LAYERS (K5, K6,
    K7). Returns the serving and training launch counts."""
    import numpy as np
    t0 = time.perf_counter()
    lengths = np.random.default_rng(0).integers(
        ZAMBA_PROMPT[0], ZAMBA_PROMPT[1] + 1, SERVE_REQUESTS)
    lengths[::SERVE_SLOTS] = ZAMBA_PROMPT[1]     # each wave's longest
    launches = collections.Counter(serve_phase(
        dev, ZAMBA_ARCH, layers=ZAMBA_LAYERS, lengths=lengths,
        new=ZAMBA_NEW, f32=ZAMBA_F32,
        controls=(("pad_scale", pad_scale_fwd, None, F32_LOGIT_TOL),),
        prepare=perturb_ssm_leaves, tag="zamba2", spread=True,
        profile=("prefill",)))
    ssm_decode_phase(dev, ZAMBA_ARCH, ZAMBA_F32, *ZAMBA_DECODE,
                     {"ssm_zeroed": zero_ssm,
                      "conv_unshifted": unshifted_conv}, "zamba2")
    phase("zamba2", arch=ZAMBA_ARCH, path="serve",
          seconds=f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    # no profiled step: torch.profiler takes a minute over a zamba2 step
    # (60.4 s on an H100, PERF.md); its prefill is profiled above
    launches.update(train_phase(dev, ZAMBA_ARCH, ZAMBA_LAYERS, tag="zamba2",
                                prepare=perturb_ssm_leaves, trace=False,
                                spread=False))
    phase("zamba2", arch=ZAMBA_ARCH, path="train",
          seconds=f"{time.perf_counter() - t0:.1f}")
    return launches


def rwkv_card_phase(dev):
    """rwkv6-1.6b in float32 at RWKV_F32_LAYERS (perturbed): the card's
    prefill and two decode steps against the same weights on the CPU
    (RWKV_CARD_TOL), decode against prefill with the wkv-zeroed control,
    and u_bonus on the value axis, which must move the card's prefill
    beyond RWKV_CARD_TOL of the CPU's."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import rwkv6
    from repro_torch.models.lm import LM

    cfg = registry.config(RWKV_ARCH, dtype="float32",
                          n_layers=RWKV_F32_LAYERS)
    _free()
    t0 = time.perf_counter()
    card = LM(cfg, device=dev, seed=0)
    perturb_ssm_leaves(card)
    cpu = LM(cfg, device="cpu", seed=None)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    s = RWKV_CHECK_S
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (2, s + 2))

    def run(model):
        t = torch.as_tensor(toks, device=model.device)
        logits, cache = model.prefill(t[:, :s], s + 4)
        out = [logits.cpu()]
        for i in range(2):
            logits, cache = model.decode(cache, t[:, s + i])
            out.append(logits.cpu())
        return out
    got, want = run(card), run(cpu)
    err = max_diff(got, want)
    saved = rwkv6.wkv_step
    rwkv6.wkv_step = value_axis_wkv_step
    try:
        moved = run(card)
    finally:
        rwkv6.wkv_step = saved
    ctl_u = max_diff(moved, want)
    t = torch.as_tensor(toks, device=dev)
    inc = decode_vs_prefill(card, t, s)
    ctl_wkv = decode_vs_prefill(card, t, s, zero_wkv)
    phase("rwkv", arch=RWKV_ARCH, check="card_vs_cpu", dtype="float32",
          n_layers=cfg.n_layers, B=2, s=s, decode_steps=2,
          max_abs_logit=f"{max(float(x.abs().max()) for x in want):.4f}",
          card_vs_cpu=f"{err:.4e}", control_u_value_axis=f"{ctl_u:.4e}",
          tol=RWKV_CARD_TOL, decode_vs_prefill=f"{inc:.4e}",
          control_wkv_zeroed=f"{ctl_wkv:.4e}",
          decode_tol=SSM_DECODE_TOL,
          seconds=f"{time.perf_counter() - t0:.1f}")
    check(err <= RWKV_CARD_TOL, f"rwkv card vs CPU: {err}")
    check(ctl_u > RWKV_CARD_TOL, f"the control (u_bonus on the value axis) "
          f"lies within {RWKV_CARD_TOL}: {ctl_u}")
    check(inc <= SSM_DECODE_TOL, f"rwkv decode vs prefill: {inc}")
    check(ctl_wkv > SSM_DECODE_TOL, f"the control (wkv zeroed) lies within "
          f"{SSM_DECODE_TOL}: {ctl_wkv}")
    del card, cpu
    _free()


def rwkv_train_phase(dev):
    """rwkv6-1.6b trained at RWKV_LAYERS (perturbed) for TRAIN_STEPS steps
    of RWKV_TRAIN through launch.train's functions (no kernel on its
    path: every count stays 0); then step 1 in float32 at
    RWKV_F32_LAYERS on RWKV_CPU_STEP's batch, card against CPU on the same
    weights (loss and grad norm within RWKV_CARD_TOL relative). Returns
    the launch counts."""
    import numpy as np

    from repro_torch.launch import train as lt

    t0 = time.perf_counter()
    argv = train_argv(RWKV_ARCH, RWKV_LAYERS, RWKV_TRAIN["seq_len"],
                      RWKV_TRAIN["batch"])
    kern = full_depth_run("kernel", {}, profile=True, arch=RWKV_ARCH,
                          argv=argv, line="rwkv", prepare=perturb_ssm_leaves,
                          trace=False, halves="update")
    for h in kern["hist"]:
        check(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]),
              f"rwkv step {h['step']}: loss {h['loss']} grad_norm "
              f"{h['grad_norm']}")
    check(sum(kern["launches"].values()) == 0, "rwkv training launched a "
          "flash kernel")
    tokens = RWKV_TRAIN["batch"] * (RWKV_TRAIN["seq_len"] - 1)
    phase("rwkv", arch=RWKV_ARCH, n_layers=lt.config(lt.parse(argv)).n_layers,
          params=kern["params"], global_batch=RWKV_TRAIN["batch"],
          seq_len=RWKV_TRAIN["seq_len"], tokens_per_step=tokens,
          steps=TRAIN_STEPS, quantized_state=True,
          init_s=f"{kern['init_s']:.3f}",
          step_s=",".join(f"{h['time_s']:.3f}" for h in kern["hist"]),
          tokens_per_s=f"{tokens / kern['hist'][-1]['time_s']:.1f}",
          grads_s=kern["grads_s"], update_s=f"{kern['update_s']:.3f}",
          max_memory_allocated=kern["peak"],
          launches=json.dumps(kern["launches"], separators=(",", ":")))
    # step 1 in float32 at RWKV_F32_LAYERS, card against CPU
    small = train_argv(RWKV_ARCH, RWKV_F32_LAYERS,
                       RWKV_CPU_STEP["seq_len"], RWKV_CPU_STEP["batch"]) + [
        "--dtype", "float32"]
    card = lt.build(lt.parse(small))
    perturb_ssm_leaves(card.model)
    small[small.index("--device") + 1] = "cpu"
    cpu = lt.build(lt.parse(small))
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               card.model.state_dict().items()})
    hc, hp = lt.train_steps(card, 0, 1)[0], lt.train_steps(cpu, 0, 1)[0]
    cmp = dict(loss_rel=_rel(hc["loss"], hp["loss"]),
               grad_norm_rel=_rel(hc["grad_norm"], hp["grad_norm"]))
    phase("rwkv", arch=RWKV_ARCH, compare="step1_card_vs_cpu",
          dtype="float32", n_layers=RWKV_F32_LAYERS,
          global_batch=RWKV_CPU_STEP["batch"],
          seq_len=RWKV_CPU_STEP["seq_len"], loss=f"{hc['loss']:.6f}",
          grad_norm=f"{hc['grad_norm']:.6f}",
          **{k: f"{v:.3e}" for k, v in cmp.items()}, tol=RWKV_CARD_TOL,
          card_step_s=f"{hc['time_s']:.3f}", cpu_step_s=f"{hp['time_s']:.3f}",
          seconds=f"{time.perf_counter() - t0:.1f}")
    check(all(v <= RWKV_CARD_TOL for v in cmp.values()), f"rwkv step 1, "
          f"card vs CPU: {cmp}")
    del card, cpu
    _free()
    return kern["launches"]


def rwkv_phases(dev):
    """rwkv6-1.6b on the card: served at RWKV_LAYERS of its 24 layers (no
    kernel: every count 0), its float32 checks against the CPU, trained
    at RWKV_LAYERS. Returns the launch counts."""
    from repro_torch.kernels import flash_cuda as fc
    t0 = time.perf_counter()
    launches = collections.Counter(serve_phase(
        dev, RWKV_ARCH, layers=RWKV_LAYERS, prompt=RWKV_PROMPT,
        new=RWKV_NEW, prepare=perturb_ssm_leaves, profile=("decode",),
        tag="rwkv"))
    check(launches[fc.NAME] == 0, "rwkv serving launched K5")
    rwkv_card_phase(dev)
    phase("rwkv", arch=RWKV_ARCH, path="serve",
          seconds=f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    launches.update(rwkv_train_phase(dev))
    phase("rwkv", arch=RWKV_ARCH, path="train",
          seconds=f"{time.perf_counter() - t0:.1f}")
    return launches


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


# --- [dist]: training on a device mesh ------------------------------------------
# llama3-8b at full width (d_model 4096, 32 heads, 8 kv heads, head dim
# 128, d_ff 14336, vocab 128,256), bf16, one 4096-token sequence a rank
# (the model sees 4095), DIST_LAYERS layers: (a) make_train_step and
# make_compressed_dp_step on a one-rank NCCL mesh; (b) two ranks sharing
# the card over gloo: (data=2, model=1) compressed DP. The tensor-parallel
# run (data=1, model=2) is not on the card (dist_two_rank_phase).
DIST_FLAG = "--dist-only"
DIST_ARCH = "llama3-8b"
DIST_LAYERS, DIST_STEPS = 2, 2
DIST_SEQ = 4096
# (a): a world of one adds no reduction; (b): bf16 multi-rank runs sum in
# another order than one process (the bf16 training limit, 1e-2, of the
# one-device slice above)
DIST_ONE_RANK_RTOL, DIST_LOSS_RTOL = 1e-6, 1e-2
DIST_TIMEOUT = 900       # the ranks' join (s)
# the compressed all-reduce's checks run on these reference leaves (each
# the per-block leaves stacked into it): a matrix and a norm gamma
DIST_CHECK_LEAVES = ("dense.attn.wq", "final_ln")
# K5/K6/K7 at one rank's local heads on a (1, 2) mesh, timed beside their
# plain versions and SDPA (``[kernels] case=tp2``; no main path on the
# card runs this shape, so these rows stay out of the kernel table line)
LOCAL_HEADS = "tp2"
K5_CASES.append((LOCAL_HEADS, 1, 16, 4, 4095, 128, "bfloat16", None, 10))
BWD_CASES.append((LOCAL_HEADS, 1, 16, 4, 4095, 128, "bfloat16", None, 5))
# [mesh]'s local-head cases beside tp2, timed only in --mesh-only: tp4,
# one rank's heads of (1, 4) (the kv heads split too); tp2_w4096,
# mixtral-8x7b's on (2, 2) (window 4096, 8191 tokens). Then the
# families' on (2, 2), timed only in --mesh-families (FAMILY_TAGS):
# gemma-7b's 8 of 16 heads at D = 256; zamba2-7b's 16 of 32 at D = 112,
# through ops.flash_attention's pad to 128 (padded_kernel_phase); whisper-
# base's encoder, 4 of 8 heads over 1500 frames, bidirectional
# (BIDIRECTIONAL), 8 rows a data rank; llama-3.2-vision-90b's 32 of 64
# query heads on 4 kv heads (a GQA group of 8)
MESH_K5_CASES = [("tp4", 1, 8, 2, 4095, 128, "bfloat16", None, 10),
                 ("tp2_w4096", 1, 16, 4, 8191, 128, "bfloat16", 4096, 5),
                 ("tp2_d256", 1, 8, 8, 4095, 256, "bfloat16", None, 10),
                 ("tp2_d112", 1, 16, 16, 4095, 112, "bfloat16", None, 10),
                 ("tp2_d64", 8, 4, 4, 1500, 64, "bfloat16", None, 20),
                 ("tp2_vlm", 1, 32, 4, 4095, 128, "bfloat16", None, 10)]
MESH_BWD_CASES = [("tp4", 1, 8, 2, 4095, 128, "bfloat16", None, 5),
                  ("tp2_w4096", 1, 16, 4, 8191, 128, "bfloat16", 4096, 3),
                  ("tp2_d256", 1, 8, 8, 4095, 256, "bfloat16", None, 5),
                  ("tp2_d112", 1, 16, 16, 4095, 112, "bfloat16", None, 5),
                  ("tp2_d64", 8, 4, 4, 1500, 64, "bfloat16", None, 5),
                  ("tp2_vlm", 1, 32, 4, 4095, 128, "bfloat16", None, 5)]
FAMILY_TAGS = ("tp2_d256", "tp2_d112", "tp2_d64", "tp2_vlm")
MESH_TAGS = (LOCAL_HEADS, "tp4", "tp2_w4096") + FAMILY_TAGS
# K7 launched twice at these cases (the training shape, one rank's local
# heads): dk and dv must be equal bit for bit
K7_DETERMINISTIC = ("train",) + MESH_TAGS


def dist_config(dtype="bfloat16", layers=DIST_LAYERS, smoke=False):
    """[dist]'s configuration; with ``smoke`` the SMOKE config (its own
    depth and dtype: the CPU tests' size)."""
    from repro_torch.configs import registry
    if smoke:
        return registry.smoke_config(DIST_ARCH, attn_impl="flash")
    return registry.config(DIST_ARCH, attn_impl="flash", n_layers=layers,
                           dtype=dtype)


def dist_opt():
    from repro_torch.optim import adamw
    return adamw.AdamWConfig(lr=3e-4, warmup_steps=DIST_STEPS,
                             total_steps=DIST_STEPS, quantized_state=True)


def dist_tokens(vocab, rows, step, lo=0, hi=None, seq=DIST_SEQ):
    from repro_torch.data.pipeline import SyntheticLM
    return SyntheticLM(vocab, seq, rows).batch_at(step, lo, hi)


def one_process_steps(dev, cfg, rows, seq=DIST_SEQ):
    """make_train_fn's DIST_STEPS steps on ``rows`` ``seq``-token
    sequences a step, one process, no mesh: the per-step metrics and the
    launch counts."""
    import torch

    from repro_torch.data.pipeline import device_batch
    from repro_torch.kernels import flash_cuda as fc
    from repro_torch.models.lm import LM
    from repro_torch.optim import adamw
    from repro_torch.train import loop as tl
    _free()
    model = LM(cfg, device=dev, seed=0, trainable=True)
    ocfg = dist_opt()
    step = tl.make_train_fn(model, ocfg)
    params = tl.params_of(model)
    state = (params, adamw.init(ocfg, params))
    hist = []
    fc.reset_launches()
    for s in range(DIST_STEPS):
        p, o, m = step(*state, device_batch(
            {"tokens": dist_tokens(cfg.vocab, rows, s, seq=seq)}, dev))
        state = (p, o)
        hist.append({k: float(v) for k, v in m.items()})
    _sync(dev)
    launches = dict(fc.LAUNCHES)
    del model, step, state, params
    _free()
    return hist, launches


def dist_one_rank_phase(dev):
    """(a): make_train_step on a one-rank NCCL mesh against make_train_fn
    on the same card (losses and grad norms to DIST_ONE_RANK_RTOL, the
    same launches), then make_compressed_dp_step, its all-reduce through
    NCCL, held to the one-shard rule: g_hat = dequant(quant(g + err)) bit
    for bit. Returns the launch counts of both mesh runs."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.kernels import flash_cuda as fc
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    from repro_torch.optim import adamw, compress
    from repro_torch.train import loop as tl

    cfg = dist_config()
    want, want_launches = one_process_steps(dev, cfg, 1)
    mesh = make_host_mesh()
    try:
        check(dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1),
              f"one-rank mesh {dist.get_backend()} {tuple(mesh.shape)}")
        model = LM(cfg, device=dev, seed=0, trainable=True)
        ocfg = dist_opt()
        step, shardings = tl.make_train_step(model, ocfg, mesh)
        params = tl.params_of(model)
        state = shardings(params).distribute(
            {"opt_state": adamw.init(ocfg, params)})
        torch.cuda.reset_peak_memory_stats()
        # the main path: counts set to 0 just before, read just after
        fc.reset_launches()
        for s in range(DIST_STEPS):
            t0 = time.perf_counter()
            p, o, m = step(state["params"], state["opt_state"],
                           make_global_batch(mesh, {"tokens": dist_tokens(
                               cfg.vocab, 1, s)}))
            state = {"params": p, "opt_state": o}
            m = {k: float(v) for k, v in m.items()}
            loss_rel = _rel(m["loss"], want[s]["loss"])
            gn_rel = _rel(m["grad_norm"], want[s]["grad_norm"])
            phase("dist", run="one_rank_nccl", mesh="1x1", step=s,
                  loss=f"{m['loss']:.6f}", loss_rel=f"{loss_rel:.3e}",
                  grad_norm_rel=f"{gn_rel:.3e}",
                  step_s=f"{time.perf_counter() - t0:.3f}")
            check(loss_rel <= DIST_ONE_RANK_RTOL
                  and gn_rel <= DIST_ONE_RANK_RTOL,
                  f"one-rank mesh step {s}: loss {loss_rel}, grad norm "
                  f"{gn_rel} from the one-device step")
        launches = collections.Counter(fc.LAUNCHES)
        check(dict(launches) == want_launches and all(launches.values()),
              f"one-rank mesh launches {dict(launches)}, one device "
              f"{want_launches}")
        peak = torch.cuda.max_memory_allocated()
        del model, step, state, params, p, o
        _free()
        # the compressed step, its all-reduce through NCCL
        model = LM(cfg, device=dev, seed=0, trainable=True)
        params = tl.params_of(model)
        batch = make_global_batch(mesh, {"tokens": dist_tokens(cfg.vocab, 1,
                                                              0)})
        _, _, grads = tl._grads(model, {k: v.to_local()
                                        for k, v in batch.items()})
        err = compress.init_error(params)
        g_hat, new_err = compress.tree_compressed_psum(grads, err,
                                                       (mesh, "data"))
        bad = [n for n, g in grads.items()
               if not torch.equal(g_hat[n], compress._quantize(
                   g.float() + err[n])[2].to(g.dtype))]
        check(not bad, f"one-shard g_hat differs from dequant(quant(g + "
              f"err)) at {bad[:3]}")
        del grads, g_hat, new_err
        cstep = tl.make_compressed_dp_step(model, ocfg, mesh)
        fc.reset_launches()
        out = cstep(params, adamw.init(ocfg, params), err, batch)
        torch.cuda.synchronize()
        claunch, cm = dict(fc.LAUNCHES), out[3]
        del out
        check(_rel(float(cm["loss"]), want[0]["loss"]) <= DIST_ONE_RANK_RTOL,
              f"one-rank compressed step's loss {float(cm['loss'])} vs "
              f"{want[0]['loss']}")
        phase("dist", run="one_rank_nccl", mesh="1x1",
              train_step_launches=json.dumps(dict(launches),
                                             separators=(",", ":")),
              compressed_launches=json.dumps(claunch, separators=(",", ":")),
              one_shard_rule="bitwise", payload_bytes=cstep.stats[
                  "payload_bytes"], dense_bytes=cstep.stats["dense_bytes"],
              peak_gb=f"{peak / 2 ** 30:.2f}")
        launches.update(claunch)
        del model, cstep, params, err
    finally:
        dist.destroy_process_group()
        _free()
    return launches


def _dist_dp(rank, dev, cfg, seq=DIST_SEQ, profile=False, params_out=False):
    """(data=world, model=1) compressed DP on this rank (on ``dev``, one
    ``seq``-token row a rank): per-step metrics, the all-reduce's bytes
    and time, the checks' inputs on DIST_CHECK_LEAVES (gathered from
    every rank) and the launches; with ``profile``, one more step under
    torch.profiler (its NCCL kernels' device time); with ``params_out``,
    the parameters after the first step and after the last as the
    reference's numpy trees."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import local_rows, make_global_batch
    from repro_torch.kernels import flash_cuda as fc
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    from repro_torch.optim import adamw, compress
    from repro_torch.train import loop as tl

    mesh = make_host_mesh(1, device=dev.type)
    world = dist.get_world_size()
    model = LM(cfg, device=dev, seed=0, trainable=True)
    ocfg = dist_opt()
    groups = {k: v for k, v in model.reference_leaves().items()
              if k in DIST_CHECK_LEAVES}
    watched = [n for g in groups.values() for n in g]
    step = tl.make_compressed_dp_step(model, ocfg, mesh)
    params = tl.params_of(model)
    state = (params, adamw.init(ocfg, params), compress.init_error(params))
    rec = []
    orig = compress.tree_compressed_psum

    def timed(grads, errs, group, **kw):
        _sync(dev)
        t0 = time.perf_counter()
        g_hat, new_err = orig(grads, errs, group, **kw)
        _sync(dev)
        rec.append({"s": time.perf_counter() - t0,
                    "dtype": {k: grads[names[0]].dtype
                              for k, names in groups.items()},
                    "g": {n: grads[n].float().clone() for n in watched},
                    "err_in": {n: errs[n].clone() for n in watched},
                    "err_out": {n: new_err[n].clone() for n in watched},
                    "g_hat": {n: g_hat[n].float().clone() for n in watched}})
        return g_hat, new_err

    def batch_at(s):
        return make_global_batch(mesh, {"tokens": dist_tokens(
            cfg.vocab, world, s, lo, hi, seq=seq)}, global_batch=world)

    lo, hi = local_rows(mesh, world)
    hist, tree1 = [], None
    compress.tree_compressed_psum = timed
    _reset_peak(dev)
    try:
        fc.reset_launches()
        for s in range(DIST_STEPS):
            t0 = time.perf_counter()
            p, o, e, m = step(*state, batch_at(s))
            state = (p, o, e)
            m = {k: float(v) for k, v in m.items()}
            if params_out and s == 0:
                from repro_torch.convert import lm_params_to_numpy
                tree1 = lm_params_to_numpy(model)
            hist.append(dict(m, step_s=time.perf_counter() - t0,
                             allreduce_s=rec[-1]["s"], **step.stats))
        launches = dict(fc.LAUNCHES)
    finally:
        compress.tree_compressed_psum = orig
    peak = _peak(dev)
    tree = None
    if params_out:
        from repro_torch.convert import lm_params_to_numpy
        tree = lm_params_to_numpy(model)
    split = (device_ms(lambda: step(*state, batch_at(DIST_STEPS)))
             if profile else None)
    del model, state, params, p, o, e, step
    _free()
    # the checks: the int32 sums and g_hat against the plain formula on
    # every rank's inputs (gathered; gloo's over host copies), error
    # feedback's running sum
    host = dist.get_backend() == "gloo"
    checks = {}
    for s, r in enumerate(rec):
        for key, names in groups.items():
            x = torch.cat([(r["g"][n] + r["err_in"][n]).reshape(-1)
                           for n in names])
            x = x.cpu() if host else x
            xs = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(xs, x)
            qs = [compress._quantize(t.to(dev)) for t in xs]
            qsum = sum(q.to(torch.int32) for q, _, _ in qs)
            mine = qs[rank][0].to(torch.int32)
            dist.all_reduce(mine)
            ssum = qs[0][1]
            for _, sc, _ in qs[1:]:
                ssum = ssum + sc
            # g_hat in the gradient's dtype, as the step hands it on
            plain = ((qsum.float() * (ssum / world)[:, None]).reshape(-1)[
                :x.numel()] / world).to(r["dtype"][key]).float()
            got = torch.cat([r["g_hat"][n].reshape(-1) for n in names])
            ulp = torch.nextafter(plain.abs(), torch.full_like(
                plain, float("inf"))) - plain.abs()
            checks[f"{key}@{s}"] = (bool(torch.equal(mine, qsum)),
                                    float(((got - plain).abs()
                                           / ulp).max()))
    # error feedback: sum over the steps of what was sent plus the last
    # residual equals the sum of the gradients; the control drops the
    # residual each step (err zeroed), on the same gradients
    ef = {}
    for key, names in groups.items():
        g_sum = sum(torch.cat([r["g"][n].reshape(-1) for n in names])
                    for r in rec)
        tol = 1e-5 * float(g_sum.abs().max())
        sent = sum(compress._quantize(torch.cat(
            [(r["g"][n] + r["err_in"][n]).reshape(-1) for n in names]))[2]
            for r in rec)
        last = torch.cat([rec[-1]["err_out"][n].reshape(-1) for n in names])
        kept = float((sent + last - g_sum).abs().max())
        sent0 = sum(compress._quantize(torch.cat(
            [r["g"][n].reshape(-1) for n in names]))[2] for r in rec)
        g_last = torch.cat([rec[-1]["g"][n].reshape(-1) for n in names])
        last0 = g_last - compress._quantize(g_last)[2]
        dropped = float((sent0 + last0 - g_sum).abs().max())
        ef[key] = (kept, dropped, tol)
    return {"hist": hist, "launches": launches, "peak": peak,
            "checks": checks, "ef": ef, "split": split, "params": tree,
            "params1": tree1}


def _dist_rank(rank, world, init_file):
    """One of the two ranks of (b): gloo over CUDA tensors, both on card
    0."""
    import os

    import torch

    from repro_torch.launch import ranks
    # two processes share the card's 80 GB: segments that grow in place
    # keep what one frees usable for the next leaf's buffers
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    ranks.init(rank, world, init_file, backend="gloo", threads=None)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return {"dp": _dist_dp(rank, torch.device("cuda", 0), dist_config())}


def dp_report(tag, res, whole, mesh_name):
    """Print and check each rank's compressed DP run (``_dist_dp``'s
    results ``res``) against ``whole``, the one-process steps on every
    rank's rows: the losses within DIST_LOSS_RTOL, the int32 sums exact,
    g_hat within one ulp of the plain formula, error feedback's running
    sum within its limit and the control that drops the residual beyond
    it."""
    for r, dp in enumerate(res):
        for s, h in enumerate(dp["hist"]):
            rel = _rel(h["loss"], whole[s]["loss"])
            phase(tag, run="dp_compressed", mesh=mesh_name, rank=r, step=s,
                  loss=f"{h['loss']:.6f}", loss_rel_vs_one_process=f"{rel:.3e}",
                  step_s=f"{h['step_s']:.3f}",
                  allreduce_s=f"{h['allreduce_s']:.3f}",
                  payload_bytes=h["payload_bytes"],
                  dense_f32_bytes=h["dense_bytes"],
                  peak_gb=f"{dp['peak'] / 2 ** 30:.2f}",
                  launches=json.dumps(dp["launches"], separators=(",", ":")))
            check(rel <= DIST_LOSS_RTOL, f"DP rank {r} step {s}: loss {rel} "
                  f"from the one-process step on the whole batch")
        for key, (exact, ulps) in dp["checks"].items():
            check(exact and ulps <= 1.0, f"DP rank {r} {key}: int32 sums "
                  f"exact {exact}, g_hat {ulps} ulp from the plain formula")
        for key, (kept, dropped, tol) in dp["ef"].items():
            check(kept <= tol < dropped, f"DP rank {r} {key}: error feedback "
                  f"sum err {kept}, control {dropped}, limit {tol}")
        phase(tag, run="dp_compressed", rank=r, checks=",".join(
            f"{k}:int32_exact={e}:g_hat_ulps={u:.1f}"
            for k, (e, u) in dp["checks"].items()),
              error_feedback=",".join(f"{k}:{a:.2e}<={t:.2e}<{b:.2e}"
                                      for k, (a, b, t) in dp["ef"].items()))


def dist_two_rank_phase(dev):
    """(b): two ranks sharing the card over gloo (DIST_TIMEOUT), then the
    one-process steps they are held to. Returns the DP run's launches
    (rank 0). The tensor-parallel run is not here: DTensor's functional
    all-reduce over gloo on CUDA tensors ended both ranks with a
    segmentation fault at its first redistribute (PERF.md §7); the CPU
    tests hold the (1, 2) and (1, 4) meshes."""
    from repro_torch.launch import ranks
    _free()         # the ranks share the card with this process
    init = ROOT / "build" / "dist_rdzv"
    init.parent.mkdir(exist_ok=True)
    init.unlink(missing_ok=True)
    t0 = time.perf_counter()
    res = ranks.run_ranks(_dist_rank, 2, str(init), timeout=DIST_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    init.unlink(missing_ok=True)
    whole, _ = one_process_steps(dev, dist_config(), 2)
    dp_report("dist", [out["dp"] for out in res], whole, "2x1")
    phase("dist", ranks_seconds=f"{ranks_s:.1f}")
    return collections.Counter(res[0]["dp"]["launches"])


def dist_phases(dev):
    """[dist]: (a) then (b). Returns their launches (rank 0's in (b))."""
    t0 = time.perf_counter()
    launches = dist_one_rank_phase(dev)
    launches.update(dist_two_rank_phase(dev))
    phase("dist", seconds=f"{time.perf_counter() - t0:.1f}")
    return launches


DRYRUN_FLAG = "--dryrun-only"
DRYRUN_ARCH = "llama3-8b"
DRYRUN_CELLS = ("train_4k", "decode_32k")
DRYRUN_TIMEOUT = 900     # (a)'s processes (s)
DEVICE_BYTES = 80e9      # the H100's memory, the cells' peak limit
DRYRUN_REPS = 3          # (b): timed steps after a warm-up, median
PEAK_RATIO = (0.5, 2.0)  # (b): predicted / measured peak


@contextlib.contextmanager
def dryrun_cells(out_dir):
    """(a)'s processes (``dryrun_cells_start``), killed on the way out if
    they still run."""
    procs = dryrun_cells_start(out_dir)
    try:
        yield procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def dryrun_cells_start(out_dir):
    """(a): one ``launch.dryrun`` process per DRYRUN_CELLS cell, started
    together, on the CPU (the card hidden from them): each makes its own
    fake 256-rank process group."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = []
    for shape in DRYRUN_CELLS:
        # output to a file: a pipe nobody reads until the end would fill
        with open(Path(out_dir) / f"{shape}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", DRYRUN_ARCH, "--shape", shape, "--mesh",
                 "single", "--out", str(out_dir)], env=env, cwd=str(ROOT),
                stdout=log, stderr=subprocess.STDOUT))
    return procs


def dryrun_cells_finish(procs, out_dir, t_start):
    """(a)'s records, once both processes end: each ``ok``, its peak per
    device within DEVICE_BYTES."""
    recs = []
    for p, shape in zip(procs, DRYRUN_CELLS):
        left = max(DRYRUN_TIMEOUT - (time.perf_counter() - t_start), 1)
        p.wait(timeout=left)
        out = (Path(out_dir) / f"{shape}.log").read_text()
        check(p.returncode == 0, f"dry run {shape} exited {p.returncode}: "
              f"{out[-2000:]}")
    for shape in DRYRUN_CELLS:
        path = Path(out_dir) / f"{DRYRUN_ARCH}__{shape}__single.json"
        rec = json.loads(path.read_text())
        check(rec["ok"], f"dry run {shape}: {rec.get('error')}")
        r, mem = rec["roofline"], rec["memory"]
        phase("dryrun", cell=f"{DRYRUN_ARCH}/{shape}", mesh="16x16",
              chips=rec["chips"], trace_s=rec["trace_s"],
              flops_per_dev=f"{rec['cost']['flops_per_dev']:.6e}",
              bytes_per_dev=f"{rec['cost']['bytes_per_dev']:.6e}",
              collective_bytes_per_dev=(
                  f"{rec['collectives']['total_bytes']:.6e}"),
              compute_s=f"{r['compute_s']:.6e}",
              memory_s=f"{r['memory_s']:.6e}",
              collective_s=f"{r['collective_s']:.6e}",
              dominant=r["dominant"], peak_bytes=mem["peak_bytes"],
              argument_bytes=mem["argument_bytes"],
              useful_flops_frac=f"{rec['useful_flops_frac']:.4f}",
              derived="counts_not_measured")
        check(mem["peak_bytes"] <= DEVICE_BYTES,
              f"dry run {shape}: peak {mem['peak_bytes']} bytes a device")
        recs.append(rec)
    return recs


def dryrun_step_phase(dev):
    """(b): [dist]'s step (llama3-8b, full width, DIST_LAYERS layers,
    bf16, int8 moments, one DIST_SEQ-token sequence), einsum attention,
    world of one: counted on meta, then on the card; the counts must
    equal exactly, the argument bytes equal the real tensors', the
    measured step lie at or above max(compute_s, memory_s), the
    predicted peak within PEAK_RATIO of the card's."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun, op_analysis, specs
    cfg = registry.config(DIST_ARCH, n_layers=DIST_LAYERS)
    cell = specs.Cell(DIST_ARCH, "train_4k", DIST_SEQ, 1, "train")
    plan = dryrun.Plan(quantized=True)

    def count(device):
        fn, args, _, _ = dryrun.build_cell(DIST_ARCH, "train_4k", None,
                                           plan, cfg=cfg, cell=cell,
                                           device=device, seed=0)
        return fn, args

    fn, args = count(torch.device("meta"))
    meta, out, meta_s = dryrun.count_cell(fn, args)
    mem = meta.memory(out)
    roof = dryrun.roofline(*(meta.analyze()[k] for k in (
        "flops_per_dev", "bytes_per_dev", "collective_bytes_per_dev")))
    del fn, args, out
    _free()
    fn, args = count(dev)
    real = sum(t.numel() * t.element_size()
               for t in op_analysis.local_tensors(args))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    card, out, card_s = dryrun.count_cell(fn, args, device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    mine = {k: getattr(card.cost, k) for k in ("flops", "eflops", "bytes",
                                               "coll_bytes")}
    want = {k: getattr(meta.cost, k) for k in mine}
    check(mine == want and card.n_ops == meta.n_ops,
          f"card counts {mine} ({card.n_ops} ops) differ from meta's {want} "
          f"({meta.n_ops} ops)")
    check(card.argument_bytes == mem["argument_bytes"] == real,
          f"argument bytes: card {card.argument_bytes}, meta "
          f"{mem['argument_bytes']}, tensors {real}")
    times = []
    for i in range(DRYRUN_REPS + 1):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        fn(*args)
        t1.record()
        torch.cuda.synchronize()
        if i:
            times.append(t0.elapsed_time(t1) / 1e3)
    step = sorted(times)[len(times) // 2]
    bound = max(roof["compute_s"], roof["memory_s"])
    ratio = mem["peak_bytes"] / peak
    phase("dryrun", step=f"{DIST_ARCH}/{DIST_LAYERS}_layers",
          tokens=DIST_SEQ, flops=f"{meta.cost.flops + meta.cost.eflops:.6e}",
          matmul_flops=f"{meta.cost.flops:.6e}",
          bytes=f"{meta.cost.bytes:.6e}", ops=meta.n_ops,
          counts="meta_equals_card", argument_bytes=real,
          compute_s=f"{roof['compute_s']:.6e}",
          memory_s=f"{roof['memory_s']:.6e}", bound_s=f"{bound:.6e}",
          step_s=f"{step:.6f}", steps_s=",".join(f"{t:.6f}" for t in times),
          bound_over_step=f"{bound / step:.4f}",
          predicted_peak=mem["peak_bytes"], max_memory_allocated=peak,
          peak_ratio=f"{ratio:.4f}", meta_count_s=f"{meta_s:.1f}",
          card_count_s=f"{card_s:.1f}")
    check(step >= bound, f"measured step {step} s below its roofline bound "
          f"{bound} s: a miscount")
    check(PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1],
          f"predicted peak {mem['peak_bytes']} vs max_memory_allocated "
          f"{peak}: ratio {ratio}")
    del fn, args
    _free()


def dryrun_fleet_phase(recs):
    """(c): (a)'s records as jobs (``fleet.load_jobs``) placed under
    every scheme on a fleet of L4, A100 and H100 slices; then the first
    job's slice degraded and the job re-placed (``replace_slice``): it
    must leave that slice."""
    from repro_torch.launch import fleet
    with tempfile.TemporaryDirectory() as d:
        for rec in recs:
            (Path(d) / f"{rec['arch']}__{rec['shape']}__single.json"
             ).write_text(json.dumps(rec))
        jobs = fleet.load_jobs(d)
    check(len(jobs) == len(recs), f"{len(jobs)} jobs from {len(recs)} "
          f"records")

    def gpus():
        return [fleet.Slice("l4-0", 256, 256, "l4"),
                fleet.Slice("a100-0", 256, 256, "a100"),
                fleet.Slice("h100-0", 256, 256, "h100"),
                fleet.Slice("h100-1", 256, 256, "h100")]

    for scheme in fleet.FLEET_SCHEMES:
        slices = gpus()
        placed = fleet.schedule_queue(jobs, slices, scheme)
        phase("dryrun", fleet_scheme=scheme, placements=",".join(
            f"{j.shape}->{slices[i].name if i is not None else None}"
            for j, i in placed))
        check(all(i is not None for _, i in placed),
              f"{scheme}: a job found no slice")
    slices = gpus()
    job = jobs[0]
    cur, _ = fleet.place(job, slices)
    new = fleet.replace_slice(job, slices, cur)
    phase("dryrun", straggler=f"{job.arch}/{job.shape}",
          degraded=slices[cur].name, health=slices[cur].health,
          replaced_to=slices[new].name if new is not None else None)
    check(new is not None and new != cur,
          f"replace_slice kept the job on the degraded {slices[cur].name}")


def dryrun_phases(dev, procs, out_dir, t_start):
    """[dryrun]: (b) on the card, then (a)'s records, then (c)."""
    t0 = time.perf_counter()
    dryrun_step_phase(dev)
    recs = dryrun_cells_finish(procs, out_dir, t_start)
    dryrun_fleet_phase(recs)
    phase("dryrun", seconds=f"{time.perf_counter() - t0:.1f}",
          cells_wall_s=f"{time.perf_counter() - t_start:.1f}")


# --- [mesh]: training on four cards, one NCCL rank a card --------------------
MESH_FLAG = "--mesh-only"
MESH_COUNT_FLAG = "--mesh-count"         # [mesh]'s meta count (a CPU child)
MESH_WORLD = 4
MESH_ARCH = "llama3-8b"
# (a) on (2, 2) and (b) on (1, 4): llama3-8b whole, MESH_BATCH sequences
# of MESH_SEQ tokens a step (one a data rank at (2, 2)), TRAIN_STEPS steps
MESH_TP = {"a": (2, 2), "b": (1, 4)}
MESH_SEQ, MESH_BATCH = 4096, 2
# (d): (a) at MESH_SHORT layers and MESH_ELASTIC_BATCH sequences (a row a
# rank at (4, 1)), saved at (2, 2) after step 2, restored at MESH_RESTORE;
# the count: one (2, 2) step of (a) at MESH_SHORT layers
MESH_SHORT, MESH_ELASTIC_BATCH = 2, 4
MESH_RESTORE = ((1, 4), (4, 1))
# (e): mixtral-8x7b at [moe]'s 4 of 32 layers, one sequence of twice
# MESH_SEQ tokens (8192) a data rank on (2, 2)
MESH_MOE_LAYERS = 4
MESH_MOE_HELD = 2        # (e)'s steps held to one process (mesh_phases)
MESH_TIMEOUT = 900       # the ranks' join (s)
MESH_PEAK = 80e9         # a card's memory: each rank's peak below it
# --mesh-families: (f)-(i), every remaining dense, cross-attention and
# state-space family at full width on FAMILY_LAYOUT under its plan
# (launch.dryrun.PLANS: n_micro, fsdp, int8 moments), TRAIN_STEPS steps
# of ``batch`` sequences of ``seq`` tokens at ``layers`` (None: all; the
# depth one card trains). Each is held to one process on card 0 at
# ``held`` layers, the depth at which one card holds the plan (a second
# mesh run at that depth where it differs): free-running (``free``), its
# steps before MESH_MOE_HELD within DIST_LOSS_RTOL; and, as (e), the step
# after MESH_MOE_HELD taken by one process at the mesh's saved weights
# within TRAIN_LOSS_RTOL. Where one card cannot step the plan at all
# (``free`` off: 1 group of llama-3.2-vision-90b is 7.2e9 parameters,
# whose int8 moments and float32 accumulator with its bf16 weights and
# gradients pass 80 GB), the first step too is held at the same weights
# (the seeded ones), by one process's loss and gradient norm alone (each
# within TRAIN_LOSS_RTOL and TRAIN_GNORM_RTOL). ``tag``: the local-head
# kernel case the run's attention takes.
FAMILY_FLAG = "--mesh-families"
FAMILY_LAYOUT = (2, 2)
GEMMA_MESH_HELD = 4      # gemma-7b: float32 moments and accumulator
ZAMBA_MESH_HELD = ZAMBA_LAYERS
FAMILIES = {
    "f": dict(arch=GEMMA_ARCH, layers=None, seq=4096, batch=4,
              held=GEMMA_MESH_HELD, free=True, tag="tp2_d256"),
    "g": dict(arch=ZAMBA_ARCH, layers=ZAMBA_LAYERS, seq=4096, batch=4,
              held=ZAMBA_MESH_HELD, free=True, tag="tp2_d112"),
    "h": dict(arch=WHISPER_ARCH, layers=None, seq=WHISPER_TRAIN["seq_len"],
              batch=WHISPER_TRAIN["batch"], held=None, free=True,
              tag="tp2_d64"),
    "i": dict(arch=VISION_ARCH, layers=VISION_TRAIN_LAYERS, seq=VISION_SEQ,
              batch=16, held=VISION_TRAIN_LAYERS, free=False,
              tag="tp2_vlm"),
}
# zamba2's profiled step records the card's activity only: recording the
# host's ops too takes a minute a step on one card (zamba2_phases)
FAMILY_DEVICE_ONLY_PROFILE = (ZAMBA_ARCH,)
# (j): (a)'s model at MESH_SHORT layers on FAMILY_LAYOUT, the reference
# CLI's n_micro (2) and int8 moments, SUP_BATCH sequences a step, under
# fault.Supervisor (``shardings=``, a checkpoint every SUP_EVERY steps)
# with a fault at step SUP_FAULT on every rank: its history's steps must
# be SUP_HISTORY and its final state an uninterrupted run's bit for bit
SUP_STEPS, SUP_EVERY, SUP_FAULT, SUP_BATCH = 5, 2, 3, 4
SUP_HISTORY = [0, 1, 2, 2, 3, 4]
FAMILY_PHASES = ("f", "g", "h", "i", "j")
# --mesh-remaining: the last three registry architectures at full width on
# FAMILY_LAYOUT, as --mesh-families runs its families (``_mesh_family``,
# ``family_one_process``, ``family_report``), TRAIN_STEPS steps each.
# (m) deepseek-v3-671b at [moe]'s 4 layers (3 mla_dense + 1 mla_moe)
# under its optimised plan (launch.dryrun.OPT_PLANS: its 256 experts 64 a
# card over ("data", "model"), the slot rows re-sharded over those axes,
# a bf16 accumulator, int8 moments, n_micro 8; ``opt``), 16 sequences of
# 4096 tokens: two rows a microbatch, dispatched in one group a data rank
# (``rules.batch_groups``). One card cannot step it (15.11e9 parameters:
# bf16 weights and a float32 accumulator pass 80 GB), so it is held as
# (i) is (``free`` off), by one process's loss and gradient norm at the
# seeded weights (step 0) and at the mesh's saved ones (after
# MESH_MOE_HELD steps) with the plan's own bf16 accumulator, one row a
# microbatch in a group of its own (as each data rank's backward takes
# its row of a microbatch and dispatches it; ``one_row_routes``) with
# the load-balancing loss of the row's whole microbatch (``pair_aux``:
# the mesh routes the microbatch whole), following the mesh's expert
# choices (each difference a near-tie, ROUTE_TIE_TOL). At the seeded
# weights GNORM_FAULTS are planted in the
# one process's accumulated gradient: the one that must fail
# TRAIN_GNORM_RTOL is rejected, the other's move is reported. MLA stays
# on ``_sdpa``: K5-K7 launch 0 times. The count counts one (2, 2) step of
# it (``moe_train``).
# (n) deepseek-coder-33b at CODER_LAYERS of 62 (the guide's depth for a
# card: ~3.4e9 parameters, ~48 GB before activations; 16 layers ~63 GB),
# 8 sequences a step under PLANS (n_micro 4, float32 moments): its 56
# query heads on 8 kv heads give each rank 28 on 4 (a GQA group of 7,
# ``tp2_g7``). (o) minitron-8b whole (32 layers; llama3-8b's attention,
# ``tp2``, and a 256,000-token vocabulary), 4 sequences, n_micro 2. Both
# are held to one process at REMAIN_HELD layers free-running, as (f).
REMAIN_FLAG = "--mesh-remaining"
CODER_ARCH, MINITRON_ARCH = "deepseek-coder-33b", "minitron-8b"
CODER_LAYERS, REMAIN_HELD = 12, 4
FAMILIES.update(
    m=dict(arch=DEEPSEEK_ARCH, layers=MESH_MOE_LAYERS, seq=4096, batch=16,
           held=MESH_MOE_LAYERS, free=False, tag=None, opt=True),
    n=dict(arch=CODER_ARCH, layers=CODER_LAYERS, seq=4096, batch=8,
           held=REMAIN_HELD, free=True, tag="tp2_g7"),
    o=dict(arch=MINITRON_ARCH, layers=None, seq=4096, batch=4,
           held=REMAIN_HELD, free=True, tag=LOCAL_HEADS))
FAMILY_DEVICE_ONLY_PROFILE += (DEEPSEEK_ARCH, CODER_ARCH, MINITRON_ARCH)
# (m)'s planted faults, each (name, the leaves and rows it takes, scale,
# whether the gradient-norm check must reject it): every leaf's gradient
# 2.5e-3 off, which a limit of 3e-3 (the two-row control's, PR 30) would
# pass; and rank 0's routed experts (the first quarter of each expert
# leaf's rows) 1e-2 off, reported only (its move is a fraction of the
# experts' share of the gradient norm). A gradient fault leaves the loss
# as it is: the loss check passes under both.
GNORM_FAULTS = (("all_leaves_2.5e-3", None, 1 + 2.5e-3, True),
                ("rank0_experts_1e-2", "moe.w", 1 + 1e-2, False))
REMAIN_PHASES = ("m", "n", "o", "count")
# the local-head case new to this mode; each rank also checks ``tp2``
# (minitron-8b's); the planted control reads kv head h // WRONG_GROUP
REMAIN_TAGS = ("tp2_g7",)
REMAIN_KERNEL_TAGS = (LOCAL_HEADS,) + REMAIN_TAGS
WRONG_GROUP = 8
MESH_K5_CASES.append(("tp2_g7", 1, 28, 4, 4095, 128, "bfloat16", None, 10))
MESH_BWD_CASES.append(("tp2_g7", 1, 28, 4, 4095, 128, "bfloat16", None, 5))
K7_DETERMINISTIC += REMAIN_TAGS
REMAIN_TIMEOUT = 1000    # the ranks' join (s)


def mesh_spec(device="cuda", smoke=False, ckpt=None, **over):
    """What the ranks of [mesh] run (a picklable dict): the device
    (``"cuda"``: a card a rank, NCCL, each checking the local-head kernels
    on its card; ``"cpu"``: gloo, the tests' SMOKE run), the SMOKE configs
    or the published ones, the checkpoint directory of (d), the sequence
    length (``seq``; (c)'s too, (e)'s twice it), (a)'s and (b)'s depth
    (``layers``, None for all), the phases in order, and whether each
    rank profiles a step and returns its parameters; the local-head
    kernel cases each card checks first (``kernel_tags``); the program
    the count counts (``count``: ``"train"``, a training step; ``"decode"``,
    a decode step, ``mesh_count_cell``)."""
    spec = dict(device=device, smoke=smoke, ckpt=ckpt, seq=MESH_SEQ,
                layers=None, phases=("a", "b", "c", "d", "e", "count"),
                profile=device == "cuda", params_out=False,
                kernel_tags=MESH_TAGS[:3], count="train")
    spec.update(over)
    return spec


def mesh_argv(spec, arch, layers, seq, batch, layout=None, plan=None):
    """launch.train's arguments for a [mesh] run (the spec's device;
    ``--model-axis`` of ``layout`` on the mesh): n_micro 1 and int8
    moments, or ``plan``'s n_micro and moments (a ``launch.dryrun.Plan``,
    which ``build`` takes whole; the one-process runs, which take no plan
    but (m)'s, read these)."""
    argv = train_argv(arch, layers, seq, batch)
    if plan is not None:
        argv[argv.index("--n-micro") + 1] = str(plan.n_micro)
    if plan is None or plan.quantized:
        argv.append("--quantized-state")
    argv[argv.index("--device") + 1] = spec["device"]
    if spec["smoke"]:
        argv.append("--smoke")
    if layout is not None:
        argv += ["--model-axis", str(layout[1])]
    return argv


def local_head_checks(dev, tags):
    """K5, K6 and K7 at the local-head cases ``tags`` on this rank's card
    against their plain versions (``k5_agreement``, ``grad_agreement``),
    each with its case's mask (BIDIRECTIONAL: ``causal=False``), and K7's
    dk and dv over two launches bit for bit. A head dim no kernel is built
    for (zamba2's 112) runs the kernels on inputs zero-padded to the next
    one, as ``ops.flash_attention`` pads them, and is also held through
    that wrapper (forward, and its backward under autograd) against the
    plain versions at the model's D. Per case (K5 passes, K5 max err,
    K6/K7 pass, their max err, K7 bitwise)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_cuda as fc
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for tag, b, h, hkv, s, d, dname, window, _ in (
            [c for c in K5_CASES + MESH_K5_CASES if c[0] in tags]):
        q, k, v = _attention_case(dev, gen, b, h, hkv, s, d,
                                  getattr(torch, dname))
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        causal = tag not in BIDIRECTIONAL
        kw = dict(sm_scale=d ** -0.5, causal=causal, window=window)
        dp = ops.padded_head_dim(d)
        qp, kp, vp, dop = ((F.pad(t, (0, dp - d)).contiguous()
                            for t in (q, k, v, do)) if dp != d
                           else (q, k, v, do))
        o, lse = fc.flash_fwd(qp, kp, vp, **kw)
        o = o[..., :d].contiguous() if dp != d else o
        pout, plse = fc.flash_fwd_plain(q, k, v, **kw)
        ok5, err, err_lse, _ = k5_agreement(o, lse, pout, plse)
        dd = torch.sum(do.float() * o.float(), dim=-1)
        got = (fc.flash_bwd_dq(qp, kp, vp, dop, lse, dd, **kw),
               *fc.flash_bwd_dkv(qp, kp, vp, dop, lse, dd, **kw))
        want = fc.flash_bwd_plain(q, k, v, o, lse, do, **kw)
        res = [grad_agreement(g[..., :d].contiguous(), w)
               for g, w in zip(got, want)]
        if dp != d:
            wo = ops.flash_attention(q, k, v, causal=causal, window=window)
            w_ok, w_err, _ = agreement(wo, pout)
            ok5, err = ok5 and w_ok, max(err, w_err)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            res += [grad_agreement(g, w) for g, w in zip(torch.autograd.grad(
                ops.flash_attention(*leaves, causal=causal, window=window),
                leaves, do), want)]
            del wo, leaves
        again = fc.flash_bwd_dkv(qp, kp, vp, dop, lse, dd, **kw)
        _sync(dev)
        out[tag] = (ok5, max(err, err_lse), all(r[0] for r in res),
                    max(r[1] for r in res),
                    all(torch.equal(a, g) for a, g in zip(again, got[1:])))
        del q, k, v, do, qp, kp, vp, dop, o, lse, dd, got, again
        _free()
    return out


def group_control(dev, tag, group=WRONG_GROUP):
    """The planted control of local-head case ``tag``: K5, K6 and K7 on
    an input in which query head h reads kv head h // ``group`` (k and v
    gathered to every query head by that map; K7's dk and dv summed back
    by it), held to the plain versions at the case's own group, which
    must reject each. Returns (K5 rejected, K6/K7 rejected, K5's max err,
    K6/K7's)."""
    import torch

    from repro_torch.kernels import flash_cuda as fc
    gen = torch.Generator(device=dev).manual_seed(3)
    _, b, h, hkv, s, d, dname, window, _ = next(
        c for c in MESH_K5_CASES if c[0] == tag)
    check(h % hkv == 0 and (h - 1) // group < hkv,
          f"{tag}: no map h // {group} at H {h}, Hkv {hkv}")
    q, k, v = _attention_case(dev, gen, b, h, hkv, s, d,
                              getattr(torch, dname))
    do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    kw = dict(sm_scale=d ** -0.5, causal=True, window=window)
    wrong = torch.arange(h, device=dev) // group
    kr, vr = k[:, wrong].contiguous(), v[:, wrong].contiguous()
    o, lse = fc.flash_fwd(q, kr, vr, **kw)
    pout, plse = fc.flash_fwd_plain(q, k, v, **kw)
    ok5, err5, err_lse, _ = k5_agreement(o, lse, pout, plse)
    dd = torch.sum(do.float() * o.float(), dim=-1)
    dq = fc.flash_bwd_dq(q, kr, vr, do, lse, dd, **kw)
    dkr, dvr = fc.flash_bwd_dkv(q, kr, vr, do, lse, dd, **kw)
    summed = [torch.zeros(k.shape, dtype=torch.float32, device=dev)
              .index_add_(1, wrong, t.float()).to(k.dtype)
              for t in (dkr, dvr)]
    want = fc.flash_bwd_plain(q, k, v, pout, plse, do, **kw)
    res = [grad_agreement(g, w) for g, w in zip((dq, *summed), want)]
    _sync(dev)
    out = (not ok5, not all(r[0] for r in res), max(err5, err_lse),
           max(r[1] for r in res))
    del q, k, v, do, kr, vr, o, lse, pout, plse, dd, dq, dkr, dvr, summed
    _free()
    return out


@contextlib.contextmanager
def dispatch_recorder(slots):
    """Record every MoE dispatch of a run: (slot (G, s, K), B, S) a call,
    each kept choice's slot e * C + pos (E * C where dropped)."""
    from repro_torch.models import moe
    orig = moe._dispatch

    def recording(router, router_bias, cfg, x, n_groups):
        out = orig(router, router_bias, cfg, x, n_groups)
        slots.append((out[1].detach(), x.shape[0], x.shape[1]))
        return out

    moe._dispatch = recording
    try:
        yield
    finally:
        moe._dispatch = orig


def moe_share(r, slots):
    """This rank's MoE work on the mesh, by its own data shard: the kept
    choices its local experts compute (the expert weights' shard), the
    share of them whose token is in its data rows, and that share of the
    expert rows it computes (E_local x G x C, empty slots included). The
    routing, dispatch and combine run on the whole batch on every rank,
    so their own share is 1 / data."""
    import torch
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.models import moe
    mesh, cfg = r.mesh, r.cfg
    w1 = next(p for n, p in r.state["params"].items()
              if n.endswith("moe.w1"))
    shape, off = compute_local_shape_and_global_offset(
        w1.shape, w1.device_mesh, w1.placements)
    lo, hi = off[0], off[0] + shape[0]
    n_data = mesh.size(mesh.mesh_dim_names.index("data"))
    d = mesh.get_local_rank("data")
    E = cfg.n_experts
    own = kept = rows = 0
    for slot, B, S in slots:
        G, s, _ = slot.shape
        C = moe.capacity(cfg, s)
        expert = torch.div(slot, C, rounding_mode="floor")
        mine = (slot < E * C) & (expert >= lo) & (expert < hi)
        tok = torch.arange(G * s, device=slot.device).reshape(G, s, 1)
        shard = (tok // S) // (B // n_data)
        own += int((mine & (shard == d)).sum())
        kept += int(mine.sum())
        rows += (hi - lo) * G * C
    return {"experts": f"{lo}-{hi - 1}", "own_kept_share": own / kept,
            "own_rows_share": own / rows, "kept_rows_share": kept / rows,
            "routed_own_share": 1 / n_data}


def _mesh_train(dev, spec, layout, arch=MESH_ARCH, layers=None, seq=None,
                batch=None, moe=False, plan=None, prepare=None, save=None,
                inputs=None, profile=None):
    """launch.train's path on this rank's mesh of ``layout``: build (under
    ``plan``, ``mesh_argv``'s; ``inputs`` the cross-attended inputs of a
    step, default ``train_inputs``, made before the steps),
    ``prepare(model)`` on the model
    built, then TRAIN_STEPS steps (the launches counted over them), the
    peak, one more step under torch.profiler (``profile``, default
    ``spec["profile"]``; ``"cuda"``: its device activity only); with
    ``save``, the parameters saved there after MESH_MOE_HELD steps, for
    one process to take the next step at them. An MoE run records its
    routing (``RoutingRecorder``) and its dispatches (``moe_share``)."""
    import numpy as np
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.kernels import flash_cuda as fc
    from repro_torch.launch import train as lt
    from repro_torch.train import checkpoint
    args = lt.parse(mesh_argv(spec, arch, layers or spec["layers"],
                              seq or spec["seq"], batch or MESH_BATCH,
                              layout, plan))
    t0 = time.perf_counter()
    source = inputs or train_inputs(lt.config(args), args.global_batch)
    if source is not None:
        # every step's cross-attended inputs made first, so that no step's
        # time holds their making (16 x 1601 x 8192 normals for
        # llama-3.2-vision-90b: seconds of host time)
        made = {s: source(s) for s in range(TRAIN_STEPS + 1)}
        source = made.__getitem__
    r = lt.build(args, source, plan=plan)
    if prepare is not None:
        prepare(r.model)
    init_s = time.perf_counter() - t0
    check(tuple(r.mesh.shape) == tuple(layout),
          f"mesh {tuple(r.mesh.shape)}, wanted {layout}")
    rec = RoutingRecorder() if moe else None
    slots, last, out1 = [], {}, {}

    def on_step(h):
        if rec:
            rec.mark()
        h["launches"] = {k: n - last.get(k, 0) for k, n in fc.LAUNCHES.items()}
        last.update(fc.LAUNCHES)
        if spec["params_out"] and h["step"] == 0:
            from repro_torch.convert import lm_params_to_numpy
            out1["tree"] = lm_params_to_numpy(r.model)

    _reset_peak(dev)
    with rec.hook() if rec else contextlib.nullcontext(), \
            dispatch_recorder(slots) if moe else contextlib.nullcontext():
        if rec:
            rec.mark()
        # the main path: counts set to 0 just before, read just after
        fc.reset_launches()
        if save:
            # the weights step MESH_MOE_HELD + 1 starts from, for one
            # process to take that step at them (moe_restored_step,
            # family_at)
            hist = lt.train_steps(r, 0, MESH_MOE_HELD, on_step=on_step)
            checkpoint.save(save, MESH_MOE_HELD, {"params": r.state["params"]})
            hist += lt.train_steps(r, MESH_MOE_HELD, TRAIN_STEPS,
                                   on_step=on_step)
        else:
            hist = lt.train_steps(r, 0, TRAIN_STEPS, on_step=on_step)
        launches = dict(fc.LAUNCHES)
    # the parameters fsdp shards over data on a dim model does not split
    data = r.mesh.mesh_dim_names.index("data")
    fsdp = sorted(n for n, p in r.state["params"].items()
                  if isinstance(p, DTensor) and p.dim() >= 2
                  and isinstance(p.placements[data], Shard)
                  and all(p.placements[data].dim != q.dim
                          for i, q in enumerate(p.placements)
                          if i != data and isinstance(q, Shard)))
    out = {"hist": hist, "launches": launches, "peak": _peak(dev),
           "init_s": init_s, "params": sum(p.numel() for p in
                                           r.model.parameters()),
           "moe_groups": r.cfg.moe_groups, "ep_axes": r.cfg.ep_axes,
           "grad_dtype": plan.grad_dtype if plan else None,
           "mesh": tuple(r.mesh.shape), "layers": r.cfg.n_layers,
           "flash_layers": flash_layers(r.model),
           "n_micro": args.n_micro, "quantized": args.quantized_state,
           "tokens": args.global_batch * (args.seq_len - 1),
           "fsdp_leaves": fsdp}
    if moe:
        out["routes"] = [[route_ids(c) for c in call]
                         for call in rec.calls if call]
        out["share"] = moe_share(r, slots)
    del slots, rec
    profile = spec["profile"] if profile is None else profile
    out["split"] = (device_ms(lambda: lt.train_steps(
        r, TRAIN_STEPS, TRAIN_STEPS + 1), cpu=profile != "cuda")
                    if profile else None)
    if spec["params_out"]:
        from repro_torch.convert import lm_params_to_numpy
        out["tree"] = lm_params_to_numpy(r.model)
        out["tree1"] = out1["tree"]
    del r
    _free()
    return out


def _mesh_dp(dev, spec):
    """(c): [dist]'s compressed data-parallel step on (world, 1)."""
    import torch.distributed as dist
    return _dist_dp(dist.get_rank(), dev, dist_config(smoke=spec["smoke"]),
                    seq=spec["seq"], profile=spec["profile"],
                    params_out=spec["params_out"])


def _same_leaf(a, b):
    """Whether two checkpoint leaves hold the same bits (DTensors whole)."""
    import torch
    from torch.distributed.tensor import DTensor
    if not isinstance(a, torch.Tensor):
        return a == b
    a = a.full_tensor() if isinstance(a, DTensor) else a
    b = b.full_tensor() if isinstance(b, DTensor) else b
    return a.dtype == b.dtype and torch.equal(a, b)


def _mesh_elastic(dev, spec):
    """(d): MESH_SHORT layers at (2, 2), saved after step 2; restored at
    each of MESH_RESTORE (every leaf held to the saved one bit for bit,
    laid out by the new mesh's shardings) and stepped once; then the
    (2, 2) run's own step 3."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import train as lt
    from repro_torch.train import checkpoint

    def build(layout):
        return lt.build(lt.parse(mesh_argv(
            spec, MESH_ARCH, None if spec["smoke"] else MESH_SHORT,
            spec["seq"], MESH_ELASTIC_BATCH, layout)))

    last = TRAIN_STEPS - 1
    r = build((2, 2))
    first = lt.train_steps(r, 0, last)
    t0 = time.perf_counter()
    checkpoint.save(spec["ckpt"], last, r.state)
    out = {"first": first, "save_s": time.perf_counter() - t0,
           "restored": {}}
    saved = checkpoint._flatten(r.state)
    for layout in MESH_RESTORE:
        r2 = build(layout)
        t0 = time.perf_counter()
        got = checkpoint.restore(spec["ckpt"], last, r2.state, r2.shardings)
        restore_s = time.perf_counter() - t0
        flat, want = checkpoint._flatten(got), checkpoint._flatten(
            r2.shardings)
        bad = [k for k, v in saved.items() if not _same_leaf(v, flat[k])]
        placed = all(tuple(v.placements) == tuple(want[k].placements)
                     for k, v in flat.items() if isinstance(v, DTensor))
        r2.state = got
        h = lt.train_steps(r2, last, last + 1)[0]
        out["restored"][layout] = dict(h, bad=bad, leaves=len(saved),
                                       placed=placed, restore_s=restore_s,
                                       mesh=tuple(r2.mesh.shape))
        del r2, got, flat
        _free()
    out["straight"] = lt.train_steps(r, last, last + 1)[0]
    del r
    _free()
    return out


def mesh_count_cell(spec, mesh, device):
    """The count's program on ``device``: one (2, 2) step of (a)'s model
    at MESH_SHORT layers (the SMOKE config with ``spec["smoke"]``), einsum
    attention (the dry run counts no ctypes kernel), ``spec["count"]``'s
    kind: a training step (int8 moments, MESH_BATCH sequences of
    ``spec["seq"]`` tokens) or a decode step (SERVE_SLOTS rows against a
    cache of SERVE_COUNT_LEN); or (``"moe_train"``) one step of (m),
    deepseek-v3-671b at its depth, batch and sequence under its
    OPT_PLANS plan: ``(fn, args)``."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun, specs
    if spec["count"] == "moe_train":
        fam = FAMILIES["m"]
        cfg = (registry.smoke_config(fam["arch"]) if spec["smoke"] else
               registry.config(fam["arch"], n_layers=fam["layers"]))
        seq = spec["seq"] if spec["smoke"] else fam["seq"]
        cell = specs.Cell(fam["arch"], "train_4k", seq, fam["batch"],
                          "train")
        fn, args, _, _ = dryrun.build_cell(
            fam["arch"], cell.shape, mesh, family_plan("m"), cfg=cfg,
            cell=cell, device=device, seed=0)
        return fn, args
    cfg = (registry.smoke_config(MESH_ARCH) if spec["smoke"] else
           registry.config(MESH_ARCH, n_layers=MESH_SHORT))
    if spec["count"] == "decode":
        cell = specs.Cell(MESH_ARCH, "decode_32k", SERVE_COUNT_LEN,
                          SERVE_SLOTS, "decode")
        plan = dryrun.Plan()
    else:
        cell = specs.Cell(MESH_ARCH, "train_4k", spec["seq"], MESH_BATCH,
                          "train")
        plan = dryrun.Plan(quantized=True)
    fn, args, _, _ = dryrun.build_cell(
        MESH_ARCH, cell.shape, mesh, plan, cfg=cfg, cell=cell,
        device=device, seed=0)
    return fn, args


def _count_record(a, out, secs):
    an = a.analyze()
    return {"cost": {k: getattr(a.cost, k) for k in ("flops", "eflops",
                                                     "bytes", "coll_bytes")},
            "n_ops": a.n_ops, "op_counts": dict(a.op_counts),
            "argument_bytes": a.argument_bytes,
            "memory": a.memory(out), "collectives": an["collectives"],
            "per_dev": {k: an[k] for k in (
                "flops_per_dev", "bytes_per_dev",
                "collective_bytes_per_dev")}, "seconds": secs}


def mesh_count_child(out_path, spec_json):
    """[mesh]'s meta count, in a process of its own on the CPU: the count
    program on meta under a fake 4-rank group on a (2, 2) mesh, as rank
    ``count_rank`` (default 0); its record to ``out_path`` (JSON). Where
    the spec's ``count_ranks`` name ranks besides 0, each is counted in a
    child of its own (a dim split unevenly over a mesh axis, 4,095 tokens
    over ``model``, gives the ranks other local shapes) and the record is
    rank 0's with every rank's under ``by_rank``."""
    import logging

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun
    spec = json.loads(spec_json)
    several = [r for r in spec.get("count_ranks", (0,))]
    if "count_rank" not in spec and several != [0]:
        procs = {r: mesh_count_start(f"{out_path}.{r}",
                                     dict(spec, count_rank=r))
                 for r in several}
        recs = {str(r): mesh_count_finish(p, f"{out_path}.{r}",
                                          time.perf_counter())
                for r, p in procs.items()}
        Path(out_path).write_text(json.dumps(dict(recs["0"], by_rank=recs)))
        return
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    dryrun.fake_world(MESH_WORLD, spec.get("count_rank", 0))
    mesh = init_device_mesh("cpu", MESH_TP["a"],
                            mesh_dim_names=("data", "model"))
    fn, args = mesh_count_cell(spec, mesh, torch.device("meta"))
    a, out, secs = dryrun.count_cell(fn, args)
    Path(out_path).write_text(json.dumps(_count_record(a, out, secs)))


def mesh_count_start(out_path, spec):
    """Start ``mesh_count_child`` (the card hidden from it)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    log = open(f"{out_path}.log", "w")
    try:
        return subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), MESH_COUNT_FLAG,
             out_path, json.dumps(spec)], env=env, cwd=str(ROOT),
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()


def _mesh_count(dev, spec):
    """The count on this rank: the count program counted by
    ``op_analysis`` on the card (the first run), then timed (median of
    DRYRUN_REPS after a warm-up; CUDA events) and profiled once."""
    from repro_torch.launch import dryrun, op_analysis
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(MESH_TP["a"][1], device=dev.type)
    fn, args = mesh_count_cell(spec, mesh, dev)
    real = sum(t.numel() * t.element_size()
               for t in op_analysis.local_tensors(args))
    _sync(dev)
    _reset_peak(dev)
    a, out, secs = dryrun.count_cell(fn, args, device=dev)
    _sync(dev)
    rec = dict(_count_record(a, out, secs), real_argument_bytes=real,
               peak=_peak(dev), cell=spec["count"])
    del out
    times = []
    for i in range(DRYRUN_REPS + 1):
        t0 = time.perf_counter()
        fn(*args)
        _sync(dev)
        if i:
            times.append(time.perf_counter() - t0)
    rec["steps_s"] = times
    rec["split"] = (device_ms(lambda: fn(*args)) if spec["profile"]
                    else None)
    del fn, args
    _free()
    return rec


def family_plan(key):
    """(f)-(i)'s and (n)-(o)'s plan, the architecture's
    ``launch.dryrun.PLANS`` entry ((m)'s its ``OPT_PLANS`` one); (j)'s,
    the reference CLI's n_micro (``launch.train``'s default) with int8
    moments."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as lt
    if key == "j":
        return dryrun.Plan(n_micro=lt.parse([]).n_micro, quantized=True)
    fam = FAMILIES[key]
    return (dryrun.OPT_PLANS if fam.get("opt") else dryrun.PLANS)[
        fam["arch"]]


def is_moe(arch):
    """Whether ``arch`` routes its tokens to experts."""
    from repro_torch.configs import registry
    return registry.config(arch).is_moe


def family_prepare(arch):
    """What the model of ``arch`` takes before training, as its one-card
    slice does: zamba2's constant leaves drawn (perturb_ssm_leaves), the
    VLM's gates set to VISION_GATE; None for the others."""
    if arch == ZAMBA_ARCH:
        return perturb_ssm_leaves
    if arch == VISION_ARCH:
        return lambda model: set_gates(model, VISION_GATE)
    return None


def family_argv(spec, key, layers, layout=None):
    """launch.train's arguments for family ``key`` at ``layers`` (the
    SMOKE config's own depth and the spec's sequence with ``smoke``)."""
    fam = FAMILIES[key]
    smoke = spec["smoke"]
    return mesh_argv(spec, fam["arch"], None if smoke else layers,
                     spec["seq"] if smoke else fam["seq"], fam["batch"],
                     layout, family_plan(key))


def _mesh_family(dev, spec, key, inputs=None):
    """(f)-(i) on this rank: family ``key`` at its depth (profiled, as
    the spec says), then, where one card holds the plan at another depth,
    at that one; the held run saves its weights after MESH_MOE_HELD
    steps under ``spec["ckpt"] + "_" + key``. ``inputs``: another source
    of the cross-attended inputs (the CPU tests' control). An MoE run
    records its routing and dispatches (``_mesh_train``'s ``moe``)."""
    fam = FAMILIES[key]
    layers, held, seq = ((None, None, spec["seq"]) if spec["smoke"]
                         else (fam["layers"], fam["held"], fam["seq"]))

    def run(depth, save, profile):
        return _mesh_train(
            dev, spec, FAMILY_LAYOUT, fam["arch"], depth, seq, fam["batch"],
            moe=is_moe(fam["arch"]), plan=family_plan(key),
            prepare=family_prepare(fam["arch"]), save=save, inputs=inputs,
            profile=profile)

    save = spec["ckpt"] + f"_{key}" if spec["ckpt"] else None
    profile = spec["profile"] and (
        "cuda" if fam["arch"] in FAMILY_DEVICE_ONLY_PROFILE else True)
    out = {"timed": run(layers, save if held == layers else None, profile)}
    if held != layers:
        out["held"] = run(held, save, False)
    return out


def _other_frames(dev, spec):
    """(h) with each data rank's frames taken from the other data rank's
    rows (its tokens its own): the CPU tests' control, whose loss must
    move."""
    import numpy as np

    from repro_torch.launch import train as lt
    fam = FAMILIES["h"]
    cfg = lt.config(lt.parse(family_argv(spec, "h", fam["layers"])))
    base = train_inputs(cfg, fam["batch"])

    def inputs(step):
        return {k: np.roll(v, fam["batch"] // 2, axis=0)
                for k, v in base(step).items()}
    return _mesh_family(dev, dict(spec, ckpt=None), "h", inputs)


def _moe_variant(dev, spec, what):
    """(m) with one thing changed, the CPU tests' controls: ``"f32_acc"``,
    its plan with a float32 accumulator (held to the reference at 1e-5);
    ``"f32_state"``, float32 moments too; ``"misrouted"``, each rank's share of the expert weights taken from
    the rank at its transposed mesh coordinates, what an expert layout in
    the other order of ("data", "model") than the slot rows' gives: rank
    r's slot rows reach another rank's experts, and the loss must move."""
    import dataclasses

    import torch
    fam = FAMILIES["m"]
    plan = family_plan("m")
    prepare = None
    if what == "f32_acc":
        plan = dataclasses.replace(plan, grad_dtype=None)
    elif what == "f32_state":
        plan = dataclasses.replace(plan, grad_dtype=None, quantized=False)
    else:
        def prepare(model):
            with torch.no_grad():
                for n, p in model.named_parameters():
                    if n.split(".")[-2:-1] == ["moe"] \
                            and n.endswith(("w1", "w3", "w2")):
                        mesh = p.device_mesh
                        d, m = (mesh.get_local_rank(a)
                                for a in ("data", "model"))
                        parts = p.full_tensor().chunk(mesh.size())
                        p.to_local().copy_(parts[m * mesh.size(0) + d])
    return {"timed": _mesh_train(
        dev, spec, FAMILY_LAYOUT, fam["arch"],
        None if spec["smoke"] else fam["layers"],
        spec["seq"] if spec["smoke"] else fam["seq"], fam["batch"],
        moe=True, plan=plan, prepare=prepare, profile=False)}


def _mesh_supervised(dev, spec):
    """(j): SUP_STEPS steps under fault.Supervisor with ``shardings=``,
    a checkpoint every SUP_EVERY steps and a fault injected at step
    SUP_FAULT (once, on every rank), beside the same steps uninterrupted:
    the history, every leaf of the final state against the uninterrupted
    one's (bit for bit), the latest checkpoint and the launches."""
    from repro_torch.kernels import flash_cuda as fc
    from repro_torch.launch import train as lt
    from repro_torch.train import checkpoint, fault
    argv = mesh_argv(spec, MESH_ARCH, None if spec["smoke"] else MESH_SHORT,
                     spec["seq"], SUP_BATCH, FAMILY_LAYOUT, family_plan("j"))
    argv[argv.index("--steps") + 1] = str(SUP_STEPS)
    args = lt.parse(argv)
    straight = lt.build(args)
    lt.train_steps(straight, 0, SUP_STEPS)
    r = lt.build(args)
    armed = [True]

    def fault_hook(step):
        if step == SUP_FAULT and armed[0]:
            armed[0] = False
            raise RuntimeError(f"injected fault at step {step}")

    ckpt = spec["ckpt"] + "_j"
    sup = fault.Supervisor(ckpt_dir=ckpt, ckpt_every=SUP_EVERY)
    _reset_peak(dev)
    # the main path: counts set to 0 just before, read just after
    fc.reset_launches()
    t0 = time.perf_counter()
    final, hist = sup.run(state=r.state, step_fn=r.step_fn,
                          data_fn=r.data_fn, n_steps=SUP_STEPS,
                          fault_hook=fault_hook, shardings=r.shardings)
    wall = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)
    got, want = checkpoint._flatten(final), checkpoint._flatten(
        straight.state)
    bad = [k for k in want if not _same_leaf(got[k], want[k])]
    out = {"hist": hist, "steps": [h["step"] for h in hist],
           "launches": launches, "leaves": len(want), "bad": bad,
           "latest": checkpoint.latest_step(ckpt),
           "opt_step": final["opt_state"].step, "peak": _peak(dev),
           "wall_s": wall, "flash_layers": flash_layers(r.model),
           "n_micro": args.n_micro,
           "tokens": args.global_batch * (args.seq_len - 1)}
    del r, straight, final, got, want
    _free()
    return out


MESH_RUNS = {
    "a": lambda dev, spec: _mesh_train(dev, spec, MESH_TP["a"]),
    "b": lambda dev, spec: _mesh_train(dev, spec, MESH_TP["b"]),
    "c": _mesh_dp,
    "d": _mesh_elastic,
    "e": lambda dev, spec: _mesh_train(
        dev, spec, MESH_TP["a"], MIXTRAL_ARCH,
        None if spec["smoke"] else MESH_MOE_LAYERS, 2 * spec["seq"],
        MESH_BATCH, moe=True, save=spec["ckpt"] + "_moe"),
    "count": _mesh_count,
    "f": lambda dev, spec: _mesh_family(dev, spec, "f"),
    "g": lambda dev, spec: _mesh_family(dev, spec, "g"),
    "h": lambda dev, spec: _mesh_family(dev, spec, "h"),
    "i": lambda dev, spec: _mesh_family(dev, spec, "i"),
    "j": _mesh_supervised,
    "h_other_frames": _other_frames,
    "m": lambda dev, spec: _mesh_family(dev, spec, "m"),
    "m_f32_acc": lambda dev, spec: _moe_variant(dev, spec, "f32_acc"),
    "m_f32_state": lambda dev, spec: _moe_variant(dev, spec, "f32_state"),
    "m_misrouted": lambda dev, spec: _moe_variant(dev, spec, "misrouted"),
    "n": lambda dev, spec: _mesh_family(dev, spec, "n"),
    "o": lambda dev, spec: _mesh_family(dev, spec, "o"),
}


def _mesh_rank(rank, world, init_file, spec):
    """One rank of [mesh]: on card ``rank`` over NCCL (``spec["device"]``
    ``"cuda"``; first the local-head kernel checks on its card), or on the
    CPU over gloo (the tests' SMOKE run); then ``spec["phases"]`` in
    order. Returns each phase's results."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.launch import ranks
    cuda = spec["device"] == "cuda"
    if cuda:
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction = False
    ranks.init(rank, world, init_file, backend="nccl" if cuda else "gloo",
               threads=None if cuda else 1)
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    out = {"backend": dist.get_backend(), "device": str(dev)}
    if cuda:
        out["kernels"] = local_head_checks(dev, spec["kernel_tags"])
        out["controls"] = {t: group_control(dev, t)
                           for t in spec.get("kernel_controls", ())}
    for name in spec["phases"]:
        t0 = time.perf_counter()
        out[name] = MESH_RUNS[name](dev, spec)
        out[f"{name}_s"] = time.perf_counter() - t0
    return out


def _rank_lines(tag, res, key, whole, what, cuda=True, held=None):
    """Print (a)'s, (b)'s or (e)'s lines: every rank's steps against the
    one-process run ``whole`` (the losses of its first ``held`` steps,
    default all, within DIST_LOSS_RTOL; the rest printed), its step time,
    tokens a second, NCCL's device time in the profiled step, the peak
    (under MESH_PEAK) and its launches, each kernel launched on a card
    (on the CPU the kernels' plain versions run)."""
    from repro_torch.kernels import flash_cuda as fc
    for r, out in enumerate(res):
        run = out[key]
        mesh = "x".join(map(str, run["mesh"]))
        for h, w in zip(run["hist"], whole["hist"], strict=True):
            rel = _rel(h["loss"], w["loss"])
            limit = (DIST_LOSS_RTOL if held is None or h["step"] < held
                     else "not_held")
            phase(tag, run=what, mesh=mesh, rank=r, step=h["step"],
                  loss=f"{h['loss']:.6f}", loss_one_process=f"{w['loss']:.6f}",
                  loss_rel_vs_one_process=f"{rel:.3e}",
                  grad_norm_rel_vs_one_process=(
                      f"{_rel(h['grad_norm'], w['grad_norm']):.3e}"),
                  aux=f"{h['aux']:.6f}", aux_one_process=f"{w['aux']:.6f}",
                  limit=limit, time_s=f"{h['time_s']:.3f}",
                  launches=json.dumps(h["launches"], separators=(",", ":")))
            check(limit == "not_held" or rel <= DIST_LOSS_RTOL,
                  f"{what} {mesh} rank {r} step {h['step']}: loss {rel} "
                  f"from one process")
        wall = run["hist"][-1]["time_s"]
        split = run["split"] or {}
        busy = sum(split.values())
        tokens = run["tokens"]
        phase(tag, run=what, mesh=mesh, rank=r, device=out["device"],
              params=run["params"], tokens_per_step=tokens,
              init_s=f"{run['init_s']:.3f}",
              step_s=",".join(f"{h['time_s']:.3f}" for h in run["hist"]),
              tokens_per_s=f"{tokens / wall:.1f}",
              tokens_per_s_per_card=f"{tokens / wall / MESH_WORLD:.1f}",
              nccl_s=(f"{split['nccl'] / 1e3:.4f}" if split
                      else "not measured"),
              device_s=f"{busy / 1e3:.4f}" if split else "not measured",
              **{f"profiled_{k}_ms": f"{v:.3f}" for k, v in split.items()},
              max_memory_allocated=run["peak"],
              launches=json.dumps(run["launches"], separators=(",", ":")))
        check(run["peak"] < MESH_PEAK, f"{what} rank {r}: peak "
              f"{run['peak']} bytes")
        check(not cuda or all(run["launches"].get(k, 0) > 0
                              for k in (fc.NAME, fc.DQ, fc.DKV)),
              f"{what} rank {r}: a flash kernel never launched "
              f"{run['launches']}")


def route_ids(choices):
    """A route call's (G, S, K) expert choices as a compact host array
    (int16: deepseek-v3-671b's 256 experts pass int8's range)."""
    import numpy as np
    return choices.cpu().numpy().astype(np.int16)


def _routes_lead(dev, routes):
    """A lead for ``RoutingRecorder`` from a rank's recorded choices."""
    import types

    import torch
    return types.SimpleNamespace(calls=[
        [torch.as_tensor(c, device=dev).long() for c in call]
        for call in routes])


def moe_restored_step(dev, spec, routes):
    """(e)'s step MESH_MOE_HELD + 1 in one process at the weights the
    mesh took it from (saved by the mesh run), following the mesh's
    expert choices of that step: its history entry and the routing
    recorder."""
    from repro_torch.launch import train as lt
    from repro_torch.train import checkpoint
    from repro_torch.train import loop as tl
    r = lt.build(lt.parse(mesh_argv(
        spec, MIXTRAL_ARCH, None if spec["smoke"] else MESH_MOE_LAYERS,
        2 * spec["seq"], MESH_BATCH)))
    got = checkpoint.restore(spec["ckpt"] + "_moe", MESH_MOE_HELD,
                             {"params": r.state["params"]})
    r.state["params"] = tl.bind(r.model, got["params"])
    del got
    rec = RoutingRecorder(_routes_lead(
        dev, routes[MESH_MOE_HELD:MESH_MOE_HELD + 1]))
    with rec.hook():
        rec.mark()
        h = lt.train_steps(r, MESH_MOE_HELD, MESH_MOE_HELD + 1)[0]
    del r
    _free()
    return h, rec


def mesh_count_finish(proc, out_path, t_start):
    """The meta count's record, once its process ends."""
    proc.wait(timeout=max(DRYRUN_TIMEOUT - (time.perf_counter() - t_start),
                          1))
    check(proc.returncode == 0, f"meta count exited {proc.returncode}: "
          f"{Path(out_path + '.log').read_text()[-2000:]}")
    return json.loads(Path(out_path).read_text())


def mesh_count_report(tag, whole, res):
    """Every card's count equal to meta's (flops, elementwise flops,
    bytes, collective bytes, argument bytes; the meta count of the card's
    own rank where ``whole`` has one, ``by_rank``, else rank 0's), the
    measured step at or above its roofline bound, the predicted peak
    within PEAK_RATIO of the card's; the collective term beside NCCL's
    measured time. Ops
    that the card dispatches and meta does not (or the other way) are
    printed by name: they may differ only in ops that cost nothing, since
    every cost is equal."""
    from repro_torch.launch import dryrun
    for r, out in enumerate(res):
        card = out["count"]
        meta = whole.get("by_rank", {}).get(str(r), whole)
        roof = dryrun.roofline(*(meta["per_dev"][k] for k in (
            "flops_per_dev", "bytes_per_dev", "collective_bytes_per_dev")))
        bound = max(roof["compute_s"], roof["memory_s"])
        ops_differ = {k: card["op_counts"].get(k, 0)
                      - meta["op_counts"].get(k, 0)
                      for k in set(card["op_counts"]) | set(meta["op_counts"])
                      if card["op_counts"].get(k, 0)
                      != meta["op_counts"].get(k, 0)}
        if card["cost"] != meta["cost"]:
            # printed before the check ends the script: the ops to look at
            phase(tag, run="count", cell=card["cell"], rank=r,
                  card_cost=json.dumps(card["cost"]),
                  meta_cost=json.dumps(meta["cost"]),
                  card_minus_meta_ops=json.dumps(ops_differ, sort_keys=True,
                                                 separators=(",", ":")))
        check(card["cost"] == meta["cost"], f"rank {r}: card counts "
              f"{card['cost']} differ from meta's {meta['cost']}")
        check(card["argument_bytes"] == meta["argument_bytes"]
              == card["real_argument_bytes"], f"rank {r}: argument bytes "
              f"card {card['argument_bytes']}, meta "
              f"{meta['argument_bytes']}, tensors "
              f"{card['real_argument_bytes']}")
        step = sorted(card["steps_s"])[len(card["steps_s"]) // 2]
        pred = meta["memory"]["peak_bytes"]
        ratio = pred / card["peak"]
        split = card["split"] or {}
        nccl = split.get("nccl")
        coll = meta["per_dev"]["collective_bytes_per_dev"]
        phase(tag, run="count", cell=card["cell"], mesh="2x2", rank=r,
              flops=f"{meta['cost']['flops'] + meta['cost']['eflops']:.6e}",
              matmul_flops=f"{meta['cost']['flops']:.6e}",
              bytes=f"{meta['cost']['bytes']:.6e}",
              collective_bytes=f"{coll:.6e}", ops=meta["n_ops"],
              card_ops=card["n_ops"], counts="meta_equals_card",
              card_minus_meta_ops=json.dumps(ops_differ, sort_keys=True,
                                             separators=(",", ":")),
              argument_bytes=card["argument_bytes"],
              compute_s=f"{roof['compute_s']:.6e}",
              memory_s=f"{roof['memory_s']:.6e}",
              collective_s_at_50GBps=f"{roof['collective_s']:.6e}",
              bound_s=f"{bound:.6e}", step_s=f"{step:.6f}",
              steps_s=",".join(f"{t:.6f}" for t in card["steps_s"]),
              bound_over_step=f"{bound / step:.4f}",
              nccl_s=f"{nccl / 1e3:.6f}" if nccl is not None
              else "not measured",
              collective_bytes_per_nccl_s=(
                  f"{coll / (nccl / 1e3):.4e}" if nccl else "not measured"),
              predicted_peak=pred, max_memory_allocated=card["peak"],
              peak_ratio=f"{ratio:.4f}",
              collectives=json.dumps({k: v for k, v in
                                      meta["collectives"].items()},
                                     separators=(",", ":")),
              meta_count_s=f"{meta['seconds']:.1f}",
              card_count_s=f"{card['seconds']:.1f}", derived="counts")
        check(step >= bound, f"rank {r}: measured step {step} s below its "
              f"roofline bound {bound} s: a miscount")
        check(PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1], f"rank {r}: predicted "
              f"peak {pred} vs max_memory_allocated {card['peak']}")


def rank_kernel_lines(res, cuda):
    """Every card: the backend, and K5, K6, K7 at each local-head case
    held to their plain versions, K7 bit for bit over two launches."""
    for r, out in enumerate(res):
        want = ("nccl", f"cuda:{r}") if cuda else ("gloo", "cpu")
        check((out["backend"], out["device"]) == want,
              f"rank {r}: {out['backend']} on {out['device']}")
        for tag, (ok5, e5, okb, eb, same) in out.get("kernels", {}).items():
            phase("mesh", rank=r, device=out["device"], case=tag,
                  k5_max_abs_err=f"{e5:.3e}", k6_k7_max_abs_err=f"{eb:.3e}",
                  k7_two_launches="bitwise" if same else "differ")
            check(ok5 and okb and same, f"rank {r} {tag}: K5 {ok5} ({e5}), "
                  f"K6/K7 {okb} ({eb}), K7 bitwise {same}")
        for tag, (rej5, rejb, e5, eb) in out.get("controls", {}).items():
            phase("mesh", rank=r, device=out["device"], case=tag,
                  control=f"kv_head_h_div_{WRONG_GROUP}",
                  k5="rejected" if rej5 else "passed",
                  k6_k7="rejected" if rejb else "passed",
                  k5_max_abs_err=f"{e5:.3e}", k6_k7_max_abs_err=f"{eb:.3e}")
            check(rej5 and rejb, f"rank {r} {tag}: the checks passed the "
                  f"planted map h // {WRONG_GROUP} (K5 rejected {rej5}, "
                  f"K6/K7 rejected {rejb})")


def mesh_kernel_phase(dev, tags=MESH_TAGS[:3]):
    """Local-head cases ``tags`` (default [mesh]'s: ``tp2``, ``tp4``,
    ``tp2_w4096``; --mesh-remaining's REMAIN_KERNEL_TAGS) on card 0: K5,
    K6 and K7 against their plain versions, timed beside them and SDPA.
    Returns their rows."""
    table = lm_kernel_phase(dev, [c for c in K5_CASES + MESH_K5_CASES
                                  if c[0] in tags], small=False)
    table.update(bwd_kernel_phase(
        dev, [c for c in BWD_CASES + MESH_BWD_CASES if c[0] in tags],
        small=False))
    return table


def mesh_phases(dev, spec=None):
    """[mesh] on MESH_WORLD cards (``spec``, default ``mesh_spec()``): the
    meta count's process, the ranks (each its card's local-head checks,
    then (a) through (e) and the count), then on card 0 the one-process
    runs that (a), (b) and (c) are held to and (e)'s, which follows the
    mesh's routing, and the checks. Returns the launches of the
    local-head rows: (a)'s for tp2, (b)'s for tp4, (e)'s for tp2_w4096
    (rank 0's)."""
    from repro_torch.launch import ranks

    t0 = time.perf_counter()
    spec = spec or mesh_spec(ckpt=str(ROOT / "build" / "mesh_ckpt"))
    ckpt, cuda = spec["ckpt"], spec["device"] == "cuda"
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(ckpt + "_moe", ignore_errors=True)
    with tempfile.TemporaryDirectory() as tmp:
        count_json = str(Path(tmp) / "count.json")
        t_count = time.perf_counter()
        proc = mesh_count_start(count_json, spec)
        try:
            _free()
            init = ROOT / "build" / "mesh_rdzv"
            init.unlink(missing_ok=True)
            t1 = time.perf_counter()
            res = ranks.run_ranks(_mesh_rank, MESH_WORLD, str(init), (spec,),
                                  timeout=MESH_TIMEOUT)
            ranks_s = time.perf_counter() - t1
            init.unlink(missing_ok=True)
            shutil.rmtree(ckpt, ignore_errors=True)
            # the one-process runs on card 0, once the ranks have left it
            whole = full_depth_run("one_process", {}, arch=MESH_ARCH,
                                   argv=mesh_argv(spec, MESH_ARCH, None,
                                                  spec["seq"], MESH_BATCH),
                                   line="mesh")
            whole_dp, _ = one_process_steps(
                dev, dist_config(smoke=spec["smoke"]), MESH_WORLD,
                seq=spec["seq"])
            moe_whole = full_depth_run(
                "one_process", {}, arch=MIXTRAL_ARCH,
                argv=mesh_argv(spec, MIXTRAL_ARCH, None if spec["smoke"]
                               else MESH_MOE_LAYERS, 2 * spec["seq"],
                               MESH_BATCH), line="mesh",
                lead=_routes_lead(dev, res[0]["e"]["routes"]))
            moe_at, moe_rec = moe_restored_step(dev, spec,
                                                res[0]["e"]["routes"])
            shutil.rmtree(ckpt + "_moe", ignore_errors=True)
            meta = mesh_count_finish(proc, count_json, t_count)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rank_kernel_lines(res, cuda)
    # (a), (b): tensor parallelism against one process on card 0
    for key in ("a", "b"):
        _rank_lines("mesh", res, key, whole, f"tp_{key}", cuda)
    phase("mesh", run="one_process", arch=MESH_ARCH, batch=MESH_BATCH,
          n_micro=1, step_s=",".join(f"{h['time_s']:.3f}"
                                     for h in whole["hist"]),
          max_memory_allocated=whole["peak"])
    # (c): the compressed data-parallel step over NCCL
    dp_report("mesh", [out["c"] for out in res], whole_dp, "4x1")
    for r, out in enumerate(res):
        split = out["c"]["split"] or {}
        phase("mesh", run="dp_compressed", rank=r,
              allreduce_s=",".join(f"{h['allreduce_s']:.4f}"
                                   for h in out["c"]["hist"]),
              payload_bytes=out["c"]["hist"][-1]["payload_bytes"],
              profiled_nccl_s=(f"{split['nccl'] / 1e3:.4f}" if split
                               else "not measured"),
              profiled_device_s=(f"{sum(split.values()) / 1e3:.4f}"
                                 if split else "not measured"))
    # (d): the elastic restore across cards
    for r, out in enumerate(res):
        el = out["d"]
        want = el["straight"]
        for layout, got in el["restored"].items():
            rel = _rel(got["loss"], want["loss"])
            mesh = "x".join(map(str, got["mesh"]))
            phase("mesh", run="elastic", rank=r, saved="2x2", restored=mesh,
                  leaves=got["leaves"], bitwise_leaves=got["leaves"]
                  - len(got["bad"]), placed=got["placed"],
                  step=want["step"], loss=f"{got['loss']:.6f}",
                  loss_2x2=f"{want['loss']:.6f}", loss_rel=f"{rel:.3e}",
                  save_s=f"{el['save_s']:.1f}",
                  restore_s=f"{got['restore_s']:.1f}")
            check(not got["bad"] and got["placed"], f"rank {r} restored at "
                  f"{mesh}: leaves {got['bad'][:3]} differ from the saved "
                  f"ones, placed {got['placed']}")
            check(tuple(got["mesh"]) == tuple(layout)
                  and rel <= DIST_LOSS_RTOL, f"rank {r} at {mesh}: step "
                  f"{want['step']} loss {rel} from the (2, 2) run's")
    # (e): mixtral-8x7b, held as [moe] holds it where both runs have the
    # same weights: at step 1, and at step MESH_MOE_HELD + 1 taken by one
    # process from the mesh's own weights (moe_restored_step): each loss
    # within TRAIN_LOSS_RTOL, each routing difference a near-tie. The
    # free-running one process is held for MESH_MOE_HELD steps: the mesh
    # sums bf16 partial gradients over data (one more rounding of each
    # element than one process), Adam's sign-like first updates turn those
    # ulps into steps of lr on near-0 gradients, and the router's changes
    # flip choices, so by step 3 the two runs are other models (their
    # grad norms 41% apart in the first four-card run, PERF.md §6); that
    # step's free-running loss is printed beside.
    follow_check(moe_whole["routes"], "mesh", MIXTRAL_ARCH,
                 "one_process_follows_mesh", held=1)
    follow_check(moe_rec, "mesh", MIXTRAL_ARCH,
                 f"one_process_at_mesh_weights_step{MESH_MOE_HELD}")
    for r, out in enumerate(res):
        first, at = out["e"]["hist"][0], out["e"]["hist"][MESH_MOE_HELD]
        rels = (_rel(first["loss"], moe_whole["hist"][0]["loss"]),
                _rel(at["loss"], moe_at["loss"]),
                _rel(at["grad_norm"], moe_at["grad_norm"]))
        phase("mesh", run="moe_e", rank=r, step=MESH_MOE_HELD,
              compare="one_process_at_mesh_weights",
              loss=f"{at['loss']:.6f}",
              loss_one_process=f"{moe_at['loss']:.6f}",
              loss_rel=f"{rels[1]:.3e}", grad_norm_rel=f"{rels[2]:.3e}",
              step0_loss_rel=f"{rels[0]:.3e}", limit=TRAIN_LOSS_RTOL)
        check(rels[0] <= TRAIN_LOSS_RTOL and rels[1] <= TRAIN_LOSS_RTOL,
              f"moe_e rank {r}: loss at step 0 {rels[0]}, at step "
              f"{MESH_MOE_HELD} from the same weights {rels[1]} "
              f"(limit {TRAIN_LOSS_RTOL})")
    _rank_lines("mesh", res, "e", moe_whole, "moe_e", cuda,
                held=MESH_MOE_HELD)
    for r, out in enumerate(res):
        phase("mesh", run="moe_e", rank=r, **out["e"]["share"])
    # the count: meta against every card
    mesh_count_report("mesh", meta, res)
    phase("mesh", ranks_seconds=f"{ranks_s:.1f}", **{
        f"{k}_s": f"{res[0][f'{k}_s']:.1f}" for k in spec["phases"]},
          seconds=f"{time.perf_counter() - t0:.1f}")
    launches = collections.Counter()
    for key, tag in (("a", LOCAL_HEADS), ("b", "tp4"), ("e", "tp2_w4096")):
        for name, n in res[0][key]["launches"].items():
            launches[f"{name}_{tag}"] += n
    return launches


def family_kernel_phase(dev):
    """FAMILY_TAGS' kernel cases on card 0, each against its plain
    version, timed beside it and SDPA: a head dim the kernels are built
    for through lm_kernel_phase and bwd_kernel_phase, zamba2's through
    padded_kernel_phase (the wrapper's pad). Returns their rows."""
    from repro_torch.kernels import flash_cuda as fc
    fwd = [c for c in MESH_K5_CASES if c[0] in FAMILY_TAGS]
    bwd = [c for c in MESH_BWD_CASES if c[0] in FAMILY_TAGS]
    table = lm_kernel_phase(dev, [c for c in fwd if c[5] in fc.HEAD_DIMS],
                            small=False)
    table.update(bwd_kernel_phase(
        dev, [c for c in bwd if c[5] in fc.HEAD_DIMS], small=False))
    for f, b in zip(fwd, bwd, strict=True):
        if f[5] not in fc.HEAD_DIMS:
            check(f[2] == f[3] and f[5] == b[5] == ZAMBA_D,
                  f"padded case {f[0]}: H = Hkv and D = {ZAMBA_D} only")
            table.update(padded_kernel_phase(
                dev, (f[0], f[1], f[2], f[4], f[8]),
                (b[0], b[1], b[2], b[4], b[8])))
    return table


def family_spec(**over):
    """What the ranks of --mesh-families run: (f)-(j) on the cards, each
    card checking FAMILY_TAGS' kernel cases first."""
    return mesh_spec(**{"ckpt": str(ROOT / "build" / "mesh_ckpt"),
                        "phases": FAMILY_PHASES, "kernel_tags": FAMILY_TAGS,
                        **over})


def remain_spec(**over):
    """What the ranks of --mesh-remaining run: (m)-(o) and the count of
    (m)'s step, each card checking REMAIN_KERNEL_TAGS' kernel cases and
    the planted control of REMAIN_TAGS first."""
    return mesh_spec(**{"ckpt": str(ROOT / "build" / "mesh_ckpt"),
                        "phases": REMAIN_PHASES,
                        "kernel_tags": REMAIN_KERNEL_TAGS,
                        "kernel_controls": REMAIN_TAGS,
                        "count": "moe_train", "count_ranks": (0, 1, 2, 3),
                        "timeout": REMAIN_TIMEOUT,
                        **over})


def accumulated_grads(model, batch, n_micro=None, dtype=None, faults=()):
    """``train.loop.microbatch_grads``' mean loss and its gradients' global
    norm for a model on one device, over ``n_micro`` microbatches of
    ``batch``'s rows (default: one row a microbatch; every row holds as
    many tokens, so the mean over rows is the mean over any plan's
    microbatches of equal rows, up to float32's order of summation),
    accumulated in ``dtype`` (default float32; a plan's ``grad_dtype``).
    Each microbatch's gradient is added into the accumulator as the
    backward makes it (a parameter's hook), so that no whole set of
    gradients is held beside the accumulator: one card holds
    llama-3.2-vision-90b's group so (two rows at a time and a set of bf16
    gradients beside a float32 accumulator pass 80 GB), and
    deepseek-v3-671b's 4 layers with a bf16 one. The norm is summed a
    slice of each leaf at a time in float32 (a whole float32 copy of
    deepseek's (256, 7168, 2048) expert leaf is 15 GB). Returns (loss,
    norm, {name: norm with the fault planted}) for each of ``faults``
    (GNORM_FAULTS' entries: the leaves they scale, all or the routed
    experts' of rank 0, the first 1 / MESH_WORLD of an expert leaf's
    rows)."""
    import torch

    from repro_torch.train import loop as tl
    dtype = dtype or torch.float32
    params = dict(model.named_parameters())
    acc = {n: torch.zeros_like(p, dtype=dtype) for n, p in params.items()}

    def add(n):
        def hook(p):
            acc[n].add_(p.grad.to(dtype))
            p.grad = None
        return hook

    hooks = [p.register_post_accumulate_grad_hook(add(n))
             for n, p in params.items()]
    n_micro = n_micro or next(iter(batch.values())).shape[0]
    lsum = torch.zeros((), dtype=torch.float32, device=model.device)
    try:
        for mb in tl._split(batch, n_micro):
            model.zero_grad(set_to_none=True)
            loss, _ = model.loss(mb)
            loss.backward()
            lsum = lsum + loss.detach()
    finally:
        for h in hooks:
            h.remove()
    inv = 1.0 / n_micro

    def sq(a):
        out = torch.zeros((), dtype=torch.float32, device=model.device)
        for part in a.reshape(-1).split(1 << 28):
            out = out + torch.sum(part.float().square())
        return out

    total = sum(sq(a.mul_(inv)) for a in acc.values())
    planted = {}
    for name, leaves, scale, _ in faults:
        if leaves is None:
            part = total
        else:
            part = sum(sq(a[:a.shape[0] // MESH_WORLD])
                       for n, a in acc.items()
                       if ".".join(n.split(".")[-2:]).startswith(leaves))
        planted[name] = float(torch.sqrt(total + (scale ** 2 - 1) * part))
    return float(lsum * inv), float(torch.sqrt(total)), planted


def one_row_routes(calls, n_micro, n_experts):
    """Rank 0's route calls of one mesh step (``n_micro`` microbatches, a
    microbatch's calls consecutive, each (G, S, K): one group a data
    rank, group g its row g) as one process makes them taking one row a
    microbatch in a group of its own: row g of microbatch i takes group
    g of each of microbatch i's calls. Each is (choices, me): ``me``
    (E,) the mesh call's mean count a token of each expert over both
    groups, the token fractions of the load-balancing loss, which the
    mesh takes over the whole microbatch (``pair_aux``)."""
    import numpy as np
    per = len(calls) // n_micro
    check(per * n_micro == len(calls), f"{len(calls)} route calls in "
          f"{n_micro} microbatches")
    out = []
    for i in range(n_micro):
        mb = calls[i * per:(i + 1) * per]
        mes = [np.bincount(c.ravel(), minlength=n_experts)
               / (c.shape[0] * c.shape[1]) for c in mb]
        for g in range(mb[0].shape[0]):
            out += [(c[g:g + 1], me) for c, me in zip(mb, mes)]
    return out


@contextlib.contextmanager
def pair_aux(mes):
    """Each ``moe.route`` call of a one-row run, in ``one_row_routes``'
    order, with the load-balancing loss the mesh takes over the row's
    whole microbatch: E * sum(me * ce) / K with the microbatch's token
    fractions ``me`` and the row's own mean gates ``ce``. The mean of a
    microbatch's rows' losses is then the microbatch's, gradients
    included (the fractions are counts: constants)."""
    import torch

    from repro_torch.models import moe
    route = moe.route
    left = iter(mes)

    def paired(p, cfg, x_flat):
        r = route(p, cfg, x_flat)
        gates, _ = moe.selection_scores(p, x_flat)
        me = torch.as_tensor(next(left), dtype=torch.float32,
                             device=gates.device)
        return r._replace(aux=cfg.n_experts * torch.sum(
            me * torch.mean(gates, dim=(0, 1))) / cfg.top_k)

    moe.route = paired
    try:
        yield
    finally:
        moe.route = route


def family_at(dev, argv, prepare, step, ckpt=None, dtype=None, routes=None,
              faults=()):
    """One process's loss and gradient norm (``accumulated_grads``, one
    row a microbatch, no optimizer state) at ``step``'s batch, at the
    seeded weights or, with ``ckpt``, at the weights a mesh run saved
    there after MESH_MOE_HELD steps (read a leaf at a time into the
    model's parameters); its peak and seconds. ``dtype`` is the
    accumulator's (a plan's ``grad_dtype``; default float32); an MoE
    follows ``routes`` (a list a step of the route calls of one-row
    microbatches, ``one_row_routes``) with its microbatches'
    load-balancing losses (``pair_aux``), the recorder's differences
    returned (``rec``); ``faults`` (GNORM_FAULTS' entries) give the
    gradient norms with each planted (``planted``)."""
    from repro_torch.data.pipeline import SyntheticLM, device_batch
    from repro_torch.launch import train as lt
    from repro_torch.models.lm import LM
    from repro_torch.train import checkpoint
    from repro_torch.train import loop as tl
    args = lt.parse(argv)
    cfg = lt.config(args)
    _free()
    _reset_peak(dev)
    model = LM(cfg, device=dev, seed=0, trainable=True)
    if prepare is not None:
        prepare(model)
    if ckpt:
        checkpoint.restore_into(ckpt, MESH_MOE_HELD,
                                {"params": tl.params_of(model)})
    extra = train_inputs(cfg, args.global_batch)
    batch = device_batch({"tokens": SyntheticLM(
        cfg.vocab, args.seq_len, args.global_batch).batch_at(step),
        **(extra(step) if extra else {})}, dev)
    rec = None if routes is None else RoutingRecorder(_routes_lead(
        dev, [[c for c, _ in routes[step]]]))
    t0 = time.perf_counter()
    with rec.hook() if rec else contextlib.nullcontext(), \
            pair_aux([me for _, me in routes[step]]) if rec \
            else contextlib.nullcontext():
        if rec:
            rec.mark()
        loss, gnorm, planted = accumulated_grads(model, batch, dtype=dtype,
                                                 faults=faults)
    out = {"loss": loss, "grad_norm": gnorm, "planted": planted, "rec": rec,
           "s": time.perf_counter() - t0, "peak": _peak(dev)}
    del model, batch
    _free()
    return out


def family_one_process(dev, spec, key, routes=None):
    """On card 0, what (f)-(i)'s and (m)-(o)'s held run is held to: one
    process running the plan's TRAIN_STEPS steps at the held depth (where
    ``free``), and its loss at the mesh's saved weights at step
    MESH_MOE_HELD (and, without ``free``, at the seeded weights at step
    0, where an MoE's GNORM_FAULTS are planted). An MoE run without
    ``free`` ((m)) takes the plan's accumulator dtype, one row a
    microbatch, and follows the mesh's expert choices ``routes`` (rank
    0's, a list a step). Returns (the free-running run or None, {step:
    family_at's record})."""
    import torch

    from repro_torch.launch import train as lt
    fam = FAMILIES[key]
    plan = family_plan(key)
    argv = family_argv(spec, key, fam["held"])
    prepare = family_prepare(fam["arch"])
    whole = (full_depth_run("one_process", {}, arch=fam["arch"], argv=argv,
                            line="mesh", prepare=prepare,
                            quantized=plan.quantized)
             if fam["free"] else None)
    kw, faults = {}, ()
    if not fam["free"] and is_moe(fam["arch"]):
        n_experts = lt.config(lt.parse(argv)).n_experts
        kw = dict(dtype=getattr(torch, plan.grad_dtype), routes=[
            one_row_routes(calls, plan.n_micro, n_experts)
            for calls in routes])
        faults = GNORM_FAULTS
    at = ({} if fam["free"] else
          {0: family_at(dev, argv, prepare, 0, faults=faults, **kw)})
    at[MESH_MOE_HELD] = family_at(dev, argv, prepare, MESH_MOE_HELD,
                                  spec["ckpt"] + f"_{key}", **kw)
    return whole, at


def family_report(tag, res, key, whole, at, cuda=True):
    """(f)-(i)'s and (m)-(o)'s lines and checks: on every rank, each
    run's launches a step (K5 twice a flash layer a microbatch, K6 and K7
    once: the
    forward, the remat recompute, the backward) on a card, its peak under
    MESH_PEAK; the held run's steps against one process (free-running:
    the steps before MESH_MOE_HELD within DIST_LOSS_RTOL; at the same
    weights within TRAIN_LOSS_RTOL); the timed run's step time, tokens a
    second, NCCL's device time in the profiled step and peak; under fsdp,
    the matrices sharded over data on a dim model does not split. Without
    ``free`` ((i), (m)) the gradient norm at the same weights too, within
    TRAIN_GNORM_RTOL, and each planted fault's norm (``planted``) beyond
    it where GNORM_FAULTS says it must be. Each step's line is printed
    before its checks. An MoE run ((m)) also shows
    each rank's dispatch groups, its experts and the share of their kept
    choices from its own data rows (``moe_share``), and, where the one
    process followed the mesh's choices, each difference a near-tie
    (``follow_check``)."""
    from repro_torch.kernels import flash_cuda as fc
    fam = FAMILIES[key]
    arch, plan, what = fam["arch"], family_plan(key), f"family_{key}"
    for r, out in enumerate(res):
        timed = out[key]["timed"]
        held = out[key].get("held", timed)
        mesh = "x".join(map(str, timed["mesh"]))
        for run in (timed, held) if held is not timed else (timed,):
            n, nm = run["flash_layers"], run["n_micro"]
            want = {fc.NAME: 2 * n * nm, fc.DQ: n * nm, fc.DKV: n * nm}
            for h in run["hist"]:
                got = {k: h["launches"].get(k, 0) for k in want}
                check(not cuda or got == want, f"{what} {arch} at "
                      f"{run['layers']} layers, rank {r} step {h['step']}: "
                      f"launches {got}, want {want}")
            check(run["peak"] < MESH_PEAK, f"{what} rank {r}: peak "
                  f"{run['peak']} bytes")
        for h in held["hist"]:
            s = h["step"]
            cmp, fails = {}, []
            if whole is not None:
                w = whole["hist"][s]
                rel = _rel(h["loss"], w["loss"])
                limit = DIST_LOSS_RTOL if s < MESH_MOE_HELD else "not_held"
                cmp.update(loss_one_process=f"{w['loss']:.6f}",
                           loss_rel_vs_one_process=f"{rel:.3e}",
                           grad_norm_rel_vs_one_process=(
                               f"{_rel(h['grad_norm'], w['grad_norm']):.3e}"),
                           limit=limit)
                if limit != "not_held" and rel > DIST_LOSS_RTOL:
                    fails.append(f"loss {rel} from one process")
            if s in at:
                a = at[s]
                rel = _rel(h["loss"], a["loss"])
                cmp.update(compare="one_process_at_mesh_weights",
                           loss_at_same_weights=f"{a['loss']:.6f}",
                           loss_rel_at_same_weights=f"{rel:.3e}",
                           grad_norm_rel_at_same_weights=(
                               f"{_rel(h['grad_norm'], a['grad_norm']):.3e}"),
                           same_weights_limit=TRAIN_LOSS_RTOL)
                if rel > TRAIN_LOSS_RTOL:
                    fails.append(f"loss {rel} from one process at the same "
                                 f"weights")
                if not fam["free"]:
                    g_rel = _rel(h["grad_norm"], a["grad_norm"])
                    cmp.update(same_weights_grad_norm_limit=(
                        f"{TRAIN_GNORM_RTOL:.3e}"))
                    if g_rel > TRAIN_GNORM_RTOL:
                        fails.append(f"grad norm {g_rel} from one process at "
                                     f"the same weights (limit "
                                     f"{TRAIN_GNORM_RTOL})")
                    for name, _, _, must in GNORM_FAULTS:
                        if name not in a.get("planted", {}):
                            continue
                        f_rel = _rel(h["grad_norm"], a["planted"][name])
                        cmp[f"control_{name}_rel"] = f"{f_rel:.3e}"
                        cmp[f"control_{name}"] = (
                            "rejected" if f_rel > TRAIN_GNORM_RTOL
                            else "within_limit")
                        cmp[f"control_{name}_must_fail"] = must
                        if must and f_rel <= TRAIN_GNORM_RTOL:
                            fails.append(f"planted {name}: grad norm "
                                         f"{f_rel} from one process, within "
                                         f"{TRAIN_GNORM_RTOL}")
            phase(tag, run=what, arch=arch, mesh=mesh, rank=r, step=s,
                  n_layers=held["layers"], loss=f"{h['loss']:.6f}",
                  grad_norm=f"{h['grad_norm']:.6f}", **cmp,
                  time_s=f"{h['time_s']:.3f}",
                  launches=json.dumps(h["launches"], separators=(",", ":")))
            check(not fails, f"{what} {arch} rank {r} step {s}: "
                  f"{'; '.join(fails)}")
        wall = timed["hist"][-1]["time_s"]
        split = timed["split"] or {}
        phase(tag, run=what, arch=arch, mesh=mesh, rank=r,
              device=out["device"], n_layers=timed["layers"],
              held_layers=held["layers"], n_micro=plan.n_micro,
              fsdp=plan.fsdp, quantized_state=plan.quantized,
              params=timed["params"], tokens_per_step=timed["tokens"],
              init_s=f"{timed['init_s']:.3f}",
              step_s=",".join(f"{h['time_s']:.3f}" for h in timed["hist"]),
              tokens_per_s=f"{timed['tokens'] / wall:.1f}",
              tokens_per_s_per_card=(
                  f"{timed['tokens'] / wall / MESH_WORLD:.1f}"),
              nccl_s=(f"{split['nccl'] / 1e3:.4f}" if split
                      else "not measured"),
              device_s=(f"{sum(split.values()) / 1e3:.4f}" if split
                        else "not measured"),
              **{f"profiled_{k}_ms": f"{v:.3f}" for k, v in split.items()},
              max_memory_allocated=timed["peak"],
              held_max_memory_allocated=held["peak"],
              fsdp_leaves=len(timed["fsdp_leaves"]),
              fsdp_example=(timed["fsdp_leaves"] or ["none"])[0],
              moe_groups=timed["moe_groups"],
              ep_axes=",".join(timed["ep_axes"] or ()) or "none",
              grad_dtype=timed["grad_dtype"] or "float32",
              launches=json.dumps(timed["launches"], separators=(",", ":")))
        check(not plan.fsdp or timed["fsdp_leaves"], f"{what} rank {r}: "
              f"fsdp, and no matrix is sharded over data")
        if "share" in timed:
            phase(tag, run=what, arch=arch, rank=r, **timed["share"])
    for s, a in at.items():
        follow_check(a.get("rec"), tag, arch,
                     f"{what}_one_process_follows_mesh_step{s}")
    peaks = {s: a["peak"] for s, a in at.items()}
    phase(tag, run=f"{what}_one_process", arch=arch,
          n_layers=res[0][key].get("held", res[0][key]["timed"])["layers"],
          n_micro=plan.n_micro, free_running=whole is not None,
          step_s=(",".join(f"{h['time_s']:.3f}" for h in whole["hist"])
                  if whole else "not run"),
          max_memory_allocated=whole["peak"] if whole else "not run",
          same_weights_steps=",".join(map(str, at)),
          same_weights_s=",".join(f"{a['s']:.3f}" for a in at.values()),
          same_weights_peak=json.dumps(peaks, separators=(",", ":")))


def supervisor_report(tag, res, cuda=True):
    """(j)'s lines and checks on every rank: the history's steps equal
    SUP_HISTORY, the final state the uninterrupted run's bit for bit, the
    latest checkpoint and the optimizer's step SUP_STEPS, K5-K7 launched
    as many times as the steps run (SUP_HISTORY's length) need, the peak
    under MESH_PEAK."""
    from repro_torch.kernels import flash_cuda as fc
    for r, out in enumerate(res):
        j = out["j"]
        n, nm = j["flash_layers"], j["n_micro"]
        runs = len(j["steps"])
        want = {fc.NAME: 2 * n * nm * runs, fc.DQ: n * nm * runs,
                fc.DKV: n * nm * runs}
        got = {k: j["launches"].get(k, 0) for k in want}
        phase(tag, run="supervisor_j", rank=r, mesh="x".join(
            map(str, FAMILY_LAYOUT)), n_micro=nm, quantized_state=True,
              tokens_per_step=j["tokens"],
              steps=",".join(map(str, j["steps"])),
              want_steps=",".join(map(str, SUP_HISTORY)),
              leaves=j["leaves"], bitwise_leaves=j["leaves"] - len(j["bad"]),
              compare="uninterrupted_run", latest_checkpoint=j["latest"],
              opt_step=j["opt_step"],
              losses=",".join(f"{h['loss']:.6f}" for h in j["hist"]),
              step_s=",".join(f"{h['time_s']:.3f}" for h in j["hist"]),
              wall_s=f"{j['wall_s']:.1f}", max_memory_allocated=j["peak"],
              launches=json.dumps(got, separators=(",", ":")))
        check(j["steps"] == SUP_HISTORY, f"supervisor rank {r}: steps "
              f"{j['steps']}, want {SUP_HISTORY}")
        check(not j["bad"], f"supervisor rank {r}: leaves {j['bad'][:3]} "
              f"differ from the uninterrupted run's")
        check(j["latest"] == SUP_STEPS and j["opt_step"] == SUP_STEPS,
              f"supervisor rank {r}: latest checkpoint {j['latest']}, "
              f"optimizer step {j['opt_step']}")
        check(not cuda or got == want, f"supervisor rank {r}: launches "
              f"{got}, want {want}")
        check(j["peak"] < MESH_PEAK, f"supervisor rank {r}: peak "
              f"{j['peak']} bytes")


def family_phases(dev, spec=None):
    """--mesh-families (and --mesh-remaining) on MESH_WORLD cards
    (``spec``, default ``family_spec()``; ``remain_spec()``): the meta
    count's process where the phases count, the ranks (each its card's
    local-head kernel checks, then the runs (f)-(i) and (j), or (m)-(o)
    and the count), then on card 0 the one-process runs they are held
    to, and the checks. Returns the launches of the local-head rows:
    each run's timed run's on rank 0."""
    from repro_torch.launch import ranks
    t0 = time.perf_counter()
    spec = spec or family_spec()
    cuda = spec["device"] == "cuda"
    runs = [k for k in FAMILIES if k in spec["phases"]]
    # every phase's checkpoints ((j)'s too: its Supervisor resumes from
    # whatever checkpoint it finds), before and after the runs
    dirs = [spec["ckpt"] + f"_{k}" for k in spec["phases"]]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    _free()
    init = ROOT / "build" / "mesh_rdzv"
    init.unlink(missing_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        count_json = str(Path(tmp) / "count.json")
        t_count = time.perf_counter()
        proc = (mesh_count_start(count_json, spec)
                if "count" in spec["phases"] else None)
        t1 = time.perf_counter()
        try:
            res = ranks.run_ranks(_mesh_rank, MESH_WORLD, str(init), (spec,),
                                  timeout=spec.get("timeout", MESH_TIMEOUT))
            ranks_s = time.perf_counter() - t1
            init.unlink(missing_ok=True)
            # the one-process runs on card 0, once the ranks have left it;
            # a run's failure is reported after every run's lines
            t1 = time.perf_counter()
            held, failed = {}, {}
            for k in runs:
                try:
                    held[k] = family_one_process(
                        dev, spec, k, res[0][k]["timed"].get("routes"))
                except Exception as e:          # noqa: BLE001
                    failed[k] = f"{type(e).__name__}: {e}"[:2000]
                    held[k] = (None, {})
                    # after a device-side assert every CUDA call raises:
                    # the ranks' lines are still printed below
                    with contextlib.suppress(Exception):
                        _free()
            one_s = time.perf_counter() - t1
            meta = (mesh_count_finish(proc, count_json, t_count)
                    if proc else None)
        finally:
            for d in dirs:
                shutil.rmtree(d, ignore_errors=True)
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    rank_kernel_lines(res, cuda)
    # every run's lines before any failure ends the script
    reports = [(k, lambda k=k: family_report("mesh", res, k, *held[k],
                                             cuda)) for k in held]
    if "j" in spec["phases"]:
        reports.append(("j", lambda: supervisor_report("mesh", res, cuda)))
    if meta is not None:
        reports.append(("count", lambda: mesh_count_report("mesh", meta,
                                                           res)))
    for key, report in reports:
        try:
            report()
        except Exception as e:              # noqa: BLE001
            failed[key] = f"{type(e).__name__}: {e}"[:2000]
    check(not failed, f"[mesh] families failed: {failed}")
    phase("mesh", families=",".join(spec["phases"]),
          ranks_seconds=f"{ranks_s:.1f}", one_process_seconds=f"{one_s:.1f}",
          **{f"{k}_s": f"{res[0][f'{k}_s']:.1f}" for k in spec["phases"]},
          seconds=f"{time.perf_counter() - t0:.1f}")
    launches = collections.Counter()
    for key in held:
        for name, n in res[0][key]["timed"]["launches"].items():
            if FAMILIES[key]["tag"]:
                launches[f"{name}_{FAMILIES[key]['tag']}"] += n
    return launches


# --- --mesh-serve: serving on four cards, one NCCL rank a card ----------------
# (k) llama3-8b whole (SERVE_ARCH, bf16, seeded weights) on each of
# SERVE_LAYOUTS with the [serve] phase's traffic (SERVE_REQUESTS requests of
# SERVE_PROMPT tokens in waves of SERVE_SLOTS, SERVE_NEW new tokens) through
# Engine, K5 on each rank's local heads in every prefill (``tp4_serve``: (1,
# 4), B 4, H 8, Hkv 2; ``tp2_serve``: (2, 2), B 2, H 16, Hkv 4; S up to 2048),
# held to one process on card 0 teacher-forced on the mesh run's tokens
# (LOGIT_TOL; a differing argmax a near-tie of the one process); then
# SERVE_F32_LAYERS layers in float32 on (1, 4) at F32_LOGIT_TOL of one
# process, whose control (a decode that writes no k/v into the cache, what
# a sequence-split cache's lost writes did) must lie beyond it. (l)
# deepseek-v3-671b at [moe]'s DEEPSEEK_SERVE_LAYERS on SERVE_MLA_LAYOUT (its
# latent cache split over T on every card), DEEPSEEK_PROMPT tokens and
# DEEPSEEK_NEW new ones, held to one process (its MoE dispatch in the mesh's
# batch shards, moe_groups 2) that follows the mesh's expert choices (each
# difference a near-tie, ROUTE_TIE_TOL) at LOGIT_TOL; then MLA's decode
# invariant on the mesh at MLA_CHECK's size (MLA_B, MLA_S, MLA_TOL), whose
# control with the decode's write dropped must fail it. The count: one (2,
# 2) decode step of (k)'s model at MESH_SHORT layers (einsum attention),
# SERVE_SLOTS rows against a cache of SERVE_COUNT_LEN.
SERVE_MESH_FLAG = "--mesh-serve"
SERVE_LAYOUTS = {"tp4_serve": (1, 4), "tp2_serve": (2, 2)}
SERVE_TAGS = tuple(SERVE_LAYOUTS)
MESH_K5_CASES += [("tp4_serve", 4, 8, 2, 2048, 128, "bfloat16", None, 10),
                  ("tp2_serve", 2, 16, 4, 2048, 128, "bfloat16", None, 10)]
SERVE_F32_LAYERS = 2
SERVE_MLA_LAYOUT = (2, 2)
SERVE_COUNT_LEN = 4096


def serve_kernel_phase(dev):
    """SERVE_TAGS' K5 cases on card 0 against K5's plain version, timed
    beside it and SDPA. Returns their rows."""
    return lm_kernel_phase(dev, [c for c in MESH_K5_CASES
                                 if c[0] in SERVE_TAGS], small=False)


def serve_mesh_spec(**over):
    """What the ranks of --mesh-serve run: (k), (l) and the count (of a
    decode step), each card checking SERVE_TAGS' kernel cases first; the
    traffic (``serve``: prompt lengths and new tokens of (k); ``mla``:
    (l)'s), the SMOKE configs with ``smoke`` (the CPU rehearsal's)."""
    spec = mesh_spec(phases=("k", "l", "count"), kernel_tags=SERVE_TAGS,
                     count="decode", serve=(SERVE_PROMPT, SERVE_NEW),
                     mla=(DEEPSEEK_PROMPT, DEEPSEEK_NEW))
    spec.update(over)
    return spec


def serve_mesh_config(spec, arch=SERVE_ARCH, **over):
    """``arch``'s configuration for --mesh-serve (flash attention, the
    SMOKE one with ``spec["smoke"]``), with ``over``."""
    from repro_torch.configs import registry
    if spec["smoke"]:
        return registry.smoke_config(arch, attn_impl="flash", **{
            k: v for k, v in over.items() if k != "n_layers"})
    return registry.config(arch, attn_impl="flash", **over)


def serve_mesh_model(dev, cfg, mesh):
    """``cfg``'s model with the seeded weights (seed 0, as one process
    draws them on card 0) on ``dev``, its parameters laid out on ``mesh``
    by the sharding rules (each rank keeps its slices)."""
    from repro_torch.models.lm import LM
    from repro_torch.sharding import rules
    from repro_torch.train import loop as tl
    model = LM(cfg, device=dev, seed=0)
    tl.distribute_model(model, rules.params_shardings(
        tl.params_of(model), mesh, stacks=model.stack_dims()))
    _free()
    return model


@contextlib.contextmanager
def decode_writes_dropped():
    """Every one-row cache write (a decode step's) dropped: what a cache
    split over its sequence dim did with DTensor's slice assignment
    before ``layers.write_seq`` (the controls)."""
    from repro_torch.models import layers
    orig = layers.write_seq

    def write(cache, idx, new):
        if new.shape[1] != 1:
            orig(cache, idx, new)

    layers.write_seq = write
    try:
        yield
    finally:
        layers.write_seq = orig


def _whole(t):
    """A logits or tokens DTensor read whole (a collective: every rank
    calls it), as a float32 or int64 numpy array."""
    import torch
    from torch.distributed.tensor import DTensor
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


def _serve_mesh_run(dev, spec, layout, cfg, traffic, routes=False,
                    after=None):
    """``cfg``'s model on this rank's mesh of ``layout``, ``traffic``'s
    SERVE_REQUESTS requests (prompt lengths, new tokens) through
    ``Engine`` in waves of SERVE_SLOTS: the launches (counted over the
    run), the results, every call's inputs and seconds, the logits read
    whole (kept on rank 0), the peak, then (``spec["profile"]``) the
    device time of the last wave's prefill and of PROFILE_STEPS decode
    steps by torch.profiler, NCCL's kernels (waits included) apart. An
    MoE model's routing is recorded (``routes``); ``after(model, calls,
    max_len)`` adds its result before the model is freed."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_cuda as fc
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.engine import Engine
    mesh = make_host_mesh(layout[1], device=dev.type)
    check(tuple(mesh.shape) == tuple(layout),
          f"mesh {tuple(mesh.shape)}, wanted {layout}")
    rank = torch.distributed.get_rank()
    _reset_peak(dev)
    t0 = time.perf_counter()
    model = serve_mesh_model(dev, cfg, mesh)
    _sync(dev)
    init_s = time.perf_counter() - t0
    build_peak = _peak(dev)
    _reset_peak(dev)
    prompt, new = traffic
    lengths, reqs = serve_requests(cfg.vocab, prompt, new)
    max_len = int(lengths.max()) + new
    rr = RoutingRecorder() if routes else None
    rec = RecordingLM(model, rr.mark if rr else None)
    eng = Engine(rec, batch_slots=SERVE_SLOTS, max_len=max_len)
    with rr.hook() if rr else contextlib.nullcontext():
        # the main path: counts set to 0 just before, read just after
        fc.reset_launches()
        t0 = time.perf_counter()
        results = eng.serve(reqs)
        _sync(dev)
        serve_s = time.perf_counter() - t0
        launches = dict(fc.LAUNCHES)
    peak = _peak(dev)
    out = {"mesh": tuple(mesh.shape), "layers": cfg.n_layers,
           "dtype": cfg.dtype, "flash_layers": flash_layers(model),
           "params": sum(p.numel() for p in model.parameters()),
           "lengths": [int(n) for n in lengths], "max_len": max_len,
           "launches": launches, "peak": peak, "build_peak": build_peak,
           "init_s": init_s,
           "serve_s": serve_s,
           "results": [(r.uid, r.tokens.tolist()) for r in results],
           "calls": [dict(kind=c["kind"], seconds=c["seconds"],
                          tokens=(c["tokens"] if c["kind"] == "prefill"
                                  else _whole(c["tokens"])))
                     for c in rec.calls]}
    logits = [_whole(c["logits"]) for c in rec.calls]
    out["logits"] = logits if rank == 0 else None
    if rr is not None:
        out["routes"] = ([[c.cpu().numpy().astype(np.int16) for c in call]
                          for call in rr.calls if call] if rank == 0
                         else None)
    if after is not None:
        out.update(after(model, rec.calls, max_len))
    del logits, rec, eng
    out["split"] = None
    if spec["profile"]:
        last = [c for c in out["calls"] if c["kind"] == "prefill"][-1]
        state = {}

        def prefill():
            state["logits"], state["cache"] = model.prefill(last["tokens"],
                                                            max_len)

        def decode():
            tok = torch.argmax(state["logits"], dim=-1)
            for _ in range(PROFILE_STEPS):
                logits, state["cache"] = model.decode(state["cache"], tok)
                tok = torch.argmax(logits, dim=-1)

        out["split"] = {"prefill": device_ms(prefill),
                        "decode": device_ms(decode)}
        del state
    del model
    _free()
    return out


def _f32_control(model, calls, max_len):
    """The float32 run's control on the mesh: its calls replayed with
    every decode step's k/v write dropped, the logits read whole."""
    import torch
    with decode_writes_dropped():
        logits = teacher_forced(model, calls, max_len)
    rank = torch.distributed.get_rank()
    whole = [_whole(t) for t in logits]
    return {"control_logits": whole if rank == 0 else None}


def _serve_mesh_dense(dev, spec):
    """(k) on this rank: llama3-8b whole on each of SERVE_LAYOUTS in bf16,
    then SERVE_F32_LAYERS layers in float32 on (1, 4) with its control."""
    out = {}
    cfg = serve_mesh_config(spec)
    for tag, layout in SERVE_LAYOUTS.items():
        out[tag] = _serve_mesh_run(dev, spec, layout, cfg, spec["serve"])
    out["f32"] = _serve_mesh_run(
        dev, spec, SERVE_LAYOUTS["tp4_serve"],
        serve_mesh_config(spec, n_layers=SERVE_F32_LAYERS, dtype="float32"),
        spec["serve"], after=_f32_control)
    return out


@contextlib.contextmanager
def dropped_choices(counts):
    """Append each ``moe.route`` call's number of choices dropped past
    capacity to ``counts``."""
    from repro_torch.models import moe
    route = moe.route

    def counting(p, cfg, x_flat, **kw):
        r = route(p, cfg, x_flat, **kw)
        counts.append(int((~r.keep).sum()))
        return r

    moe.route = counting
    try:
        yield
    finally:
        moe.route = route


def mla_mesh_check(dev, spec):
    """MLA's decode invariant on this rank's SERVE_MLA_LAYOUT mesh in
    float32 at MLA_CHECK's size: the absorbed decode of token MLA_S after
    a prefill of MLA_S tokens against the prefill of MLA_S + 1 (the latent
    cache split over T), the MoE choices dropped past capacity in them,
    and the same with the decode's write dropped (the control); K5's
    launches over both."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_cuda as fc
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import rules
    mesh = make_host_mesh(SERVE_MLA_LAYOUT[1], device=dev.type)
    # the invariant needs the MoE to drop no choice: MLA_CHECK's capacity
    # factor keeps one group of MLA_B x MLA_S tokens whole, and the mesh
    # dispatches each of its batch shards as a group of its own
    groups = rules.batch_groups(mesh, MLA_B)
    cfg = serve_mesh_config(spec, DEEPSEEK_ARCH, **dict(
        MLA_CHECK, capacity_factor=MLA_CHECK["capacity_factor"] * groups))
    _reset_peak(dev)
    t0 = time.perf_counter()
    model = serve_mesh_model(dev, cfg, mesh)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        1, cfg.vocab, (MLA_B, MLA_S + 1)), device=dev)
    dropped_counts = []
    fc.reset_launches()
    with dropped_choices(dropped_counts):
        _, cache = model.prefill(toks[:, :MLA_S], MLA_S + 4)
        inc, _ = model.decode(cache, toks[:, MLA_S])
        full, _ = model.prefill(toks, MLA_S + 4)
    with decode_writes_dropped():
        _, cache = model.prefill(toks[:, :MLA_S], MLA_S + 4)
        dropped, _ = model.decode(cache, toks[:, MLA_S])
    launches = sum(fc.LAUNCHES.values())
    inc, full, dropped = (_whole(t) for t in (inc, full, dropped))
    out = {"decode_vs_prefill": float(np.abs(inc - full).max()),
           "control_decode_write_dropped": float(np.abs(dropped
                                                        - full).max()),
           "max_abs_logit": float(np.abs(full).max()),
           "finite": bool(np.isfinite(inc).all() and np.isfinite(full).all()),
           "launches": launches, "layers": cfg.n_layers,
           "capacity_factor": cfg.capacity_factor,
           "dropped_choices": sum(dropped_counts),
           "seconds": time.perf_counter() - t0, "peak": _peak(dev)}
    del model, cache
    _free()
    return out


def _serve_mesh_mla(dev, spec):
    """(l) on this rank: deepseek-v3-671b at DEEPSEEK_SERVE_LAYERS on
    SERVE_MLA_LAYOUT through Engine, its routing recorded; then MLA's
    decode invariant on the mesh."""
    cfg = serve_mesh_config(spec, DEEPSEEK_ARCH,
                            n_layers=DEEPSEEK_SERVE_LAYERS)
    out = _serve_mesh_run(dev, spec, SERVE_MLA_LAYOUT, cfg, spec["mla"],
                          routes=True)
    out["mla_check"] = mla_mesh_check(dev, spec)
    return out


MESH_RUNS.update(k=_serve_mesh_dense, l=_serve_mesh_mla)


def _held(got, want, tol):
    """``compare_runs`` of two runs' logits, its failure kept (reported
    after every line is printed) rather than raised."""
    try:
        return compare_runs(got, want, tol), None
    except SmokeFailure as e:
        return None, str(e)


def serve_one_process(dev, spec, res):
    """On card 0, once the ranks have left it, what (k) and (l) are held
    to: one process with the same seeded weights, teacher-forced on rank
    0's calls — (k) bf16 at full depth for each layout, float32 at
    SERVE_F32_LAYERS (and the mesh's control against it); (l) with its
    MoE dispatch in the mesh's batch shards (``rules.batch_groups``),
    following the mesh's expert choices."""
    import dataclasses

    import torch

    from repro_torch.models.lm import LM
    from repro_torch.sharding import rules
    k, ll = res[0]["k"], res[0]["l"]
    out = {}

    def held(model, run, lead=None, tol=LOGIT_TOL):
        want, rr = replay(model, run["calls"], run["max_len"], lead=lead)
        got = [torch.as_tensor(x, device=dev) for x in run["logits"]]
        stats, failure = _held(got, want, tol)
        by_kind = {kind: max((float((g - w).abs().max()) for g, w, c in zip(
            got, want, run["calls"]) if c["kind"] == kind), default=0.0)
            for kind in ("prefill", "decode")}
        return {"stats": stats, "failure": failure, "by_kind": by_kind,
                "err": max_diff(got, want), "routes": rr,
                "max_abs_logit": max(float(w.abs().max()) for w in want)}

    t0 = time.perf_counter()
    _reset_peak(dev)
    model = LM(serve_mesh_config(spec), device=dev, seed=0)
    for tag in SERVE_LAYOUTS:
        out[tag] = held(model, k[tag])
    out["peak"] = _peak(dev)
    del model
    _free()
    model = LM(serve_mesh_config(spec, n_layers=SERVE_F32_LAYERS,
                                 dtype="float32"), device=dev, seed=0)
    out["f32"] = held(model, k["f32"], tol=F32_LOGIT_TOL)
    want, _ = replay(model, k["f32"]["calls"], k["f32"]["max_len"])
    out["f32"]["control"] = max_diff(
        [torch.as_tensor(x, device=dev) for x in k["f32"]["control_logits"]],
        want)
    del model, want
    _free()
    cfg = serve_mesh_config(spec, DEEPSEEK_ARCH,
                            n_layers=DEEPSEEK_SERVE_LAYERS)
    groups = rules.batch_groups(dict(zip(("data", "model"),
                                         SERVE_MLA_LAYOUT)), SERVE_SLOTS)
    model = LM(dataclasses.replace(cfg, moe_groups=groups), device=dev,
               seed=0)
    out["l"] = held(model, ll, lead=_routes_lead(dev, ll["routes"]))
    out["l"]["groups"] = groups
    del model
    _free()
    out["seconds"] = time.perf_counter() - t0
    return out


def serve_mesh_report(tag, res, one, cuda=True):
    """(k)'s and (l)'s lines and checks: every rank's results equal rank
    0's, its launches (K5 once a GQA layer a wave on the card, none on
    MLA's path, K6 and K7 never), its peak under MESH_PEAK; prefill
    seconds a wave, decode ms a step, tokens a second and NCCL's profiled
    seconds; the logits against one process (bf16 LOGIT_TOL, float32
    F32_LOGIT_TOL with its control beyond it), (l)'s routing differences
    near-ties and MLA's decode invariant with its control."""
    import numpy as np

    from repro_torch.kernels import flash_cuda as fc
    waves = -(-SERVE_REQUESTS // SERVE_SLOTS)
    runs = {t: lambda o, t=t: o["k"][t] for t in SERVE_LAYOUTS}
    runs.update(f32=lambda o: o["k"]["f32"], mla=lambda o: o["l"])
    for what, run_of in runs.items():
        for r, out in enumerate(res):
            run = run_of(out)
            pre = [c["seconds"] for c in run["calls"]
                   if c["kind"] == "prefill"]
            dec = [c["seconds"] for c in run["calls"]
                   if c["kind"] == "decode"]
            n_tok = sum(len(t) for _, t in run["results"])
            split = run["split"] or {}
            nccl = {k: f"{v['nccl'] / 1e3:.4f}" if v else "not recorded"
                    for k, v in split.items()}
            busy = {k: f"{sum(v.values()) / 1e3:.4f}" if v
                    else "not recorded" for k, v in split.items()}
            phase(tag, run="serve_l" if what == "mla" else "serve_k",
                  case=what, mesh="x".join(map(str, run["mesh"])), rank=r,
                  layers=run["layers"], dtype=run["dtype"],
                  params=run["params"], requests=SERVE_REQUESTS,
                  slots=SERVE_SLOTS, waves=waves,
                  prompt_lengths=",".join(map(str, run["lengths"])),
                  max_len=run["max_len"], init_s=f"{run['init_s']:.3f}",
                  serve_s=f"{run['serve_s']:.3f}", tokens=n_tok,
                  tokens_per_s=f"{n_tok / run['serve_s']:.2f}",
                  prefill_s_per_wave=",".join(f"{x:.4f}" for x in pre),
                  decode_steps=len(dec),
                  decode_ms_median=f"{1e3 * float(np.median(dec)):.3f}",
                  decode_ms_max=f"{1e3 * max(dec):.3f}",
                  prefill_nccl_s=nccl.get("prefill", "not measured"),
                  prefill_device_s=busy.get("prefill", "not measured"),
                  decode_nccl_s=nccl.get("decode", "not measured"),
                  decode_device_s=busy.get("decode", "not measured"),
                  profiled_decode_steps=PROFILE_STEPS,
                  build_peak=run["build_peak"],
                  max_memory_allocated=run["peak"],
                  launches=json.dumps(run["launches"],
                                      separators=(",", ":")))
            check(run["results"] == run_of(res[0])["results"],
                  f"{what} rank {r}: results differ from rank 0's")
            got = run["launches"]
            want = run["flash_layers"] * waves if cuda else 0
            check(got[fc.NAME] == want and got[fc.DQ] == got[fc.DKV] == 0,
                  f"{what} rank {r}: launches {got}, K5 wanted {want}")
            check(run["peak"] < MESH_PEAK and run["build_peak"] < MESH_PEAK,
                  f"{what} rank {r}: peak {run['peak']} bytes, at build "
                  f"{run['build_peak']}")
    for what in runs:
        o = one["l" if what == "mla" else what]
        st = o["stats"] or {}
        phase(tag, run="serve_l" if what == "mla" else "serve_k", case=what,
              compare="one_process", moe_groups=o.get("groups"),
              compared_rows=st.get("rows"),
              max_abs_logit=f"{o['max_abs_logit']:.4f}",
              max_logit_err_vs_one_process=f"{o['err']:.4e}",
              prefill_max_logit_err=f"{o['by_kind']['prefill']:.4e}",
              decode_max_logit_err=f"{o['by_kind']['decode']:.4e}",
              control_decode_write_dropped=(f"{o['control']:.4e}"
                                            if "control" in o else None),
              logit_tol=F32_LOGIT_TOL if what == "f32" else LOGIT_TOL,
              near_ties=st.get("near_ties"),
              max_near_tie_gap=(f"{st['max_tie_gap']:.4e}" if st else None),
              failure=o["failure"])
    follow_check(one["l"]["routes"], tag, DEEPSEEK_ARCH,
                 "one_process_follows_mesh")
    for r, out in enumerate(res):
        m = out["l"]["mla_check"]
        phase(tag, run="serve_l", check="mla_decode", rank=r,
              dtype="float32", layers=m["layers"], B=MLA_B, s=MLA_S,
              max_abs_logit=f"{m['max_abs_logit']:.4f}",
              decode_vs_prefill=f"{m['decode_vs_prefill']:.4e}",
              control_decode_write_dropped=(
                  f"{m['control_decode_write_dropped']:.4e}"),
              tol=MLA_TOL, launches=m["launches"],
              capacity_factor=m["capacity_factor"],
              dropped_choices=m["dropped_choices"],
              seconds=f"{m['seconds']:.1f}", max_memory_allocated=m["peak"])
        check(m["dropped_choices"] == 0, f"rank {r}: the MoE dropped "
              f"{m['dropped_choices']} choices in the MLA check")
        check(m["finite"] and m["decode_vs_prefill"] <= MLA_TOL,
              f"rank {r}: MLA decode vs prefill {m['decode_vs_prefill']}")
        check(m["control_decode_write_dropped"] > MLA_TOL, f"rank {r}: the "
              f"MLA control lies within {MLA_TOL}")
        check(m["launches"] == 0, f"rank {r}: MLA launched a flash kernel")
        check(m["peak"] < MESH_PEAK, f"rank {r}: MLA check peak {m['peak']}")
    for what in runs:
        o = one["l" if what == "mla" else what]
        check(o["failure"] is None, f"{what} against one process: "
              f"{o['failure']}")
    f32 = one["f32"]
    check(f32["control"] > F32_LOGIT_TOL, f"(k) float32: the control (no "
          f"decode write) lies within {F32_LOGIT_TOL}: {f32['control']}")


def serve_mesh_phases(dev, spec=None):
    """--mesh-serve on MESH_WORLD cards (``spec``, default
    ``serve_mesh_spec()``): the meta count's process, the ranks (each its
    card's SERVE_TAGS kernel checks, then (k), (l) and the count), then on
    card 0 the one-process runs they are held to, and the checks. Returns
    the launches of the SERVE_TAGS rows: (k)'s bf16 runs' on rank 0."""
    from repro_torch.launch import ranks
    t0 = time.perf_counter()
    spec = spec or serve_mesh_spec()
    cuda = spec["device"] == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        count_json = str(Path(tmp) / "count.json")
        t_count = time.perf_counter()
        proc = mesh_count_start(count_json, spec)
        try:
            _free()
            init = ROOT / "build" / "mesh_rdzv"
            init.unlink(missing_ok=True)
            t1 = time.perf_counter()
            res = ranks.run_ranks(_mesh_rank, MESH_WORLD, str(init), (spec,),
                                  timeout=MESH_TIMEOUT)
            ranks_s = time.perf_counter() - t1
            init.unlink(missing_ok=True)
            one = serve_one_process(dev, spec, res)
            meta = mesh_count_finish(proc, count_json, t_count)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rank_kernel_lines(res, cuda)
    serve_mesh_report("mesh_serve", res, one, cuda)
    mesh_count_report("mesh_serve", meta, res)
    phase("mesh_serve", ranks_seconds=f"{ranks_s:.1f}",
          one_process_seconds=f"{one['seconds']:.1f}",
          one_process_peak=one["peak"],
          **{f"{k}_s": f"{res[0][f'{k}_s']:.1f}" for k in spec["phases"]},
          seconds=f"{time.perf_counter() - t0:.1f}")
    launches = collections.Counter()
    for tag in SERVE_TAGS:
        for name, n in res[0]["k"][tag]["launches"].items():
            launches[f"{name}_{tag}"] += n
    return launches


# --- [examples]: the repo's four examples as the port's entry points -------------
EXAMPLES_FLAG = "--examples-only"
EXAMPLES = ROOT / "examples"
# the tour's sections that score on numpy in both runs (the reference's
# explain and report): nothing to follow there
TOUR_NUMPY_SECTIONS = ("explain", "report")
EXAMPLE_PLAIN_STEPS = 3      # train_lm's steps held to the plain route


def load_example(name):
    """``examples/torch_<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counts():
    """K1-K7's launch counts, from the bindings."""
    from repro_torch.kernels import flash_cuda as fc
    from repro_torch.kernels import topsis_cuda as tc
    return {**tc.LAUNCHES, **fc.LAUNCHES}


def _reset_counts():
    from repro_torch.kernels import flash_cuda as fc
    from repro_torch.kernels import topsis_cuda as tc
    tc.reset_launches()
    fc.reset_launches()


def example_line(name, launches, want, dev, seconds, **fields):
    """An example's line, its launches of K1-K7 beside it; on a card each
    kernel of ``want`` launched."""
    phase("examples", example=name, seconds=f"{seconds:.3f}", **fields,
          launches=json.dumps(launches, separators=(",", ":")))
    missed = [k for k in want if launches.get(k, 0) == 0]
    check(dev.type != "cuda" or not missed,
          f"examples {name}: {missed} not launched")


def quickstart_example(dev):
    """torch_quickstart: K1's pick equal to numpy's or a near-tie
    (closeness within TOL, the float64 gap within TOL), and the Table VI
    cell. Returns its launches."""
    import numpy as np

    from repro_torch.cluster import parity as Q
    t0 = time.perf_counter()
    _reset_counts()
    out = load_example("quickstart").main(["--device", str(dev)])
    launches = _counts()
    cc, pick = out["closeness"]["numpy"], out["pick"]
    err = Q.max_err_np(out["closeness"]["cuda"], cc)
    gap = abs(cc[pick["numpy"]] - cc[pick["cuda"]])
    check(err <= TOL, f"quickstart: cuda closeness {err} from numpy")
    check(gap <= Q.TOL, f"quickstart: cuda picks {pick['cuda']}, numpy "
          f"{pick['numpy']}, float64 gap {gap}")
    check(bool(np.isfinite(out["optimization_pct"])), "quickstart: no "
          "Table VI cell")
    example_line("quickstart", launches, ("topsis_single",), dev,
                 time.perf_counter() - t0,
                 pick_numpy=out["nodes"][pick["numpy"]],
                 pick_cuda=out["nodes"][pick["cuda"]],
                 max_err_vs_numpy=f"{err:.3e}", float64_gap=f"{gap:.3e}",
                 default_kj=f"{out['default_kj']:.6f}",
                 topsis_kj=f"{out['topsis_kj']:.6f}",
                 optimization_pct=f"{out['optimization_pct']:.4f}")
    return launches


def fleet_tour_runs(dev, dryrun_dir, out_dir):
    """torch_fleet_scheduler on the cuda backend, then on numpy following
    the cuda run's near-tie breaks in every scenario (``cluster.parity``:
    each differing pick a float64 near-tie). Returns (cuda run, numpy
    run, the one-shot queue's and the frontier's calls by backend, the
    scenarios' parity records by run, the cuda run's launches)."""
    import contextlib as cl

    from repro_torch.cluster import parity as Q
    from repro_torch.core import scheduler as S
    tour = load_example("fleet_scheduler")
    calls = collections.defaultdict(list)
    stats = {"cuda": {}, "numpy": {}}

    class Recording(S.BatchScheduler):
        def select_many(self, pods, nodes, now=0.0, blocked=None,
                        exclude=None, explain=False):
            assign, diag = super().select_many(
                pods, nodes, now=now, blocked=blocked, exclude=exclude,
                explain=explain)
            calls["queue", self.backend].append(
                (pods, nodes, assign, diag["closeness"]))
            return assign, diag

        def select_many_grid(self, pods, nodes, schemes, now=0.0,
                             exclude=None):
            assign, diag = super().select_many_grid(pods, nodes, schemes,
                                                    now=now, exclude=exclude)
            calls["grid", self.backend].append(
                (pods, nodes, assign, diag["closeness"]))
            return assign, diag

    def hook(run):
        @cl.contextmanager
        def scenario(name):
            if name in TOUR_NUMPY_SECTIONS:
                yield
                return
            rec = stats[run][name] = Q.policy_stats()
            replay = stats["cuda"][name]["calls"] if run == "numpy" else None
            with Q.engine_scheduler(Q.make_policy_scheduler(rec, replay)), \
                    Q.wake_scoring(rec):
                yield
        return scenario

    outs = {}
    for run in ("cuda", "numpy"):
        argv = [str(dryrun_dir), "--backend", run, "--device", str(dev),
                "--out-dir", str(Path(out_dir) / run)]
        _reset_counts()
        outs[run] = tour.main(argv, scenario=hook(run),
                              batch_scheduler=Recording)
        if run == "cuda":
            launches = _counts()
    return outs["cuda"], outs["numpy"], calls, stats, launches


def walk_ties(got, want, what):
    """The cuda calls ``got`` against the numpy calls ``want`` of the
    same queues: closeness within TOL, every differing pick a float64
    near-tie (``near_tie_walk``, per scheme of a grid call). Returns
    (largest closeness difference, rows placed differently, near-ties)."""
    import numpy as np

    from repro_torch.cluster import parity as Q
    from repro_torch.core.scheduler import _as_table
    check(len(got) == len(want), f"{what}: {len(got)} cuda calls, "
          f"{len(want)} numpy calls")
    err, differ, ties = 0.0, 0, 0
    for (pods, nodes, a_cu, cc_cu), (_, _, a_np, cc_np) in zip(got, want):
        err = max(err, Q.max_err_np(cc_cu, cc_np))
        grid = np.ndim(cc_np) == 3
        for a, b, cc in (zip(a_cu, a_np, cc_np) if grid
                         else [(a_cu, a_np, cc_np)]):
            if list(a) != list(b):
                differ += 1
                ties += Q.near_tie_walk(cc, list(a), pods, _as_table(nodes),
                                        None)[0]
    check(err <= TOL, f"{what}: cuda closeness {err} from numpy")
    return err, differ, ties


def fleet_tour_example(dev, dryrun_dir, out_dir, runs=None):
    """torch_fleet_scheduler's checks on ``runs`` (default: made here by
    ``fleet_tour_runs`` on the records in ``dryrun_dir``): the
    scenarios' numbers equal between the runs, K3 launched once a
    scoring round; the one-shot queue's and the frontier's cuda picks
    equal numpy's or near-ties, the frontiers equal or a near-tie
    between them; explain's deltas summing to its gap; the trace and
    the reports written. Returns the cuda run's launches."""
    import numpy as np
    t0 = time.perf_counter()
    cu, nu, calls, stats, launches = runs or fleet_tour_runs(
        dev, dryrun_dir, out_dir)
    for name, got in cu["scenarios"].items():
        differ = [k for k, v in got.items() if v != nu["scenarios"][name][k]]
        check(not differ, f"fleet tour {name}: the cuda run and numpy "
              f"following it differ in {differ}")
    rounds = sum(len(r["calls"]) for r in stats["cuda"].values())
    check(dev.type != "cuda" or launches["topsis_kinds"] == rounds,
          f"fleet tour: K3 launched {launches['topsis_kinds']} times for "
          f"{rounds} scoring rounds")
    q_err, q_diff, q_ties = walk_ties(calls["queue", "cuda"][-1:],
                                      calls["queue", "numpy"][-1:], "queue")
    g_err, g_diff, g_ties = walk_ties(calls["grid", "cuda"],
                                      calls["grid", "numpy"], "frontier")
    for regime, f in cu["frontier"].items():
        same = bool(np.array_equal(f["mask"],
                                   nu["frontier"][regime]["mask"]))
        check(same or g_ties > 0, f"fleet tour frontier {regime}: the "
              f"frontiers differ with no near-tie")
    check(cu["explain"] == nu["explain"], "fleet tour: explain differs")
    exp = cu["explain"]
    check(abs(sum(exp["deltas"].values()) - exp["gap"]) <= 1e-9,
          f"fleet tour: explain's deltas sum to "
          f"{sum(exp['deltas'].values())}, gap {exp['gap']}")
    for path in (cu["recorder"]["trace"], cu["report"]["path"],
                 cu["frontier_report"]):
        check(Path(path).is_file() and Path(path).resolve().is_relative_to(
            Path(out_dir).resolve()), f"fleet tour: {path} not written "
              f"under {out_dir}")
    example_line(
        "fleet_scheduler", launches,
        ("topsis_batched", "topsis_kinds", "topsis_grid"), dev,
        time.perf_counter() - t0, jobs=cu["jobs"],
        queue_placed=cu["select_many"]["cuda"]["placed"],
        queue_ms_cuda=f"{cu['select_many']['cuda']['ms']:.3f}",
        queue_ms_numpy=f"{cu['select_many']['numpy']['ms']:.3f}",
        queue_max_err_vs_numpy=f"{q_err:.3e}", queue_pods_differ=q_diff,
        queue_near_ties=q_ties, scenarios=len(cu["scenarios"]),
        scoring_rounds=rounds,
        scenario_near_ties=sum(c["ties"] for r in stats["numpy"].values()
                               for c in r["calls"]),
        scenarios_equal_numpy=True,
        frontier_max_err_vs_numpy=f"{g_err:.3e}",
        frontier_schemes_differ=g_diff, frontier_near_ties=g_ties,
        frontier=",".join(str(f["front"]) for f in cu["frontier"].values()),
        batch_rounds=cu["recorder"]["batch_rounds"])
    return launches


def train_example(dev, out_dir, argv=()):
    """torch_train_lm at its defaults (``argv`` added): the failure and
    the restart, the mean of the last 10 losses below the first 10's,
    the first EXAMPLE_PLAIN_STEPS losses within TRAIN_LOSSES_RTOL of the
    same steps on the kernels' plain versions. Returns its launches."""
    import numpy as np

    from repro_torch.kernels import flash_cuda as fc
    ex = load_example("train_lm")
    t0 = time.perf_counter()
    _reset_counts()
    kern = ex.main(["--device", str(dev), "--out-dir",
                    str(Path(out_dir) / "train_ckpt"), *argv])
    launches = _counts()
    seconds = time.perf_counter() - t0
    with kernel_route(flash_fwd=fc.flash_fwd_plain,
                      flash_bwd=fc.flash_bwd_plain):
        plain = ex.main(["--device", str(dev), *argv, "--steps",
                         str(EXAMPLE_PLAIN_STEPS)], fail_at=None)
    check(_counts() == launches, "train_lm: the plain run launched a "
          "flash kernel")
    losses = kern["losses"]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    rel = max(_rel(a, b) for a, b in zip(
        losses[:EXAMPLE_PLAIN_STEPS], plain["losses"], strict=True))
    # the history: steps 0 .. fail_at - 1, then from the checkpoint the
    # restart restored (at or before the failure) to the end
    steps, fail_at = kern["steps"], kern["fail_at"]
    restart = steps[fail_at]
    check(kern["failures"] == 1 and restart <= fail_at
          and steps == list(range(fail_at)) + list(range(restart,
                                                         max(steps) + 1)),
          f"train_lm: no failure and restart in steps {steps}")
    check(last < first, f"train_lm: loss {first} -> {last}")
    check(rel <= TRAIN_LOSSES_RTOL, f"train_lm: first losses {rel} from the "
          f"plain route")
    example_line("train_lm", launches, (fc.NAME, fc.DQ, fc.DKV), dev,
                 seconds, steps=max(steps) + 1, executed=len(steps),
                 failure_at=fail_at, restart_from=restart,
                 loss_first10=f"{first:.4f}", loss_last10=f"{last:.4f}",
                 losses_rel_vs_plain=f"{rel:.3e}",
                 step_s_median=f"{float(np.median(kern['time_s'])):.4f}")
    return launches


def serve_example(dev, argv=()):
    """torch_serve_lm at its defaults (``argv`` added): every request
    served within the vocabulary, and its float32 logits within
    F32_LOGIT_TOL of the same calls on K5's plain version (teacher-forced
    on the kernel run's tokens). Returns its launches."""
    from repro_torch.kernels import flash_cuda as fc
    ex = load_example("serve_lm")
    seen = {}

    def wrap(model):
        seen["model"] = model
        seen["rec"] = RecordingLM(model)
        return seen["rec"]

    t0 = time.perf_counter()
    _reset_counts()
    out = ex.main(["--device", str(dev), *argv], wrap=wrap)
    launches = _counts()
    seconds = time.perf_counter() - t0
    model, rec = seen["model"], seen["rec"]
    check(model.cfg.dtype == "float32", f"serve_lm runs {model.cfg.dtype}")
    kernel_logits = [c["logits"] for c in rec.calls]
    before = fc.LAUNCHES[fc.NAME]
    plain, _ = replay(model, rec.calls, 64, fc.flash_fwd_plain)
    check(fc.LAUNCHES[fc.NAME] == before, "a comparison run launched K5")
    stats = compare_runs(kernel_logits, plain, F32_LOGIT_TOL)
    check(all(len(t) > 0 and bool(((t >= 0) & (t < model.cfg.vocab)).all())
              for t in out["results"].values()), "serve_lm: bad tokens")
    example_line("serve_lm", launches, (fc.NAME,), dev, seconds,
                 requests=out["requests"], tokens=out["tokens"],
                 serve_s=f"{out['seconds']:.3f}",
                 tokens_per_s=f"{out['tokens_per_s']:.1f}",
                 calls=len(rec.calls),
                 max_logit_err_vs_plain=f"{stats['max_err']:.3e}",
                 logit_tol=F32_LOGIT_TOL, near_ties=stats["near_ties"])
    return launches


def examples_phase(dev, dryrun_dir):
    """[examples]: the four examples on ``dev`` (the fleet tour on the
    dry run's records in ``dryrun_dir``), files into a temporary
    directory. Returns their launches, summed."""
    t0 = time.perf_counter()
    launches = collections.Counter()
    with tempfile.TemporaryDirectory() as out_dir:
        launches.update(quickstart_example(dev))
        launches.update(fleet_tour_example(dev, dryrun_dir, out_dir))
        launches.update(train_example(dev, out_dir))
        launches.update(serve_example(dev))
    phase("examples", seconds=f"{time.perf_counter() - t0:.1f}")
    return launches


def kernel_rows(table, launches):
    """The kernel table line's rows: each row's launches from the main
    paths' counts; the local-head rows, which no card path launches, go
    to a ``[dist]`` line of their own instead."""
    rows = []
    for row in table.values():
        row["launches"] = launches[row["name"]]
        if row["name"].endswith(f"_{LOCAL_HEADS}"):
            phase("dist", local_head_row=json.dumps(row,
                                                    separators=(",", ":")))
        else:
            rows.append(row)
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if sys.argv[1:2] == [MESH_COUNT_FLAG]:   # [mesh]'s meta count child
        sys.path.insert(0, str(SRC))
        mesh_count_child(*sys.argv[2:4])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the card", file=sys.stderr)
        return 1
    if not all((ROOT / CSRC / f).is_file()
               for f in ("topsis.cu", "topsis_math.cuh",
                         "topsis_math_check.cu", "flash_attention.cu",
                         "rmsnorm.cu", "flash_attention_bwd.cu",
                         "hopper.cuh")):
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
    if sys.argv[1:] == [DRYRUN_FLAG]:        # the dry run alone
        with tempfile.TemporaryDirectory() as out_dir, \
                dryrun_cells(out_dir) as procs:
            dryrun_phases(dev, procs, out_dir, time.perf_counter())
        phase("done", dryrun_only=True,
              seconds=f"{time.perf_counter() - t0:.1f}")
        print(smi)
        print(json.dumps({"kernels": []}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": count}}))
        return 0
    four = {MESH_FLAG: ("mesh_only", mesh_kernel_phase, mesh_phases),
            FAMILY_FLAG: ("mesh_families", family_kernel_phase,
                          family_phases),
            SERVE_MESH_FLAG: ("mesh_serve", serve_kernel_phase,
                              serve_mesh_phases),
            REMAIN_FLAG: ("mesh_remaining",
                          lambda dev: mesh_kernel_phase(dev,
                                                        REMAIN_KERNEL_TAGS),
                          lambda dev: family_phases(dev, remain_spec()))}
    if len(sys.argv) == 2 and sys.argv[1] in four:   # on four cards
        done, kernels, phases = four[sys.argv[1]]
        if count < MESH_WORLD:
            print(f"chip_smoke: {sys.argv[1]} needs {MESH_WORLD} cards, "
                  f"{count} visible", file=sys.stderr)
            return 1
        build_phase()           # once, before any rank loads the libraries
        table = kernels(dev)
        launches = phases(dev)
        for row in table.values():
            row["launches"] = launches[row["name"]]
        phase("done", **{done: True},
              seconds=f"{time.perf_counter() - t0:.1f}")
        print(smi)
        print(json.dumps({"kernels": list(table.values())}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": count}}))
        return 0
    build_phase()
    if sys.argv[1:] == [KERNELS_FLAG]:       # the flash and RMSNorm kernels
        table = lm_kernel_phase(dev)
        table.update(bwd_kernel_phase(dev))
        table.update(padded_kernel_phase(dev))
        phase("done", kernels_only=True,
              seconds=f"{time.perf_counter() - t0:.1f}")
        print(smi)
        print(json.dumps({"kernels": list(table.values())}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": count}}))
        return 0
    if sys.argv[1:] == [EXAMPLES_FLAG]:      # the four examples alone
        examples_phase(dev, ROOT / "build" / "no_dryrun_records")
        phase("done", examples_only=True,
              seconds=f"{time.perf_counter() - t0:.1f}")
        print(smi)
        print(json.dumps({"kernels": []}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": count}}))
        return 0
    if sys.argv[1:] == [MOE_FLAG]:           # the MoE slice alone
        windowed = [c for c in K5_CASES if c[7] == WINDOW_ROW]
        table = lm_kernel_phase(dev, windowed, small=False)
        table.update(bwd_kernel_phase(
            dev, [c for c in BWD_CASES if c[7] == WINDOW_ROW], small=False))
        moe = moe_phases(dev)
        for row in table.values():
            row["launches"] = moe[row["name"].rsplit("_w", 1)[0]]
        phase("done", moe_only=True,
              seconds=f"{time.perf_counter() - t0:.1f}")
        print(smi)
        print(json.dumps({"kernels": list(table.values())}))
        return 0
    if sys.argv[1:] == [SSM_FLAG]:           # the state-space slice
        table = padded_kernel_phase(dev)
        zamba = zamba2_phases(dev)
        rwkv = rwkv_phases(dev)
        for row in table.values():
            row["launches"] = zamba[row["name"].rsplit("_d", 1)[0]]
        phase("done", ssm_only=True, rwkv_launches=json.dumps(
            dict(rwkv), separators=(",", ":")),
              seconds=f"{time.perf_counter() - t0:.1f}")
        print(smi)
        print(json.dumps({"kernels": list(table.values())}))
        return 0
    if sys.argv[1:] == [DIST_FLAG]:          # training on a mesh alone
        # the [dist] path's shapes (K5 at the serving case's, K6/K7 at the
        # training case's) and one rank's local heads
        table = lm_kernel_phase(dev, [c for c in K5_CASES
                                      if c[0] in ("a", LOCAL_HEADS)],
                                small=False)
        table.update(bwd_kernel_phase(
            dev, [c for c in BWD_CASES if c[0] in ("train", LOCAL_HEADS)],
            small=False))
        launches = dist_phases(dev)
        rows = kernel_rows(table, launches)
        phase("done", dist_only=True,
              seconds=f"{time.perf_counter() - t0:.1f}")
        print(smi)
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": count}}))
        return 0
    if sys.argv[1:] == [CROSS_FLAG]:         # the cross-attention slice
        table = lm_kernel_phase(dev, [c for c in K5_CASES
                                      if c[0] in BIDIRECTIONAL], small=False)
        table.update(bwd_kernel_phase(
            dev, [c for c in BWD_CASES if c[0] in BIDIRECTIONAL],
            small=False))
        whisper, vision = cross_phases(dev)
        for row in table.values():
            row["launches"] = whisper[row["name"].rsplit("_d", 1)[0]]
        phase("done", cross_only=True, vision_launches=json.dumps(
            dict(vision), separators=(",", ":")),
              seconds=f"{time.perf_counter() - t0:.1f}")
        print(smi)
        print(json.dumps({"kernels": list(table.values())}))
        return 0
    # [dryrun]'s cells run in processes of their own beside the card
    # phases; their records are read at the end
    with tempfile.TemporaryDirectory() as dry_dir, \
            dryrun_cells(dry_dir) as dry_procs:
        rows = _main_paths(dev, smi, dry_procs, dry_dir, time.perf_counter())
    phase("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


def _main_paths(dev, smi, dry_procs, dry_dir, dry_t0):
    """The whole script's kernel cases and main paths, [dryrun] last;
    returns the kernel table line's rows."""
    table = kernel_phase(dev, smi)
    table.update(lm_kernel_phase(dev))
    table.update(bwd_kernel_phase(dev))
    table.update(padded_kernel_phase(dev))
    # each main path's counts, summed: slice (K1-K4), the per-pod
    # decisions (K1), the policy round (K3), the frontier layer (K4, K3),
    # serve (K5), the smoke-size serving launcher (K5), train (K5, K6,
    # K7), for llama3-8b (head dim 128), gemma-7b (256), mixtral-8x7b
    # (128, window 4096), whisper-base (64), llama-3.2-vision-90b (128),
    # zamba2-7b (112, padded to 128) and rwkv6-1.6b (none); the D = 256
    # rows count gemma's, the _w4096 rows mixtral's, the D = 64 rows
    # whisper's, the D = 112 rows zamba2's
    launches = collections.Counter(slice_phase(dev))
    launches.update(perpod_phase(dev, smi))
    launches.update(policy_phase(dev, smi))
    launches.update(pareto_phase(dev, smi))
    launches.update(serve_phase(dev))
    launches.update(serve_smoke_phase(dev))
    wide = collections.Counter(serve_phase(dev, GEMMA_ARCH))
    launches.update(train_phase(dev))
    f32_train_phase(dev)
    # the float64 spread run of llama3-8b only: the others' are recorded
    # (PERF.md), and the script's time is near its limit
    wide.update(train_phase(dev, GEMMA_ARCH, spread=False))
    f32_train_phase(dev, GEMMA_ARCH, GEMMA_F32_LAYERS, control="half_d")
    moe = moe_phases(dev)
    narrow, vision = cross_phases(dev)
    zamba = zamba2_phases(dev)
    rwkv = rwkv_phases(dev)
    supervisor_phase(dev)
    launches.update(dist_phases(dev))
    dryrun_phases(dev, dry_procs, dry_dir, dry_t0)
    # the four examples, the fleet tour on [dryrun]'s records
    launches.update(examples_phase(dev, dry_dir))
    launches.update(wide)
    launches.update({row_name(n, WIDE_D): c for n, c in wide.items()})
    launches.update(moe)
    launches.update({row_name(n, 128, WINDOW_ROW): c for n, c in moe.items()})
    launches.update(narrow)
    launches.update({row_name(n, NARROW_D): c for n, c in narrow.items()})
    launches.update(vision)
    launches.update(zamba)
    launches.update({row_name(n, ZAMBA_D): c for n, c in zamba.items()})
    launches.update(rwkv)
    return kernel_rows(table, launches)


if __name__ == "__main__":
    sys.exit(main())
