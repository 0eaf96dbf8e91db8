"""GreenPod TOPSIS as the placement engine of a GPU fleet — port of
``repro.launch.fleet``.

The paper schedules K8s pods onto a heterogeneous set of VM node classes
(Table I: frugal A, balanced B, fast-but-hungry C) by five criteria. On an
accelerator fleet the analogous decision is placing a JOB (architecture x
input shape, i.e. a dry-run cell, which runs at its mesh size) onto a
SLICE of a heterogeneous fleet (GPU generations differ in speed, memory
and power — the exact heterogeneity axis of the paper's Table I).

The criteria vector is derived from the job's roofline terms
(``launch/dryrun.py``'s records, on the H100) evaluated on the candidate
slice's generation:

  0 step_time (cost)    — dominant roofline term / gen speed x slice health
  1 energy    (cost)    — step_time x chips x gen power at the job's
                          compute utilization (+ idle wake-up share for a
                          previously-idle slice — the consolidation signal,
                          same mechanism as core/energy.predicted_task_*)
  2 chips     (benefit) — free chips after placement
  3 hbm_headroom (benefit) — free device memory/chip after the job's peak
  4 balance   (benefit) — 1 - |compute_term - memory_term| / step_time

Everything but ``GENERATIONS`` is the reference's, imports rewritten to
the port's ``core.topsis.closeness_np`` and ``core.criteria
.FLEET_CRITERIA``; the reference's table is TPU data, the port's three
NVIDIA generations in the roles Table I gives the paper's node classes.

Straggler mitigation (train/fault.py): a StragglerAlert marks the slice
degraded (health multiplier on step_time) and ``replace_slice`` re-ranks —
the paper's adaptive response to system conditions, applied to fleet
health.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os

import numpy as np

from repro_torch.core import topsis
from repro_torch.core.criteria import FLEET_CRITERIA

_BENEFIT = np.array([c.benefit for c in FLEET_CRITERIA], dtype=bool)

# Fleet-level weighting schemes (Table-III profiles re-expressed for the
# fleet criteria). The cluster-simulator schemes in core/weighting.py are
# calibrated to the paper's GKE dynamics; the fleet's step-time/energy
# dynamic range is different (2-3x speed spread between generations), so the
# profiles are stated directly: same intent, fleet-scaled emphasis.
FLEET_SCHEMES: dict[str, np.ndarray] = {
    "general": np.array([0.20, 0.20, 0.20, 0.20, 0.20]),
    "energy_centric": np.array([0.10, 0.60, 0.10, 0.10, 0.10]),
    "performance_centric": np.array([0.60, 0.05, 0.15, 0.15, 0.05]),
    "resource_efficient": np.array([0.10, 0.25, 0.25, 0.25, 0.15]),
}


def fleet_weights(scheme: str) -> np.ndarray:
    w = FLEET_SCHEMES[scheme]
    return w / w.sum()

# Heterogeneous fleet generations — the Table-I node classes of a GPU
# fleet. speed: bf16 dense tensor peak relative to the H100 (the
# generation the dry run's roofline is evaluated on); hbm: device memory
# bytes/GPU; tdp: board power limit, W/GPU (datasheets); idle: W/GPU at
# rest — no datasheet states it: these are assumptions, illustrative of
# each class as the reference's own table is.
_H100_BF16 = 989e12      # H100 SXM5 datasheet: 989 TFLOPS bf16 dense
GENERATIONS: dict[str, dict[str, float]] = {
    # class-A analog: slow, frugal, memory-tight. NVIDIA L4 datasheet:
    # 121 TFLOPS bf16 dense (242 with sparsity), 24 GB, 72 W
    "l4": {"speed": 121e12 / _H100_BF16, "hbm": 24e9, "tdp": 72.0,
           "idle": 16.0},
    # class-B analog: balanced. NVIDIA A100 80GB SXM datasheet: 312
    # TFLOPS bf16 dense, 80 GB, 400 W
    "a100": {"speed": 312e12 / _H100_BF16, "hbm": 80e9, "tdp": 400.0,
             "idle": 50.0},
    # class-C analog: fastest step, most power. NVIDIA H100 SXM5
    # datasheet: 989 TFLOPS bf16 dense, 80 GB, 700 W
    "h100": {"speed": 1.0, "hbm": 80e9, "tdp": 700.0, "idle": 70.0},
}


@dataclasses.dataclass
class Slice:
    name: str
    chips: int
    free_chips: int
    gen: str = "h100"
    health: float = 1.0          # >1 = degraded (straggler multiplier)
    awake: bool = False          # hosting at least one job

    @property
    def hbm_per_chip(self) -> float:
        return GENERATIONS[self.gen]["hbm"]

    def degrade(self, factor: float = 2.0):
        self.health *= factor

    def heal(self):
        self.health = 1.0


@dataclasses.dataclass(frozen=True)
class Job:
    """One dry-run cell, as a schedulable unit (runs at its compiled size)."""
    arch: str
    shape: str
    chips_wanted: int            # mesh size the cell was compiled for
    compute_s: float             # roofline terms on the H100
    memory_s: float
    collective_s: float
    peak_bytes_per_dev: float

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def utilization(self) -> float:
        """Compute-term share of the step — the MFU-ish factor that scales
        dynamic chip power."""
        t = self.step_time_s
        return min(self.compute_s / t, 1.0) if t > 0 else 0.0


def load_jobs(dryrun_dir: str, mesh: str = "single") -> list[Job]:
    """Jobs from launch/dryrun.py JSON records."""
    jobs = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir,
                                              f"*__{mesh}.json"))):
        with open(path) as f:
            rec = json.load(f)
        if not rec.get("ok"):
            continue
        r = rec["roofline"]
        jobs.append(Job(rec["arch"], rec["shape"], rec["chips"],
                        r["compute_s"], r["memory_s"], r["collective_s"],
                        rec["memory"]["peak_bytes"]))
    return jobs


def job_on_slice(job: Job, s: Slice) -> tuple[float, float]:
    """(step_time_s, energy_J) of the job on slice s's generation."""
    g = GENERATIONS[s.gen]
    step = job.step_time_s / g["speed"] * s.health
    util = job.utilization()
    power = g["idle"] + (g["tdp"] - g["idle"]) * util
    energy = step * job.chips_wanted * power
    if not s.awake:
        # waking an idle slice bills its idle power for the step duration —
        # the marginal-energy consolidation signal (paper §V.D / core.energy)
        energy += step * s.chips * g["idle"]
    return step, energy


def feasible(job: Job, s: Slice) -> bool:
    return (s.free_chips >= job.chips_wanted
            and job.peak_bytes_per_dev <= s.hbm_per_chip)


def decision_matrix(job: Job, slices: list[Slice]) -> np.ndarray:
    rows = []
    for s in slices:
        step, energy = job_on_slice(job, s)
        # fractional benefit criteria, like the paper's cores/memory columns
        free_after = max(s.free_chips - job.chips_wanted, 0) / s.chips
        hbm_free = max(s.hbm_per_chip - job.peak_bytes_per_dev, 0.0) \
            / s.hbm_per_chip
        g = GENERATIONS[s.gen]
        comp = job.compute_s / g["speed"]
        balance = 1.0 - abs(comp - step) / max(step, 1e-12)
        rows.append([step, energy, free_after, hbm_free, balance])
    return np.asarray(rows, dtype=np.float64)


def place(job: Job, slices: list[Slice], scheme: str = "energy_centric"
          ) -> tuple[int | None, dict]:
    """TOPSIS-selected slice index for the job (None if unschedulable)."""
    valid = np.array([feasible(job, s) for s in slices])
    if not valid.any():
        return None, {"reason": "unschedulable"}
    M = decision_matrix(job, slices)
    w = fleet_weights(scheme)
    res = topsis.closeness_np(M, w, _BENEFIT, valid)
    idx = int(res.ranking[0])
    return idx, {"closeness": res.closeness, "matrix": M}


def bind(job: Job, s: Slice):
    assert feasible(job, s)
    s.free_chips -= job.chips_wanted
    s.awake = True


def replace_slice(job: Job, slices: list[Slice], current: int,
                  scheme: str = "energy_centric") -> int | None:
    """Straggler mitigation: degrade the current slice and re-place."""
    slices[current].degrade()
    idx, _ = place(job, slices, scheme)
    return idx


def schedule_queue(jobs: list[Job], slices: list[Slice],
                   scheme: str = "energy_centric"
                   ) -> list[tuple[Job, int | None]]:
    """FIFO placement of a job queue with chip accounting."""
    out = []
    for job in jobs:
        idx, _ = place(job, slices, scheme)
        if idx is not None:
            bind(job, slices[idx])
        out.append((job, idx))
    return out
