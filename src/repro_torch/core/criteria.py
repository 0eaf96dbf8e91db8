"""Criterion definitions for GreenPod scheduling (paper §I, §III).

The five GreenPod criteria, in canonical column order:

  0 execution_time  (cost)    — predicted task runtime on the candidate node
  1 energy          (cost)    — predicted task energy on the candidate node
  2 cores           (benefit) — available processing cores after placement
  3 memory          (benefit) — available memory after placement
  4 balance         (benefit) — resource balance (1 - |cpu_util - mem_util|)

The carbon-aware stack (beyond-paper; repro_torch.core.carbon) appends a sixth:

  5 carbon_rate     (cost)    — node power draw x grid carbon intensity of
                                the node's region at decision time

``greenpod_criteria(carbon=...)`` selects the 5- or 6-criteria tuple; with
the carbon weight at zero the 6-criteria TOPSIS ranking is bitwise identical
to the legacy 5-criteria one (a zero-weight column contributes exactly 0 to
every distance), which is what keeps paper-mode reproduction intact.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Criterion:
    name: str
    benefit: bool  # True: higher is better; False: cost criterion
    description: str = ""


GREENPOD_CRITERIA: tuple[Criterion, ...] = (
    Criterion("execution_time", False, "predicted runtime (s)"),
    Criterion("energy", False, "predicted energy (J)"),
    Criterion("cores", True, "free vCPU after placement"),
    Criterion("memory", True, "free memory (GB) after placement"),
    Criterion("balance", True, "1 - |cpu_util - mem_util| after placement"),
)

CRITERIA_NAMES: tuple[str, ...] = tuple(c.name for c in GREENPOD_CRITERIA)
N_CRITERIA = len(GREENPOD_CRITERIA)

# Sixth criterion (carbon-aware stack): instantaneous emission rate of the
# placement — the task's power draw on the candidate node (dynamic power for
# its vCPUs, plus the idle power a placement on a sleeping node newly wakes)
# times the node region's grid intensity at decision time. A cost criterion:
# the scheduler steers work toward currently-clean regions.
CARBON_CRITERION = Criterion(
    "carbon_rate", False,
    "node power draw x regional grid intensity (W * gCO2/kWh) at decision "
    "time")

GREENPOD_CRITERIA_CARBON: tuple[Criterion, ...] = (
    GREENPOD_CRITERIA + (CARBON_CRITERION,))
N_CRITERIA_CARBON = len(GREENPOD_CRITERIA_CARBON)


def greenpod_criteria(carbon: bool = False) -> tuple[Criterion, ...]:
    """The decision-matrix column tuple: 5 paper criteria, or 6 with the
    carbon-rate criterion appended (when a carbon signal is attached)."""
    return GREENPOD_CRITERIA_CARBON if carbon else GREENPOD_CRITERIA


def benefit_mask(criteria=GREENPOD_CRITERIA) -> np.ndarray:
    return np.array([c.benefit for c in criteria], dtype=bool)


# --- decision-matrix column computation --------------------------------------
# Single source of the criteria arithmetic for both the full-rebuild path
# (repro_torch.core.scheduler.decision_matrix_table) and the dirty-column refresh
# of the incremental FleetState caches. Every operation is elementwise per
# node — no cross-node reduction happens before TOPSIS scoring — which is
# the property that makes subset recomputation bitwise-identical to slicing
# a full rebuild: computing columns for the dirty node indices alone yields
# exactly the floats a fresh ``NodeTable.from_nodes`` rebuild would.
def criteria_matrix(cpu, mem, base_time_s, table,
                    carbon_intensity=None, cols=None) -> np.ndarray:
    """(..., N', C) GreenPod criteria block over ``table``'s column arrays
    (``CRITERIA_NAMES`` order; C = 5, or 6 with ``carbon_intensity``).

    ``cpu`` / ``mem`` / ``base_time_s`` are scalars for one pod or ``(P, 1)``
    request columns for a queue. ``cols`` optionally restricts the block to
    a node-index subset (the dirty-column recompute path): N' is then
    ``len(cols)``, and — because the arithmetic is elementwise per node —
    the block equals the corresponding columns of the full matrix bitwise.
    ``carbon_intensity`` must already be sliced to ``cols`` by the caller
    (it is a per-node column too)."""
    from repro_torch.core.energy import predicted_task_energy_joules_np

    sl = slice(None) if cols is None else cols
    speed = table.speed[sl]
    awake = table.awake[sl]
    exec_t = base_time_s / speed
    energy = predicted_task_energy_joules_np(
        table.dyn_power_per_vcpu[sl], table.idle_power[sl], exec_t, cpu,
        awake)
    cpu_after = (table.reserved_cpu[sl] + table.used_cpu[sl]
                 + cpu) / table.vcpus[sl]
    mem_after = (table.reserved_mem[sl] + table.used_mem[sl]
                 + mem) / table.mem_gb[sl]
    rows = [
        np.broadcast_to(exec_t, cpu_after.shape),
        energy,
        np.maximum(1.0 - cpu_after, 0.0),    # core availability
        np.maximum(1.0 - mem_after, 0.0),    # memory availability
        1.0 - np.abs(cpu_after - mem_after),
    ]
    if carbon_intensity is not None:
        rows.append(placement_power(cpu, table, cols=cols)
                    * np.asarray(carbon_intensity, dtype=np.float64))
    return np.stack(rows, axis=-1).astype(np.float64, copy=False)


def placement_power(cpu, table, cols=None) -> np.ndarray:
    """(..., N') marginal power draw (W) of placing ``cpu`` vCPUs on each
    node of ``table`` (optionally restricted to the ``cols`` subset):
    the carbon_rate criterion is this times grid intensity. Split out of
    :func:`criteria_matrix` so the incremental caches can refresh the
    carbon column alone when only decision time ``now`` moved (the power
    factor is time-invariant; the intensity column is not)."""
    from repro_torch.core.energy import predicted_power_w_np

    sl = slice(None) if cols is None else cols
    return predicted_power_w_np(table.dyn_power_per_vcpu[sl],
                                table.idle_power[sl], cpu, table.awake[sl])


# Fleet-level criteria (beyond-paper: TOPSIS over TPU slices; values derived
# from compiled roofline terms — see the reference's repro.launch.fleet).
FLEET_CRITERIA: tuple[Criterion, ...] = (
    Criterion("step_time", False, "roofline-estimated step time (s)"),
    Criterion("energy", False, "step_time x slice TDP (J)"),
    Criterion("chips", True, "free chips on slice"),
    Criterion("hbm_headroom", True, "free HBM after placement (GB)"),
    Criterion("balance", True, "1 - |compute_util - hbm_util|"),
)
