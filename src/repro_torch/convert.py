"""State carried into the port from plain numpy and Python values.

A scheduler has no weights: what must match between the reference and the
port is the fleet state, the pod queue and the weighting schemes. These
functions build the port's objects from values any caller can produce —
for instance the columns of a reference ``NodeTable`` mid-run — without
importing the reference. Weight vectors need no conversion: they stay
numpy ``(C,)`` / ``(S, C)`` arrays.
"""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

from repro_torch.cluster.node import FleetState, Node
from repro_torch.cluster.workload import WORKLOADS, Pod, WorkloadSpec

# NodeTable fields, in declaration order. The first eight (and the two
# list columns) define the nodes; the three profile columns are derived
# from the node class and only checked.
NODE_COLUMNS = ("names", "node_class", "vcpus", "mem_gb", "reserved_cpu",
                "reserved_mem", "used_cpu", "used_mem", "speed",
                "dyn_power_per_vcpu", "idle_power", "region", "power_state")
_PROFILE_COLUMNS = ("speed", "dyn_power_per_vcpu", "idle_power")


def fleet_from_columns(columns: Mapping[str, "np.ndarray | list"]
                       ) -> FleetState:
    """A port :class:`FleetState` (its ``Node`` list is ``.nodes``) from
    ``NodeTable``'s fields. ``region`` and ``power_state`` may be omitted
    (defaults: ``"default"`` and no lifecycle); the profile columns, when
    given, must equal what the node classes imply."""
    missing = [k for k in NODE_COLUMNS[:8] if k not in columns]
    if missing:
        raise KeyError(f"fleet columns missing {missing}")
    n = len(columns["names"])
    region = list(columns.get("region", ())) or ["default"] * n
    power_state = list(columns.get("power_state", ())) or [None] * n
    f64 = {k: np.asarray(columns[k], dtype=np.float64)
           for k in ("vcpus", "mem_gb", "reserved_cpu", "reserved_mem",
                     "used_cpu", "used_mem")}
    for k, col in [("node_class", columns["node_class"]),
                   ("region", region), ("power_state", power_state),
                   *f64.items()]:
        if len(col) != n:
            raise ValueError(f"column {k!r} has {len(col)} entries, "
                             f"expected {n}")
    nodes = [Node(str(columns["names"][i]), str(columns["node_class"][i]),
                  float(f64["vcpus"][i]), float(f64["mem_gb"][i]),
                  reserved_cpu=float(f64["reserved_cpu"][i]),
                  reserved_mem=float(f64["reserved_mem"][i]),
                  used_cpu=float(f64["used_cpu"][i]),
                  used_mem=float(f64["used_mem"][i]),
                  region=str(region[i]), power_state=power_state[i])
             for i in range(n)]
    fleet = FleetState.from_nodes(nodes)
    for k in _PROFILE_COLUMNS:
        if k in columns and not np.array_equal(
                np.asarray(columns[k], dtype=np.float64), getattr(fleet, k)):
            raise ValueError(f"column {k!r} disagrees with the node-class "
                             f"energy profiles")
    return fleet


def pods_from_records(records: Iterable[tuple]) -> list[Pod]:
    """Pods from ``(uid, kind, cpu, mem, base_time_s, scheduler,
    deferrable, deadline_s)`` records. A record whose kind and requests
    match a Table-II workload shares that ``WorkloadSpec``; any other gets
    its own."""
    pods = []
    for uid, kind, cpu, mem, bts, scheduler, deferrable, deadline_s \
            in records:
        spec = WORKLOADS.get(kind)
        if spec is None or (spec.cpu_request, spec.mem_request,
                            spec.base_time_s) != (cpu, mem, bts):
            spec = WorkloadSpec(str(kind), float(cpu), float(mem),
                                float(bts), "")
        pods.append(Pod(int(uid), spec, str(scheduler),
                        deferrable=bool(deferrable),
                        deadline_s=float(deadline_s)))
    return pods
