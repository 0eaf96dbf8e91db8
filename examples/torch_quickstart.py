"""GreenPod quickstart on the PyTorch port: make one placement decision by
hand on the paper's cluster, on the numpy backend and on the card (the
cuda backend scores it through the TOPSIS kernel K1), then schedule the
paper's AIoT workload with both schedulers and print the energy outcome.
The port's counterpart of ``examples/quickstart.py``.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.cluster.node import make_paper_cluster
from repro_torch.cluster.simulator import run_experiment
from repro_torch.cluster.workload import WORKLOADS, Pod
from repro_torch.core.scheduler import GreenPodScheduler, decision_matrix
from repro_torch.device import resolve_device

BACKENDS = ("numpy", "cuda")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the cuda backend (default: the "
                         "CUDA card; 'cpu' runs the kernel's plain version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. one placement decision, step by step -----------------------------
    nodes = make_paper_cluster()
    pod = Pod(uid=0, workload=WORKLOADS["medium"], scheduler="topsis")
    matrix = decision_matrix(pod, nodes)
    print("decision matrix (exec_s, energy_J, cores, memory, balance):")
    for n, row in zip(nodes, matrix):
        print(f"  {n.name:13s} {np.round(row, 3)}")

    picks, closeness = {}, {}
    for backend in BACKENDS:
        sched = GreenPodScheduler("energy_centric", backend=backend,
                                  device=dev)
        idx, diag = sched.select(pod, nodes)
        picks[backend] = idx
        closeness[backend] = np.asarray(diag["closeness"], np.float64)
        print(f"GreenPod (energy-centric, {backend}) binds the pod to: "
              f"{nodes[idx].name} (closeness {closeness[backend][idx]:.3f})")

    # --- 2. the paper's experiment: medium competition, energy-centric -------
    res = run_experiment("medium", "energy_centric", device=dev)
    dk = res.mean_energy_kj("default")
    tk = res.mean_energy_kj("topsis")
    pct = 100 * (dk - tk) / dk
    sched_ms = res.mean_sched_time_ms("topsis")
    print("\nmedium competition, energy-centric profile:")
    print(f"  default K8s : {dk:.4f} kJ/pod")
    print(f"  GreenPod    : {tk:.4f} kJ/pod")
    print(f"  energy optimization: {pct:.2f}% (paper Table VI: 39.13%)")
    print(f"  TOPSIS scheduling overhead: {sched_ms:.3f} ms/pod")
    return {"device": str(dev), "nodes": [n.name for n in nodes],
            "matrix": matrix, "pick": picks, "closeness": closeness,
            "default_kj": dk, "topsis_kj": tk, "optimization_pct": pct,
            "sched_ms": sched_ms}


if __name__ == "__main__":
    main()
