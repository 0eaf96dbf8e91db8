"""The ``carbon_autoscale`` cell of tests/engine_golden_spec.py on the port's
``cuda`` backend against its ``numpy`` backend, at the cell's 8 nodes and
at 2,048 (``make_scenario_cluster("mixed", n, seed=3)``, the cell's
arrivals and policies).

float32 scoring breaks some float64 near-ties another way (ROADMAP Queue
3), so the comparison is ``repro_torch.cluster.parity``'s replay, as in
chip_smoke.py's [policy] phase: every scoring call
of the cuda run (an engine round or a queue-pressure wake's scoring) is
scored again by the numpy run on the same fleet state — closeness within
1e-5, and each pick that differs a float64 near-tie under the same ledger
— and the numpy run then follows the cuda run's picks, so the two runs
must end equal: records, event log, counters, energy and carbon.

On the card (``-m gpu``) the cuda backend launches K3 once a call. The
same test runs on the CPU, where the cuda backend takes the kernels'
plain versions. The card's machine has no JAX: this file imports nothing
of it, nor the reference.
"""
import pytest
import torch

from repro_torch.cluster import parity
from repro_torch.cluster.node import make_scenario_cluster
from repro_torch.cluster.simulator import run_scenario
from repro_torch.cluster.workload import PoissonArrivals
from repro_torch.kernels import topsis_cuda


def _cell(backend, nodes, device, replay=None):
    stats = parity.policy_stats()
    carbon, autoscale = parity.policy_knobs()
    arrivals = PoissonArrivals(rate_per_s=0.3, n_bursts=3, burst_size=4,
                               seed=7, deferrable_share=0.5,
                               deadline_s=300.0)
    with parity.engine_scheduler(parity.make_policy_scheduler(stats,
                                                              replay)), \
            parity.wake_scoring(stats):
        res = run_scenario(
            arrivals, "energy_centric",
            cluster_factory=lambda: make_scenario_cluster("mixed", nodes,
                                                          seed=3),
            batch=True, batch_backend=backend, carbon=carbon,
            autoscale=autoscale, device=device)
    return res, stats


def _outcome(res):
    return ([(r.pod.uid, r.node, r.start_s, r.runtime_s, r.energy_j)
             for r in res.records], res.events,
            (res.unschedulable, res.preemptions, res.migrations, res.wakes,
             res.sleeps),
            res.total_carbon_g("topsis"), res.fleet_energy_kj(),
            res.fleet_carbon_g())


@pytest.mark.parametrize("nodes", [8, 2048])
@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_carbon_autoscale_cell_cuda_matches_numpy(device, nodes):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    topsis_cuda.reset_launches()
    got, cu = _cell("cuda", nodes, device)
    if device == "cuda":
        assert topsis_cuda.LAUNCHES["topsis_kinds"] == len(cu["calls"])
    assert cu["calls"] and cu["criteria"] == {6}
    assert all(c["mask"] for c in cu["calls"])
    assert got.wakes > 0 and got.sleeps > 0
    want, nps = _cell("numpy", nodes, device, replay=cu["calls"])
    assert len(nps["calls"]) == len(cu["calls"])
    assert max(c["err"] for c in nps["calls"]) <= 1e-5
    assert _outcome(got) == _outcome(want)
