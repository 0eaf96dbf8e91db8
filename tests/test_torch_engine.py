"""The port's engine and simulator (``repro_torch.cluster``) against the
live reference engine, in-process.

The ``policy_free`` cell of tests/engine_golden_spec.py is re-created with
the port's classes and run on each port backend (numpy, torch, cuda; the
last two on the CPU here). Placements, uids, start and run times, energies,
counters and the event log must equal the live reference
``run_cell("policy_free", ...)`` exactly — never the JSON golden, which was
recorded on another stack. ``table6()`` must equal the reference's.
"""
import jax  # noqa: F401
import numpy as np
import pytest
import torch

import engine_golden_spec as spec
from repro.cluster import simulator as R_sim
from repro_torch.cluster.node import make_scenario_cluster
from repro_torch.cluster.simulator import (run_experiment, run_scenario,
                                           table6)
from repro_torch.cluster.workload import PoissonArrivals

_REF_CACHE: dict = {}


def _ref_cell(backend):
    if backend not in _REF_CACHE:
        _REF_CACHE[backend] = spec.run_cell("policy_free", backend)
    return _REF_CACHE[backend]


def _port_cell(backend):
    """``spec.run_cell("policy_free", ...)`` rebuilt from port classes."""
    arrivals = PoissonArrivals(rate_per_s=0.3, n_bursts=3, burst_size=4,
                               seed=7, deferrable_share=0.0,
                               deadline_s=300.0)
    return run_scenario(
        arrivals, "energy_centric",
        cluster_factory=lambda: make_scenario_cluster("mixed", 8, seed=3),
        batch=True, batch_backend=backend, device="cpu")


def _records(res):
    return [(r.pod.uid, r.pod.workload.kind, r.pod.scheduler, r.node,
             r.node_class, r.start_s, r.runtime_s, r.energy_j, r.arrival_s)
            for r in res.records]


def _metrics(res):
    return {
        "unschedulable": res.unschedulable,
        "unschedulable_rate": res.unschedulable_rate(),
        "preemptions": res.preemptions, "migrations": res.migrations,
        "wakes": res.wakes, "sleeps": res.sleeps,
        "energy_topsis_kj": res.energy_kj("topsis"),
        "energy_default_kj": res.energy_kj("default"),
        "mean_energy_topsis_kj": res.mean_energy_kj("topsis"),
        "mean_exec_topsis_s": res.mean_exec_time_s("topsis"),
        "fleet_idle_energy_kj": res.fleet_idle_energy_kj(),
        "fleet_energy_kj": res.fleet_energy_kj(),
        "allocation": res.allocation("topsis"),
    }


@pytest.mark.parametrize("ref_backend", ["numpy", "jax"])
@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_policy_free_cell_matches_live_reference(backend, ref_backend):
    ref, got = _ref_cell(ref_backend), _port_cell(backend)
    assert len(got.records) == len(ref.records) > 0
    assert _records(got) == _records(ref)
    assert _metrics(got) == _metrics(ref)
    assert got.events == ref.events


@pytest.mark.parametrize("level", ["low", "medium", "high"])
def test_table6_matches_reference(level):
    assert table6(levels=(level,)) == R_sim.table6(levels=(level,))


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_batch_experiment_matches_reference(backend):
    ref = R_sim.run_experiment("high", "energy_centric", batch=True,
                               batch_backend="numpy")
    got = run_experiment("high", "energy_centric", batch=True,
                         batch_backend=backend, device="cpu")
    assert _records(got) == _records(ref)
    assert _metrics(got) == _metrics(ref)


@pytest.mark.parametrize("knob", ["carbon", "autoscale"])
def test_unported_policies_raise(knob):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_scenario(PoissonArrivals(n_bursts=1), "energy_centric",
                     **{knob: object()})


def test_batch_run_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scenario(PoissonArrivals(n_bursts=1), "energy_centric",
                     batch=True)


def test_per_pod_run_needs_no_card():
    """The per-pod GreenPod path is numpy, as in the reference, so the
    paper-mode entry points run anywhere."""
    res = run_experiment("low", "general")
    ref = R_sim.run_experiment("low", "general")
    assert _records(res) == _records(ref)
    assert np.isfinite(res.mean_energy_kj("topsis"))
