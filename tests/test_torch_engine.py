"""The port's engine and simulator (``repro_torch.cluster``) against the
live reference engine, in-process.

Every cell of tests/engine_golden_spec.py (``policy_free``, ``carbon_only``,
``autoscale_only``, ``carbon_autoscale``) is re-created with the port's
classes and run on each port backend (numpy, torch, cuda; the last two on
the CPU here). Placements, uids, start and run times, energies, carbon,
counters and the event log must equal the live reference
``run_cell(name, ...)`` exactly — never the JSON golden, which was
recorded on another stack. ``table6()`` must equal the reference's.
"""
import dataclasses

import jax  # noqa: F401
import numpy as np
import pytest
import torch

import engine_golden_spec as spec
from repro.cluster import simulator as R_sim
from repro_torch.cluster import parity
from repro_torch.cluster.node import make_scenario_cluster
from repro_torch.cluster.simulator import (run_experiment, run_scenario,
                                           table6)
from repro_torch.cluster.workload import PoissonArrivals
from repro_torch.core.carbon import CarbonPolicy, diurnal_fleet_signal
from repro_torch.core.elastic import AutoscalePolicy

POLICY_CELLS = ("carbon_only", "autoscale_only", "carbon_autoscale")

_REF_CACHE: dict = {}


def _ref_cell(backend, name="policy_free"):
    if (name, backend) not in _REF_CACHE:
        _REF_CACHE[name, backend] = spec.run_cell(name, backend)
    return _REF_CACHE[name, backend]


def port_policies(name):
    """The carbon and autoscale knobs of ``spec.SCENARIOS[name]``, built
    from port classes with ``spec``'s constants."""
    cell = spec.SCENARIOS[name]
    period = spec.PERIOD_S
    carbon = CarbonPolicy(
        diurnal_fleet_signal(base=300.0, amplitude=200.0, period_s=period,
                             phase_s=period / 4.0, stagger_s=period / 16.0),
        defer_threshold=300.0, preempt_threshold=450.0,
        check_interval_s=30.0) if cell["carbon"] else None
    autoscale = AutoscalePolicy(
        idle_timeout_s=20.0, min_awake=1, consolidate_interval_s=60.0,
        consolidate_util_below=0.3) if cell["autoscale"] else None
    return carbon, autoscale


def _port_cell(backend, name="policy_free", device="cpu"):
    """``spec.run_cell(name, ...)`` rebuilt from port classes."""
    cell = spec.SCENARIOS[name]
    arrivals = PoissonArrivals(rate_per_s=0.3, n_bursts=3, burst_size=4,
                               seed=7,
                               deferrable_share=(0.5 if cell["deferrable"]
                                                 else 0.0),
                               deadline_s=300.0)
    carbon, autoscale = port_policies(name)
    return run_scenario(
        arrivals, "energy_centric",
        cluster_factory=lambda: make_scenario_cluster("mixed", 8, seed=3),
        batch=True, batch_backend=backend, carbon=carbon,
        autoscale=autoscale, device=device)


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
        "total_carbon_g": _carbon(res, lambda r: r.total_carbon_g("topsis")),
        "fleet_carbon_g": _carbon(res, lambda r: r.fleet_carbon_g()),
    }


def _carbon(res, read):
    """A carbon total, or None for a run without a carbon signal (which
    raises on the read)."""
    return read(res) if res.timeline.carbon_signal is not None else None


@pytest.mark.parametrize("ref_backend", ["numpy", "jax"])
@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_policy_free_cell_matches_live_reference(backend, ref_backend):
    ref, got = _ref_cell(ref_backend), _port_cell(backend)
    assert len(got.records) == len(ref.records) > 0
    assert _records(got) == _records(ref)
    assert _metrics(got) == _metrics(ref)
    assert got.events == ref.events


@pytest.mark.parametrize("ref_backend", ["numpy", "jax"])
@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
@pytest.mark.parametrize("name", POLICY_CELLS)
def test_policy_cell_matches_live_reference(name, backend, ref_backend):
    """The carbon and autoscale policies through ``run_scenario``: records,
    event logs, counters, energies and carbon exactly as the reference's."""
    ref, got = _ref_cell(ref_backend, name), _port_cell(backend, name)
    assert len(got.records) == len(ref.records) > 0
    assert _records(got) == _records(ref)
    assert _metrics(got) == _metrics(ref)
    assert got.events == ref.events



def test_parity_policy_knobs_are_the_carbon_autoscale_cell():
    """chip_smoke.py's [policy] phase and tests/test_torch_policies.py take
    their policies from ``parity.policy_knobs``: they are this cell's."""
    (carbon, autoscale) = parity.policy_knobs()
    want_carbon, want_autoscale = port_policies("carbon_autoscale")
    assert autoscale == want_autoscale
    assert vars(carbon.signal) == vars(want_carbon.signal)
    assert ({f.name: getattr(carbon, f.name)
             for f in dataclasses.fields(carbon) if f.name != "signal"}
            == {f.name: getattr(want_carbon, f.name)
                for f in dataclasses.fields(want_carbon)
                if f.name != "signal"})


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
