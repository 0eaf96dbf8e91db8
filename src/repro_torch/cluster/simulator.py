"""Scenario driver over the discrete-event simulation kernel — port of
``repro.cluster.simulator``.

The event loop lives in ``repro_torch.cluster.engine``; this module is the
thin driver. :func:`run_scenario` keeps the reference's signature (plus a
``device``), maps the ``carbon=`` / ``autoscale=`` knob dataclasses onto
the ordered policy list ``[CarbonScheduling, AutoscaleScheduling]``
(``repro_torch.core.carbon``, ``repro_torch.core.elastic``), and hands the
run to :func:`repro_torch.cluster.engine.simulate`.

The paper's factorial experiment (§IV) is one point in the input space:
every pod arriving at t=0 (``PaperArrivals``) on the 4-node Table-I
cluster, no policies. ``table6()`` routes through this driver and
reproduces the reference's paper-mode output (tests/test_torch_engine.py
holds it against the live reference).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.carbon import CarbonPolicy, CarbonScheduling
from repro_torch.core.elastic import AutoscalePolicy, AutoscaleScheduling
from repro_torch.cluster.engine import (PodRecord, SimResult,  # noqa: F401
                                        simulate)              # (re-exported)
from repro_torch.cluster.node import Node, make_paper_cluster
from repro_torch.cluster.workload import ArrivalProcess, PaperArrivals


def run_scenario(arrivals: ArrivalProcess, scheme: str,
                 cluster_factory: Callable[[], list[Node]] = make_paper_cluster,
                 adaptive: bool = False, batch: bool = False,
                 batch_backend: str = "cuda",
                 carbon: CarbonPolicy | None = None,
                 autoscale: AutoscalePolicy | None = None,
                 explain: bool = False, device=None) -> SimResult:
    """Drive one scenario through the event-driven kernel.

    Events are pod-arrival bursts (from ``arrivals``) and task completions
    (from prior placements); each scheduling round walks the FIFO pending
    queue against current cluster state. Default-scheduler pods and
    per-pod TOPSIS go through ``select``; with ``batch=True`` the round's
    TOPSIS pods are scored in one ``BatchScheduler.select_many`` pass on
    ``batch_backend`` (the fleet-scale path; ``cuda`` by default, on
    ``device`` — ``None`` is the card).

    ``carbon`` (a :class:`~repro_torch.core.carbon.CarbonPolicy`) attaches
    the signal to the TOPSIS schedulers (sixth carbon-rate criterion) and
    the power timeline, and enables deferral/preemption temporal shifting;
    ``autoscale`` (an :class:`~repro_torch.core.elastic.AutoscalePolicy`)
    gives nodes the sleep/wake/drain lifecycle. Each maps onto one
    ``SchedulingPolicy``, composed in the fixed order ``[carbon,
    autoscale]``; with both at ``None`` the run is policy-free.

    ``explain=True`` records per-decision TOPSIS attributions
    (``SimResult.explanations``; numpy scoring only).
    """
    policies = []
    if carbon is not None:
        policies.append(CarbonScheduling(carbon))
    if autoscale is not None:
        policies.append(AutoscaleScheduling(autoscale))
    return simulate(arrivals, scheme, cluster_factory=cluster_factory,
                    adaptive=adaptive, batch=batch,
                    batch_backend=batch_backend, policies=policies,
                    explain=explain, device=device)


def run_experiment(level: str, scheme: str,
                   cluster_factory: Callable[[], list[Node]] = make_paper_cluster,
                   adaptive: bool = False, batch: bool = False,
                   batch_backend: str = "cuda", device=None) -> SimResult:
    """One cell of the paper's factorial design (competition level x scheme):
    the paper-mode arrival process (all pods at t=0, interleaved Table-V
    stream) through the event-driven kernel."""
    return run_scenario(PaperArrivals(level), scheme,
                        cluster_factory=cluster_factory, adaptive=adaptive,
                        batch=batch, batch_backend=batch_backend,
                        device=device)


def table6(levels=("low", "medium", "high"),
           schemes=("general", "energy_centric", "performance_centric",
                    "resource_efficient"), adaptive: bool = False):
    """Reproduce paper Table VI: energy (kJ) per (level, scheme) for both
    schedulers + optimization %. Returns nested dict."""
    out: dict[str, dict[str, dict[str, float]]] = {}
    for level in levels:
        out[level] = {}
        for scheme in schemes:
            res = run_experiment(level, scheme, adaptive=adaptive)
            dk = res.mean_energy_kj("default")
            tk = res.mean_energy_kj("topsis")
            out[level][scheme] = {
                "default_kj": dk,
                "topsis_kj": tk,
                "savings_kj": dk - tk,
                "optimization_pct": 100.0 * (dk - tk) / dk if dk else 0.0,
            }
    return out
