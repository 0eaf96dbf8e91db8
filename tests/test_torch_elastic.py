"""The port's elastic fleet (``repro_torch.core.elastic``: ``AutoscalePolicy``,
``always_on_fleet_idle_kj``, ``ElasticFleet``, ``AutoscaleScheduling``)
against the live reference ``repro.core.elastic``, in-process.

The module is a copy with its imports rewritten, so everything is held
equal, not close: validation messages word for word, the analytic
always-on baseline, and an ``ElasticFleet`` driven through one scripted
sequence of commits, completions, evictions, wakes (a pressure wake
scored by each package's own scheduler), a drain and ``close`` — node
states, return values and the ``PowerTimeline`` state ledger equal after
every step. Runs compare on fixed seeds (no hypothesis database).
"""
import dataclasses
import math

import jax  # noqa: F401
import numpy as np
import pytest
import torch  # noqa: F401

from repro.cluster import engine as R_engine
from repro.cluster import node as R_node
from repro.cluster import simulator as R_sim
from repro.cluster import workload as R_workload
from repro.core import elastic as R
from repro.core import energy as R_energy
from repro.core import scheduler as R_sched
from repro_torch.cluster import engine as P_engine
from repro_torch.cluster import node as P_node
from repro_torch.cluster import simulator as P_sim
from repro_torch.cluster import workload as P_workload
from repro_torch.core import elastic as P
from repro_torch.core import energy as P_energy
from repro_torch.core import scheduler as P_sched

PACKAGES = {
    "reference": dict(elastic=R, energy=R_energy, node=R_node,
                      workload=R_workload, engine=R_engine, sched=R_sched,
                      sim=R_sim),
    "port": dict(elastic=P, energy=P_energy, node=P_node,
                 workload=P_workload, engine=P_engine, sched=P_sched,
                 sim=P_sim),
}


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


POLICY_KWARGS = [
    dict(idle_timeout_s=0.0), dict(idle_timeout_s=-1.0),
    dict(idle_timeout_s=float("nan")), dict(consolidate_interval_s=0.0),
    dict(consolidate_interval_s=float("nan")),
    dict(consolidate_util_below=-0.1), dict(consolidate_util_below=1.5),
    dict(min_awake=-1),
]


@pytest.mark.parametrize("kwargs", POLICY_KWARGS,
                         ids=lambda kw: ",".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_autoscale_policy_validation_matches_reference(kwargs):
    assert (_message(lambda: P.AutoscalePolicy(**kwargs))
            == _message(lambda: R.AutoscalePolicy(**kwargs)))


def test_autoscale_policy_defaults_and_profiles_match_reference():
    assert (dataclasses.asdict(P.AutoscalePolicy())
            == dataclasses.asdict(R.AutoscalePolicy()))
    assert P.NODE_WAKE_PROFILES == R.NODE_WAKE_PROFILES
    assert P.POWER_STATES == R.POWER_STATES


@pytest.mark.parametrize("profile,n,horizon", [
    ("mixed", 8, 123.25), ("edge_heavy", 33, 3600.0), ("mixed", 4, 0.5)])
def test_always_on_fleet_idle_kj_matches_reference(profile, n, horizon):
    got = P.always_on_fleet_idle_kj(
        P_node.make_scenario_cluster(profile, n, seed=4), horizon)
    want = R.always_on_fleet_idle_kj(
        R_node.make_scenario_cluster(profile, n, seed=4), horizon)
    assert got == want > 0.0


def _ledger(timeline):
    return ([dataclasses.astuple(iv) for iv in timeline.state_intervals],
            [dataclasses.astuple(w) for w in timeline.wake_transitions])


def _scripted(pkg):
    """Drive one ElasticFleet of ``pkg`` through a fixed sequence; yield
    (step, what the step returned, states, ledger, counters) after every
    step."""
    m = PACKAGES[pkg]
    E, W = m["elastic"], m["workload"]
    nodes = m["node"].make_scenario_cluster("mixed", 6, seed=1)
    fleet_state = m["node"].FleetState.from_nodes(nodes)
    timeline = m["energy"].PowerTimeline()
    policy = E.AutoscalePolicy(idle_timeout_s=10.0, min_awake=1,
                               consolidate_interval_s=60.0,
                               consolidate_util_below=0.9)
    fleet = E.ElasticFleet(fleet_state.nodes, policy, timeline)
    fleet.table = fleet_state
    sched = m["sched"].BatchScheduler("energy_centric", backend="numpy")
    sched.attach(fleet_state)
    pods = [W.Pod(i, W.WORKLOADS[k], "topsis", deferrable=(i == 2),
                  deadline_s=30.0)
            for i, k in enumerate(("light", "medium", "complex", "light"))]
    running = []

    def commit(i, pod, t):
        fleet_state.bind(i, pod.cpu, pod.mem)
        start = fleet.on_commit(i, t)
        running.append(m["engine"].RunningTask(start + 5.0, pod.uid, pod, i,
                                               0, 0))
        return start

    def evict(i, t):
        task = next(r for r in running if r.node_index == i)
        running.remove(task)
        fleet_state.release(i, task.pod.cpu, task.pod.mem)
        fleet.on_evict(i, t)

    def complete(i, t):
        task = next(r for r in running if r.node_index == i)
        running.remove(task)
        fleet_state.release(i, task.pod.cpu, task.pod.mem)
        fleet.on_complete(i, t)

    steps = [
        ("write_states", lambda: fleet.write_states(1.0)),
        ("commit", lambda: commit(1, pods[0], 2.0)),
        ("commit", lambda: commit(2, pods[1], 3.0)),
        ("states", lambda: fleet.states(9.0)),
        ("exclude_mask", lambda: fleet.exclude_mask(15.0).tolist()),
        ("complete", lambda: complete(1, 12.0)),
        ("write_states", lambda: fleet.write_states(16.0)),
        ("wake_for_pressure", lambda: fleet.wake_for_pressure(
            sched, pods[2:], 20.0)),
        ("next_transition", lambda: fleet.next_transition(20.0)),
        ("exclude_for_deadline", lambda: fleet.exclude_for_deadline(
            fleet.exclude_mask(21.0), 21.5).tolist()),
        ("commit_waking", lambda: commit(
            next(i for i, s in enumerate(fleet.states(21.0))
                 if s == E.WAKING), pods[2], 21.0)),
        ("advance_to", lambda: fleet.advance_to(40.0)),
        ("states", lambda: fleet.states(40.0)),
        ("victims", lambda: [
            (d, [e.uid for e in vs]) for d, vs in [fleet.consolidation_victims(
                41.0, running, lambda pod: pod.deadline_s)]]),
        ("evict", lambda: evict(2, 41.0)),
        ("force_sleep", lambda: fleet.force_sleep(2, 41.0)),
        ("write_states", lambda: fleet.write_states(41.0)),
        ("request_wake", lambda: fleet.request_wake(4, 50.0)),
        ("states", lambda: fleet.states(51.0)),
        ("close", lambda: fleet.close(53.0)),
    ]
    for name, step in steps:
        out = step()
        yield (name, out, fleet.states(60.0), _ledger(timeline),
               (fleet.wakes, fleet.sleeps),
               [n.power_state for n in fleet_state.nodes],
               list(fleet_state.power_state))


def test_elastic_fleet_scripted_sequence_matches_reference():
    ref = list(_scripted("reference"))
    got = list(_scripted("port"))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g == r, g[0]
    names = [s[0] for s in got]
    ledger_states = {iv[2] for iv in got[-1][3][0]}
    # the script reaches every state and both ledgers
    assert {P.IDLE, P.ASLEEP, P.WAKING} <= ledger_states, names
    assert got[-1][4][0] >= 2 and got[-1][4][1] >= 1


def _policy_run(pkg, seed, profile, autoscale):
    m = PACKAGES[pkg]
    arrivals = m["workload"].PoissonArrivals(rate_per_s=0.3, n_bursts=3,
                                             burst_size=4, seed=seed)
    kw = {} if pkg == "reference" else {"device": "cpu"}
    return m["sim"].run_scenario(
        arrivals, "energy_centric",
        cluster_factory=lambda: m["node"].make_scenario_cluster(
            profile, 8, seed=seed),
        batch=True, batch_backend="numpy",
        autoscale=(None if autoscale is None
                   else m["elastic"].AutoscalePolicy(**autoscale)), **kw)


def _outcome(res):
    return ([(r.pod.uid, r.node, r.start_s, r.runtime_s, r.energy_j)
             for r in res.records],
            _ledger(res.timeline), res.events,
            (res.unschedulable, res.wakes, res.sleeps, res.migrations),
            res.fleet_idle_energy_kj(), res.fleet_energy_kj(),
            res.energy_kj("topsis"))


@pytest.mark.parametrize("seed,profile", [(0, "mixed"), (32163, "mixed"),
                                          (7, "edge_heavy")])
def test_always_on_policy_is_inert_like_reference(seed, profile):
    """``idle_timeout_s=inf``: no node sleeps or wakes, the ledger holds
    IDLE stretches only, and the port's run equals the reference's; so
    does the policy-free run (an empty ledger)."""
    always_on = dict(idle_timeout_s=math.inf)
    got = _policy_run("port", seed, profile, always_on)
    assert _outcome(got) == _outcome(_policy_run("reference", seed, profile,
                                                 always_on))
    assert got.wakes == got.sleeps == got.migrations == 0
    assert {iv.state for iv in got.timeline.state_intervals} == {P.IDLE}
    assert not got.timeline.wake_transitions
    free = _policy_run("port", seed, profile, None)
    assert _outcome(free) == _outcome(_policy_run("reference", seed, profile,
                                                  None))
    assert not free.timeline.state_intervals
    assert [r.pod.uid for r in got.records] == [r.pod.uid
                                               for r in free.records]
