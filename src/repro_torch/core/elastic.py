"""Elastic fleet subsystem: node power-state lifecycle and autoscale
policies — port of ``repro.core.elastic`` (a copy, imports rewritten).

GreenPod's energy wins come from consolidating work onto frugal nodes, but a
fleet without a node lifecycle pays every node's idle power forever. This
module makes powering idle capacity down — the biggest energy lever in
edge-cloud orchestration — a first-class scheduling dimension:

1. **Power-state machine** (``ElasticFleet``): every node is in one of four
   states::

       ACTIVE --(last task ends)--> IDLE --(idle_timeout_s)--> ASLEEP
         ^                           |                            |
         |                           +--(task commits)            |
         +--(wake completes, tasks)--WAKING <--(policy wake)------+

   * ``ACTIVE`` — ≥1 committed task; baseline idle power is attributed to
     the schedulers keeping the node awake (the legacy busy-union
     accounting, unchanged).
   * ``IDLE``   — awake but empty; draws full idle power, charged to the
     fleet's state ledger. An IDLE node has *zero marginal idle cost* for
     the TOPSIS energy criterion — it is already paying to be awake.
   * ``ASLEEP`` — suspended; draws ``sleep_power_w`` (a few percent of
     idle), is excluded from scheduling, and is only brought back by a
     policy wake.
   * ``WAKING`` — transitioning ASLEEP→awake; draws idle power for the
     class's ``wake_latency_s`` plus a one-shot ``wake_energy_j`` surge.
     Pods may be committed to a WAKING node — they start exactly when the
     wake completes.

   Sleep transitions are *lazy*: an IDLE node's fall-asleep instant is the
   deterministic ``idle_since + idle_timeout_s``, so the state at any query
   time — and the exact ledger intervals — are derived without event-loop
   ticks. Wake completions are real events (the engine re-runs a scheduling
   round when one lands).

2. **AutoscalePolicy** — the knobs the event-driven engine consumes:
   idle-timeout sleep, queue-pressure wake (pods that end a round unplaced
   wake the TOPSIS-best sleeping node, scored by the same 6-criteria stack
   on any backend), and periodic consolidation (low-utilization nodes are
   drained through the preemption/requeue machinery — every victim must fit
   on the remaining awake fleet *now*, and a deferrable victim is never
   drained past its deadline — then put straight to sleep).

With no policy attached (``run_scenario(..., autoscale=None)``) none of
this machinery runs and the engine reproduces the policy-free output
bitwise (tests/test_torch_engine.py and tests/test_torch_elastic.py hold
the port against the live reference).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import telemetry
from repro_torch.core.energy import NODE_ENERGY_PROFILES
from repro_torch.core.policy import (CONSOLIDATE_TICK, WAKE_DONE, Event,
                                     SchedulingPolicy)

# Canonical power-state names (NodeTable carries them as a column; the
# ``awake`` criterion derives from them when set).
ACTIVE = "active"
IDLE = "idle"
ASLEEP = "asleep"
WAKING = "waking"
POWER_STATES = (ACTIVE, IDLE, ASLEEP, WAKING)
AWAKE_STATES = frozenset((ACTIVE, IDLE, WAKING))

# --- per-class wake/sleep profiles ------------------------------------------
# A suspended node retains a wake-on-LAN residual draw (fraction of idle);
# waking draws idle power for the class's boot latency plus a one-shot surge
# (spin-up, cache warm) modelled as an energy lump. Frugal edge boxes (A)
# resume fast; the beefy class-C tier pays the longest latency.
SLEEP_POWER_FRACTION = 0.05
WAKE_SURGE_FACTOR = 2.0
_WAKE_LATENCY_S = {"A": 2.0, "B": 4.0, "C": 8.0, "default": 4.0}

NODE_WAKE_PROFILES: dict[str, dict[str, float]] = {
    cls: {
        "wake_latency_s": _WAKE_LATENCY_S[cls],
        "sleep_power_w": SLEEP_POWER_FRACTION * prof["idle_power"],
        "wake_energy_j": (WAKE_SURGE_FACTOR * prof["idle_power"]
                          * _WAKE_LATENCY_S[cls]),
    }
    for cls, prof in NODE_ENERGY_PROFILES.items()
}


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Elasticity configuration for the event-driven engine
    (``repro_torch.cluster.simulator.run_scenario(..., autoscale=...)``).

    * ``idle_timeout_s`` — a node empty for this long falls ASLEEP
      (``math.inf`` keeps the fleet always-on: full state accounting, no
      sleeping — the baseline the idle-energy savings are measured against).
    * ``wake_on_pressure`` — pods that end a scheduling round unplaced wake
      the TOPSIS-best sleeping node that fits them (one wake per uncovered
      pod, FIFO); with this off, sleeping capacity is only recovered by
      consolidationless attrition, so pods can go unschedulable while
      capacity sleeps.
    * ``consolidate_interval_s`` — cadence of the periodic consolidation
      pass (``None`` disables): awake nodes with cpu utilization below
      ``consolidate_util_below`` are drained — their running tasks are
      evicted, requeued, and re-placed by the normal TOPSIS round — and put
      straight to sleep. A node is only drained when every one of its tasks
      fits on the remaining awake fleet at drain time, and never when that
      would start a deferrable pod past its deadline.
    * ``min_awake`` — the first ``min_awake`` nodes never auto-sleep and are
      never drained (a deterministic awake floor that keeps the fleet
      schedulable without waiting a wake latency).
    """

    idle_timeout_s: float = 60.0
    wake_on_pressure: bool = True
    consolidate_interval_s: float | None = None
    consolidate_util_below: float = 0.25
    min_awake: int = 1

    def __post_init__(self):
        if math.isnan(self.idle_timeout_s) or self.idle_timeout_s <= 0.0:
            raise ValueError(f"idle_timeout_s must be positive (inf keeps "
                             f"the fleet always-on), got {self.idle_timeout_s}")
        if self.consolidate_interval_s is not None and not (
                self.consolidate_interval_s > 0.0):
            raise ValueError(f"consolidate_interval_s must be positive or "
                             f"None, got {self.consolidate_interval_s}")
        if not 0.0 <= self.consolidate_util_below <= 1.0:
            raise ValueError(f"consolidate_util_below must be in [0, 1], "
                             f"got {self.consolidate_util_below}")
        if self.min_awake < 0:
            raise ValueError(f"min_awake must be >= 0, got {self.min_awake}")


def always_on_fleet_idle_kj(nodes: Sequence, horizon_s: float) -> float:
    """Fleet idle energy of a lifecycle-free (or never-sleeping) fleet:
    every node draws its idle power for the whole horizon. This is the
    analytic baseline autoscale policies are measured against
    (the reference's benchmarks/autoscale_sweep.py).
    ``SimResult.fleet_idle_energy_kj`` on an ``autoscale=None`` run counts
    only busy-union idle — its state ledger is empty by design — so
    comparing policies through that method alone would undercount the
    no-policy fleet's true idle draw; use this for the baseline side."""
    return sum(NODE_ENERGY_PROFILES[n.node_class]["idle_power"]
               for n in nodes) * horizon_s / 1000.0


def _best_node(sched, pod, nodes, t, exclude):
    """Highest-closeness feasible node under the run's own TOPSIS scheduler
    (per-pod or batched — whichever the engine is using), with ``exclude``
    masking everything that is not a wake candidate."""
    if hasattr(sched, "select_many"):
        assignments, _ = sched.select_many([pod], nodes, now=t,
                                           exclude=exclude)
        return assignments[0]
    idx, _ = sched.select(pod, nodes, now=t, exclude=exclude)
    return idx


class ElasticFleet:
    """Per-node power-state machine driven by the event-driven engine.

    Tracks, per node: the committed-task count, when the node last became
    empty (``IDLE``), an optional drain-forced sleep instant, and an
    in-flight wake (``WAKING`` until ``wake_ready``). States are *queried*
    at a time ``t`` (sleep transitions are lazy, see module docstring); the
    corresponding IDLE/ASLEEP/WAKING intervals are materialized into the
    run's ``PowerTimeline`` state ledger exactly when a node leaves them
    (or at :meth:`close`), so state-dependent idle power and wake-transition
    energy are accounted without time-stepping.
    """

    def __init__(self, nodes: Sequence, policy: AutoscalePolicy,
                 timeline, t0: float = 0.0):
        self.nodes = nodes
        self.policy = policy
        self.timeline = timeline
        # optional delta-maintained FleetState (the engine's source of
        # truth): when attached, write_states mirrors power-state changes
        # into its columns — marking transitioned nodes dirty, which is
        # what keeps the schedulers' incremental energy/carbon criteria
        # (they depend on the awake mask) in sync — and wake scoring runs
        # against it instead of re-flattening the Node list
        self.table = None
        n = len(nodes)
        self._running = [0] * n
        # when the node last became empty (None while ACTIVE or WAKING)
        self._idle_since: list[float | None] = [t0] * n
        # drain-forced sleep instant (skips the idle timeout)
        self._sleep_at: list[float | None] = [None] * n
        # in-flight wake: request time and completion time
        self._wake_started: list[float | None] = [None] * n
        self._wake_ready: list[float | None] = [None] * n
        self.wakes = 0
        self.sleeps = 0
        self.write_states(t0)

    # --- state queries -------------------------------------------------------
    def _sleep_due(self, i: int) -> float:
        """The instant node i falls (or fell) asleep, given its current
        idle stretch; inf when it cannot auto-sleep."""
        since = self._idle_since[i]
        if since is None:
            return math.inf
        if self._sleep_at[i] is not None:
            return self._sleep_at[i]
        if i < self.policy.min_awake:
            return math.inf
        return since + self.policy.idle_timeout_s

    def state(self, i: int, t: float) -> str:
        if self._wake_ready[i] is not None:
            return WAKING            # advance_to() clears completed wakes
        if self._running[i] > 0:
            return ACTIVE
        return ASLEEP if t >= self._sleep_due(i) else IDLE

    def states(self, t: float) -> list[str]:
        return [self.state(i, t) for i in range(len(self.nodes))]

    def write_states(self, t: float) -> list[str]:
        """Refresh every ``Node.power_state`` (the column the
        awake/marginal-idle criterion derives from); with an attached
        :attr:`table` the FleetState column is synced too, dirtying exactly
        the nodes that transitioned."""
        sts = self.states(t)
        for node, s in zip(self.nodes, sts):
            node.power_state = s
        if self.table is not None:
            self.table.set_power_states(sts)
        return sts

    def exclude_mask(self, t: float) -> np.ndarray:
        """(N,) bool: nodes no scheduler may place on this round (ASLEEP —
        capacity comes back only through a policy wake)."""
        return np.asarray([s == ASLEEP for s in self.states(t)])

    def exclude_for_deadline(self, base: np.ndarray,
                             deadline: float) -> np.ndarray:
        """``base`` plus WAKING nodes whose wake completes after
        ``deadline`` — a deferrable pod must never be started past it, and
        a pod committed to a WAKING node starts at its ready time."""
        ready = np.asarray([-math.inf if r is None else r
                            for r in self._wake_ready])
        return base | (ready > deadline)

    def next_transition(self, t: float) -> float | None:
        """Earliest in-flight wake completion strictly after ``t`` (the only
        state transition needing an engine event — sleeps are lazy and
        change no scheduling outcome until a round queries them)."""
        cands = [r for r in self._wake_ready if r is not None and r > t]
        return min(cands) if cands else None

    # --- ledger materialization ----------------------------------------------
    def _materialize_idle(self, i: int, upto: float) -> None:
        """Flush node i's open idle stretch (and the ASLEEP tail it lazily
        decayed into) to the state ledger, up to ``upto``."""
        since = self._idle_since[i]
        if since is None:
            return
        node = self.nodes[i]
        due = self._sleep_due(i)
        self.timeline.add_state(
            node.name, node.node_class, IDLE, since, min(upto, due),
            NODE_ENERGY_PROFILES[node.node_class]["idle_power"])
        if upto > due:
            self.timeline.add_state(
                node.name, node.node_class, ASLEEP, max(due, since), upto,
                NODE_WAKE_PROFILES[node.node_class]["sleep_power_w"])
            self.sleeps += 1
            telemetry.active().inc("policy_node_sleeps",
                                   policy="AutoscaleScheduling")
        self._idle_since[i] = None
        self._sleep_at[i] = None

    def advance_to(self, t: float) -> None:
        """Finalize wake transitions completed by ``t`` (called whenever the
        engine's clock advances): the WAKING interval lands in the ledger
        and the node becomes ACTIVE (tasks were committed while it woke) or
        IDLE."""
        for i, ready in enumerate(self._wake_ready):
            if ready is None or ready > t:
                continue
            node = self.nodes[i]
            self.timeline.add_state(
                node.name, node.node_class, WAKING,
                self._wake_started[i], ready,
                NODE_ENERGY_PROFILES[node.node_class]["idle_power"])
            self._wake_started[i] = None
            self._wake_ready[i] = None
            self._idle_since[i] = ready if self._running[i] == 0 else None

    # --- engine hooks --------------------------------------------------------
    def on_commit(self, i: int, t: float) -> float:
        """Resources bound on node i at clock ``t``; returns the task's
        effective start — ``t``, or the wake-completion instant when the
        node is still WAKING."""
        if self._wake_ready[i] is not None:
            start = self._wake_ready[i]
        else:
            if t >= self._sleep_due(i):
                raise RuntimeError(
                    f"commit on sleeping node {self.nodes[i].name} at t={t} "
                    f"(the engine must exclude ASLEEP nodes)")
            start = t
            self._materialize_idle(i, t)
        self._running[i] += 1
        self._idle_since[i] = None
        return start

    def on_complete(self, i: int, end_t: float) -> None:
        self._running[i] -= 1
        if self._running[i] == 0 and self._wake_ready[i] is None:
            self._idle_since[i] = end_t

    def on_evict(self, i: int, t: float) -> None:
        """A running task was preempted/drained off node i at ``t``."""
        self.on_complete(i, t)

    def request_wake(self, i: int, t: float) -> float:
        """ASLEEP → WAKING at ``t``: flushes the idle/asleep stretch, posts
        the wake-surge energy lump, and returns the ready instant."""
        node = self.nodes[i]
        self._materialize_idle(i, t)
        prof = NODE_WAKE_PROFILES[node.node_class]
        self._wake_started[i] = t
        self._wake_ready[i] = t + prof["wake_latency_s"]
        self.timeline.add_wake(node.name, node.node_class, t,
                               prof["wake_energy_j"])
        self.wakes += 1
        telemetry.active().inc("policy_node_wakes",
                               policy="AutoscaleScheduling")
        return self._wake_ready[i]

    def force_sleep(self, i: int, t: float) -> None:
        """Drain completed: the (now empty) node sleeps immediately,
        skipping the idle timeout."""
        self._idle_since[i] = t
        self._sleep_at[i] = t

    def close(self, horizon: float) -> None:
        """End of run: flush every open state interval up to ``horizon``."""
        for i, node in enumerate(self.nodes):
            ready = self._wake_ready[i]
            if ready is not None:
                # a wake still in flight (pressure-woken, pods landed
                # elsewhere): charge the transition up to the horizon
                self.timeline.add_state(
                    node.name, node.node_class, WAKING,
                    self._wake_started[i], min(ready, horizon),
                    NODE_ENERGY_PROFILES[node.node_class]["idle_power"])
                self._wake_started[i] = None
                self._wake_ready[i] = None
                if ready < horizon and self._running[i] == 0:
                    self._idle_since[i] = ready
                    self._sleep_at[i] = None
                    self._materialize_idle(i, horizon)
                continue
            self._materialize_idle(i, horizon)

    # --- autoscale decisions -------------------------------------------------
    def wake_for_pressure(self, sched, pods: Sequence, t: float) -> list[int]:
        """Queue-pressure wake: walk the still-pending queue FIFO; each pod
        not covered by capacity woken earlier in this pass wakes the
        TOPSIS-best sleeping node that fits it (scored by the run's own
        scheduler — same 6-criteria stack, any backend). Returns the woken
        node indices."""
        if not self.policy.wake_on_pressure:
            return []
        asleep = np.asarray([s == ASLEEP for s in self.states(t)])
        if not asleep.any():
            return []
        woken: list[int] = []
        free: dict[int, list[float]] = {}
        for pod in pods:
            covered = False
            for j in woken:
                if free[j][0] >= pod.cpu - 1e-9 and free[j][1] >= pod.mem - 1e-9:
                    free[j][0] -= pod.cpu
                    free[j][1] -= pod.mem
                    covered = True
                    break
            if covered:
                continue
            idx = _best_node(sched, pod,
                             self.table if self.table is not None
                             else self.nodes, t, exclude=~asleep)
            if idx is None:
                continue                 # fits no sleeping node either
            self.request_wake(idx, t)
            asleep[idx] = False
            woken.append(idx)
            free[idx] = [self.nodes[idx].free_cpu - pod.cpu,
                         self.nodes[idx].free_mem - pod.mem]
        return woken

    def consolidation_victims(self, t: float, running: Sequence,
                              deadline_of: Callable) -> tuple[list[int],
                                                              list]:
        """Pick this pass's drain targets: awake ACTIVE nodes (index ≥
        ``min_awake``) with cpu utilization below the policy threshold,
        lowest first. A node is drained only if (a) the awake floor
        survives, (b) none of its tasks belongs to a deferrable pod at or
        past its deadline (the restart must start ≤ deadline), and (c)
        every one of its tasks fits on the remaining awake, non-draining
        fleet right now (first-fit capacity ledger over ACTIVE/IDLE nodes —
        WAKING capacity is not counted, so a migrated deferrable pod is
        never forced past its deadline by a wake latency). The engine
        requeues victims at the *front* of the pending queue, so the
        fit-check holds against same-round arrivals.

        The TOPSIS round re-places victims by score, not by this ledger's
        first-fit order, so for *deferrable* victims (the class with a
        hard never-start-past-deadline contract) the bar is stricter and
        order-independent: the victim must fit on some awake node even if
        every other victim of the pass landed on that same node first.
        Non-deferrable victims keep the first-fit proof — in the rare
        packing divergence they retry like any pending pod (worst case a
        pressure wake recovers the capacity). ``running`` holds the
        kernel's ``RunningTask`` entries; returns (drained node indices,
        victim entries)."""
        sts = self.states(t)
        by_node: dict[int, list] = {}
        for e in running:
            by_node.setdefault(e.node_index, []).append(e)
        cands = sorted(
            (i for i in by_node
             if sts[i] == ACTIVE and i >= self.policy.min_awake
             and self.nodes[i].cpu_util < self.policy.consolidate_util_below),
            key=lambda i: (self.nodes[i].cpu_util, i))
        if not cands:
            return [], []
        n_awake = sum(s in AWAKE_STATES for s in sts)
        # conservative ledger: candidates host nobody else's victims
        base = {i: (self.nodes[i].free_cpu, self.nodes[i].free_mem)
                for i, s in enumerate(sts)
                if s in (ACTIVE, IDLE) and i not in set(cands)}
        ledger = {i: list(cap) for i, cap in base.items()}
        drained: list[int] = []
        victims: list = []
        for i in cands:
            if n_awake - len(drained) <= self.policy.min_awake:
                break
            vs = by_node[i]
            if any(e.pod.deferrable and not t < deadline_of(e.pod)
                   for e in vs):
                continue
            trial = {j: list(cap) for j, cap in ledger.items()}
            ok = True
            for e in vs:
                pod = e.pod
                fit = next((cap for cap in trial.values()
                            if cap[0] >= pod.cpu - 1e-9
                            and cap[1] >= pod.mem - 1e-9), None)
                if fit is None:
                    ok = False
                    break
                fit[0] -= pod.cpu
                fit[1] -= pod.mem
            if not ok:
                continue
            ledger = trial
            drained.append(i)
            victims.extend(vs)
        # order-independent deadline guarantee: a deferrable victim must
        # fit on some awake node even after every *other* victim of the
        # pass is charged against that node (whatever packing the TOPSIS
        # round picks, restart-now stays feasible). Nodes whose deferrable
        # victims miss that bar are dropped from the pass; shrinking the
        # victim set only loosens the test, so this converges.
        while victims:
            tot_cpu = sum(e.pod.cpu for e in victims)
            tot_mem = sum(e.pod.mem for e in victims)
            bad = {e.node_index for e in victims
                   if e.pod.deferrable and math.isfinite(deadline_of(e.pod))
                   and not any(
                       c - (tot_cpu - e.pod.cpu) >= e.pod.cpu - 1e-9
                       and m - (tot_mem - e.pod.mem) >= e.pod.mem - 1e-9
                       for c, m in base.values())}
            if not bad:
                break
            drained = [i for i in drained if i not in bad]
            victims = [e for e in victims if e.node_index not in bad]
        return drained, victims


class AutoscaleScheduling(SchedulingPolicy):
    """The elastic fleet lifecycle as a kernel policy: the engine-side
    logic of :class:`AutoscalePolicy`, expressed through the
    :class:`~repro_torch.core.policy.SchedulingPolicy` hook protocol around an
    :class:`ElasticFleet` state machine.

    * ``on_clock``       — finalize wake transitions completed by ``t``
      (their WAKING intervals land in the state ledger before the round
      queries node states).
    * ``on_round_start`` — the *drain* event: at the consolidation
      cadence, low-utilization nodes' tasks are evicted through the
      kernel's truncate-and-requeue machinery (victims go to the *front*
      of the pending queue) and the emptied nodes sleep immediately.
    * ``exclude_mask`` / ``exclude_for`` — ASLEEP nodes are masked out of
      every pod's scoring validity; WAKING nodes whose ready time lies
      past a deferrable pod's deadline are masked for that pod.
    * ``on_commit``      — a pod bound to a still-WAKING node starts
      exactly at the wake-completion instant.
    * ``on_round_end``   — the *wake* event: pods that ended the round
      unplaced (and are not voluntarily deferring) wake the TOPSIS-best
      sleeping nodes.
    * ``next_wake_time`` — WAKE_DONE at in-flight wake completions;
      CONSOLIDATE_TICK at the drain cadence while tasks run.

    One instance drives one run (the fleet state machine is per-run);
    ``run_scenario`` constructs a fresh one per call.
    """

    def __init__(self, policy: AutoscalePolicy):
        self.policy = policy
        self.fleet: ElasticFleet | None = None
        self.next_consolidate = policy.consolidate_interval_s

    def bind(self, sim) -> None:
        self.fleet = ElasticFleet(sim.state.nodes, self.policy,
                                  sim.state.timeline)
        # adopt the engine's FleetState so power-state transitions land in
        # its columns (dirty-tracked) the moment write_states runs
        self.fleet.table = getattr(sim.state, "fleet", None)

    def on_clock(self, sim, t: float) -> None:
        self.fleet.advance_to(t)
        tel = telemetry.active()
        if tel.enabled:
            # observer-only: per-state node counts over sim time (states()
            # is a read-only view, so recording can't perturb the run)
            states = self.fleet.states(t)
            for state in POWER_STATES:
                tel.record("fleet_state_nodes", t,
                           float(states.count(state)), state=state)

    def on_round_start(self, sim, t: float) -> None:
        if self.next_consolidate is None or t < self.next_consolidate:
            return
        st = sim.state
        if st.running:
            drain_idxs, victims = self.fleet.consolidation_victims(
                t, st.running, sim.deadline)
            if victims:
                # drained pods go to the FRONT of the queue: they are
                # older than any pod arriving this round, and restart
                # priority is what keeps the drain-time fit guarantee
                # (and deferrable victims' deadlines) honest against
                # same-round arrival contention
                st.pending[:0] = sim.evict(victims, t)
                st.migrations += len(victims)
                telemetry.active().inc("policy_drained_tasks",
                                       value=float(len(victims)),
                                       policy=type(self).__name__)
                for i in drain_idxs:
                    self.fleet.force_sleep(i, t)
        self.next_consolidate = t + self.policy.consolidate_interval_s

    def exclude_mask(self, sim, t: float) -> np.ndarray:
        self.fleet.write_states(t)
        return self.fleet.exclude_mask(t)

    def exclude_for(self, sim, pod, base: np.ndarray,
                    t: float) -> np.ndarray | None:
        if pod.deferrable and math.isfinite(pod.deadline_s):
            return self.fleet.exclude_for_deadline(base, sim.deadline(pod))
        return None

    def on_commit(self, sim, node_index: int, t: float) -> float:
        return self.fleet.on_commit(node_index, t)

    def on_completion(self, sim, node_index: int, end_t: float) -> None:
        self.fleet.on_complete(node_index, end_t)

    def on_evict(self, sim, node_index: int, t: float) -> None:
        self.fleet.on_evict(node_index, t)

    def on_round_end(self, sim, unplaced, held, t: float) -> None:
        if not unplaced:
            return
        held_uids = {p.uid for p in held}
        pressure = [p for p in unplaced if p.uid not in held_uids]
        if pressure:
            self.fleet.wake_for_pressure(sim.state.schedulers["topsis"],
                                         pressure, t)

    def next_wake_time(self, sim, t: float, held) -> Event | None:
        cands: list[Event] = []
        ready = self.fleet.next_transition(t)
        if ready is not None:
            cands.append(Event.make(ready, WAKE_DONE))
        if (self.next_consolidate is not None and sim.state.running
                and self.next_consolidate > t):
            cands.append(Event.make(self.next_consolidate, CONSOLIDATE_TICK))
        return min(cands) if cands else None

    def finalize(self, sim, horizon: float) -> None:
        self.fleet.close(horizon)
        sim.state.wakes = self.fleet.wakes
        sim.state.sleeps = self.fleet.sleeps
