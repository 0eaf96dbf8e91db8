"""Discrete-event simulation kernel for the cluster engine — port of
``repro.cluster.engine``, the same event loop wired to the port's
schedulers.

This module owns the mechanics every scenario shares — the typed event
clock, the pending/running queues, the scheduling round, the per-node power
timeline — and nothing policy-specific. Carbon temporal shifting, the
elastic power-state lifecycle, and any future policy plug in through the
:class:`repro_torch.core.policy.SchedulingPolicy` hook protocol; the kernel calls
their hooks at fixed points in each round and otherwise treats them as
opaque. ``repro_torch.cluster.simulator.run_scenario`` is the thin driver that
composes the ordered policy list and calls :func:`simulate`.

Kernel semantics (kube-scheduler backoff-and-retry, idealized): a
scheduling round places every pending pod it can against current cluster
state; pods that do not fit wait in a FIFO queue and are retried whenever a
running task completes, a new burst arrives, or a policy wake fires. The
clock advances to the earliest candidate :class:`~repro_torch.core.policy.Event`
— COMPLETION before ARRIVAL before wake-like on ties — releasing exactly
one completion per step (the backoff step). Pods still pending when no
event can ever free capacity are counted unschedulable. Every processed
event lands in ``SimState.event_log``, so a fixed scenario replays to an
identical log (tests/test_torch_engine.py holds it equal to the reference
engine's log).

State is explicit: :class:`SimState` holds the queues (running tasks are
:class:`RunningTask` dataclasses on a heap, not bare tuples), the records,
the timeline, per-pod bookkeeping (arrival instants,
:class:`EvictBlock` same-node restart blocks), and the event counters
policies publish into. Cluster capacity lives in a delta-maintained
:class:`~repro_torch.cluster.node.FleetState` (``SimState.fleet``): commit,
completion, and eviction mutate its columns in place (O(touched columns)
per event, with dirty tracking the schedulers' incremental caches consume)
instead of re-flattening ``Node`` objects into a fresh snapshot per round;
``SimState.nodes`` is a per-node view over the same objects for policy
code. The eviction/requeue machinery
(:meth:`EventEngine.evict`) truncates a victim's record and power segment
at the eviction instant and hands the pod back for requeueing — carbon
preemption and consolidation drains are two callers of the same service.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import telemetry
from repro_torch.core.elastic import ASLEEP, NODE_WAKE_PROFILES
from repro_torch.core.energy import (NODE_ENERGY_PROFILES, PowerTimeline,
                               task_energy_joules)
from repro_torch.core.policy import ARRIVAL, COMPLETION, Event, SchedulingPolicy
from repro_torch.core.scheduler import (BatchScheduler, DefaultK8sScheduler,
                                  GreenPodScheduler, predict_exec_time)
from repro_torch.cluster.node import FleetState, Node, make_paper_cluster
from repro_torch.cluster.workload import ArrivalProcess, Pod


@dataclasses.dataclass
class PodRecord:
    pod: Pod
    node: str
    node_class: str
    start_s: float
    runtime_s: float
    energy_j: float
    scheduling_time_s: float
    arrival_s: float = 0.0      # burst arrival time (deferral latency basis)


@dataclasses.dataclass(order=True)
class RunningTask:
    """One committed task on the running heap, ordered by ``(end_s, uid)``
    (uids are unique, so the tail fields never compare). ``record_index``
    and ``segment_index`` point at the task's :class:`PodRecord` and power
    segment so an eviction can truncate both at the eviction instant."""

    end_s: float
    uid: int
    pod: Pod = dataclasses.field(compare=False)
    node_index: int = dataclasses.field(compare=False)
    record_index: int = dataclasses.field(compare=False)
    segment_index: int = dataclasses.field(compare=False)


@dataclasses.dataclass(frozen=True)
class EvictBlock:
    """A same-node restart block: the node a pod was just evicted off, and
    the eviction instant. The block holds only while the clock stays at
    ``t`` (rounds can repeat at one instant via the backoff step); an
    instant same-node restart would discard the partial run for nothing."""

    node_index: int
    t: float


@dataclasses.dataclass
class SimResult:
    records: list[PodRecord]
    unschedulable: int
    timeline: PowerTimeline | None = None
    preemptions: int = 0
    # elastic fleet counters (autoscale runs; zero otherwise)
    migrations: int = 0        # tasks drained off consolidated nodes
    wakes: int = 0             # ASLEEP -> WAKING transitions
    sleeps: int = 0            # falls asleep (idle timeout or drain)
    # processed-event log: (t, kind, payload) per kernel event, in clock
    # order (None for results constructed outside the kernel)
    events: list | None = None
    # per-decision TOPSIS attributions (explain=True runs; None otherwise)
    explanations: list | None = None

    def _timeline(self) -> PowerTimeline:
        """The run's power timeline (rebuilt from records for results
        constructed without one)."""
        if self.timeline is None:
            self.timeline = PowerTimeline()
            for r in self.records:
                self.timeline.add(r.node, r.node_class, r.pod.scheduler,
                                  r.start_s, r.runtime_s,
                                  r.energy_j / r.runtime_s if r.runtime_s
                                  else 0.0)
        return self.timeline

    def energy_kj(self, scheduler: str) -> float:
        """Node-level energy attributed to a scheduler: per-pod dynamic energy
        plus each node's idle power for the union time that scheduler's pods
        keep the node awake (Table IV: 'efficiency of scheduling decisions
        from an energy optimization perspective') — read off the
        power-state timeline."""
        return self._timeline().energy_kj(scheduler)

    def energy_series(self, scheduler: str | None = None):
        """Time-resolved cumulative energy ``(edges_s, joules)`` for one
        scheduler (or the whole cluster when None)."""
        return self._timeline().energy_series(scheduler)

    def power_series(self, scheduler: str | None = None):
        """Piecewise-constant total power ``(edges_s, watts)``."""
        return self._timeline().power_series(scheduler)

    def total_carbon_g(self, scheduler: str | None = None) -> float:
        """Operational carbon (gCO2) off the power timeline — requires the
        run to have had a CarbonPolicy (signal attached to the timeline)."""
        return self._timeline().total_carbon_g(scheduler)

    def carbon_series(self, scheduler: str | None = None):
        """Time-resolved cumulative carbon ``(edges_s, grams)``."""
        return self._timeline().carbon_series(scheduler)

    def fleet_idle_energy_kj(self) -> float:
        """Every joule the fleet drew that is not task dynamic power:
        busy-union idle + power-state ledger (IDLE/ASLEEP/WAKING draw) +
        wake surges. On a run without an AutoscalePolicy the state ledger
        is empty and this reduces to the busy-union idle total — which
        *excludes* empty nodes' draw; when comparing a policy run against
        a no-policy baseline, use
        ``repro_torch.core.elastic.always_on_fleet_idle_kj`` for the baseline
        side."""
        return self._timeline().fleet_idle_energy_kj()

    def fleet_energy_kj(self) -> float:
        """Whole-fleet energy: dynamic + :meth:`fleet_idle_energy_kj`."""
        return self._timeline().fleet_energy_kj()

    def state_energy_kj(self, state: str | None = None) -> float:
        """Energy drawn in one power state (or all, state=None) off the
        elastic state ledger, in kJ."""
        return self._timeline().state_energy_j(state) / 1000.0

    def fleet_carbon_g(self) -> float:
        """Whole-fleet carbon including the state ledger (needs a carbon
        signal on the run, like :meth:`total_carbon_g`)."""
        return self._timeline().fleet_carbon_g()

    def mean_deferral_latency_s(self, scheduler: str | None = None) -> float:
        """Mean wait between arrival and *first* start over deferrable pods
        (a preempted pod's requeued record does not reset its latency)."""
        first: dict[int, PodRecord] = {}
        for r in self.records:
            if not r.pod.deferrable:
                continue
            if scheduler is not None and r.pod.scheduler != scheduler:
                continue
            cur = first.get(r.pod.uid)
            if cur is None or r.start_s < cur.start_s:
                first[r.pod.uid] = r
        if not first:
            return 0.0
        return float(np.mean([r.start_s - r.arrival_s
                              for r in first.values()]))

    def mean_energy_kj(self, scheduler: str) -> float:
        """Per-pod average energy — the unit of paper Table VI (its kJ values
        decrease from low→high competition while pod counts grow ~3x, which is
        only consistent with a per-pod average). A preempted pod has one
        record per run attempt but counts once."""
        n = len({r.pod.uid for r in self.records
                 if r.pod.scheduler == scheduler})
        return self.energy_kj(scheduler) / n if n else 0.0

    def mean_sched_time_ms(self, scheduler: str) -> float:
        """Mean scheduling time per *attempt* (a preempted pod's requeued
        placement is a real second scheduling decision)."""
        ts = [r.scheduling_time_s for r in self.records
              if r.pod.scheduler == scheduler]
        return 1000.0 * float(np.mean(ts)) if ts else 0.0

    def mean_exec_time_s(self, scheduler: str) -> float:
        """Mean total time-on-cluster per pod (a preempted pod's truncated
        partial run and its rerun sum into one pod's total)."""
        totals: dict[int, float] = {}
        for r in self.records:
            if r.pod.scheduler == scheduler:
                totals[r.pod.uid] = totals.get(r.pod.uid, 0.0) + r.runtime_s
        return float(np.mean(list(totals.values()))) if totals else 0.0

    def unschedulable_rate(self) -> float:
        total = len({r.pod.uid for r in self.records}) + self.unschedulable
        return self.unschedulable / total if total else 0.0

    def allocation(self, scheduler: str) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in self.records:
            if r.pod.scheduler == scheduler:
                out[r.node_class] = out.get(r.node_class, 0) + 1
        return out

    def summary(self) -> dict:
        """Run metrics in the shape the benchmark sweeps record: run-level
        counters plus one entry per scheduler that placed pods."""
        out: dict = {
            "pods": len({r.pod.uid for r in self.records})
            + self.unschedulable,
            "unschedulable_rate": self.unschedulable_rate(),
            "preemptions": self.preemptions,
            "migrations": self.migrations,
            "wakes": self.wakes,
            "sleeps": self.sleeps,
            "schedulers": {},
        }
        for s in sorted({r.pod.scheduler for r in self.records}):
            out["schedulers"][s] = {
                "pods": len({r.pod.uid for r in self.records
                             if r.pod.scheduler == s}),
                "energy_kj": self.energy_kj(s),
                "mean_energy_kj": self.mean_energy_kj(s),
                "mean_sched_time_ms": self.mean_sched_time_ms(s),
                "mean_exec_time_s": self.mean_exec_time_s(s),
                "allocation": self.allocation(s),
            }
        if self.explanations:
            out["explanations"] = self.explanations
        return out


@dataclasses.dataclass
class SimState:
    """Everything one simulation run mutates, in one explicit structure.

    Policies read and mutate this through the engine's hook calls:
    ``pending`` is the FIFO retry queue, ``running`` a heap of
    :class:`RunningTask`, ``blocked`` the same-node restart blocks keyed by
    pod uid, ``arrival_s`` each pod's burst arrival instant (the deferral
    deadline basis), and the counter fields are what
    :class:`SimResult` reports.

    ``fleet`` — a delta-maintained :class:`FleetState` — is the single
    source of truth for cluster capacity and power states. The kernel
    mutates it through its column mutators (never the ``Node`` objects
    directly: that would bypass the dirty tracking the schedulers'
    incremental caches rely on); ``nodes`` is a read view over the same
    per-node objects for policy code."""

    fleet: FleetState
    schedulers: dict
    timeline: PowerTimeline
    pending: list[Pod] = dataclasses.field(default_factory=list)
    running: list[RunningTask] = dataclasses.field(default_factory=list)
    records: list[PodRecord] = dataclasses.field(default_factory=list)
    arrival_s: dict[int, float] = dataclasses.field(default_factory=dict)
    blocked: dict[int, EvictBlock] = dataclasses.field(default_factory=dict)
    event_log: list[tuple] = dataclasses.field(default_factory=list)
    t: float = 0.0
    unschedulable: int = 0
    preemptions: int = 0
    migrations: int = 0
    wakes: int = 0
    sleeps: int = 0

    @property
    def nodes(self) -> list[Node]:
        """Per-node views over the fleet (same objects ``fleet`` maintains);
        mutate capacity/power state through ``fleet``, not through these."""
        return self.fleet.nodes


class EventEngine:
    """The discrete-event kernel: one instance drives one scenario run.

    Policies receive this object in every hook; ``state`` exposes the
    queues and ledgers, and the kernel services below expose the shared
    machinery (:meth:`evict`, :meth:`block_restart`, :meth:`deadline`).
    """

    def __init__(self, state: SimState,
                 policies: Sequence[SchedulingPolicy],
                 arrivals: ArrivalProcess, batch: bool = False):
        self.state = state
        self.policies = tuple(policies)
        self.batch = batch
        self._events = sorted(arrivals.events(), key=lambda ev: ev[0])
        # sim-time series accumulators (observer-only: live on the engine,
        # never in SimState, and are touched only when telemetry is on)
        self._series_prev: tuple[float, float, float] | None = None
        self._series_energy_j = 0.0
        self._series_carbon_g = 0.0

    # --- kernel services (used by policies) ----------------------------------
    def deadline(self, pod: Pod) -> float:
        """The absolute instant a pod's deferral window closes: its burst
        arrival plus its relative ``deadline_s``."""
        return self.state.arrival_s.get(pod.uid, 0.0) + pod.deadline_s

    def block_restart(self, uid: int, node_index: int, t: float) -> None:
        """Forbid an instant same-node restart for a just-evicted pod (the
        block lapses once the clock leaves ``t``)."""
        self.state.blocked[uid] = EvictBlock(node_index, t)

    def evict(self, victims: Sequence[RunningTask], t: float) -> list[Pod]:
        """Evict running tasks at instant ``t`` (carbon preemption or a
        consolidation drain): release resources, truncate each victim's
        record and power segment at ``t``, notify every policy, and return
        the pods for the caller to requeue. A victim committed to a
        still-WAKING node has ``start_s > t`` — it never ran, so its
        partial attempt clamps to zero runtime/energy."""
        st = self.state
        telemetry.active().inc("engine_evictions", value=float(len(victims)))
        gone = {v.uid for v in victims}
        st.running[:] = [rt for rt in st.running if rt.uid not in gone]
        heapq.heapify(st.running)
        pods: list[Pod] = []
        for v in victims:
            st.fleet.release(v.node_index, v.pod.cpu, v.pod.mem)
            for pol in self.policies:
                pol.on_evict(self, v.node_index, t)
            rec = st.records[v.record_index]
            elapsed = max(t - rec.start_s, 0.0)
            rec.runtime_s = elapsed
            rec.energy_j = (st.timeline.segments[v.segment_index].dyn_power_w
                            * elapsed)
            st.timeline.truncate(v.segment_index, t)
            pods.append(v.pod)
        return pods

    # --- internals -----------------------------------------------------------
    def _commit(self, pod: Pod, idx: int, t: float,
                sched_time_s: float) -> None:
        """Bind pod to nodes[idx], append its record + running-heap entry,
        and post the task segment to the power timeline. A policy may move
        the task's effective start (a WAKING node's ready instant)."""
        st = self.state
        node = st.nodes[idx]
        st.fleet.bind(idx, pod.cpu, pod.mem)
        start = t
        for pol in self.policies:
            adjusted = pol.on_commit(self, idx, t)
            if adjusted is not None:
                start = adjusted
        rt = predict_exec_time(pod, node)
        ej = task_energy_joules(node.node_class, rt, pod.cpu)
        st.records.append(PodRecord(pod, node.name, node.node_class, start,
                                    rt, ej, sched_time_s,
                                    st.arrival_s.get(pod.uid, 0.0)))
        st.timeline.add(node.name, node.node_class, pod.scheduler, start, rt,
                        NODE_ENERGY_PROFILES[node.node_class]
                        ["dyn_power_per_vcpu"] * pod.cpu)
        heapq.heappush(st.running,
                       RunningTask(start + rt, pod.uid, pod, idx,
                                   len(st.records) - 1,
                                   len(st.timeline.segments) - 1))
        telemetry.active().inc("engine_commits", scheduler=pod.scheduler)

    def _pop_release(self) -> float:
        """Pop the earliest completion, release its resources, notify the
        policies, log the event, return its end time (the backoff step)."""
        st = self.state
        done = heapq.heappop(st.running)
        st.fleet.release(done.node_index, done.pod.cpu, done.pod.mem)
        for pol in self.policies:
            pol.on_completion(self, done.node_index, done.end_s)
        st.event_log.append((done.end_s, COMPLETION, done.uid))
        telemetry.active().inc("engine_events", kind=COMPLETION)
        return done.end_s

    def _run_burst(self, pods: list[Pod], t: float,
                   blocked_now: dict[int, int], exclude,
                   scheduler: str = "topsis") -> list[Pod]:
        """Schedule an arrival burst through one batched scoring pass
        (``select_many`` of the named scheduler — bursts are grouped by
        ``pod.scheduler``, so a mixed queue never scores through the wrong
        engine) and commit the assignments. Returns the pods that did not
        fit. ``blocked_now`` maps pod uid -> a node index the pod must not
        be committed to this round; the exclusion happens inside
        ``select_many``'s greedy ledger, so a blocked top choice falls
        through to the pod's next-ranked node without charging phantom
        capacity. ``exclude`` ((N,) or (P, N) bool) hard-masks
        policy-forbidden nodes out of the scoring validity."""
        st = self.state
        blocked = ([blocked_now.get(p.uid) for p in pods]
                   if blocked_now else None)
        assignments, diag = st.schedulers[scheduler].select_many(
            pods, st.fleet, now=t, blocked=blocked, exclude=exclude)
        still: list[Pod] = []
        for pod, idx in zip(pods, assignments):
            if idx is None:
                still.append(pod)
                continue
            self._commit(pod, idx, t, diag["per_pod_time_s"])
        return still

    def _record_series(self, tel) -> None:
        """Sample the sim-time metric timelines at the current clock
        instant (called after each scheduling round when recording is on).

        Strictly observer-side: reads sim state, writes telemetry. Every
        recorded value is a simulation quantity — queue depths, the fleet's
        instantaneous draw from the committed ledger, cumulative energy and
        carbon integrated piecewise-constant between clock advances — so
        the same scenario records bit-identical series on every backend.
        The cumulative series are the sampled operator view; the exact
        end-of-run totals stay on the :class:`PowerTimeline` ledger."""
        st = self.state
        t = st.t
        # per-node instantaneous draw: dynamic power of started tasks plus
        # the per-state baseline (busy-union idle rule for legacy nodes:
        # an empty always-on node draws nothing in the ledger either)
        power = [0.0] * len(st.nodes)
        for rt in st.running:
            seg = st.timeline.segments[rt.segment_index]
            if seg.start_s <= t:
                power[rt.node_index] += seg.dyn_power_w
        awake = 0
        for i, node in enumerate(st.nodes):
            s = node.power_state
            if s != ASLEEP:
                awake += 1
            if s is None:
                if node.used_cpu > 0.0:
                    power[i] += (NODE_ENERGY_PROFILES[node.node_class]
                                 ["idle_power"])
            elif s == ASLEEP:
                power[i] += (NODE_WAKE_PROFILES[node.node_class]
                             ["sleep_power_w"])
            else:       # active / idle / waking all draw the idle baseline
                power[i] += (NODE_ENERGY_PROFILES[node.node_class]
                             ["idle_power"])
        fleet_power = sum(power)
        sig = st.timeline.carbon_signal
        if sig is not None:
            from repro_torch.core.carbon import J_PER_KWH
            carbon_rate = sum(
                p * sig.intensity(st.timeline.region_of(node.name), t)
                for p, node in zip(power, st.nodes) if p) / J_PER_KWH
        else:
            carbon_rate = 0.0
        if self._series_prev is not None:
            prev_t, prev_p, prev_r = self._series_prev
            if t > prev_t:
                self._series_energy_j += prev_p * (t - prev_t)
                self._series_carbon_g += prev_r * (t - prev_t)
        self._series_prev = (t, fleet_power, carbon_rate)
        tel.record("engine_pending_depth", t, float(len(st.pending)))
        tel.record("engine_running_tasks", t, float(len(st.running)))
        tel.record("fleet_awake_nodes", t, float(awake))
        tel.record("fleet_power_w", t, fleet_power)
        tel.record("fleet_energy_cum_kj", t, self._series_energy_j / 1000.0)
        if sig is not None:
            tel.record("fleet_carbon_cum_g", t, self._series_carbon_g)

    # --- the event loop ------------------------------------------------------
    def run(self) -> SimResult:
        st = self.state
        policies = self.policies
        events = self._events
        tel = telemetry.active()
        if tel.enabled:
            # the sim clock restarts at zero: timelines describe this run
            tel.clear_series()
        ei = 0
        while True:
            # ingest every burst due by the current clock
            while ei < len(events) and events[ei][0] <= st.t:
                burst_t, burst_pods = events[ei]
                for p in burst_pods:
                    for pol in policies:
                        pol.on_arrival(self, p, burst_t)
                    st.arrival_s.setdefault(p.uid, burst_t)
                st.pending.extend(burst_pods)
                st.event_log.append((burst_t, ARRIVAL, len(burst_pods)))
                tel.inc("engine_events", kind=ARRIVAL)
                ei += 1
            # safety net: release anything that finished before now (the
            # advance step never moves the clock past an unreleased
            # completion)
            while st.running and st.running[0].end_s < st.t:
                self._pop_release()
            if not st.pending and not st.running and ei >= len(events):
                break
            t = st.t
            # queue-depth gauges, sampled once per clock instant's round
            tel.set_gauge("engine_pending_depth", float(len(st.pending)))
            tel.set_gauge("engine_running_tasks", float(len(st.running)))
            for pol in policies:
                pol.on_clock(self, t)
            with tel.span("engine_round"):
                # round-start mutations: carbon preemption evictions, the
                # consolidation drain pass — requeued pods re-enter this
                # round's pending queue
                for pol in policies:
                    pol.on_round_start(self, t)
                blocked_now = {uid: b.node_index
                               for uid, b in st.blocked.items() if b.t == t}
                # exclusion masks for this round: the OR of every policy's
                # fleet-wide mask, plus per-pod extras (a policy may forbid
                # specific nodes for specific pods — deadline-late WAKING
                # nodes for deferrable pods)
                base_ex = None
                for pol in policies:
                    m = pol.exclude_mask(self, t)
                    if m is not None:
                        base_ex = m if base_ex is None else (base_ex | m)

                def _exclude_for(pod: Pod):
                    # per-pod extras run even when no policy set a
                    # fleet-wide mask (base may be None — a policy can be
                    # purely per-pod)
                    mask = base_ex
                    for pol in policies:
                        extra = pol.exclude_for(self, pod, mask, t)
                        if extra is not None:
                            mask = extra
                    return mask
                # deferral filter: policies hold pods out of this round
                # (they keep their queue position and retry at the
                # policy's wake)
                held: list[Pod] = []
                held_uids: set[int] = set()
                for pol in policies:
                    n_held = 0
                    for p in pol.filter_pending(self, st.pending, t):
                        if p.uid not in held_uids:
                            held.append(p)
                            held_uids.add(p.uid)
                            n_held += 1
                    if n_held:
                        tel.inc("policy_deferred_pods", value=float(n_held),
                                policy=type(pol).__name__)
                # scheduling round: place what fits, FIFO retry for the
                # rest. Batch-capable schedulers take the burst path,
                # grouped by pod.scheduler (in first-appearance order) so
                # a mixed queue routes each group through its own scoring
                # engine
                placed: set[int] = set()
                bursts: dict[str, list[Pod]] = {}
                for pod in st.pending:
                    if pod.uid in held_uids:
                        continue
                    sched = st.schedulers[pod.scheduler]
                    if self.batch and hasattr(sched, "select_many"):
                        bursts.setdefault(pod.scheduler, []).append(pod)
                        continue
                    idx, diag = sched.select(
                        pod, st.fleet, now=t, exclude=_exclude_for(pod))
                    if idx is None:
                        continue
                    if blocked_now.get(pod.uid) == idx:
                        # blocked instant same-node restart: wait like a
                        # deferred pod (guarantees a wake event to retry
                        # on)
                        held.append(pod)
                        held_uids.add(pod.uid)
                        continue
                    self._commit(pod, idx, t, diag["scheduling_time_s"])
                    placed.add(pod.uid)
                for group, burst in bursts.items():
                    per_pod = [_exclude_for(p) for p in burst]
                    if any(pp is not base_ex for pp in per_pod):
                        # a policy set per-pod extras: stack to (P, N),
                        # padding unmasked pods with the base (or an empty
                        # mask)
                        fill = (base_ex if base_ex is not None
                                else np.zeros(len(st.nodes), dtype=bool))
                        ex_b = np.stack([pp if pp is not None else fill
                                         for pp in per_pod])
                    else:
                        ex_b = base_ex
                    b_still = self._run_burst(burst, t, blocked_now, ex_b,
                                              scheduler=group)
                    placed.update({p.uid for p in burst}
                                  - {p.uid for p in b_still})
                st.pending = [p for p in st.pending if p.uid not in placed]
                # evicted-but-unplaced victims wait like held pods (the
                # block lapses once t advances)
                for p in st.pending:
                    if p.uid in blocked_now and p.uid not in held_uids:
                        held.append(p)
                        held_uids.add(p.uid)
                for pol in policies:
                    pol.on_round_end(self, st.pending, held, t)
            if tel.enabled:
                self._record_series(tel)
            # advance the clock to the earliest candidate event:
            # completion, arrival burst, or a policy wake
            next_arrival = events[ei][0] if ei < len(events) else None
            next_completion = (st.running[0].end_s if st.running else None)
            wake_ev: Event | None = None
            wake_pol: SchedulingPolicy | None = None
            for pol in policies:
                ev = pol.next_wake_time(self, t, held)
                if ev is not None and (wake_ev is None or ev < wake_ev):
                    wake_ev, wake_pol = ev, pol
            next_wake = wake_ev.t if wake_ev is not None else None
            if st.pending and next_completion is not None \
                    and (next_arrival is None
                         or next_completion <= next_arrival) \
                    and (next_wake is None or next_completion <= next_wake):
                # backoff step: free exactly one completed pod, then retry
                st.t = self._pop_release()
                continue
            if next_arrival is not None and (next_wake is None
                                             or next_arrival <= next_wake):
                if next_completion is not None \
                        and next_completion <= next_arrival:
                    # release completions due at-or-before the arrival (one
                    # per iteration) so the burst schedules against freed
                    # capacity — including the exact completion==arrival tie
                    st.t = self._pop_release()
                    continue
                st.t = next_arrival
                continue
            if next_wake is not None:
                if next_completion is not None \
                        and next_completion <= next_wake:
                    st.t = self._pop_release()
                    continue
                st.t = next_wake
                st.event_log.append((wake_ev.t, wake_ev.kind,
                                     wake_ev.payload))
                tel.inc("engine_events", kind=wake_ev.kind)
                wake_pol.on_tick(self, wake_ev)
                continue
            if st.pending:
                # no completions left, no future arrivals, no wakes:
                # nothing can ever fit
                st.unschedulable += len(st.pending)
                break
            break   # only running tasks remain; their records are complete
        # close the run at its horizon (latest task end or the final clock,
        # whichever is later): drain the still-running completions through
        # the policy hooks so post-last-task state lands in the ledgers,
        # then let every policy flush
        horizon = st.t
        for r in st.records:
            horizon = max(horizon, r.start_s + r.runtime_s)
        while st.running:
            self._pop_release()
        for pol in policies:
            pol.finalize(self, horizon)
        if tel.enabled:
            # end-of-run rollups (observer-only; guarded so disabled runs
            # skip the ledger walk entirely)
            st.timeline.publish_telemetry(tel)
            st.timeline.publish_series(tel)
            tel.set_gauge("engine_unschedulable", float(st.unschedulable))
        explanations: list | None = None
        for sched in st.schedulers.values():
            ex = getattr(sched, "explanations", None)
            if ex:
                explanations = (explanations or []) + ex
        return SimResult(st.records, st.unschedulable, st.timeline,
                         preemptions=st.preemptions,
                         migrations=st.migrations,
                         wakes=st.wakes, sleeps=st.sleeps,
                         events=st.event_log,
                         explanations=explanations)


def simulate(arrivals: ArrivalProcess, scheme: str,
             cluster_factory: Callable[[], list[Node]] = make_paper_cluster,
             adaptive: bool = False, batch: bool = False,
             batch_backend: str = "cuda",
             policies: Sequence[SchedulingPolicy] = (),
             explain: bool = False, device=None) -> SimResult:
    """Build a run (fleet, schedulers, timeline) and drive it through the
    kernel with the given ordered policy list.

    If any policy carries a ``carbon_signal``, the signal is attached to
    the TOPSIS schedulers (the sixth carbon-rate criterion) and to the
    run's power timeline (carbon accounting). With no policies the kernel
    reduces to the policy-free event loop — arrival and completion events
    only — and reproduces the pre-kernel engine bitwise.

    ``explain=True`` turns on per-decision TOPSIS attribution: every
    placement records the winner-vs-runner-up per-criterion closeness
    contributions (``SimResult.explanations``; surfaced in
    ``summary()``). Numpy scoring only — a batch run on torch/cuda
    raises at its first scoring round.

    ``device`` is where the torch and cuda backends score (``None``: the
    card, raising when there is none); the numpy backend ignores it.
    """
    policies = tuple(policies)
    nodes = cluster_factory()
    signals = [p.carbon_signal for p in policies
               if p.carbon_signal is not None]
    if len({id(s) for s in signals}) > 1:
        raise ValueError(
            f"{len(signals)} policies supplied distinct carbon signals; "
            f"the schedulers and the power timeline take exactly one — "
            f"share a single signal object between the policies")
    csig = signals[0] if signals else None
    schedulers = {
        "topsis": (BatchScheduler(scheme, adaptive=adaptive,
                                  backend=batch_backend,
                                  carbon_signal=csig,
                                  explain=explain, device=device) if batch
                   else GreenPodScheduler(scheme, adaptive=adaptive,
                                          carbon_signal=csig,
                                          explain=explain)),
        "default": DefaultK8sScheduler(),
    }
    timeline = PowerTimeline(
        carbon_signal=csig,
        node_region=({n.name: n.region for n in nodes}
                     if csig is not None else None))
    fleet = FleetState.from_nodes(nodes)
    state = SimState(fleet=fleet, schedulers=schedulers, timeline=timeline)
    # schedulers adopt the fleet as a live snapshot: scoring rounds sync
    # only dirty node columns instead of re-flattening the Node list
    for sched in schedulers.values():
        if hasattr(sched, "attach"):
            sched.attach(fleet)
    engine = EventEngine(state, policies, arrivals, batch=batch)
    for pol in policies:
        pol.bind(engine)
    return engine.run()
