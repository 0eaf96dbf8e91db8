"""Energy models.

1. ``blade_power`` — the blade-server power model of Dayarathna et al. [32],
   the exact model the paper uses for its real-world extrapolation (§V.E):

     P = 14.45 + 0.236*u_cpu - 4.47e-8*u_mem + 0.00281*u_disk + 3.1e-8*u_net  [W]

   with u_cpu in percent, u_mem in memory accesses/s, u_disk in IO ops/s,
   u_net in network ops/s.

2. Per-node-class *dynamic* energy profiles for the cluster simulator
   (DESIGN.md §7 calibration): each node class has a speed factor and a
   dynamic power per allocated vCPU. Energy attributed to a task is
   dynamic power x runtime, matching the paper's 'energy consumption from
   scheduling decisions' metric (Table IV).

3. ``chip_energy`` — TPU-side model for the beyond-paper fleet scheduler:
   energy = step_time x chips x (idle + (TDP-idle) x mfu-ish utilization).

4. ``PowerTimeline`` — per-node power-state timeline for the event-driven
   simulator: every committed placement adds a task segment (node, scheduler,
   start, runtime, dynamic power); idle attribution is the per-node union of
   a scheduler's busy intervals (same decomposition the legacy post-hoc
   ``_union_length`` accounting produced), and the same segments yield
   piecewise-constant power / cumulative energy *series* over time, which a
   scalar union cannot express.
"""
from __future__ import annotations

import dataclasses


def blade_power(u_cpu_pct: float, u_mem_acc_per_s: float = 0.0,
                u_disk_iops: float = 0.0, u_net_ops: float = 0.0) -> float:
    """Dayarathna et al. [32] blade server power (Watts)."""
    return (14.45 + 0.236 * u_cpu_pct - 4.47e-8 * u_mem_acc_per_s
            + 0.00281 * u_disk_iops + 3.1e-8 * u_net_ops)


def paper_job_energy_kwh(runtime_min: float = 34.0, pue: float = 1.45,
                         u_cpu_pct: float = 60.0,
                         u_mem_acc_per_s: float = 8e6,
                         u_disk_iops: float = 350.0,
                         u_net_ops: float = 3e6) -> float:
    """Average job energy exactly as computed in paper §V.E (≈0.024 kWh)."""
    p_watts = blade_power(u_cpu_pct, u_mem_acc_per_s, u_disk_iops, u_net_ops)
    return p_watts * pue * (runtime_min / 60.0) / 1000.0


# --- Cluster-simulator node energy profiles (calibrated, DESIGN.md §7) -----
# speed: relative per-core throughput; dyn_power_per_vcpu: Watts drawn per
# allocated vCPU while a task runs; idle_power: Watts the node draws whenever
# a scheduler's pods keep it awake (static/uncore power). Class A (e2-medium)
# is slow but frugal, class C (n2-standard-4) fast but power-hungry — the
# heterogeneity axis the paper's §V.D allocation analysis relies on.
# Consolidating onto one frugal node avoids paying several nodes' idle power,
# which is the physical mechanism behind the paper's 30-39% energy savings.
# Values fit to paper Table VI by scripts/calibrate.py (err metric in
# scripts/calibrated_params.json); see EXPERIMENTS.md §Repro for the match.
NODE_ENERGY_PROFILES: dict[str, dict[str, float]] = {
    "A": {"speed": 0.7500, "dyn_power_per_vcpu": 6.0000, "idle_power": 6.2321},
    "B": {"speed": 1.1000, "dyn_power_per_vcpu": 10.0000, "idle_power": 9.5953},
    "C": {"speed": 1.3417, "dyn_power_per_vcpu": 27.0570, "idle_power": 14.0000},
    "default": {"speed": 0.7000, "dyn_power_per_vcpu": 11.7709,
                "idle_power": 14.9153},
}


def task_energy_joules(node_class: str, runtime_s: float,
                       cpu_request: float) -> float:
    """Dynamic (CPU-proportional) energy of one task."""
    prof = NODE_ENERGY_PROFILES[node_class]
    return prof["dyn_power_per_vcpu"] * cpu_request * runtime_s


def predicted_task_energy_joules(node_class: str, runtime_s: float,
                                 cpu_request: float, node_awake: bool) -> float:
    """Energy-profiling-module prediction used in the decision matrix:
    dynamic energy plus — if the node is currently asleep — the idle power
    the placement would newly wake up for the task's duration. Marginal idle
    cost of an already-awake node is zero, which is what makes energy-centric
    TOPSIS consolidate (paper §V.D)."""
    e = task_energy_joules(node_class, runtime_s, cpu_request)
    if not node_awake:
        e += NODE_ENERGY_PROFILES[node_class]["idle_power"] * runtime_s
    return e


def predicted_task_energy_joules_np(dyn_power_per_vcpu, idle_power,
                                    runtime_s, cpu_request, awake):
    """Vectorized :func:`predicted_task_energy_joules` over node columns.

    All arguments broadcast (numpy arrays or scalars); ``awake`` is a bool
    mask. Same arithmetic and operand order as the scalar form, so the two
    agree bitwise on float64 inputs — the batched scheduler's decision
    matrix must rank identically to the per-pod path. (This is
    :func:`predicted_power_w_np` x runtime, kept in the legacy operand
    order for bitwise golden stability.)
    """
    import numpy as np
    e = dyn_power_per_vcpu * cpu_request * runtime_s
    return e + np.where(awake, 0.0, idle_power * runtime_s)


def predicted_power_w_np(dyn_power_per_vcpu, idle_power, cpu_request, awake):
    """Marginal power draw (W) of a placement, vectorized over node
    columns: dynamic power for the requested vCPUs plus — if the node is
    asleep — the idle power the placement newly wakes. The single source
    of the marginal-power rule; the carbon-rate criterion is this times
    grid intensity, and :func:`predicted_task_energy_joules_np` is this
    times runtime."""
    import numpy as np
    return dyn_power_per_vcpu * cpu_request + np.where(awake, 0.0,
                                                       idle_power)


# --- Per-node power-state timeline (event-driven simulator) -----------------
def merge_intervals(intervals: list[tuple[float, float]]
                    ) -> list[tuple[float, float]]:
    """Union of [start, end) intervals as a sorted list of disjoint
    intervals."""
    merged: list[tuple[float, float]] = []
    if not intervals:
        return merged
    ivs = sorted(intervals)
    cur_s, cur_e = ivs[0]
    for s, e in ivs[1:]:
        if s > cur_e:
            merged.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    merged.append((cur_s, cur_e))
    return merged


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals (same merge
    order and summation order as the legacy simulator ``_union_length``,
    so totals agree bitwise)."""
    return sum(e - s for s, e in merge_intervals(intervals))


@dataclasses.dataclass(frozen=True)
class StateInterval:
    """One node's stay in a non-task power state (elastic fleet subsystem,
    ``repro_torch.core.elastic``): the node draws ``power_w`` on
    ``[start_s, end_s)`` while IDLE (awake, empty), ASLEEP (suspended
    residual), or WAKING (booting back up). Task-occupancy (ACTIVE) power is
    not recorded here — it stays attributed to schedulers via the busy-union
    idle accounting, so the two ledgers never double count."""

    node: str
    node_class: str
    state: str             # "idle" | "asleep" | "waking"
    start_s: float
    end_s: float
    power_w: float

    @property
    def energy_j(self) -> float:
        return self.power_w * (self.end_s - self.start_s)


@dataclasses.dataclass(frozen=True)
class WakeTransition:
    """One ASLEEP→awake transition's surge energy, posted as a lump at the
    wake-request instant ``t_s`` (the latency's baseline draw is a WAKING
    ``StateInterval``; this is the extra spin-up cost on top)."""

    node: str
    node_class: str
    t_s: float
    energy_j: float


@dataclasses.dataclass(frozen=True)
class PowerSegment:
    """One task's occupancy of one node: draws ``dyn_power_w`` on
    ``[start_s, start_s + runtime_s)`` and keeps the node awake (idle power
    attributed to ``scheduler``) for that interval."""

    node: str
    node_class: str
    scheduler: str
    start_s: float
    runtime_s: float
    dyn_power_w: float

    @property
    def end_s(self) -> float:
        return self.start_s + self.runtime_s

    @property
    def energy_j(self) -> float:
        return self.dyn_power_w * self.runtime_s


class PowerTimeline:
    """Per-node power-state timeline: the simulator's energy ledger.

    Segments are appended in commit order. Scalar totals (``energy_kj``)
    reproduce the legacy union-of-intervals decomposition — dynamic power x
    runtime per task, plus each node's idle power for the union time a
    scheduler's tasks keep it awake — while :meth:`power_series` /
    :meth:`energy_series` expose the same ledger as time-resolved
    piecewise-constant power and cumulative energy, per scheduler.

    Carbon accounting (``carbon_signal`` + per-node ``node_region``
    attached): every constant-power piece of the ledger is integrated
    against its region's time-varying grid intensity —
    :meth:`total_carbon_g` and :meth:`carbon_series` are exact (the signal
    supplies analytic interval integrals), not time-stepped. A preempted
    task's segment is cut at the eviction instant via :meth:`truncate`, so
    its energy/carbon interval splits between the partial run and the
    requeued one.

    State ledger (elastic fleet subsystem, ``repro_torch.core.elastic``): with an
    ``AutoscalePolicy`` on the run, the fleet's non-task power draw lands
    here as :class:`StateInterval` entries (IDLE / ASLEEP / WAKING) plus
    :class:`WakeTransition` surge lumps. ``fleet_idle_energy_kj`` /
    ``fleet_energy_kj`` / ``fleet_carbon_g`` combine both ledgers; the
    per-scheduler views above are untouched (a run without a policy records
    no state intervals and reproduces the legacy accounting bitwise).
    """

    def __init__(self, segments: list[PowerSegment] | None = None,
                 carbon_signal=None,
                 node_region: "dict[str, str] | None" = None):
        self.segments: list[PowerSegment] = list(segments or [])
        self.state_intervals: list[StateInterval] = []
        self.wake_transitions: list[WakeTransition] = []
        self.carbon_signal = carbon_signal
        self.node_region: dict[str, str] = dict(node_region or {})

    def add(self, node: str, node_class: str, scheduler: str, start_s: float,
            runtime_s: float, dyn_power_w: float) -> None:
        self.segments.append(PowerSegment(node, node_class, scheduler,
                                          start_s, runtime_s, dyn_power_w))

    def add_state(self, node: str, node_class: str, state: str,
                  start_s: float, end_s: float, power_w: float) -> None:
        """Post one node-state stay to the state ledger (empty intervals are
        dropped, so lazy materialization can emit degenerate bounds)."""
        if end_s > start_s:
            self.state_intervals.append(
                StateInterval(node, node_class, state, start_s, end_s,
                              power_w))

    def add_wake(self, node: str, node_class: str, t_s: float,
                 energy_j: float) -> None:
        self.wake_transitions.append(
            WakeTransition(node, node_class, t_s, energy_j))

    def truncate(self, index: int, end_s: float) -> None:
        """Cut segment ``index`` short at ``end_s`` (task preempted): its
        dynamic power and the node-awake attribution both stop there."""
        seg = self.segments[index]
        self.segments[index] = dataclasses.replace(
            seg, runtime_s=max(end_s - seg.start_s, 0.0))

    def _segs(self, scheduler: str | None) -> list[PowerSegment]:
        if scheduler is None:
            return self.segments
        return [s for s in self.segments if s.scheduler == scheduler]

    def dynamic_energy_j(self, scheduler: str | None = None) -> float:
        """Sum of per-task dynamic energy, in segment (commit) order —
        identical arithmetic to summing ``PodRecord.energy_j``."""
        return sum(s.energy_j for s in self._segs(scheduler))

    def busy_intervals(self, scheduler: str | None = None
                       ) -> dict[str, list[tuple[float, float]]]:
        """Per-node busy intervals attributed to ``scheduler``."""
        by_node: dict[str, list[tuple[float, float]]] = {}
        for s in self._segs(scheduler):
            by_node.setdefault(s.node, []).append((s.start_s, s.end_s))
        return by_node

    def idle_energy_j(self, scheduler: str | None = None) -> float:
        """Idle (static) energy: each node's idle power x the union time the
        scheduler's tasks keep it awake — the legacy decomposition."""
        classes = {s.node: s.node_class for s in self._segs(scheduler)}
        return sum(NODE_ENERGY_PROFILES[classes[node]]["idle_power"]
                   * union_length(ivs)
                   for node, ivs in self.busy_intervals(scheduler).items())

    def energy_kj(self, scheduler: str | None = None) -> float:
        return (self.dynamic_energy_j(scheduler)
                + self.idle_energy_j(scheduler)) / 1000.0

    def power_series(self, scheduler: str | None = None):
        """Piecewise-constant total power: ``(edges, watts)`` with
        ``watts[k]`` drawn on ``[edges[k], edges[k+1])`` — dynamic power of
        every running task plus idle power of every node the scheduler keeps
        awake. ``len(watts) == len(edges) - 1``; empty timelines return
        ``([], [])``."""
        import numpy as np
        segs = self._segs(scheduler)
        if not segs:
            return np.zeros(0), np.zeros(0)
        edges = np.unique(np.asarray(
            [s.start_s for s in segs] + [s.end_s for s in segs]))
        idx = {t: i for i, t in enumerate(edges.tolist())}
        delta = np.zeros(len(edges))
        for s in segs:                       # dynamic power while running
            delta[idx[s.start_s]] += s.dyn_power_w
            delta[idx[s.end_s]] -= s.dyn_power_w
        classes = {s.node: s.node_class for s in segs}
        for node, ivs in self.busy_intervals(scheduler).items():
            p = NODE_ENERGY_PROFILES[classes[node]]["idle_power"]
            for lo, hi in merge_intervals(ivs):  # idle power while awake
                delta[idx[lo]] += p
                delta[idx[hi]] -= p
        return edges, np.cumsum(delta)[:-1]

    def energy_series(self, scheduler: str | None = None):
        """Cumulative energy over time: ``(edges, joules)`` with
        ``joules[k]`` the energy consumed up to ``edges[k]`` (``joules[0]``
        is 0). The final value equals ``energy_kj() * 1000`` up to float
        summation order."""
        import numpy as np
        edges, watts = self.power_series(scheduler)
        if not len(edges):
            return edges, np.zeros(0)
        return edges, np.concatenate(
            [[0.0], np.cumsum(watts * np.diff(edges))])

    # --- carbon accounting (power x grid intensity over the timeline) -------
    def _require_signal(self):
        if self.carbon_signal is None:
            raise ValueError(
                "timeline has no carbon signal attached; construct "
                "PowerTimeline(carbon_signal=..., node_region=...) or run "
                "the scenario with a CarbonPolicy")

    def _power_pieces(self, scheduler: str | None = None
                      ) -> "list[tuple[float, float, float, str]]":
        """The ledger as constant-power pieces ``(start, end, watts, node)``:
        one dynamic piece per task segment plus one idle piece per merged
        busy interval per node — the exact decomposition ``energy_kj``
        sums, exposed for intensity-weighted integration."""
        segs = self._segs(scheduler)
        pieces = [(s.start_s, s.end_s, s.dyn_power_w, s.node)
                  for s in segs if s.runtime_s > 0.0]
        classes = {s.node: s.node_class for s in segs}
        for node, ivs in self.busy_intervals(scheduler).items():
            p = NODE_ENERGY_PROFILES[classes[node]]["idle_power"]
            pieces.extend((lo, hi, p, node)
                          for lo, hi in merge_intervals(ivs) if hi > lo)
        return pieces

    def region_of(self, node: str) -> str:
        return self.node_region.get(node, "default")

    def total_carbon_g(self, scheduler: str | None = None) -> float:
        """Operational carbon (grams CO2) attributed to a scheduler:
        ∫ power x intensity dt over every piece of the ledger, using the
        signal's exact interval integrals."""
        from repro_torch.core.carbon import J_PER_KWH
        self._require_signal()
        sig = self.carbon_signal
        return sum(p * sig.integral(self.region_of(node), lo, hi)
                   for lo, hi, p, node in self._power_pieces(scheduler)
                   ) / J_PER_KWH

    def carbon_series(self, scheduler: str | None = None):
        """Cumulative carbon over time: ``(edges, grams)`` with ``grams[k]``
        the CO2 emitted up to ``edges[k]`` (``grams[0]`` is 0; the final
        value equals :meth:`total_carbon_g` up to summation order). Edges
        are the power-state change points; within each edge interval the
        power is constant and the intensity integral is exact."""
        import numpy as np
        from repro_torch.core.carbon import J_PER_KWH
        self._require_signal()
        sig = self.carbon_signal
        pieces = self._power_pieces(scheduler)
        if not pieces:
            return np.zeros(0), np.zeros(0)
        edges = np.unique(np.asarray(
            [lo for lo, _, _, _ in pieces] + [hi for _, hi, _, _ in pieces]))
        # accumulate each piece's integral split at its own interior edges
        # (piece endpoints are edges, so searchsorted brackets exactly) —
        # no all-pieces scan per interval
        delta = np.zeros(len(edges) - 1)
        for lo, hi, p, node in pieces:
            region = self.region_of(node)
            i0 = int(np.searchsorted(edges, lo))
            i1 = int(np.searchsorted(edges, hi))
            for k in range(i0, i1):
                delta[k] += p * sig.integral(region, edges[k], edges[k + 1])
        return edges, np.concatenate([[0.0], np.cumsum(delta / J_PER_KWH)])

    # --- state ledger (elastic fleet subsystem) ------------------------------
    def state_energy_j(self, state: str | None = None) -> float:
        """Non-task baseline energy from the state ledger: idle power while
        IDLE or WAKING, residual draw while ASLEEP (``state`` filters to one
        state; None sums all). Zero on runs without an AutoscalePolicy."""
        return sum(iv.energy_j for iv in self.state_intervals
                   if state is None or iv.state == state)

    def wake_transition_energy_j(self) -> float:
        """Total wake-surge energy (one lump per ASLEEP→awake transition)."""
        return sum(w.energy_j for w in self.wake_transitions)

    def fleet_idle_energy_kj(self) -> float:
        """Every joule the fleet drew that is not task dynamic power:
        busy-union idle (attributed to schedulers) + state-ledger draw +
        wake surges — the quantity an idle-timeout policy exists to cut."""
        return (self.idle_energy_j(None) + self.state_energy_j()
                + self.wake_transition_energy_j()) / 1000.0

    def fleet_energy_kj(self) -> float:
        """Whole-fleet energy over the run: task dynamic energy plus
        :meth:`fleet_idle_energy_kj`."""
        return self.dynamic_energy_j(None) / 1000.0 + self.fleet_idle_energy_kj()

    def state_carbon_g(self) -> float:
        """Operational carbon of the state ledger: each interval's constant
        power integrated against its region's intensity (exact), plus each
        wake lump at the intensity of its instant."""
        from repro_torch.core.carbon import J_PER_KWH
        self._require_signal()
        sig = self.carbon_signal
        total = sum(iv.power_w * sig.integral(self.region_of(iv.node),
                                              iv.start_s, iv.end_s)
                    for iv in self.state_intervals)
        total += sum(w.energy_j * sig.intensity(self.region_of(w.node), w.t_s)
                     for w in self.wake_transitions)
        return total / J_PER_KWH

    def fleet_carbon_g(self) -> float:
        """Whole-fleet carbon: the task-attributed total plus the state
        ledger's (requires a carbon signal, like :meth:`total_carbon_g`)."""
        return self.total_carbon_g(None) + self.state_carbon_g()

    # --- telemetry (observer-only rollups) -----------------------------------
    def publish_telemetry(self, tel) -> None:
        """Roll the energy ledgers up into gauges on ``tel``: per-node
        dynamic (task) energy, per-node per-state ledger energy and
        residency seconds, per-node wake-surge energy, and the fleet
        totals. Read-only over both ledgers — callers guard on
        ``tel.enabled`` so disabled runs never pay the walk."""
        dyn: dict[str, float] = {}
        for s in self.segments:
            dyn[s.node] = dyn.get(s.node, 0.0) + s.energy_j
        for node, e in dyn.items():
            tel.set_gauge("node_dynamic_energy_j", e, node=node)
        state_e: dict[tuple[str, str], float] = {}
        state_s: dict[tuple[str, str], float] = {}
        for iv in self.state_intervals:
            key = (iv.node, iv.state)
            state_e[key] = state_e.get(key, 0.0) + iv.energy_j
            state_s[key] = state_s.get(key, 0.0) + (iv.end_s - iv.start_s)
        for (node, state), e in state_e.items():
            tel.set_gauge("node_state_energy_j", e, node=node, state=state)
            tel.set_gauge("node_state_seconds", state_s[(node, state)],
                          node=node, state=state)
        wake: dict[str, float] = {}
        for w in self.wake_transitions:
            wake[w.node] = wake.get(w.node, 0.0) + w.energy_j
        for node, e in wake.items():
            tel.set_gauge("node_wake_energy_j", e, node=node)
        tel.set_gauge("fleet_dynamic_energy_kj",
                      self.dynamic_energy_j(None) / 1000.0)
        tel.set_gauge("fleet_idle_energy_kj", self.fleet_idle_energy_kj())
        tel.set_gauge("fleet_energy_kj", self.fleet_energy_kj())

    def publish_series(self, tel) -> None:
        """Expose the ledgers as sim-time :class:`~repro_torch.core.telemetry.
        TimeSeries` on ``tel``: per-scheduler cumulative energy
        (``scheduler_energy_cum_kj``), per-state fleet baseline power
        (``state_power_w``), and — when a carbon signal is attached —
        per-region cumulative carbon (``region_carbon_cum_g``). Like
        :meth:`publish_telemetry` this is read-only over the ledgers and
        deterministic: every sample is derived from committed segments, so
        backends with bitwise-identical placements record identical series."""
        import numpy as np
        for sched in sorted({s.scheduler for s in self.segments}):
            edges, joules = self.energy_series(sched)
            for t, j in zip(edges.tolist(), joules.tolist()):
                tel.record("scheduler_energy_cum_kj", t, j / 1000.0,
                           scheduler=sched)
        states = sorted({iv.state for iv in self.state_intervals})
        for state in states:
            ivs = [iv for iv in self.state_intervals if iv.state == state]
            edges = np.unique(np.asarray(
                [iv.start_s for iv in ivs] + [iv.end_s for iv in ivs]))
            idx = {t: i for i, t in enumerate(edges.tolist())}
            delta = np.zeros(len(edges))
            for iv in ivs:
                delta[idx[iv.start_s]] += iv.power_w
                delta[idx[iv.end_s]] -= iv.power_w
            watts = np.cumsum(delta)
            for t, w in zip(edges.tolist(), watts.tolist()):
                tel.record("state_power_w", t, w, state=state)
        if self.carbon_signal is not None:
            from repro_torch.core.carbon import J_PER_KWH
            sig = self.carbon_signal
            by_region: dict[str, list[tuple[float, float, float, str]]] = {}
            for piece in self._power_pieces(None):
                by_region.setdefault(self.region_of(piece[3]),
                                     []).append(piece)
            for region in sorted(by_region):
                pieces = by_region[region]
                edges = np.unique(np.asarray(
                    [lo for lo, _, _, _ in pieces]
                    + [hi for _, hi, _, _ in pieces]))
                delta = np.zeros(len(edges) - 1)
                for lo, hi, p, _node in pieces:
                    i0 = int(np.searchsorted(edges, lo))
                    i1 = int(np.searchsorted(edges, hi))
                    for k in range(i0, i1):
                        delta[k] += p * sig.integral(region, edges[k],
                                                     edges[k + 1])
                grams = np.concatenate(
                    [[0.0], np.cumsum(delta / J_PER_KWH)])
                for t, g in zip(edges.tolist(), grams.tolist()):
                    tel.record("region_carbon_cum_g", t, g, region=region)


# --- TPU fleet (beyond-paper) ----------------------------------------------
TPU_V5E_TDP_W = 250.0        # per-chip board power envelope
TPU_V5E_IDLE_W = 70.0


def chip_energy_joules(step_time_s: float, chips: int,
                       utilization: float) -> float:
    p = TPU_V5E_IDLE_W + (TPU_V5E_TDP_W - TPU_V5E_IDLE_W) * utilization
    return step_time_s * chips * p
