"""Cluster node model — paper Table I node categories — plus the
struct-of-arrays ``NodeTable`` the fleet-scale batched scheduler scores
against (one numpy array per column instead of one Python object per node).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.carbon import DEFAULT_REGIONS
from repro_torch.core.elastic import ASLEEP
from repro_torch.core.energy import NODE_ENERGY_PROFILES


@dataclasses.dataclass
class Node:
    name: str
    node_class: str          # "A" | "B" | "C" | "default"
    vcpus: float
    mem_gb: float
    # system components (kube-system etc.) reserve resources on the default node
    reserved_cpu: float = 0.0
    reserved_mem: float = 0.0
    used_cpu: float = 0.0
    used_mem: float = 0.0
    # grid region the node draws power from (carbon-aware stack,
    # repro_torch.core.carbon); the paper's cluster keeps the single "default"
    region: str = "default"
    # power-state lifecycle (elastic fleet subsystem, repro_torch.core.elastic):
    # "active" | "idle" | "asleep" | "waking", maintained by ElasticFleet
    # when an AutoscalePolicy drives the run. None (the default) means "no
    # lifecycle" — the awake criterion falls back to the static used_cpu
    # derivation and everything reproduces the policy-free engine bitwise.
    power_state: str | None = None

    @property
    def speed(self) -> float:
        return NODE_ENERGY_PROFILES[self.node_class]["speed"]

    @property
    def free_cpu(self) -> float:
        return self.vcpus - self.reserved_cpu - self.used_cpu

    @property
    def free_mem(self) -> float:
        return self.mem_gb - self.reserved_mem - self.used_mem

    @property
    def cpu_util(self) -> float:
        return (self.reserved_cpu + self.used_cpu) / self.vcpus

    @property
    def mem_util(self) -> float:
        return (self.reserved_mem + self.used_mem) / self.mem_gb

    def fits(self, cpu: float, mem: float) -> bool:
        return self.free_cpu >= cpu - 1e-9 and self.free_mem >= mem - 1e-9

    def bind(self, cpu: float, mem: float) -> None:
        assert self.fits(cpu, mem), f"overcommit on {self.name}"
        self.used_cpu += cpu
        self.used_mem += mem

    def release(self, cpu: float, mem: float) -> None:
        self.used_cpu -= cpu
        self.used_mem -= mem


@dataclasses.dataclass
class NodeTable:
    """Struct-of-arrays fleet view: column arrays over N nodes.

    The scheduler hot path builds its (N, 5) decision matrix by
    broadcasting over these columns — no Python-level per-node loop — which
    is what lets the same code scale from the paper's 4-node cluster to the
    1000+-node fleets the Pallas kernel targets. All columns are copied out
    of the source ``Node`` list at construction (a snapshot, not a view):
    rebuild via :meth:`from_nodes` after cluster state changes, or mutate
    the ``used_*`` arrays directly when the table is the source of truth
    (synthetic fleets from :func:`make_fleet`).
    """

    names: list[str]
    node_class: list[str]
    vcpus: np.ndarray          # (N,) float64
    mem_gb: np.ndarray
    reserved_cpu: np.ndarray
    reserved_mem: np.ndarray
    used_cpu: np.ndarray
    used_mem: np.ndarray
    speed: np.ndarray
    dyn_power_per_vcpu: np.ndarray
    idle_power: np.ndarray
    # grid region per node (carbon column lookups); defaults to "default"
    # everywhere for tables built before the carbon stack existed
    region: list[str] = dataclasses.field(default_factory=list)
    # power-state column (elastic fleet subsystem): None entries mean "no
    # lifecycle" and keep the legacy awake derivation for that node
    power_state: "list[str | None]" = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.region:
            self.region = ["default"] * len(self.names)
        if not self.power_state:
            self.power_state = [None] * len(self.names)
        # precompute the lifecycle masks once per snapshot so the hot
        # `awake` property stays a vectorized select (None = no lifecycle)
        if any(s is not None for s in self.power_state):
            self._state_known = np.asarray(
                [s is not None for s in self.power_state])
            self._state_awake = np.asarray(
                [s is not None and s != ASLEEP for s in self.power_state])
        else:
            self._state_known = None
            self._state_awake = None

    @classmethod
    def from_nodes(cls, nodes: Sequence[Node]) -> "NodeTable":
        prof = [NODE_ENERGY_PROFILES[n.node_class] for n in nodes]
        f64 = lambda xs: np.asarray(xs, dtype=np.float64)
        return cls(
            names=[n.name for n in nodes],
            node_class=[n.node_class for n in nodes],
            vcpus=f64([n.vcpus for n in nodes]),
            mem_gb=f64([n.mem_gb for n in nodes]),
            reserved_cpu=f64([n.reserved_cpu for n in nodes]),
            reserved_mem=f64([n.reserved_mem for n in nodes]),
            used_cpu=f64([n.used_cpu for n in nodes]),
            used_mem=f64([n.used_mem for n in nodes]),
            speed=f64([p["speed"] for p in prof]),
            dyn_power_per_vcpu=f64([p["dyn_power_per_vcpu"] for p in prof]),
            idle_power=f64([p["idle_power"] for p in prof]),
            region=[n.region for n in nodes],
            power_state=[n.power_state for n in nodes],
        )

    def __len__(self) -> int:
        return len(self.names)

    @property
    def free_cpu(self) -> np.ndarray:
        return self.vcpus - self.reserved_cpu - self.used_cpu

    @property
    def free_mem(self) -> np.ndarray:
        return self.mem_gb - self.reserved_mem - self.used_mem

    @property
    def cpu_util(self) -> np.ndarray:
        return (self.reserved_cpu + self.used_cpu) / self.vcpus

    @property
    def awake(self) -> np.ndarray:
        """Awake mask feeding the marginal-idle rule of the energy and
        carbon-rate criteria: an awake node's idle power is already paid,
        so a placement there costs only dynamic power. With a real
        power-state column (elastic fleet subsystem) a node is awake in
        every state but ASLEEP — in particular an empty-but-IDLE node is
        awake, unlike the static derivation that treats every empty node as
        a wake-up cost. Nodes without a lifecycle keep the legacy
        ``used_cpu > 0`` derivation, bitwise."""
        derived = self.used_cpu > 1e-9
        if self._state_known is None:
            return derived
        return np.where(self._state_known, self._state_awake, derived)

    def fits(self, cpu, mem) -> np.ndarray:
        """Bool feasibility mask (PodFitsResources filter): (N,) for scalar
        requests, (P, N) when cpu/mem are (P, 1) request columns."""
        return ((self.free_cpu >= cpu - 1e-9)
                & (self.free_mem >= mem - 1e-9))


@dataclasses.dataclass
class FleetState(NodeTable):
    """Delta-maintained :class:`NodeTable`: the event engine's single source
    of truth for fleet state.

    Where a plain ``NodeTable`` is a throwaway snapshot (rebuilt from the
    ``Node`` list every scoring call), a ``FleetState`` is *long-lived*: the
    engine routes every mutation — task commit, completion release, eviction,
    power-state transition — through :meth:`bind` / :meth:`release` /
    :meth:`set_power_states`, which update only the touched node's column
    entries (O(touched columns), no per-round O(N) re-flatten) and keep the
    backing ``Node`` objects in sync, so policies that read per-node views
    (``sim.state.nodes[i]``) keep working unchanged.

    Dirty-column contract: every mutation stamps the touched node with a
    monotonically increasing modification version. A consumer (the
    schedulers' incremental decision-matrix caches, the jax device mirror)
    remembers the :attr:`version` it last synced at and asks
    :meth:`modified_since` for the node indices whose criteria columns must
    be recomputed — anything else is guaranteed bitwise-identical to a fresh
    ``NodeTable.from_nodes(nodes)`` rebuild (tests/test_fleet_state.py pins
    this with a randomized-interleaving property test). Multiple consumers
    with independent cursors can share one ``FleetState``. Mutating the
    ``Node`` objects or the column arrays directly (instead of going through
    the mutators) breaks the contract — consumers would silently serve stale
    columns.
    """

    def __post_init__(self):
        super().__post_init__()
        # authoritative per-node views (set by from_nodes); kept in sync by
        # the mutators below so policy code can keep reading Node objects
        self.nodes: list[Node] = []
        self._mod = np.zeros(len(self.names), dtype=np.int64)
        self.version = 0

    @classmethod
    def from_nodes(cls, nodes: Sequence[Node]) -> "FleetState":
        fs = super().from_nodes(nodes)
        fs.nodes = list(nodes)
        return fs

    def _touch(self, i: int) -> None:
        self.version += 1
        self._mod[i] = self.version

    def modified_since(self, version: int) -> np.ndarray:
        """Indices of nodes mutated after a consumer's last-synced
        ``version`` (ascending). The consumer should store
        ``self.version`` as its new cursor *before* recomputing."""
        return np.flatnonzero(self._mod > version)

    def bind(self, i: int, cpu: float, mem: float) -> None:
        """Commit ``cpu``/``mem`` on node ``i``: Node object and ``used_*``
        columns move together, and the node is marked dirty."""
        node = self.nodes[i]
        node.bind(cpu, mem)
        self.used_cpu[i] = node.used_cpu
        self.used_mem[i] = node.used_mem
        self._touch(i)

    def release(self, i: int, cpu: float, mem: float) -> None:
        """Release ``cpu``/``mem`` on node ``i`` (completion or eviction)."""
        node = self.nodes[i]
        node.release(cpu, mem)
        self.used_cpu[i] = node.used_cpu
        self.used_mem[i] = node.used_mem
        self._touch(i)

    def set_power_states(self, states: "Sequence[str | None]") -> None:
        """Sync the power-state column to ``states`` (one entry per node),
        touching only nodes whose state actually changed — the elastic
        fleet rewrites all N states every round, but a round typically
        transitions a handful of nodes. State changes dirty the node
        because the ``awake`` mask feeds the energy and carbon-rate
        criteria columns."""
        changed = [i for i, (old, new)
                   in enumerate(zip(self.power_state, states)) if old != new]
        if not changed:
            return
        if self._state_known is None:
            self._state_known = np.asarray(
                [s is not None for s in self.power_state])
            self._state_awake = np.asarray(
                [s is not None and s != ASLEEP for s in self.power_state])
        for i in changed:
            s = states[i]
            self.power_state[i] = s
            self.nodes[i].power_state = s
            self._state_known[i] = s is not None
            self._state_awake[i] = s is not None and s != ASLEEP
            self._touch(i)


# Paper Table-I capacities (vcpus, mem_gb) per node class, and the capacity
# jitter applied to synthetic fleets — shared by make_fleet and
# make_scenario_cluster so the two fleet generators never desynchronize.
NODE_CAPS: dict[str, tuple[float, float]] = {
    "A": (2, 4), "B": (2, 8), "C": (4, 16), "default": (2, 8)}
CAP_SCALES = (1, 2, 4)


def make_fleet_nodes(n: int, seed: int = 0, utilization: float = 0.0,
                     regions: Sequence[str] = DEFAULT_REGIONS) -> list[Node]:
    """The ``Node`` objects behind :func:`make_fleet` — same rng stream,
    same values, but as mutable per-node views. Feed to
    :meth:`FleetState.from_nodes` when the fleet must be *maintained*
    (incremental engine rounds) rather than snapshotted once."""
    rng = np.random.default_rng(seed)
    classes = list(NODE_CAPS)
    nodes = []
    for i in range(n):
        cls_i = classes[int(rng.integers(len(classes)))]
        vcpus, mem = NODE_CAPS[cls_i]
        scale = float(rng.choice(CAP_SCALES))
        nodes.append(Node(f"node-{i:05d}", cls_i, vcpus * scale, mem * scale,
                          region=regions[i % len(regions)]))
    if utilization > 0.0:
        u = rng.uniform(0.0, min(2.0 * utilization, 0.95), n)
        for node, ui in zip(nodes, u):
            node.used_cpu = float(ui * (node.vcpus - node.reserved_cpu))
            node.used_mem = float(ui * (node.mem_gb - node.reserved_mem))
    return nodes


def make_fleet(n: int, seed: int = 0, utilization: float = 0.0,
               regions: Sequence[str] = DEFAULT_REGIONS) -> NodeTable:
    """Synthetic heterogeneous fleet of ``n`` nodes for benchmarks/examples:
    the paper's Table-I node classes replicated with jittered capacities and
    (optionally) random pre-existing load. Nodes are spread round-robin
    across ``regions`` (inert unless a carbon signal is attached)."""
    return NodeTable.from_nodes(make_fleet_nodes(n, seed=seed,
                                                 utilization=utilization,
                                                 regions=regions))


# Scenario fleet class mixes: probability of each Table-I node class.
# edge_heavy skews to frugal e2-medium-like boxes (far-edge deployments),
# cloud_heavy to the fast, power-hungry n2-standard-4 tier, mixed is uniform.
SCENARIO_PROFILES: dict[str, dict[str, float]] = {
    "edge_heavy": {"A": 0.60, "B": 0.25, "C": 0.05, "default": 0.10},
    "cloud_heavy": {"A": 0.05, "B": 0.25, "C": 0.60, "default": 0.10},
    "mixed": {"A": 0.25, "B": 0.25, "C": 0.25, "default": 0.25},
}


def make_scenario_cluster(profile: str, n: int, seed: int = 0,
                          regions: Sequence[str] = DEFAULT_REGIONS
                          ) -> list[Node]:
    """Scenario fleet for the event-driven engine: ``n`` mutable ``Node``
    objects (4 ≤ n ≤ 131072) whose class mix follows ``SCENARIO_PROFILES``.

    The first four nodes are one of each Table-I class at paper capacities
    (every fleet keeps the paper's heterogeneity axis; unlike
    :func:`make_paper_cluster`, no system reservations on the default
    node); the rest are drawn from the profile's mix with the capacity
    jitter of :func:`make_fleet`. Nodes are spread round-robin across
    ``regions`` (drives the carbon column when a signal is attached;
    inert otherwise). Deterministic in ``seed`` — scenario runs replay
    exactly. The engine wraps these in a delta-maintained
    :class:`FleetState` (burst scoring recomputes only dirty node columns,
    which is what lets scenario fleets scale past the old 8192 ceiling).
    """
    if profile not in SCENARIO_PROFILES:
        raise ValueError(f"unknown profile {profile!r}; "
                         f"choose from {sorted(SCENARIO_PROFILES)}")
    if not 4 <= n <= 131072:
        raise ValueError(f"fleet size {n} outside [4, 131072]")
    rng = np.random.default_rng(seed)
    mix = SCENARIO_PROFILES[profile]
    classes = list(mix)
    probs = np.asarray([mix[c] for c in classes], dtype=np.float64)
    nodes = []
    for i in range(n):
        cls_i = (classes[i] if i < 4
                 else classes[int(rng.choice(len(classes), p=probs))])
        vcpus, mem = NODE_CAPS[cls_i]
        scale = 1.0 if i < 4 else float(rng.choice(CAP_SCALES))
        nodes.append(Node(f"{profile}-{i:05d}", cls_i,
                          vcpus * scale, mem * scale,
                          region=regions[i % len(regions)]))
    return nodes


def make_paper_cluster() -> list[Node]:
    """Heterogeneous GKE cluster of paper Table I (one node per category)."""
    return [
        Node("node-a", "A", vcpus=2, mem_gb=4),                     # e2-medium
        Node("node-b", "B", vcpus=2, mem_gb=8),                     # n2-standard-2
        Node("node-c", "C", vcpus=4, mem_gb=16),                    # n2-standard-4
        Node("node-default", "default", vcpus=2, mem_gb=8,          # e2-standard-2
             reserved_cpu=0.5, reserved_mem=1.5),                   # system components
    ]
