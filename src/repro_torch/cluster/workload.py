"""Containerized AIoT workloads (paper Table II), competition levels
(paper Table V), and the arrival processes that feed the event-driven
simulator (paper-mode t=0 burst, Poisson bursts, replayable JSON traces)."""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    kind: str            # light | medium | complex
    cpu_request: float   # vCPU (K8s resource request)
    mem_request: float   # GB
    base_time_s: float   # runtime on a class-B node (speed 1.0), calibrated
    description: str


# Table II. base_time_s calibrated so the default-K8s column of Table VI is
# matched (DESIGN.md §7); TOPSIS columns are then predictions.
WORKLOADS: dict[str, WorkloadSpec] = {
    "light": WorkloadSpec("light", 0.2, 0.5, 12.6489,
                          "basic linear regression, 1k samples"),
    "medium": WorkloadSpec("medium", 0.5, 1.0, 55.4095,
                           "scalable linear regression, 1M samples"),
    "complex": WorkloadSpec("complex", 1.0, 2.0, 39.3375,
                            "distributed linear regression, 10M samples"),
}


@dataclasses.dataclass(frozen=True)
class Pod:
    uid: int
    workload: WorkloadSpec
    scheduler: str        # "topsis" | "default"
    # Carbon-aware temporal shifting (repro_torch.core.carbon): a deferrable pod
    # may wait for a grid-carbon dip before scheduling — but never more than
    # deadline_s past its arrival — and may be preempted+requeued (once)
    # when its node's regional intensity spikes. Inert without a
    # CarbonPolicy on the run.
    deferrable: bool = False
    deadline_s: float = 600.0     # relative to arrival; must stay finite

    @property
    def cpu(self) -> float:
        return self.workload.cpu_request

    @property
    def mem(self) -> float:
        return self.workload.mem_request


# Table V: per scheduler pod counts (light, medium, complex).
COMPETITION_LEVELS: dict[str, dict[str, int]] = {
    "low": {"light": 2, "medium": 1, "complex": 1},
    "medium": {"light": 4, "medium": 2, "complex": 1},
    "high": {"light": 6, "medium": 3, "complex": 2},
}


def make_pods(level: str) -> list[Pod]:
    """Interleaved TOPSIS/default pod arrival stream for a competition level.

    The paper deploys both schedulers' pods concurrently on the shared
    cluster (Table V: 'N (k TOPSIS, k Default)'): arrivals are interleaved
    (default, topsis, default, ...), heavy pods first within each
    scheduler's batch. This reproduces the structure of paper Table VI —
    the default column is near-constant per level at low/medium (little
    cross-scheduler interaction) but varies slightly at high competition
    (0.4471 vs 0.4257), exactly the shared-cluster contention signature.
    """
    counts = COMPETITION_LEVELS[level]
    uid = itertools.count()
    pods: list[Pod] = []
    order = ["complex", "medium", "light"]
    per_sched = {
        s: [Pod(next(uid), WORKLOADS[k], s)
            for k in order for _ in range(counts[k])]
        for s in ("default", "topsis")
    }
    for d, t in zip(per_sched["default"], per_sched["topsis"]):
        pods.extend((d, t))
    return pods


# --- Arrival processes (event-driven simulator input) ------------------------
class ArrivalProcess:
    """A time-ordered stream of pod-arrival bursts.

    Implementations yield ``(t_arrival_s, [Pod, ...])`` events from
    :meth:`events`, non-decreasing in time. The event-driven simulator
    (``repro_torch.cluster.simulator.run_scenario``) ingests each burst when the
    clock reaches it; TOPSIS pods of a burst can be scored in one batched
    pass (``BatchScheduler.select_many``). Processes must be deterministic
    for a fixed construction (seeded RNGs), so scenario runs replay exactly.
    """

    def events(self) -> "list[tuple[float, list[Pod]]]":
        raise NotImplementedError

    def total_pods(self) -> int:
        return sum(len(pods) for _, pods in self.events())


class PaperArrivals(ArrivalProcess):
    """Paper mode (§IV): every pod of a competition level arrives at t=0 in
    the interleaved Table-V stream — one burst, post-hoc energy over the
    busy union. ``table6()`` routes through this process, which is what
    pins the event-driven engine to the paper's factorial numbers."""

    def __init__(self, level: str):
        self.level = level

    def events(self):
        return [(0.0, make_pods(self.level))]


class PoissonArrivals(ArrivalProcess):
    """Poisson burst arrivals: burst epochs are a Poisson process of rate
    ``rate_per_s`` (exponential inter-arrival gaps), each burst holds
    ``burst_size`` pods whose kinds are drawn from ``mix`` (a
    kind -> probability dict over ``WORKLOADS``) and whose scheduler is
    "topsis" with probability ``topsis_share`` else "default". Fixed
    ``seed`` makes the stream replayable; ``n_bursts`` bounds the horizon.
    """

    def __init__(self, rate_per_s: float = 0.2, n_bursts: int = 10,
                 burst_size: int = 4, mix: dict[str, float] | None = None,
                 topsis_share: float = 0.5, seed: int = 0,
                 deferrable_share: float = 0.0, deadline_s: float = 600.0):
        if rate_per_s <= 0:
            raise ValueError("rate_per_s must be positive")
        self.rate_per_s = rate_per_s
        self.n_bursts = n_bursts
        self.burst_size = burst_size
        self.mix = dict(mix or {"light": 0.5, "medium": 0.3, "complex": 0.2})
        if any(k not in WORKLOADS for k in self.mix):
            raise ValueError(f"unknown workload kind in mix: {self.mix}")
        self.topsis_share = topsis_share
        # carbon-aware temporal shifting: each pod is deferrable with this
        # probability; at 0.0 (default) the RNG stream is untouched, so
        # pre-carbon scenarios replay bitwise
        if not 0.0 <= deferrable_share <= 1.0:
            raise ValueError(f"deferrable_share must be in [0, 1], "
                             f"got {deferrable_share}")
        if not (math.isfinite(deadline_s) and deadline_s > 0.0):
            raise ValueError(f"deadline_s must be finite and positive, "
                             f"got {deadline_s}")
        self.deferrable_share = deferrable_share
        self.deadline_s = deadline_s
        self.seed = seed

    def events(self):
        import numpy as np
        rng = np.random.default_rng(self.seed)
        kinds = list(self.mix)
        probs = np.asarray([self.mix[k] for k in kinds], dtype=np.float64)
        probs = probs / probs.sum()
        uid = itertools.count()
        t = 0.0
        out: list[tuple[float, list[Pod]]] = []
        for _ in range(self.n_bursts):
            t += float(rng.exponential(1.0 / self.rate_per_s))
            burst = [
                Pod(next(uid),
                    WORKLOADS[kinds[int(rng.choice(len(kinds), p=probs))]],
                    "topsis" if rng.uniform() < self.topsis_share
                    else "default",
                    deferrable=(self.deferrable_share > 0.0
                                and rng.uniform() < self.deferrable_share),
                    deadline_s=self.deadline_s)
                for _ in range(self.burst_size)
            ]
            out.append((t, burst))
        return out


class TraceArrivals(ArrivalProcess):
    """Replayable arrival trace: a list of ``{"t": float, "kind": str,
    "scheduler": "topsis"|"default", "count": int, "deferrable": bool,
    "deadline_s": float}`` entries (count defaults to 1, deferrable to
    False, deadline_s to the Pod default), e.g. loaded from a JSON file via
    :meth:`from_file`. Entries sharing one ``t`` form one burst; bursts are
    emitted in time-sorted order, entry order preserved within a burst — so
    a trace replays to the identical pod stream every run.

    Every entry is validated up front with a message naming the offending
    entry (and, when loaded via :meth:`from_file`, the source file) — a
    malformed trace fails at construction, not deep inside the event
    engine.
    """

    def __init__(self, entries: "list[dict]", source: str | None = None):
        self.entries = list(entries)
        prefix = f"{source}: " if source else ""
        for i, e in enumerate(self.entries):
            where = f"{prefix}trace entry {i} ({e!r})"
            if not isinstance(e, dict):
                raise ValueError(f"{where}: expected an object with at "
                                 f"least 't' and 'kind' fields")
            try:
                t_ok = math.isfinite(float(e["t"])) and float(e["t"]) >= 0.0
            except (KeyError, TypeError, ValueError):
                t_ok = False
            if not t_ok:
                raise ValueError(f"{where}: needs a finite non-negative "
                                 f"arrival time 't'")
            if e.get("kind") not in WORKLOADS:
                raise ValueError(
                    f"{where}: unknown workload kind {e.get('kind')!r}; "
                    f"choose from {sorted(WORKLOADS)}")
            if e.get("scheduler", "topsis") not in ("topsis", "default"):
                raise ValueError(
                    f"{where}: unknown scheduler {e['scheduler']!r}; "
                    f"choose 'topsis' or 'default'")
            count = e.get("count", 1)
            try:
                count_ok = int(count) == count and int(count) > 0
            except (TypeError, ValueError):
                count_ok = False
            if not count_ok:
                raise ValueError(f"{where}: 'count' must be a positive "
                                 f"integer, got {count!r}")
            ddl = e.get("deadline_s", 1.0)
            try:
                ddl_ok = math.isfinite(float(ddl)) and float(ddl) > 0.0
            except (TypeError, ValueError):
                ddl_ok = False
            if not ddl_ok:
                raise ValueError(f"{where}: 'deadline_s' must be finite "
                                 f"and positive, got {ddl!r}")

    @classmethod
    def from_file(cls, path) -> "TraceArrivals":
        """Load a JSON trace; ``path`` may be a ``str`` or any
        ``os.PathLike`` (``pathlib.Path``). Validation errors are prefixed
        with the file path and the offending entry's index."""
        with open(path) as f:
            return cls(json.load(f), source=os.fspath(path))

    def events(self):
        uid = itertools.count()
        by_t: dict[float, list[Pod]] = {}
        for e in sorted(self.entries, key=lambda e: float(e["t"])):
            pods = by_t.setdefault(float(e["t"]), [])
            kw = {}
            if "deferrable" in e:
                kw["deferrable"] = bool(e["deferrable"])
            if "deadline_s" in e:
                kw["deadline_s"] = float(e["deadline_s"])
            for _ in range(int(e.get("count", 1))):
                pods.append(Pod(next(uid), WORKLOADS[e["kind"]],
                                e.get("scheduler", "topsis"), **kw))
        return sorted(by_t.items())
