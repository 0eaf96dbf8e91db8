"""Scheduling-policy protocol and typed events for the simulation kernel.

The discrete-event kernel (``repro_torch.cluster.engine``) owns the clock, the
pending/running queues, and the scheduling round; everything else — carbon
temporal shifting, the elastic power-state lifecycle, and any future policy
(cost-benefit drain, predictive wake) — plugs in through the
:class:`SchedulingPolicy` hook protocol defined here. The protocol lives in
this leaf module (stdlib + numpy only) so policy implementations in
``repro_torch.core.carbon`` / ``repro_torch.core.elastic`` can subclass it without
importing the kernel, and the kernel can import the policies' dependencies
freely.

Event kinds
-----------

Every clock advance in the kernel is one of five typed events:

* ``ARRIVAL``          — a burst of pods lands (from the arrival process).
* ``COMPLETION``       — the earliest running task ends (backoff/retry step).
* ``CARBON_CHECK``     — a carbon-policy wake: re-test the deferral dip /
                         preemption spike (cadence wakes and exact deadlines).
* ``WAKE_DONE``        — an in-flight node wake completes (pods committed to
                         the WAKING node start now; the round re-runs).
* ``CONSOLIDATE_TICK`` — the periodic consolidation drain pass fires.

``ARRIVAL`` and ``COMPLETION`` are produced by the kernel itself;
wake-like events come from each policy's :meth:`~SchedulingPolicy.
next_wake_time`. Ties are broken COMPLETION < ARRIVAL < wake-like, then by
policy order — exactly the pre-kernel engine's hand-merged clock advance.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

import numpy as np

if TYPE_CHECKING:   # kernel types, import-free at runtime (no cycle)
    from repro_torch.cluster.engine import EventEngine
    from repro_torch.cluster.workload import Pod

# Event kinds (Event.kind values; also the kernel's event-log tags).
ARRIVAL = "arrival"
COMPLETION = "completion"
CARBON_CHECK = "carbon_check"
WAKE_DONE = "wake_done"
CONSOLIDATE_TICK = "consolidate_tick"
EVENT_KINDS = (ARRIVAL, COMPLETION, CARBON_CHECK, WAKE_DONE,
               CONSOLIDATE_TICK)

# Tie-break priority when several events land on one instant: release a
# completion first (freed capacity is visible to the round), ingest the
# arrival burst second, fire policy wakes last.
_PRIORITY = {COMPLETION: 0, ARRIVAL: 1, CARBON_CHECK: 2, WAKE_DONE: 2,
             CONSOLIDATE_TICK: 2}


@dataclasses.dataclass(order=True, frozen=True)
class Event:
    """One typed point on the simulation clock. Ordered by ``(t, priority)``
    so ``min()`` over candidate events reproduces the engine's tie rules;
    ``payload`` (a uid, a burst size, a node index — kind-dependent) never
    participates in ordering."""

    t: float
    priority: int
    kind: str = dataclasses.field(compare=False)
    payload: object = dataclasses.field(compare=False, default=None)

    @classmethod
    def make(cls, t: float, kind: str, payload: object = None) -> "Event":
        return cls(t, _PRIORITY[kind], kind, payload)


class SchedulingPolicy:
    """Hook protocol a scheduling policy implements against the kernel.

    The kernel calls the hooks in a fixed per-round order, for every policy
    in the engine's (ordered) policy list; every hook receives the engine
    (``sim``) whose ``state`` holds the queues, records, timeline, and
    counters, and whose services (``sim.evict``, ``sim.block_restart``,
    ``sim.deadline``) expose the preemption/requeue machinery. All hooks
    are no-ops by default — a policy overrides only what it needs.

    Round lifecycle (``t`` is the kernel clock):

    1.  ``bind(sim)``          — once, at run start (capture fleet state).
    2.  ``on_arrival``         — per pod, as its burst is ingested
                                 (validate, bookkeep).
    3.  ``on_clock``           — the clock landed on ``t``; finalize any
                                 lazily-derived state before the round.
    4.  ``on_round_start``     — mutate the queues before scheduling
                                 (preempt/evict, consolidation drains).
    5.  ``exclude_mask`` /
        ``exclude_for``        — (N,) fleet-wide and per-pod scoring masks.
    6.  ``filter_pending``     — pods to hold out of this round (deferral).
    7.  ``on_commit``          — a pod bound to a node; may move its
                                 effective start (WAKING nodes).
    8.  ``on_completion`` /
        ``on_evict``           — a task left its node (ran out / evicted).
    9.  ``on_round_end``       — the round placed what it could; react to
                                 still-unplaced pods (pressure wakes).
    10. ``next_wake_time``     — the policy's earliest future event, as a
                                 typed :class:`Event` (or None).
    11. ``on_tick``            — a wake-like event this policy scheduled
                                 just fired (observation hook).
    12. ``finalize``           — end of run (close ledgers, flush counters).
    """

    @property
    def carbon_signal(self):
        """Grid-intensity signal this policy wants attached to the TOPSIS
        schedulers (sixth criterion) and the run's power timeline (carbon
        accounting); None for signal-free policies."""
        return None

    def bind(self, sim: "EventEngine") -> None:
        """Run start: the engine's fleet/queues/timeline exist."""

    def on_arrival(self, sim: "EventEngine", pod: "Pod", t: float) -> None:
        """``pod`` ingested from a burst at clock ``t`` (validate here)."""

    def on_clock(self, sim: "EventEngine", t: float) -> None:
        """Clock advanced to ``t``; runs before any round-start mutation."""

    def on_round_start(self, sim: "EventEngine", t: float) -> None:
        """Mutate queues before the scheduling round (evictions, drains)."""

    def exclude_mask(self, sim: "EventEngine", t: float) -> np.ndarray | None:
        """(N,) bool of nodes no pod may be placed on this round."""
        return None

    def exclude_for(self, sim: "EventEngine", pod: "Pod",
                    base: np.ndarray | None,
                    t: float) -> np.ndarray | None:
        """Per-pod extra exclusions on top of the round's combined ``base``
        mask (None when no policy set a fleet-wide mask); return None to
        keep ``base`` as-is."""
        return None

    def filter_pending(self, sim: "EventEngine", pods: Sequence["Pod"],
                       t: float) -> "list[Pod]":
        """Subset of ``pods`` to hold out of this round (deferral). Held
        pods keep their queue position and are retried at the policy's
        next wake."""
        return []

    def on_commit(self, sim: "EventEngine", node_index: int,
                  t: float) -> float | None:
        """A pod was bound to ``node_index`` at ``t``; return an adjusted
        effective start time (e.g. a WAKING node's ready instant) or None
        to keep the current one."""
        return None

    def on_completion(self, sim: "EventEngine", node_index: int,
                      end_t: float) -> None:
        """A running task on ``node_index`` completed at ``end_t``."""

    def on_evict(self, sim: "EventEngine", node_index: int,
                 t: float) -> None:
        """A running task was evicted off ``node_index`` at ``t``."""

    def on_round_end(self, sim: "EventEngine", unplaced: Sequence["Pod"],
                     held: Sequence["Pod"], t: float) -> None:
        """The round is over; ``unplaced`` pods found no node (``held`` ⊆
        ``unplaced`` sat the round out voluntarily)."""

    def next_wake_time(self, sim: "EventEngine", t: float,
                       held: Sequence["Pod"]) -> Event | None:
        """This policy's earliest event strictly after ``t`` (a
        CARBON_CHECK / WAKE_DONE / CONSOLIDATE_TICK), or None."""
        return None

    def on_tick(self, sim: "EventEngine", event: Event) -> None:
        """A wake-like event contributed by this policy just fired."""

    def finalize(self, sim: "EventEngine", horizon: float) -> None:
        """End of run: close ledgers, publish counters into the state."""
