"""Elastic fleet power states (port of ``repro.core.elastic``, first part).

Every node of an elastic fleet is in one of four states::

    ACTIVE --(last task ends)--> IDLE --(idle_timeout_s)--> ASLEEP
      ^                           |                            |
      |                           +--(task commits)            |
      +--(wake completes, tasks)--WAKING <--(policy wake)------+

This part carries the state names (``NodeTable.power_state`` holds them;
the ``awake`` criterion derives from them when set) and the per-class
wake/sleep profiles the engine's power accounting reads. With no power
state set, every node keeps the legacy busy-derived ``awake`` rule.

Not yet ported (ROADMAP Queue 1): ``AutoscalePolicy``, ``ElasticFleet`` and
the ``AutoscaleScheduling`` engine policy.
"""
from __future__ import annotations

from repro_torch.core.energy import NODE_ENERGY_PROFILES

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
