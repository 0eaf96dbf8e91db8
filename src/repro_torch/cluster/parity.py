"""Backend parity of an engine run under the near-tie rule.

The port's float32 backends (``torch``, ``cuda``) break some float64
near-ties another way than ``numpy`` (ROADMAP Queue 3), and in a policy
run one such break changes everything after it. So two runs are compared
by replay: the float32 run records every scoring call (an engine round, or
a queue-pressure wake's scoring of one pod inside ``elastic._best_node``);
the numpy run scores each call again on its own fleet state, holds the
closeness within :data:`TOL`, shows every pick that differs to be a float64
near-tie under the same ledger (:func:`near_tie_walk`), and then follows
the float32 run's picks, so the two runs must end equal.

Used by ``chip_smoke.py`` (its ``[policy]`` and ``[pareto]`` phases at
15,000 nodes) and by ``tests/test_torch_policies.py``::

    stats = policy_stats()
    with engine_scheduler(make_policy_scheduler(stats)), \\
            wake_scoring(stats):
        res_cuda = run_scenario(..., batch=True, batch_backend="cuda")
    stats_np = policy_stats()
    with engine_scheduler(make_policy_scheduler(stats_np, stats["calls"])), \\
            wake_scoring(stats_np):
        res_np = run_scenario(..., batch=True, batch_backend="numpy")
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

TOL = 1e-5      # float32 closeness vs float64; the widest near-tie gap

# the policies of tests/engine_golden_spec.py's ``carbon_autoscale`` cell:
# a diurnal signal over the four regions (period 1800 s, a quarter-period
# phase, regions 112.5 s apart), deferral while the fleet minimum is above
# 300 gCO2/kWh, preemption above 450, a check every 30 s; nodes fall
# asleep after 20 s idle (one always awake), wake on queue pressure, and
# are drained below 30% cpu every 60 s
POLICY_SIGNAL = dict(base=300.0, amplitude=200.0, period_s=1800.0,
                     phase_s=450.0, stagger_s=112.5)


class ParityError(AssertionError):
    pass


def _check(cond, msg):
    if not cond:
        raise ParityError(msg)


def policy_knobs():
    """``(CarbonPolicy, AutoscalePolicy)`` of the ``carbon_autoscale``
    cell."""
    from repro_torch.core.carbon import CarbonPolicy, diurnal_fleet_signal
    from repro_torch.core.elastic import AutoscalePolicy
    carbon = CarbonPolicy(diurnal_fleet_signal(**POLICY_SIGNAL),
                          defer_threshold=300.0, preempt_threshold=450.0,
                          check_interval_s=30.0)
    autoscale = AutoscalePolicy(idle_timeout_s=20.0, min_awake=1,
                                consolidate_interval_s=60.0,
                                consolidate_util_below=0.3)
    return carbon, autoscale


@contextlib.contextmanager
def patched(owner, name, value):
    """``owner.name = value`` for one ``with`` block."""
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def engine_scheduler(cls):
    """Route ``simulate``'s BatchScheduler through ``cls`` for one run."""
    from repro_torch.cluster import engine
    return patched(engine, "BatchScheduler", cls)


def max_err_np(got, want):
    """Largest abs difference over the finite entries of ``want``; the
    shapes, the -inf patterns and finiteness must agree."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    _check(got.shape == want.shape, f"shape {got.shape} vs {want.shape}")
    _check(np.array_equal(np.isneginf(got), np.isneginf(want)),
           "-inf pattern differs")
    fin = np.isfinite(want)
    _check(bool(np.isfinite(got[fin]).all()), "non-finite closeness")
    return float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0


def near_tie_walk(cc_ref, got, pods, table, blocked):
    """Walk the queue with the ledger of the assignment ``got``. At each
    pod, the float64 reference's pick under that same ledger must be
    ``got``'s pick, or a node whose float64 closeness is within TOL of it
    (a near-tie). Returns the number of near-ties and the largest float64
    closeness gap among them."""
    order = np.argsort(-cc_ref, kind="stable", axis=-1)
    free_cpu, free_mem = table.free_cpu.copy(), table.free_mem.copy()
    ties, max_gap = 0, 0.0
    for i, pod in enumerate(pods):
        forbid = blocked[i] if blocked is not None else None
        want = None
        for j in order[i]:
            if np.isneginf(cc_ref[i, j]):
                break
            if forbid is not None and int(j) == forbid:
                continue
            if free_cpu[j] >= pod.cpu - 1e-9 and free_mem[j] >= pod.mem - 1e-9:
                want = int(j)
                break
        pick = got[i]
        if pick != want:
            _check(pick is not None and want is not None,
                   f"pod {pod.uid}: placed {pick}, reference {want}")
            _check(free_cpu[pick] >= pod.cpu - 1e-9
                   and free_mem[pick] >= pod.mem - 1e-9 and pick != forbid,
                   f"pod {pod.uid}: node {pick} does not fit")
            gap = abs(cc_ref[i, want] - cc_ref[i, pick])
            _check(gap <= TOL, f"pod {pod.uid}: node {pick} vs reference "
                   f"{want}, float64 closeness gap {gap} > {TOL}")
            ties += 1
            max_gap = max(max_gap, float(gap))
        if pick is not None:
            free_cpu[pick] -= pod.cpu
            free_mem[pick] -= pod.mem
    return ties, max_gap


def policy_stats():
    """A fresh record for ``make_policy_scheduler`` and ``wake_scoring``."""
    return dict(calls=[], dirty=[], criteria=set(), in_wake=False,
                check_s=0.0)


def make_policy_scheduler(stats, replay=None):
    """A BatchScheduler that records every ``select_many`` call of a policy
    run — an engine round, or a queue-pressure wake's scoring of one pod
    (made inside ``elastic._best_node``, see ``wake_scoring``) — with its
    host time (ending in the copy back and the greedy ledger), its queue,
    its exclude mask's rank, the dirty node columns its cache sync
    consumed, its placements and its closeness.

    ``replay`` (the numpy run) holds the float32 run's calls: call i must
    score the same queue, its closeness must lie within TOL of the
    recorded call's, and where the two place differently every recorded
    pick must be the float64 pick or a near-tie of it under the same
    ledger (``near_tie_walk``). The recorded placements are then returned,
    so the numpy run follows the float32 run's tie-breaks and the two runs
    must end equal. That check's time is kept apart (``check_s``)."""
    from repro_torch.core import scheduler as S

    class PolicyBatchScheduler(S.BatchScheduler):
        def _score_queue_incremental(self, pods, fleet, now, exclude):
            cache = self._cache
            stats["dirty"].append(fleet.modified_since(cache._synced).size)
            stats["criteria"].add(cache.n_criteria)
            return super()._score_queue_incremental(pods, fleet, now,
                                                    exclude)

        def select_many(self, pods, nodes, now=0.0, blocked=None,
                        exclude=None, explain=False):
            t0 = time.perf_counter()
            assign, diag = super().select_many(pods, nodes, now=now,
                                               blocked=blocked,
                                               exclude=exclude)
            i = len(stats["calls"])
            call = dict(wake=stats["in_wake"], pods=len(pods),
                        s=time.perf_counter() - t0,
                        mask=None if exclude is None else np.ndim(exclude),
                        uids=[p.uid for p in pods], assign=assign,
                        cc=diag["closeness"] if replay is None else None,
                        ties=0, gap=0.0, err=0.0, check_s=0.0)
            if replay is not None:
                t1 = time.perf_counter()
                _check(i < len(replay), f"policy call {i}: the numpy run "
                       f"scores more often than the recorded run")
                want = replay[i]
                _check(want["uids"] == call["uids"] and want["wake"]
                       == call["wake"], f"policy call {i}: the numpy run "
                       f"scored another queue than the recorded run")
                call["err"] = max_err_np(want["cc"], diag["closeness"])
                _check(call["err"] <= TOL, f"policy call {i}: recorded vs "
                       f"numpy closeness {call['err']} > {TOL}")
                if want["assign"] != assign:
                    call["ties"], call["gap"] = near_tie_walk(
                        diag["closeness"], want["assign"], pods, nodes,
                        blocked)
                    assign = call["assign"] = want["assign"]
                call["check_s"] = time.perf_counter() - t1
                stats["check_s"] += call["check_s"]
            stats["calls"].append(call)
            return assign, diag

    return PolicyBatchScheduler


@contextlib.contextmanager
def wake_scoring(stats):
    """Flag the ``select_many`` calls of the queue-pressure wake
    (``elastic._best_node``) in ``stats["in_wake"]`` for one block."""
    from repro_torch.core import elastic
    best = elastic._best_node

    def flagged(*args, **kw):
        stats["in_wake"] = True
        try:
            return best(*args, **kw)
        finally:
            stats["in_wake"] = False
    with patched(elastic, "_best_node", flagged):
        yield
