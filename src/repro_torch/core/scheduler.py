"""Schedulers: GreenPod (TOPSIS), its fleet-scale batched variant, and the
default-K8s baseline — port of ``repro.core.scheduler``.

Per-pod schedulers expose ``select(pod, nodes) -> (node_index | None,
diagnostics)`` over a list of ``repro_torch.cluster.node.Node`` (or a
prebuilt ``NodeTable``). ``BatchScheduler.select_many(pods, nodes)`` scores
a whole queue of pods against one fleet snapshot in a single call — the
1000+-node path. The baseline reimplements the upstream kube-scheduler
scoring pipeline the paper compares against: filter (PodFitsResources) →
score (LeastRequestedPriority + BalancedResourceAllocation) → bind to max
score.

Backends (scoring engines, identical semantics — tests assert equivalence):

  numpy — ``topsis.closeness_np``; float64, the semantic reference.
  torch — eager float32 torch ops (``topsis.closeness``) on the
          scheduler's device.
  cuda  — the hand-written kernels through ``repro_torch.kernels.ops``:
          K1 for a per-pod decision, K2 for a full-rebuild round, K3 for
          the incremental round the engine runs, K4 for the weight grid.
          On ``device="cpu"`` the kernels' plain versions run instead.

On an attached fleet the torch and cuda backends of both GreenPod and
the batch scheduler keep a resident (K, N, C_PAD) float32 device mirror of
the criteria cache (``_sync_mirror``): a per-pod decision scores its
kind's (N, C_PAD) row of it in place, a round gathers from it.

``device=None`` means the card (``repro_torch.device.resolve_device``); the
numpy backend ignores the device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import telemetry, topsis
from repro_torch.core.carbon import CarbonSignal
from repro_torch.core.criteria import (benefit_mask, criteria_matrix,
                                       greenpod_criteria, placement_power)
from repro_torch.core.energy import predicted_task_energy_joules
from repro_torch.core.weighting import (CARBON_SCHEMES, adaptive_weights,
                                        scheme_grid, validate_weights,
                                        weights_for)
from repro_torch.cluster.node import FleetState, Node, NodeTable
from repro_torch.cluster.workload import Pod
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

_BENEFIT = benefit_mask()

BACKENDS = ("numpy", "torch", "cuda")

C_PAD = ops.C_PAD


def _resolve_backend(backend: str, device) -> "torch.device | None":
    """Validate ``backend`` and resolve the device it scores on (None for
    numpy, which runs on the host)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"choose from {BACKENDS}")
    return None if backend == "numpy" else resolve_device(device)


def _host(cc: torch.Tensor) -> np.ndarray:
    return cc.cpu().numpy()


def _upload_padded(a: np.ndarray, device) -> torch.Tensor:
    """float64 (..., C) host block -> float32 (..., C_PAD) device tensor,
    zero-padded on the host so the upload is one copy."""
    buf = np.zeros(a.shape[:-1] + (C_PAD,), dtype=np.float32)
    buf[..., :a.shape[-1]] = a
    return torch.from_numpy(buf).to(device)


def predict_exec_time(pod: Pod, node: Node) -> float:
    """Energy-profiling module prediction: runtime scales inversely with the
    node class's per-core speed (requests are guaranteed, no oversubscription
    past the filter)."""
    return pod.workload.base_time_s / node.speed


def predict_energy(pod: Pod, node: Node) -> float:
    awake = node.used_cpu > 1e-9
    return predicted_task_energy_joules(
        node.node_class, predict_exec_time(pod, node), pod.cpu, awake)


def _as_table(nodes) -> NodeTable:
    return nodes if isinstance(nodes, NodeTable) else NodeTable.from_nodes(nodes)


def decision_matrix_table(cpu, mem, base_time_s, table: NodeTable,
                          carbon_intensity=None) -> np.ndarray:
    """(..., N, C) GreenPod decision matrix by broadcasting over the fleet's
    column arrays (criteria.CRITERIA_NAMES order) — no per-node Python loop.

    ``cpu`` / ``mem`` / ``base_time_s`` are scalars for one pod (→ (N, C))
    or ``(P, 1)`` arrays for a queue (→ (P, N, C)). C is 5, or 6 when
    ``carbon_intensity`` (the (N,) gCO2/kWh column for the fleet's regions
    at decision time) is given — the sixth column is the placement's
    emission rate: power draw (dynamic for the request, plus the idle power
    a sleeping node would newly wake) x regional intensity. The arithmetic
    lives in :func:`repro_torch.core.criteria.criteria_matrix` — the same code
    the incremental :class:`FleetCriteriaCache` uses to refresh dirty node
    columns, so the two paths agree bitwise by construction."""
    return criteria_matrix(cpu, mem, base_time_s, table,
                           carbon_intensity=carbon_intensity)


def decision_matrix(pod: Pod, nodes, carbon_intensity=None) -> np.ndarray:
    """(N, C) decision matrix for one pod; ``nodes`` is a Node list or a
    NodeTable."""
    table = _as_table(nodes)
    return decision_matrix_table(pod.cpu, pod.mem, pod.workload.base_time_s,
                                 table, carbon_intensity=carbon_intensity)


def decision_matrix_batch(pods: Sequence[Pod], nodes,
                          carbon_intensity=None) -> np.ndarray:
    """(P, N, C) decision tensor for a queue of pods against one fleet
    snapshot (every pod scored on identical cluster state)."""
    table = _as_table(nodes)
    col = lambda xs: np.asarray(xs, dtype=np.float64)[:, None]
    return decision_matrix_table(col([p.cpu for p in pods]),
                                 col([p.mem for p in pods]),
                                 col([p.workload.base_time_s for p in pods]),
                                 table, carbon_intensity=carbon_intensity)


def _score(mat, weights: np.ndarray, valid: np.ndarray, backend: str,
           benefit: np.ndarray = _BENEFIT, device=None) -> np.ndarray:
    """(N,) closeness for one decision matrix on the given backend
    (invalid rows are -inf). ``mat`` is the host (N, C) float64 matrix for
    numpy; for torch and cuda, a float32 tensor on the device, (N, C) or
    padded to (N, C_PAD) (a row of the resident mirror, read in place)."""
    if backend == "numpy":
        return np.asarray(topsis.closeness_np(mat, weights, benefit,
                                              valid).closeness)
    if backend == "torch":
        m = ops.as_f32(mat, device)[:, :len(benefit)]
        return _host(topsis.closeness(m, ops.as_f32(weights, device),
                                      ops.as_mask(benefit, device),
                                      ops.as_mask(valid, device)).closeness)
    if backend == "cuda":
        return _host(ops.topsis_closeness(mat, weights, benefit, valid=valid,
                                          device=device))
    raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")


def _greedy_assign(cc: np.ndarray, pods: Sequence[Pod], table: NodeTable,
                   blocked=None) -> "list[int | None]":
    """Commit one (P, N) closeness matrix greedily in queue order against a
    fresh capacity ledger: each pod takes its best-ranked node that still
    fits (``blocked[i]`` optionally forbids one node index for ``pods[i]``).
    Extracted from :meth:`BatchScheduler.select_many` so the grid path
    commits every scheme through identical code — the per-scheme ledgers
    are independent what-if placements off the same snapshot."""
    order = np.argsort(-cc, kind="stable", axis=-1)
    free_cpu = table.free_cpu.copy()
    free_mem = table.free_mem.copy()
    assignments: list[int | None] = []
    for i, pod in enumerate(pods):
        forbid = blocked[i] if blocked is not None else None
        chosen = None
        for j in order[i]:
            if np.isneginf(cc[i, j]):
                break           # rest of the ranking is infeasible
            if forbid is not None and int(j) == forbid:
                continue
            if free_cpu[j] >= pod.cpu - 1e-9 \
                    and free_mem[j] >= pod.mem - 1e-9:
                chosen = int(j)
                free_cpu[j] -= pod.cpu
                free_mem[j] -= pod.mem
                break
        assignments.append(chosen)
    return assignments


def _check_carbon_scheme(scheme: str, carbon_signal) -> None:
    if scheme in CARBON_SCHEMES and carbon_signal is None:
        raise ValueError(
            f"scheme {scheme!r} weights the carbon-rate criterion; "
            f"construct the scheduler with a carbon_signal "
            f"(repro_torch.core.carbon.CarbonSignal) to use it")


class FleetCriteriaCache:
    """Incrementally maintained decision-matrix cache over one attached
    :class:`~repro_torch.cluster.node.FleetState`.

    The insight that makes the cache cheap: pods come in a handful of
    workload *kinds* (identical ``(cpu, mem, base_time_s)`` request
    triples), and the criteria arithmetic is elementwise per node — so one
    ``(K, N, C)`` float64 tensor (K = kinds seen so far) covers every pod,
    and a pod's ``(N, C)`` matrix is a zero-copy row view. Per round
    :meth:`sync` consumes the fleet's dirty-column contract
    (``modified_since``): only columns of nodes touched since the last
    sync are recomputed (through ``repro_torch.core.criteria.criteria_matrix``,
    the same code the full-rebuild oracle uses — bitwise agreement by
    construction), and the carbon_rate column is refreshed from the cached
    time-invariant power factor whenever decision time moves.

    Returned matrices/rows are views into the cache: read-only until the
    next :meth:`sync`.
    """

    def __init__(self, fleet: FleetState, carbon_signal: CarbonSignal | None):
        self.fleet = fleet
        self.signal = carbon_signal
        self.n_criteria = 6 if carbon_signal is not None else 5
        self._kinds: dict[tuple, int] = {}    # request triple -> row index
        self._reqs: list[tuple] = []
        n = len(fleet)
        self.mats = np.zeros((0, n, self.n_criteria))
        self._power_w = np.zeros((0, n))      # carbon power factor per kind
        self._synced = fleet.version
        self._carbon_now: float | None = None
        self.intensities: np.ndarray | None = None   # (N,) at _carbon_now

    def _kind_of(self, pod: Pod) -> tuple:
        return (pod.cpu, pod.mem, pod.workload.base_time_s)

    def _full_row(self, req: tuple) -> tuple[np.ndarray, np.ndarray]:
        cpu, mem, bts = req
        mat = np.zeros((len(self.fleet), self.n_criteria))
        mat[:, :5] = criteria_matrix(cpu, mem, bts, self.fleet)
        power = np.zeros(0)
        if self.signal is not None:
            power = placement_power(cpu, self.fleet)
            mat[:, 5] = power * self.intensities
        return mat, power

    def sync(self, pods: Sequence[Pod], now: float):
        """Bring the cache up to date with the fleet and decision time;
        returns ``(kind_idx, dirty, carbon_moved, grew)`` — the per-pod row
        indices, the node indices whose columns were recomputed, whether
        the whole carbon column was refreshed (``now`` moved), and whether
        new kind rows were appended (device mirrors re-upload on growth)."""
        tel = telemetry.active()
        fleet = self.fleet
        dirty = fleet.modified_since(self._synced)
        self._synced = fleet.version
        carbon_moved = False
        if self.signal is not None and now != self._carbon_now:
            self.intensities = np.asarray(
                self.signal.intensities(fleet.region, now), dtype=np.float64)
            self._carbon_now = now
            carbon_moved = True
        if dirty.size and self._reqs:
            col = lambda xs: np.asarray(xs, dtype=np.float64)[:, None]
            cpus, mems, bts = (col([r[j] for r in self._reqs])
                               for j in range(3))
            self.mats[:, dirty, :5] = criteria_matrix(cpus, mems, bts,
                                                      fleet, cols=dirty)
            if self.signal is not None:
                self._power_w[:, dirty] = placement_power(cpus, fleet,
                                                          cols=dirty)
        if self.signal is not None and self._reqs:
            # the carbon column is (time-invariant power) x (intensity at
            # now): refresh all nodes when now moved, else just the dirty
            # subset — elementwise either way, so bitwise-equal to a full
            # rebuild at the same instant
            if carbon_moved:
                self.mats[:, :, 5] = self._power_w * self.intensities
            elif dirty.size:
                self.mats[:, dirty, 5] = (self._power_w[:, dirty]
                                          * self.intensities[dirty])
        grew = False
        new_kinds = 0
        kind_idx = np.empty(len(pods), dtype=np.int64)
        for i, pod in enumerate(pods):
            req = self._kind_of(pod)
            k = self._kinds.get(req)
            if k is None:
                mat, power = self._full_row(req)
                k = len(self._reqs)
                self._kinds[req] = k
                self._reqs.append(req)
                self.mats = np.concatenate([self.mats, mat[None]])
                if self.signal is not None:
                    self._power_w = np.concatenate(
                        [self._power_w, power[None]])
                grew = True
                new_kinds += 1
            kind_idx[i] = k
        tel.inc("cache_syncs")
        if dirty.size:
            tel.inc("cache_dirty_columns", value=float(dirty.size))
        if carbon_moved:
            tel.inc("cache_carbon_refreshes")
        if new_kinds:
            tel.inc("cache_kind_rows_added", value=float(new_kinds))
        return kind_idx, dirty, carbon_moved, grew


def _sync_mirror(mirror: "torch.Tensor | None", cache: FleetCriteriaCache,
                 dirty: np.ndarray, carbon_moved: bool, grew: bool,
                 device) -> torch.Tensor:
    """Mirror one ``cache.sync`` delta onto the resident (K, N, C_PAD)
    float32 device tensor ``mirror`` (None before the first sync), in
    place, and return it. Growth (a kind first seen — at most once per
    workload kind per run) re-uploads the whole tensor; otherwise the dirty
    node columns are written with ``index_copy_``, and the carbon column is
    rewritten only when decision time moved. GreenPod and the batch
    scheduler each keep one."""
    tel = telemetry.active()
    if mirror is None or grew:
        tel.inc("cache_device_reuploads",
                reason="growth" if mirror is not None else "first")
        return _upload_padded(cache.mats, device)
    if dirty.size:
        tel.inc("cache_device_scatters")
        mirror.index_copy_(1, torch.as_tensor(dirty, device=device),
                           _upload_padded(cache.mats[:, dirty, :], device))
    if carbon_moved and cache.signal is not None:
        tel.inc("cache_device_carbon_updates")
        mirror[:, :, cache.n_criteria - 1] = ops.as_f32(cache.mats[:, :, -1],
                                                        device)
    return mirror



class GreenPodScheduler:
    """TOPSIS-based multi-criteria scheduler (paper §III).

    With a ``carbon_signal`` attached the decision matrix gains the sixth
    carbon-rate column (node power x regional grid intensity at ``now``) and
    weight vectors are the 6-criteria form — paper schemes carry a zero
    carbon weight, so their rankings are bitwise unchanged. The default
    backend is numpy, as in the reference (the engine's per-pod path is
    pinned to float64); ``backend="cuda"`` scores through K1."""

    name = "topsis"

    def __init__(self, scheme: str = "energy_centric", adaptive: bool = False,
                 backend: str = "numpy",
                 carbon_signal: CarbonSignal | None = None,
                 explain: bool = False, device=None):
        _check_carbon_scheme(scheme, carbon_signal)
        self.device = _resolve_backend(backend, device)
        self.scheme = scheme
        self.adaptive = adaptive
        self.backend = backend
        self.carbon_signal = carbon_signal
        self.criteria = greenpod_criteria(carbon=carbon_signal is not None)
        self._benefit = benefit_mask(self.criteria)
        self.decision_log: list[dict] = []
        self.explain = explain
        self.explanations: list[dict] = []
        self._cache: FleetCriteriaCache | None = None
        # device-resident (K, N, C_PAD) float32 mirror of the cache
        self._dev: torch.Tensor | None = None

    def attach(self, fleet: FleetState) -> None:
        """Adopt ``fleet`` as a live, delta-maintained snapshot: subsequent
        ``select`` calls that receive this exact object reuse the
        incrementally synced decision-matrix cache instead of rebuilding
        the pod's (N, C) matrix from scratch; on the torch and cuda
        backends the pod's kind row of the resident device mirror is
        scored in place (dirty columns written into it after binds)."""
        self._cache = FleetCriteriaCache(fleet, self.carbon_signal)
        self._dev = None

    def weights(self, nodes) -> np.ndarray:
        carbon = self.carbon_signal is not None
        if not self.adaptive:
            return weights_for(self.scheme, carbon=carbon)
        util = float(np.mean(_as_table(nodes).cpu_util))
        return adaptive_weights(self.scheme, util, carbon=carbon)

    def select(self, pod: Pod, nodes, now: float = 0.0, exclude=None,
               explain: bool = False):
        """Best node for one pod; ``exclude`` optionally masks nodes the
        engine forbids this round (ASLEEP nodes, or WAKING nodes whose
        ready time would start a deferrable pod past its deadline) — they
        are treated exactly like capacity-infeasible nodes. With
        ``explain=True`` (or the scheduler constructed with it) the
        decision's per-criterion attribution (``topsis.explain_np``) is
        appended to ``self.explanations`` and returned in the diagnostics
        — numpy backend only (the torch/cuda engines do not expose the
        weighted intermediates)."""
        explain = explain or self.explain
        if explain and self.backend != "numpy":
            raise ValueError(
                f"explain=True needs backend='numpy', not "
                f"{self.backend!r}: only the numpy path exposes the "
                f"weighted separation terms the attribution decomposes")
        w = None
        with telemetry.active().span("scheduler_decision",
                                     scheduler=self.name,
                                     backend=self.backend) as sp:
            table = _as_table(nodes)
            valid = table.fits(pod.cpu, pod.mem)
            if exclude is not None:
                valid = valid & ~np.asarray(exclude, dtype=bool)
            if not valid.any():
                return None, {"reason": "unschedulable"}
            scored = None
            if self._cache is not None and table is self._cache.fleet:
                kind_idx, dirty, carbon_moved, grew = self._cache.sync(
                    [pod], now)
                mat = self._cache.mats[kind_idx[0]]
                if self.backend != "numpy":
                    self._dev = _sync_mirror(self._dev, self._cache, dirty,
                                             carbon_moved, grew, self.device)
                    scored = self._dev[int(kind_idx[0])]
            else:
                inten = (self.carbon_signal.intensities(table.region, now)
                         if self.carbon_signal is not None else None)
                mat = decision_matrix_table(pod.cpu, pod.mem,
                                            pod.workload.base_time_s, table,
                                            carbon_intensity=inten)
            if scored is None:
                scored = (mat if self.backend == "numpy"
                          else _upload_padded(mat, self.device))
            w = self.weights(table)
            cc = _score(scored, w, valid, self.backend, benefit=self._benefit,
                        device=self.device)
            idx = int(np.argmax(cc))   # first max — same tie-break as a
            #                            stable sort
        dt = sp.duration_s
        diag = {"closeness": cc, "scheduling_time_s": dt, "matrix": mat}
        if explain:
            exp = topsis.explain_np(mat, w, self._benefit, valid,
                                    criteria_names=[c.name
                                                    for c in self.criteria])
            exp.update(pod=pod.uid, t=now, node=table.names[idx],
                       runner_up_node=(table.names[exp["runner_up"]]
                                       if exp["runner_up"] is not None
                                       else None))
            self.explanations.append(exp)
            diag["explanation"] = exp
        self.decision_log.append({"pod": pod.uid, "node": table.names[idx],
                                  "time_s": dt})
        return idx, diag


class BatchScheduler:
    """Fleet-scale batched TOPSIS: one scoring pass per arrival burst.

    ``select_many`` builds the (P, N, C) decision tensor by broadcasting,
    scores every pod against the same fleet snapshot on the configured
    backend, then commits placements greedily in queue order against a
    capacity ledger (each pod takes its best-ranked node that still fits).
    Snapshot scoring is the throughput trade-off vs. the per-pod scheduler's
    rescore-after-every-bind: one kernel launch amortizes over the whole
    queue, which is what wins at 1000+ nodes. Input nodes are never
    mutated — the caller binds from the returned assignments.
    """

    name = "topsis-batch"

    def __init__(self, scheme: str = "energy_centric", adaptive: bool = False,
                 backend: str = "cuda",
                 carbon_signal: CarbonSignal | None = None,
                 explain: bool = False, device=None):
        _check_carbon_scheme(scheme, carbon_signal)
        self.device = _resolve_backend(backend, device)
        self.scheme = scheme
        self.adaptive = adaptive
        self.backend = backend
        self.carbon_signal = carbon_signal
        self.criteria = greenpod_criteria(carbon=carbon_signal is not None)
        self._benefit = benefit_mask(self.criteria)
        self.decision_log: list[dict] = []
        self.explain = explain
        self.explanations: list[dict] = []
        self._cache: FleetCriteriaCache | None = None
        # device-resident (K, N, C_PAD) float32 mirror of the cache
        self._dev: torch.Tensor | None = None

    def attach(self, fleet: FleetState) -> None:
        """Adopt ``fleet`` as a live, delta-maintained snapshot. Scoring
        calls that receive this exact object take the incremental path:
        only dirty node columns are recomputed, and (torch and cuda
        backends) the per-kind criteria tensor stays resident on the
        device across rounds — dirty columns are written into it in place
        and a round is one kernel launch."""
        self._cache = FleetCriteriaCache(fleet, self.carbon_signal)
        self._dev = None

    def weights(self, table: NodeTable) -> np.ndarray:
        carbon = self.carbon_signal is not None
        if not self.adaptive:
            return weights_for(self.scheme, carbon=carbon)
        return adaptive_weights(self.scheme, float(np.mean(table.cpu_util)),
                                carbon=carbon)

    def _valid(self, pods: Sequence[Pod], table: NodeTable,
               exclude) -> np.ndarray:
        """(P, N) feasibility: the pod fits, and the engine did not
        exclude the node."""
        valid = table.fits(np.asarray([p.cpu for p in pods])[:, None],
                           np.asarray([p.mem for p in pods])[:, None])
        if exclude is not None:
            valid = valid & ~np.asarray(exclude, dtype=bool)
        return valid

    def score_queue(self, pods: Sequence[Pod], nodes,
                    now: float = 0.0, exclude=None) -> np.ndarray:
        """(P, N) closeness matrix for the whole queue on one snapshot
        (infeasible nodes are -inf per pod). ``now`` is the decision time
        the carbon column is evaluated at (ignored without a signal).
        ``exclude`` — (N,) or (P, N) bool — masks nodes the engine forbids
        (sleeping nodes; per-pod deadline-late WAKING nodes), folded into
        the validity mask every backend already honors.

        When ``nodes`` is the attached :class:`FleetState` this takes the
        incremental path; any other input scores through the full-rebuild
        path below, which is kept as the reference oracle
        (tests/test_torch_scheduler.py asserts the two agree)."""
        table = _as_table(nodes)
        if self._cache is not None and table is self._cache.fleet:
            telemetry.active().inc("scheduler_score_queue",
                                   path="incremental")
            return self._score_queue_incremental(pods, table, now, exclude)
        telemetry.active().inc("scheduler_score_queue", path="rebuild")
        inten = (self.carbon_signal.intensities(table.region, now)
                 if self.carbon_signal is not None else None)
        mats = decision_matrix_batch(pods, table, carbon_intensity=inten)
        valid = self._valid(pods, table, exclude)
        w = self.weights(table)
        ws = np.broadcast_to(w, (len(pods), w.shape[0]))
        if self.backend == "numpy":
            return topsis.batched_closeness_np(mats, ws, self._benefit, valid)
        dev = self.device
        if self.backend == "torch":
            return _host(topsis.batched_closeness(
                ops.as_f32(mats, dev), ops.as_f32(ws, dev),
                ops.as_mask(self._benefit, dev),
                ops.as_mask(valid, dev)).closeness)
        return _host(ops.topsis_closeness_batched(
            mats, ws, self._benefit, valid=valid, device=dev))

    def _score_queue_incremental(self, pods: Sequence[Pod],
                                 fleet: FleetState, now: float,
                                 exclude) -> np.ndarray:
        """The one-launch round over the attached fleet: sync the per-kind
        criteria cache (dirty columns only), then score every pod as a row
        gather — numpy reads zero-copy views, torch gathers from the
        device-resident mirror, cuda streams kind rows through K3."""
        cache = self._cache
        kind_idx, dirty, carbon_moved, grew = cache.sync(pods, now)
        valid = self._valid(pods, fleet, exclude)
        w = self.weights(fleet)
        ws = np.broadcast_to(w, (len(pods), w.shape[0]))
        if self.backend == "numpy":
            return np.stack([
                np.asarray(topsis.closeness_np(cache.mats[k], ws[i],
                                               self._benefit,
                                               valid[i]).closeness)
                for i, k in enumerate(kind_idx)])
        self._dev = _sync_mirror(self._dev, cache, dirty, carbon_moved, grew,
                                 self.device)
        dev = self.device
        telemetry.active().inc("cache_fused_dispatches", backend=self.backend)
        if self.backend == "torch":
            mats = self._dev[torch.as_tensor(kind_idx, device=dev)]
            return _host(topsis.batched_closeness(
                mats[..., :cache.n_criteria], ops.as_f32(ws, dev),
                ops.as_mask(self._benefit, dev),
                ops.as_mask(valid, dev)).closeness)
        return _host(ops.topsis_closeness_kinds(
            self._dev, kind_idx, ws, self._benefit, valid=valid, device=dev))

    def _weight_grid(self, schemes) -> np.ndarray:
        """Resolve ``schemes`` — a sequence of scheme names or an (S, C)
        array of weight vectors — into a validated (S, C) float64 grid
        matching this scheduler's criteria count. Name rows go through
        :func:`weights_for` (so the paper schemes stay bitwise identical to
        the scalar path); raw vectors must pass
        :func:`repro_torch.core.weighting.validate_weights`, and 5-weight rows
        are padded with a zero carbon weight when a signal is attached —
        the same inert extension the named schemes get."""
        carbon = self.carbon_signal is not None
        seq = list(schemes) if not isinstance(schemes, np.ndarray) else None
        if seq is not None and seq and all(isinstance(s, str) for s in seq):
            for s in seq:
                _check_carbon_scheme(s, self.carbon_signal)
            return scheme_grid(tuple(seq), carbon=carbon)
        ws = validate_weights(np.atleast_2d(np.asarray(schemes,
                                                      dtype=np.float64)),
                              name="schemes")
        c = len(self._benefit)
        if ws.shape[-1] == 5 and c == 6:
            ws = np.concatenate([ws, np.zeros((ws.shape[0], 1))], axis=-1)
        if ws.shape[-1] != c:
            raise ValueError(
                f"scheme grid has {ws.shape[-1]} weights but this "
                f"scheduler scores {c} criteria "
                f"({'with' if carbon else 'without'} a carbon signal)")
        return ws

    def score_queue_grid(self, pods: Sequence[Pod], nodes, schemes,
                         now: float = 0.0, exclude=None) -> np.ndarray:
        """(S, P, N) closeness tensor: the whole queue scored under every
        weighting scheme in ONE pass (the Pareto-sweep path). ``schemes``
        is a list of scheme names or an (S, C) weight grid
        (:meth:`_weight_grid`); row ``s`` equals what :meth:`score_queue`
        returns with ``ws[s]`` as the scheme. ``now`` / ``exclude`` behave
        exactly as in :meth:`score_queue`; the feasibility mask is
        scheme-independent and shared.

        When ``nodes`` is the attached :class:`FleetState` this takes the
        incremental path — dirty-column sync plus one K4 launch (cuda) on
        the rows gathered from the device-resident kind tensor, with no
        re-upload per scheme."""
        table = _as_table(nodes)
        ws = self._weight_grid(schemes)
        if self._cache is not None and table is self._cache.fleet:
            telemetry.active().inc("scheduler_score_grid",
                                   path="incremental")
            return self._score_grid_incremental(pods, table, ws, now,
                                                exclude)
        telemetry.active().inc("scheduler_score_grid", path="rebuild")
        inten = (self.carbon_signal.intensities(table.region, now)
                 if self.carbon_signal is not None else None)
        mats = decision_matrix_batch(pods, table, carbon_intensity=inten)
        valid = self._valid(pods, table, exclude)
        if self.backend == "numpy":
            return topsis.closeness_grid_np(mats, ws, self._benefit, valid)
        dev = self.device
        if self.backend == "torch":
            return _host(topsis.closeness_grid(
                ops.as_f32(mats, dev), ops.as_f32(ws, dev),
                ops.as_mask(self._benefit, dev), ops.as_mask(valid, dev)))
        return _host(ops.topsis_closeness_grid(
            mats, ws, self._benefit, valid=valid, device=dev))

    def _score_grid_incremental(self, pods: Sequence[Pod],
                                fleet: FleetState, ws: np.ndarray,
                                now: float, exclude) -> np.ndarray:
        """Grid round over the attached fleet: one dirty-column sync, then
        the per-backend (S, P, N) scoring — numpy loops scheme x pod over
        the zero-copy cache views (the reference), torch and cuda gather
        the queue's rows from the device mirror and score them in one
        pass (cuda: K4)."""
        cache = self._cache
        kind_idx, dirty, carbon_moved, grew = cache.sync(pods, now)
        valid = self._valid(pods, fleet, exclude)
        if self.backend == "numpy":
            return np.stack([
                np.stack([
                    np.asarray(topsis.closeness_np(cache.mats[k], w,
                                                   self._benefit,
                                                   valid[i]).closeness)
                    for i, k in enumerate(kind_idx)])
                for w in ws])
        self._dev = _sync_mirror(self._dev, cache, dirty, carbon_moved, grew,
                                 self.device)
        dev = self.device
        telemetry.active().inc("cache_fused_dispatches", backend=self.backend)
        mats = self._dev[torch.as_tensor(kind_idx, device=dev)]
        if self.backend == "torch":
            return _host(topsis.closeness_grid(
                mats[..., :cache.n_criteria], ops.as_f32(ws, dev),
                ops.as_mask(self._benefit, dev), ops.as_mask(valid, dev)))
        return _host(ops.topsis_closeness_grid(
            mats, ws, self._benefit, valid=valid, device=dev))

    def select_many_grid(self, pods: Sequence[Pod], nodes, schemes,
                         now: float = 0.0, exclude=None):
        """What-if placement of one queue under every scheme: returns
        ``(assignments, diagnostics)`` where ``assignments[s][i]`` is the
        node index pods[i] would take under scheme ``s`` (or None). One
        fused :meth:`score_queue_grid` dispatch scores all schemes; each
        scheme's greedy capacity-ledger walk then starts from the SAME
        fresh snapshot (``_greedy_assign``) — the per-scheme placements are
        independent hypotheticals, identical to running
        :meth:`select_many` once per scheme, which is what the frontier
        layer compares. Input nodes are never mutated."""
        with telemetry.active().span("scheduler_grid",
                                     scheduler=self.name,
                                     backend=self.backend) as sp:
            table = _as_table(nodes)
            n_s = len(schemes)
            if not len(pods):
                return ([[] for _ in range(n_s)],
                        {"closeness": np.zeros((n_s, 0, len(table))),
                         "scheduling_time_s": 0.0, "per_scheme_time_s": 0.0})
            cc = self.score_queue_grid(pods, table, schemes, now=now,
                                       exclude=exclude)
            assignments = [_greedy_assign(cc[s], pods, table)
                           for s in range(cc.shape[0])]
        dt = sp.duration_s
        return assignments, {"closeness": cc, "scheduling_time_s": dt,
                             "per_scheme_time_s": dt / cc.shape[0]}

    def _explain_batch(self, pods, table, now, exclude, assignments) -> None:
        """Per-pod attribution for one batch round (numpy path): rebuild
        each pod's (N, C) matrix and validity exactly as ``score_queue``
        saw them and decompose winner vs runner-up. ``node`` records the
        greedy ledger's actual commit — it can differ from the scoring
        ``winner`` when an earlier pod took the capacity."""
        names = [c.name for c in self.criteria]
        if self._cache is not None and table is self._cache.fleet:
            # fleet untouched since the scoring sync -> dirty is empty and
            # these are the same cache rows score_queue just read
            kind_idx, _, _, _ = self._cache.sync(pods, now)
            mats = [self._cache.mats[k] for k in kind_idx]
        else:
            inten = (self.carbon_signal.intensities(table.region, now)
                     if self.carbon_signal is not None else None)
            mats = decision_matrix_batch(pods, table, carbon_intensity=inten)
        valid = self._valid(pods, table, exclude)
        w = self.weights(table)
        for i, (pod, idx) in enumerate(zip(pods, assignments)):
            exp = topsis.explain_np(mats[i], w, self._benefit, valid[i],
                                    criteria_names=names)
            exp.update(pod=pod.uid, t=now,
                       node=table.names[idx] if idx is not None else None,
                       runner_up_node=(table.names[exp["runner_up"]]
                                       if exp["runner_up"] is not None
                                       else None))
            self.explanations.append(exp)

    def select_many(self, pods: Sequence[Pod], nodes, now: float = 0.0,
                    blocked: "Sequence[int | None] | None" = None,
                    exclude=None, explain: bool = False):
        """Place a queue: returns (assignments, diagnostics) where
        ``assignments[i]`` is the node index for ``pods[i]`` or None.
        ``blocked[i]`` optionally names one node index ``pods[i]`` must not
        take this pass (a node it was just preempted off) — skipped inside
        the greedy ledger walk, so a blocked top choice falls through to
        the next-ranked node without phantom capacity charges. ``exclude``
        ((N,) or (P, N) bool) hard-masks nodes out of the scoring validity
        instead (sleeping / deadline-late nodes, see :meth:`score_queue`).
        ``explain=True`` (numpy backend only, like
        :meth:`GreenPodScheduler.select`) appends a per-criterion
        attribution per placed pod to ``self.explanations``."""
        explain = explain or self.explain
        if explain and self.backend != "numpy":
            raise ValueError(
                f"explain=True needs backend='numpy', not "
                f"{self.backend!r}: only the numpy path exposes the "
                f"weighted separation terms the attribution decomposes")
        with telemetry.active().span("scheduler_batch",
                                     scheduler=self.name,
                                     backend=self.backend) as sp:
            table = _as_table(nodes)
            if not len(pods):
                return [], {"closeness": np.zeros((0, len(table))),
                            "scheduling_time_s": 0.0, "per_pod_time_s": 0.0}
            cc = self.score_queue(pods, table, now=now, exclude=exclude)
            assignments = _greedy_assign(cc, pods, table, blocked=blocked)
        dt = sp.duration_s
        per_pod = dt / len(pods)
        if explain:
            self._explain_batch(pods, table, now, exclude, assignments)
        for pod, idx in zip(pods, assignments):
            self.decision_log.append(
                {"pod": pod.uid,
                 "node": table.names[idx] if idx is not None else None,
                 "time_s": per_pod})
        return assignments, {"closeness": cc, "scheduling_time_s": dt,
                             "per_pod_time_s": per_pod}


class DefaultK8sScheduler:
    """Upstream kube-scheduler default scoring (the paper's baseline).

    LeastRequestedPriority: ((capacity - requested) / capacity) * 100,
    averaged over cpu and memory.
    BalancedResourceAllocation: 100 - |cpu_fraction - mem_fraction| * 100.
    Total = mean of the two plugins (equal default plugin weights).
    """

    name = "default"

    def __init__(self):
        self.decision_log: list[dict] = []

    def select(self, pod: Pod, nodes, now: float = 0.0, exclude=None):
        """Vectorized over ``NodeTable`` columns (``nodes`` may be a Node
        list or a prebuilt table): one broadcast pass scores the whole
        fleet, infeasible nodes score -1. Identical plugin arithmetic to
        the upstream per-node loop; ties resolve to the lowest node index
        (the loop's running-max-with-epsilon tie-break, which only diverges
        for score gaps below 1e-12 — see tests/test_scheduler.py pinning).
        ``now`` is accepted for engine-call symmetry and ignored — the
        baseline is carbon-blind. ``exclude`` masks engine-forbidden nodes
        (sleeping capacity) exactly like capacity infeasibility."""
        with telemetry.active().span("scheduler_decision",
                                     scheduler=self.name,
                                     backend="numpy") as sp:
            table = _as_table(nodes)
            fits = table.fits(pod.cpu, pod.mem)
            if exclude is not None:
                fits = fits & ~np.asarray(exclude, dtype=bool)
            if not fits.any():
                return None, {"reason": "unschedulable"}
            cpu_frac = (table.reserved_cpu + table.used_cpu
                        + pod.cpu) / table.vcpus
            mem_frac = (table.reserved_mem + table.used_mem
                        + pod.mem) / table.mem_gb
            least = 100.0 * ((1.0 - cpu_frac) + (1.0 - mem_frac)) / 2.0
            balanced = 100.0 * (1.0 - np.abs(cpu_frac - mem_frac))
            scores = np.where(fits, (least + balanced) / 2.0, -1.0)
            best = int(np.argmax(scores))
        dt = sp.duration_s
        self.decision_log.append({"pod": pod.uid, "node": table.names[best],
                                  "time_s": dt})
        return best, {"scores": scores, "scheduling_time_s": dt}
