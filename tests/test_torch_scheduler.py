"""The port's schedulers (``repro_torch.core.scheduler``) against the
reference ``repro.core.scheduler`` on identical fleets.

Fleets are built and mutated in the reference, then carried into the port
through ``repro_torch.convert`` from the reference ``NodeTable`` columns;
pods through their plain records. Tolerances: numpy paths bitwise (the
same float64 arithmetic); the float32 torch and cuda paths within 1e-5 of
the reference numpy scores, with the identical -inf pattern and the same
placements. ``torch`` and ``cuda`` run with ``device="cpu"`` here (cuda:
the kernels' plain versions behind the real wrappers).
"""
import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.cluster import node as R_node
from repro.cluster.workload import WORKLOADS as R_WORKLOADS
from repro.cluster.workload import Pod as R_Pod
from repro.core import carbon as R_carbon
from repro.core import elastic as R_elastic
from repro.core import scheduler as R
from repro_torch import convert
from repro_torch.cluster.node import FleetState, NodeTable
from repro_torch.core import carbon as P_carbon
from repro_torch.core import scheduler as P
from repro_torch.kernels import topsis_cuda

PORT_BACKENDS = ("numpy", "torch", "cuda")
ATOL = 1e-5


# --- carrying state across ---------------------------------------------------
def to_port(table) -> FleetState:
    return convert.fleet_from_columns(
        {k: getattr(table, k) for k in convert.NODE_COLUMNS})


def to_port_pods(pods):
    return convert.pods_from_records(
        (p.uid, p.workload.kind, p.cpu, p.mem, p.workload.base_time_s,
         p.scheduler, p.deferrable, p.deadline_s) for p in pods)


def ref_queue(p, seed=0):
    rng = np.random.default_rng(seed)
    kinds = list(R_WORKLOADS)
    return [R_Pod(i, R_WORKLOADS[kinds[int(rng.integers(len(kinds)))]],
                  "topsis") for i in range(p)]


def churn(fs, rng, steps=40):
    """Random bind/release/sleep/wake word against a reference or port
    FleetState (the mutators the engine drives), kept physically valid."""
    bound = []
    n = len(fs)
    for _ in range(steps):
        op = rng.integers(4)
        i = int(rng.integers(n))
        if op == 0:
            cpu, mem = 0.25 * (1 + rng.integers(8)), 0.5 * (1 + rng.integers(4))
            if fs.free_cpu[i] >= cpu and fs.free_mem[i] >= mem:
                fs.bind(i, cpu, mem)
                bound.append((i, cpu, mem))
        elif op == 1 and bound:
            fs.release(*bound.pop(int(rng.integers(len(bound)))))
        elif op in (2, 3):
            states = list(fs.power_state)
            states[i] = R_elastic.ASLEEP if op == 2 else R_elastic.IDLE
            fs.set_power_states(states)


def ref_fleet(n=40, seed=0, util=0.3, churn_seed=None):
    fs = R_node.FleetState.from_nodes(
        R_node.make_fleet_nodes(n, seed=seed, utilization=util))
    if churn_seed is not None:
        churn(fs, np.random.default_rng(churn_seed))
    return fs


def same_scores(got, want, bitwise):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    if bitwise:
        assert np.array_equal(got, want)
        return
    finite = np.isfinite(want)
    assert np.isfinite(got[finite]).all()
    np.testing.assert_allclose(got[finite], want[finite], atol=ATOL, rtol=0)


@pytest.mark.parametrize("churn_seed", [None, 1, 2])
def test_fleet_columns_carry_across_bitwise(churn_seed):
    ref = ref_fleet(churn_seed=churn_seed)
    port = to_port(ref)
    for k in ("vcpus", "mem_gb", "reserved_cpu", "reserved_mem", "used_cpu",
              "used_mem", "speed", "dyn_power_per_vcpu", "idle_power",
              "free_cpu", "free_mem", "cpu_util", "awake"):
        assert np.array_equal(getattr(port, k), getattr(ref, k)), k
    assert port.names == ref.names and port.region == ref.region
    assert list(port.power_state) == list(ref.power_state)
    assert [n.name for n in port.nodes] == ref.names
    assert np.array_equal(port.fits(0.5, 1.0), ref.fits(0.5, 1.0))


def test_convert_rejects_inconsistent_profiles():
    cols = {k: getattr(ref_fleet(8), k) for k in convert.NODE_COLUMNS}
    cols["speed"] = cols["speed"] + 1.0
    with pytest.raises(ValueError, match="speed"):
        convert.fleet_from_columns(cols)


def test_pods_carry_across():
    pods = ref_queue(9, seed=3)
    port = to_port_pods(pods)
    assert [(p.uid, p.cpu, p.mem, p.workload.base_time_s, p.scheduler)
            for p in port] == [(p.uid, p.cpu, p.mem, p.workload.base_time_s,
                                p.scheduler) for p in pods]
    odd = convert.pods_from_records([(5, "light", 0.3, 0.5, 12.0, "topsis",
                                      True, 60.0)])[0]
    assert odd.cpu == 0.3 and odd.deferrable and odd.deadline_s == 60.0


# --- per-pod schedulers ---------------------------------------------------------
@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("carbon", [False, True])
def test_greenpod_select_matches_reference(backend, carbon):
    ref = ref_fleet(churn_seed=4)
    port = to_port(ref)
    r_sig = R_carbon.diurnal_fleet_signal(period_s=3600.0) if carbon else None
    p_sig = P_carbon.diurnal_fleet_signal(period_s=3600.0) if carbon else None
    r_s = R.GreenPodScheduler("energy_centric", carbon_signal=r_sig)
    p_s = P.GreenPodScheduler("energy_centric", backend=backend,
                              carbon_signal=p_sig, device="cpu")
    p_att = P.GreenPodScheduler("energy_centric", backend=backend,
                                carbon_signal=p_sig, device="cpu")
    p_att.attach(port)
    for rp, pp in zip(ref_queue(6, seed=1), to_port_pods(ref_queue(6, 1))):
        idx_r, d_r = r_s.select(rp, ref, now=917.0)
        idx_p, d_p = p_s.select(pp, port, now=917.0)
        idx_a, d_a = p_att.select(pp, port, now=917.0)
        assert idx_p == idx_r == idx_a
        same_scores(d_p["closeness"], d_r["closeness"], backend == "numpy")
        same_scores(d_a["closeness"], d_r["closeness"], backend == "numpy")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("carbon", [False, True])
def test_attached_greenpod_matches_reference_through_binds(backend, carbon):
    """The per-pod path on the resident mirror: an attached port scheduler
    against the reference's (float64 numpy) one, decision after decision,
    each bound on both fleets before the next — so every decision scores a
    row with freshly written dirty columns — and, with a carbon signal,
    ``now`` moving so the carbon column is rewritten. Same picks, scores
    within 1e-5."""
    ref = ref_fleet(48, seed=5, util=0.2)
    port = to_port(ref)
    r_sig = R_carbon.diurnal_fleet_signal(period_s=3600.0) if carbon else None
    p_sig = P_carbon.diurnal_fleet_signal(period_s=3600.0) if carbon else None
    r_s = R.GreenPodScheduler("energy_centric", carbon_signal=r_sig)
    p_s = P.GreenPodScheduler("energy_centric", backend=backend,
                              carbon_signal=p_sig, device="cpu")
    p_s.attach(port)
    times = (0.0, 0.0, 450.0, 450.0, 1200.0, 1900.0, 1900.0, 2600.0)
    for now, rp, pp in zip(times, ref_queue(8, seed=12),
                           to_port_pods(ref_queue(8, seed=12))):
        idx_r, d_r = r_s.select(rp, ref, now=now)
        idx_p, d_p = p_s.select(pp, port, now=now)
        assert idx_p == idx_r
        same_scores(d_p["closeness"], d_r["closeness"], False)
        ref.bind(idx_r, rp.cpu, rp.mem)
        port.bind(idx_p, pp.cpu, pp.mem)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_greenpod_mirror_writes_only_dirty_columns_in_place(backend):
    """After a bind, the per-pod path writes the bound node's column into
    the same mirror storage and leaves every other column alone (a value
    planted in a clean column survives the next decision)."""
    fs = to_port(ref_fleet(16, seed=1))
    s = P.GreenPodScheduler("energy_centric", backend=backend, device="cpu")
    s.attach(fs)
    pod = to_port_pods(ref_queue(1))[0]
    s.select(pod, fs)
    mirror = s._dev
    assert mirror.shape == (1, 16, P.C_PAD) and mirror.dtype == torch.float32
    assert torch.all(mirror[..., 5:] == 0)
    mirror[0, 9, 0] = 1234.5                 # a clean column, planted
    fs.bind(3, 0.5, 1.0)
    s.select(pod, fs)
    assert s._dev is mirror
    np.testing.assert_array_equal(mirror[0, 3, :5].numpy(),
                                  s._cache.mats[0, 3, :].astype(np.float32))
    assert float(mirror[0, 9, 0]) == 1234.5


def test_cpu_greenpod_launches_no_kernel():
    before = dict(topsis_cuda.LAUNCHES)
    fs = to_port(ref_fleet(16))
    s = P.GreenPodScheduler("energy_centric", backend="cuda", device="cpu")
    s.attach(fs)
    for pod in to_port_pods(ref_queue(3)):
        idx, _ = s.select(pod, fs)
        fs.bind(idx, pod.cpu, pod.mem)
    P.GreenPodScheduler("energy_centric", backend="cuda",
                        device="cpu").select(pod, fs)
    assert topsis_cuda.LAUNCHES == before


def test_greenpod_explain_matches_reference():
    ref = ref_fleet(churn_seed=5)
    port = to_port(ref)
    rp, pp = ref_queue(1)[0], to_port_pods(ref_queue(1))[0]
    _, d_r = R.GreenPodScheduler(explain=True).select(rp, ref, now=1.0)
    _, d_p = P.GreenPodScheduler(explain=True).select(pp, port, now=1.0)
    assert d_p["explanation"] == d_r["explanation"]
    with pytest.raises(ValueError, match="explain=True needs"):
        P.GreenPodScheduler(backend="torch", device="cpu").select(
            pp, port, explain=True)


@pytest.mark.parametrize("churn_seed", [None, 6])
def test_default_k8s_matches_reference(churn_seed):
    ref = ref_fleet(churn_seed=churn_seed)
    port = to_port(ref)
    exclude = np.zeros(len(ref), bool)
    exclude[::5] = True
    for rp, pp in zip(ref_queue(5, 2), to_port_pods(ref_queue(5, 2))):
        for ex in (None, exclude):
            idx_r, d_r = R.DefaultK8sScheduler().select(rp, ref, exclude=ex)
            idx_p, d_p = P.DefaultK8sScheduler().select(pp, port, exclude=ex)
            assert idx_p == idx_r
            assert np.array_equal(d_p["scores"], d_r["scores"])


def test_greedy_assign_matches_reference():
    ref = ref_fleet(churn_seed=7)
    port = to_port(ref)
    rng = np.random.default_rng(0)
    cc = rng.random((6, len(ref)))
    cc[rng.random(cc.shape) < 0.3] = -np.inf
    cc[:, 3] = cc[:, 4]                     # exact ties break by index
    blocked = [None, 3, None, 0, None, 4]
    for b in (None, blocked):
        assert P._greedy_assign(cc, to_port_pods(ref_queue(6)), port, b) \
            == R._greedy_assign(cc, ref_queue(6), ref, b)


# --- batch scheduler: rebuild, incremental and grid paths -------------------
def _ref_batch(backend="numpy", **kw):
    return R.BatchScheduler("energy_centric", backend=backend, **kw)


def _port_batch(backend, **kw):
    return P.BatchScheduler("energy_centric", backend=backend, device="cpu",
                            **kw)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_batch_rebuild_matches_reference(backend):
    ref = ref_fleet(churn_seed=8)
    snap_r = R_node.NodeTable.from_nodes(ref.nodes)
    snap_p = NodeTable.from_nodes(to_port(ref).nodes)
    pods_r, pods_p = ref_queue(7, 3), to_port_pods(ref_queue(7, 3))
    exclude = np.zeros(len(ref), bool)
    exclude[1::4] = True
    blocked = [None, 2, None, None, 5, None, None]
    a_r, d_r = _ref_batch().select_many(pods_r, snap_r, exclude=exclude,
                                        blocked=blocked)
    a_p, d_p = _port_batch(backend).select_many(pods_p, snap_p,
                                                exclude=exclude,
                                                blocked=blocked)
    assert a_p == a_r
    same_scores(d_p["closeness"], d_r["closeness"], backend == "numpy")


@pytest.mark.parametrize("attached", [False, True])
def test_batch_explain_matches_reference(attached):
    ref = ref_fleet(churn_seed=11)
    port = to_port(ref)
    r_s, p_s = _ref_batch(explain=True), _port_batch("numpy", explain=True)
    if attached:
        r_s.attach(ref)
        p_s.attach(port)
    nodes_r = ref if attached else R_node.NodeTable.from_nodes(ref.nodes)
    nodes_p = port if attached else NodeTable.from_nodes(port.nodes)
    r_s.select_many(ref_queue(4, 6), nodes_r, now=3.0)
    p_s.select_many(to_port_pods(ref_queue(4, 6)), nodes_p, now=3.0)
    assert p_s.explanations == r_s.explanations
    with pytest.raises(ValueError, match="explain=True needs"):
        _port_batch("cuda").select_many(to_port_pods(ref_queue(2)), nodes_p,
                                        explain=True)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("carbon", [False, True])
def test_batch_incremental_matches_reference(backend, carbon):
    """Attached schedulers in both packages, driven through the same
    mutation word in lockstep: every round's scores and placements match
    the reference numpy round."""
    ref = ref_fleet(seed=2)
    port = to_port(ref)
    r_sig = R_carbon.diurnal_fleet_signal(period_s=1800.0) if carbon else None
    p_sig = P_carbon.diurnal_fleet_signal(period_s=1800.0) if carbon else None
    r_s = _ref_batch(carbon_signal=r_sig)
    p_s = _port_batch(backend, carbon_signal=p_sig)
    r_s.attach(ref)
    p_s.attach(port)
    pods_r, pods_p = ref_queue(6, 4), to_port_pods(ref_queue(6, 4))
    for rnd, now in enumerate((0.0, 0.0, 311.0, 977.5)):
        churn(ref, np.random.default_rng(rnd), steps=15)
        churn(port, np.random.default_rng(rnd), steps=15)
        a_r, d_r = r_s.select_many(pods_r, ref, now=now)
        a_p, d_p = p_s.select_many(pods_p, port, now=now)
        assert a_p == a_r
        same_scores(d_p["closeness"], d_r["closeness"], backend == "numpy")


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("attached", [False, True])
def test_batch_grid_matches_reference(backend, attached):
    ref = ref_fleet(seed=3, churn_seed=9)
    port = to_port(ref)
    pods_r, pods_p = ref_queue(5, 5), to_port_pods(ref_queue(5, 5))
    ws = np.random.default_rng(0).dirichlet(np.ones(5), 4)
    r_s, p_s = _ref_batch(), _port_batch(backend)
    if attached:
        r_s.attach(ref)
        p_s.attach(port)
    nodes_r = ref if attached else R_node.NodeTable.from_nodes(ref.nodes)
    nodes_p = port if attached else NodeTable.from_nodes(port.nodes)
    for schemes in (ws, ["general", "energy_centric", "resource_efficient"]):
        a_r, d_r = r_s.select_many_grid(pods_r, nodes_r, schemes)
        a_p, d_p = p_s.select_many_grid(pods_p, nodes_p, schemes)
        assert a_p == a_r
        same_scores(d_p["closeness"], d_r["closeness"], backend == "numpy")


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_incremental_matches_rebuild_after_churn(backend):
    """The port's own oracle check (as tests/test_fleet_state.py does for
    the reference): attached vs a detached scheduler on a fresh rebuild,
    after random bind/release/power-state words — bitwise on numpy, 1e-5
    on the float32 backends."""
    for seed in range(3):
        fs = to_port(ref_fleet(24, seed=seed))
        inc = _port_batch(backend)
        inc.attach(fs)
        oracle = _port_batch(backend)
        pods = to_port_pods(ref_queue(6, seed))
        rng = np.random.default_rng(seed + 10)
        for _ in range(4):
            churn(fs, rng, steps=12)
            cc_inc = inc.score_queue(pods, fs)
            cc_ref = oracle.score_queue(pods, NodeTable.from_nodes(fs.nodes))
            same_scores(cc_inc, cc_ref, backend == "numpy")


def test_device_mirror_is_padded_and_written_in_place():
    fs = to_port(ref_fleet(16, seed=1))
    s = _port_batch("cuda")
    s.attach(fs)
    pods = to_port_pods(ref_queue(4))
    s.score_queue(pods, fs)
    mirror = s._dev
    assert mirror.shape == (len(s._cache._reqs), 16, P.C_PAD)
    assert mirror.dtype == torch.float32
    assert torch.all(mirror[..., 5:] == 0)
    fs.bind(3, 0.5, 1.0)
    s.score_queue(pods, fs)
    assert s._dev is mirror                  # same storage, column 3 updated
    np.testing.assert_array_equal(mirror[:, 3, :5].numpy(),
                                  s._cache.mats[:, 3, :].astype(np.float32))


def test_cpu_scheduling_launches_no_kernel():
    before = dict(topsis_cuda.LAUNCHES)
    fs = to_port(ref_fleet(16))
    s = _port_batch("cuda")
    s.attach(fs)
    s.select_many(to_port_pods(ref_queue(3)), fs)
    assert topsis_cuda.LAUNCHES == before


# --- devices and backends -----------------------------------------------------
@pytest.mark.parametrize("make", [
    lambda: P.BatchScheduler(),
    lambda: P.BatchScheduler(backend="torch"),
    lambda: P.GreenPodScheduler(backend="cuda"),
], ids=["batch-default", "batch-torch", "greenpod-cuda"])
def test_device_none_means_the_card(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_numpy_backend_needs_no_device():
    assert P.GreenPodScheduler().device is None
    assert P.BatchScheduler(backend="numpy").device is None


def test_unknown_backend_names_the_choices():
    with pytest.raises(ValueError, match="choose from"):
        P.BatchScheduler(backend="pallas", device="cpu")
