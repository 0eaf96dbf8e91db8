"""The port's frontier layer (``repro_torch.core.pareto``) against the live
reference ``repro.core.pareto``, in-process.

The grid functions, the dominance filter and the frontier containers are
copies, so they are held bitwise. ``placement_metrics`` scores the grid
on each port backend (numpy, torch, cuda; the last two on the CPU here,
cuda through the kernels' plain versions): its frontier's size and
checksum (benchmarks/pareto_sweep.py's fingerprint) must equal the
reference numpy and jax runs' in the benchmark's ``--smoke`` cell (N = 8,
S = 4, 4 pods) and at N = 64, S = 64, with and without a carbon signal;
the numpy backend's metrics must equal the reference numpy's exactly.
``scenario_metrics`` runs the four paper schemes through the engine on
the 8-node golden fleet; ``FrontierAtlas.to_report()`` must be equal.
"""
import itertools

import jax  # noqa: F401
import numpy as np
import pytest
import torch

import engine_golden_spec as spec
from repro.cluster import node as R_node
from repro.cluster import workload as R_workload
from repro.core import carbon as R_carbon
from repro.core import pareto as R
from repro_torch.cluster import node as P_node
from repro_torch.cluster import workload as P_workload
from repro_torch.core import carbon as P_carbon
from repro_torch.core import pareto as P
from test_torch_engine import port_policies

PAPER_SCHEMES = ("general", "energy_centric", "performance_centric",
                 "resource_efficient")


def _message(fn, exc=ValueError):
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


# --- grids and the dominance filter ------------------------------------------
@pytest.mark.parametrize("n,criteria", [(1, 5), (2, 5), (4, 5), (3, 6),
                                        (5, 6)])
def test_weight_grid_matches_reference(n, criteria):
    got, want = P.weight_grid(n, criteria), R.weight_grid(n, criteria)
    np.testing.assert_array_equal(got, want)
    assert P.grid_size(n, criteria) == R.grid_size(n, criteria) == len(got)


@pytest.mark.parametrize("schemes,criteria", [(1, 5), (5, 5), (64, 5),
                                              (64, 6), (513, 6)])
def test_weight_grid_upto_and_lattice_degree_match_reference(schemes,
                                                             criteria):
    assert (P.lattice_n_for(schemes, criteria)
            == R.lattice_n_for(schemes, criteria))
    np.testing.assert_array_equal(P.weight_grid_upto(schemes, criteria),
                                  R.weight_grid_upto(schemes, criteria))


@pytest.mark.parametrize("args", [(0, 5), (-2, 6), (2, 4), (2, 7)])
def test_weight_grid_rejects_like_reference(args):
    assert (_message(lambda: P.weight_grid(*args))
            == _message(lambda: R.weight_grid(*args)))


@pytest.mark.parametrize("seed,s,m", [(0, 1, 3), (1, 7, 2), (2, 64, 4),
                                      (3, 200, 3)])
def test_pareto_mask_matches_reference(seed, s, m):
    rng = np.random.default_rng(seed)
    metrics = rng.integers(0, 5, (s, m)).astype(np.float64)  # many ties
    np.testing.assert_array_equal(P.pareto_mask(metrics),
                                  R.pareto_mask(metrics))
    metrics = rng.random((s, m))
    np.testing.assert_array_equal(P.pareto_mask(metrics),
                                  R.pareto_mask(metrics))


@pytest.mark.parametrize("bad", [np.ones(3), np.ones((2, 2, 2)),
                                 np.array([[1.0, np.nan]]),
                                 np.array([[np.inf, 0.0]])],
                         ids=["1d", "3d", "nan", "inf"])
def test_pareto_mask_rejects_like_reference(bad):
    assert (_message(lambda: P.pareto_mask(bad))
            == _message(lambda: R.pareto_mask(bad)))


# --- placement_metrics ---------------------------------------------------------
def _queue(workload, n_pods):
    """benchmarks/pareto_sweep.py's queue: kinds cycled."""
    kinds = itertools.cycle(["light", "medium", "complex"])
    return [workload.Pod(i, workload.WORKLOADS[next(kinds)], "topsis")
            for i in range(n_pods)]


def _fingerprint(pareto, points):
    """benchmarks/pareto_sweep.py's (frontier_size, frontier_checksum)."""
    front = pareto.frontier_for(points)
    members = np.flatnonzero(front.mask).astype(np.int64)
    return (int(front.mask.sum()),
            float(int(((members + 1) ** 2).sum() % (2 ** 31))))


def _dicts(points):
    return [p.as_dict() for p in points]


# (N, S, pods): the benchmark's --smoke cell, then N = 64 at S = 64
CELLS = [(8, 4, 4), (64, 64, 8)]


@pytest.mark.parametrize("carbon", [False, True], ids=["5c", "6c"])
@pytest.mark.parametrize("n,s,n_pods", CELLS)
def test_placement_metrics_matches_reference(n, s, n_pods, carbon):
    criteria = 6 if carbon else 5
    ws = R.weight_grid_upto(s, criteria)
    names = [f"w{i}" for i in range(s)]
    ref = {}
    for backend in ("numpy", "jax"):
        ref[backend] = R.placement_metrics(
            _queue(R_workload, n_pods),
            R_node.make_fleet_nodes(n, seed=0, utilization=0.3), ws,
            backend=backend, now=900.0, names=names,
            carbon_signal=(R_carbon.diurnal_fleet_signal(period_s=1800.0)
                           if carbon else None))
    want = _fingerprint(R, ref["numpy"])
    assert _fingerprint(R, ref["jax"]) == want
    for backend in ("numpy", "torch", "cuda"):
        got = P.placement_metrics(
            _queue(P_workload, n_pods),
            P_node.make_fleet_nodes(n, seed=0, utilization=0.3), ws,
            backend=backend, now=900.0, names=names, device="cpu",
            carbon_signal=(P_carbon.diurnal_fleet_signal(period_s=1800.0)
                           if carbon else None))
        assert _fingerprint(P, got) == want, backend
        assert ("carbon_g" in got[0].metrics) == carbon
        if backend == "numpy":
            assert _dicts(got) == _dicts(ref["numpy"])


def test_collectors_need_a_card_by_default():
    """The cuda default scores on the card: without one the collectors
    raise, as ``run_scenario(batch=True)`` does; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    nodes = P_node.make_fleet_nodes(8, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.placement_metrics(_queue(P_workload, 2), nodes,
                            P.weight_grid_upto(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.scenario_metrics(["general"], lambda: P_workload.PoissonArrivals(
            n_bursts=1))


# --- scenario_metrics and the atlas ------------------------------------------
def _ref_scenario(carbon, batch):
    return R.scenario_metrics(
        PAPER_SCHEMES, lambda: spec.arrivals(carbon), cluster_factory=
        spec.fleet(), carbon=spec.make_carbon() if carbon else None,
        batch=batch, batch_backend="numpy")


def _port_scenario(carbon, batch, backend):
    policy = port_policies("carbon_only")[0]
    return P.scenario_metrics(
        PAPER_SCHEMES, lambda: P_workload.PoissonArrivals(
            rate_per_s=0.3, n_bursts=3, burst_size=4, seed=7,
            deferrable_share=0.5 if carbon else 0.0, deadline_s=300.0),
        cluster_factory=lambda: P_node.make_scenario_cluster("mixed", 8,
                                                             seed=3),
        carbon=policy if carbon else None, batch=batch,
        batch_backend=backend, device="cpu")


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
@pytest.mark.parametrize("carbon", [False, True], ids=["5c", "6c"])
def test_scenario_metrics_matches_reference(carbon, backend):
    """The four paper schemes through the engine (batch rounds on each
    port backend) on the 8-node golden fleet: every metric equal."""
    got = _port_scenario(carbon, True, backend)
    want = _ref_scenario(carbon, True)
    assert _dicts(got) == _dicts(want)
    assert ("carbon_g" in got[0].metrics) == carbon
    np.testing.assert_array_equal(P.frontier_for(got).mask,
                                  R.frontier_for(want).mask)


def test_per_pod_scenario_metrics_matches_reference():
    """``batch=False``, asked for: the reference's per-pod numpy decisions
    on the host."""
    assert (_dicts(_port_scenario(True, False, "numpy"))
            == _dicts(_ref_scenario(True, False)))


def test_frontier_atlas_report_matches_reference():
    atlases = {}
    for pareto, run in ((P, _port_scenario), (R, None)):
        atlas = pareto.FrontierAtlas()
        for carbon in (False, True):
            pts = (run(carbon, True, "numpy") if run is not None
                   else _ref_scenario(carbon, True))
            atlas.add("carbon" if carbon else "flat", pareto.frontier_for(pts))
        atlases[pareto.__name__] = atlas
    got, want = atlases[P.__name__], atlases[R.__name__]
    assert got.to_report() == want.to_report()
    for regime in ("flat", "carbon"):
        assert (got.dominant_scheme(regime).as_dict()
                == want.dominant_scheme(regime).as_dict())
    assert (_message(lambda: got.dominant_scheme("x"), KeyError)
            == _message(lambda: want.dominant_scheme("x"), KeyError))
