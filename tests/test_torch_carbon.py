"""The port's carbon policy (``repro_torch.core.carbon``: ``TraceCarbon``,
``CarbonPolicy``, ``CarbonScheduling``) against the live reference
``repro.core.carbon``, in-process.

The module is a copy with its imports rewritten, so every value is held
equal, not close: intensities, integrals, the region fallback, and every
validation message word for word. A zero carbon weight must leave the
ranking bitwise as the 5-criteria scheme's on the numpy backend (the
float32 torch and cuda backends: the same -inf pattern and placements,
closeness within 1e-5 of numpy).
"""
import json
import math

import jax  # noqa: F401
import numpy as np
import pytest
import torch  # noqa: F401

from repro.cluster import workload as R_workload
from repro.cluster import simulator as R_sim
from repro.core import carbon as R
from repro_torch.cluster import workload as P_workload
from repro_torch.cluster.node import make_fleet
from repro_torch.cluster.simulator import run_scenario
from repro_torch.core import carbon as P
from repro_torch.core.scheduler import BatchScheduler, _greedy_assign

TRACE = [
    {"t": 0.0, "intensity": 100.0, "region": "a"},
    {"t": 10.0, "intensity": 300.0, "region": "a"},
    {"t": 25.5, "intensity": 40.0, "region": "a"},
    {"t": 5.0, "intensity": 50.0, "region": "default"},
    {"t": 7.0, "intensity": 75.0},
    {"t": 3.0, "intensity": 0.0, "region": "b"},
]
TIMES = (0.0, 2.5, 5.0, 6.999, 7.0, 9.999, 10.0, 25.5, 1e9)
SPANS = ((0.0, 20.0), (5.0, 15.0), (-10.0, 3.0), (7.0, 7.0), (24.0, 1e4),
         (30.0, 20.0))
REGIONS = ("a", "b", "default", "unmapped")

BAD_TRACES = [
    [{"intensity": 1.0}],                          # missing t
    [{"t": -1.0, "intensity": 1.0}],               # negative t
    [{"t": float("inf"), "intensity": 1.0}],       # non-finite t
    [{"t": "x", "intensity": 1.0}],                # not a number
    [{"t": 0.0}],                                  # missing intensity
    [{"t": 0.0, "intensity": -5.0}],               # negative value
    [{"t": 0.0, "intensity": float("nan")}],       # non-finite value
    [{"t": 0.0, "intensity": 1.0, "region": ""}],  # empty region
    [{"t": 0.0, "intensity": 1.0, "region": 3}],   # not a string
    [["t", 0.0]],                                  # not an object
    [],                                            # empty trace
]


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("region", REGIONS)
def test_trace_intensity_and_integral_match_reference(region):
    """Step lookup, the first reading extending backwards, the default
    series as the fallback, and exact piecewise integrals."""
    ref, got = R.TraceCarbon(TRACE), P.TraceCarbon(TRACE)
    assert got.series == ref.series
    for t in TIMES:
        assert got.intensity(region, t) == ref.intensity(region, t)
    for t0, t1 in SPANS:
        assert got.integral(region, t0, t1) == ref.integral(region, t0, t1)
    regions = np.asarray([region, "a", region])
    np.testing.assert_array_equal(got.intensities(regions, 8.0),
                                  ref.intensities(regions, 8.0))
    assert got.fleet_min(list(REGIONS), 8.0) == ref.fleet_min(list(REGIONS),
                                                               8.0)


def test_trace_without_default_series_names_what_it_has():
    entries = [{"t": 0.0, "intensity": 1.0, "region": "a"}]
    ref, got = R.TraceCarbon(entries), P.TraceCarbon(entries)
    want = _message(lambda: ref.intensity("b", 0.0))
    assert _message(lambda: got.intensity("b", 0.0)) == want
    assert _message(lambda: got.integral("b", 0.0, 1.0)) == want
    assert got.intensity("a", 5.0) == ref.intensity("a", 5.0) == 1.0


@pytest.mark.parametrize("bad", BAD_TRACES, ids=range(len(BAD_TRACES)))
def test_trace_validation_messages_match_reference(bad):
    assert (_message(lambda: P.TraceCarbon(bad))
            == _message(lambda: R.TraceCarbon(bad)))


def test_trace_from_file_matches_reference(tmp_path):
    path = tmp_path / "carbon.json"
    path.write_text(json.dumps(TRACE))
    ref = R.TraceCarbon.from_file(str(path))
    for got in (P.TraceCarbon.from_file(str(path)),
                P.TraceCarbon.from_file(path)):         # os.PathLike
        assert got.series == ref.series
        for region in REGIONS:
            for t0, t1 in SPANS:
                assert (got.integral(region, t0, t1)
                        == ref.integral(region, t0, t1))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([TRACE[0], {"t": 1.0}]))
    want = _message(lambda: R.TraceCarbon.from_file(bad))
    assert str(bad) in want and "entry 1" in want
    assert _message(lambda: P.TraceCarbon.from_file(bad)) == want


POLICY_KWARGS = [
    dict(check_interval_s=0.0),
    dict(check_interval_s=-30.0),
    dict(defer_threshold=float("nan")),
    dict(preempt_threshold=-1.0),
    dict(preempt_threshold=float("nan")),
]


@pytest.mark.parametrize("kwargs", POLICY_KWARGS,
                         ids=lambda kw: ",".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_carbon_policy_validation_matches_reference(kwargs):
    assert (_message(lambda: P.CarbonPolicy(P.ConstantCarbon(100.0),
                                            **kwargs))
            == _message(lambda: R.CarbonPolicy(R.ConstantCarbon(100.0),
                                               **kwargs)))


def test_carbon_policy_defaults_match_reference():
    ref, got = R.CarbonPolicy(R.ConstantCarbon(1.0)), P.CarbonPolicy(
        P.ConstantCarbon(1.0))
    for field in ("defer_threshold", "preempt_threshold", "check_interval_s"):
        assert getattr(got, field) == getattr(ref, field)
    assert math.isinf(got.defer_threshold)                # deferral off


class _OneBurst:
    """One deferrable pod at t=0 with the given deadline, from the given
    workload module (``Pod`` and ``WORKLOADS``)."""

    def __init__(self, workload, deadline_s):
        self.pods = [workload.Pod(0, workload.WORKLOADS["light"], "topsis",
                                  deferrable=True, deadline_s=deadline_s)]

    def events(self):
        return [(0.0, self.pods)]


@pytest.mark.parametrize("deadline", [math.inf, 0.0, -5.0])
def test_deferrable_pod_needs_a_finite_deadline_like_reference(deadline):
    want = _message(lambda: R_sim.run_scenario(
        _OneBurst(R_workload, deadline), "energy_centric",
        carbon=R.CarbonPolicy(R.ConstantCarbon(100.0))))
    got = _message(lambda: run_scenario(
        _OneBurst(P_workload, deadline), "energy_centric",
        carbon=P.CarbonPolicy(P.ConstantCarbon(100.0))))
    assert got == want and "deadline_s" in got


def _queue(p, seed):
    rng = np.random.default_rng(seed)
    kinds = list(P_workload.WORKLOADS)
    return [P_workload.Pod(i, P_workload.WORKLOADS[
        kinds[int(rng.integers(len(kinds)))]], "topsis") for i in range(p)]


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
@pytest.mark.parametrize("seed,n,p,util,t", [
    (0, 4, 1, 0.0, 0.0), (1, 64, 3, 0.4, 900.0), (2, 257, 6, 0.8, 4321.5)])
def test_zero_carbon_weight_ranks_as_the_5_criteria_scheme(backend, seed, n,
                                                           p, util, t):
    """The paper schemes with a signal attached carry a zero carbon
    weight: the sixth column changes no ranking."""
    table = make_fleet(n, seed=seed, utilization=util)
    pods = _queue(p, seed)
    legacy = BatchScheduler("energy_centric", backend="numpy")
    legacy_cc = legacy.score_queue(pods, table)
    sig = P.diurnal_fleet_signal(period_s=1800.0)
    sched = BatchScheduler("energy_centric", backend=backend,
                           carbon_signal=sig, device="cpu")
    got = sched.score_queue(pods, table, now=t)
    if backend == "numpy":
        np.testing.assert_array_equal(got, legacy_cc)
    else:
        np.testing.assert_array_equal(np.isneginf(got),
                                      np.isneginf(legacy_cc))
        fin = np.isfinite(legacy_cc)
        np.testing.assert_allclose(got[fin], legacy_cc[fin], atol=1e-5,
                                   rtol=0)
        five = BatchScheduler("energy_centric", backend=backend,
                              device="cpu").score_queue(pods, table)
        assert (_greedy_assign(got, pods, table)
                == _greedy_assign(five, pods, table))
