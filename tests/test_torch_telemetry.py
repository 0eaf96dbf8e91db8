"""The port's telemetry exporters (``repro_torch.telemetry``: ``export``,
``baseline``, ``report``) against the live reference ``repro.telemetry``,
in-process.

Two registries are recorded: the ``carbon_autoscale`` cell of
tests/engine_golden_spec.py run by the port (numpy backend) and by the
reference. Their simulation-side content — counters, gauges, sim-time
series, the histograms' names and observation counts — is equal; span
durations are wall-clock times and differ from run to run. On each
registry, every port exporter's output is string-equal to the
reference's: the JSON snapshot, the Prometheus text and its parse, the
Perfetto trace, the HTML report (with a frontier section); and so are the
benchmark gate's verdicts (``compare_reports``, ``format_verdict``) on the
repo's recorded reports and the benchmark history file.
"""
import copy
import json
from pathlib import Path

import jax  # noqa: F401
import pytest
import torch  # noqa: F401

import engine_golden_spec as spec
from repro.core import pareto as R_pareto
from repro.core import telemetry as R_tel
from repro.telemetry import baseline as R_base
from repro.telemetry import export as R_exp
from repro.telemetry import report as R_rep
from repro_torch import telemetry as P_pkg
from repro_torch.core import pareto as P_pareto
from repro_torch.core import telemetry as P_tel
from repro_torch.telemetry import baseline as P_base
from repro_torch.telemetry import export as P_exp
from repro_torch.telemetry import report as P_rep
from test_torch_engine import _port_cell
from test_torch_pareto import _port_scenario, _ref_scenario

ROOT = Path(__file__).resolve().parents[1]
BENCH_FILES = ("BENCH_scenarios.json", "BENCH_pareto.json",
               "BENCH_carbon.json", "BENCH_autoscale.json")


@pytest.fixture(scope="module")
def recorded():
    """{"port": (registry, result), "reference": (registry, result)} for
    the carbon_autoscale cell, and a frontier payload to render."""
    with P_tel.enabled() as ptel:
        pres = _port_cell("numpy", "carbon_autoscale")
    with R_tel.enabled() as rtel:
        rres = spec.run_cell("carbon_autoscale", "numpy")
    atlas = R_pareto.FrontierAtlas()
    atlas.add("golden", R_pareto.frontier_for(_ref_scenario(True, False)))
    return {"port": (ptel, pres), "reference": (rtel, rres),
            "frontier": atlas.to_report()}


def test_port_and_reference_record_the_same_simulation(recorded):
    (ptel, _), (rtel, _) = recorded["port"], recorded["reference"]
    got, want = ptel.snapshot(), rtel.snapshot()
    for key in ("counters", "gauges", "series"):
        assert got[key] == want[key], key
    assert ([(h["name"], h["labels"], h["count"]) for h in got["histograms"]]
            == [(h["name"], h["labels"], h["count"])
                for h in want["histograms"]])
    assert ptel.counter_value("policy_node_sleeps",
                              policy="AutoscaleScheduling") > 0


def _dump(obj):
    return json.dumps(obj, sort_keys=True)


@pytest.mark.parametrize("who", ["port", "reference"])
def test_json_snapshot_matches_reference(recorded, who):
    tel, _ = recorded[who]
    for spans in (False, True):
        assert (_dump(P_exp.json_snapshot(tel, include_spans=spans))
                == _dump(R_exp.json_snapshot(tel, include_spans=spans)))


@pytest.mark.parametrize("who", ["port", "reference"])
def test_prometheus_text_and_parse_match_reference(recorded, who):
    tel, _ = recorded[who]
    text = P_exp.prometheus_text(tel)
    assert text == R_exp.prometheus_text(tel)
    parsed = P_exp.parse_prometheus(text)
    assert parsed == R_exp.parse_prometheus(text)
    for name, labels, value in tel.counters.values():
        assert parsed[(name, tuple(sorted(labels.items())))] == value


@pytest.mark.parametrize("who", ["port", "reference"])
def test_perfetto_trace_matches_reference(recorded, who, tmp_path):
    tel, res = recorded[who]
    got = P_exp.perfetto_trace(res, "carbon_autoscale", tel=tel)
    assert _dump(got) == _dump(R_exp.perfetto_trace(res, "carbon_autoscale",
                                                    tel=tel))
    assert P_exp.validate_trace(got) == R_exp.validate_trace(got)
    paths = [tmp_path / "port.json", tmp_path / "ref.json"]
    P_exp.write_perfetto(res, paths[0], tel=tel)
    R_exp.write_perfetto(res, paths[1], tel=tel)
    assert paths[0].read_text() == paths[1].read_text()


@pytest.mark.parametrize("who", ["port", "reference"])
def test_html_report_matches_reference(recorded, who):
    tel, res = recorded[who]
    kw = dict(title="carbon_autoscale", frontier=recorded["frontier"],
              provenance={"git_sha": "abc", "platform": "cpu"})
    html = P_rep.html_report(tel, res, **kw)
    assert html == R_rep.html_report(tel, res, **kw)
    assert P_pkg.html_report(None, None) == R_rep.html_report(None, None)


def test_port_frontier_payload_renders_as_reference(recorded):
    """The port's own FrontierAtlas feeds the port's report exactly as the
    reference's atlas feeds the reference's."""
    atlas = P_pareto.FrontierAtlas()
    atlas.add("golden", P_pareto.frontier_for(_port_scenario(True, False,
                                                             "numpy")))
    assert atlas.to_report() == recorded["frontier"]
    assert (P_rep.html_report(frontier=atlas.to_report())
            == R_rep.html_report(frontier=recorded["frontier"]))


def _perturbed(report):
    """A current report drifting from ``report``: the first cell's energy
    metrics 1% up, its timings 2x, the last cell gone, a metric nobody
    registered."""
    cur = copy.deepcopy(report)
    cells = cur["results"]
    for key, value in list(cells[0].items()):
        if isinstance(value, float) and "energy" in key:
            cells[0][key] = value * 1.01
        elif isinstance(value, float) and ("time" in key or key.startswith(
                "ms_")):
            cells[0][key] = value * 2.0
    cells[0]["shiny_new_metric"] = 1.23
    if len(cells) > 1:
        cells.pop()
    return cur


@pytest.mark.parametrize("name", BENCH_FILES)
def test_compare_reports_matches_reference(name):
    base = json.loads((ROOT / name).read_text())
    for cur in (base, _perturbed(base)):
        got = P_base.compare_reports(cur, base)
        want = R_base.compare_reports(cur, base)
        assert _dump(got) == _dump(want)
        for verbose in (False, True):
            assert (P_base.format_verdict(got, verbose=verbose)
                    == R_base.format_verdict(want, verbose=verbose))
    assert P_pkg.compare_reports is P_base.compare_reports


def test_history_matches_reference(tmp_path):
    entries = [{"kind": "check", "status": "pass", "bench": "b"},
               {"kind": "record", "results": [{"a": 1.5}], "z": None}]
    paths = {}
    for who, mod in (("port", P_base), ("reference", R_base)):
        paths[who] = tmp_path / who / "history" / "b.jsonl"
        for e in entries:
            assert mod.append_history(e, paths[who]) == str(paths[who])
    assert paths["port"].read_text() == paths["reference"].read_text()
    assert (P_base.history_entries(paths["reference"])
            == R_base.history_entries(paths["port"]) == entries)
    assert P_base.history_entries(tmp_path / "none.jsonl") == []
