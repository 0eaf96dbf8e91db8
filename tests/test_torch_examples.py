"""The repo's four examples as the port's entry points
(``examples/torch_*.py``), on the CPU at reduced sizes, held against the
live reference in-process (never against the JSON goldens):

- quickstart: the decision matrix bitwise equal to the reference's, both
  backends' pick the reference GreenPod's, the Table VI cell's energies
  bitwise equal to the reference's ``run_experiment``;
- the fleet tour at small sizes through chip_smoke's ``[examples]`` checks
  (the cuda backend's plain versions against numpy following its
  near-tie breaks), every scenario's energy, carbon, wakes, sleeps,
  migrations, preemptions and placements equal to the reference's
  ``run_scenario(..., batch_backend="numpy")`` where no near-tie was
  followed, explain's deltas summing to its gap, the files in the
  out-dir; a cuda run whose numbers differ is rejected;
- train_lm: a few steps with a failure mid-run, losses within 1e-5 of the
  reference's ``make_train_step`` under its Supervisor at carried-over
  weights, the replayed steps and the final parameters bit for bit an
  uninterrupted run's;
- serve_lm: greedy tokens equal to the reference ``Engine``'s at
  carried-over weights, float32 logits within 1e-5 of each row's largest;
- each example raises without a card unless ``--device cpu`` is given.
"""
import importlib.util
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import node as rnode
from repro.cluster import simulator as rsim
from repro.cluster.workload import WORKLOADS as RWORKLOADS
from repro.cluster.workload import Pod as RPod
from repro.cluster.workload import PoissonArrivals as RPoisson
from repro.configs import registry as rregistry
from repro.core import carbon as rcarbon
from repro.core import elastic as relastic
from repro.core.scheduler import GreenPodScheduler as RGreenPod
from repro.core.scheduler import decision_matrix as rdecision_matrix
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.launch.mesh import make_host_mesh as rmake_host_mesh
from repro.models import lm as rlm
from repro.optim import adamw as radamw
from repro.serve.engine import Engine as REngine
from repro.serve.engine import Request as RRequest
from repro.train import fault as rfault
from repro.train import loop as rloop

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "fleet_scheduler", "train_lm", "serve_lm")
# the fleet tour's sizes here: its one-shot queue, its frontier
SMALL_TOUR = dict(N_NODES=256, N_PODS=16, FRONTIER_SCHEMES=32,
                  FRONTIER_PODS=8, FRONTIER_NODES=32)
TRAIN_ARGV = ["--device", "cpu", "--steps", "12", "--batch", "4", "--seq",
              "32"]
CKPT_EVERY = 4
FAIL_AT = 6
LOSS_RTOL = 1e-5
LOGIT_RTOL = 1e-5


def _example(name, **constants):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in constants.items():
        assert hasattr(mod, k), k
        setattr(mod, k, v)
    return mod


def _chip_smoke():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _ref_tree():
    params = rlm.build(rregistry.smoke_config("llama3-8b")).init(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("name", NAMES)
def test_examples_need_a_card_unless_asked_for_the_cpu(name, monkeypatch,
                                                      tmp_path):
    """No card, no ``--device``: each raises before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])
    assert not list(tmp_path.iterdir())


# --- quickstart -----------------------------------------------------------------
def test_quickstart_matches_the_reference():
    out = _example("quickstart").main(["--device", "cpu"])
    nodes = rnode.make_paper_cluster()
    pod = RPod(uid=0, workload=RWORKLOADS["medium"], scheduler="topsis")
    np.testing.assert_array_equal(out["matrix"],
                                  rdecision_matrix(pod, nodes))
    idx, diag = RGreenPod("energy_centric").select(pod, nodes)
    assert out["pick"] == {"numpy": idx, "cuda": idx}
    np.testing.assert_array_equal(out["closeness"]["numpy"],
                                  diag["closeness"])
    np.testing.assert_allclose(out["closeness"]["cuda"], diag["closeness"],
                               rtol=0, atol=1e-5)
    res = rsim.run_experiment("medium", "energy_centric")
    assert out["default_kj"] == res.mean_energy_kj("default")
    assert out["topsis_kj"] == res.mean_energy_kj("topsis")
    assert 43.0 < out["optimization_pct"] < 45.0


# --- the fleet tour ---------------------------------------------------------------
def _reference_scenarios():
    """The reference tour's scenario sections on numpy, by the port tour's
    names (examples/fleet_scheduler.py's parameters)."""
    period = 1800.0
    signal = rcarbon.diurnal_fleet_signal(
        base=300.0, amplitude=200.0, period_s=period, phase_s=period / 4.0,
        stagger_s=period / 16.0)
    policy = rcarbon.CarbonPolicy(signal, defer_threshold=300.0,
                                  preempt_threshold=450.0,
                                  check_interval_s=30.0)

    def arrivals(**kw):
        return RPoisson(rate_per_s=0.2, n_bursts=6, burst_size=12, seed=0,
                        **kw)

    def carbon_arrivals():
        return arrivals(deferrable_share=0.5, deadline_s=period / 2.0)

    def fleet(profile):
        return lambda: rnode.make_scenario_cluster(profile, 64, seed=0)

    def run(arr, scheme, profile="mixed", **kw):
        kw.setdefault("batch_backend", "numpy")
        return rsim.run_scenario(arr, scheme, cluster_factory=fleet(profile),
                                 batch=True, **kw)

    AS = relastic.AutoscalePolicy
    runs = {"event": (run(arrivals(), "energy_centric", "edge_heavy"),
                      False)}
    for scheme in ("energy_centric", "carbon_centric"):
        runs[f"carbon_{scheme}"] = (run(carbon_arrivals(), scheme,
                                        carbon=policy), True)
    for key, pol in (("always_on", None),
                     ("idle_timeout", AS(idle_timeout_s=60.0)),
                     ("consolidation", AS(idle_timeout_s=60.0,
                                          consolidate_interval_s=30.0,
                                          consolidate_util_below=0.3))):
        runs[f"elastic_{key}"] = (run(arrivals(), "energy_centric",
                                      autoscale=pol), False)
    runs["recorder"] = (run(carbon_arrivals(), "carbon_centric",
                            carbon=policy, autoscale=AS(idle_timeout_s=60.0)),
                        True)
    runs["explain"] = run(arrivals(), "energy_centric", explain=True)
    return runs


@pytest.fixture(scope="module")
def tour():
    """The port tour at SMALL_TOUR through chip_smoke's runs (cuda on the
    CPU, then numpy following it), with the reference's scenarios."""
    cs = _chip_smoke()
    mod = _example("fleet_scheduler", **SMALL_TOUR)
    cpu = torch.device("cpu")
    load = cs.load_example
    cs.load_example = lambda name: mod if name == "fleet_scheduler" \
        else load(name)
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            runs = cs.fleet_tour_runs(cpu, ROOT / "build" / "no_records",
                                      out_dir)
            files = {b: sorted(p.name for p in (Path(out_dir) / b).iterdir())
                     for b in ("cuda", "numpy")}
            cs.fleet_tour_example(cpu, None, out_dir, runs=runs)
    finally:
        cs.load_example = load
    return cs, runs, files, _reference_scenarios()


def test_fleet_tour_scenarios_equal_the_reference(tour):
    """Every scenario section of the numpy run equals the reference's
    numpy run where no near-tie was followed (and every one is such
    here); the cuda run equals the numpy run (chip_smoke's check)."""
    _, (cu, nu, _, stats, _), _, ref = tour
    assert set(nu["scenarios"]) == set(ref) - {"explain"}
    for name, got in nu["scenarios"].items():
        assert sum(c["ties"] for c in stats["numpy"][name]["calls"]) == 0
        res, carbon = ref[name]
        assert got["energy_kj"] == res.energy_kj("topsis"), name
        assert got["default_energy_kj"] == res.energy_kj("default"), name
        assert got["carbon_g"] == (res.total_carbon_g("topsis") if carbon
                                   else None), name
        assert (got["wakes"], got["sleeps"], got["migrations"],
                got["preemptions"]) == (res.wakes, res.sleeps,
                                        res.migrations, res.preemptions)
        assert got["placements"] == sorted(
            (r.pod.uid, r.pod.scheduler, r.node, r.start_s)
            for r in res.records), name
        assert cu["scenarios"][name] == got


def test_fleet_tour_explain_and_files(tour):
    """explain (numpy) picks the reference's decision and its deltas sum
    to the gap; the trace and the two reports land in the out-dir."""
    _, (cu, _, _, _, _), files, ref = tour
    res = ref["explain"]
    exp = max((e for e in res.explanations if e["runner_up"] is not None),
              key=lambda e: abs(e["gap"]))
    got = cu["explain"]
    assert (got["pod"], got["node"], got["runner_up"], got["gap"]) == (
        exp["pod"], exp["node"], exp["runner_up_node"], exp["gap"])
    assert sum(got["deltas"].values()) == pytest.approx(got["gap"],
                                                        abs=1e-12)
    want = ["fleet_frontier_report.html", "fleet_scheduler.trace.json",
            "fleet_scheduler_report.html"]
    assert files == {"cuda": want, "numpy": want}


def test_fleet_tour_queue_and_frontier_follow_numpy(tour):
    """The one-shot queue (numpy and cuda in one run) and the frontier
    (one grid call a regime in each run) were recorded, and their picks
    and frontiers agree with numpy's."""
    _, (cu, nu, calls, _, _), _, _ = tour
    assert len(calls["queue", "cuda"]) == len(calls["queue", "numpy"]) - 2
    assert len(calls["grid", "cuda"]) == len(calls["grid", "numpy"]) == 2
    assert cu["select_many"]["cuda"]["assignments"] == \
        cu["select_many"]["numpy"]["assignments"]
    for regime, f in cu["frontier"].items():
        np.testing.assert_array_equal(f["mask"],
                                      nu["frontier"][regime]["mask"])


def test_fleet_tour_check_rejects_a_cuda_run_that_differs(tour):
    """A scenario number of the cuda run off by 1e-9 kJ fails the check."""
    cs, (cu, nu, calls, stats, launches), _, _ = tour
    bad = dict(cu, scenarios=dict(cu["scenarios"], event=dict(
        cu["scenarios"]["event"],
        energy_kj=cu["scenarios"]["event"]["energy_kj"] + 1e-9)))
    with tempfile.TemporaryDirectory() as d, \
            pytest.raises(cs.SmokeFailure, match="fleet tour event"):
        cs.fleet_tour_example(torch.device("cpu"), None, d,
                              runs=(bad, nu, calls, stats, launches))


# --- train_lm ---------------------------------------------------------------------
def _reference_training(tree, tmp_path):
    """examples/train_lm.py's run at TRAIN_ARGV's sizes and FAIL_AT."""
    cfg = rregistry.smoke_config("llama3-8b")
    model = rlm.build(cfg)
    ocfg = radamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=12)
    step, _ = rloop.make_train_step(model, ocfg, rmake_host_mesh(),
                                    n_micro=2, donate=False)
    params = jax.tree.map(jnp.asarray, tree)
    ds = RSyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=4)
    fired = []

    def fault_hook(s):
        if s == FAIL_AT and not fired:
            fired.append(s)
            raise RuntimeError("simulated node failure")

    sup = rfault.Supervisor(ckpt_dir=str(tmp_path), ckpt_every=CKPT_EVERY,
                            max_restarts=3)
    _, hist = sup.run(state={"params": params,
                             "opt_state": radamw.init(ocfg, params)},
                      step_fn=step,
                      data_fn=lambda s: {"tokens": jnp.asarray(
                          ds.batch_at(s))},
                      n_steps=12, fault_hook=fault_hook)
    return hist


def test_train_lm_matches_the_reference_and_restores_bit_for_bit(tmp_path):
    tree = _ref_tree()
    ex = _example("train_lm", CKPT_EVERY=CKPT_EVERY)
    got = ex.main(TRAIN_ARGV + ["--out-dir", str(tmp_path / "port")],
                  params=tree, fail_at=FAIL_AT)
    assert got["failures"] == 1
    # steps 0-5, the failure at 6, the restart from the checkpoint at 4
    assert got["steps"] == list(range(6)) + list(range(4, 12))
    want = _reference_training(tree, tmp_path / "ref")
    assert [h["step"] for h in want] == got["steps"]
    np.testing.assert_allclose(got["losses"], [h["loss"] for h in want],
                               rtol=LOSS_RTOL)
    # the replayed steps 4 and 5 and the final parameters as an
    # uninterrupted run's, bit for bit
    assert got["losses"][4:6] == got["losses"][6:8]
    whole = ex.main(TRAIN_ARGV, params=tree, fail_at=None)
    assert whole["steps"] == list(range(12))
    assert set(whole["params"]) == set(got["params"])
    for k, v in whole["params"].items():
        assert torch.equal(v, got["params"][k]), k
    assert not torch.distributed.is_initialized()


# --- serve_lm ---------------------------------------------------------------------
class _Recording:
    """The model as the Engine sees it, keeping every call's inputs and
    logits."""

    def __init__(self, model):
        self.model, self.calls = model, []

    def prefill(self, batch, max_len):
        logits, cache = self.model.prefill(batch, max_len)
        self.calls.append(("prefill", batch["tokens"].copy(), logits))
        return logits, cache

    def decode(self, cache, tokens):
        logits, cache = self.model.decode(cache, tokens)
        self.calls.append(("decode", tokens.clone(), logits))
        return logits, cache


def test_serve_lm_matches_the_reference_engine():
    tree = _ref_tree()
    rec = {}

    def wrap(model):
        rec["lm"] = _Recording(model)
        return rec["lm"]

    out = _example("serve_lm").main(["--device", "cpu"], params=tree,
                                    wrap=wrap)
    rmodel = rlm.build(rregistry.smoke_config("llama3-8b"))
    params = jax.tree.map(jnp.asarray, tree)
    eng = REngine(rmodel, params, batch_slots=4, max_len=64)
    rng = np.random.default_rng(0)
    reqs = [RRequest(i, rng.integers(2, 256, rng.integers(4, 12))
                     .astype(np.int32), max_new_tokens=16)
            for i in range(12)]
    want = {r.uid: np.asarray(r.tokens) for r in eng.serve(reqs)}
    assert set(out["results"]) == set(want)
    for uid, toks in want.items():
        np.testing.assert_array_equal(out["results"][uid], toks)
    # every call of the port's run replayed on the reference, teacher-forced
    prefill = jax.jit(lambda p, b: rmodel.prefill(p, b, max_len=64))
    decode = jax.jit(rmodel.decode)
    cache = None
    assert rec["lm"].calls
    for kind, tokens, logits in rec["lm"].calls:
        if kind == "prefill":
            ref, cache = prefill(params, {"tokens": jnp.asarray(tokens)})
        else:
            ref, cache = decode(params, cache, jnp.asarray(tokens.numpy()))
        ref = np.asarray(ref)
        scale = np.abs(ref).max(-1, keepdims=True)
        assert (np.abs(logits.numpy() - ref) <= LOGIT_RTOL * scale).all()
