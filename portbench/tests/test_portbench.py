"""CPU tests of the benchmark (``portbench/``): the cells resolve by name,
the work formulas equal hand counts, the traffic follows the seed, the
reference agrees with the program at a small size, a run whose timed
path is broken comes out not correct, and nothing imports JAX or the
JAX package. The ``gpu`` test runs the calibration on the card.

    python -m pytest -q portbench/tests
"""
from __future__ import annotations

import ast
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path[:0] = [str(BENCH), str(REPO / "src")]

from harness import cells, result, trace, traffic, weights, work  # noqa: E402
from reference import moe_lm, served  # noqa: E402

HERE = Path(__file__).resolve().parent
SMOKE_CFG = json.loads((HERE / "smoke-moe.json").read_text())
SMOKE_MIX = json.loads((HERE / "smoke-chat.json").read_text())
CELL = "mixtral-8x7b.serve-chat"
SEED = 2 ** 31 + 977


def smoke_cell(limits=None, cfg=SMOKE_CFG, mix=SMOKE_MIX) -> cells.Cell:
    real = cells.cell(CELL)
    return cells.Cell("smoke", 1, cfg, mix, limits or real.limits,
                      real.end_to_end, real.per_layer)


def smoke_run(cell=None, seed=SEED, traced=False, control=False):
    cell = cell or smoke_cell()
    return cell.driver.run(cell, seed, 0.0, traced, time.time(),
                           device="cpu", control=control)


# --- resolving by name ---------------------------------------------------------
def test_every_cell_resolves_by_name():
    bench = cells.benchmark()
    for w in bench["workloads"]:
        cell = cells.cell(w["name"], bench)
        assert cell.chips == w["chips"]
        assert hasattr(cell.driver, "run")
        assert set(cell.limits) <= {"share_missed", "mean_gap", "bad_answers"}
        assert cell.config["num_hidden_layers"] >= 1
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cells.reader(m["name"]))
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
        assert set(c["reduced"]) <= set(json.loads(
            (REPO / c["file"]).read_text())["reduced"])


def test_benchmark_names_and_units_keep_the_contract_alphabet():
    import re
    bench = cells.benchmark()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert name.match(m["name"]) and unit.match(m["unit"])
    for x in bench["workloads"] + bench["configs"]:
        assert name.match(x["name"]) and len(x["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_an_unknown_cell_or_file_is_refused_by_name():
    with pytest.raises(KeyError):
        cells.cell("no-such.cell")
    with pytest.raises(FileNotFoundError):
        cells.load_module(BENCH / "metrics" / "no_such_metric.py")


# --- the yardstick's arithmetic --------------------------------------------------
def test_attention_pairs_count_by_hand():
    def brute(s, w, causal=True):
        return sum(1 for q in range(s) for k in range(s)
                   if (not causal or k <= q) and (w is None or k > q - w))
    for s, w in [(1, None), (7, None), (7, 3), (7, 7), (7, 20), (16, 5)]:
        assert work.attention_pairs(s, w) == brute(s, w)
    assert work.attention_pairs(5, None, causal=False) == 25


def test_token_flops_count_by_hand():
    c = dict(SMOKE_CFG)
    per_token, per_row, per_pair = work.token_flops(c)
    D, H, Hkv, hd, F, E, K, V, L = 64, 4, 2, 16, 128, 4, 2, 256, 2
    by_hand = L * 2 * (D * H * hd + 2 * D * Hkv * hd + H * hd * D   # q k v o
                       + D * E                                      # router
                       + K * (2 * D * F + F * D))                   # experts
    assert per_token == by_hand
    assert per_row == 2 * D * V
    assert per_pair == L * H * (2 * hd + 2 * hd)


def test_served_flops_count_by_hand():
    c = dict(SMOKE_CFG, sliding_window=None)
    t, r, p = work.token_flops(c)
    # prompt 3, 2 tokens out: 3 + 1 tokens through the layers, 2 logits
    # rows, pairs 3 * 4 / 2 = 6 in the prompt and 4 for the fed-back token
    assert work.served_flops(c, 3, 2) == 4 * t + 2 * r + 10 * p
    c["sliding_window"] = 2     # pairs: 1 + 2 + 2, then 2
    assert work.served_flops(c, 3, 2) == 4 * t + 2 * r + 7 * p


def test_flash_bound_by_hand():
    b, h, hkv, s, d = 2, 4, 2, 64, 128
    flops = 4 * d * b * h * (s * (s + 1) // 2)
    nbytes = 2 * (2 * b * h * s * d + 2 * b * hkv * s * d) + 4 * b * h * s
    want = max(flops / 989e12, nbytes / 3.35e12)
    assert math.isclose(work.flash_fwd_bound_s(b, h, hkv, s, d, None), want)


# --- traffic -------------------------------------------------------------------
def test_traffic_follows_the_seed():
    mix = cells.cell(CELL).traffic
    a = traffic.wave(mix, SEED, 3, 32000)
    b = traffic.wave(mix, SEED, 3, 32000)
    c = traffic.wave(mix, SEED + 1, 3, 32000)
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
               for x, y in zip(a, b))
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))
    # every seed and wave holds the same lengths, in another order
    for w in (a, c, traffic.wave(mix, 12, 0, 32000)):
        assert sorted(len(r.prompt) for r in w) == sorted(
            traffic.quantiles(mix["prompt_tokens"], 32))
        assert sorted(r.max_new for r in w) == sorted(
            traffic.quantiles(mix["output_tokens"], 32))
        assert all(r.prompt.min() >= 2 and r.prompt.max() < 32000 for r in w)
    assert max(len(r.prompt) for r in a) == 2048
    assert traffic.max_len(mix) == 2048 + 256
    warm = traffic.wave(mix, SEED, traffic.WARMUP_INDEX, 32000)
    assert max(r.max_new for r in warm) == mix["warmup_new_tokens"]


def test_weights_follow_the_seed_in_their_served_types():
    a = weights.make(SMOKE_CFG, 5, "cpu")
    b = weights.make(SMOKE_CFG, 5, "cpu")
    c = weights.make(dict(SMOKE_CFG, torch_dtype="bfloat16"), 5, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert c["layers.0.moe.w1"].dtype == torch.bfloat16
    assert c["layers.0.moe.router"].dtype == torch.float32
    assert not torch.equal(a["layers.0.ln1"], torch.ones(64))
    assert torch.equal(a["layers.0.moe.router_bias"], torch.zeros(4))


# --- the reference against the program -----------------------------------------
def program(cfg=SMOKE_CFG, seed=SEED):
    cell = smoke_cell(cfg=cfg)
    return cell.driver.build(cfg, seed, torch.device("cpu"))


@pytest.mark.parametrize("rows, cols", [(3, 40), (32, 1024)])
def test_reference_prefill_and_decode_agree_with_the_program(rows, cols):
    """float32 on the CPU, the prompts padded as the engine pads them,
    dropless; at 32 x 1024 tokens the program's dispatch cuts the sequence
    into groups of 16,384 tokens, which dropless routing does not see."""
    model = program()
    ref = moe_lm.MoeLM(SMOKE_CFG, weights.make(SMOKE_CFG, SEED, "cpu"))
    g = np.random.default_rng(0)
    prompts = [g.integers(2, 256, g.integers(1, cols + 1)) for _ in
               range(rows)]
    prompts[0] = g.integers(2, 256, cols)
    toks, pad = served.padded(prompts)
    got, cache = model.prefill({"tokens": toks.astype(np.int32)}, cols + 3)
    want, rcache = ref.prefill(torch.as_tensor(toks), cols + 3,
                               torch.as_tensor(pad))
    assert set(ref.pad_margin) == {0, 1}
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for _ in range(3):
        nxt = torch.argmax(want, -1)
        got, cache = model.decode(cache, nxt)
        want, rcache = ref.decode(rcache, nxt)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_a_smoke_run_is_correct_and_reports_its_metrics():
    line, checks, numbers = smoke_run()
    assert line["correct"] and line["failed"] == 0
    assert line["attempted"] == SMOKE_MIX["clients"]
    assert numbers["max_gap"] < 1e-4 and numbers["pad_branch"] == []
    assert set(line["metrics"]) == {"serve_tokens_per_s", "itl_p95_ms",
                                    "setup_s"}
    assert list(checks) == list(cells.cell(CELL).limits)
    traced, _, _ = smoke_run(traced=True)
    assert {"mfu_pct.serve", "prefill_s.serve"} <= set(traced["metrics"])
    assert 0 < traced["metrics"]["mfu_pct.serve"]["value"] < 100


def test_a_configuration_that_drops_tokens_is_refused():
    cfg = dict(SMOKE_CFG, capacity_factor=1.25)
    with pytest.raises(ValueError, match="dropless"):
        smoke_cell().driver.model_config(cfg)


def _greedy(model, prompts, steps):
    toks, pad = (torch.as_tensor(a) for a in served.padded(prompts))
    logits, cache = model.prefill(toks, toks.shape[1] + steps, pad)
    out = []
    for _ in range(steps):
        out.append(torch.argmax(logits, -1))
        logits, cache = model.decode(cache, out[-1])
    fed = torch.stack(out[:-1]).numpy()
    return [np.array([int(o[i]) for o in out]) for i in
            range(len(prompts))], fed


def test_a_pad_routing_within_rounding_of_a_tie_is_judged_on_both_branches(
        monkeypatch):
    """Served tokens that came from the pads' other routing in layer 0:
    the base replay misses some, the flipped branch agrees with all."""
    ref = moe_lm.MoeLM(SMOKE_CFG, weights.make(SMOKE_CFG, SEED, "cpu"))
    g = np.random.default_rng(0)
    prompts = [g.integers(2, 256, n) for n in (1, 60, 64)]
    ref.pad_flip = frozenset({0})
    toks, fed = _greedy(ref, prompts, 12)
    ref.pad_flip = frozenset()
    assert (served._gaps(ref, prompts, toks, fed, "cpu", False)[0] > 0).any()
    assert served.gaps(ref, prompts, toks, fed, "cpu")[2] == frozenset()
    monkeypatch.setattr(served, "PAD_TIE", float("inf"))
    gaps, _, branch = served.gaps(ref, prompts, toks, fed, "cpu")
    assert 0 in branch and gaps.max() == 0 and len(gaps) == 36


def test_the_control_reads_wider_gaps_than_the_program():
    _, _, numbers = smoke_run(control=True)
    assert numbers["control_mean_gap"] > 10 * max(numbers["mean_gap"], 1e-6)
    assert numbers["control_max_gap"] > 10 * max(numbers["max_gap"], 1e-6)


# --- faults planted in the timed path --------------------------------------------
def _stale_decode(monkeypatch):
    """Decode steps that leave the cache as they found it."""
    from repro_torch.models.lm import LM
    orig = LM.decode

    def decode(self, cache, tokens):
        saved = {k: [t.clone() for t in v.values()] for k, v in cache.items()
                 if isinstance(v, dict)}
        logits, new = orig(self, cache, tokens)
        for k, ts in saved.items():
            for t, s in zip(cache[k].values(), ts):
                t.copy_(s)
        return logits, new
    monkeypatch.setattr(LM, "decode", decode)


def _half_the_answers(monkeypatch):
    from repro_torch.serve.engine import Engine
    orig = Engine.run_wave
    monkeypatch.setattr(Engine, "run_wave",
                        lambda self, reqs: orig(self, reqs)[::2])


def _altered_token(monkeypatch):
    """Every fourth decode step, every row's token is the one its logits
    rank last."""
    from repro_torch.models.lm import LM
    orig, calls = LM.decode, []

    def decode(self, cache, tokens):
        logits, new = orig(self, cache, tokens)
        calls.append(1)
        if len(calls) % 4 == 2:
            rows = torch.arange(logits.shape[0])
            logits = logits.clone()
            logits[rows, torch.argmin(logits, -1)] = logits.max() + 1
        return logits, new
    monkeypatch.setattr(LM, "decode", decode)


@pytest.mark.parametrize("fault", [_stale_decode, _half_the_answers,
                                   _altered_token])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    line, checks, _ = smoke_run()
    assert not line["correct"]
    assert any(c["value"] > c["limit"] for c in checks.values())


# --- the profiler's reading --------------------------------------------------------
class _Ev:
    def __init__(self, name, start, end, dev=True):
        self._n, self._s, self._e, self._d = name, start, end, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._d
                else torch.autograd.DeviceType.CPU)


def test_trace_reading_counts_busy_time_once_and_names_idle_stretches():
    evs = [_Ev("k1", 100, 200), _Ev("k2", 150, 250),
           _Ev("copy", 600, 700), _Ev("cudaLaunchKernel", 0, 900, False),
           _Ev("k1", 750, 800)]
    r = trace.read(evs, 1e-6)
    assert r["window_s"] == 1e-6
    assert math.isclose(r["busy_s"], (150 + 100 + 50) / 1e9)
    assert math.isclose(r["idle"]["before copy"], 350 / 1e9)
    assert math.isclose(r["idle"]["before k1"], 50 / 1e9)
    assert math.isclose(r["idle"]["edges"], (1000 - 700) / 1e9)
    assert r["ops"]["k1"] == (150 / 1e9, 2)
    assert "cudaLaunchKernel" not in r["ops"]
    b = trace.breakdown({"decode": r, "prefill": trace.read(
        [_Ev("flash_fwd_kernel", 0, 5000)], 1e-5)})
    assert b["device_ops"][0] == ["prefill: flash_fwd_kernel", 5e-6]
    assert b["idle_gaps"][0] == ["prefill: edges", 5e-6]
    assert len(b["idle_gaps"]) == 4
    assert trace.read([_Ev("k", 0, 1, False)], 1.0) == {}


# --- imports ---------------------------------------------------------------------
def _top_level_imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        names = _top_level_imports(f)
        assert not names & set(result.FORBIDDEN), f
        if f.parent.name in ("reference", "harness", "metrics"):
            assert "repro_torch" not in names, f


def test_the_module_guard_compares_whole_top_level_names():
    assert result.forbidden_modules(["repro_torch", "repro_torch.models",
                                     "reproducible", "jaxtyping"]) == []
    assert result.forbidden_modules(["repro.models", "jax", "jaxlib.xla",
                                     "flax"]) == ["flax", "jax", "jaxlib.xla",
                                                  "repro.models"]


def test_run_without_a_card_or_without_the_program_prints_no_result(
        tmp_path):
    cmd = [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
           str(SEED), "--seconds", "1", "--trace", "0"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


# --- on the card -----------------------------------------------------------------
@pytest.mark.gpu
def test_on_the_card_the_program_passes_and_the_control_fails():
    """Three seeds at the cell's own size: each within every limit, the
    fp8 control beyond one of them (about five minutes on an H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = cells.cell(CELL)
    for seed in (SEED, SEED + 1, SEED + 2):
        line, checks, numbers = cell.driver.run(cell, seed, 0.0, False,
                                                time.time(), control=True)
        assert line["correct"], checks
        assert any(numbers[f"control_{k}"] > lim
                   for k, lim in cell.limits.items()
                   if f"control_{k}" in numbers)
