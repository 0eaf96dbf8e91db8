"""The serving path: waves of a closed loop of clients through the
program's ``serve.engine.Engine`` (``run_wave``), on one card.

Set-up builds the program's model (``repro_torch.models.lm.LM``, its
``ModelConfig`` made from the configuration file and checked against the
program's registry), draws its weights from the seed into its parameters
(``harness.weights``), and serves one warm-up wave of the mix's own
prompt lengths. The window then serves waves back to back until
``seconds`` have passed, ending on a wave's end. The model handed to the
engine is wrapped to take the host's clock at each ``prefill`` and
``decode`` call (the engine reads the last tokens to the host before
each decode call); the program is not changed.

After the window (and, with ``trace``, one more wave whose prefill and
decode calls ``TRACED_DECODE`` the profiler reads, device activity
only), the program is freed and the reference (``reference.moe_lm``
in float32) replays one window wave drawn from the seed, judging every
token served in it (``reference.served``).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time

import numpy as np
import torch

from harness import result, trace, traffic, weights
from harness.cells import Cell, reader
from reference import moe_lm, served

# the traced wave's decode calls [first, last) whose device time the idle
# share reads: steady lockstep steps, past the prefill
TRACED_DECODE = (16, 144)

WIDTHS = ("d_model", "n_heads", "n_kv_heads", "head_dim", "moe_d_ff", "vocab",
          "n_experts", "top_k", "rope_theta")


def model_config(c: dict):
    """The program's ``ModelConfig`` of configuration file ``c``; where
    the file names a registry architecture, every width it states must be
    the registry's. The reference routes dropless, so the file's capacity
    factor has to give every expert room for every token (f K >= E)."""
    from repro_torch.configs import registry
    from repro_torch.models.config import ModelConfig
    z = weights.dims(c)
    stated = dict(
        n_layers=z["L"], d_model=z["D"], n_heads=z["H"], n_kv_heads=z["Hkv"],
        head_dim=z["hd"], d_ff=z["F"], moe_d_ff=z["F"], vocab=z["V"],
        n_experts=z["E"], top_k=z["K"], rope_theta=c["rope_theta"],
        norm_eps=c["rms_norm_eps"], attn_window=c.get("sliding_window"),
        capacity_factor=c["capacity_factor"], dtype=c["torch_dtype"],
        tie_embeddings=c["tie_word_embeddings"])
    cfg = ModelConfig(arch_id=c.get("registry_arch") or "portbench",
                      family="moe", attn_impl="flash", **stated)
    if c.get("registry_arch"):
        reg = registry.config(c["registry_arch"])
        for k in WIDTHS:
            v = stated[k]
            if getattr(reg, k) != v and not (k == "head_dim" and reg.hd == v):
                raise ValueError(f"{k}: the file states {v}, the program's "
                                 f"registry {getattr(reg, k)}")
    if cfg.capacity_factor * cfg.top_k < cfg.n_experts:
        raise ValueError(f"capacity factor {cfg.capacity_factor} drops "
                         "tokens; the configuration routes dropless")
    return cfg


def build(c: dict, seed: int, dev):
    """The program's model with the benchmark's weights."""
    from repro_torch.models.lm import LM
    model = LM(model_config(c), device=dev, seed=None)
    params = dict(model.named_parameters())
    names = {n: n.replace("layers.", "blocks.", 1)
             for n, *_ in weights.leaves(c)}
    if sorted(names.values()) != sorted(params):
        raise ValueError("the program's parameters are not the "
                         "configuration's leaves")
    weights.fill(c, seed, dev, lambda n, s, d: params[names[n]].data)
    return model


class Timed:
    """The model as the engine sees it, with the host's clock read at each
    call. Where ``traced`` is set, the next wave's prefill call and its
    decode calls ``TRACED_DECODE`` are each a profiled stretch."""

    def __init__(self, model):
        self.model, self.traced = model, None
        self.reset()

    def reset(self):
        self.prefill_at, self.decode_at, self.fed = None, [], []

    def prefill(self, batch, max_len):
        self.prefill_at = time.perf_counter()
        if not self.traced:
            return self.model.prefill(batch, max_len)
        self.traced["prefill"].start()
        out = self.model.prefill(batch, max_len)
        self.traced["prefill"].stop()
        return out

    def decode(self, cache, tokens):
        if self.traced:
            d, n = self.traced["decode"], len(self.decode_at)
            if n == TRACED_DECODE[0]:
                d.start()
            elif n == TRACED_DECODE[1] and d.running:
                d.stop()
        self.decode_at.append(time.perf_counter())
        self.fed.append(tokens)
        return self.model.decode(cache, tokens)


def host_times() -> tuple[float, float]:
    """(seconds this process has run on a CPU, seconds its main thread
    has waited for one), where Linux gives them (zeros elsewhere)."""
    try:
        _, wait, _ = open("/proc/self/schedstat").read().split()
    except (OSError, ValueError):
        wait = 0
    return time.process_time(), int(wait) / 1e9


@dataclasses.dataclass
class Wave:
    reqs: list
    tokens: dict           # client -> served tokens (np.int32)
    prefill_at: float
    arrivals: list         # host time each step's tokens were on the host
    end: float
    fed: np.ndarray        # (decode calls, slots): the tokens each call took
    host: tuple            # (CPU s, s waiting for a CPU) over the wave


def serve_wave(engine, timed, reqs) -> Wave:
    from repro_torch.serve.engine import Request
    timed.reset()
    h0 = host_times()
    res = engine.run_wave([Request(uid=r.client, prompt=r.prompt,
                                   max_new_tokens=r.max_new) for r in reqs])
    end = time.perf_counter()
    h1 = host_times()
    if timed.traced and timed.traced["decode"].running:
        timed.traced["decode"].stop()
    fed = (torch.stack([torch.as_tensor(t) for t in timed.fed]).cpu().numpy()
           if timed.fed else np.zeros((0, len(reqs)), np.int64))
    return Wave(reqs, {r.uid: r.tokens for r in res}, timed.prefill_at,
                timed.decode_at + [end], end, fed,
                tuple(b - a for a, b in zip(h0, h1)))


def answered(w: Wave, row: int, r, eos: int) -> bool:
    """A request's answer came, ends at its budget or its first eos, and
    is the tokens the engine fed back for it."""
    t = w.tokens.get(r.client)
    return (t is not None and served.well_formed(t, r.max_new, eos)
            and np.array_equal(w.fed[:len(t) - 1, row], t[:-1]))


def itl_gaps(waves: list[Wave]) -> np.ndarray:
    """Every gap between a request's successive output tokens (s): token
    k is on the host when decode call k + 1 starts (the wave's end for the
    last)."""
    out = []
    for w in waves:
        a = np.asarray(w.arrivals)
        for toks in w.tokens.values():
            out.append(np.diff(a[:len(toks)]))
    return np.concatenate(out)


def run(cell: Cell, seed: int, seconds: float, traced: bool, t0: float,
        device=None, control: bool = False) -> tuple[dict, dict, dict]:
    """One run of ``cell``: (result line, checks, every number the
    judgement read). ``control`` adds the fp8 reference's numbers in the
    program's place (``control_*``), which the benchmark's own runs do
    not read."""
    dev = torch.device(device or "cuda")
    c, spec = cell.config, cell.traffic
    if dev.type == "cuda":
        # the program's serving entry point's settings (launch.serve)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    t_build = time.time()
    model = build(c, seed, dev)
    sync(dev)
    t_warm = time.time()
    timed = Timed(model)
    from repro_torch.serve.engine import Engine, Request
    eos = Request(uid=0, prompt=np.zeros(1, np.int32)).eos_id
    vocab = c["vocab_size"]
    engine = Engine(timed, batch_slots=int(spec["slots"]),
                    max_len=traffic.max_len(spec))
    serve_wave(engine, timed, traffic.wave(spec, seed, traffic.WARMUP_INDEX,
                                           vocab))
    sync(dev)
    gc.collect()
    setup_peak = peak(dev, reset=True)
    setup_s = time.time() - t0
    print(f"setup_s={setup_s:.3f}: to the driver {t_build - t0:.3f}, model "
          f"and weights {t_warm - t_build:.3f}, warm-up wave "
          f"{t0 + setup_s - t_warm:.3f}", file=sys.stderr)

    waves, start = [], time.perf_counter()
    while not waves or waves[-1].end - start < seconds:
        waves.append(serve_wave(engine, timed, traffic.wave(
            spec, seed, len(waves), vocab)))
    window_s = waves[-1].end - start
    window_peak = peak(dev)

    readings, traced_reqs = None, []
    if traced and dev.type == "cuda":
        traced_reqs = traffic.wave(spec, seed, len(waves), vocab)
        timed.traced = {"prefill": trace.Stretch(), "decode": trace.Stretch()}
        serve_wave(engine, timed, traced_reqs)
        readings = {k: v.reading for k, v in timed.traced.items()
                    if v.reading}
    del engine, timed, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    n_tokens = sum(len(t) for w in waves for t in w.tokens.values())
    bad = sum(not answered(w, i, r, eos) for w in waves
              for i, r in enumerate(w.reqs))
    attempted = sum(len(w.reqs) for w in waves)

    itl = itl_gaps(waves)
    print(f"waves={len(waves)} wave_s="
          f"{[round(w.end - w.prefill_at, 4) for w in waves]} cpu_s="
          f"{[round(w.host[0], 4) for w in waves]} cpu_wait_s="
          f"{[round(w.host[1], 4) for w in waves]} itl_ms_q50_90_95"
          f"_99={np.round(np.quantile(itl, [.5, .9, .95, .99]) * 1e3, 3)}",
          file=sys.stderr)
    judged = waves[int(traffic.rng(seed, 2 ** 32 + 1).integers(len(waves)))]
    t = time.perf_counter()
    numbers = judge(c, seed, dev, judged, control)
    print(f"judged in {time.perf_counter() - t:.1f} s: "
          f"{json.dumps(numbers)}", file=sys.stderr)
    numbers["bad_answers"] = bad
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in cell.limits.items()}
    correct = all(ch["value"] <= ch["limit"] for ch in checks.values())

    ctx = dict(cell=cell, config=c, waves=waves, window_s=window_s,
               window_peak=window_peak, readings=readings or {}, setup_s=setup_s,
               traced_reqs=traced_reqs,
               itl_s=itl, n_tokens=n_tokens)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = result.metric(v, m["unit"])
    line = {"correct": bool(correct), "attempted": attempted, "failed": bad,
            "metrics": metrics,
            "device": result.device(1, max(setup_peak, window_peak),
                                    (readings or {}).get("decode"))
            if dev.type == "cuda" else {"platform": dev.type, "count": 1}}
    if readings:
        line["breakdown"] = trace.breakdown(readings)
    return line, checks, numbers


def judge(c: dict, seed: int, dev, wave: Wave, control: bool) -> dict:
    """The gap numbers of every token served in ``wave`` against the
    float32 reference (and, where ``control``, the fp8 reference's in the
    program's place, as ``control_<number>``)."""
    prompts = [r.prompt for r in wave.reqs]
    toks = [wave.tokens.get(r.client, np.zeros(0, np.int32))
            for r in wave.reqs]
    if not any(len(t) for t in toks):
        return dict.fromkeys(("max_gap", "mean_gap", "share_missed"),
                             float("inf"))
    w = weights.make(c, seed, dev, dtype=torch.float32)
    ref = moe_lm.MoeLM(c, w)
    g, kept, branch = served.gaps(ref, prompts, toks, wave.fed, dev,
                                  keep=control)
    out = served.numbers(g)
    out["pad_branch"] = sorted(branch)
    if control:
        lower = moe_lm.MoeLM(c, w, control=True)
        del ref, w
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        cg = served.control_gaps(lower, kept, prompts, toks, wave.fed, dev,
                                 branch)
        out.update({f"control_{k}": v
                    for k, v in served.numbers(cg).items()})
    return out


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak(dev, reset: bool = False) -> int:
    if dev.type != "cuda":
        return 0
    p = torch.cuda.max_memory_allocated(dev)
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return p
