"""The one traffic generator: a mix's parameters in, requests out.

A closed loop of ``clients`` callers, each with one request in flight,
on an engine of ``slots`` slots (``clients == slots``: every wave holds
one request of every client, and the next wave the next ones). Prompt
and output lengths follow the mix's distributions, drawn stratified: a
wave's lengths are the distribution's quantiles at (i + 0.5) / n, for
i < n = clients, so every wave of every seed holds the same multiset of
lengths, and the seed decides only which client gets which length, how
prompt and output lengths pair, and the token ids. Seeds then change
the order of the work, not its amount.

Distributions: ``{"dist": "lognormal", "median", "sigma", "min",
"max"}`` (rounded, then clipped) or ``{"dist": "fixed", "value"}``.
"""
from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np

WARMUP_INDEX = -1


@dataclasses.dataclass
class Req:
    client: int
    prompt: np.ndarray      # (S,) int32
    max_new: int


def quantiles(dist: dict, n: int) -> list[int]:
    """The n stratified lengths of ``dist``, ascending."""
    if dist["dist"] == "fixed":
        return [int(dist["value"])] * n
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    z = statistics.NormalDist()
    return [min(int(dist["max"]), max(int(dist["min"]), round(
        dist["median"] * math.exp(dist["sigma"] * z.inv_cdf((i + .5) / n)))))
        for i in range(n)]


def rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, index % 2 ** 64])


def wave(spec: dict, seed: int, index: int, vocab: int) -> list[Req]:
    """Wave ``index`` of the mix under ``seed``: one request a client.
    The warm-up wave (``WARMUP_INDEX``) has the same prompt lengths and
    at most ``warmup_new_tokens`` output tokens."""
    n = int(spec["clients"])
    g = rng(seed, index)
    plens = g.permutation(quantiles(spec["prompt_tokens"], n))
    news = g.permutation(quantiles(spec["output_tokens"], n))
    if index == WARMUP_INDEX:
        news = np.minimum(news, int(spec["warmup_new_tokens"]))
    low = int(spec["token_ids"]["low"])
    return [Req(c, g.integers(low, vocab, int(s)).astype(np.int32), int(m))
            for c, (s, m) in enumerate(zip(plens, news))]


def max_len(spec: dict) -> int:
    """The longest row a wave can make: prompt and output at their tops."""
    n = int(spec["clients"])
    return (max(quantiles(spec["prompt_tokens"], n))
            + max(quantiles(spec["output_tokens"], n)))
