"""The yardstick's arithmetic: the chip's peaks, and the work a model and
a kernel need, counted from shapes (what the model needs, not what an
implementation happens to compute).

Peaks are NVIDIA's data sheet for the H100 SXM part (dense rates, at its
700 W limit). The attention pairs and the flash-attention bound are
copied from the repository's ``chip_smoke.py`` (``attention_pairs``,
``bound``).
"""
from __future__ import annotations

from harness.weights import dims

BF16_FLOPS = 989e12        # dense bf16 tensor cores
FP32_FLOPS = 67e12         # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def attention_pairs(s: int, window: int | None, causal: bool = True) -> int:
    """Valid (query, key) pairs of an s x s causal (optionally windowed)
    or bidirectional mask."""
    if not causal:
        return s * s
    if window is None:
        return s * (s + 1) // 2
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def bound_s(nbytes: float, flops: float, peak: float = BF16_FLOPS) -> float:
    """Least time of the work on the chip (s): the larger of its bytes at
    the memory's rate and its operations at ``peak``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def flash_fwd_bound_s(b: int, h: int, hkv: int, s: int, d: int,
                      window: int | None, elt: int = 2) -> float:
    """The forward flash-attention call's bound: 4 d operations a valid
    pair and head (q.k and p.v), q, k, v and out read or written once at
    ``elt`` bytes, and the float32 log-sum-exp."""
    flops = 4 * d * b * h * attention_pairs(s, window)
    nbytes = (2 * b * h * s * d + 2 * b * hkv * s * d) * elt + b * h * s * 4
    return bound_s(nbytes, flops)


def token_flops(cfg: dict) -> tuple[int, int, int]:
    """(per token through the layers, per logits row, per attended pair)
    model FLOPs of a GQA mixture-of-experts LM: 2 a multiply-add over the
    active weights (the attention projections, the router, top-k experts),
    the unembedding only where a token's logits are needed, and 4 hd a
    (query, key) pair and head."""
    z = dims(cfg)
    D, H, Hkv, hd, F, E, K, V, L = (z[k] for k in
                                    ("D", "H", "Hkv", "hd", "F", "E", "K",
                                     "V", "L"))
    attn = D * (H + 2 * Hkv) * hd + H * hd * D
    per_token = 2 * L * (attn + D * E + K * 3 * D * F)
    return per_token, 2 * D * V, 4 * hd * H * L


def served_flops(cfg: dict, prompt_len: int, n_out: int) -> int:
    """Model FLOPs of one served request: its prompt (padding not counted)
    and its n_out - 1 fed-back tokens through the layers, n_out logits
    rows, and causal attention over its own tokens (a decoded token
    attends to every earlier one; ``sliding_window`` bounds it)."""
    per_token, per_row, per_pair = token_flops(cfg)
    w = cfg.get("sliding_window")
    p, n = prompt_len, max(n_out, 1)
    pairs = attention_pairs(p, w)
    pairs += sum(min(p + j, w or p + j) for j in range(1, n))
    return (p + n - 1) * per_token + n * per_row + pairs * per_pair
