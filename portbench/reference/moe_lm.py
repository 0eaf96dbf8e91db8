"""A GQA mixture-of-experts language model served in waves, in plain
PyTorch and float32 (Mixtral's block: RMSNorm, rotary attention over
grouped kv heads with an optional sliding window, a softmax router over
E experts choosing the top K, SwiGLU experts), with the serving
semantics the benchmark's engine states:

* a wave's prompts are left-padded with token 0 to the longest, the pads
  are attended like any token, and every row takes positions 0..S-1;
* decoding feeds one token a row at the cache's length, the same for
  every row;
* experts are dropless: every token goes to its K chosen experts, its
  gates renormalised over them. Ties in the router go to the lower
  expert index.

The wave's pads are one token at every position before its first real
one, so they attend only to pads and all hold one state. Where the
router's K-th and (K+1)-th logits of that state lie within rounding of a
tie, bf16 and float32 may route every pad differently, and every row
attends to them. ``pad_flip`` (layers) routes the pads to their (K+1)-th
expert in place of their K-th in those layers, and each prefill records
the pads' margin between the two logits a layer in ``pad_margin``: the
judgement replays such a wave on both branches.

``control=True`` runs every product of weights stored in bfloat16 in
fp8 (e4m3) instead: each weight column and each activation row scaled to
e4m3's range and rounded, then multiplied in float32. The router stays
float32, as the configuration states it.

Matrix products run in float32 proper: TF32 is switched off while a
reference runs (``exact_float32``).
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3, scaled along ``dim`` by its largest
    magnitude, returned in float32."""
    scale = t.abs().amax(dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def rmsnorm(x, g, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def rope(x, pos, theta):
    """Rotate-half rotary embedding of x (B, S, H, d) at positions (S,)."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                         dtype=torch.float32) / d)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class MoeLM:
    """``w``: the served weights in float32, by the benchmark's leaf names
    (``harness.weights``)."""

    def __init__(self, cfg: dict, w: dict, control: bool = False,
                 attn_rows: int = 4, expert_rows: int = 8192):
        self.cfg, self.control = cfg, control
        self.attn_rows, self.expert_rows = attn_rows, expert_rows
        self.D = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.Hkv = cfg["num_key_value_heads"]
        self.hd = cfg.get("head_dim") or self.D // self.H
        self.E = cfg["num_local_experts"]
        self.K = cfg["num_experts_per_tok"]
        self.L = cfg["num_hidden_layers"]
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]
        self.window = cfg.get("sliding_window")
        self.w = w
        self.pad_flip, self.pad_margin = frozenset(), {}
        if control:
            self.w = {k: (fp8(v, v.dim() - 2) if _product(k) else v)
                      for k, v in w.items()}

    def mm(self, x, w):
        if self.control:
            x = fp8(x, -1)
        return x @ w

    # --- blocks --------------------------------------------------------------
    def _qkv(self, i, x, pos):
        p = f"layers.{i}.attn."
        B, S, _ = x.shape
        q = self.mm(x, self.w[p + "wq"]).view(B, S, self.H, self.hd)
        k = self.mm(x, self.w[p + "wk"]).view(B, S, self.Hkv, self.hd)
        v = self.mm(x, self.w[p + "wv"]).view(B, S, self.Hkv, self.hd)
        return rope(q, pos, self.theta), rope(k, pos, self.theta), v

    def _attend(self, q, k, v, qpos):
        """q (b, s, H, hd) at positions qpos over k, v (b, t, Hkv, hd) at
        positions 0..t-1, causal and windowed."""
        g = self.H // self.Hkv
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
        logits = torch.einsum("bshd,bthd->bhst", q, k) * self.hd ** -0.5
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        qi = qpos[:, None]
        mask = ki <= qi
        if self.window is not None:
            mask &= ki > qi - self.window
        logits = logits.masked_fill(~mask, float("-inf"))
        return torch.einsum("bhst,bthd->bshd", torch.softmax(logits, -1), v)

    def _moe(self, i, y, pad=None):
        """y (B, S, D); ``pad`` (B, S) marks the wave's pads (prefill)."""
        B, S, D = y.shape
        p = f"layers.{i}.moe."
        K = self.K
        x = y.reshape(B * S, D)
        logits = x @ self.w[p + "router"]
        gates = torch.softmax(logits, dim=-1)
        sel = gates + self.w[p + "router_bias"]
        order = torch.sort(sel, dim=-1, descending=True, stable=True)[1]
        idx = order[:, :K]
        if pad is not None and bool(pad.any()):
            pads = pad.reshape(-1)
            top = torch.gather(logits[pads], 1, order[pads, K - 1:K + 1])
            m = float((top[:, 0] - top[:, 1]).min())
            self.pad_margin[i] = min(m, self.pad_margin.get(i, m))
            if i in self.pad_flip:
                idx = idx.clone()
                idx[pads, K - 1] = order[pads, K]
        gate = torch.gather(gates, 1, idx)
        gate = gate / gate.sum(-1, keepdim=True)
        out = torch.zeros_like(x)
        for e in range(self.E):
            te, ke = torch.nonzero(idx == e, as_tuple=True)
            # in blocks of rows: the pads alone may send most of a
            # wave's tokens to one expert
            for j in range(0, te.numel(), self.expert_rows):
                t, k = te[j:j + self.expert_rows], ke[j:j + self.expert_rows]
                xe = x[t]
                h = self.mm(xe, self.w[p + "w1"][e])
                h = h * torch.sigmoid(h) * self.mm(xe, self.w[p + "w3"][e])
                out.index_add_(0, t, self.mm(h, self.w[p + "w2"][e])
                               * gate[t, k, None])
        return out.reshape(B, S, D)

    def _logits(self, x):
        return self.mm(rmsnorm(x, self.w["final_ln"], self.eps),
                       self.w["lm_head"])

    # --- serving -------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int, pad=None):
        """tokens (B, S), already padded (``pad`` (B, S) marks the pads).
        Returns (last-position logits (B, V), cache)."""
        self.pad_margin = {}
        with exact_float32():
            B, S = tokens.shape
            pos = torch.arange(S, device=tokens.device)
            x = self.w["embed"][tokens]
            cache = {"len": S, "k": [], "v": []}
            for i in range(self.L):
                p = f"layers.{i}."
                h = rmsnorm(x, self.w[p + "ln1"], self.eps)
                q, k, v = self._qkv(i, h, pos)
                ck = k.new_zeros(B, max_len, self.Hkv, self.hd)
                cv = torch.zeros_like(ck)
                ck[:, :S], cv[:, :S] = k, v
                cache["k"].append(ck)
                cache["v"].append(cv)
                r = self.attn_rows
                a = torch.cat([self._attend(q[b:b + r], k[b:b + r],
                                            v[b:b + r], pos)
                               for b in range(0, B, r)])
                x = x + self.mm(a.reshape(B, S, -1), self.w[p + "attn.wo"])
                x = x + self._moe(i, rmsnorm(x, self.w[p + "ln2"], self.eps),
                                  pad)
            return self._logits(x[:, -1]), cache

    @torch.no_grad()
    def decode(self, cache: dict, tokens: torch.Tensor):
        """One token a row (B,) at position ``cache["len"]``; the cache is
        written in place. Returns (logits (B, V), cache)."""
        with exact_float32():
            n = cache["len"]
            pos = torch.tensor([n], device=tokens.device)
            x = self.w["embed"][tokens][:, None]
            for i in range(self.L):
                p = f"layers.{i}."
                h = rmsnorm(x, self.w[p + "ln1"], self.eps)
                q, k, v = self._qkv(i, h, pos)
                cache["k"][i][:, n], cache["v"][i][:, n] = k[:, 0], v[:, 0]
                a = self._attend(q, cache["k"][i][:, :n + 1],
                                 cache["v"][i][:, :n + 1], pos)
                x = x + self.mm(a.reshape(x.shape[0], 1, -1),
                                self.w[p + "attn.wo"])
                x = x + self._moe(i, rmsnorm(x, self.w[p + "ln2"], self.eps))
            cache["len"] = n + 1
            return self._logits(x[:, 0]), cache


def _product(name: str) -> bool:
    """Weights the configuration stores in bfloat16 and multiplies by."""
    return name.endswith(("wq", "wk", "wv", "wo", "w1", "w3", "w2",
                          "lm_head"))
