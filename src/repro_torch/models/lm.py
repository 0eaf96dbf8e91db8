"""The dense language model of the port — port of the ``dense`` segment of
``repro.models.lm``: embedding, n blocks of GQA attention + swiglu/geglu
FFN, final RMSNorm, unembedding, with the reference's prefill / decode /
init_cache semantics (lm.py:464-502).

The reference stacks each segment's parameters on axis 0 and scans them;
here the blocks are an ``nn.ModuleList``, and the converter
(``convert.lm_params_from_numpy``) unstacks the reference's pytree. The
decode cache keeps the reference's layout — ``{"len": int, "dense": {"k",
"v"}}`` with k and v of shape (n_layers, B, T, Hkv, hd) — and is updated
in place: a cache handed to ``decode`` is the one it returns.

``loss`` is the training objective (lm.py:454-461): next-token
cross-entropy over ``tokens[:, :-1]``, chunked by 1024 positions, with
each block recomputed in the backward (``torch.utils.checkpoint``) when
``cfg.remat``, as ``jax.checkpoint`` does in the reference's scan.

Only the dense segment is ported; MoE, MLA, hybrid, SSM, VLM and
encoder-decoder configurations raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention, attn_shapes, dot_f32,
                                       dtype_of, ffn, ffn_shapes, frozen,
                                       init_dense, rmsnorm)


def _unported_kind(cfg: ModelConfig) -> str | None:
    """The reference segment kind this config needs, where the port has
    not got it yet."""
    if cfg.rwkv:
        return "rwkv"
    if cfg.enc_dec:
        return "enc/dec"
    if cfg.ssm_state:
        return "mamba"
    if cfg.cross_attn_every:
        return "vlm_group"
    if cfg.is_moe:
        return "mla_moe" if cfg.use_mla else "moe"
    if cfg.use_mla:
        return "mla_dense"
    return None


class Block(nn.Module):
    """One dense block's weights: x + attention(rmsnorm(x)), then
    + ffn(rmsnorm(x)). ``attn`` holds wq, wk, wv, wo and ``ffn`` w1, w3,
    w2, in the reference's (d_in, d_out) layout."""

    def __init__(self, attn: dict, ffn: dict, ln1: torch.Tensor,
                 ln2: torch.Tensor):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.attn = frozen(attn)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        self.ffn = frozen(ffn)


class LM(nn.Module):
    """Dense LM on one device. ``seed`` draws the weights on that device
    from a ``torch.Generator`` one tensor at a time (not JAX's bits);
    ``seed=None`` leaves them uninitialised for a converter to fill.
    ``device=None`` is the card. ``trainable=True`` gives every parameter
    ``requires_grad`` (training); the default serves, without gradients."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int | None = 0,
                 trainable: bool = False):
        super().__init__()
        kind = _unported_kind(cfg)
        if kind is not None:
            raise NotImplementedError(
                f"{cfg.arch_id}: segment kind {kind!r} is not ported yet "
                f"(ROADMAP Queue 1 item 5, models/lm.py); only 'dense' is")
        self.cfg = cfg
        dev = resolve_device(device)
        dt = dtype_of(cfg)
        D, V = cfg.d_model, cfg.vocab
        gen = (None if seed is None
               else torch.Generator(device=dev).manual_seed(seed))
        if gen is None:
            embed = torch.empty((V, D), dtype=dt, device=dev)
        else:
            embed = torch.randn((V, D), generator=gen, device=dev,
                                dtype=torch.float32).mul_(0.02).to(dt)
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_ln = nn.Parameter(
            torch.ones(D, dtype=torch.float32, device=dev), requires_grad=False)
        self.lm_head = None
        if not cfg.tie_embeddings:
            head = init_dense(gen, {"w": (D, V)}, cfg, dev)["w"]
            self.lm_head = nn.Parameter(head, requires_grad=False)
        self.blocks = nn.ModuleList(
            Block(init_dense(gen, attn_shapes(cfg), cfg, dev),
                  init_dense(gen, ffn_shapes(cfg), cfg, dev),
                  torch.ones(D, dtype=torch.float32, device=dev),
                  torch.ones(D, dtype=torch.float32, device=dev))
            for _ in range(cfg.n_layers))
        self.requires_grad_(trainable)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # --- cache ---------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int) -> dict:
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
        dt = dtype_of(cfg)
        return {"len": 0,
                "dense": {"k": torch.zeros(shape, dtype=dt, device=self.device),
                          "v": torch.zeros(shape, dtype=dt,
                                           device=self.device)}}

    # --- forward -------------------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _block(self, blk: Block, x: torch.Tensor, positions: torch.Tensor,
               cache: dict | None = None) -> torch.Tensor:
        """One block: x + attention(rmsnorm(x)), then + ffn(rmsnorm(x));
        a decode ``cache`` ({k, v, len} of this block) is written in
        place."""
        cfg = self.cfg
        h, _ = attention(blk.attn, cfg, rmsnorm(x, blk.ln1, cfg.norm_eps),
                         positions=positions, cache=cache)
        x = x + h
        return x + ffn(blk.ffn, cfg, rmsnorm(x, blk.ln2, cfg.norm_eps))

    def _forward(self, tokens: torch.Tensor, cache: dict,
                 pos: int) -> torch.Tensor:
        """Hidden states (B, S, D) of ``tokens`` at positions pos + arange(S),
        writing their k/v into ``cache`` at ``pos``."""
        x = self.embed[tokens]
        positions = pos + torch.arange(tokens.shape[1], device=self.device)
        kc, vc = cache["dense"]["k"], cache["dense"]["v"]
        for i, blk in enumerate(self.blocks):
            x = self._block(blk, x, positions,
                            {"k": kc[i], "v": vc[i], "len": pos})
        return x

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, self.final_ln, self.cfg.norm_eps)
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return dot_f32(x, w)

    @torch.no_grad()
    def prefill(self, tokens, max_len: int) -> tuple[torch.Tensor, dict]:
        """Run the whole prompt (B, S) and build a decode cache of length
        ``max_len``. Returns (last-position logits (B, V) float32, cache)."""
        tokens = self._tokens(tokens)
        B, S = tokens.shape
        cache = self.init_cache(B, max_len)
        x = self._forward(tokens, cache, 0)
        cache["len"] = S
        return self._unembed(x[:, -1:, :])[:, 0], cache

    @torch.no_grad()
    def decode(self, cache: dict, tokens) -> tuple[torch.Tensor, dict]:
        """One decode step for tokens (B,) at position ``cache["len"]``,
        the same for every row. Returns (logits (B, V) float32, cache)."""
        tokens = self._tokens(tokens)
        pos = int(cache["len"])
        x = self._forward(tokens[:, None], cache, pos)
        new_cache = {"len": pos + 1, "dense": cache["dense"]}
        return self._unembed(x)[:, 0], new_cache

    # --- training ------------------------------------------------------------
    def decays(self) -> dict[str, bool]:
        """Which parameters take AdamW's decoupled weight decay. The
        reference decays leaves with ``ndim >= 2`` (adamw.py:136), and its
        per-block leaves are stacked (n_layers, ...): every block parameter
        here, the 1-d norm gammas included, is one slice of such a leaf and
        decays. ``final_ln`` (D,) does not."""
        return {name: p.dim() >= 2 or name.startswith("blocks.")
                for name, p in self.named_parameters()}

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """Hidden states (B, S, D) of ``tokens`` over the whole sequence,
        without a cache (the reference's ``mode="full"``); each block is
        recomputed in the backward when ``cfg.remat``."""
        x = self.embed[tokens]
        positions = torch.arange(tokens.shape[1], device=self.device)
        for blk in self.blocks:
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpoint(self._block, blk, x, positions,
                               use_reentrant=False)
            else:
                x = self._block(blk, x, positions)
        return x

    def _chunked_ce(self, hidden: torch.Tensor, targets: torch.Tensor,
                    chunk: int = 1024) -> torch.Tensor:
        """Mean cross-entropy with the float32 logits made ``chunk``
        positions at a time (the reference's ``_chunked_ce``, every
        position valid)."""
        B, S, _ = hidden.shape
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(0, S, chunk):
            logits = self._unembed(hidden[:, i:i + chunk])       # float32
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                targets[:, i:i + chunk, None])[..., 0]
            total = total + torch.sum(lse - gold)
        return total / max(B * S, 1)

    def loss(self, tokens) -> tuple[torch.Tensor, dict]:
        """Next-token loss of ``tokens`` (B, S): the model reads
        ``tokens[:, :-1]`` and predicts ``tokens[:, 1:]``. Returns
        ``(total, {"ce", "aux"})``; a dense model has no auxiliary loss, so
        ``total = ce + 0.01 * 0``."""
        tokens = self._tokens(tokens)
        hidden = self.hidden(tokens[:, :-1])
        ce = self._chunked_ce(hidden, tokens[:, 1:])
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}
