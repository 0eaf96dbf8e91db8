"""The language model of the port — port of ``repro.models.lm`` for the
segment kinds ``dense``, ``moe``, ``mla_dense`` and ``mla_moe``:
embedding, the segments' blocks, final RMSNorm, unembedding, with the
reference's prefill / decode / init_cache semantics (lm.py:464-502).

A model is a sequence of segments (``segments_for``, as the reference's):
llama3-8b and gemma-7b one ``dense`` segment, mixtral-8x7b one ``moe``
segment (GQA attention + MoE FFN), deepseek-v3-671b a ``dense_prefix`` of
``mla_dense`` blocks (MLA + dense FFN) then a ``moe`` segment of
``mla_moe`` blocks (MLA + MoE with a shared expert). The reference stacks
each segment's parameters on axis 0 and scans them; here the blocks of all
segments are one ``nn.ModuleList`` in order, named ``blocks.<i>.<leaf>``,
and the converter (``convert.lm_params_from_numpy``) unstacks the
reference's pytree. The decode cache keeps the reference's layout — ``{"len":
int, <segment name>: {"k", "v"}}`` (GQA kinds; (n_blocks, B, T, Hkv, hd))
or ``{"kv_c", "k_rope"}`` (MLA kinds; (n_blocks, B, T, R) and (n_blocks,
B, T, dr)) — and is updated in place: a cache handed to ``decode`` is the
one it returns.

``loss`` is the training objective (lm.py:454-461): next-token
cross-entropy over ``tokens[:, :-1]``, chunked by 1024 positions, plus
0.01 times the MoE blocks' summed load-balancing loss, with each block
recomputed in the backward (``torch.utils.checkpoint``) when
``cfg.remat``, as ``jax.checkpoint`` does in the reference's scan.

Hybrid, SSM, VLM and encoder-decoder configurations raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention, attn_shapes, dot_f32,
                                       dtype_of, ffn, ffn_shapes, frozen,
                                       init_dense, mla_attention, mla_shapes,
                                       rmsnorm)

PORTED_KINDS = ("dense", "moe", "mla_dense", "mla_moe")


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    kind: str
    n_blocks: int


def segments_for(cfg: ModelConfig) -> list[Segment]:
    """The reference's segments of ``cfg`` (lm.py:44-69)."""
    if cfg.rwkv:
        return [Segment("rwkv", "rwkv", cfg.n_layers)]
    if cfg.enc_dec:
        return [Segment("enc", "enc", cfg.n_encoder_layers),
                Segment("dec", "dec", cfg.n_layers)]
    if cfg.ssm_state and cfg.attn_every:
        n_groups = cfg.n_layers // cfg.attn_every
        rest = cfg.n_layers - n_groups * cfg.attn_every
        segs = [Segment("mamba_group", "mamba_group", n_groups)]
        if rest:
            segs.append(Segment("mamba_tail", "mamba", rest))
        return segs
    if cfg.cross_attn_every:
        assert cfg.n_layers % cfg.cross_attn_every == 0
        return [Segment("vlm", "vlm_group",
                        cfg.n_layers // cfg.cross_attn_every)]
    if cfg.is_moe:
        segs = []
        if cfg.n_dense_layers:
            kind = "mla_dense" if cfg.use_mla else "dense"
            segs.append(Segment("dense_prefix", kind, cfg.n_dense_layers))
        kind = "mla_moe" if cfg.use_mla else "moe"
        segs.append(Segment("moe", kind, cfg.n_layers - cfg.n_dense_layers))
        return segs
    return [Segment("dense", "dense", cfg.n_layers)]


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
    return None


def _mla(kind: str) -> bool:
    return kind.startswith("mla_")


def _has_moe(kind: str) -> bool:
    return kind in ("moe", "mla_moe")


class Block(nn.Module):
    """One block's weights: x + attention(rmsnorm(x)), then
    + ffn-or-moe(rmsnorm(x)). ``attn`` holds the GQA (wq, wk, wv, wo) or
    MLA (wdq, wuq, wdkv, wkr, wuk, wuv, wo) weights, ``ffn`` w1, w3, w2
    or ``moe`` router, router_bias, w1, w3, w2 (and ``shared``), in the
    reference's (d_in, d_out) layout."""

    def __init__(self, kind: str, attn: dict, mlp: dict, ln1: torch.Tensor,
                 ln2: torch.Tensor):
        super().__init__()
        self.kind = kind
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.attn = frozen(attn)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        leaves = frozen({k: v for k, v in mlp.items() if k != "shared"})
        if "shared" in mlp:
            leaves["shared"] = frozen(mlp["shared"])
        setattr(self, "moe" if _has_moe(kind) else "ffn", leaves)


def _block(kind: str, cfg: ModelConfig, gen, dev) -> Block:
    """A block of ``kind``: attention, then FFN or MoE, drawn in that order
    (uninitialised where ``gen`` is None)."""
    D = cfg.d_model
    attn = init_dense(gen, mla_shapes(cfg) if _mla(kind) else
                      attn_shapes(cfg), cfg, dev)
    if _has_moe(kind):
        mlp = moe.moe_init(gen, cfg, dev)
    else:
        mlp = init_dense(gen, ffn_shapes(cfg), cfg, dev)
    return Block(kind, attn, mlp,
                 torch.ones(D, dtype=torch.float32, device=dev),
                 torch.ones(D, dtype=torch.float32, device=dev))


class LM(nn.Module):
    """The LM on one device. ``seed`` draws the weights on that device
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
                f"(ROADMAP Queue 1 item 5, models/lm.py); ported: "
                f"{', '.join(PORTED_KINDS)}")
        if cfg.n_dense_layers > cfg.n_layers:
            raise ValueError(f"{cfg.arch_id}: {cfg.n_dense_layers} dense "
                             f"layers > n_layers {cfg.n_layers}")
        self.cfg = cfg
        self.segments = segments_for(cfg)
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
            _block(seg.kind, cfg, gen, dev)
            for seg in self.segments for _ in range(seg.n_blocks))
        self.requires_grad_(trainable)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def segment_blocks(self):
        """(segment, [its blocks' indices in ``blocks``]) in order."""
        i = 0
        for seg in self.segments:
            yield seg, list(range(i, i + seg.n_blocks))
            i += seg.n_blocks

    # --- cache ---------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int) -> dict:
        cfg = self.cfg
        dt = dtype_of(cfg)
        cache = {"len": 0}
        for seg in self.segments:
            n = (seg.n_blocks, batch_size, max_len)
            shapes = ({"kv_c": n + (cfg.kv_lora_rank,),
                       "k_rope": n + (cfg.qk_rope_head_dim,)}
                      if _mla(seg.kind) else
                      {"k": n + (cfg.n_kv_heads, cfg.hd),
                       "v": n + (cfg.n_kv_heads, cfg.hd)})
            cache[seg.name] = {
                k: torch.zeros(s, dtype=dt, device=self.device)
                for k, s in shapes.items()}
        return cache

    # --- forward -------------------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _block(self, blk: Block, x: torch.Tensor, positions: torch.Tensor,
               cache: dict | None = None):
        """One block: x + attention(rmsnorm(x)), then + ffn-or-moe(
        rmsnorm(x)); a decode ``cache`` (this block's, with ``len``) is
        written in place. Returns (x, aux): aux is the MoE's
        load-balancing loss, 0 for a dense FFN."""
        cfg = self.cfg
        xin = rmsnorm(x, blk.ln1, cfg.norm_eps)
        if _mla(blk.kind):
            h, _ = mla_attention(blk.attn, cfg, xin, positions=positions,
                                 cache=cache)
        else:
            h, _ = attention(blk.attn, cfg, xin, positions=positions,
                             cache=cache)
        x = x + h
        y = rmsnorm(x, blk.ln2, cfg.norm_eps)
        if _has_moe(blk.kind):
            f, aux = moe.moe_ffn(blk.moe, cfg, y, cfg.moe_groups)
        else:
            f = ffn(blk.ffn, cfg, y)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + f, aux

    def _forward(self, tokens: torch.Tensor, cache: dict,
                 pos: int) -> torch.Tensor:
        """Hidden states (B, S, D) of ``tokens`` at positions pos + arange(S),
        writing their keys and values (or latents) into ``cache`` at
        ``pos``."""
        x = self.embed[tokens]
        positions = pos + torch.arange(tokens.shape[1], device=self.device)
        for seg, idx in self.segment_blocks():
            c = cache[seg.name]
            for j, i in enumerate(idx):
                x, _ = self._block(self.blocks[i], x, positions,
                                   {**{k: t[j] for k, t in c.items()},
                                    "len": pos})
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
        new_cache = {**cache, "len": pos + 1}
        return self._unembed(x)[:, 0], new_cache

    # --- training ------------------------------------------------------------
    def decays(self) -> dict[str, bool]:
        """Which parameters take AdamW's decoupled weight decay. The
        reference decays leaves with ``ndim >= 2`` (adamw.py:136), and its
        per-block leaves are stacked (n_blocks, ...): every block parameter
        here, the 1-d norm gammas and ``router_bias`` included, is one
        slice of such a leaf and decays. ``final_ln`` (D,) does not."""
        return {name: p.dim() >= 2 or name.startswith("blocks.")
                for name, p in self.named_parameters()}

    def hidden(self, tokens: torch.Tensor):
        """(hidden states (B, S, D), summed aux loss) of ``tokens`` over the
        whole sequence, without a cache (the reference's ``mode="full"``);
        each block is recomputed in the backward when ``cfg.remat``."""
        x = self.embed[tokens]
        positions = torch.arange(tokens.shape[1], device=self.device)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for blk in self.blocks:
            if self.cfg.remat and torch.is_grad_enabled():
                x, a = checkpoint(self._block, blk, x, positions,
                                  use_reentrant=False)
            else:
                x, a = self._block(blk, x, positions)
            aux = aux + a
        return x, aux

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
        ``(ce + 0.01 * aux, {"ce", "aux"})``, aux summed over the MoE
        blocks (0 without any)."""
        tokens = self._tokens(tokens)
        hidden, aux = self.hidden(tokens[:, :-1])
        ce = self._chunked_ce(hidden, tokens[:, 1:])
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}
