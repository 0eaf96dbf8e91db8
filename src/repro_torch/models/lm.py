"""The language model of the port — port of ``repro.models.lm`` for all
of its segment kinds (``PORTED_KINDS``): embedding, the segments' blocks,
final RMSNorm, unembedding, with the reference's prefill / decode /
init_cache semantics (lm.py:464-502) and batch convention (``{"tokens"}``,
plus ``"frames"`` for an encoder-decoder, ``"vision"`` for a VLM; float32
(B, T, d_model) embeddings from the reference's stub frontends, cast to
``cfg.dtype``).

A model is a sequence of segments (``segments_for``, as the reference's):
llama3-8b and gemma-7b one ``dense`` segment, mixtral-8x7b one ``moe``
segment (GQA attention + MoE FFN), deepseek-v3-671b a ``dense_prefix`` of
``mla_dense`` blocks (MLA + dense FFN) then a ``moe`` segment of
``mla_moe`` blocks (MLA + MoE with a shared expert), whisper-base an
``enc`` segment (bidirectional self-attention, no rope) and a ``dec``
segment (causal self-attention, cross-attention to the encoder output,
no rope; sinusoid positions on both sides), llama-3.2-vision-90b one
``vlm`` segment of ``vlm_group`` blocks (``cross_attn_every`` dense
blocks, then a tanh-gated cross-attention block over the vision tokens),
zamba2-7b a ``mamba_group`` segment (each group ``attn_every`` Mamba2
blocks, then the one shared attention block) and a ``mamba_tail`` of
``mamba`` blocks, rwkv6-1.6b one ``rwkv`` segment (time-mix, then
channel-mix, each with its carried state).
The reference stacks each segment's parameters on axis 0 and scans them;
here the blocks of all segments are one ``nn.ModuleList`` in order, named
``blocks.<i>.<leaf>`` (a group's inner blocks ``blocks.<i>.selfs.<j>.
<leaf>`` or ``blocks.<i>.mambas.<j>.<leaf>``), and the converter
(``convert.lm_params_from_numpy``) unstacks the reference's pytree.
zamba2's shared attention block is one module, ``shared_attn`` (``ln1``,
``attn``, ``ln2``, ``ffn``, as the reference's top-level leaf), called by
every group, so its gradient sums over the groups. The decode cache keeps
the reference's layout — ``{"len": int, <segment name>: {"k", "v"}}``
(GQA kinds; (n_blocks, B, T, Hkv, hd)), ``{"kv_c", "k_rope"}`` (MLA kinds;
(n_blocks, B, T, R) and (n_blocks, B, T, dr)), ``{"selfs": {"k", "v"}}``
(``vlm_group``; (n_groups, k, B, T, Hkv, hd)), ``{"m": {"conv",
"ssm"}}`` (``mamba``; (n, B, ssm_conv, d_inner + 2N) in ``cfg.dtype`` and
(n, B, H, N, P) float32), ``{"mambas": {"m": ...}, "shared_kv": {"k",
"v"}}`` (``mamba_group``; the states stacked (n_groups, k, B, ...)) or
``{"tm_prev", "wkv", "cm_prev"}`` (``rwkv``; (n, B, 1, D), (n, B, H, 64,
64) float32, (n, B, 1, D)), plus ``"enc_out"`` (B, n_audio_frames, D) or
``"vision"`` (B, n_vision_tokens, D), which decode re-reads (the encoder
has no cache) — and is updated in place: a cache handed to ``decode`` is
the one it returns.

A model whose parameters are DTensors (laid out by ``sharding.rules``)
serves on their mesh: ``prefill`` places the batch by
``rules.batch_shardings`` and, without a cache, makes a zero cache laid
out by ``rules.cache_shardings`` (each rank allocating its own shard);
``decode`` places its tokens by ``rules.batch_spec``; an MoE block's
dispatch groups are the batch's shards (``rules.batch_groups``); the
logits come back as DTensors.

``loss`` is the training objective (lm.py:454-461): next-token
cross-entropy over ``tokens[:, :-1]``, chunked by 1024 positions, plus
0.01 times the MoE blocks' summed load-balancing loss, with each block
recomputed in the backward (``torch.utils.checkpoint``) when
``cfg.remat``, as ``jax.checkpoint`` does in the reference's scan.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import mamba2, moe, rwkv6
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention, attn_shapes, dot_f32,
                                       dtype_of, ffn, ffn_shapes, frozen,
                                       init_dense, mla_attention, mla_shapes,
                                       rmsnorm)
from repro_torch.sharding import rules

PORTED_KINDS = ("dense", "moe", "mla_dense", "mla_moe", "enc", "dec",
                "vlm_group", "mamba", "mamba_group", "rwkv")


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
        if cfg.n_layers % cfg.cross_attn_every:
            raise ValueError(f"{cfg.arch_id}: n_layers {cfg.n_layers} is not "
                             f"a multiple of cross_attn_every "
                             f"{cfg.cross_attn_every}")
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


def cross_inputs(cfg: ModelConfig) -> dict[str, tuple[int, int]]:
    """The batch inputs besides ``tokens`` that ``cfg`` cross-attends to,
    each with its (T, d_model) shape: ``frames`` (an encoder-decoder's
    audio frames), ``vision`` (a VLM's vision tokens); {} for the others.
    Training needs them; serving attends to zeros without them."""
    out = {}
    if cfg.enc_dec:
        out["frames"] = (cfg.n_audio_frames, cfg.d_model)
    if cfg.cross_attn_every:
        out["vision"] = (cfg.n_vision_tokens, cfg.d_model)
    return out


def _mla(kind: str) -> bool:
    return kind.startswith("mla_")


def _has_moe(kind: str) -> bool:
    return kind in ("moe", "mla_moe")


class Block(nn.Module):
    """One block's weights: x + attention(rmsnorm(x)), then (``dec``) +
    cross-attention(rmsnorm(x)) to the encoder output, then
    + ffn-or-moe(rmsnorm(x)). ``attn`` holds the GQA (wq, wk, wv, wo) or
    MLA (wdq, wuq, wdkv, wkr, wuk, wuv, wo) weights, ``xattn`` and ``lnx``
    a ``dec`` block's cross-attention, ``ffn`` w1, w3, w2 or ``moe``
    router, router_bias, w1, w3, w2 (and ``shared``), in the reference's
    (d_in, d_out) layout."""

    def __init__(self, kind: str, attn: dict, mlp: dict, ln1: torch.Tensor,
                 ln2: torch.Tensor, xattn: dict | None = None,
                 lnx: torch.Tensor | None = None):
        super().__init__()
        self.kind = kind
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.attn = frozen(attn)
        if xattn is not None:
            self.lnx = nn.Parameter(lnx, requires_grad=False)
            self.xattn = frozen(xattn)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        leaves = frozen({k: v for k, v in mlp.items() if k != "shared"})
        if "shared" in mlp:
            leaves["shared"] = frozen(mlp["shared"])
        setattr(self, "moe" if _has_moe(kind) else "ffn", leaves)


class VlmGroup(nn.Module):
    """A ``vlm_group`` block's weights (reference lm.py:94-100): ``selfs``,
    ``cross_attn_every`` dense blocks, then the gated cross-attention
    block: ``x_ln``, ``xattn``, the float32 scalar ``x_gate``, ``x_ln2``,
    ``xffn`` and the float32 scalar ``xffn_gate``."""

    kind = "vlm_group"

    def __init__(self, selfs: list, xattn: dict, xffn: dict,
                 norm: torch.Tensor, gate: torch.Tensor):
        super().__init__()
        self.selfs = nn.ModuleList(selfs)
        self.x_ln = nn.Parameter(norm.clone(), requires_grad=False)
        self.xattn = frozen(xattn)
        self.x_gate = nn.Parameter(gate.clone(), requires_grad=False)
        self.x_ln2 = nn.Parameter(norm.clone(), requires_grad=False)
        self.xffn = frozen(xffn)
        self.xffn_gate = nn.Parameter(gate.clone(), requires_grad=False)


class MambaBlock(nn.Module):
    """A ``mamba`` block's weights (reference lm.py:102-103): ``ln1`` and
    the Mamba2 leaves ``mamba`` (``models.mamba2.mamba2_init``)."""

    kind = "mamba"

    def __init__(self, mamba: dict, ln1: torch.Tensor):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.mamba = frozen(mamba)


class MambaGroup(nn.Module):
    """A ``mamba_group`` block's weights (reference lm.py:104-107):
    ``mambas``, ``attn_every`` Mamba2 blocks. The shared attention block
    that closes every group is the LM's ``shared_attn``, not a child."""

    kind = "mamba_group"

    def __init__(self, mambas: list):
        super().__init__()
        self.mambas = nn.ModuleList(mambas)


class RwkvBlock(nn.Module):
    """An ``rwkv`` block's weights (reference lm.py:108-110): ``ln1``,
    ``ln2`` and the time- and channel-mix leaves ``rwkv``
    (``models.rwkv6.rwkv6_init``)."""

    kind = "rwkv"

    def __init__(self, rwkv: dict, ln1: torch.Tensor, ln2: torch.Tensor):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        self.rwkv = frozen(rwkv)


def _block(kind: str, cfg: ModelConfig, gen, dev) -> nn.Module:
    """A block of ``kind``: attention, (``dec``) cross-attention, then FFN
    or MoE, drawn in that order (a group: its dense blocks, then the cross
    block's attention and FFN; a Mamba2 group: its Mamba2 blocks);
    uninitialised where ``gen`` is None. Norms are ones and a group's gates
    zeros, as the reference initialises them."""
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown segment kind {kind!r}")
    D = cfg.d_model
    ones = torch.ones(D, dtype=torch.float32, device=dev)
    if kind == "mamba":
        return MambaBlock(mamba2.mamba2_init(gen, cfg, dev), ones)
    if kind == "mamba_group":
        return MambaGroup([_block("mamba", cfg, gen, dev)
                           for _ in range(cfg.attn_every)])
    if kind == "rwkv":
        return RwkvBlock(rwkv6.rwkv6_init(gen, cfg, dev), ones, ones.clone())
    if kind == "vlm_group":
        selfs = [_block("dense", cfg, gen, dev)
                 for _ in range(cfg.cross_attn_every)]
        xattn = init_dense(gen, attn_shapes(cfg), cfg, dev)
        xffn = init_dense(gen, ffn_shapes(cfg), cfg, dev)
        return VlmGroup(selfs, xattn, xffn, ones,
                        torch.zeros((), dtype=torch.float32, device=dev))
    attn = init_dense(gen, mla_shapes(cfg) if _mla(kind) else
                      attn_shapes(cfg), cfg, dev)
    xattn = (init_dense(gen, attn_shapes(cfg), cfg, dev) if kind == "dec"
             else None)
    if _has_moe(kind):
        mlp = moe.moe_init(gen, cfg, dev)
    else:
        mlp = init_dense(gen, ffn_shapes(cfg), cfg, dev)
    return Block(kind, attn, mlp, ones, ones.clone(), xattn,
                 ones.clone() if xattn is not None else None)


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Rows ``positions`` of the reference's (max_len, d) float32 sinusoid
    table (``_sinusoid``, lm.py:328-334): sin at the even columns, cos at
    the odd ones, each row a function of its position alone."""
    pos = positions.to(torch.float32)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32,
                       device=positions.device)[None, :]
    ang = pos / (10000 ** (dim / d))
    pe = torch.zeros((positions.shape[0], d), dtype=torch.float32,
                     device=positions.device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def _lookup_on_mesh(table: DTensor, tokens: torch.Tensor) -> DTensor:
    """``table[tokens]`` of a DTensor table in a ``local_map`` region: the
    table gathered whole on every rank, each rank indexing it with its own
    tokens (laid out as they are; a plain tensor as replicated) as one
    device does, the table's gradient a partial sum over the mesh dims
    that split them. DTensor's own rules do worse: indexing's backward
    fails in torch 2.11, the vocab-parallel ``F.embedding`` leaves a
    partial sum it cannot reduce-scatter, and with a whole table it may
    gather the tokens."""
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tp = list(tokens.placements)
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in tp]
    return local_map(lambda t, w: w[t], out_placements=tp,
                     in_placements=(tp, [Replicate()] * mesh.ndim),
                     in_grad_placements=(tp, grad), device_mesh=mesh,
                     redistribute_inputs=True)(tokens, table)


def _index(tree: dict, j: int) -> dict:
    """Slice j of every leaf of a (nested) cache dict."""
    return {k: _index(v, j) if isinstance(v, dict) else v[j]
            for k, v in tree.items()}


class LM(nn.Module):
    """The LM on one device. ``seed`` draws the weights on that device
    from a ``torch.Generator`` one tensor at a time (not JAX's bits);
    ``seed=None`` leaves them uninitialised for a converter to fill.
    ``device=None`` is the card. ``trainable=True`` gives every parameter
    ``requires_grad`` (training); the default serves, without gradients."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int | None = 0,
                 trainable: bool = False):
        super().__init__()
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
        # zamba2's shared attention block, drawn last as in the reference
        self.shared_attn = (_block("dense", cfg, gen, dev) if cfg.attn_every
                            else None)
        self.requires_grad_(trainable)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def mesh(self):
        """The ``DeviceMesh`` the parameters are laid out on (the
        embedding's), or None on one device."""
        return (self.embed.device_mesh if isinstance(self.embed, DTensor)
                else None)

    def segment_blocks(self):
        """(segment, [its blocks' indices in ``blocks``]) in order."""
        i = 0
        for seg in self.segments:
            yield seg, list(range(i, i + seg.n_blocks))
            i += seg.n_blocks

    def stack_dims(self) -> dict[str, tuple]:
        """Each parameter's stack dims in the reference's layout: a
        segment's block leaves are stacked ``(n_blocks,)``, a group's inner
        blocks (``selfs``, ``mambas``) ``(n_groups, k)``; the others
        (``embed``, ``final_ln``, ``lm_head``, ``shared_attn``) none."""
        lead = {}
        for seg, idx in self.segment_blocks():
            for i in idx:
                for name, _ in self.blocks[i].named_parameters():
                    parts = name.split(".")
                    inner = parts[0] in ("selfs", "mambas")
                    lead[f"blocks.{i}.{name}"] = (
                        (seg.n_blocks, len(getattr(self.blocks[i], parts[0])))
                        if inner else (seg.n_blocks,))
        return {n: lead.get(n, ()) for n, _ in self.named_parameters()}

    def reference_leaves(self) -> dict[str, list[str]]:
        """The reference's parameter leaves, each by its dotted path
        (``"dense.attn.wq"``, ``"vlm.selfs.ln1"``, ``"embed"``), with the
        names of the parameters stacked into it, in stack order (a
        segment's blocks in order; a group's inner blocks group by group)."""
        seg_of = {i: seg.name for seg, idx in self.segment_blocks()
                  for i in idx}
        out: dict[str, list[str]] = {}
        for name, _ in self.named_parameters():
            parts = name.split(".")
            if parts[0] == "blocks":
                parts = [seg_of[int(parts[1])]] + [
                    p for p in parts[2:] if not p.isdigit()]
            out.setdefault(".".join(parts), []).append(name)
        return out

    # --- cache ---------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """The decode cache of every segment but the encoder, zeros; an
        encoder-decoder's ``enc_out`` and a VLM's ``vision`` zeros too (a
        prefill without ``frames`` / ``vision`` attends to them, as the
        reference's does)."""
        return self._init_cache(batch_size, max_len, self.device)

    def _init_cache(self, batch_size: int, max_len: int, dev) -> dict:
        cfg = self.cfg
        dt = dtype_of(cfg)
        cache = {"len": 0}

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=dev)
        for seg in self.segments:
            if seg.kind == "enc":
                continue
            if seg.kind in ("mamba", "mamba_group", "rwkv"):
                cache[seg.name] = self._state_cache(seg, batch_size,
                                                    max_len, dev)
                continue
            n = (seg.n_blocks,)
            if seg.kind == "vlm_group":
                n += (cfg.cross_attn_every,)
            n += (batch_size, max_len)
            shapes = ({"kv_c": n + (cfg.kv_lora_rank,),
                       "k_rope": n + (cfg.qk_rope_head_dim,)}
                      if _mla(seg.kind) else
                      {"k": n + (cfg.n_kv_heads, cfg.hd),
                       "v": n + (cfg.n_kv_heads, cfg.hd)})
            leaves = {k: zeros(*s) for k, s in shapes.items()}
            cache[seg.name] = ({"selfs": leaves} if seg.kind == "vlm_group"
                               else leaves)
        if cfg.enc_dec:
            cache["enc_out"] = zeros(batch_size, cfg.n_audio_frames,
                                     cfg.d_model)
        if cfg.cross_attn_every:
            cache["vision"] = zeros(batch_size, cfg.n_vision_tokens,
                                    cfg.d_model)
        return cache

    def _state_cache(self, seg: Segment, batch_size: int, max_len: int,
                     dev) -> dict:
        """A state-space segment's decode cache, zeros: each block's
        ``mamba2_init_state`` (``{"m": ...}``; a group's stacked (n, k,
        ...) beside the shared block's k/v (n, B, T, Hkv, hd)) or
        ``rwkv6_block_state``, stacked (n_blocks, ...)."""
        cfg = self.cfg
        if seg.kind == "rwkv":
            one = rwkv6.rwkv6_block_state(cfg, batch_size, dev)
        else:
            one = {"m": mamba2.mamba2_init_state(cfg, batch_size, dev)}

        def stacked(tree, lead):
            return {k: stacked(v, lead) if isinstance(v, dict)
                    else v.new_zeros(lead + v.shape) for k, v in tree.items()}
        if seg.kind != "mamba_group":
            return stacked(one, (seg.n_blocks,))
        kv = (seg.n_blocks, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
        return {"mambas": stacked(one, (seg.n_blocks, cfg.attn_every)),
                "shared_kv": {k: torch.zeros(kv, dtype=dtype_of(cfg),
                                             device=dev)
                              for k in ("k", "v")}}

    def _mesh_cache(self, batch_size: int, max_len: int) -> dict:
        """``init_cache``'s zeros laid out by ``rules.cache_shardings`` on
        the model's mesh, each rank allocating only its own shard (the
        layout is made on meta)."""
        meta = self._init_cache(batch_size, max_len, torch.device("meta"))
        return rules.zero_cache(rules.place_cache(
            meta, rules.cache_shardings(meta, self.mesh)), self.device)

    # --- forward -------------------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _batch(self, batch) -> dict:
        """The reference's batch convention: a dict with ``"tokens"`` (B, S)
        and, for the cross-attending kinds, ``"frames"`` / ``"vision"``
        (B, T, d_model) embeddings (cast to ``cfg.dtype``, as the reference
        casts them); or the tokens alone."""
        if not isinstance(batch, Mapping):
            batch = {"tokens": batch}
        out = {"tokens": self._tokens(batch["tokens"])}
        for key in ("frames", "vision"):
            if key in batch:
                out[key] = torch.as_tensor(batch[key], device=self.device
                                           ).to(dtype_of(self.cfg))
        return out

    def _placed(self, batch: dict) -> dict:
        """On a mesh, ``batch``'s leaves laid out by
        ``rules.batch_shardings`` (a plain leaf, whole and equal on every
        rank, split; a DTensor redistributed); otherwise as they are."""
        mesh = self.mesh
        if mesh is None:
            return batch
        out = {}
        for k, sh in rules.batch_shardings(batch, mesh).items():
            x = batch[k]
            out[k] = (x.redistribute(mesh, sh.placements)
                      if isinstance(x, DTensor)
                      else rules.distribute(x, mesh, sh.spec))
        return out

    def _carried(self, cache: dict | None, key: str, source: str):
        """``cache[key]``, what a prefill or decode without ``source`` in
        its batch attends to; training has no cache and needs ``source``."""
        if cache is None:
            raise ValueError(f"{self.cfg.arch_id}: the batch has no "
                             f"{source!r} (B, T, d_model) input")
        return cache[key]

    def _extras(self, batch: dict, cache: dict | None = None) -> dict:
        """What the cross-attending blocks read: ``vision`` (the batch's,
        else the cache's), ``enc_out`` (the encoder over the batch's
        ``frames``, else the cache's)."""
        ex = {}
        if self.cfg.cross_attn_every:
            ex["vision"] = (batch["vision"] if "vision" in batch else
                            self._carried(cache, "vision", "vision"))
        if self.cfg.enc_dec:
            ex["enc_out"] = (self._encoder(batch["frames"])
                             if "frames" in batch else
                             self._carried(cache, "enc_out", "frames"))
        return ex

    def _block(self, blk: nn.Module, x: torch.Tensor, positions: torch.Tensor,
               cache: dict | None = None, ex: dict | None = None):
        """One block (reference lm.py:161-302): x + attention(rmsnorm(x)),
        (``dec``) + cross-attention(rmsnorm(x)) to ``ex["enc_out"]``, then
        + ffn-or-moe(rmsnorm(x)); a ``vlm_group`` runs its dense blocks,
        then adds tanh(x_gate) * cross-attention to ``ex["vision"]`` and
        tanh(xffn_gate) * ffn, each product in float32 and rounded once to
        x's dtype. A decode ``cache`` (this block's, with ``len``) is
        written in place. Returns (x, aux): aux is the MoE's
        load-balancing loss, 0 for a dense FFN."""
        cfg = self.cfg
        eps = cfg.norm_eps
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if blk.kind in ("mamba", "mamba_group", "rwkv"):
            return self._state_block(blk, x, positions, cache, ex), zero
        if blk.kind == "vlm_group":
            for i, sub in enumerate(blk.selfs):
                c = (None if cache is None else
                     {**_index(cache["selfs"], i), "len": cache["len"]})
                x, _ = self._block(sub, x, positions, c, ex)
            h, _ = attention(blk.xattn, cfg, rmsnorm(x, blk.x_ln, eps),
                             kv_src=ex["vision"], use_rope=False)
            x = x + (torch.tanh(blk.x_gate) * h.float()).to(x.dtype)
            f = ffn(blk.xffn, cfg, rmsnorm(x, blk.x_ln2, eps))
            x = x + (torch.tanh(blk.xffn_gate) * f.float()).to(x.dtype)
            return x, zero
        xin = rmsnorm(x, blk.ln1, eps)
        if _mla(blk.kind):
            h, _ = mla_attention(blk.attn, cfg, xin, positions=positions,
                                 cache=cache)
        else:
            h, _ = attention(blk.attn, cfg, xin, positions=positions,
                             cache=cache, causal=blk.kind != "enc",
                             use_rope=not cfg.enc_dec)
        x = x + h
        if blk.kind == "dec":
            h, _ = attention(blk.xattn, cfg, rmsnorm(x, blk.lnx, eps),
                             kv_src=ex["enc_out"], use_rope=False)
            x = x + h
        y = rmsnorm(x, blk.ln2, eps)
        if _has_moe(blk.kind):
            f, aux = moe.moe_ffn(blk.moe, cfg, y, (ex or {}).get(
                "n_groups", cfg.moe_groups))
        else:
            f, aux = ffn(blk.ffn, cfg, y), zero
        return x + f, aux

    def _state_block(self, blk: nn.Module, x: torch.Tensor,
                     positions: torch.Tensor, cache: dict | None,
                     ex: dict | None) -> torch.Tensor:
        """A state-space block (reference lm.py:240-292). ``mamba``: x +
        Mamba2(rmsnorm(x)), over the whole sequence without a cache
        (training), with the decode state after the prompt (a prefill: S >
        1) or one O(1) step from the cached state (decode: S == 1). A
        ``mamba_group``: its Mamba2 blocks, then the shared attention block
        (``shared_attn``, with this group's k/v cache). ``rwkv``: x +
        time-mix(rmsnorm(x)), then + channel-mix(rmsnorm(x)), from the
        cached state (zeros without a cache). The new states are written
        into ``cache`` in place."""
        cfg = self.cfg
        eps = cfg.norm_eps
        if blk.kind == "mamba_group":
            for i, sub in enumerate(blk.mambas):
                c = (None if cache is None else
                     {**_index(cache["mambas"], i), "len": cache["len"]})
                x = self._state_block(sub, x, positions, c, ex)
            c = (None if cache is None else
                 {**cache["shared_kv"], "len": cache["len"]})
            x, _ = self._block(self.shared_attn, x, positions, c, ex)
            return x
        if blk.kind == "mamba":
            xin = rmsnorm(x, blk.ln1, eps)
            if cache is None:
                h, new = mamba2.mamba2_forward(blk.mamba, cfg, xin)
            elif x.shape[1] > 1:
                h, new = mamba2.mamba2_forward(blk.mamba, cfg, xin,
                                               return_state=True)
            else:
                h, new = mamba2.mamba2_forward(blk.mamba, cfg, xin,
                                               state=cache["m"])
            if cache is not None:
                for k, v in new.items():
                    cache["m"][k].copy_(v)
            return x + h
        st = (cache if cache is not None else
              rwkv6.rwkv6_block_state(cfg, x.shape[0], x.device))
        h, tm = rwkv6.time_mix(blk.rwkv, cfg, rmsnorm(x, blk.ln1, eps), st)
        x = x + h
        h, cm = rwkv6.channel_mix(blk.rwkv, cfg, rmsnorm(x, blk.ln2, eps),
                                  st)
        if cache is not None:
            for k, v in {**tm, **cm}.items():
                cache[k].copy_(v)
        return x + h

    def _block_full(self, blk: nn.Module, x: torch.Tensor,
               positions: torch.Tensor, ex: dict):
        """``_block`` over a whole sequence without a cache, recomputed in
        the backward when ``cfg.remat`` (the reference's ``mode="full"``
        scan body)."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(self._block, blk, x, positions, None, ex,
                              use_reentrant=False)
        return self._block(blk, x, positions, None, ex)

    def _encoder(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder (reference lm.py:392-398): the frames plus the
        sinusoid, the ``enc`` blocks over the whole sequence, then the
        shared ``final_ln``."""
        positions = torch.arange(frames.shape[1], device=self.device)
        h = frames + sinusoid(positions, self.cfg.d_model).to(frames.dtype)
        for seg, idx in self.segment_blocks():
            if seg.kind == "enc":
                for i in idx:
                    h, _ = self._block_full(self.blocks[i], h, positions, {})
        return rmsnorm(h, self.final_ln, self.cfg.norm_eps)

    def _embed(self, tokens: torch.Tensor, positions: torch.Tensor
               ) -> torch.Tensor:
        """Token embeddings; an encoder-decoder's decoder adds the
        sinusoid at ``positions``. A DTensor table is looked up in a
        ``local_map`` region (``_lookup_on_mesh``)."""
        if isinstance(self.embed, DTensor):
            x = _lookup_on_mesh(self.embed, tokens)
        else:
            x = self.embed[tokens]
        if self.cfg.enc_dec:
            x = x + sinusoid(positions, self.cfg.d_model).to(x.dtype)[None]
        return x

    def _decoder_segments(self):
        return [(seg, idx) for seg, idx in self.segment_blocks()
                if seg.kind != "enc"]

    def _forward(self, batch: dict, cache: dict, pos: int) -> torch.Tensor:
        """Hidden states (B, S, D) of ``batch["tokens"]`` at positions
        pos + arange(S), writing their keys and values (or latents) into
        ``cache`` at ``pos``, and the encoder output or vision tokens they
        attended to into ``cache["enc_out"]`` / ``cache["vision"]``."""
        tokens = batch["tokens"]
        ex = self._extras(batch, cache)
        if self.mesh is not None:
            ex["n_groups"] = rules.batch_groups(self.mesh, tokens.shape[0])
        positions = pos + torch.arange(tokens.shape[1], device=self.device)
        x = self._embed(tokens, positions)
        for seg, idx in self._decoder_segments():
            c = cache[seg.name]
            for j, i in enumerate(idx):
                x, _ = self._block(self.blocks[i], x, positions,
                                   {**_index(c, j), "len": pos}, ex)
        for key in ("enc_out", "vision"):
            if key in ex:
                cache[key] = ex[key]
        return x

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, self.final_ln, self.cfg.norm_eps)
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return dot_f32(x, w)

    @torch.no_grad()
    def prefill(self, batch, max_len: int, cache: dict | None = None
                ) -> tuple[torch.Tensor, dict]:
        """Run the whole prompt (``batch``: tokens (B, S), or the batch
        dict with ``frames`` / ``vision``) and build a decode cache of
        length ``max_len``: ``cache``, a zero cache of ``init_cache``'s
        layout (on a mesh, DTensors laid out by the sharding rules), or a
        fresh ``init_cache`` (on a mesh, ``_mesh_cache``). Returns
        (last-position logits (B, V) float32, cache)."""
        batch = self._placed(self._batch(batch))
        B, S = batch["tokens"].shape
        if cache is None:
            cache = (self.init_cache(B, max_len) if self.mesh is None
                     else self._mesh_cache(B, max_len))
        with implicit_replication():
            x = self._forward(batch, cache, 0)
            cache["len"] = S
            return self._unembed(x[:, -1:, :])[:, 0], cache

    @torch.no_grad()
    def decode(self, cache: dict, tokens) -> tuple[torch.Tensor, dict]:
        """One decode step for tokens (B,) at position ``cache["len"]``,
        the same for every row. Returns (logits (B, V) float32, cache)."""
        tokens = self._placed({"tokens": self._tokens(tokens)})["tokens"]
        pos = int(cache["len"])
        with implicit_replication():
            x = self._forward({"tokens": tokens[:, None]}, cache, pos)
            new_cache = {**cache, "len": pos + 1}
            return self._unembed(x)[:, 0], new_cache

    # --- training ------------------------------------------------------------
    def decays(self) -> dict[str, bool]:
        """Which parameters take AdamW's decoupled weight decay. The
        reference decays leaves with ``ndim >= 2`` (adamw.py:136), and its
        per-block leaves are stacked (n_blocks, ...): a block parameter
        here is one slice of such a leaf, one dimension short. So the 1-d
        norm gammas, ``router_bias`` and the Mamba2 and RWKV vectors
        (``a_log``, ``u_bonus``, ...) decay, and a group's scalar gates,
        stacked (n_groups,), do not; ``final_ln`` (D,) does not, nor do
        ``shared_attn``'s norms, an unstacked leaf of the reference."""
        return {name: p.dim() + name.startswith("blocks.") >= 2
                for name, p in self.named_parameters()}

    def hidden(self, batch):
        """(hidden states (B, S, D), summed aux loss) of ``batch`` (tokens,
        or the batch dict) over the whole sequence, without a cache (the
        reference's ``mode="full"``); each block is recomputed in the
        backward when ``cfg.remat``."""
        return self._hidden(self._batch(batch))

    def _hidden(self, batch: dict):
        tokens = batch["tokens"]
        ex = self._extras(batch)
        positions = torch.arange(tokens.shape[1], device=self.device)
        x = self._embed(tokens, positions)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for _, idx in self._decoder_segments():
            for i in idx:
                x, a = self._block_full(self.blocks[i], x, positions, ex)
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
            tgt = targets[:, i:i + chunk]
            if isinstance(logits, DTensor):
                # DTensor's gather over a vocab-sharded dim does not
                # reduce its masked partials; the one-hot product picks
                # the same logit exactly
                gold = torch.sum(logits * F.one_hot(
                    tgt, logits.shape[-1]).to(logits.dtype), dim=-1)
            else:
                gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
            total = total + torch.sum(lse - gold)
        return total / max(B * S, 1)

    def loss(self, batch) -> tuple[torch.Tensor, dict]:
        """Next-token loss of ``batch`` (tokens (B, S), or the batch dict
        with ``frames`` / ``vision``): the model reads ``tokens[:, :-1]``
        and predicts ``tokens[:, 1:]``. Returns ``(ce + 0.01 * aux, {"ce",
        "aux"})``, aux summed over the MoE blocks (0 without any)."""
        batch = self._batch(batch)
        tokens = batch["tokens"]
        hidden, aux = self._hidden({**batch, "tokens": tokens[:, :-1]})
        ce = self._chunked_ce(hidden, tokens[:, 1:])
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}
