"""Mixture-of-Experts FFN with capacity-based (GShard-style) token dispatch
— port of ``repro.models.moe``.

Tokens are grouped (G groups of S tokens, G = ``cfg.moe_groups``). The
router's top-k choices are packed into per-expert capacity slots
C = ``capacity(cfg, S)``, each (token, k) taking the slot given by the
float32 exclusive cumulative count of its expert's earlier choices in
token order; a choice whose slot is past C is dropped, and the kept gates
are renormalised. Routing (``route``) is the reference's arithmetic, and
its choices, slots, drops and auxiliary loss equal the reference's in
float32.

Dispatch and combine are index gathers over those slots, not the
reference's (G, S, E, C) one-hot products: slot (e, c) of group g reads
the one token routed there (or a zero row), and a token's output is the
sum over its kept choices of gate (rounded to x's dtype, where the
reference rounds its combine tensor) times its slot's expert output,
accumulated in float32 and rounded once. These are the reference's
products without their zero terms: dispatch is exact, and combine differs
at most in the float32 order of its top_k terms. At deepseek-v3's
E = 256 the one-hot tensors of a 4,096-token prefill would hold 1.7e8
entries per layer, and their products would cost more than the experts.

Every expert computes all C of its slots, empty ones included (zero rows
in, zero rows out), as in the reference. ``n_shared_experts`` dense
experts (deepseek-v3) are added to every token.

Selection is stable by index on exact ties (``torch.sort(stable=True)``),
as ``jax.lax.top_k`` returns the lower index first; ``torch.topk``
promises no order.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of, ffn, init_dense

Params = Mapping[str, torch.Tensor]

# dispatch slots scale with tokens-per-group; beyond this many tokens per
# group the sequence is processed in chunks (exact — routing is per-token;
# only capacity boundaries move, as in any production MoE server).
_MOE_CHUNK_TOKENS = 16384


def moe_shapes(cfg: ModelConfig) -> dict:
    """Shapes of the routed experts' leaves."""
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    return {"router": (D, E), "router_bias": (E,), "w1": (E, D, F),
            "w3": (E, D, F), "w2": (E, F, D)}


def shared_shapes(cfg: ModelConfig) -> dict:
    """The shared expert's FFN, ``moe_d_ff * n_shared_experts`` wide."""
    D, F = cfg.d_model, cfg.moe_d_ff * cfg.n_shared_experts
    return {"w1": (D, F), "w3": (D, F), "w2": (F, D)}


def moe_init(gen: torch.Generator | None, cfg: ModelConfig, device) -> dict:
    """The MoE leaves, drawn in order on the generator's device: the
    router float32 normal * 0.02, ``router_bias`` float32 zeros, w1 and w3
    normal * D**-0.5 and w2 normal * F**-0.5 in ``cfg.dtype``, and the
    shared expert (``shared``) as an FFN. Uninitialised where ``gen`` is
    None (a converter fills them). Not JAX's bits."""
    dt = dtype_of(cfg)
    shapes = moe_shapes(cfg)
    dtypes = {"router": torch.float32, "router_bias": torch.float32}
    if gen is None:
        p = {k: torch.empty(s, dtype=dtypes.get(k, dt), device=device)
             for k, s in shapes.items()}
    else:
        D, F = cfg.d_model, cfg.moe_d_ff
        scales = {"router": 0.02, "w1": D ** -0.5, "w3": D ** -0.5,
                  "w2": F ** -0.5}
        p = {}
        for k, s in shapes.items():
            if k == "router_bias":
                p[k] = torch.zeros(s, dtype=torch.float32, device=device)
                continue
            w = torch.randn(s, generator=gen, device=device,
                            dtype=torch.float32).mul_(scales[k])
            p[k] = w.to(dtypes.get(k, dt))
    if cfg.n_shared_experts:
        p["shared"] = init_dense(gen, shared_shapes(cfg), cfg, device)
    return p


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            // cfg.n_experts) + 1
    return max(c, cfg.top_k)


class Routing(NamedTuple):
    """The router's decisions for (G, S) tokens: ``idx`` (G, S, K) the
    chosen experts in descending score order, ``pos`` (G, S, K) each
    choice's slot in its expert, ``keep`` (G, S, K) pos < C, ``gate``
    (G, S, K) float32 the renormalised kept gates (0 where dropped),
    ``aux`` the Switch load-balancing loss, ``capacity`` C."""
    idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    aux: torch.Tensor
    capacity: int


def selection_scores(p: Params, x_flat: torch.Tensor):
    """(gates, scores) of (G, S, D) tokens: float32 softmax gates of the
    router's logits, and the selection scores gates + router_bias."""
    logits = torch.matmul(x_flat.float(), p["router"].float())
    gates = torch.softmax(logits, dim=-1)
    return gates, gates + p["router_bias"]


def route(p: Params, cfg: ModelConfig, x_flat: torch.Tensor,
          choices: torch.Tensor | None = None) -> Routing:
    """x_flat: (G, S, D) -> the routing of its tokens (reference
    moe.py:55-91: softmax gates for combination, gates + router_bias for
    selection, slots by a float32 exclusive cumsum in token order).
    ``choices`` (G, S, K), where given, are taken in place of the
    router's own top-k: a replay that follows another run's selections
    (chip_smoke.py holds each difference to be a near-tie)."""
    G, S, _ = x_flat.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    gates, sel = selection_scores(p, x_flat)
    # descending, ties to the lower index (jax.lax.top_k's order)
    idx = (torch.sort(sel, dim=-1, descending=True, stable=True)[1][..., :K]
           if choices is None else choices)
    # (G, S, K, E), as jax.nn.one_hot forms it: a compare with the expert
    # ids (F.one_hot scatters on a card and compares on meta, so a
    # step's count would differ between the two)
    onehot = (idx[..., None] == torch.arange(E, device=idx.device)).float()
    flat = onehot.reshape(G, S * K, E)
    # the count runs along the last axis (a scan over E rows of S * K, not
    # E columns of S * K steps each); exact, as the sums are integers
    run = torch.cumsum(flat.transpose(1, 2), dim=-1).transpose(1, 2)
    pos = (run - flat).reshape(G, S, K, E)
    pos = torch.sum(pos * onehot, dim=-1)                     # (G, S, K)
    keep = pos < C
    gate = torch.gather(gates, -1, idx) * keep
    denom = torch.sum(gate, dim=-1, keepdim=True)
    gate = gate / torch.clamp_min(denom, 1e-9)
    # load-balancing aux loss (Switch): E * sum(frac_tokens * frac_prob)
    me = torch.mean(onehot.sum(2), dim=(0, 1))
    ce = torch.mean(gates, dim=(0, 1))
    aux = E * torch.sum(me * ce) / K
    return Routing(idx, pos.long(), keep, gate, aux, C)


def _expert_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, N, d_in) @ (E, d_in, d_out) per expert, accumulated in float32
    and rounded to x's dtype (the reference's ``preferred_element_type``
    einsums); on the meta device as on the card (``layers.dot``)."""
    if x.dtype == torch.float32 or x.is_cuda or x.is_meta:
        return torch.bmm(x, w)
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def _dispatch(router: torch.Tensor, router_bias: torch.Tensor,
              cfg: ModelConfig, x: torch.Tensor, n_groups: int):
    """Routing and dispatch of x (B, S, D) in ``n_groups`` groups:
    ``(xin (E, G*C, D), slot (G, s, K), gate (G, s, K) float32, aux)``,
    slot e * C + pos of each kept choice (E * C for a dropped one)."""
    B, S, D = x.shape
    T, G = B * S, n_groups
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    E, K = cfg.n_experts, cfg.top_k
    xg = x.reshape(G, T // G, D)
    s = T // G
    r = route({"router": router, "router_bias": router_bias}, cfg, xg)
    C = r.capacity
    # slot e * C + pos of each kept choice; dropped ones go to slot E * C,
    # which is never read
    slot = torch.where(r.keep, r.idx * C + r.pos, E * C).reshape(G, s * K)
    tok = torch.arange(s, device=x.device).repeat_interleave(K)
    # the token in each slot; an empty slot reads row s, a zero row
    tok_of = torch.full((G, E * C + 1), s, dtype=torch.long, device=x.device)
    tok_of.scatter_(1, slot, tok.expand(G, -1))
    xpad = torch.cat([xg, xg.new_zeros(G, 1, D)], dim=1)
    rows = torch.arange(G, device=x.device)[:, None]
    xin = xpad[rows, tok_of[:, :E * C]]                      # (G, E*C, D)
    xin = xin.reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
    return xin, slot.reshape(G, s, K), r.gate, r.aux


def _experts(xin: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
             w2: torch.Tensor) -> torch.Tensor:
    """(E, N, D) slot rows -> (E, N, D) expert outputs (silu(x w1) * x w3
    then w2, each product rounded to x's dtype)."""
    h = _expert_dot(xin, w1)
    h3 = _expert_dot(xin, w3)
    h = h * torch.sigmoid(h) * h3          # jax.nn.silu(h) * h3, x.dtype
    return _expert_dot(h, w2)


def _combine(eo: torch.Tensor, slot: torch.Tensor, gate: torch.Tensor,
             B: int, S: int, dtype: torch.dtype) -> torch.Tensor:
    """(E, G*C, D) expert outputs -> (B, S, D): the kept gates rounded to
    x's dtype, as the reference rounds its combine tensor, times their
    slots' outputs, summed in float32."""
    G, s, K = slot.shape
    E, D = eo.shape[0], eo.shape[-1]
    C = eo.shape[1] // G
    eo = eo.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)
    eo = torch.cat([eo, eo.new_zeros(G, 1, D)], dim=1)
    gate = gate.to(dtype).float()
    rows = torch.arange(G, device=eo.device)[:, None]
    acc = torch.zeros((G, s, D), dtype=torch.float32, device=eo.device)
    for k in range(K):
        acc = acc + gate[..., k, None] * eo[rows, slot[..., k]].float()
    return acc.to(dtype).reshape(B, S, D)


def _moe_mesh(p: Params, cfg: ModelConfig, x: DTensor, n_groups: int):
    """The routed experts of a DTensor x on its mesh, in three
    ``local_map`` regions: routing, dispatch and combine on the whole
    batch on every rank (the tokens and the router gathered; the
    reference's groups span the global batch), and the experts on each
    rank's share of the expert weights as the sharding rules laid them
    out: the slot rows split with E where E is sharded (expert
    parallelism: only local experts run), the F dim's partial sums
    reduced where F is. With ``cfg.ep_axes`` the slot rows are first
    redistributed to E sharded over those axes (the reference's ``ep``
    constraint, moe.py:119-131)."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    rep = (Replicate(),) * mesh.ndim
    B, S, _ = x.shape
    xin, slot, gate, aux = local_map(
        lambda xl, r, rb: _dispatch(r, rb, cfg, xl, n_groups),
        out_placements=(rep, rep, rep, rep), in_placements=(rep, rep, rep),
        device_mesh=mesh, redistribute_inputs=True)(
            x, p["router"], p["router_bias"])
    if cfg.ep_axes:
        xin = xin.redistribute(mesh, tuple(
            Shard(0) if n in cfg.ep_axes else Replicate() for n in names))
    w_place = tuple(w.placements if isinstance(w, DTensor) else rep
                    for w in (p["w1"], p["w3"], p["w2"]))
    # per mesh dim: experts split (Shard(0)), F split (a partial sum),
    # or neither
    e_split = [isinstance(pl, Shard) and pl.dim == 0 for pl in w_place[0]]
    f_split = [isinstance(pl, Shard) and pl.dim != 0 for pl in w_place[0]]
    x_place = tuple(Shard(0) if e else Replicate() for e in e_split)
    x_grad = tuple(Shard(0) if e else Partial() if f else Replicate()
                   for e, f in zip(e_split, f_split))
    out_place = tuple(Shard(0) if e else Partial() if f else Replicate()
                      for e, f in zip(e_split, f_split))
    eo = local_map(_experts, out_placements=list(out_place),
                   in_placements=(x_place,) + w_place,
                   in_grad_placements=(x_grad,) + w_place,
                   device_mesh=mesh, redistribute_inputs=True)(
        xin, p["w1"], p["w3"], p["w2"])
    out = local_map(
        lambda e, sl, g: _combine(e, sl, g, B, S, x.dtype),
        out_placements=list(rep), in_placements=(rep, rep, rep),
        device_mesh=mesh, redistribute_inputs=True)(eo, slot, gate)
    return out, aux


def moe_ffn(p: Params, cfg: ModelConfig, x: torch.Tensor, n_groups: int):
    """x: (B, S, D) -> (out, aux_loss). Tokens regrouped to (G, S', D);
    beyond ``_MOE_CHUNK_TOKENS`` tokens per group an even S is halved
    until it fits or turns odd, and the chunks' aux losses averaged. A
    DTensor x runs on its mesh (``_moe_mesh``)."""
    B, S, D = x.shape
    if B * S > n_groups * _MOE_CHUNK_TOKENS and S % 2 == 0:
        n_chunks = 2
        while (B * (S // n_chunks) > n_groups * _MOE_CHUNK_TOKENS
               and (S // n_chunks) % 2 == 0):
            n_chunks *= 2
        sc = S // n_chunks
        outs, auxs = zip(*(moe_ffn(p, cfg, x[:, i * sc:(i + 1) * sc],
                                   n_groups) for i in range(n_chunks)))
        return torch.cat(outs, dim=1), torch.mean(torch.stack(auxs))
    if isinstance(x, DTensor):
        out, aux = _moe_mesh(p, cfg, x, n_groups)
    else:
        xin, slot, gate, aux = _dispatch(p["router"], p["router_bias"], cfg,
                                         x, n_groups)
        eo = _experts(xin, p["w1"], p["w3"], p["w2"])
        out = _combine(eo, slot, gate, B, S, x.dtype)
    if cfg.n_shared_experts:
        out = out + ffn(p["shared"], cfg, x)
    return out, aux


def update_router_bias(bias: torch.Tensor, expert_load: torch.Tensor,
                       step_size: float = 1e-3) -> torch.Tensor:
    """DeepSeek-V3 aux-loss-free balancing: nudge selection bias against
    overloaded experts. The reference's train loop never calls it, and
    neither does the port's."""
    target = torch.mean(expert_load)
    return bias + step_size * torch.sign(target - expert_load)
