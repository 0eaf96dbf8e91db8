"""Parameter / activation / cache sharding rules — port of
``repro.sharding.rules``.

Mapping philosophy (megatron-style TP + DP, optional pod axis for DP):
  - batch dims       -> ("pod", "data") (or ("data",) single-pod)
  - attention heads, FFN hidden, expert dim, vocab -> "model"
  - layer-stack leading dims -> unsharded
  - norms / scalars / routers -> replicated

A ``Spec`` is one entry per tensor dim: None, an axis name, or a tuple of
axis names (the dim split over those axes, major to minor), as the
reference's ``PartitionSpec``. ``placements(spec, mesh)`` turns it into
DTensor placements: ``Shard(d)`` on every mesh dim that splits tensor dim
d, ``Replicate()`` on the others. The rules read only axis sizes, so
``mesh`` may be a ``DeviceMesh`` or a plain ``{axis: size}`` mapping.
``distribute``, ``place_cache`` and ``zero_cache`` put tensors onto a
``DeviceMesh`` by a spec (the reference's ``jax.device_put``);
``batch_groups`` is the MoE dispatch groups a batch's shards make.

Rules match on the *leaf name*, the last part of a dotted parameter name,
with "moe" / "shared" among the parts as context. The reference's
per-block leaves are stacked ``(n_blocks, ...)`` (a group's inner blocks
``(n_groups, k, ...)``); the port's are one block's. So ``param_spec``
takes those stack dims as ``lead``, applies the reference's rule to the
stacked shape, and drops them: the port's spec is the reference's with
the stack dims left out. ``zero1_state_spec`` has no such context; where
the reference's moments shard a stack dim, the port's layout differs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor

# leaf name -> spec over the LAST TWO dims (leading stack dims unsharded).
# "col" = shard output dim (last), "row" = shard input dim (-2), "rep" = none.
_COL = ("wq", "wk", "wv", "w1", "w3", "wuq", "wuk", "wuv", "wkr",
        "in_zx", "in_dt", "wr", "wg", "ww", "ck", "cr", "lm_head")
_ROW = ("wo", "w2", "out_proj", "cv")
_REP = ("router", "router_bias", "ln1", "ln2", "lnx", "x_ln", "x_ln2",
        "final_ln", "norm_g", "ln_g", "a_log", "dt_bias", "d_skip", "w_bias",
        "mix_r", "mix_k", "mix_v", "mix_w", "cmix_k", "x_gate", "xffn_gate",
        "wdq", "wdkv", "in_bc")


class Spec(tuple):
    """Per-dim sharding: each entry None, an axis name or a tuple of axis
    names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``
    (``mesh`` a ``DeviceMesh`` for ``placements``)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``'s dims. A dim split
    over several axes is one ``Shard`` on each, and DTensor splits in
    mesh order, so those axes must come in mesh order (the reference's
    major-to-minor); otherwise a ``ValueError``. An axis of size 1 splits
    nothing and stays ``Replicate()`` (DTensor will not reshape a sharded
    dim of size 1, a batch of one row)."""
    names = list(mesh.mesh_dim_names)
    size = dict(zip(names, mesh.shape))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"axis {a!r} of {spec} is not in the mesh "
                                 f"{names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"dim {d} of {spec} is split over {axes}, not "
                             f"in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {names[i]!r} splits two dims of "
                                 f"{spec}")
            if size[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def model_axis_size(mesh) -> int:
    return sizes(mesh)["model"]


def batch_axes(mesh):
    s = sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in s)


def _maybe(axis: str, dim_size: int, mesh):
    """Shard only if divisible (e.g. mixtral's 8 experts on a 16-way axis
    fall back to replication along E; their F dim is sharded instead)."""
    return axis if dim_size % sizes(mesh)[axis] == 0 else None


def _stacked_spec(name: str, shape: tuple, mesh, fsdp: bool) -> Spec:
    """The reference's ``param_spec`` of a leaf of ``shape`` (stack dims
    included) whose dotted name is ``name``."""
    names = name.split(".")
    leaf = names[-1]
    ndim = len(shape)
    in_moe = "moe" in names or "shared" in names
    ms = sizes(mesh)

    def tail(*spec):
        return Spec(*([None] * (ndim - len(spec)) + list(spec)))

    def fs(dim_size):
        """data-axis shard of the non-TP dim under fsdp."""
        if not fsdp or "data" not in ms:
            return None
        return "data" if dim_size % ms["data"] == 0 else None

    if leaf == "embed":
        v, d = shape
        return Spec(_maybe("model", v, mesh), fs(d))
    if leaf in ("u_bonus",):          # (H, N) rwkv per-head bonus
        return tail("model", None)
    if leaf == "conv_w":              # (k, d_inner + 2N): channels mixed ->
        return tail(None, None)       # replicated (small)
    if in_moe and leaf in ("w1", "w3", "w2"):
        # Expert parallelism: shard E over as many mesh axes as divide it.
        # deepseek-v3's 256 experts fill data x model = 256 (1 expert/chip);
        # mixtral's 8 experts don't divide either axis -> TP over F instead.
        e = shape[-3:][0]
        f_pos = 2 if leaf in ("w1", "w3") else 1        # F dim within (E,·,·)
        if e % (ms.get("data", 1) * ms["model"]) == 0:
            ax_e = ("data", "model")
        else:
            ax_e = _maybe("model", e, mesh)
        spec3: list = [ax_e, None, None]
        if ax_e is None:
            spec3[f_pos] = "model"
        return tail(*spec3)
    if leaf in _COL:
        return tail(fs(shape[-2]), _maybe("model", shape[-1], mesh))
    if leaf in _ROW:
        return tail(_maybe("model", shape[-2], mesh), fs(shape[-1]))
    return Spec()   # _REP, ndim <= 1 and the default: replicate


def param_spec(name: str, shape: tuple, mesh, *, fsdp: bool = False,
               lead: tuple = ()) -> Spec:
    """Spec of parameter ``name`` (dotted, as ``named_parameters``) of
    ``shape``, whose reference leaf carries the stack dims ``lead`` in
    front. ``fsdp=True`` additionally shards each matrix's non-TP dim over
    the data axis (ZeRO-3 / FSDP)."""
    full = tuple(lead) + tuple(shape)
    spec = list(_stacked_spec(name, full, mesh, fsdp))
    spec += [None] * (len(full) - len(spec))
    # a shard of a stack dim (a shared expert's (n_blocks, D, F) leaf,
    # whose n_blocks the reference's expert rule reads as E) has no dim
    # to land on here: the leaf stays whole along the rest
    return Spec(*spec[len(lead):])


def params_shardings(params: Mapping, mesh, *, fsdp: bool = False,
                     stacks: Mapping | None = None) -> dict:
    """``{name: NamedSharding}`` of every parameter; ``stacks`` gives each
    name's stack dims (``LM.stack_dims()``; default none)."""
    stacks = stacks or {}
    return {n: NamedSharding(mesh, param_spec(
        n, tuple(p.shape), mesh, fsdp=fsdp, lead=stacks.get(n, ())))
        for n, p in params.items()}


def _batch_axes_for(mesh, b: int):
    """Largest prefix of (pod, data) that divides the batch size (long_500k
    has global_batch=1 -> fully replicated batch)."""
    ms = sizes(mesh)
    ba = batch_axes(mesh)
    n = int(np.prod([ms[a] for a in ba])) if ba else 1
    if ba and b % n == 0:
        return ba
    if "data" in ms and b % ms["data"] == 0:
        return ("data",)
    return ()


def batch_spec(mesh, shape: tuple) -> Spec:
    """Inputs: shard the leading batch dim over (pod, data) when divisible."""
    if len(shape) == 0:
        return Spec()
    ba = _batch_axes_for(mesh, shape[0])
    return Spec(ba if ba else None, *([None] * (len(shape) - 1)))


def batch_shardings(batch: Mapping, mesh) -> dict:
    return {k: NamedSharding(mesh, batch_spec(mesh, tuple(np.shape(v))))
            for k, v in batch.items()}


def cache_spec(path: tuple, shape: tuple, mesh) -> Spec:
    """KV caches / states (``path``: the leaf's keys in the cache dict):
    leading stack dim unsharded, batch dim over (pod,data), heads/features
    over model where divisible."""
    name = path[-1]
    ndim = len(shape)
    if name == "len" or ndim == 0:
        return Spec()

    def ba_for(b_dim_size):
        ba = _batch_axes_for(mesh, b_dim_size)
        return ba if ba else None

    if name in ("k", "v"):            # (L..., B, T, Hkv, hd)
        hkv = shape[-2]
        if hkv % model_axis_size(mesh) == 0:
            # TP over kv heads
            return Spec(*([None] * (ndim - 4)), ba_for(shape[-4]), None,
                        "model", None)
        # GQA kv heads < model axis: sequence-shard the cache over T
        return Spec(*([None] * (ndim - 4)), ba_for(shape[-4]), "model",
                    None, None)
    if name in ("kv_c", "k_rope"):    # (L, B, T, R) — MLA latent: shard T
        return Spec(*([None] * (ndim - 3)), ba_for(shape[-3]), "model", None)
    if name in ("enc_out", "vision"):  # (B, T, D)
        return Spec(ba_for(shape[0]), None, None)
    if name == "ssm":                 # (L..., B, H, N, P)
        return Spec(*([None] * (ndim - 4)), ba_for(shape[-4]),
                    _maybe("model", shape[-3], mesh), None, None)
    if name == "conv":                # (L..., B, k, chans)
        return Spec(*([None] * (ndim - 3)), ba_for(shape[-3]), None,
                    _maybe("model", shape[-1], mesh))
    if name == "wkv":                 # (L, B, H, N, N)
        return Spec(*([None] * (ndim - 4)), ba_for(shape[-4]),
                    _maybe("model", shape[-3], mesh), None, None)
    if name in ("tm_prev", "cm_prev"):  # (L, B, 1, D)
        return Spec(*([None] * (ndim - 3)), ba_for(shape[-3]), None, None)
    # default: shard the batch-like dim if we can find it
    return Spec(*([None] * (ndim - 3)), ba_for(shape[-3]), None, None) \
        if ndim >= 3 else Spec()


def cache_shardings(cache: Mapping, mesh, path: tuple = ()) -> dict:
    """The cache's nested dict with a ``NamedSharding`` at every leaf
    (``len`` included, replicated)."""
    return {k: cache_shardings(v, mesh, path + (k,)) if isinstance(v, Mapping)
            else NamedSharding(mesh, cache_spec(path + (k,),
                                                tuple(np.shape(v)), mesh))
            for k, v in cache.items()}


def batch_groups(mesh, global_batch: int) -> int:
    """Number of MoE dispatch groups = number of batch shards (1 without
    a mesh)."""
    if mesh is None:
        return 1
    n = 1
    for a in _batch_axes_for(mesh, global_batch):
        n *= sizes(mesh)[a]
    return max(n, 1)


def distribute(t: torch.Tensor, mesh, spec: Spec) -> DTensor:
    """``t``, whole and equal on every rank, as a DTensor laid out by
    ``spec``: each rank keeps its own slice, nothing is sent. A slice
    that is a view of ``t`` (a split of its leading dim) is copied, so
    that the whole tensor's memory goes with ``t``. A meta ``t`` gives a
    meta DTensor (a layout: shapes and placements, no storage)."""
    d = distribute_tensor(t, mesh, placements(spec, mesh),
                          src_data_rank=None)
    local = d.to_local()
    if local.untyped_storage().nbytes() > local.numel() \
            * local.element_size():
        d = DTensor.from_local(local.clone(), mesh, d.placements,
                               run_check=False, shape=d.shape,
                               stride=d.stride())
    return d


def place_cache(tree: Mapping, shardings: Mapping) -> dict:
    """``distribute`` of every tensor of a cache dict by the matching
    ``NamedSharding`` of ``shardings`` (``cache_shardings``' tree); its
    Python-int ``len`` as it is."""
    return {k: (place_cache(v, shardings[k]) if isinstance(v, Mapping)
                else v if not isinstance(v, torch.Tensor)
                else distribute(v, shardings[k].mesh, shardings[k].spec))
            for k, v in tree.items()}


def zero_cache(layout: Mapping | None, device=None) -> dict | None:
    """A zero cache of ``layout``'s shapes, dtypes and DTensor placements
    (``place_cache`` of a meta cache: no storage read), each rank
    allocating only its own shard, on ``device`` (default: each leaf's
    own)."""
    if layout is None:
        return None
    out = {}
    for k, v in layout.items():
        if isinstance(v, Mapping):
            out[k] = zero_cache(v, device)
        elif isinstance(v, DTensor):
            out[k] = DTensor.from_local(
                torch.zeros(v._local_tensor.shape, dtype=v.dtype,
                            device=device or v.device),
                v.device_mesh, v.placements, run_check=False,
                shape=v.shape, stride=v.stride())
        else:
            out[k] = v
    return out


def zero1_state_spec(pspec: Spec, shape: tuple, mesh) -> Spec:
    """ZeRO-1: additionally shard optimizer moments over the data axis on the
    largest dim the param spec leaves unsharded (falls back to the param spec
    when nothing divides)."""
    ms = sizes(mesh)
    if "data" not in ms:
        return pspec
    n = ms["data"]
    spec = list(pspec) + [None] * (len(shape) - len(pspec))
    # axis already used (fsdp params / (data,model)-sharded experts)
    used = set()
    for s in spec:
        for a in (s if isinstance(s, tuple) else (s,)):
            used.add(a)
    if "data" in used:
        return pspec
    # choose the largest unsharded dim divisible by the data axis
    cands = [(shape[i], i) for i in range(len(shape))
             if spec[i] is None and shape[i] % n == 0]
    if not cands:
        return pspec
    _, i = max(cands)
    spec[i] = "data"
    return Spec(*spec)
