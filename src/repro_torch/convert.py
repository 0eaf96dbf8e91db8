"""State carried into the port from plain numpy and Python values.

A scheduler has no weights: what must match between the reference and the
port is the fleet state, the pod queue and the weighting schemes. These
functions build the port's objects from values any caller can produce —
for instance the columns of a reference ``NodeTable`` mid-run — without
importing the reference. Weight vectors need no conversion: they stay
numpy ``(C,)`` / ``(S, C)`` arrays.

An LM's weights come across as the reference's parameter pytree in nested
dicts of numpy arrays (``lm_params_from_numpy``), and go back the same way
(``lm_params_to_numpy``, which also takes gradients or any other tensors
named as the LM's parameters).
"""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.cluster.node import FleetState, Node
from repro_torch.cluster.workload import WORKLOADS, Pod, WorkloadSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM
from repro_torch.train.loop import distribute_model

# NodeTable fields, in declaration order. The first eight (and the two
# list columns) define the nodes; the three profile columns are derived
# from the node class and only checked.
NODE_COLUMNS = ("names", "node_class", "vcpus", "mem_gb", "reserved_cpu",
                "reserved_mem", "used_cpu", "used_mem", "speed",
                "dyn_power_per_vcpu", "idle_power", "region", "power_state")
_PROFILE_COLUMNS = ("speed", "dyn_power_per_vcpu", "idle_power")


def fleet_from_columns(columns: Mapping[str, "np.ndarray | list"]
                       ) -> FleetState:
    """A port :class:`FleetState` (its ``Node`` list is ``.nodes``) from
    ``NodeTable``'s fields. ``region`` and ``power_state`` may be omitted
    (defaults: ``"default"`` and no lifecycle); the profile columns, when
    given, must equal what the node classes imply."""
    missing = [k for k in NODE_COLUMNS[:8] if k not in columns]
    if missing:
        raise KeyError(f"fleet columns missing {missing}")
    n = len(columns["names"])
    region = list(columns.get("region", ())) or ["default"] * n
    power_state = list(columns.get("power_state", ())) or [None] * n
    f64 = {k: np.asarray(columns[k], dtype=np.float64)
           for k in ("vcpus", "mem_gb", "reserved_cpu", "reserved_mem",
                     "used_cpu", "used_mem")}
    for k, col in [("node_class", columns["node_class"]),
                   ("region", region), ("power_state", power_state),
                   *f64.items()]:
        if len(col) != n:
            raise ValueError(f"column {k!r} has {len(col)} entries, "
                             f"expected {n}")
    nodes = [Node(str(columns["names"][i]), str(columns["node_class"][i]),
                  float(f64["vcpus"][i]), float(f64["mem_gb"][i]),
                  reserved_cpu=float(f64["reserved_cpu"][i]),
                  reserved_mem=float(f64["reserved_mem"][i]),
                  used_cpu=float(f64["used_cpu"][i]),
                  used_mem=float(f64["used_mem"][i]),
                  region=str(region[i]), power_state=power_state[i])
             for i in range(n)]
    fleet = FleetState.from_nodes(nodes)
    for k in _PROFILE_COLUMNS:
        if k in columns and not np.array_equal(
                np.asarray(columns[k], dtype=np.float64), getattr(fleet, k)):
            raise ValueError(f"column {k!r} disagrees with the node-class "
                             f"energy profiles")
    return fleet


def pods_from_records(records: Iterable[tuple]) -> list[Pod]:
    """Pods from ``(uid, kind, cpu, mem, base_time_s, scheduler,
    deferrable, deadline_s)`` records. A record whose kind and requests
    match a Table-II workload shares that ``WorkloadSpec``; any other gets
    its own."""
    pods = []
    for uid, kind, cpu, mem, bts, scheduler, deferrable, deadline_s \
            in records:
        spec = WORKLOADS.get(kind)
        if spec is None or (spec.cpu_request, spec.mem_request,
                            spec.base_time_s) != (cpu, mem, bts):
            spec = WorkloadSpec(str(kind), float(cpu), float(mem),
                                float(bts), "")
        pods.append(Pod(int(uid), spec, str(scheduler),
                        deferrable=bool(deferrable),
                        deadline_s=float(deadline_s)))
    return pods


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor of ``a``'s values. A bfloat16 array (``ml_dtypes``, as
    ``np.asarray`` of a bf16 JAX array gives) goes through its bits."""
    shape = np.shape(a)
    a = np.ascontiguousarray(a)          # (ndim >= 1: a scalar gains an axis)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.reshape(shape)


def lm_params_from_numpy(cfg: ModelConfig, tree: Mapping, *,
                         device=None, shardings: Mapping | None = None):
    """The port's ``LM`` with the reference's parameters: ``tree`` is
    ``repro.models.lm.build(cfg).init(key)`` as nested dicts of numpy
    arrays, each segment's leaves stacked on axis 0 (``dense``;
    mixtral's ``moe``; deepseek's ``dense_prefix`` and ``moe``, with the
    expert, router and shared-expert leaves and the MLA weights;
    whisper's ``enc`` and ``dec``; a VLM's ``vlm``, whose ``selfs`` leaves
    are stacked (n_groups, k, ...) and whose gates are (n_groups,);
    zamba2's ``mamba_group``, whose ``mambas`` are stacked (n_groups, k,
    ...), its ``mamba_tail`` and the unstacked top-level ``shared_attn``;
    rwkv6's ``rwkv``). Weights keep the reference's layout; key sets,
    shapes and dtypes are checked. With ``shardings`` (``{name:
    rules.NamedSharding}``, as ``train.loop.make_train_step``'s
    ``shardings(params).params``) the parameters come back as DTensors laid
    out by them, each rank keeping its slice."""
    model = LM(cfg, device=device, seed=None)

    def put(dst: torch.Tensor, a, name: str) -> None:
        t = tensor_from_numpy(np.asarray(a))
        if tuple(t.shape) != tuple(dst.shape) or t.dtype != dst.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(dst.shape)} {dst.dtype}")
        dst.copy_(t)

    def fill(module: nn.Module, node: Mapping, at: tuple, lead: tuple,
             name: str) -> None:
        """Leaves of ``module`` from slice ``at`` of the stacked ``lead +
        (...)`` leaves of ``node``; a ``ModuleList`` child (a group's
        ``selfs``) takes one more stacked axis."""
        own = dict(module.named_parameters(recurse=False))
        kids = dict(module.named_children())
        if set(node) != set(own) | set(kids):
            raise KeyError(f"{name} has {sorted(node)}, expected "
                           f"{sorted(set(own) | set(kids))}")
        for k, dst in own.items():
            if np.shape(node[k])[:len(lead)] != lead:
                raise ValueError(f"{name}.{k}: {np.shape(node[k])}, "
                                 f"expected leading axes {lead}")
            put(dst, node[k][at], f"{name}.{k}{list(at)}")
        for k, kid in kids.items():
            if isinstance(kid, nn.ModuleList):
                for i, sub in enumerate(kid):
                    fill(sub, node[k], at + (i,), lead + (len(kid),),
                         f"{name}.{k}")
            else:
                fill(kid, node[k], at, lead, f"{name}.{k}")

    expected = {"embed", "final_ln"} | {s.name for s in model.segments} | (
        set() if cfg.tie_embeddings else {"lm_head"}) | (
        {"shared_attn"} if model.shared_attn is not None else set())
    if set(tree) != expected:
        raise KeyError(f"parameter tree has {sorted(tree)}, expected "
                       f"{sorted(expected)}")
    with torch.no_grad():
        put(model.embed, tree["embed"], "embed")
        put(model.final_ln, tree["final_ln"], "final_ln")
        if model.lm_head is not None:
            put(model.lm_head, tree["lm_head"], "lm_head")
        for seg, idx in model.segment_blocks():
            for j, i in enumerate(idx):
                fill(model.blocks[i], tree[seg.name], (j,), (seg.n_blocks,),
                     seg.name)
        if model.shared_attn is not None:
            fill(model.shared_attn, tree["shared_attn"], (), (),
                 "shared_attn")
    if shardings is not None:
        distribute_model(model, shardings)
    return model


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` (a DTensor gathered whole); bfloat16 (which
    numpy has not got) comes back as float32, exactly."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def lm_params_to_numpy(model: LM, tensors: Mapping[str, torch.Tensor]
                       | None = None) -> dict:
    """The inverse of ``lm_params_from_numpy``: the reference's parameter
    pytree as nested dicts of numpy arrays, with each segment's block
    leaves stacked on axis 0 (a group's ``selfs`` or ``mambas`` on axes 0
    and 1; ``shared_attn`` unstacked).
    ``tensors`` maps the LM's parameter names (``"embed"``,
    ``"blocks.3.attn.wq"``, ``"blocks.1.moe.shared.w1"``,
    ``"blocks.0.selfs.2.ln1"``, ``"shared_attn.attn.wq"``, ...) to
    tensors of their shapes, such as
    the gradients of a training step; default: the parameters
    themselves."""
    if tensors is None:
        tensors = dict(model.named_parameters())
    names = [n for n, _ in model.named_parameters()]
    if set(tensors) != set(names):
        raise KeyError(f"tensors name {sorted(set(tensors) ^ set(names))} "
                       f"differently from the model's parameters")

    def stack(trees: list):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    def tree_of(module: nn.Module, prefix: str) -> dict:
        node = {k: tensor_to_numpy(tensors[prefix + k])
                for k, _ in module.named_parameters(recurse=False)}
        for k, kid in module.named_children():
            if isinstance(kid, nn.ModuleList):
                node[k] = stack([tree_of(sub, f"{prefix}{k}.{i}.")
                                 for i, sub in enumerate(kid)])
            else:
                node[k] = tree_of(kid, f"{prefix}{k}.")
        return node

    tree = {k: tensor_to_numpy(tensors[k])
            for k in ("embed", "final_ln", "lm_head") if k in tensors}
    for seg, idx in model.segment_blocks():
        tree[seg.name] = stack([tree_of(model.blocks[i], f"blocks.{i}.")
                                for i in idx])
    if model.shared_attn is not None:
        tree["shared_attn"] = tree_of(model.shared_attn, "shared_attn.")
    return tree
