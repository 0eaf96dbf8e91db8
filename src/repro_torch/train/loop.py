"""The training step — port of ``repro.train.loop``'s
``microbatch_grads`` and ``make_train_fn`` (loop.py:18-81): gradients of
``LM.loss`` by ``torch.autograd``, microbatched accumulation, then
``adamw.update`` (global-norm clip, AdamW, optional int8 moments).

Parameters are the model's own tensors, as a dict keyed by parameter name
(``params_of(model)``); a step updates them in place and returns the same
dict. A dict of other tensors (a restored checkpoint) is copied into the
model first.

On a mesh (``make_train_step``), the parameters are DTensors laid out by
the sharding rules, the optimizer state by ZeRO-1 (``state_shardings``),
the batch sharded over the data axes (``data.pipeline.make_global_batch``);
DTensor carries the layouts through the forward and backward, and K5-K7
run on each rank's local heads (``models.layers._flash_sdpa``). Plain
tensors that meet DTensors in the model (positions, masks, rope tables)
are taken as replicated. ``make_compressed_dp_step`` is the reference's
``shard_map`` data-parallel step with the int8 error-feedback all-reduce
(``optim.compress``).
"""
from __future__ import annotations

import math
import types

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models.lm import LM
from repro_torch.optim import adamw, compress
from repro_torch.sharding import rules


def params_of(model: LM) -> dict[str, torch.nn.Parameter]:
    """The model's parameters by name: the ``params`` a step takes."""
    return dict(model.named_parameters())


@torch.no_grad()
def bind(model: LM, params: dict) -> dict:
    """Make ``params`` the model's values: tensors that are not already
    the model's parameters are copied into them. Returns
    ``params_of(model)``."""
    own = params_of(model)
    if set(params) != set(own):
        raise KeyError(f"params name {sorted(set(params) ^ set(own))} "
                       f"differently from the model's parameters")
    for name, p in own.items():
        if params[name] is not p:
            p.copy_(params[name])
    return own


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor; others as they are."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _grads(model: LM, batch):
    """(loss, metrics, {name: grad}) of one batch (the batch dict, or its
    tokens); the gradients are taken off the parameters, so the returned
    dict holds the only reference. A parameter the loss does not reach
    (``router_bias``: selection is not differentiable) gets zeros, as
    ``jax.grad`` gives. A DTensor parameter's gradient comes back in the
    parameter's layout (partial sums reduced); the loss and metrics come
    back as plain tensors."""
    model.zero_grad(set_to_none=True)
    with implicit_replication():
        loss, metrics = model.loss(batch)
        loss.backward()
    grads = {}
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if isinstance(g, DTensor):
            g = g.redistribute(p.device_mesh, p.placements)
        grads[name] = g
        p.grad = None
    return (_plain(loss.detach()),
            {k: _plain(v.detach()) for k, v in metrics.items()}, grads)


def _split(batch: dict, n_micro: int) -> list[dict]:
    """``n_micro`` microbatches of ``batch``: every leaf split on axis 0
    into equal consecutive row blocks, as the reference's ``split``. A
    DTensor leaf's microbatch i holds rows i of the global batch,
    re-split over the batch axes (``rules.batch_spec``)."""
    parts = {}
    for k, x in batch.items():
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch of {b} rows ({k!r}) does not split into "
                             f"{n_micro} microbatches")
        if isinstance(x, DTensor):
            whole, bm = x.full_tensor(), b // n_micro
            parts[k] = [rules.distribute(
                whole[i * bm:(i + 1) * bm], x.device_mesh,
                rules.batch_spec(x.device_mesh, (bm, *x.shape[1:])))
                for i in range(n_micro)]
        else:
            parts[k] = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    return [{k: x[i] for k, x in parts.items()} for i in range(n_micro)]


def _accumulate(model: LM, batch: dict, n_micro: int,
                grad_dtype: torch.dtype | None):
    """(mean loss, mean metrics, grads) over ``n_micro`` microbatches of
    ``batch``'s rows (see ``microbatch_grads``)."""
    if n_micro == 1:
        return _grads(model, batch)
    mbs = _split(batch, n_micro)
    acc_dt = grad_dtype or torch.float32
    acc = {n: torch.zeros_like(p, dtype=acc_dt, requires_grad=False)
           for n, p in model.named_parameters()}
    lsum = torch.zeros((), dtype=torch.float32, device=model.device)
    msum: dict = {}
    for mb in mbs:
        loss, metrics, grads = _grads(model, mb)
        for n, g in grads.items():
            acc[n].add_(g.to(acc_dt))
        # the microbatch's gradients go before the next one's are made
        del grads
        lsum = lsum + loss
        for k, v in metrics.items():
            msum[k] = msum.get(k, 0.0) + v
    inv = 1.0 / n_micro
    # scaled in place: the same product, without a second accumulator
    return (lsum * inv, {k: v * inv for k, v in msum.items()},
            {n: g.mul_(inv).float() for n, g in acc.items()})


def microbatch_grads(model: LM, params: dict, batch: dict, n_micro: int,
                     grad_dtype: torch.dtype | None = None):
    """Mean loss + grads over ``n_micro`` microbatches of ``batch``'s rows
    (the whole batch dict: ``tokens`` and any ``frames`` / ``vision``).
    ``n_micro == 1`` returns the loss's metrics and grads in the
    parameters' dtype (as ``jax.value_and_grad``); more microbatches
    accumulate in ``grad_dtype`` (default float32) and return float32 grads
    and, as the reference, no metrics. There is no ``grad_specs``: a
    DTensor parameter's gradient, and its accumulator, already carry the
    parameter's layout."""
    bind(model, params)
    loss, metrics, grads = _accumulate(model, batch, n_micro, grad_dtype)
    return loss, (metrics if n_micro == 1 else {}), grads


def make_train_fn(model: LM, opt_cfg: adamw.AdamWConfig, n_micro: int = 1,
                  grad_dtype: torch.dtype | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: gradients, then one AdamW update of the model's parameters
    in place, with the reference's weight-decay rule (``LM.decays``).
    ``metrics`` holds ``loss``, ``aux`` (the MoE load-balancing loss, mean
    over the microbatches; 0 for a dense model), ``grad_norm`` and
    ``lr``."""
    decay = model.decays()

    def train_step(params, opt_state, batch):
        bind(model, params)
        loss, metrics, grads = _accumulate(model, batch, n_micro,
                                           grad_dtype)
        new_params, new_state, m = adamw.update(
            opt_cfg, grads, opt_state, params_of(model), decay=decay)
        return new_params, new_state, dict(m, loss=loss, aux=metrics["aux"])

    return train_step


# --- the mesh: ZeRO-1 state layouts and the sharded step ---------------------
def _state_spec_for(name: str, shape: tuple, part: str | None, mesh,
                    fsdp: bool, lead: tuple) -> rules.Spec:
    """The reference's ``_state_spec_for`` (loop.py:84-114) for a moment
    leaf of ``shape`` of parameter ``name``: a float32 moment or a
    ``QTensor``'s ``q`` / ``scale`` (``part``)."""
    pspec = rules.param_spec(name, shape, mesh, fsdp=fsdp, lead=lead)
    if part is not None:
        # Shape-preserving QTensor leaves: q mirrors the param's dims, so it
        # takes the PARAM's spec (the optimizer update is collective-free);
        # scale drops the last-dim sharding (its block dim is tiny).
        spec = list(pspec) + [None] * (len(shape) - len(pspec))
        if part == "scale":
            spec[-1] = None
        else:
            # q's padded last dim must still divide the assigned axis
            ax = spec[-1]
            axes = () if ax is None else ax if isinstance(ax, tuple) \
                else (ax,)
            if shape[-1] % math.prod(rules.sizes(mesh)[a] for a in axes):
                spec[-1] = None
        pspec = rules.Spec(*spec)
    return rules.zero1_state_spec(pspec, shape, mesh)


def state_shardings(opt_cfg: adamw.AdamWConfig, params: dict, mesh, *,
                    fsdp: bool = False, stacks: dict | None = None
                    ) -> adamw.OptState:
    """``NamedSharding``s for every leaf of ``adamw.init(opt_cfg,
    params)`` (ZeRO-1 over data; an int8 moment's ``q`` and ``scale``
    each by the reference's rule), in the state's structure; the step
    counter is a Python int and has none. ``stacks``: each parameter's
    reference stack dims (``LM.stack_dims()``). Only the parameters'
    shapes are read (meta tensors do, ``launch.specs``)."""
    stacks = stacks or {}

    def leaf(name, p):
        lead, shape = stacks.get(name, ()), tuple(p.shape)
        if opt_cfg.quantized_state:
            return adamw.QTensor(*(rules.NamedSharding(mesh, _state_spec_for(
                name, s, part, mesh, fsdp, lead)) for s, part in zip(
                    adamw.qtensor_shapes(shape), ("q", "scale"))), shape)
        return rules.NamedSharding(mesh, _state_spec_for(
            name, shape, None, mesh, fsdp, lead))

    return adamw.OptState(None, {n: leaf(n, p) for n, p in params.items()},
                          {n: leaf(n, p) for n, p in params.items()})


def zero_state(opt_cfg: adamw.AdamWConfig, params: dict,
               shardings: adamw.OptState) -> adamw.OptState:
    """``adamw.init(opt_cfg, params)`` laid out by ``shardings``
    (``state_shardings``) without any leaf made whole: every moment
    starts at zeros (an int8 moment's ``q`` and ``scale`` too, as
    ``quantize`` of zeros gives), so each rank makes only its own slices.
    Whole float32 moments of gemma-7b (8.5e9 parameters) would take 68 GB
    on every rank before ``place`` sliced them."""
    def zeros(shape, dtype, sh):
        return dtensor_zeros(shape, dtype=dtype, device_mesh=sh.mesh,
                             placements=rules.placements(sh.spec, sh.mesh))

    def leaf(name, sh):
        shape = tuple(params[name].shape)
        if isinstance(sh, adamw.QTensor):
            qs, ss = adamw.qtensor_shapes(shape)
            return adamw.QTensor(zeros(qs, torch.int8, sh.q),
                                 zeros(ss, torch.float32, sh.scale), shape)
        return zeros(shape, torch.float32, sh)

    return adamw.OptState(0, {n: leaf(n, sh) for n, sh in
                              shardings.m.items()},
                          {n: leaf(n, sh) for n, sh in shardings.v.items()})


def place(tree, shardings):
    """Every tensor of ``tree`` (whole and equal on every rank: a seeded
    build, a checkpoint) as a DTensor laid out by the matching
    ``NamedSharding`` of ``shardings`` (same structure; dicts, ``OptState``
    and ``QTensor``); each rank keeps its slice, nothing is sent."""
    if isinstance(shardings, rules.NamedSharding):
        return rules.distribute(tree, shardings.mesh, shardings.spec)
    if isinstance(tree, adamw.QTensor):
        return adamw.QTensor(place(tree.q, shardings.q),
                             place(tree.scale, shardings.scale), tree.shape)
    if isinstance(tree, adamw.OptState):
        return adamw.OptState(tree.step, place(tree.m, shardings.m),
                              place(tree.v, shardings.v))
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    return tree


@torch.no_grad()
def distribute_model(model: LM, shardings: dict) -> dict:
    """Replace each of the model's parameters by a DTensor parameter laid
    out by ``shardings[name]`` (``place``); returns ``params_of(model)``.
    Each whole parameter is let go once its slice replaces it, so that
    the whole model and all its slices are never held at once."""
    for name in [n for n, _ in model.named_parameters()]:
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        p = (mod[leaf] if isinstance(mod, torch.nn.ParameterDict)
             else getattr(mod, leaf))
        new = torch.nn.Parameter(place(p.detach(), shardings[name]),
                                 requires_grad=p.requires_grad)
        del p
        if isinstance(mod, torch.nn.ParameterDict):
            mod[leaf] = new
        else:
            setattr(mod, leaf, new)
    return params_of(model)


def make_train_step(model: LM, opt_cfg: adamw.AdamWConfig, mesh,
                    n_micro: int = 1, donate: bool = True,
                    fsdp: bool = False,
                    grad_dtype: torch.dtype | None = None):
    """Returns ``(train_step, shardings)``, as the reference's.
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` is ``make_train_fn``'s step on DTensors: parameters and
    state laid out on ``mesh``, the batch a ``make_global_batch`` dict
    (its gradients are the global batch's, the metrics plain tensors).
    ``shardings(params)`` returns a namespace: ``params`` and ``state``
    (``NamedSharding``s by ``rules.params_shardings`` and
    ``state_shardings``) and ``distribute(state)``, which puts the
    model's parameters and ``state["opt_state"]`` (from ``adamw.init`` of
    the whole parameters; without it, ``zero_state``'s, made in its
    layout) onto the mesh and returns the state dict the step takes.
    ``grad_dtype`` is the microbatch accumulator's dtype
    (``make_train_fn``), in the parameters' layout; the reference's
    ``make_train_step`` has none, its dry run passes a plan's to
    ``make_train_fn``. The update is in place, so nothing is donated
    (``donate`` is kept for the reference's signature)."""
    del donate
    train_step = make_train_fn(model, opt_cfg, n_micro,
                               grad_dtype=grad_dtype)
    stacks = model.stack_dims()

    def shardings(params: dict) -> types.SimpleNamespace:
        pshard = rules.params_shardings(params, mesh, fsdp=fsdp,
                                        stacks=stacks)
        sshard = state_shardings(opt_cfg, params, mesh, fsdp=fsdp,
                                 stacks=stacks)

        def distribute(state: dict) -> dict:
            params_d = distribute_model(model, pshard)
            opt = state.get("opt_state")
            return {"params": params_d,
                    "opt_state": (place(opt, sshard) if opt is not None
                                  else zero_state(opt_cfg, params_d,
                                                  sshard))}

        return types.SimpleNamespace(params=pshard, state=sshard,
                                     distribute=distribute)

    return train_step, shardings


# --- data-parallel step with int8 gradient compression ------------------------
def make_compressed_dp_step(model: LM, opt_cfg: adamw.AdamWConfig, mesh):
    """Pure data-parallel train step where the gradient all-reduce goes
    through int8 error-feedback compression (``optim.compress``), the
    reference's ``shard_map`` step (loop.py:146-170). Parameters are
    replicated: every rank holds the model's whole plain tensors; the
    batch is sharded over ``data`` (a ``make_global_batch`` dict, whose
    local rows each rank trains on, or this rank's rows as plain tensors).
    ``step(params, opt_state, err, batch) -> (params, opt_state, err,
    metrics)``: the local gradient goes through ``tree_compressed_psum``
    over the mesh's ``data`` dim, with the per-block leaves quantized as
    the reference's stacked leaves, the loss is averaged over it, and AdamW
    runs on every rank identically. ``err`` is this rank's error state
    (``compress.init_error``). ``step.stats`` holds the last all-reduce's
    ``payload_bytes`` and ``dense_bytes``."""
    group = (mesh, "data")
    decay = model.decays()
    stacks = model.reference_leaves()

    def step(params, opt_state, err, batch):
        bind(model, params)
        local = {k: v.to_local() if isinstance(v, DTensor) else v
                 for k, v in batch.items()}
        loss, metrics, grads = _grads(model, local)
        grads, new_err = compress.tree_compressed_psum(
            grads, err, group, stacks=stacks, stats=step.stats)
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=compress.process_group(group))
        loss = loss / mesh.size(mesh.mesh_dim_names.index("data"))
        new_params, new_state, m = adamw.update(
            opt_cfg, grads, opt_state, params_of(model), decay=decay)
        return new_params, new_state, new_err, dict(m, loss=loss,
                                                   aux=metrics["aux"])

    step.stats = {}
    return step
