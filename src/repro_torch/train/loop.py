"""The training step — port of ``repro.train.loop``'s
``microbatch_grads`` and ``make_train_fn`` (loop.py:18-81): gradients of
``LM.loss`` by ``torch.autograd``, microbatched accumulation, then
``adamw.update`` (global-norm clip, AdamW, optional int8 moments).

Parameters are the model's own tensors, as a dict keyed by parameter name
(``params_of(model)``); a step updates them in place and returns the same
dict. A dict of other tensors (a restored checkpoint) is copied into the
model first. ZeRO-1 state shardings and the compressed data-parallel step
wait for the sharding slice.
"""
from __future__ import annotations

import torch

from repro_torch.models.lm import LM
from repro_torch.optim import adamw


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


def _grads(model: LM, batch):
    """(loss, metrics, {name: grad}) of one batch (the batch dict, or its
    tokens); the gradients are taken off the parameters, so the returned
    dict holds the only reference. A parameter the loss does not reach
    (``router_bias``: selection is not differentiable) gets zeros, as
    ``jax.grad`` gives."""
    model.zero_grad(set_to_none=True)
    loss, metrics = model.loss(batch)
    loss.backward()
    grads = {}
    for name, p in model.named_parameters():
        grads[name] = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _split(batch: dict, n_micro: int) -> list[dict]:
    """``n_micro`` microbatches of ``batch``: every leaf split on axis 0
    into equal consecutive row blocks, as the reference's ``split``."""
    parts = {}
    for k, x in batch.items():
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch of {b} rows ({k!r}) does not split into "
                             f"{n_micro} microbatches")
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
    acc = {n: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
           for n, p in model.named_parameters()}
    lsum = torch.zeros((), dtype=torch.float32, device=model.device)
    msum: dict = {}
    for mb in mbs:
        loss, metrics, grads = _grads(model, mb)
        for n, g in grads.items():
            acc[n].add_(g.to(acc_dt))
        lsum = lsum + loss
        for k, v in metrics.items():
            msum[k] = msum.get(k, 0.0) + v
    inv = 1.0 / n_micro
    return (lsum * inv, {k: v * inv for k, v in msum.items()},
            {n: (g * inv).float() for n, g in acc.items()})


def microbatch_grads(model: LM, params: dict, batch: dict, n_micro: int,
                     grad_dtype: torch.dtype | None = None):
    """Mean loss + grads over ``n_micro`` microbatches of ``batch``'s rows
    (the whole batch dict: ``tokens`` and any ``frames`` / ``vision``).
    ``n_micro == 1`` returns the loss's metrics and grads in the
    parameters' dtype (as ``jax.value_and_grad``); more microbatches
    accumulate in ``grad_dtype`` (default float32) and return float32 grads
    and, as the reference, no metrics."""
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
