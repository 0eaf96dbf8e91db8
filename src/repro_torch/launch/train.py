"""Training entry point of the port — counterpart of
``repro.launch.train``, with ``--device`` (default: the card).

The model runs with ``attn_impl="flash"``: every layer's attention goes
through K5 forward and, in the backward, K5 again in the per-layer
recompute (``cfg.remat``), then K6 and K7. With ``--ckpt-dir`` the steps run
under the fault ``Supervisor`` (checkpoints every ``--ckpt-every`` steps and
at the end, restart from the latest on a fault); without it they run
directly through the train step and nothing is written.

On a mesh — launched by ``torchrun`` (the process group from the
environment), inside a caller's process group, or with ``--model-axis`` —
the steps run through ``make_train_step`` on ``make_host_mesh(
--model-axis)``: parameters laid out by the sharding rules, the optimizer
state by ZeRO-1, each rank making only its own rows of the batch
(``make_global_batch``); ``--device cpu`` is gloo, the default the card
and NCCL. Only rank 0 prints.

``--arch`` takes the dense (llama3-8b, gemma-7b, ...), MoE
(mixtral-8x7b, deepseek-v3-671b) and state-space (zamba2-7b: K5, K6 and K7
in its shared attention block; rwkv6-1.6b: no kernel) architectures; a
step's line shows the MoE load-balancing loss (``aux``; 0 for the others).
``--layers`` on zamba2-7b takes any depth: whole groups of
``attn_every`` Mamba2 blocks, then a tail (``segments_for``). whisper-base and
llama-3.2-vision-90b train on batches with ``frames`` / ``vision``, which
the command line has no source for (as the reference's, which fails with
``KeyError: 'frames'``): ``build(args, extra_inputs=...)`` takes them from
a caller, and without them it raises a ``ValueError`` naming the input.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
      --steps 20 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --smoke --device cpu --model-axis 2 --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
import types

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.data.pipeline import (SyntheticLM, device_batch,
                                       local_rows, make_global_batch)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import LM, cross_inputs, segments_for
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.train import fault
from repro_torch.train import loop as tl


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="override the config's depth")
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="override the config's dtype")
    ap.add_argument("--head-dim", type=int, default=None,
                    help="override the config's head dim (on the card the "
                         "flash kernels take 32, 64, 80, 128 or 256; the "
                         "SMOKE config's is 8)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--quantized-state", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--model-axis", type=int, default=None,
                    help="TP size of the (data, model) mesh over the ranks")
    return ap.parse_args(argv)


def on_mesh(args: argparse.Namespace) -> bool:
    """Whether the run takes the mesh path: a process group exists (a
    caller's), ``torchrun`` set the environment, or ``--model-axis``."""
    return (dist.is_initialized() or "TORCHELASTIC_RUN_ID" in os.environ
            or ("RANK" in os.environ and "WORLD_SIZE" in os.environ)
            or args.model_axis is not None)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def config(args: argparse.Namespace):
    over = {"attn_impl": "flash"}
    if args.layers is not None:
        over["n_layers"] = args.layers
    if args.dtype is not None:
        over["dtype"] = args.dtype
    if args.head_dim is not None:
        over["head_dim"] = args.head_dim
    cfg = (registry.smoke_config(args.arch, **over) if args.smoke
           else registry.config(args.arch, **over))
    segments_for(cfg)        # raises on a depth the arch cannot take
    return cfg


def build(args: argparse.Namespace, extra_inputs=None, *,
          plan=None) -> types.SimpleNamespace:
    """The model (weights from seed 0 on the device), its optimizer
    and train step, the training state and the data: ``cfg``, ``model``,
    ``ocfg``, ``step_fn``, ``state`` ({"params", "opt_state"}) and
    ``data_fn(step)``. ``extra_inputs(step)`` gives the batch's
    ``frames`` / ``vision`` at a step (numpy (global_batch, T, d_model)
    arrays, ``models.lm.cross_inputs``), which an encoder-decoder or VLM
    needs.

    ``plan`` (a ``launch.dryrun.Plan``; the command line has no flag for
    one, as the reference's has none) runs the step as the dry run's
    cell does: its ``grad_dtype`` is the microbatch accumulator's dtype,
    and on a mesh ``fsdp`` shards the parameters over ``data`` too,
    ``ep_axes`` re-shards the MoE's slot rows over those axes, and the
    MoE dispatches a microbatch in one group a batch shard
    (``rules.batch_groups``); its ``n_micro`` and moments take the place
    of the arguments'. Without a plan: one group, a float32 accumulator,
    no fsdp."""
    if plan is not None:
        args = argparse.Namespace(**{**vars(args), "n_micro": plan.n_micro,
                                     "quantized_state": plan.quantized})
    cfg = config(args)
    need = cross_inputs(cfg)
    if need and extra_inputs is None:
        raise ValueError(
            f"{cfg.arch_id} trains on batches with "
            f"{', '.join(repr(k) for k in need)} (global_batch, T, d_model) "
            f"inputs, which launch.train has no source for; pass "
            f"build(args, extra_inputs=...)")
    dev = resolve_device(args.device)
    mesh = make_host_mesh(args.model_axis, device=dev) if on_mesh(args) \
        else None
    if dev.type == "cuda":
        if mesh is not None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    grad_dtype = None
    if plan is not None:
        grad_dtype = (getattr(torch, plan.grad_dtype) if plan.grad_dtype
                      else None)
        cfg = dataclasses.replace(
            cfg, moe_groups=rules.batch_groups(
                mesh, args.global_batch // args.n_micro),
            ep_axes=plan.ep_axes)
    model = LM(cfg, device=dev, seed=0, trainable=True)
    ocfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                             total_steps=args.steps,
                             quantized_state=args.quantized_state)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq_len,
                     global_batch=args.global_batch)
    params = tl.params_of(model)
    if mesh is None:
        state = {"params": params, "opt_state": adamw.init(ocfg, params)}
        return types.SimpleNamespace(
            cfg=cfg, model=model, ocfg=ocfg, mesh=None, shardings=None,
            step_fn=tl.make_train_fn(model, ocfg, n_micro=args.n_micro,
                                     grad_dtype=grad_dtype),
            state=state,
            data_fn=lambda s: device_batch(
                {"tokens": ds.batch_at(s),
                 **(extra_inputs(s) if need else {})}, dev))
    step_fn, shardings = tl.make_train_step(
        model, ocfg, mesh, n_micro=args.n_micro,
        fsdp=plan is not None and plan.fsdp, grad_dtype=grad_dtype)
    sh = shardings(params)
    lo, hi = local_rows(mesh, args.global_batch)

    def data_fn(s):
        extra = ({k: v[lo:hi] for k, v in extra_inputs(s).items()}
                 if need else {})
        return make_global_batch(mesh, {"tokens": ds.batch_at(s, lo, hi),
                                        **extra},
                                 global_batch=args.global_batch)

    # the optimizer state made in its layout, never whole on a rank
    return types.SimpleNamespace(
        cfg=cfg, model=model, ocfg=ocfg, mesh=mesh,
        shardings={"params": sh.params, "opt_state": sh.state},
        step_fn=step_fn, state=sh.distribute({}), data_fn=data_fn)


def train_steps(r: types.SimpleNamespace, first: int, last: int, *,
                on_step=None) -> list[dict]:
    """Steps ``first .. last - 1`` of ``build``'s run, without
    checkpoints; ``r.state`` advances. Each history entry's ``time_s`` is
    the host clock around the step, data included, up to the card's
    finishing it."""
    hist = []
    for s in range(first, last):
        t0 = time.perf_counter()
        p, o, m = r.step_fn(r.state["params"], r.state["opt_state"],
                            r.data_fn(s))
        r.state = {"params": p, "opt_state": o}
        m = {k: float(v) for k, v in m.items()}     # waits for the card
        hist.append({"step": s, "time_s": time.perf_counter() - t0, **m})
        if on_step is not None:
            on_step(hist[-1])
    return hist


def run(args: argparse.Namespace, *, on_step=None) -> list[dict]:
    """Train as the arguments say; returns the per-step history
    (``step``, ``time_s``, ``loss``, ``aux``, ``grad_norm``, ``lr``).
    ``on_step`` is called with each history entry (under the Supervisor,
    after the run)."""
    r = build(args)
    if not args.ckpt_dir:
        return train_steps(r, 0, args.steps, on_step=on_step)
    sup = fault.Supervisor(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    _, hist = sup.run(state=r.state, step_fn=r.step_fn, data_fn=r.data_fn,
                      n_steps=args.steps, shardings=r.shardings)
    if on_step is not None:
        for h in hist:
            on_step(h)
    return hist


def main(argv=None) -> list[dict]:
    args = parse(argv)

    def show(h):
        if _rank() == 0:
            print(f"step {h['step']} loss={h['loss']:.6f} "
                  f"aux={h['aux']:.6f} grad_norm={h['grad_norm']:.6f} "
                  f"lr={h['lr']:.6e} time_s={h['time_s']:.3f}", flush=True)

    hist = run(args, on_step=show)
    losses = [h["loss"] for h in hist]
    if _rank() == 0:
        print(f"steps={len(hist)} first_loss={losses[0]:.4f} "
              f"final_loss={losses[-1]:.4f} "
              f"mean_step_s={np.mean([h['time_s'] for h in hist]):.3f}")
    return hist


if __name__ == "__main__":
    main()
