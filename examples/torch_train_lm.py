"""End-to-end training on the PyTorch port: a reduced llama3-family model
for a few hundred steps on the card with the full substrate — data
pipeline, AdamW, checkpointing, the fault supervisor (a simulated node
failure at step min(120, steps // 2), then a restart from the latest
checkpoint) and the loss curve. The model runs with
``attn_impl="flash"``: the attention forward takes kernel K5 and its
backward K6 and K7 (the SMOKE config's head dim 8 padded to 32). The
port's counterpart of ``examples/train_lm.py``.

Checkpoints go to ``--out-dir``, by default a fresh temporary directory
that is removed at the end.

Run: PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
         [--arch llama3-8b] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.pipeline import SyntheticLM, make_global_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import LM
from repro_torch.optim import adamw
from repro_torch.train import fault
from repro_torch.train import loop as tl

CKPT_EVERY = 50
DEFAULT = object()


def main(argv=None, *, params=None, fail_at=DEFAULT) -> dict:
    """Train, print the loss curve and return it. ``params`` (numpy
    arrays in the reference's parameter tree) replace the seeded weights;
    ``fail_at`` is the step the simulated failure strikes (default
    min(120, steps // 2); None: no failure)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one, removed at the end)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if fail_at is DEFAULT:
        fail_at = min(120, args.steps // 2)

    cfg = registry.smoke_config(args.arch, attn_impl="flash")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    # a world of one rank unless a caller made one: it is closed on the way
    # out, so that nothing after this run finds a process group
    own_group = not dist.is_initialized()
    mesh = make_host_mesh(device=dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    try:
        model = (LM(cfg, device=dev, seed=0, trainable=True)
                 if params is None else
                 lm_params_from_numpy(cfg, params, device=dev))
        model.requires_grad_(True)
        ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20,
                                 total_steps=args.steps)
        step, shardings = tl.make_train_step(model, ocfg, mesh, n_micro=2,
                                             donate=False)
        ds = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch)
        sh = shardings(tl.params_of(model))
        state = sh.distribute({})

        def data_fn(s):
            return make_global_batch(mesh, {"tokens": ds.batch_at(s)},
                                     global_batch=args.batch)

        def fault_hook(s):
            if s == fail_at and not getattr(fault_hook, "fired", 0):
                fault_hook.fired = 1
                raise RuntimeError("simulated node failure")

        with (contextlib.nullcontext(args.out_dir) if args.out_dir
              else tempfile.TemporaryDirectory()) as ckpt_dir:
            sup = fault.Supervisor(ckpt_dir=ckpt_dir,
                                   ckpt_every=CKPT_EVERY, max_restarts=3)
            final, hist = sup.run(
                state=state, step_fn=step, data_fn=data_fn,
                n_steps=args.steps, fault_hook=fault_hook,
                shardings={"params": sh.params, "opt_state": sh.state})
        final_params = {k: (v.full_tensor() if hasattr(v, "full_tensor")
                            else v).detach()
                        for k, v in final["params"].items()}
    finally:
        if own_group:
            dist.destroy_process_group()

    losses = [h["loss"] for h in hist]
    failures = getattr(fault_hook, "fired", 0)
    print(f"\ntrained {args.steps} steps ({len(hist)} executed incl. "
          f"replays; "
          f"{'1 simulated failure, restarted from checkpoint' if failures else 'no failure'}"
          f") on {dev}")
    for i in range(0, len(losses), max(1, len(losses) // 12)):
        print(f"  step {hist[i]['step']:4d}  loss {losses[i]:.4f}")
    print(f"  final loss {losses[-1]:.4f}  (start {losses[0]:.4f})")
    improved = bool(np.mean(losses[-10:]) < np.mean(losses[:10]))
    if len(losses) >= 20:            # two windows of 10 that do not overlap
        assert improved, "loss did not improve"
        print("loss improved ✓")
    return {"device": str(dev), "steps": [h["step"] for h in hist],
            "losses": losses, "time_s": [h["time_s"] for h in hist],
            "fail_at": fail_at, "failures": failures, "improved": improved,
            "params": final_params}


if __name__ == "__main__":
    main()
