"""Multi-GPU dry run — port of ``repro.launch.dryrun``: every
(architecture x input shape) cell's step counted on the production mesh,
and its roofline terms.

The reference compiles each cell for 512 forced CPU devices and parses the
HLO. The port runs the cell's step once on the meta device (shapes and
dtypes, no storage) over a fake process group of 256 ranks (512 with
``--mesh multi``), made by the CLI in its own process (``fake_world``):
``launch.mesh.make_production_mesh`` finds the world it needs, the mesh's
device type is ``"cpu"``, the parameters, optimizer state, caches and
batch are meta DTensors laid out by ``sharding.rules``, and
``launch.op_analysis`` counts what this rank dispatches, at local shapes:

  compute_s    = flops_per_dev / PEAK_FLOPS
  memory_s     = bytes_per_dev / HBM_BW
  collective_s = collective_bytes_per_dev / LINK_BW

No cell touches a card. The fake group's collectives move nothing, and
DTensor on a ``"cpu"`` mesh turns a shard-to-shard redistribution into an
all-gather and a chunk where NCCL would run an all-to-all.

Flash plans raise a ``ValueError``: K5-K7 are ctypes calls, which no
dispatch mode sees, and no reference plan asks for them. ``--hlo`` is
left out: there is no HLO. The record's ``lower_s`` and ``compile_s``
become ``trace_s`` (the meta run's wall time); ``xla_cost`` is left out.

Usage:
  python -m repro_torch.launch.dryrun --all --mesh single --out /tmp/d
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \\
      --mesh single --out /tmp/d
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import registry
from repro_torch.launch import op_analysis, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.lm import LM
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.train import loop as train_loop

# H100 SXM constants (per GPU)
PEAK_FLOPS = 989e12     # bf16 dense tensor peak, NVIDIA H100 datasheet
HBM_BW = 3.35e12        # bytes/s HBM3, NVIDIA H100 SXM datasheet
# bytes/s: one 400 Gb/s ConnectX-7 NIC per GPU in a DGX H100; the (16, 16)
# mesh's axes span nodes of 8 GPUs, so the NIC sets the pace
LINK_BW = 50e9


# Per-arch dry-run options (the reference's, field for field). fsdp: shard
# params over data too. quantized: int8 AdamW moments. n_micro:
# gradient-accumulation microbatches for the train_4k cell. ep_axes and
# grad_dtype as the reference's; constrain_grads is kept for the record
# (a DTensor gradient already carries its parameter's layout).
@dataclasses.dataclass(frozen=True)
class Plan:
    fsdp: bool = False
    quantized: bool = False
    n_micro: int = 1
    attn_impl: str = "einsum"
    ep_axes: tuple | None = None
    grad_dtype: str | None = None
    constrain_grads: bool = False


PLANS: dict[str, Plan] = {
    "mixtral-8x7b": Plan(n_micro=2),
    "deepseek-v3-671b": Plan(quantized=True, n_micro=8, fsdp=True),
    "deepseek-coder-33b": Plan(n_micro=4),
    "gemma-7b": Plan(n_micro=2),
    "minitron-8b": Plan(n_micro=2),
    "llama3-8b": Plan(n_micro=2),
    "zamba2-7b": Plan(n_micro=2),
    "rwkv6-1.6b": Plan(n_micro=1),
    "llama-3.2-vision-90b": Plan(fsdp=True, quantized=True, n_micro=8),
    "whisper-base": Plan(n_micro=1),
}

OPT_PLANS: dict[str, Plan] = dict(PLANS)
OPT_PLANS["deepseek-v3-671b"] = dataclasses.replace(
    OPT_PLANS["deepseek-v3-671b"], ep_axes=("data", "model"),
    grad_dtype="bfloat16", fsdp=False, constrain_grads=True)
OPT_PLANS["llama-3.2-vision-90b"] = dataclasses.replace(
    OPT_PLANS["llama-3.2-vision-90b"], grad_dtype="bfloat16")

META = torch.device("meta")


def fake_world(world_size: int, rank: int = 0) -> None:
    """The default process group: a fake one of ``world_size`` ranks (this
    process ``rank``, default 0), whose collectives move nothing — the
    counterpart of the reference's forced CPU devices. Replaces a fake
    group of another size or rank; raises if a real group exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs its own process: a "
                               f"{dist.get_backend()} group exists")
        if (dist.get_world_size(), dist.get_rank()) == (world_size, rank):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def _tokens(shape: tuple, vocab: int, device, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, vocab, size=shape,
                                        dtype=np.int32), device=device)


def _inputs(cfg, c, device, seed: int) -> dict:
    """The batch of a train or prefill cell: ``specs.model_inputs``'
    stand-ins on meta, else tokens (and frames / vision, normal * 0.1)
    drawn from ``seed`` on ``device``."""
    meta = specs.model_inputs(cfg, c)
    if device.type == "meta":
        return meta
    rng = np.random.default_rng(seed + 1)
    out = {"tokens": _tokens(tuple(meta["tokens"].shape), cfg.vocab, device,
                             seed)}
    for k, v in meta.items():
        if k != "tokens":
            out[k] = torch.as_tensor(
                (rng.standard_normal(tuple(v.shape)) * 0.1).astype(
                    np.float32), device=device)
    return out


def build_cell(arch: str, shape: str, mesh, plan: Plan, *, cfg=None,
               cell=None, device=META, seed: int = 0):
    """Returns ``(fn, args, cfg, cell)`` for the cell's step program:
    ``fn(*args)`` runs one step. ``mesh=None`` is a world of one, plain
    tensors; on a ``DeviceMesh`` every argument is a DTensor laid out by
    the sharding rules. ``cfg`` / ``cell`` replace the registry's config
    and the cell's shape (the tests' small cells); ``device`` other than
    meta builds the model with weights from ``seed`` there."""
    if plan.attn_impl == "flash":
        raise ValueError(
            "the dry run counts einsum attention: K5-K7 are ctypes calls, "
            "which no dispatch mode sees (Plan(attn_impl='flash'))")
    device = torch.device(device)
    c = cell or specs.cell(arch, shape)
    cfg = cfg or registry.config(arch)
    cfg = dataclasses.replace(
        cfg,
        moe_groups=rules.batch_groups(
            mesh, c.global_batch if c.kind != "train"
            else c.global_batch // plan.n_micro),
        attn_impl=plan.attn_impl,
        ep_axes=plan.ep_axes)
    train = c.kind == "train"
    if device.type == "meta":
        model = specs.build(cfg)
        model.requires_grad_(train)
    else:
        model = LM(cfg, device=device, seed=seed, trainable=train)
    params = train_loop.params_of(model)
    stacks = model.stack_dims()

    if train:
        ocfg = adamw.AdamWConfig(quantized_state=plan.quantized)
        gdt = getattr(torch, plan.grad_dtype) if plan.grad_dtype else None
        fn = train_loop.make_train_fn(model, ocfg, plan.n_micro,
                                      grad_dtype=gdt)
        batch = _inputs(cfg, c, device, seed)
        if mesh is None:
            state = (specs.opt_state_specs(ocfg, specs.params_specs(model))
                     if device.type == "meta" else adamw.init(ocfg, params))
            return fn, (params, state, batch), cfg, c
        _, shardings = train_loop.make_train_step(
            model, ocfg, mesh, n_micro=plan.n_micro, fsdp=plan.fsdp)
        sh = shardings(params)
        # on a device the state is made in its layout (zero_state) and
        # each whole parameter let go once laid out, as launch.train's
        # build: deepseek-v3-671b's whole int8 moments beside its whole
        # weights would fill a card
        state = ({"opt_state": specs.opt_state_specs(
            ocfg, specs.params_specs(model))} if device.type == "meta"
                 else {})
        del params
        placed = sh.distribute(state)
        batch = train_loop.place(batch, rules.batch_shardings(batch, mesh))
        return fn, (placed["params"], placed["opt_state"], batch), cfg, c

    if mesh is not None:
        params = train_loop.distribute_model(model, rules.params_shardings(
            params, mesh, fsdp=plan.fsdp, stacks=stacks))

    if c.kind == "prefill":
        batch = _inputs(cfg, c, device, seed)
        layout = None
        if mesh is not None:
            batch = train_loop.place(batch,
                                     rules.batch_shardings(batch, mesh))
            # the cache the program makes, laid out as the reference's
            # out_shardings: its shapes and placements (no storage read)
            cache = specs.cache_specs(model, c.global_batch, c.seq_len)
            layout = rules.place_cache(cache,
                                        rules.cache_shardings(cache, mesh))

        def prefill(p, b):
            with implicit_replication():
                return model.prefill(b, max_len=c.seq_len,
                                     cache=rules.zero_cache(layout))

        return prefill, (params, batch), cfg, c

    # decode: one new token against a seq_len KV cache, whose Python-int
    # len is seq_len - 1 so that the step reads all of it (as the
    # reference's compiled decode does)
    cache = model.init_cache(c.global_batch, c.seq_len)
    cache["len"] = c.seq_len - 1
    toks = (specs.decode_token_specs(c) if device.type == "meta" else
            _tokens((c.global_batch,), cfg.vocab, device, seed))
    if mesh is not None:
        cache = rules.place_cache(cache, rules.cache_shardings(cache, mesh))
        toks = train_loop.place(toks, rules.NamedSharding(
            mesh, rules.batch_spec(mesh, tuple(toks.shape))))

    def decode(p, cache, toks):
        with implicit_replication():
            return model.decode(cache, toks)

    return decode, (params, cache, toks), cfg, c


def count_cell(fn, args, device=META):
    """Run the step once under ``op_analysis``. Returns (analyzer, its
    output, wall seconds)."""
    t0 = time.perf_counter()
    a, out = op_analysis.count(fn, *args, device=device)
    return a, out, time.perf_counter() - t0


def roofline(flops: float, bytes_: float, coll_bytes: float) -> dict:
    """The H100 roofline terms (seconds) and the dominant one."""
    r = {"compute_s": flops / PEAK_FLOPS, "memory_s": bytes_ / HBM_BW,
         "collective_s": coll_bytes / LINK_BW}
    r["dominant"] = max(r, key=r.get)
    return r


def model_flops(cfg, c) -> float:
    """6 * N_active * tokens (train has fwd+bwd = 3x fwd; decode/prefill
    are fwd-only = 2 * N_active * tokens)."""
    tokens = (c.global_batch * c.seq_len if c.kind != "decode"
              else c.global_batch)
    factor = 6.0 if c.kind == "train" else 2.0
    return factor * cfg.active_param_count() * tokens


def record(rec: dict, a, out, cfg, c, chips: int) -> dict:
    """Fill ``rec`` with the counts of analyzer ``a`` for the cell's
    output ``out``: memory, cost, collectives, roofline, model flops."""
    an = a.analyze()
    rec["memory"] = a.memory(out)
    rec["cost"] = {"flops_per_dev": an["flops_per_dev"],
                   "bytes_per_dev": an["bytes_per_dev"],
                   "matmul_flops_per_dev": a.cost.flops,
                   "n_ops": a.n_ops}
    rec["collectives"] = dict(an["collectives"],
                              total_bytes=an["collective_bytes_per_dev"])
    fl = an["flops_per_dev"]
    rec["roofline"] = roofline(fl, an["bytes_per_dev"],
                               an["collective_bytes_per_dev"])
    rec["model_flops_total"] = model_flops(cfg, c)
    total = fl * chips
    rec["useful_flops_frac"] = (rec["model_flops_total"] / total
                                if total else 0.0)
    return rec


def run_cell(arch: str, shape: str, mesh_kind: str, opt: bool = False
             ) -> dict:
    """One cell on the production mesh of this process's fake world
    (``fake_world(256)``, or 512 for ``"multi"``)."""
    multi = mesh_kind == "multi"
    plan = (OPT_PLANS if opt else PLANS)[arch]
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                 "chips": 512 if multi else 256, "opt": opt,
                 "plan": dataclasses.asdict(plan)}
    try:
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        rec["chips"] = int(np.prod(mesh.shape))
        fn, args, cfg, c = build_cell(arch, shape, mesh, plan)
        a, out, secs = count_cell(fn, args)
        rec["trace_s"] = round(secs, 1)
        record(rec, a, out, cfg, c, rec["chips"])
        rec["ok"] = True
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def cells_to_run(args) -> list[tuple[str, str]]:
    cells = []
    for arch in registry.ALIASES:
        if args.arch and arch != args.arch:
            continue
        for shape in registry.shapes_for(arch):
            if args.shape and shape != args.shape:
                continue
            cells.append((arch, shape))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--opt", action="store_true",
                    help="use OPT_PLANS (EP dispatch, bf16 accumulators)")
    args = ap.parse_args(argv)
    # DTensor warns at every two-axis partial reduction of a 2-d mesh
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)
    cells = cells_to_run(args)
    n_fail = 0
    for mk in meshes:
        fake_world(512 if mk == "multi" else 256)
        for arch, shape in cells:
            path = os.path.join(args.out, f"{arch}__{shape}__{mk}.json")
            rec = run_cell(arch, shape, mk, opt=args.opt)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if rec["ok"]:
                r = rec["roofline"]
                print(f"OK   {arch:22s} {shape:12s} {mk:6s} "
                      f"trace={rec['trace_s']:6.1f}s "
                      f"comp={r['compute_s']:.3e} mem={r['memory_s']:.3e} "
                      f"coll={r['collective_s']:.3e} dom={r['dominant']} "
                      f"peak={rec['memory']['peak_bytes'] / 1e9:.2f}GB "
                      f"useful={rec['useful_flops_frac']:.2f}",
                      flush=True)
            else:
                n_fail += 1
                print(f"FAIL {arch:22s} {shape:12s} {mk:6s} {rec['error']}",
                      flush=True)
    print(f"done: {len(cells) * len(meshes) - n_fail} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
