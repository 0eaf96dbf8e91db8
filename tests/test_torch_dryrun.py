"""The multi-GPU dry run (``repro_torch.launch.dryrun``) against the
reference ``repro.launch.dryrun``: its cells, plans and model flops; the
per-device argument bytes of every cell on the fake (16, 16) production
mesh against the reference's shard shapes; the SMOKE cells on a fake
(4, 2) mesh; and, at a world of one, the matmul flops of the SMOKE
programs against the reference's ``hlo_analysis`` of the same programs
compiled for one CPU device.

A fake process group lives in a subprocess (``run_py``), so that this
process keeps no default group, and each subprocess pays DTensor's
warm-up once."""
import argparse
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import registry as rregistry
from repro.launch import hlo_analysis as H
from repro.launch import specs as rspecs
from repro.models import lm as rlm
from repro.optim import adamw as radamw
from repro.sharding import rules as rrules
from repro.train import loop as rloop
from repro_torch.configs import registry
from repro_torch.launch import dryrun, specs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a in rregistry.ALIASES for s in rregistry.shapes_for(a)]
SIZES = {"data": 16, "model": 16}


def run_py(code: str, timeout=900) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=timeout,
                         env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def rdryrun():
    """The reference's dry-run module. Importing it sets XLA_FLAGS (512
    forced devices) for every process started later; that is put back."""
    old = os.environ.get("XLA_FLAGS")
    mod = importlib.import_module("repro.launch.dryrun")
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return mod


def test_cells_to_run_equal_reference(rdryrun):
    for arch, shape in [(None, None), ("llama3-8b", None),
                        (None, "decode_32k"), ("zamba2-7b", "long_500k")]:
        ns = argparse.Namespace(arch=arch, shape=shape)
        assert dryrun.cells_to_run(ns) == rdryrun.cells_to_run(ns)
    assert len(dryrun.cells_to_run(argparse.Namespace(arch=None,
                                                      shape=None))) == 32


def test_plans_equal_reference(rdryrun):
    for mine, ref in ((dryrun.PLANS, rdryrun.PLANS),
                      (dryrun.OPT_PLANS, rdryrun.OPT_PLANS)):
        assert list(mine) == list(ref)
        for arch in ref:
            assert dataclasses.asdict(mine[arch]) == \
                dataclasses.asdict(ref[arch])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_total_exact(arch, shape):
    """The reference's 6 (train) or 2 * N_active * tokens, exactly."""
    rc, rcfg = rspecs.cell(arch, shape), rregistry.config(arch)
    tokens = (rc.global_batch * rc.seq_len if rc.kind != "decode"
              else rc.global_batch)
    want = (6.0 if rc.kind == "train" else 2.0) * \
        rcfg.active_param_count() * tokens
    assert dryrun.model_flops(registry.config(arch),
                              specs.cell(arch, shape)) == want


def test_flash_plans_raise():
    with pytest.raises(ValueError, match="ctypes"):
        dryrun.build_cell("llama3-8b", "train_4k", None,
                          dryrun.Plan(attn_impl="flash"))


# --- argument bytes on the production mesh ----------------------------------
_ARGS = """
import json
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim import adamw
dryrun.fake_world(256)
mesh = make_production_mesh(device="cpu")

def nbytes(t):
    return t._local_tensor.untyped_storage().nbytes()

def flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, path + (k,))
        elif hasattr(v, "_local_tensor"):
            yield "/".join(path + (k,)), nbytes(v)

out = {}
for arch, shape in dryrun.cells_to_run(type("A", (), {"arch": None,
                                                      "shape": None})):
    fn, args, cfg, c = dryrun.build_cell(arch, shape, mesh,
                                         dryrun.PLANS[arch])
    rec = {"total": sum(t.numel() * t.element_size()
                        for t in op_analysis.local_tensors(args)),
           "params": dict(flat(args[0]))}
    if c.kind == "train":
        st = args[1]
        rec["state"] = {}
        for mom in ("m", "v"):
            for n, t in getattr(st, mom).items():
                parts = ({"q": t.q, "scale": t.scale}
                         if isinstance(t, adamw.QTensor) else {"": t})
                for part, x in parts.items():
                    rec["state"][f"{mom}|{n}|{part}"] = nbytes(x)
        rec["batch"] = dict(flat(args[2]))
    elif c.kind == "prefill":
        rec["batch"] = dict(flat(args[1]))
    else:
        rec["cache"] = dict(flat(args[1]))
        rec["toks"] = nbytes(args[2])
    out[f"{arch}|{shape}"] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def production_args():
    return run_py(_ARGS, timeout=1200)


class _Mesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _entries(spec, ndim):
    out = list(tuple(spec)) + [None] * (ndim - len(tuple(spec)))
    return [() if e is None else e if isinstance(e, tuple) else (e,)
            for e in out]


def _shard_bytes(leaf, spec) -> int:
    n = np.dtype(leaf.dtype).itemsize
    for d, axes in zip(leaf.shape, _entries(spec, leaf.ndim)):
        n *= d // int(np.prod([SIZES[a] for a in axes]))
    return n


def _flat_ref(tree):
    return {tuple(p.key for p in path if isinstance(p, jax.tree_util.DictKey)
                  ): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", list(rregistry.ALIASES))
def test_argument_bytes_match_reference_shards(production_args, arch):
    """Per device at (16, 16): every reference leaf's shard bytes equal
    the local bytes of the port's leaves stacked into it, except the
    leaves whose reference spec splits a stack dim (the ZeRO-1 moments
    of ROADMAP.md Queue 3, a shared expert's stacked leaf) and the int8
    moments of scalar gates, which the reference quantizes over their
    stack dim; and the arguments are exactly these leaves (the
    reference's int32 ``step`` and cache ``len`` are Python ints here)."""
    rmesh = _Mesh(SIZES)
    rcfg = rregistry.config(arch)
    rmodel = rlm.build(rcfg)
    rp = rspecs.params_specs(rmodel)
    model = specs.build(registry.config(arch))
    leaves = model.reference_leaves()
    stacks = model.stack_dims()
    checked = skipped = 0
    for shape in rregistry.shapes_for(arch):
        plan = dryrun.PLANS[arch]
        got = production_args[f"{arch}|{shape}"]
        c = rspecs.cell(arch, shape)
        port_leaves = sum(got["params"].values()) + sum(
            got.get("state", {}).values()) + sum(
            got.get("batch", {}).values()) + sum(
            got.get("cache", {}).values()) + got.get("toks", 0)
        assert got["total"] == port_leaves, (arch, shape)

        def check(rleaf, spec, names, lead):
            nonlocal checked, skipped
            ent = _entries(spec, rleaf.ndim)
            if any(ent[:len(lead)]):
                skipped += 1
                return
            assert sum(names) == _shard_bytes(rleaf, spec), (arch, shape)
            checked += 1

        for ref_name, names in leaves.items():
            keys = tuple(ref_name.split("."))
            leaf = rp
            for k in keys:
                leaf = leaf[k]
            path = tuple(jax.tree_util.DictKey(k) for k in keys)
            check(leaf, rrules.param_spec(path, leaf, rmesh,
                                          fsdp=plan.fsdp),
                  [got["params"][n] for n in names], stacks[names[0]])
        if c.kind == "train":
            ocfg = radamw.AdamWConfig(quantized_state=plan.quantized)
            rstate = rspecs.opt_state_specs(ocfg, rp)
            flat = jax.tree_util.tree_flatten_with_path(rstate)[0]
            for path, rleaf in flat:
                attrs = [p.name for p in path
                         if isinstance(p, jax.tree_util.GetAttrKey)]
                keys = tuple(p.key for p in path
                             if isinstance(p, jax.tree_util.DictKey))
                if not keys:                   # the int32 step
                    continue
                part = (keys[-1] if plan.quantized and keys[-1]
                        in ("q", "scale") else "")
                ref_name = ".".join(keys[:-1] if part else keys)
                names = leaves[ref_name]
                lead = stacks[names[0]]
                spec = rloop._state_spec_for(path, rleaf, rmesh, ocfg,
                                             plan.fsdp)
                mine = [got["state"][f"{attrs[0]}|{n}|{part}"]
                        for n in names]
                if part and rleaf.ndim != len(lead) + len(
                        model.get_parameter(names[0]).shape) + (
                        model.get_parameter(names[0]).dim() == 0):
                    skipped += 1               # a scalar gate's moment
                    continue
                check(rleaf, spec, mine, lead)
        if c.kind in ("train", "prefill"):
            for k, v in rspecs.model_inputs(rcfg, c).items():
                assert got["batch"][k] == _shard_bytes(
                    v, rrules.batch_spec(rmesh, v.shape)), (k, shape)
                checked += 1
        if c.kind == "decode":
            rcache = rspecs.cache_specs(rmodel, c.global_batch, c.seq_len)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    rcache)[0]:
                keys = tuple(p.key for p in path)
                if keys[-1] == "len":
                    continue
                assert got["cache"]["/".join(keys)] == _shard_bytes(
                    leaf, rrules.cache_spec(path, leaf, rmesh)), keys
                checked += 1
            toks = rspecs.decode_token_specs(c)
            assert got["toks"] == _shard_bytes(
                toks, rrules.batch_spec(rmesh, toks.shape))
    assert checked > 0
    assert skipped <= checked / 10, (arch, skipped, checked)


# --- SMOKE cells on a fake (4, 2) mesh -------------------------------------
_SMOKE = """
import json, os, tempfile
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import registry
from repro_torch.launch import dryrun, fleet, op_analysis, specs
dryrun.fake_world(8)
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
out, d = {}, tempfile.mkdtemp()
for arch in ("llama3-8b", "mixtral-8x7b"):
    cfg = registry.smoke_config(arch)
    for kind, b in (("train", 8), ("prefill", 4), ("decode", 4)):
        cell = specs.Cell(arch, kind, 32, b, kind)
        fn, args, cfg2, c = dryrun.build_cell(
            arch, kind, mesh, dryrun.PLANS[arch], cfg=cfg, cell=cell)
        a, res, secs = dryrun.count_cell(fn, args)
        rec = dryrun.record({"arch": arch, "shape": kind, "mesh": "single",
                             "chips": 8, "ok": True}, a, res, cfg2, c, 8)
        rec["tensor_bytes"] = sum(t.numel() * t.element_size()
                                  for t in op_analysis.local_tensors(args))
        with open(os.path.join(d, f"{arch}__{kind}__single.json"), "w") as f:
            json.dump(rec, f)
        out[f"{arch}|{kind}"] = rec
out["jobs"] = [[j.arch, j.shape, j.chips_wanted] for j in
               fleet.load_jobs(d)]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def smoke_mesh():
    return run_py(_SMOKE)


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x7b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_cells_on_fake_mesh(smoke_mesh, arch, kind):
    rec = smoke_mesh[f"{arch}|{kind}"]
    mem, cost = rec["memory"], rec["cost"]
    assert mem["argument_bytes"] == rec["tensor_bytes"] > 0
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                 + mem["temp_bytes"] - mem["alias_bytes"])
    assert 0 < cost["matmul_flops_per_dev"] <= cost["flops_per_dev"]
    assert cost["bytes_per_dev"] > 0
    # tensor parallelism over model=2 reduces partial sums
    assert rec["collectives"]["all-reduce"]["count"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    r = rec["roofline"]
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert r[r["dominant"]] == max(r["compute_s"], r["memory_s"],
                                   r["collective_s"])
    assert [arch, kind, 8] in smoke_mesh["jobs"]
    if kind == "decode":          # the cache is updated in place
        assert mem["alias_bytes"] > 0


# --- a world of one against the reference's hlo_analysis --------------------
B, S, N_MICRO = 4, 64, 2


def _reference_counts(arch, kind):
    """(dot flops, flops of the unnamed dots, Analyzer.flops) of the
    reference's SMOKE program compiled for one CPU device. The dot flops
    leave out the elementwise work the reference adds for each fusion
    (hlo_analysis.py:343-353)."""
    rmodel = rlm.build(rregistry.smoke_config(arch))
    rp = rspecs.params_specs(rmodel)
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if kind == "prefill":
        fn, args = (lambda p, b: rmodel.prefill(p, b, max_len=S)), (rp,
                                                                    batch)
    else:
        ocfg = radamw.AdamWConfig()
        fn = rloop.make_train_fn(rmodel, ocfg, N_MICRO)
        args = (rp, rspecs.opt_state_specs(ocfg, rp), batch)
    txt = jax.jit(fn).lower(*args).compile().as_text()
    full = H.Analyzer(txt).analyze().flops
    dots = H.Analyzer(txt)
    dots._ew_count = lambda name: 0
    total = dots.analyze().flops
    return total, dots.contrib.get("dot", [0.0])[0], full


def _port_counts(arch, kind):
    cell = specs.Cell(arch, kind, S, B, kind)
    fn, args, cfg, c = dryrun.build_cell(
        arch, kind, None, dryrun.Plan(n_micro=N_MICRO),
        cfg=registry.smoke_config(arch), cell=cell)
    return dryrun.count_cell(fn, args)[0]


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_world_one_matmul_flops_equal_reference_dots(kind):
    """llama3-8b: the port's matmul flops are the reference's dot flops
    exactly, and its flops with the elementwise work within 5% of the
    reference's Analyzer.flops (whose fusions add their elementwise
    work to ``flops``)."""
    dots, unnamed, full = _reference_counts("llama3-8b", kind)
    a = _port_counts("llama3-8b", kind)
    assert unnamed == 0
    assert a.cost.flops == dots
    assert abs(a.cost.flops + a.cost.eflops - full) <= 0.05 * full


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_world_one_moe_dispatch_family_differs(kind):
    """mixtral-8x7b: the reference dispatches and combines tokens with
    one-hot contractions, which XLA emits as dots (its unnamed ``dot``s:
    50% of a SMOKE prefill's dot flops); the port's index-gather
    dispatch does no product there. Its matmul flops are the reference's
    dot flops less exactly that family (ROADMAP.md Queue 3)."""
    dots, unnamed, full = _reference_counts("mixtral-8x7b", kind)
    a = _port_counts("mixtral-8x7b", kind)
    assert unnamed > 0.2 * dots
    assert a.cost.flops == dots - unnamed


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_counts_equal_cpu_counts(kind):
    """The dry run's meta program is the program that runs: the same
    SMOKE step (float32, where the CPU takes the card's products) counted
    on meta and run on the CPU gives the same counts and argument bytes.
    Exactly, but for AdamW's schedule: its 0-d float32 scalars live on
    the host, where a CPU run counts them (and a meta or card run counts
    their copies to the device instead)."""
    import torch
    cell = specs.Cell("llama3-8b", kind, 32, 4, kind)
    counts = []
    for dev in ("meta", "cpu"):
        fn, args, cfg, c = dryrun.build_cell(
            "llama3-8b", kind, None, dryrun.Plan(n_micro=2),
            cfg=registry.smoke_config("llama3-8b"), cell=cell,
            device=torch.device(dev))
        a, out, _ = dryrun.count_cell(fn, args, device=torch.device(dev))
        counts.append((a.cost.flops, a.cost.eflops, a.cost.bytes,
                       a.memory(out)["argument_bytes"], a.n_ops))
    (fl, efl, by, arg, n), (fl2, efl2, by2, arg2, n2) = counts
    assert (fl, arg) == (fl2, arg2)
    if kind != "train":
        assert (efl, by, n) == (efl2, by2, n2)
        return
    n_leaves = len(args[0])
    assert 0 < efl2 - efl <= 64 and abs(by2 - by) <= 8 * n_leaves
