"""Training on four cards (chip_smoke.py ``--mesh-only``, the ``[mesh]``
phase): its rank functions at the SMOKE size on 4 gloo CPU ranks, held
against the reference's ``make_train_step`` and
``make_compressed_dp_step`` on 4 forced XLA CPU devices; the mode's exit
without four cards; the zamba2 mesh ops that torch 2.11's sharding rules
refuse, run in ``local_map`` regions, against the ops on DTensors; and,
marked ``gpu``, (a) and (b) on four cards.

The ranks run ``chip_smoke._mesh_rank`` with a CPU spec (``mesh_spec(
device="cpu", smoke=True)``): (a) ``launch.train`` on (2, 2), (b) on
(1, 4), both 2 sequences a step and 3 steps with int8 moments; (c) the
compressed data-parallel step on (4, 1), 2 steps; (d) (2, 2) at 4
sequences saved after step 2 and restored at (1, 4) and (4, 1). The
reference runs the same seeded weights (the port's, carried over as
numpy) and the same batches in a subprocess with 4 forced CPU devices.
Tolerances are ``tests/test_torch_dist_train.py``'s: losses and gradient
norms 1e-5 relative at every step; the parameters after the first step
at most 2 lr off, and 5e-5 on all but 0.1% a step (``_params_rule``).

Spawned ranks import nothing of JAX: the reference is imported only in
the subprocess, and chip_smoke.py imports none of it.
"""
import concurrent.futures
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.convert import lm_params_to_numpy
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import ranks
from repro_torch.models.lm import LM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 64
NICE = 10        # the ranks leave the other test workers their cores
TP_LR = 3e-4     # launch.train's --lr in chip_smoke's TRAIN_ARGV
ZAMBA_GRAD_REL = 1e-4


def _chip_smoke():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree, np.float32)]


def _params_rule(got, want, lr, steps):
    """test_torch_dist_train's rule for Adam's ill-conditioned elements:
    after one step at most 2 lr off, and 5e-5 on all but 0.1% a step.
    After more steps of int8 moments the 2 lr bound does not hold on
    either side: where a block's v codes round to 0 an element moves by
    m / eps (an embedding element goes from -0.02 to 17.0 in 3 steps in
    both packages), so a reduction order that moves m moves the element
    by more than lr; only the share is held then."""
    err = np.concatenate([np.abs(a - b).ravel() for a, b in zip(
        _leaves(got), _leaves(want), strict=True)])
    assert np.mean(err > 5e-5) <= 1e-3 * steps, np.mean(err > 5e-5)
    if steps == 1:
        assert err.max() <= 2 * lr, err.max()


# --- the reference on 4 forced CPU devices -----------------------------------
_REF = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro import compat
    from repro.configs import registry
    from repro.models import lm
    from repro.optim import adamw
    from repro.train import loop
    d = dict(np.load(sys.argv[1]))

    def unflatten(prefix):
        tree = {}
        for k, v in d.items():
            if not k.startswith(prefix):
                continue
            node, *path = k[len(prefix):].split("/")
            path = [node] + path
            t = tree
            for p in path[:-1]:
                t = t.setdefault(p, {})
            t[path[-1]] = jnp.asarray(v)
        return tree

    cfg = registry.smoke_config("llama3-8b", attn_impl="flash")
    model = lm.build(cfg)
    params = unflatten("w/")
    out = {}

    def flat(tag, tree):
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[tag + "/" + "/".join(p.key for p in path)] = np.asarray(
                x, np.float32)

    def tp(tag, layout, steps, lr, warmup, total):
        oc = adamw.AdamWConfig(lr=lr, warmup_steps=warmup, total_steps=total,
                               quantized_state=True)
        mesh = jax.make_mesh(layout, ("data", "model"),
                             **compat.axis_types_kwarg(2))
        with jax.set_mesh(mesh):
            step, _ = loop.make_train_step(model, oc, mesh, donate=False)
            p, s = params, adamw.init(oc, params)
            for i in range(steps):
                p, s, m = step(p, s, {"tokens": jnp.asarray(d[f"{tag}{i}"])})
                out[f"{tag}/loss{i}"] = np.asarray(m["loss"])
                out[f"{tag}/grad_norm{i}"] = np.asarray(m["grad_norm"])
                if i == 0:
                    flat(tag + "/p1", p)
        flat(tag + "/p", p)

    tp("a", (2, 2), 3, %(lr)r, 3, 3)
    tp("b", (1, 4), 3, %(lr)r, 3, 3)
    tp("d", (2, 2), 3, %(lr)r, 3, 3)
    # (c): [dist]'s optimizer (lr 3e-4, warmup and total DIST_STEPS = 2)
    oc = adamw.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=2,
                           quantized_state=True)
    step = loop.make_compressed_dp_step(model, oc,
                                        jax.make_mesh((4,), ("data",)))
    p, s = params, adamw.init(oc, params)
    from repro.optim import compress
    e = compress.init_error(params)
    for i in range(2):
        p, s, e, m = step(p, s, e, {"tokens": jnp.asarray(d[f"c{i}"])})
        out[f"c/loss{i}"] = np.asarray(m["loss"])
        if i == 0:
            flat("c/p1", p)
    flat("c/p", p)
    np.savez(sys.argv[2], **out)
""") % {"lr": TP_LR}


def _ref(tmp_path, tree, vocab):
    """The reference's runs of (a)-(d) on the port's seeded weights."""
    src = tmp_path / "in.npz"
    batches = {}
    for tag, rows, steps in (("a", 2, 3), ("b", 2, 3), ("d", 4, 3),
                             ("c", 4, 2)):
        ds = SyntheticLM(vocab, SEQ, rows)
        batches.update({f"{tag}{i}": ds.batch_at(i) for i in range(steps)})
    np.savez(src, **batches, **{f"w/{k}": v for k, v in
                                _flatten(tree).items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    dst = tmp_path / "out.npz"
    res = subprocess.run([sys.executable, "-c", _REF, str(src), str(dst)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = dict(np.load(dst))

    def tree_of(prefix):
        t = {}
        for k, v in out.items():
            if k.startswith(prefix):
                *path, leaf = k[len(prefix):].split("/")
                node = t
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = v
        return t
    return out, {f"{tag}{n}": tree_of(f"{tag}/p{n}/") for tag in "abcd"
                 for n in ("", "1")}


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """chip_smoke's [mesh] ranks at the SMOKE size on 4 gloo CPU ranks,
    beside the reference on 4 forced CPU devices."""
    cs = _chip_smoke()
    d = tmp_path_factory.mktemp("mesh")
    spec = cs.mesh_spec(device="cpu", smoke=True, ckpt=str(d / "ckpt"),
                        seq=SEQ, phases=("a", "b", "c", "d"),
                        params_out=True)
    cfg = registry.smoke_config("llama3-8b", attn_impl="flash")
    tree = lm_params_to_numpy(LM(cfg, device="cpu", seed=0))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(ranks.run_ranks, cs._mesh_rank, 4, str(d / "rdzv"),
                          (spec,), timeout=400, nice=NICE)
        want, want_p = _ref(d, tree, cfg.vocab)
        got = fut.result()
    return cs, got, want, want_p


@pytest.mark.parametrize("key,layout", [("a", (2, 2)), ("b", (1, 4))])
def test_tensor_parallel_ranks_match_reference_make_train_step(mesh, key,
                                                               layout):
    """(a) on (2, 2) and (b) on (1, 4) through launch.train: every rank's
    losses and gradient norms equal the reference's make_train_step on
    the same mesh shape, 1e-5 relative; the parameters after the first
    step and after 3 by the Adam rule."""
    _, got, want, want_p = mesh
    for r, out in enumerate(got):
        run = out[key]
        assert out["backend"] == "gloo" and tuple(run["mesh"]) == layout
        for i, h in enumerate(run["hist"]):
            np.testing.assert_allclose(h["loss"], want[f"{key}/loss{i}"],
                                       rtol=1e-5)
            np.testing.assert_allclose(h["grad_norm"],
                                       want[f"{key}/grad_norm{i}"],
                                       rtol=1e-5)
    _params_rule(got[0][key]["tree1"], want_p[key + "1"], TP_LR, 1)
    _params_rule(got[0][key]["tree"], want_p[key], TP_LR, 3)


def test_compressed_dp_ranks_match_reference(mesh):
    """(c) on (4, 1): every rank's losses equal the reference's
    make_compressed_dp_step on 4 devices (1e-5 relative), the parameters
    after 1 and 2 steps by the Adam rule, the int32 sums exact and g_hat within
    one ulp of the plain formula on every rank."""
    _, got, want, want_p = mesh
    for out in got:
        dp = out["c"]
        for i, h in enumerate(dp["hist"]):
            np.testing.assert_allclose(h["loss"], want[f"c/loss{i}"],
                                       rtol=1e-5)
        assert dp["checks"] and all(exact and ulps <= 1.0
                                    for exact, ulps in dp["checks"].values())
    _params_rule(got[0]["c"]["params1"], want_p["c1"], 3e-4, 1)
    _params_rule(got[0]["c"]["params"], want_p["c"], 3e-4, 2)


def test_error_feedback_kept_and_its_control_fails(mesh):
    """Error feedback's running sum is held to its limit on every rank
    and leaf; the control that drops the residual each step lies beyond
    it, and dp_report (the chip's check) rejects it."""
    cs, got, _, _ = mesh
    res = [out["c"] for out in got]
    for dp in res:
        for kept, dropped, tol in dp["ef"].values():
            assert kept <= tol < dropped
    dropped = [dict(dp, ef={k: (b, b, t) for k, (a, b, t) in dp["ef"].items()})
               for dp in res]
    whole = [{"loss": h["loss"]} for h in res[0]["hist"]]
    cs.dp_report("mesh", res, whole, "4x1")
    with pytest.raises(cs.SmokeFailure, match="error feedback"):
        cs.dp_report("mesh", dropped, whole, "4x1")


def test_elastic_restore_across_meshes_matches_reference(mesh):
    """(d): saved at (2, 2) after step 2 and restored at (1, 4) and
    (4, 1): every leaf bit for bit, laid out by the new mesh; the
    restored step 3 equals the reference's (2, 2) step 3 (1e-5
    relative), as the (2, 2) run's own does."""
    _, got, want, want_p = mesh
    for out in got:
        el = out["d"]
        for i, h in enumerate(el["first"] + [el["straight"]]):
            np.testing.assert_allclose(h["loss"], want[f"d/loss{i}"],
                                       rtol=1e-5)
        assert set(el["restored"]) == {(1, 4), (4, 1)}
        for layout, h in el["restored"].items():
            assert h["bad"] == [] and h["leaves"] > 0 and h["placed"]
            assert tuple(h["mesh"]) == layout
            np.testing.assert_allclose(h["loss"], want["d/loss2"], rtol=1e-5)
            np.testing.assert_allclose(h["grad_norm"], want["d/grad_norm2"],
                                       rtol=1e-5)


def test_mesh_only_exits_nonzero_without_four_cards():
    """--mesh-only prints no result and exits non-zero here (no card),
    as it does on a machine with fewer than four."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                          "--mesh-only"], capture_output=True, text=True,
                         env=env, timeout=120, cwd=ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_mesh_only_refuses_fewer_than_four_cards(monkeypatch, capsys):
    """On a machine with a card but fewer than four, the mode exits
    non-zero before it builds anything."""
    cs = _chip_smoke()
    built = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cs, "device_phase", lambda: ("H100, 700 W",
                                                     "NVIDIA H100", 1))
    monkeypatch.setattr(cs, "build_phase", lambda: built.append(1))
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", cs.MESH_FLAG])
    assert cs.main() == 1
    assert not built
    assert "needs 4 cards, 1 visible" in capsys.readouterr().err


# --- zamba2's mesh ops, repaired for torch 2.11 ------------------------------
_ZAMBA = """
import json
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch.configs import registry
from repro_torch.launch import dryrun, specs
from repro_torch.models import mamba2

dryrun.fake_world(8)
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
cfg = registry.smoke_config("zamba2-7b")
seen = {}


def record(op, old, new):
    old = old if isinstance(old, tuple) else (old,)
    new = new if isinstance(new, tuple) else (new,)
    for o, n in zip(old, new, strict=True):
        r = seen.setdefault(op, {"calls": 0, "placements": [], "equal": True,
                                 "in": None})
        r["calls"] += 1
        r["placements"].append([str(o.placements), str(n.placements)])
        r["equal"] &= (o.placements == n.placements
                       and o.shape == n.shape
                       and torch.equal(o.to_local(), n.to_local()))


def old_conv(conv_in, w):
    k, S = w.shape[0], conv_in.shape[1]
    padded = torch.nn.functional.pad(conv_in, (0, 0, k - 1, 0))
    conv = padded[:, 0:S] * w[0]
    for i in range(1, k):
        conv = conv + padded[:, i:i + S] * w[i]
    return conv


wrapped = {"_causal_conv_mesh": lambda a: old_conv(*a),
           "_ssd_mesh": lambda a: mamba2._ssd_chunked(*a),
           "_readout_mesh": lambda a: mamba2._readout(*a)}
orig = {name: getattr(mamba2, name) for name in wrapped}


def hook(name):
    def fn(*args):
        out = orig[name](*args)
        det = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                    for a in args)
        with torch.no_grad():
            new = orig[name](*det)
            record(name, wrapped[name](det), new)
        seen[name]["in"] = [str(a.placements) for a in args
                            if isinstance(a, DTensor)]
        return out
    return fn


orig_pad = mamba2._pad_seq


def pad(t, before, after):
    out = orig_pad(t, before, after)
    if isinstance(t, DTensor):
        with torch.no_grad():
            record("_pad_seq", torch.nn.functional.pad(
                t.detach(), (0, 0) * (t.dim() - 2) + (before, after)),
                orig_pad(t.detach(), before, after))
    return out


for name in wrapped:
    setattr(mamba2, name, hook(name))
mamba2._pad_seq = pad
for kind, b, s in (("train", 8, 512), ("prefill", 4, 512), ("decode", 4, 32)):
    cell = specs.Cell("zamba2-7b", kind, s, b, kind)
    fn, args, _, _ = dryrun.build_cell("zamba2-7b", kind, mesh,
                                       dryrun.PLANS["zamba2-7b"], cfg=cfg,
                                       cell=cell, device="cpu")
    dryrun.count_cell(fn, args, device="cpu")
print(json.dumps(seen))
"""


@pytest.fixture(scope="module")
def zamba_ops():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _ZAMBA], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("op", ["_causal_conv_mesh", "_pad_seq", "_ssd_mesh",
                                "_readout_mesh"])
def test_zamba2_mesh_op_equals_the_ops_on_dtensors(zamba_ops, op):
    """zamba2-7b's SMOKE train, prefill and decode cells on a fake (4, 2)
    mesh: at every call of the repaired op, its output's placements,
    shape and each rank's local values equal those of the plain function
    run on the DTensors (the old path, which torch 2.13's sharding rules
    take and 2.11's refuse)."""
    r = zamba_ops[op]
    assert r["calls"] > 0 and r["equal"], r
    if op == "_ssd_mesh":
        # dt's heads split over model: y and the final state so
        assert ["(Shard(dim=0), Shard(dim=2))"] * 2 in r["placements"]
        assert ["(Shard(dim=0), Shard(dim=1))"] * 2 in r["placements"]
    if op == "_readout_mesh":
        # the state's heads split, the output gathered over them
        assert r["in"][1] == "(Shard(dim=0), Shard(dim=1))"


def _rank_zamba(rank, world, init_file, tree):
    """zamba2-7b's SMOKE step through make_train_step on (2, 2) gloo
    ranks: the repaired ops' gradients through their local_map regions."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import loop as tl
    ranks.init(rank, world, init_file)
    mesh = make_host_mesh(2, device="cpu")
    cfg = registry.smoke_config("zamba2-7b")
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    model.requires_grad_(True)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    _, shardings = tl.make_train_step(model, ocfg, mesh)
    params = tl.params_of(model)
    state = shardings(params).distribute({"opt_state": adamw.init(ocfg,
                                                                  params)})
    toks = SyntheticLM(cfg.vocab, 300, 4).batch_at(0)
    loss, _, grads = tl.microbatch_grads(
        model, state["params"], pipeline.make_global_batch(
            mesh, {"tokens": toks}), 1)
    return float(loss), lm_params_to_numpy(model, grads)


def test_zamba2_step_on_a_mesh_matches_one_process(tmp_path):
    """The repaired ops' backward: zamba2-7b's SMOKE gradients on (2, 2)
    gloo ranks (a 299-token sequence: the SSD's pad to its chunk) equal
    one process's, the loss 1e-5 relative, each leaf within ZAMBA_GRAD_REL
    of its largest |g|. The per-head a_log and dt_bias gradients are
    float32 sums over every token of terms of both signs: one process's
    own moves by 1.3-2.7e-5 of its largest when the batch is summed in two
    microbatches, and the mesh's partial sums differ by up to 6.3e-5, as
    the DTensor path before the repair did on torch 2.13 (6.4e-5). A
    gradient left unreduced over a mesh dim is off by a factor."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.train import loop as tl
    cfg = registry.smoke_config("zamba2-7b")
    tree = lm_params_to_numpy(LM(cfg, device="cpu", seed=0))
    got = ranks.run_ranks(_rank_zamba, 4, str(tmp_path / "rdzv"), (tree,),
                          timeout=300, nice=NICE)
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    model.requires_grad_(True)
    toks = torch.as_tensor(SyntheticLM(cfg.vocab, 300, 4).batch_at(0))
    loss, _, grads = tl.microbatch_grads(model, tl.params_of(model),
                                         {"tokens": toks}, 1)
    want = lm_params_to_numpy(model, grads)
    for r_loss, r_grads in got:
        np.testing.assert_allclose(r_loss, float(loss), rtol=1e-5)
        for a, b in zip(_leaves(r_grads), _leaves(want), strict=True):
            np.testing.assert_allclose(a, b, rtol=0, atol=ZAMBA_GRAD_REL
                                       * max(float(np.abs(b).max()), 1e-30))


# --- on four cards -----------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("key,layout", [("a", (2, 2)), ("b", (1, 4))])
def test_cuda_tensor_parallel_on_four_cards(tmp_path, key, layout):
    """(a) on (2, 2) and (b) on (1, 4): llama3-8b at full width, 2
    layers, one NCCL rank a card, K5, K6 and K7 on each rank's local heads
    (the per-card kernel checks first); the losses within 1e-2 of one
    process on card 0 running the same 2 sequences. Needs four cards
    on one host."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices (run with -m gpu on four cards)")
    cs = _chip_smoke()
    spec = cs.mesh_spec(ckpt=str(tmp_path / "ckpt"), layers=2,
                        phases=(key,), profile=False)
    whole = cs.full_depth_run("one_process", {}, arch=cs.MESH_ARCH,
                              argv=cs.mesh_argv(spec, cs.MESH_ARCH, 2,
                                                spec["seq"], cs.MESH_BATCH),
                              line="mesh")
    cs._free()
    got = ranks.run_ranks(cs._mesh_rank, 4, str(tmp_path / "rdzv"), (spec,),
                          timeout=600)
    for r, out in enumerate(got):
        assert (out["backend"], out["device"]) == ("nccl", f"cuda:{r}")
        assert all(ok5 and okb and same for ok5, _, okb, _, same
                   in out["kernels"].values())
        run = out[key]
        assert tuple(run["mesh"]) == layout
        assert all(n > 0 for n in run["launches"].values())
        for h, w in zip(run["hist"], whole["hist"], strict=True):
            assert abs(h["loss"] - w["loss"]) <= 1e-2 * abs(w["loss"])
        assert run["peak"] < cs.MESH_PEAK
