"""Training on a device mesh: the port's sharded and compressed steps,
the global batch, the elastic restore and the launcher's mesh path, on
gloo ranks spawned on the CPU, against the reference.

The reference's parameters (``init(PRNGKey(0))``) are carried to the
ranks as numpy trees (``convert``); the sharded ``make_train_step`` on 4
ranks is held to the reference's single-device ``make_train_fn`` on the
same batches with ``tests/test_torch_train.py``'s tolerances: loss and
grad norm 1e-5 relative at every step; the first step's gradients, each
leaf within 2e-5 of its largest |g|; the parameters after the steps by
the rule for Adam's ill-conditioned elements (at most 2 lr, and 5e-5 on
all but 0.1%): the mesh's reductions sum in another order, and where a
gradient is near 0 Adam turns that into a larger step difference (one
element of 115k past 5e-5 after 2 steps). The steps are float32 (the
SMOKE configs' dtype): two with the warmup schedule, one with int8
moments and one of mixtral. The compressed data-parallel step on 2 ranks is held to the
reference's ``make_compressed_dp_step`` on 2 forced CPU devices (a
subprocess), and on one rank to its one-device result.

Spawned ranks import nothing of JAX: this module imports the reference
only inside the functions the parent runs, and the rank functions get
numpy arrays. Each group of ranks joins within a timeout
(``launch.ranks.run_ranks``) and rendezvouses through a file under
``tmp_path``.
"""
import concurrent.futures
import contextlib
import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.data import pipeline
from repro_torch.kernels import flash_cuda
from repro_torch.launch import ranks
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.optim import adamw, compress
from repro_torch.train import checkpoint, fault
from repro_torch.train import loop as tl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 4, 32
GRAD_REL = 2e-5
LR = dict(lr=3e-3, warmup_steps=2, total_steps=3)
ONE_STEP = dict(lr=3e-3, warmup_steps=0)
NICE = 10        # the ranks leave the other test workers their cores


def _beside(background, foreground):
    """``(background(), foreground())``, the first on a thread while the
    second runs here (the ranks' processes beside the reference's
    work in this one)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(background)
        fg = foreground()
        return fut.result(), fg


def _tokens(step, b=B, s=S, vocab=256):
    return pipeline.SyntheticLM(vocab, s, b).batch_at(step)


# --- the reference, in the parent process --------------------------------------
def _ref_params(arch):
    import jax
    from repro.configs import registry as rregistry
    from repro.models import lm as rlm
    cfg = rregistry.smoke_config(arch, attn_impl="flash")
    return jax.tree.map(np.asarray, rlm.build(cfg).init(
        jax.random.PRNGKey(0)))


def _ref_steps(arch, n_steps, n_micro=1, **kw):
    """The reference's single-device make_train_fn: per-step metrics, the
    parameters after the last step and the first step's gradients
    (numpy)."""
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.configs import registry as rregistry
    from repro.models import lm as rlm
    from repro.optim import adamw as radamw
    from repro.train import loop as rloop
    cfg = rregistry.smoke_config(arch, attn_impl="flash")
    model = rlm.build(cfg)
    oc = radamw.AdamWConfig(**kw)
    step = jax.jit(rloop.make_train_fn(model, oc, n_micro))
    p = _ref_params(arch)
    s = radamw.init(oc, p)
    ms = []
    with jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"),
                                    **compat.axis_types_kwarg(2))):
        _, _, g0 = jax.jit(lambda p, b: rloop.microbatch_grads(
            model, p, b, n_micro))(p, {"tokens": jnp.asarray(_tokens(0))})
        for i in range(n_steps):
            p, s, m = step(p, s, {"tokens": jnp.asarray(_tokens(i))})
            ms.append({k: float(v) for k, v in m.items()})
    return ms, jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, g0)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree, np.float32)]


def _params_first_step_rule(got, want, lr):
    err = np.concatenate([np.abs(a - b).ravel() for a, b in zip(
        _leaves(got), _leaves(want), strict=True)])
    assert err.max() <= 2 * lr and np.mean(err > 5e-5) <= 1e-3, \
        (err.max(), np.mean(err > 5e-5))


# --- the sharded step on 4 ranks -----------------------------------------------
# name: (arch, (data, model), steps, n_micro, fsdp, quantized, wrong_kv)
CASES = {
    "kv_heads_sharded_2x2": ("llama3-8b", (2, 2), 2, 1, False, False, False),
    "replicated_kv_1x4": ("llama3-8b", (1, 4), 2, 1, False, False, False),
    "data_parallel_4x1": ("llama3-8b", (4, 1), 2, 1, False, False, False),
    "n_micro_2": ("llama3-8b", (2, 2), 2, 2, False, False, False),
    "fsdp": ("llama3-8b", (2, 2), 2, 1, True, False, False),
    "int8_moments": ("llama3-8b", (2, 2), 1, 1, False, True, False),
    "mixtral_2x2": ("mixtral-8x7b", (2, 2), 1, 1, False, False, False),
    "control_kv_slice_one_head_off": ("llama3-8b", (1, 4), 2, 1, False,
                                      False, True),
}


def _count_plain_flash():
    """Count the kernels' plain-version calls on this rank (the CPU
    path of K5 and of K6/K7 together)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = flash_cuda.flash_fwd, flash_cuda.flash_bwd

    def cf(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def cb(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)
    flash_cuda.flash_fwd, flash_cuda.flash_bwd = cf, cb
    return calls


@contextlib.contextmanager
def _kv_slice_one_head_off():
    """A planted fault: the model axis rank the kv slice is taken from
    moves by half the axis, so each rank's slice starts one kv head off."""
    from torch.distributed.device_mesh import DeviceMesh
    orig = DeviceMesh.get_local_rank

    def shifted(self, mesh_dim=None):
        r = orig(self, mesh_dim)
        if mesh_dim == "model":
            n = self.size(self.mesh_dim_names.index("model"))
            r = (r + n // 2) % n
        return r
    DeviceMesh.get_local_rank = shifted
    try:
        yield
    finally:
        DeviceMesh.get_local_rank = orig


def _rank_sharded(rank, world, init_file, trees, cases):
    ranks.init(rank, world, init_file)
    calls = _count_plain_flash()
    out = {}
    for name, (arch, shape, n_steps, n_micro, fsdp, quant, wrong) in \
            cases.items():
        cfg = registry.smoke_config(arch, attn_impl="flash")
        mesh = make_host_mesh(shape[1], device="cpu")
        assert tuple(mesh.shape) == shape
        kw = dict(ONE_STEP if n_steps == 1 else LR, quantized_state=quant)
        ocfg = adamw.AdamWConfig(**kw)
        model = lm_params_from_numpy(cfg, trees[arch], device="cpu")
        model.requires_grad_(True)
        step, shardings = tl.make_train_step(model, ocfg, mesh,
                                             n_micro=n_micro, fsdp=fsdp)
        params = tl.params_of(model)
        sh = shardings(params)
        state = sh.distribute({"opt_state": adamw.init(ocfg, params)})
        with _kv_slice_one_head_off() if wrong else contextlib.nullcontext():
            _, _, g0 = tl.microbatch_grads(
                model, state["params"], pipeline.make_global_batch(
                    mesh, {"tokens": _tokens(0)}), n_micro)
        grads = lm_params_to_numpy(model, g0)
        calls.update(fwd=0, bwd=0)
        ms = []
        with _kv_slice_one_head_off() if wrong else contextlib.nullcontext():
            for i in range(n_steps):
                batch = pipeline.make_global_batch(mesh,
                                                   {"tokens": _tokens(i)})
                p, o, m = step(state["params"], state["opt_state"], batch)
                state = {"params": p, "opt_state": o}
                ms.append({k: float(v) for k, v in m.items()})
        placed = {n: tuple(p.placements) for n, p in state["params"].items()}
        tree = lm_params_to_numpy(model)
        out[name] = {"metrics": ms, "calls": dict(calls),
                     "params": tree if rank == 0 else None,
                     "grads": grads if rank == 0 else None,
                     "placements": placed if rank == 0 else None,
                     "spec": {n: s.spec for n, s in sh.params.items()}
                     if rank == 0 else None}
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    trees = {a: _ref_params(a) for a in ("llama3-8b", "mixtral-8x7b")}
    return _beside(
        lambda: ranks.run_ranks(_rank_sharded, 4,
                                str(tmp_path_factory.mktemp("rdzv") / "f"),
                                (trees, CASES), timeout=300, nice=NICE),
        lambda: {"2": _ref_steps("llama3-8b", 2, **LR),
                 "micro": _ref_steps("llama3-8b", 2, n_micro=2, **LR),
                 "int8": _ref_steps("llama3-8b", 1, quantized_state=True,
                                    **ONE_STEP),
                 "mixtral": _ref_steps("mixtral-8x7b", 1, **ONE_STEP)})


def _ref_for(name):
    return {"n_micro_2": "micro", "int8_moments": "int8",
            "mixtral_2x2": "mixtral"}.get(name, "2")


@pytest.mark.parametrize("name", [n for n in CASES
                                  if not n.startswith("control")])
def test_sharded_step_matches_single_device_reference(sharded, name):
    got, refs = sharded
    want_m, want_p, want_g = refs[_ref_for(name)]
    arch, shape, n_steps = CASES[name][:3]
    for r in range(4):
        for gm, wm in zip(got[r][name]["metrics"], want_m, strict=True):
            np.testing.assert_allclose(gm["loss"], wm["loss"], rtol=1e-5)
            np.testing.assert_allclose(gm["grad_norm"], wm["grad_norm"],
                                       rtol=1e-5)
            assert gm["lr"] == wm["lr"]
    # the first step's gradients, every leaf within GRAD_REL of its
    # largest |g|
    for a, b in zip(_leaves(got[0][name]["grads"]), _leaves(want_g),
                    strict=True):
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_REL * max(
            float(np.abs(b).max()), 1e-30))
    # the parameters: the mesh's reassociated sums add to the one-device
    # port's own difference, and Adam amplifies both where a gradient is
    # near 0 (lm_head's rows of rare tokens: one element of llama3's 115k
    # at 5.07e-5 after 2 steps on (2, 2))
    _params_first_step_rule(got[0][name]["params"], want_p, 3e-3)
    # the flash path ran on every rank under the mesh: K5 twice a layer a
    # microbatch (forward, and the recompute of remat), K6/K7 once
    n = registry.smoke_config(arch).n_layers * n_steps * CASES[name][3]
    for r in range(4):
        assert got[r][name]["calls"] == {"fwd": 2 * n, "bwd": n}, r


def test_sharded_step_lays_parameters_out_by_the_rules(sharded):
    got, _ = sharded
    R, S0, S1 = Replicate(), Shard(0), Shard(1)
    pl = got[0]["kv_heads_sharded_2x2"]["placements"]
    assert pl["blocks.0.attn.wq"] == (R, S1)
    assert pl["blocks.0.attn.wo"] == (R, S0)
    assert pl["embed"] == (R, S0)
    assert pl["blocks.0.ln1"] == (R, R)
    fs = got[0]["fsdp"]["placements"]
    assert fs["blocks.0.attn.wq"] == (S0, S1)
    moe = got[0]["mixtral_2x2"]["placements"]
    # 4 experts over data x model: one expert a rank
    assert moe["blocks.0.moe.w1"] == (S0, S0)


def test_control_kv_slice_one_head_off_fails(sharded):
    got, refs = sharded
    want_m, want_p, want_g = refs["2"]
    bad = got[0]["control_kv_slice_one_head_off"]
    assert abs(bad["metrics"][0]["loss"] - want_m[0]["loss"]) > 1e-5 * abs(
        want_m[0]["loss"])
    with pytest.raises(AssertionError):
        _params_first_step_rule(bad["params"], want_p, 3e-3)
    wk = want_g["dense"]["attn"]["wk"]
    assert np.abs(bad["grads"]["dense"]["attn"]["wk"] - wk).max() \
        > GRAD_REL * np.abs(wk).max()


# --- the compressed data-parallel step ---------------------------------------------
_REF_DP = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import registry
    from repro.models import lm
    from repro.optim import adamw, compress
    from repro.train import loop
    n_dev, n_steps = int(sys.argv[1]), int(sys.argv[2])
    d = np.load(sys.argv[3])
    cfg = registry.smoke_config("llama3-8b")
    model = lm.build(cfg)
    oc = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=3)
    mesh = jax.make_mesh((n_dev,), ("data",))
    step = loop.make_compressed_dp_step(model, oc, mesh)
    p = model.init(jax.random.PRNGKey(0))
    s = adamw.init(oc, p)
    e = compress.init_error(p)
    out = {}
    for i in range(n_steps):
        p, s, e, m = step(p, s, e, {"tokens": jnp.asarray(d[f"t{i}"])})
        out[f"loss{i}"] = np.asarray(m["loss"])
        if i == 0:
            e0 = e
    flat = jax.tree_util.tree_flatten_with_path
    for path, x in flat(p)[0]:
        out["p/" + jax.tree_util.keystr(path)] = np.asarray(x, np.float32)
    for path, x in flat(e0)[0]:
        out["e/" + jax.tree_util.keystr(path)] = np.asarray(x)
    np.savez(sys.argv[4], **out)
""")


def _keystr(keys):
    return "".join(f"['{k}']" for k in keys)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {_keystr(prefix): np.asarray(tree, np.float32)}


def _ref_dp(tmp_path, n_dev, n_steps, toks):
    """The reference's make_compressed_dp_step on n_dev forced CPU
    devices: losses, parameters and the error state after the first step
    (its replicated out_specs hand back device 0's)."""
    src = tmp_path / f"dp{n_dev}.npz"
    np.savez(src, **{f"t{i}": t for i, t in enumerate(toks)})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_dev}")
    dst = tmp_path / f"dp{n_dev}_out.npz"
    res = subprocess.run([sys.executable, "-c", _REF_DP, str(n_dev),
                          str(n_steps), str(src), str(dst)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(dst))


def _dp_run(tree, toks, mesh):
    """The port's compressed step on this rank: losses, parameters and
    this rank's error state after the first step (numpy)."""
    cfg = registry.smoke_config("llama3-8b", attn_impl="flash")
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    model.requires_grad_(True)
    ocfg = adamw.AdamWConfig(**LR)
    step = tl.make_compressed_dp_step(model, ocfg, mesh)
    params = tl.params_of(model)
    state, err = adamw.init(ocfg, params), compress.init_error(params)
    losses = []
    for t in toks:
        batch = pipeline.make_global_batch(mesh, {"tokens": t})
        params, state, err, m = step(params, state, err, batch)
        losses.append(float(m["loss"]))
        if len(losses) == 1:
            first_err = _flat(lm_params_to_numpy(model, err))
    return (losses, _flat(lm_params_to_numpy(model)), first_err,
            dict(step.stats))


def _rank_dp(rank, world, init_file, tree, toks):
    ranks.init(rank, world, init_file)
    return _dp_run(tree, toks, make_host_mesh(device="cpu"))


def _check_dp(got, want, n_steps, rank):
    """Losses 1e-5 relative. An int8 code of the gradient rounds the
    other way where the two float32 gradients straddle a rounding
    boundary, which moves that element's g_hat by a whole step: so the
    rule of test_torch_train's int8 step holds a step, codes flipping on
    at most 0.1% of the elements each. Parameters: at most 2 lr, 5e-5 on
    all but 0.1% a step. The error state after the first step, err' =
    g - dequant (its inputs the same on both sides; after the second the
    parameters differ where Adam is ill-conditioned): within GRAD_REL
    (2e-5) of the leaf's largest |g| (254 times its largest |err'|, half
    a code step of the largest block) on all but 0.1%. The reference's
    err is replicated in and out of its shard_map (``P()``, replication
    unchecked), so each device keeps its own residual, as each rank does
    here; the value it hands back is device 0's."""
    losses, params, errs, _ = got
    for i in range(n_steps):
        np.testing.assert_allclose(losses[i], float(want[f"loss{i}"]),
                                   rtol=1e-5)
    lr, frac = 3e-3, 1e-3 * n_steps
    err = np.concatenate([np.abs(a - b).ravel() for a, b in zip(
        _leaves(params), _leaves({k[2:]: v for k, v in want.items()
                                  if k.startswith("p/")}), strict=True)])
    assert err.max() <= 2 * lr and np.mean(err > 5e-5) <= frac, \
        (err.max(), np.mean(err > 5e-5))
    if rank:
        return      # the reference's out_specs=P() returns device 0's err
    werr = {k[2:]: v for k, v in want.items() if k.startswith("e/")}
    assert errs.keys() == werr.keys()
    over = [np.abs(errs[k] - werr[k]).ravel()
            > 2e-5 * 254 * float(np.abs(werr[k]).max()) for k in errs]
    assert np.mean(np.concatenate(over)) <= 1e-3


def test_compressed_dp_two_ranks_match_reference(tmp_path):
    toks = [_tokens(i) for i in range(2)]
    tree = _ref_params("llama3-8b")
    got, want = _beside(
        lambda: ranks.run_ranks(_rank_dp, 2, str(tmp_path / "rdzv"),
                                (tree, toks), nice=NICE),
        lambda: _ref_dp(tmp_path, 2, 2, toks))
    for r in range(2):
        _check_dp(got[r], want, 2, r)
    # the int32 codes stand for float32 gradients: as many bytes, plus the
    # scales and the count
    stats = got[0][3]
    assert stats["payload_bytes"] >= stats["dense_bytes"]


def test_compressed_dp_one_rank_matches_one_device_reference(tmp_path):
    toks = [_tokens(i) for i in range(2)]
    tree = _ref_params("llama3-8b")

    def port():
        mesh = make_host_mesh(device="cpu")
        try:
            return _dp_run(tree, toks, mesh)
        finally:
            dist.destroy_process_group()
    want, got = _beside(lambda: _ref_dp(tmp_path, 1, 2, toks), port)
    _check_dp(got, want, 2, 0)


# --- the global batch, the elastic restore, the Supervisor ----------------------
def _state_numpy(state):
    """Every tensor leaf of a state, gathered, as numpy (bf16 as its
    bits)."""
    out = {}
    for k, v in checkpoint._flatten(state).items():
        if isinstance(v, torch.Tensor):
            a, _ = checkpoint._to_host(v)
            out[k] = a
        else:
            out[k] = v
    return out


def _train_state(mesh, quantized=True, dtype="bfloat16"):
    cfg = registry.smoke_config("llama3-8b", attn_impl="flash", dtype=dtype)
    from repro_torch.models.lm import LM
    model = LM(cfg, device="cpu", seed=0, trainable=True)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0,
                             quantized_state=quantized)
    step, shardings = tl.make_train_step(model, ocfg, mesh)
    params = tl.params_of(model)
    sh = shardings(params)
    state = sh.distribute({"opt_state": adamw.init(ocfg, params)})
    return model, step, sh, state


def _rank_elastic(rank, world, init_file, ckpt_dir, sup_dir):
    ranks.init(rank, world, init_file)
    out = {"supervisor": _supervised(sup_dir)}
    # the global batch: each rank exactly its rows, made from them alone
    mesh = make_host_mesh(2, device="cpu")
    glob = np.arange(8 * 5, dtype=np.int32).reshape(8, 5)
    gb = pipeline.make_global_batch(mesh, {"tokens": glob})["tokens"]
    lo, hi = pipeline.local_rows(mesh, 8)
    ds = pipeline.SyntheticLM(256, 16, 8)
    local = pipeline.make_global_batch(
        mesh, {"tokens": ds.batch_at(3, lo, hi)}, global_batch=8)["tokens"]
    out["batch"] = (gb.to_local().numpy(), gb.full_tensor().numpy(),
                    (lo, hi), local.full_tensor().numpy(),
                    tuple(gb.placements))
    # save at (2, 2) after a step, restore at (4, 1), (1, 4) and (2, 2)
    model, step, sh, state = _train_state(mesh)
    p, o, _ = step(state["params"], state["opt_state"],
                   pipeline.make_global_batch(mesh, {"tokens": _tokens(0)}))
    state = {"params": p, "opt_state": o}
    checkpoint.save(ckpt_dir, 1, state)
    out["saved"] = _state_numpy(state)
    for m in (1, 4, 2):
        mesh_m = make_host_mesh(m, device="cpu")
        _, _, sh_m, like = _train_state(mesh_m)
        got = checkpoint.restore(ckpt_dir, 1, like,
                                 {"params": sh_m.params,
                                  "opt_state": sh_m.state})
        placed = {n: got["params"][n].placements == sh_m.params[n].placements
                  for n in got["params"]}
        out[f"restored_{m}"] = (_state_numpy(got), all(placed.values()),
                                tuple(mesh_m.shape))
    out["dot_f32"] = _dot_f32_cases()
    # mesh errors
    try:
        make_host_mesh(3, device="cpu")
        out["bad_axis"] = None
    except ValueError as e:
        out["bad_axis"] = str(e)
    try:
        make_production_mesh(device="cpu")
        out["production"] = None
    except ValueError as e:
        out["production"] = str(e)
    return out


def test_global_batch_elastic_restore_and_mesh_errors(elastic):
    d, got = elastic
    ckpt = str(d / "ckpt")
    glob = np.arange(40, dtype=np.int32).reshape(8, 5)
    ds = pipeline.SyntheticLM(256, 16, 8)
    for r in range(4):
        local, full, (lo, hi), synth, place = got[r]["batch"]
        d = r // 2                      # (data, model) = (2, 2), row major
        assert (lo, hi) == (4 * d, 4 * d + 4)
        np.testing.assert_array_equal(local, glob[lo:hi])
        np.testing.assert_array_equal(full, glob)
        np.testing.assert_array_equal(synth, ds.batch_at(3))
        assert place == (Shard(0), Replicate())
    saved = got[0]["saved"]
    assert any(k.endswith("__q") for k in saved)        # int8 moments
    for r in range(4):
        for m, shape in ((1, (4, 1)), (4, (1, 4)), (2, (2, 2))):
            leaves, placed, mshape = got[r][f"restored_{m}"]
            assert placed and mshape == shape
            assert leaves.keys() == saved.keys()
            for k in saved:
                np.testing.assert_array_equal(leaves[k], saved[k], err_msg=k)
    # a world of one: the same checkpoint as plain tensors
    cfg = registry.smoke_config("llama3-8b", attn_impl="flash",
                                dtype="bfloat16")
    from repro_torch.models.lm import LM
    model = LM(cfg, device="cpu", seed=1, trainable=True)
    ocfg = adamw.AdamWConfig(quantized_state=True)
    like = {"params": tl.params_of(model),
            "opt_state": adamw.init(ocfg, tl.params_of(model))}
    one = checkpoint.restore(ckpt, 1, like)
    for k, v in _state_numpy(one).items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    assert "does not divide" in got[0]["bad_axis"]
    assert "needs 256 ranks" in got[0]["production"]


def _dot_f32_cases():
    """The card's float32-out unembedding GEMM on a mesh
    (``layers._dot_f32_mesh``, a ``local_map`` around ``_DotF32``; its
    ``torch.mm(out_dtype=float32)`` taken here in float32 on the bf16
    values, exactly) against ``_DotF32`` on whole tensors, for the
    layouts the mesh gives it: (max |y err|, max |dx err|, max |dw err|,
    y's placements) a case."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import layers

    def fwd(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x.float(), w.float())
    saved = layers._DotF32.forward
    layers._DotF32.forward = staticmethod(fwd)
    out = []
    try:
        R, S0, S1 = Replicate(), Shard(0), Shard(1)
        for m, xp, wp in ((2, [S0, R], [R, S1]), (4, [R, R], [R, S1]),
                          (1, [S0, R], [R, R]), (2, [R, S1], [R, S0])):
            mesh = make_host_mesh(m, device="cpu")
            g = torch.Generator().manual_seed(0)
            x = torch.randn(8, 16, generator=g).bfloat16()
            w = torch.randn(16, 12, generator=g).bfloat16()
            dy = torch.randn(8, 12, generator=g)
            xd = distribute_tensor(x, mesh, xp, src_data_rank=None)
            wd = distribute_tensor(w, mesh, wp, src_data_rank=None)
            xd.requires_grad_()
            wd.requires_grad_()
            y = layers._dot_f32_mesh(xd, wd)
            y.backward(distribute_tensor(dy, mesh, y.placements,
                                         src_data_rank=None))
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            layers._DotF32.apply(xr, wr).backward(dy)
            want = layers._DotF32.apply(x, w)
            out.append((float((y.full_tensor() - want).abs().max()),
                        float((xd.grad.full_tensor().float()
                               - xr.grad.float()).abs().max()),
                        float((wd.grad.full_tensor().float()
                               - wr.grad.float()).abs().max()),
                        float(xr.grad.float().abs().max()),
                        float(wr.grad.float().abs().max()),
                        tuple(y.placements)))
    finally:
        layers._DotF32.forward = saved
    return out


def _supervised(ckpt_dir):
    """A supervised run at (2, 2) with a fault at step 3, and the same
    steps straight through."""
    mesh = make_host_mesh(2, device="cpu")
    ds = pipeline.SyntheticLM(256, 16, 4)

    def data_fn(s):
        return pipeline.make_global_batch(mesh, {"tokens": ds.batch_at(s)})

    _, step, sh, state = _train_state(mesh, quantized=False, dtype="float32")
    faults = {"armed": True}

    def fault_hook(s):
        if s == 3 and faults["armed"]:
            faults["armed"] = False
            raise RuntimeError("injected node failure")

    sup = fault.Supervisor(ckpt_dir=ckpt_dir, ckpt_every=2, max_restarts=2)
    shard = {"params": sh.params, "opt_state": sh.state}
    final, hist = sup.run(state=state, step_fn=step, data_fn=data_fn,
                          n_steps=5, fault_hook=fault_hook, shardings=shard)
    _, step2, _, state2 = _train_state(mesh, quantized=False,
                                       dtype="float32")
    for s in range(5):
        p, o, _ = step2(state2["params"], state2["opt_state"], data_fn(s))
        state2 = {"params": p, "opt_state": o}
    return ([h["step"] for h in hist], final["opt_state"].step,
            _state_numpy(final), _state_numpy(state2),
            checkpoint.latest_step(ckpt_dir))


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    return d, ranks.run_ranks(_rank_elastic, 4, str(d / "rdzv"),
                              (str(d / "ckpt"), str(d / "sup")), nice=NICE)


def test_supervisor_restarts_with_shardings_bit_identically(elastic):
    """The reference's test_supervisor_restarts_from_checkpoint on the
    mesh, restoring with ``shardings=``: the restarted run equals the
    uninterrupted one bit for bit."""
    for res in elastic[1]:
        steps, last, final, straight, latest = res["supervisor"]
        assert steps == [0, 1, 2, 2, 3, 4] and last == 5 and latest == 5
        assert final.keys() == straight.keys()
        for k in final:
            np.testing.assert_array_equal(final[k], straight[k], err_msg=k)


def test_float32_out_gemm_on_a_mesh(elastic):
    """The unembedding's float32-out GEMM, which DTensor has no rule
    for, through its local_map region: the product exact, rows split
    with x, columns with w; the gradients within one bf16 ulp of their
    largest value (a split contraction sums bf16-rounded partials)."""
    R, S0, S1 = Replicate(), Shard(0), Shard(1)
    want = [(S0, S1), (R, S1), (S0, R), (R, R)]
    for res in elastic[1]:
        for (y_err, dx_err, dw_err, dx_max, dw_max, place), pl in zip(
                res["dot_f32"], want, strict=True):
            assert y_err == 0 and place == pl
            assert dx_err <= 2 ** -7 * dx_max and dw_err <= 2 ** -7 * dw_max


# --- the launcher --------------------------------------------------------------
LAUNCH = ["--smoke", "--device", "cpu", "--steps", "8", "--global-batch",
          "8", "--seq-len", "64"]


def _rank_launch(rank, world, init_file):
    from repro_torch.launch import train as launch_train
    ranks.init(rank, world, init_file)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hist = launch_train.main(LAUNCH + ["--model-axis", "2"])
    return [h["loss"] for h in hist], buf.getvalue()


def test_launch_train_model_axis_on_four_ranks(tmp_path):
    from repro_torch.launch import train as launch_train
    def one_rank():
        with contextlib.redirect_stdout(io.StringIO()):
            return [h["loss"] for h in launch_train.main(LAUNCH)]
    got, one = _beside(lambda: ranks.run_ranks(
        _rank_launch, 4, str(tmp_path / "rdzv"), timeout=240, nice=NICE),
        one_rank)
    for r, (losses, text) in enumerate(got):
        np.testing.assert_allclose(losses, one, rtol=1e-4)
        if r == 0:
            assert "step 7 loss=" in text and "steps=8" in text
        else:
            assert text == ""
    assert np.mean(one[-3:]) < np.mean(one[:3])


def test_mesh_module_touches_no_process_group_and_needs_a_card():
    import repro_torch.launch.mesh  # noqa: F401
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()
        assert not dist.is_initialized()


# --- on the card ------------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_one_rank_mesh_step_runs_k5_k7(tmp_path):
    """make_train_step on a one-rank NCCL mesh at the SMOKE config with
    head dim 64, bf16: K5 twice a layer a step (the forward and remat's
    recompute) and K6/K7 once, launched through the local_map region
    (the bf16 unembedding through its own, ``_dot_f32_mesh``); the loss
    equals make_train_fn's on the same card to 1e-6 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    cfg = registry.smoke_config("llama3-8b", attn_impl="flash",
                                dtype="bfloat16", head_dim=64)
    from repro_torch.models.lm import LM
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    toks = _tokens(0, b=2, s=128)
    plain = LM(cfg, device="cuda", seed=0, trainable=True)
    pp = tl.params_of(plain)
    _, _, want = tl.make_train_fn(plain, ocfg)(
        pp, adamw.init(ocfg, pp), {"tokens": torch.from_numpy(toks).cuda()})
    mesh = make_host_mesh()
    try:
        model = LM(cfg, device="cuda", seed=0, trainable=True)
        step, shardings = tl.make_train_step(model, ocfg, mesh)
        params = tl.params_of(model)
        state = shardings(params).distribute(
            {"opt_state": adamw.init(ocfg, params)})
        flash_cuda.reset_launches()
        _, _, got = step(state["params"], state["opt_state"],
                         pipeline.make_global_batch(mesh, {"tokens": toks}))
        torch.cuda.synchronize()
        n = cfg.n_layers
        assert flash_cuda.LAUNCHES == {flash_cuda.NAME: 2 * n,
                                       flash_cuda.DQ: n, flash_cuda.DKV: n}
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-6)
    finally:
        dist.destroy_process_group()
