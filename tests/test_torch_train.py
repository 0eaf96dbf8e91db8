"""The port's training slice against the reference: the synthetic data,
``LM.loss`` and its gradients, microbatching, the train step over several
steps, checkpoints and the fault supervisor, and the launcher.

Weights are the reference's own init, carried across as numpy by
``convert.lm_params_from_numpy``; gradients and updated parameters come
back as the reference's pytree through ``convert.lm_params_to_numpy``.
The reference's flash path needs an ambient 1x1 ("data", "model") mesh
(layers.py:89); every comparison with ``attn_impl="flash"`` traces it
there, where its Pallas kernels run in interpret mode. Tolerances at the
llama3 smoke config in float32: loss 1e-5 relative, each gradient leaf
within 2e-5 of its largest |g|; after 3 AdamW steps, parameters within
5e-5, about 1% of what the steps move them: Adam's early steps move an
element by ~lr * sign(g), so an element whose gradient is near 0 turns the
~1e-6 gradient differences into larger ones.
"""
import contextlib
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import registry as rregistry
from repro.data import pipeline as rpipeline
from repro.models import lm as rlm
from repro.optim import adamw as radamw
from repro.train import loop as rloop
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.data import pipeline
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import LM
from repro_torch.optim import adamw
from repro_torch.train import checkpoint, fault
from repro_torch.train import loop as tl

GRAD_REL = 2e-5


def _ctx(attn_impl):
    if attn_impl != "flash":
        return contextlib.nullcontext()
    return jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"),
                                      **compat.axis_types_kwarg(2)))


@pytest.fixture(scope="module")
def ref_params():
    cfg = rregistry.smoke_config("llama3-8b")
    return rlm.build(cfg).init(jax.random.PRNGKey(0))


def _pair(ref_params, attn_impl="flash", **kw):
    """(reference model, port model) with the same weights."""
    rcfg = rregistry.smoke_config("llama3-8b", attn_impl=attn_impl, **kw)
    pcfg = registry.smoke_config("llama3-8b", attn_impl=attn_impl, **kw)
    model = lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, ref_params),
                                 device="cpu")
    return rlm.build(rcfg), model.requires_grad_(True)


def _tokens(B=4, S=32, step=0, vocab=256):
    return rpipeline.SyntheticLM(vocab, S, B).batch_at(step)


def _close_tree(got, want, rel):
    """Every leaf of ``got`` within ``rel`` of its largest |want|."""
    def one(a, b):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rel * max(float(np.abs(b).max()),
                                                  1e-30))
    jax.tree.map(one, got, want)


# --- data ------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,lo,hi", [(0, 0, 0, 4), (3, 5, 1, 3),
                                             (7, 123, 0, 1)])
def test_synthetic_tokens_equal_reference(seed, step, lo, hi):
    want = rpipeline.SyntheticLM(1000, 64, 4, seed=seed).batch_at(step, lo, hi)
    got = pipeline.SyntheticLM(1000, 64, 4, seed=seed).batch_at(step, lo, hi)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_device_batch_and_prefetcher():
    ds = pipeline.SyntheticLM(100, 16, 2)
    b = pipeline.device_batch({"tokens": ds.batch_at(0)}, torch.device("cpu"))
    assert b["tokens"].shape == (2, 16) and b["tokens"].dtype == torch.int32
    got = list(pipeline.Prefetcher((ds.batch_at(s) for s in range(5)),
                                   depth=2))
    assert len(got) == 5
    np.testing.assert_array_equal(got[3], ds.batch_at(3))


# --- loss and gradients ------------------------------------------------------------
@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_loss_and_grads_match_reference(ref_params, attn_impl):
    rmodel, model = _pair(ref_params, attn_impl)
    toks = _tokens()
    with _ctx(attn_impl):
        (want, wm), wg = jax.value_and_grad(rmodel.loss, has_aux=True)(
            ref_params, {"tokens": jnp.asarray(toks)})
    loss, metrics = model.loss(torch.from_numpy(toks))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(wm["ce"]),
                               rtol=1e-5)
    assert float(metrics["aux"]) == float(wm["aux"]) == 0.0
    grads = lm_params_to_numpy(model, {n: p.grad for n, p in
                                       model.named_parameters()})
    _close_tree(grads, wg, GRAD_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma_loss_and_grads_match_reference(dtype):
    """A gemma-shaped LM at head dim 256 (geglu, tied embeddings; the
    embedding's gradient sums its lookup and the unembedding), through the
    flash path at D = 256 (K5, K6 and K7's plain versions): the loss, and
    in float32 every gradient leaf, against the reference's with converted
    weights. bf16 gradients round at other points in the two frameworks'
    backward passes, so in bf16 the loss is held, at the layers' bf16
    tolerance."""
    over = dict(head_dim=256, dtype=dtype, attn_impl="flash")
    rcfg = rregistry.smoke_config("gemma-7b", **over)
    pcfg = registry.smoke_config("gemma-7b", **over)
    rmodel = rlm.build(rcfg)
    params = rmodel.init(jax.random.PRNGKey(2))
    model = lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, params),
                                 device="cpu").requires_grad_(True)
    toks = _tokens(B=2, S=24, vocab=rcfg.vocab)
    with _ctx("flash"):
        (want, _), wg = jax.value_and_grad(rmodel.loss, has_aux=True)(
            params, {"tokens": jnp.asarray(toks)})
    loss, _ = model.loss(torch.from_numpy(toks))
    loss.backward()
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
        grads = lm_params_to_numpy(model, {n: p.grad for n, p in
                                           model.named_parameters()})
        assert "lm_head" not in grads
        _close_tree(grads, wg, GRAD_REL)
    else:
        np.testing.assert_allclose(float(loss), float(want), rtol=2e-2)
        assert all(bool(torch.isfinite(p.grad).all())
                   for p in model.parameters())


def test_loss_runs_k5_under_autograd_and_remat_changes_nothing(ref_params):
    """With ``remat`` each block is recomputed in the backward; the loss
    and every gradient are the same as without it."""
    _, model = _pair(ref_params, "flash")
    _, plain = _pair(ref_params, "flash", remat=False)
    toks = torch.from_numpy(_tokens(B=2, S=40))
    out = []
    for m in (model, plain):
        loss, _ = m.loss(toks)
        loss.backward()
        out.append((float(loss), {n: p.grad for n, p in
                                  m.named_parameters()}))
    assert out[0][0] == out[1][0]
    for n, g in out[0][1].items():
        torch.testing.assert_close(g, out[1][1][n], rtol=0, atol=0)


def test_serving_model_takes_no_gradients():
    model = LM(registry.smoke_config("llama3-8b"), device="cpu", seed=0)
    assert not any(p.requires_grad for p in model.parameters())
    trainable = LM(registry.smoke_config("llama3-8b"), device="cpu", seed=0,
                   trainable=True)
    assert all(p.requires_grad for p in trainable.parameters())


def test_microbatch_grads_match_full_batch(ref_params):
    _, model = _pair(ref_params, "flash")
    batch = {"tokens": torch.from_numpy(_tokens(B=4))}
    params = tl.params_of(model)
    l1, m1, g1 = tl.microbatch_grads(model, params, batch, 1)
    l2, m2, g2 = tl.microbatch_grads(model, params, batch, 2)
    assert set(m1) == {"ce", "aux"} and m2 == {}
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for n, g in g1.items():
        assert g2[n].dtype == torch.float32
        torch.testing.assert_close(g2[n], g.float(), rtol=0,
                                   atol=1e-5 * float(g.abs().max()))
    assert all(p.grad is None for p in model.parameters())


def test_microbatch_grads_match_reference(ref_params):
    """n_micro=2 against the reference's scan accumulation."""
    rmodel, model = _pair(ref_params, "einsum")
    toks = _tokens(B=4)
    want_l, _, want_g = rloop.microbatch_grads(
        rmodel, ref_params, {"tokens": jnp.asarray(toks)}, 2)
    loss, _, grads = tl.microbatch_grads(
        model, tl.params_of(model), {"tokens": torch.from_numpy(toks)}, 2)
    np.testing.assert_allclose(float(loss), float(want_l), rtol=1e-5)
    _close_tree(lm_params_to_numpy(model, grads), want_g, GRAD_REL)


def test_bf16_grads_keep_the_parameter_dtype():
    cfg = registry.smoke_config("llama3-8b", dtype="bfloat16",
                                attn_impl="flash")
    model = LM(cfg, device="cpu", seed=0, trainable=True)
    batch = {"tokens": torch.from_numpy(_tokens(B=2))}
    _, _, g1 = tl.microbatch_grads(model, tl.params_of(model), batch, 1)
    _, _, g2 = tl.microbatch_grads(model, tl.params_of(model), batch, 2)
    for n, p in model.named_parameters():
        assert g1[n].dtype == p.dtype and g2[n].dtype == torch.float32


def test_three_train_steps_match_reference(ref_params):
    """make_train_fn against the reference's, 3 steps on the same batches
    with float32 moments: the losses, grad norms and lrs of every step and
    the parameters after the last."""
    rmodel, model = _pair(ref_params, "flash")
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=3)
    rc, pc = radamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    rstep = jax.jit(rloop.make_train_fn(rmodel, rc))
    pstep = tl.make_train_fn(model, pc)
    rp, rs = ref_params, radamw.init(rc, ref_params)
    pp = tl.params_of(model)
    ps = adamw.init(pc, pp)
    for i in range(3):
        toks = _tokens(step=i)
        with _ctx("flash"):
            rp, rs, rm = rstep(rp, rs, {"tokens": jnp.asarray(toks)})
        pp, ps, pm = pstep(pp, ps, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-5)
        assert float(pm["lr"]) == float(rm["lr"])
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=5e-5), lm_params_to_numpy(model), rp)


def test_int8_moment_step_matches_reference(ref_params):
    """One step with int8 moments. The step's update reads the float32
    moments, so loss, grad norm and parameters agree as with float32
    state; the stored int8 codes may differ by one where the two float32
    moments straddle a rounding boundary (on at most 0.1% of them), which
    is why later steps with int8 state are not compared element for
    element."""
    rmodel, model = _pair(ref_params, "flash")
    kw = dict(lr=3e-3, warmup_steps=0, quantized_state=True)
    rc, pc = radamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    toks = _tokens(step=5)
    with _ctx("flash"):
        rp, rs, rm = jax.jit(rloop.make_train_fn(rmodel, rc))(
            ref_params, radamw.init(rc, ref_params),
            {"tokens": jnp.asarray(toks)})
    pp = tl.params_of(model)
    _, ps, pm = tl.make_train_fn(model, pc)(
        pp, adamw.init(pc, pp), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-5)
    # Adam's first step moves an element by lr * g / (|g| + eps): where
    # |g| is near eps the step is ill-conditioned, so a few elements may
    # differ by up to a step; every other within 5e-5
    err = np.concatenate([np.abs(a - np.asarray(b)).ravel() for a, b in zip(
        jax.tree.leaves(lm_params_to_numpy(model)), jax.tree.leaves(rp))])
    assert err.max() <= 2 * kw["lr"] and np.mean(err > 5e-5) <= 1e-3
    for moments, want in ((ps.m, rs.m), (ps.v, rs.v)):
        codes = lm_params_to_numpy(model, {n: t.q for n, t in
                                           moments.items()})
        scales = lm_params_to_numpy(model, {n: t.scale for n, t in
                                            moments.items()})
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=1e-5, atol=0), scales,
            jax.tree.map(lambda t: t.scale, want,
                         is_leaf=lambda x: isinstance(x, radamw.QTensor)))
        diff = jax.tree.map(
            lambda a, b: np.abs(a.astype(np.int32) - np.asarray(b.q)),
            codes, want, is_leaf=lambda x: isinstance(x, radamw.QTensor))
        flat = np.concatenate([d.ravel() for d in jax.tree.leaves(diff)])
        assert flat.max() <= 1 and flat.mean() <= 1e-3


def test_train_step_binds_restored_params(ref_params):
    """A step given tensors that are not the model's (a restored
    checkpoint) copies them into the model first."""
    _, model = _pair(ref_params, "einsum")
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    step = tl.make_train_fn(model, cfg)
    own = tl.params_of(model)
    copy = {n: p.detach().clone() + 1.0 for n, p in own.items()}
    want = {n: t.clone() for n, t in copy.items()}
    batch = {"tokens": torch.from_numpy(_tokens(B=2))}
    got, _, _ = step(copy, adamw.init(cfg, own), batch)
    assert got.keys() == own.keys() and all(got[n] is own[n] for n in own)
    for n in own:   # one step from the restored values, not the old ones
        assert float((got[n] - want[n]).abs().max()) < 1e-2


# --- checkpoints -----------------------------------------------------------------
def _bf16_state():
    cfg = registry.smoke_config("llama3-8b", dtype="bfloat16")
    model = LM(cfg, device="cpu", seed=3, trainable=True)
    ocfg = adamw.AdamWConfig(quantized_state=True)
    params = tl.params_of(model)
    state = adamw.init(ocfg, params)
    grads = {n: torch.randn(p.shape, generator=torch.Generator()
                            .manual_seed(1)).to(p.dtype)
             for n, p in params.items()}
    _, state, _ = adamw.update(ocfg, grads, state, params,
                               decay=model.decays())
    return {"params": params, "opt_state": state}


def _assert_same(a, b):
    fa, fb = checkpoint._flatten(a), checkpoint._flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype, k
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_checkpoint_round_trip_bf16_bitwise(tmp_path):
    """bf16 leaves are stored as their raw 16 bits (uint16 .npy, dtype
    "bfloat16" in the manifest), int8 moments and float32 scales as they
    are, the step counter as an int; all come back bit for bit."""
    state = _bf16_state()
    checkpoint.save(str(tmp_path), 7, state)
    assert checkpoint.latest_step(str(tmp_path)) == 7
    got = checkpoint.restore(str(tmp_path), 7, state)
    _assert_same(got, state)
    assert isinstance(got["opt_state"], adamw.OptState)
    assert got["opt_state"].step == 1
    d = tmp_path / "step_00000007"
    assert np.load(d / "params__embed.npy").dtype == np.uint16
    assert np.load(d / "opt_state__m__embed__q.npy").dtype == np.int8


def test_checkpoint_async_save_snapshots_at_call(tmp_path):
    state = _bf16_state()
    want = {n: p.detach().clone() for n, p in state["params"].items()}
    t = checkpoint.save(str(tmp_path), 3, state, blocking=False)
    with torch.no_grad():                 # a later in-place update
        for p in state["params"].values():
            p.add_(1)
    t.join()
    got = checkpoint.restore(str(tmp_path), 3, state)
    for n, w in want.items():
        assert torch.equal(got["params"][n], w)


def test_checkpoint_ignores_partial_dirs(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"x": torch.ones(3)})
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert checkpoint.latest_step(str(tmp_path)) == 1
    assert checkpoint.latest_step(str(tmp_path / "missing")) is None


def test_checkpoint_rejects_another_shape(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"x": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), 1, {"x": torch.ones(4)})


# --- fault tolerance ----------------------------------------------------------------
def _smoke_run(lr=1e-3):
    cfg = registry.smoke_config("llama3-8b", attn_impl="flash")
    model = LM(cfg, device="cpu", seed=0, trainable=True)
    ocfg = adamw.AdamWConfig(lr=lr, warmup_steps=0)
    params = tl.params_of(model)
    ds = pipeline.SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=4)
    return (model, tl.make_train_fn(model, ocfg),
            {"params": params, "opt_state": adamw.init(ocfg, params)},
            lambda s: {"tokens": torch.from_numpy(ds.batch_at(s))})


def test_supervisor_restarts_from_checkpoint(tmp_path):
    model, step, state, data_fn = _smoke_run()
    faults = {"armed": True}

    def fault_hook(s):
        if s == 7 and faults["armed"]:
            faults["armed"] = False
            raise RuntimeError("injected node failure")

    sup = fault.Supervisor(ckpt_dir=str(tmp_path), ckpt_every=5,
                           max_restarts=2)
    final, hist = sup.run(state=state, step_fn=step, data_fn=data_fn,
                          n_steps=10, fault_hook=fault_hook)
    assert final["opt_state"].step == 10
    steps_run = [h["step"] for h in hist]
    assert steps_run.count(5) + steps_run.count(6) >= 2   # re-ran 5/6
    assert checkpoint.latest_step(str(tmp_path)) == 10

    # the restarted run equals an uninterrupted one
    _, step2, state2, _ = _smoke_run()
    for s in range(10):
        p, o, _ = step2(state2["params"], state2["opt_state"], data_fn(s))
        state2 = {"params": p, "opt_state": o}
    for n, p in final["params"].items():
        torch.testing.assert_close(p, state2["params"][n], rtol=0,
                                   atol=1e-6)


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    _, step, state, data_fn = _smoke_run()

    def always_fail(s):
        raise RuntimeError("dead node")

    sup = fault.Supervisor(ckpt_dir=str(tmp_path), max_restarts=2)
    with pytest.raises(RuntimeError, match="dead node"):
        sup.run(state=state, step_fn=step, data_fn=data_fn, n_steps=5,
                fault_hook=always_fail)


def test_straggler_detection(tmp_path):
    _, step, state, data_fn = _smoke_run()
    step(state["params"], state["opt_state"], data_fn(0))
    t0 = time.perf_counter()
    step(state["params"], state["opt_state"], data_fn(0))
    typical = time.perf_counter() - t0
    alerts = []

    def slow_hook(s):
        if s == 8:
            time.sleep(max(1.0, 10.0 * typical))

    sup = fault.Supervisor(ckpt_dir=str(tmp_path), straggler_factor=3.0,
                           on_straggler=alerts.append)
    sup.run(state=state, step_fn=step, data_fn=data_fn, n_steps=10,
            fault_hook=slow_hook)
    assert any(a.step == 8 for a in alerts)


# --- the launcher -------------------------------------------------------------------
def test_launch_train_smoke_on_cpu(capsys):
    hist = launch_train.main(["--smoke", "--device", "cpu", "--steps", "25",
                              "--global-batch", "8", "--seq-len", "64"])
    out = capsys.readouterr().out
    assert "steps=25" in out and "step 24 loss=" in out
    losses = [h["loss"] for h in hist]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses
    assert all(np.isfinite(h["grad_norm"]) for h in hist)


@pytest.mark.parametrize("head_dim", [None, 256])
def test_launch_train_gemma_smoke_on_cpu(capsys, head_dim):
    """``launch.train --arch gemma-7b --smoke`` on the CPU, at the SMOKE
    head dim (32) and at gemma-7b's (256, ``--head-dim``)."""
    argv = ["--arch", "gemma-7b", "--smoke", "--device", "cpu", "--steps",
            "3", "--global-batch", "2", "--seq-len", "32"]
    if head_dim is not None:
        argv += ["--head-dim", str(head_dim)]
    hist = launch_train.main(argv)
    assert "steps=3" in capsys.readouterr().out
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)


def test_launch_train_with_checkpoints(tmp_path):
    hist = launch_train.main(["--smoke", "--device", "cpu", "--steps", "4",
                              "--global-batch", "2", "--seq-len", "16",
                              "--n-micro", "1", "--quantized-state",
                              "--ckpt-dir", str(tmp_path),
                              "--ckpt-every", "2"])
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert checkpoint.latest_step(str(tmp_path)) == 4


def test_launch_train_builds_the_flash_path():
    args = launch_train.parse(["--smoke", "--layers", "3", "--dtype",
                               "bfloat16"])
    cfg = launch_train.config(args)
    assert cfg.attn_impl == "flash" and cfg.remat
    assert cfg.n_layers == 3 and cfg.dtype == "bfloat16"


# --- the MoE family ------------------------------------------------------------------
MOE_ARCHS = ["mixtral-8x7b", "deepseek-v3-671b"]


def _moe_pair(arch, seed=0):
    """(reference model, its params, port model) of ``arch``'s SMOKE
    config (float32) with ``attn_impl="flash"``, the same weights."""
    rcfg = rregistry.smoke_config(arch, attn_impl="flash")
    pcfg = registry.smoke_config(arch, attn_impl="flash")
    rmodel = rlm.build(rcfg)
    params = rmodel.init(jax.random.PRNGKey(seed))
    model = lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, params),
                                 device="cpu").requires_grad_(True)
    return rmodel, params, model


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_grads_match_reference(arch):
    """ce, aux and every gradient leaf (the router's through the gates
    and the aux loss; the experts' through the gather dispatch and
    combine; the MLA weights) against the reference's, float32; the
    router's bias, which selection alone reads, gets a zero gradient on
    both sides."""
    rmodel, params, model = _moe_pair(arch, seed=4)
    toks = _tokens(B=2, S=24, vocab=model.cfg.vocab)
    with _ctx("flash"):
        (want, wm), wg = jax.value_and_grad(rmodel.loss, has_aux=True)(
            params, {"tokens": jnp.asarray(toks)})
    loss, metrics, grads = tl._grads(model, torch.from_numpy(toks))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(wm["aux"]),
                               rtol=1e-6)
    got = lm_params_to_numpy(model, grads)
    assert not np.asarray(wg["moe"]["moe"]["router_bias"]).any()
    assert not got["moe"]["moe"]["router_bias"].any()
    _close_tree(got, wg, GRAD_REL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_step_matches_reference(arch):
    """One AdamW step (float32 moments) of make_train_fn against the
    reference's: loss, aux in the step's metrics, grad norm, lr, and the
    parameters after it (as in test_int8_moment_step_matches_reference)."""
    rmodel, params, model = _moe_pair(arch, seed=5)
    kw = dict(lr=3e-3, warmup_steps=0)
    rc, pc = radamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    toks = _tokens(B=2, S=20, step=2, vocab=model.cfg.vocab)
    with _ctx("flash"):
        rp, _, rm = jax.jit(rloop.make_train_fn(rmodel, rc))(
            params, radamw.init(rc, params), {"tokens": jnp.asarray(toks)})
        _, wm = rmodel.loss(params, {"tokens": jnp.asarray(toks)})
    pp = tl.params_of(model)
    _, _, pm = tl.make_train_fn(model, pc)(
        pp, adamw.init(pc, pp), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["aux"]), float(wm["aux"]), rtol=1e-6)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-5)
    assert float(pm["lr"]) == float(rm["lr"])
    # Adam's first step is ill-conditioned where |g| is near eps (see
    # test_int8_moment_step_matches_reference): a few elements may differ
    # by up to a step, every other within 5e-5
    err = np.concatenate([np.abs(a - np.asarray(b)).ravel() for a, b in zip(
        jax.tree.leaves(lm_params_to_numpy(model)), jax.tree.leaves(rp))])
    assert err.max() <= 2 * kw["lr"] and np.mean(err > 5e-5) <= 1e-3


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_checkpoint_round_trip_bitwise(tmp_path, arch):
    """An MoE model's training state (bf16 experts, the float32 router
    and its bias, int8 moments) saved and restored bit for bit."""
    cfg = registry.smoke_config(arch, dtype="bfloat16")
    model = LM(cfg, device="cpu", seed=3, trainable=True)
    ocfg = adamw.AdamWConfig(quantized_state=True)
    step = tl.make_train_fn(model, ocfg)
    params = tl.params_of(model)
    params, opt, m = step(params, adamw.init(ocfg, params),
                          {"tokens": torch.from_numpy(
                              _tokens(B=2, S=12, vocab=cfg.vocab))})
    assert np.isfinite(float(m["aux"])) and float(m["aux"]) > 0
    state = {"params": params, "opt_state": opt}
    checkpoint.save(str(tmp_path), 1, state)
    _assert_same(checkpoint.restore(str(tmp_path), 1, state), state)
    assert params[f"blocks.{cfg.n_layers - 1}.moe.router"].dtype == \
        torch.float32


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("layers", [None, 2])
def test_launch_train_moe_smoke_on_cpu(capsys, arch, layers):
    """``launch.train --arch <moe> --smoke`` on the CPU, and with
    ``--layers``: every step's line shows the aux loss."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
            "--global-batch", "2", "--seq-len", "24"]
    if layers is not None:
        argv += ["--layers", str(layers)]
    hist = launch_train.main(argv)
    out = capsys.readouterr().out
    assert "steps=3" in out and "step 2 loss=" in out and " aux=" in out
    assert all(np.isfinite(h["loss"]) and h["aux"] > 0 for h in hist)


# --- the state-space family: zamba2-7b and rwkv6-1.6b -------------------------
SSM_ARCHS = ["zamba2-7b", "rwkv6-1.6b"]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_loss_and_grads_match_reference(arch):
    """The loss and every gradient leaf, float32, the constant-initialised
    leaves perturbed: zamba2's shared block's gradient is the sum over the
    groups that call it (the reference's ``extras["shared_attn"]``). The
    einsum path (the flash path's gradients are held by the step below)."""
    from test_torch_mamba2 import ssm_models
    _, _, rmodel, params, model = ssm_models(arch, attn_impl="einsum")
    model.requires_grad_(True)
    toks = _tokens(B=2, S=24, vocab=model.cfg.vocab)
    (want, _), wg = jax.jit(jax.value_and_grad(rmodel.loss, has_aux=True))(
        params, {"tokens": jnp.asarray(toks)})
    loss, _, grads = tl._grads(model, torch.from_numpy(toks))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    got = lm_params_to_numpy(model, grads)
    if arch == "zamba2-7b":
        assert np.abs(got["shared_attn"]["attn"]["wq"]).max() > 0
    _close_tree(got, wg, GRAD_REL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_train_step_matches_reference(arch):
    """One AdamW step (float32 moments, weight decay on) of make_train_fn
    against the reference's: loss, grad norm, lr and the parameters after
    it, zamba2's shared block (no decay on its (D,) norms) included."""
    from test_torch_mamba2 import ssm_models
    _, _, rmodel, params, model = ssm_models(arch)
    model.requires_grad_(True)
    kw = dict(lr=3e-3, warmup_steps=0, weight_decay=0.5)
    rc, pc = radamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    toks = _tokens(B=2, S=20, step=2, vocab=model.cfg.vocab)
    with _ctx("flash"):
        rp, _, rm = jax.jit(rloop.make_train_fn(rmodel, rc))(
            params, radamw.init(rc, params), {"tokens": jnp.asarray(toks)})
    pp = tl.params_of(model)
    _, _, pm = tl.make_train_fn(model, pc)(
        pp, adamw.init(pc, pp), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-5)
    assert float(pm["lr"]) == float(rm["lr"])
    got = lm_params_to_numpy(model)
    if arch == "zamba2-7b":
        np.testing.assert_allclose(got["shared_attn"]["ln1"],
                                   np.asarray(rp["shared_attn"]["ln1"]),
                                   atol=1e-6, rtol=0)
    # Adam's first step is ill-conditioned where |g| is near eps (see
    # test_int8_moment_step_matches_reference): a few elements may differ
    # by up to a step, every other within 5e-5
    err = np.concatenate([np.abs(a - np.asarray(b)).ravel() for a, b in zip(
        jax.tree.leaves(got), jax.tree.leaves(rp))])
    assert err.max() <= 2 * kw["lr"] and np.mean(err > 5e-5) <= 1e-3


@pytest.mark.parametrize("arch,layers", [("zamba2-7b", None),
                                         ("zamba2-7b", 3),
                                         ("rwkv6-1.6b", None)])
def test_launch_train_ssm_smoke_on_cpu(capsys, arch, layers):
    """``launch.train --arch zamba2-7b|rwkv6-1.6b --smoke`` on the CPU;
    zamba2 at ``--layers 3`` is one group of 2 and a 1-block tail."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
            "--global-batch", "2", "--seq-len", "24"]
    if layers is not None:
        argv += ["--layers", str(layers)]
    hist = launch_train.main(argv)
    out = capsys.readouterr().out
    assert "steps=3" in out and "step 2 loss=" in out
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    if layers == 3:
        r = launch_train.build(launch_train.parse(argv))
        assert [(s.kind, s.n_blocks) for s in r.model.segments] == [
            ("mamba_group", 1), ("mamba", 1)]
