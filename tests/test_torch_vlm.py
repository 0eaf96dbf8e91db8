"""llama-3.2-vision-90b in the port (``vlm_group`` segments: dense blocks,
then tanh-gated cross-attention to vision tokens) against the reference
(``repro.models``), on the same weights and inputs.

Weights are the reference's own init, carried across by
``convert.lm_params_from_numpy``, with one change made to the reference's
tree before it is converted: the gates. The reference initialises
``x_gate`` and ``xffn_gate`` to 0, where tanh(0) = 0 erases the
cross-attention branch and a wrong one would pass unseen, so every
comparison draws them non-zero (``_gated``: uniform in [0.3, 0.9] from a
seeded numpy generator, one pair a group) in both packages. Vision tokens
are ``normal * 0.1`` float32 (B, n_vision_tokens, d_model) from a seeded
numpy generator, as tests/test_archs.py makes them. Comparisons with
``attn_impl="flash"`` trace the reference under a 1x1 ("data", "model")
mesh, where its dense blocks' prefill runs the Pallas kernel in interpret
mode.

Tolerances: logits f32 1e-5, bf16 5e-2; gradients f32 within 2e-5 of
each leaf's largest |g|.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import registry as rregistry
from repro.models import lm as rlm
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro.train import loop as rloop
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import LM, VlmGroup, cross_inputs
from repro_torch.serve.engine import Engine, Request
from repro_torch.train import loop as tl

ARCH = "llama-3.2-vision-90b"
LOGIT_ATOL = {"float32": 1e-5, "bfloat16": 5e-2}
GRAD_REL = 2e-5


def _mesh():
    return jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"),
                                      **compat.axis_types_kwarg(2)))


def _ctx(attn_impl):
    return _mesh() if attn_impl == "flash" else contextlib.nullcontext()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(dtype="float32", attn_impl="flash", **kw):
    return (rregistry.smoke_config(ARCH, dtype=dtype, attn_impl=attn_impl,
                                   **kw),
            registry.smoke_config(ARCH, dtype=dtype, attn_impl=attn_impl,
                                  **kw))


def _vision(cfg, b, seed):
    """The stub vision tower's tokens: normal * 0.1, float32."""
    return (np.random.default_rng(seed).normal(
        size=(b, cfg.n_vision_tokens, cfg.d_model)) * 0.1).astype(np.float32)


def _gated(params, seed=0):
    """The reference's params with the gates drawn non-zero: x_gate and
    xffn_gate of every group uniform in [0.3, 0.9] (float32, (n_groups,)),
    from numpy's generator at ``seed``."""
    rng = np.random.default_rng(seed)
    vlm = dict(params["vlm"])
    for gate in ("x_gate", "xffn_gate"):
        vlm[gate] = jnp.asarray(rng.uniform(0.3, 0.9, vlm[gate].shape)
                                .astype(np.float32))
    return dict(params, vlm=vlm)


def _models(rcfg, pcfg, seed=0, gated=True):
    model = rlm.build(rcfg)
    params = model.init(jax.random.PRNGKey(seed))
    if gated:
        params = _gated(params, seed)
    port = lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    return model, params, port


def _close_tree(got, want, rel):
    def one(a, b):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rel * max(float(np.abs(b).max()),
                                                  1e-30))
    jax.tree.map(one, got, want)


def test_segments_and_cache_layout_match_reference():
    """One ``vlm`` segment of n_layers / k groups, each k dense blocks and a
    cross block; the cache's ``selfs`` stacked (n_groups, k, ...) and the
    vision tokens beside it."""
    rcfg, pcfg = _cfgs()
    model = LM(pcfg, device="cpu", seed=0)
    assert [(s.name, s.kind, s.n_blocks) for s in model.segments] == [
        (s.name, s.kind, s.n_blocks) for s in rlm.segments_for(rcfg)] == [
        ("vlm", "vlm_group", 2)]
    assert all(isinstance(b, VlmGroup) and len(b.selfs) == 2
               for b in model.blocks)
    want = jax.tree.map(lambda a: tuple(a.shape),
                        rlm.build(rcfg).init_cache(3, 20))
    got = model.init_cache(3, 20)
    assert got.pop("len") == 0 and want.pop("len") == ()
    assert jax.tree.map(lambda t: tuple(t.shape), got) == want
    assert got["vlm"]["selfs"]["k"].shape == (2, 2, 3, 20, 2, 16)
    assert cross_inputs(pcfg) == {"vision": (16, 64)}
    assert model.blocks[0].x_gate.shape == () and \
        model.blocks[0].x_gate.dtype == torch.float32


def test_depth_must_be_a_multiple_of_the_group():
    """The reference asserts n_layers % cross_attn_every == 0; the port
    raises a ValueError, and launch.train's --layers with it."""
    _, pcfg = _cfgs(n_layers=3)
    with pytest.raises(ValueError, match="cross_attn_every"):
        LM(pcfg, device="cpu")
    with pytest.raises(ValueError, match="cross_attn_every"):
        launch_train.config(launch_train.parse(
            ["--arch", ARCH, "--smoke", "--layers", "3"]))


def _run_both(rcfg, pcfg, tokens, vision, max_len, steps, seed=0):
    """Prefill (with ``vision``, or without where it is None) and ``steps``
    greedy decode steps on both models, the reference's tokens fed to
    both; yields (what, reference logits, port logits), then checks the
    caches."""
    model, params, port = _models(rcfg, pcfg, seed)
    batch = {"tokens": tokens}
    if vision is not None:
        batch["vision"] = vision
    with _ctx(rcfg.attn_impl):
        rl, rc = model.prefill(params, jax.tree.map(jnp.asarray, batch),
                               max_len)
        pl, pc = port.prefill(batch, max_len)
        yield "prefill", rl, pl
        for step in range(steps):
            tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
            rl, rc = model.decode(params, rc, jnp.asarray(tok))
            pl, pc = port.decode(pc, torch.from_numpy(tok))
            yield f"decode {step}", rl, pl
    assert set(pc) == set(rc) == {"len", "vlm", "vision"}
    np.testing.assert_array_equal(_np(pc["vision"]), _np(rc["vision"]))
    for leaf in ("k", "v"):
        np.testing.assert_allclose(_np(pc["vlm"]["selfs"][leaf]),
                                   _np(rc["vlm"]["selfs"][leaf]),
                                   atol=LOGIT_ATOL[rcfg.dtype])
    assert pc["len"] == int(rc["len"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["flash", "einsum"])
def test_prefill_decode_logits_match_reference(dtype, attn_impl):
    """SMOKE prefill with vision tokens and non-zero gates, then 3 decode
    steps re-reading the cache's vision tokens: logits and the cache."""
    rcfg, pcfg = _cfgs(dtype, attn_impl)
    tokens = np.random.default_rng(0).integers(
        0, rcfg.vocab, (2, 11)).astype(np.int32)
    for what, want, got in _run_both(rcfg, pcfg, tokens, _vision(rcfg, 2, 1),
                                     16, 3):
        assert got.dtype == torch.float32 and got.shape == (2, rcfg.vocab)
        np.testing.assert_allclose(_np(got), _np(want),
                                   atol=LOGIT_ATOL[dtype], rtol=0,
                                   err_msg=what)


@pytest.mark.parametrize("attn_impl", ["flash", "einsum"])
def test_prefill_without_vision_attends_to_zeros_as_reference(attn_impl):
    """A prefill whose batch has no vision tokens cross-attends to the
    zeros of init_cache's ``vision``, as the reference's."""
    rcfg, pcfg = _cfgs("float32", attn_impl)
    tokens = np.random.default_rng(2).integers(
        0, rcfg.vocab, (2, 9)).astype(np.int32)
    for what, want, got in _run_both(rcfg, pcfg, tokens, None, 12, 2,
                                     seed=3):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0,
                                   err_msg=what)


@pytest.mark.parametrize("gate,moves", [(0.0, False), (0.5, True)])
def test_gates_open_and_close_the_cross_attention(gate, moves):
    """At gates 0 other vision tokens leave the logits bit for bit as they
    were (tanh(0) * h is 0); at 0.5 they move them."""
    _, pcfg = _cfgs()
    model = LM(pcfg, device="cpu", seed=0)
    with torch.no_grad():
        for blk in model.blocks:
            blk.x_gate.fill_(gate)
            blk.xffn_gate.fill_(gate)
    toks = np.random.default_rng(4).integers(0, pcfg.vocab, (2, 7))
    a, _ = model.prefill({"tokens": toks, "vision": _vision(pcfg, 2, 5)}, 8)
    b, _ = model.prefill({"tokens": toks, "vision": _vision(pcfg, 2, 6)}, 8)
    diff = float((a - b).abs().max())
    assert (diff > 1e-3) if moves else (diff == 0.0)


@pytest.mark.parametrize("attn_impl", ["flash", "einsum"])
def test_loss_and_grads_match_reference(attn_impl):
    """The loss with vision tokens and every gradient leaf of one step, the
    gates' included, float32."""
    rcfg, pcfg = _cfgs("float32", attn_impl)
    rmodel, params, port = _models(rcfg, pcfg, seed=1)
    port.requires_grad_(True)
    toks = np.random.default_rng(6).integers(
        0, rcfg.vocab, (2, 13)).astype(np.int32)
    batch = {"tokens": toks, "vision": _vision(rcfg, 2, 7)}
    with _ctx(attn_impl):
        (want, _), wg = jax.value_and_grad(rmodel.loss, has_aux=True)(
            params, jax.tree.map(jnp.asarray, batch))
    loss, _, grads = tl._grads(port, batch)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    got = lm_params_to_numpy(port, grads)
    assert got["vlm"]["x_gate"].shape == (2,)
    assert np.abs(got["vlm"]["x_gate"]).min() > 0
    _close_tree(got, wg, GRAD_REL)


def test_bf16_gate_product_is_float32_rounded_once():
    """x + (tanh(gate) * h).astype(x.dtype): in bf16 the product is taken in
    float32 and rounded once, as the reference's f32 gate promotes h (a
    0-d float32 tensor would not promote a bf16 one in torch). A group's
    output equals that composition of its own layers bit for bit, and
    differs from the bf16 product's; the bf16 logits agree with the
    reference's."""
    from repro_torch.models.layers import attention, ffn, rmsnorm
    rcfg, pcfg = _cfgs("bfloat16", "einsum")
    rmodel, params, port = _models(rcfg, pcfg, seed=5)
    toks = np.random.default_rng(8).integers(
        0, rcfg.vocab, (2, 6)).astype(np.int32)
    batch = {"tokens": toks, "vision": _vision(rcfg, 2, 9)}
    want, _ = rmodel.prefill(params, jax.tree.map(jnp.asarray, batch), 8)
    got, _ = port.prefill(batch, 8)
    np.testing.assert_allclose(_np(got), _np(want), atol=LOGIT_ATOL[
        "bfloat16"], rtol=0)
    blk, eps = port.blocks[0], pcfg.norm_eps
    x = torch.from_numpy(_vision(pcfg, 2, 10)[:, :6] * 40).to(torch.bfloat16)
    vision = torch.from_numpy(batch["vision"]).to(torch.bfloat16)
    pos = torch.arange(6)
    with torch.no_grad():
        out, _ = port._block(blk, x, pos, None, {"vision": vision})
        y = x
        for sub in blk.selfs:
            y, _ = port._block(sub, y, pos, None, {})

        def gated(bf16_product):
            z = y
            h, _ = attention(blk.xattn, pcfg, rmsnorm(z, blk.x_ln, eps),
                             kv_src=vision, use_rope=False)
            g = torch.tanh(blk.x_gate)
            z = z + (g * h if bf16_product else (g * h.float()).to(z.dtype))
            f = ffn(blk.xffn, pcfg, rmsnorm(z, blk.x_ln2, eps))
            g = torch.tanh(blk.xffn_gate)
            return z + (g * f if bf16_product else (g * f.float()).to(
                z.dtype))
        assert torch.equal(out, gated(False))
        assert not torch.equal(out, gated(True))


def test_module_methods_reach_every_parameter():
    """nn.Module's own methods (``float``, ``to``) reach every parameter
    of every block: a bf16 model upcast in place serves in float32."""
    _, pcfg = _cfgs("bfloat16")
    model = LM(pcfg, device="cpu", seed=0).float().to("cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert len(list(model.parameters())) == len(model.decays())


def test_loss_without_vision_raises():
    _, pcfg = _cfgs()
    model = LM(pcfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="'vision'"):
        model.loss(np.zeros((1, 5), np.int32))


def test_decays_follow_reference_ndim_rule():
    """A leaf decays where the reference's stacked leaf has ndim >= 2: the
    selfs' norms (n_groups, k, D) and x_ln (n_groups, D) decay, the gates
    (n_groups,) do not, nor does final_ln."""
    rcfg, pcfg = _cfgs()
    model = LM(pcfg, device="cpu", seed=0)
    decays = model.decays()
    got = lm_params_to_numpy(model, {n: torch.full(p.shape, float(decays[n]))
                                     for n, p in model.named_parameters()})
    want = jax.tree.map(lambda a: np.full(a.shape, float(a.ndim >= 2)),
                        rlm.build(rcfg).init(jax.random.PRNGKey(0)))
    jax.tree.map(np.testing.assert_array_equal, got, want)
    assert not decays["blocks.0.x_gate"] and not decays["blocks.1.xffn_gate"]
    assert decays["blocks.0.x_ln"] and decays["blocks.0.selfs.1.ln2"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trips_bitwise(dtype):
    """The vlm tree — selfs stacked (n_groups, k, ...), the float32 scalar
    gates stacked (n_groups,) — converts into the port and back bit for
    bit; a tree whose selfs are stacked (n_groups,) only is refused."""
    rcfg, pcfg = _cfgs(dtype)
    tree = jax.tree.map(np.asarray, _gated(
        rlm.build(rcfg).init(jax.random.PRNGKey(6)), 6))
    model = lm_params_from_numpy(pcfg, tree, device="cpu")
    assert float(model.blocks[1].xffn_gate) == float(tree["vlm"]
                                                      ["xffn_gate"][1])
    back = lm_params_to_numpy(model)

    def same(a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        if b.dtype == jnp.bfloat16:
            assert a.dtype == np.float32
            a = a.astype(b.dtype)
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(same, back, tree)
    bad = dict(tree, vlm=dict(tree["vlm"], selfs=jax.tree.map(
        lambda a: a[:, 0], tree["vlm"]["selfs"])))
    with pytest.raises(ValueError, match="selfs"):
        lm_params_from_numpy(pcfg, bad, device="cpu")


def test_engine_extra_inputs_match_reference_engine():
    """Engine(extra_inputs={"vision": ...}) against the reference's engine
    with gates non-zero: waves with mixed prompt lengths and a dummy slot;
    greedy tokens equal."""
    rcfg, pcfg = _cfgs()
    rmodel, params, port = _models(rcfg, pcfg, seed=2)
    vision = _vision(rcfg, 4, 8)
    rng = np.random.default_rng(9)
    lengths, max_new = [3, 9, 5, 12, 2, 7], [6, 4, 8, 6, 5, 3]
    prompts = [rng.integers(1, rcfg.vocab, n).astype(np.int32)
               for n in lengths]
    with _mesh():
        want = RefEngine(rmodel, params, batch_slots=4, max_len=24,
                         extra_inputs={"vision": jnp.asarray(vision)}).serve(
            [RefRequest(i, p, max_new_tokens=n, eos_id=-1)
             for i, (p, n) in enumerate(zip(prompts, max_new))])
    got = Engine(port, batch_slots=4, max_len=24,
                 extra_inputs={"vision": vision}).serve(
        [Request(i, p, max_new_tokens=n, eos_id=-1)
         for i, (p, n) in enumerate(zip(prompts, max_new))])
    assert [r.uid for r in got] == [r.uid for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))


def test_microbatched_train_step_with_vision_matches_reference():
    """microbatch_grads with n_micro 2 splits tokens and vision on axis 0
    alike: the loss and every gradient leaf against the reference's scan;
    then make_train_fn's AdamW step, where the gates take no weight decay
    (the reference's (n_groups,) leaves)."""
    from repro.optim import adamw as radamw
    from repro_torch.optim import adamw
    rcfg, pcfg = _cfgs()
    rmodel, params, port = _models(rcfg, pcfg, seed=4)
    port.requires_grad_(True)
    toks = np.random.default_rng(10).integers(
        0, rcfg.vocab, (4, 12)).astype(np.int32)
    batch = {"tokens": toks, "vision": _vision(rcfg, 4, 11)}
    with _mesh():
        want_l, _, want_g = rloop.microbatch_grads(
            rmodel, params, jax.tree.map(jnp.asarray, batch), 2)
    loss, _, grads = tl.microbatch_grads(
        port, tl.params_of(port),
        {k: torch.from_numpy(v) for k, v in batch.items()}, 2)
    np.testing.assert_allclose(float(loss), float(want_l), rtol=1e-5)
    _close_tree(lm_params_to_numpy(port, grads), want_g, GRAD_REL)
    kw = dict(lr=3e-3, warmup_steps=0, weight_decay=0.5)
    rc, pc = radamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    with _mesh():
        rp, _, rm = jax.jit(rloop.make_train_fn(rmodel, rc, n_micro=2))(
            params, radamw.init(rc, params), jax.tree.map(jnp.asarray, batch))
    pp = tl.params_of(port)
    _, _, pm = tl.make_train_fn(port, pc, n_micro=2)(
        pp, adamw.init(pc, pp), batch)
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-5)
    got = lm_params_to_numpy(port)
    np.testing.assert_allclose(got["vlm"]["x_gate"],
                               np.asarray(rp["vlm"]["x_gate"]), atol=1e-6,
                               rtol=0)
    err = np.concatenate([np.abs(a - np.asarray(b)).ravel() for a, b in zip(
        jax.tree.leaves(got), jax.tree.leaves(rp))])
    assert err.max() <= 2 * kw["lr"] and np.mean(err > 5e-5) <= 1e-3


# --- launchers -------------------------------------------------------------------
def test_launcher_serves_on_cpu(capsys):
    """``launch.serve --arch llama-3.2-vision-90b --smoke``: no vision
    tokens, as the reference's CLI, so the cross-attention reads zeros."""
    res = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--requests", "3", "--slots", "2", "--max-new",
                          "4"])
    vocab = registry.smoke_config(ARCH).vocab
    assert sorted(r.uid for r in res) == [0, 1, 2]
    assert all(len(r.tokens) == 4 and bool(((r.tokens >= 0)
                                            & (r.tokens < vocab)).all())
               for r in res)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_launch_train_needs_vision():
    """launch.train has no vision tokens to give: its entry point raises a
    ValueError naming them; ``build(args, extra_inputs=...)`` trains, at a
    depth of whole groups (``--layers 2``)."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
            "--global-batch", "4", "--seq-len", "16", "--layers", "2"]
    with pytest.raises(ValueError, match="'vision'"):
        launch_train.main(argv)
    args = launch_train.parse(argv)
    cfg = launch_train.config(args)
    r = launch_train.build(args, extra_inputs=lambda s: {
        "vision": _vision(cfg, 4, 100 + s)})
    assert len(r.model.blocks) == 1
    hist = launch_train.train_steps(r, 0, 2)
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[1]["loss"] < hist[0]["loss"]
