"""whisper-base in the port (``enc`` / ``dec`` segments, cross-attention)
against the reference (``repro.models``), on the same weights and inputs.

Weights are the reference's own init, carried across by
``convert.lm_params_from_numpy``; the stub frontend's frame embeddings are
``normal * 0.1`` from a seeded numpy generator, float32 (B, n_audio_frames,
d_model), as tests/test_archs.py makes them. Comparisons with
``attn_impl="flash"`` trace the reference under a 1x1 ("data", "model")
mesh, where its encoder and decoder prefill run the Pallas kernel in
interpret mode (the encoder with ``causal=False``); the port's run K5's
plain version on the CPU. Cross-attention takes ``_sdpa`` on both sides.

Tolerances: layers f32 2e-5, bf16 2e-2; logits f32 1e-5, bf16 5e-2;
gradients f32 within 2e-5 of each leaf's largest |g|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import registry as rregistry
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro.train import loop as rloop
from repro_torch.configs import registry
from repro_torch.convert import (lm_params_from_numpy, lm_params_to_numpy,
                                 tensor_from_numpy)
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as launch_train
from repro_torch.models import layers
from repro_torch.models.lm import LM, cross_inputs, sinusoid
from repro_torch.serve.engine import Engine, Request
from repro_torch.train import loop as tl

ARCH = "whisper-base"
LAYER_TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}
LOGIT_ATOL = {"float32": 1e-5, "bfloat16": 5e-2}
GRAD_REL = 2e-5


def _mesh():
    return jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"),
                                      **compat.axis_types_kwarg(2)))


def _ctx(attn_impl):
    import contextlib
    return _mesh() if attn_impl == "flash" else contextlib.nullcontext()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(dtype="float32", attn_impl="flash"):
    return (rregistry.smoke_config(ARCH, dtype=dtype, attn_impl=attn_impl),
            registry.smoke_config(ARCH, dtype=dtype, attn_impl=attn_impl))


def _frames(cfg, b, seed):
    """The stub frontend's frame embeddings: normal * 0.1, float32."""
    return (np.random.default_rng(seed).normal(
        size=(b, cfg.n_audio_frames, cfg.d_model)) * 0.1).astype(np.float32)


def _models(rcfg, pcfg, seed=0):
    model = rlm.build(rcfg)
    params = model.init(jax.random.PRNGKey(seed))
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


# --- layers ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
@pytest.mark.parametrize("d_kv_in", [None, 48])
def test_cross_attention_matches_reference(dtype, attn_impl, d_kv_in):
    """attention(p, cfg, x, kv_src=...) against the reference's: k and v
    from the source (of another width where ``d_kv_in`` says so), no rope,
    every key attended, under either attn_impl (neither takes the
    kernel)."""
    rcfg, pcfg = _cfgs(dtype, attn_impl)
    p = rlayers.attn_init(jax.random.PRNGKey(4), rcfg, d_kv_in=d_kv_in)
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in p.items()}
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        layers.attn_shapes(pcfg, d_kv_in)
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 7, rcfg.d_model)) * 0.5).astype(np.float32)
    src = rng.normal(size=(2, 11, d_kv_in or rcfg.d_model)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    with _ctx(attn_impl):
        want, _ = rlayers.attention(p, rcfg, jnp.asarray(x).astype(jdt),
                                    kv_src=jnp.asarray(src).astype(jdt),
                                    use_rope=False)
    tdt = getattr(torch, dtype)
    got, cache = layers.attention(tp, pcfg, torch.from_numpy(x).to(tdt),
                                  kv_src=torch.from_numpy(src).to(tdt),
                                  use_rope=False)
    assert cache is None and got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL[dtype])


def test_cross_attention_takes_no_cache_and_no_kernel(monkeypatch):
    """Cross-attention never reaches K5's binding, and refuses a cache."""
    from repro_torch.kernels import flash_cuda
    calls = []
    monkeypatch.setattr(flash_cuda, "flash_fwd",
                        lambda *a, **k: calls.append(a) or (None, None))
    _, pcfg = _cfgs()
    p = layers.attn_init(torch.Generator().manual_seed(0), pcfg)
    x, src = torch.zeros(1, 3, pcfg.d_model), torch.ones(1, 5, pcfg.d_model)
    out, _ = layers.attention(p, pcfg, x, kv_src=src)
    assert out.shape == x.shape and not calls
    with pytest.raises(ValueError, match="no cache"):
        layers.attention(p, pcfg, x, kv_src=src, cache={"len": 0})


@pytest.mark.parametrize("start,n", [(0, 32), (440, 8), (65530, 6)])
def test_sinusoid_rows_match_reference_table(start, n):
    """Rows of the port's sinusoid equal the reference's table there."""
    d = 512
    want = np.asarray(rlm._sinusoid(65536, d))[start:start + n]
    got = sinusoid(torch.arange(start, start + n), d).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


# --- the model -------------------------------------------------------------------
def test_segments_and_cache_layout_match_reference():
    rcfg, pcfg = _cfgs()
    model = LM(pcfg, device="cpu", seed=0)
    assert [(s.name, s.kind, s.n_blocks) for s in model.segments] == [
        (s.name, s.kind, s.n_blocks) for s in rlm.segments_for(rcfg)]
    assert [b.kind for b in model.blocks] == ["enc"] * 2 + ["dec"] * 2
    want = jax.tree.map(lambda a: tuple(a.shape),
                        rlm.build(rcfg).init_cache(3, 20))
    got = model.init_cache(3, 20)
    assert got.pop("len") == 0 and want.pop("len") == ()
    assert jax.tree.map(lambda t: tuple(t.shape), got) == want
    assert set(got) == {"dec", "enc_out"}
    assert cross_inputs(pcfg) == {"frames": (32, 64)}


def _run_both(rcfg, pcfg, tokens, frames, max_len, steps, seed=0):
    """Prefill (with ``frames``, or without where it is None) and ``steps``
    greedy decode steps on both models, the reference's tokens fed to both;
    yields (what, reference logits, port logits), then checks the caches."""
    model, params, port = _models(rcfg, pcfg, seed)
    batch = {"tokens": tokens}
    if frames is not None:
        batch["frames"] = frames
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
    assert set(pc) == set(rc)
    np.testing.assert_allclose(_np(pc["enc_out"]), _np(rc["enc_out"]),
                               **LAYER_TOL[rcfg.dtype])
    for leaf in ("k", "v"):
        np.testing.assert_allclose(_np(pc["dec"][leaf]), _np(rc["dec"][leaf]),
                                   atol=LOGIT_ATOL[rcfg.dtype])
    assert pc["len"] == int(rc["len"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["flash", "einsum"])
def test_prefill_decode_logits_match_reference(dtype, attn_impl):
    """SMOKE prefill with frames, then 3 decode steps re-reading the
    cache's encoder output: logits, and the cache at the end."""
    rcfg, pcfg = _cfgs(dtype, attn_impl)
    tokens = np.random.default_rng(0).integers(
        0, rcfg.vocab, (2, 11)).astype(np.int32)
    for what, want, got in _run_both(rcfg, pcfg, tokens, _frames(rcfg, 2, 1),
                                     16, 3):
        assert got.dtype == torch.float32 and got.shape == (2, rcfg.vocab)
        np.testing.assert_allclose(_np(got), _np(want),
                                   atol=LOGIT_ATOL[dtype], rtol=0,
                                   err_msg=what)


@pytest.mark.parametrize("attn_impl", ["flash", "einsum"])
def test_prefill_without_frames_attends_to_zeros_as_reference(attn_impl):
    """A prefill whose batch has no frames cross-attends to the zeros of
    init_cache's enc_out (reference lm.py:405-409), and decode after it."""
    rcfg, pcfg = _cfgs("float32", attn_impl)
    tokens = np.random.default_rng(2).integers(
        0, rcfg.vocab, (2, 9)).astype(np.int32)
    for what, want, got in _run_both(rcfg, pcfg, tokens, None, 12, 2,
                                     seed=3):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0,
                                   err_msg=what)


def test_encoder_sees_every_frame_and_decoder_every_token():
    """The encoder is bidirectional and reaches the logits through the
    cross-attention: changing the last frame moves the first decode
    position's logits; changing a later token does not move an earlier
    position's (the decoder stays causal)."""
    _, pcfg = _cfgs()
    model = LM(pcfg, device="cpu", seed=0)
    toks = np.random.default_rng(4).integers(0, pcfg.vocab, (1, 8))
    frames = _frames(pcfg, 1, 5)
    moved = frames.copy()
    moved[:, -1] += 1.0
    with torch.no_grad():
        h = model.hidden({"tokens": toks, "frames": frames})[0]
        h_frames = model.hidden({"tokens": toks, "frames": moved})[0]
        later = toks.copy()
        later[0, -1] = (later[0, -1] + 1) % pcfg.vocab
        h_later = model.hidden({"tokens": later, "frames": frames})[0]
    assert float((h_frames[:, 0] - h[:, 0]).abs().max()) > 1e-3
    torch.testing.assert_close(h_later[:, :-1], h[:, :-1], rtol=0, atol=0)


@pytest.mark.parametrize("attn_impl", ["flash", "einsum"])
def test_loss_and_grads_match_reference(attn_impl):
    """The loss with frames and every gradient leaf of one step (the
    encoder's through the cross-attention; the shared final_ln through the
    encoder and the unembedding), float32."""
    rcfg, pcfg = _cfgs("float32", attn_impl)
    rmodel, params, port = _models(rcfg, pcfg, seed=1)
    port.requires_grad_(True)
    toks = np.random.default_rng(6).integers(
        0, rcfg.vocab, (2, 13)).astype(np.int32)
    batch = {"tokens": toks, "frames": _frames(rcfg, 2, 7)}
    with _ctx(attn_impl):
        (want, _), wg = jax.value_and_grad(rmodel.loss, has_aux=True)(
            params, jax.tree.map(jnp.asarray, batch))
    loss, _, grads = tl._grads(port, batch)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    got = lm_params_to_numpy(port, grads)
    assert np.abs(got["enc"]["attn"]["wq"]).max() > 0
    _close_tree(got, wg, GRAD_REL)


def test_module_methods_reach_every_parameter():
    """nn.Module's own methods (``float``, ``to``) reach every parameter
    of every block: a bf16 model upcast in place serves in float32."""
    _, pcfg = _cfgs("bfloat16")
    model = LM(pcfg, device="cpu", seed=0).float().to("cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert len(list(model.parameters())) == len(model.decays())


def test_loss_without_frames_raises():
    _, pcfg = _cfgs()
    model = LM(pcfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="'frames'"):
        model.loss(np.zeros((1, 5), np.int32))


def test_decays_follow_reference_ndim_rule():
    """A leaf decays where the reference's stacked leaf has ndim >= 2: every
    block leaf of both segments (norms (n, D)), the embedding and the
    head; not the shared final_ln."""
    rcfg, pcfg = _cfgs()
    model = LM(pcfg, device="cpu", seed=0)
    decays = model.decays()
    got = lm_params_to_numpy(model, {n: torch.full(p.shape, float(decays[n]))
                                     for n, p in model.named_parameters()})
    want = jax.tree.map(lambda a: np.full(a.shape, float(a.ndim >= 2)),
                        rlm.build(rcfg).init(jax.random.PRNGKey(0)))
    jax.tree.map(np.testing.assert_array_equal, got, want)
    assert decays["blocks.2.lnx"] and not decays["final_ln"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trips_bitwise(dtype):
    """The enc / dec tree (the dec blocks' xattn and lnx) converts into the
    port and back bit for bit; a tree without the dec blocks' lnx is
    refused."""
    rcfg, pcfg = _cfgs(dtype)
    tree = jax.tree.map(np.asarray,
                        rlm.build(rcfg).init(jax.random.PRNGKey(6)))
    model = lm_params_from_numpy(pcfg, tree, device="cpu")
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
    with pytest.raises(KeyError, match="dec"):
        bad = dict(tree, dec={k: v for k, v in tree["dec"].items()
                              if k != "lnx"})
        lm_params_from_numpy(pcfg, bad, device="cpu")


def test_engine_extra_inputs_match_reference_engine():
    """Engine(extra_inputs={"frames": ...}) against the reference's engine:
    the frames join every wave's prefill, waves with mixed prompt lengths
    and a dummy slot; greedy tokens equal."""
    rcfg, pcfg = _cfgs()
    rmodel, params, port = _models(rcfg, pcfg, seed=2)
    frames = _frames(rcfg, 4, 8)
    rng = np.random.default_rng(9)
    lengths, max_new = [3, 9, 5, 12, 2, 7], [6, 4, 8, 6, 5, 3]
    prompts = [rng.integers(1, rcfg.vocab, n).astype(np.int32)
               for n in lengths]
    with _mesh():
        want = RefEngine(rmodel, params, batch_slots=4, max_len=24,
                         extra_inputs={"frames": jnp.asarray(frames)}).serve(
            [RefRequest(i, p, max_new_tokens=n, eos_id=-1)
             for i, (p, n) in enumerate(zip(prompts, max_new))])
    got = Engine(port, batch_slots=4, max_len=24,
                 extra_inputs={"frames": frames}).serve(
        [Request(i, p, max_new_tokens=n, eos_id=-1)
         for i, (p, n) in enumerate(zip(prompts, max_new))])
    assert [r.uid for r in got] == [r.uid for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))


def test_microbatched_train_step_with_frames_matches_reference():
    """microbatch_grads with n_micro 2 splits tokens and frames on axis 0
    alike: the loss and every gradient leaf against the reference's scan;
    then make_train_fn's step equals one AdamW update of them."""
    from repro.optim import adamw as radamw
    from repro_torch.optim import adamw
    rcfg, pcfg = _cfgs()
    rmodel, params, port = _models(rcfg, pcfg, seed=4)
    port.requires_grad_(True)
    toks = np.random.default_rng(10).integers(
        0, rcfg.vocab, (4, 12)).astype(np.int32)
    batch = {"tokens": toks, "frames": _frames(rcfg, 4, 11)}
    with _mesh():
        want_l, _, want_g = rloop.microbatch_grads(
            rmodel, params, jax.tree.map(jnp.asarray, batch), 2)
    loss, metrics, grads = tl.microbatch_grads(
        port, tl.params_of(port),
        {k: torch.from_numpy(v) for k, v in batch.items()}, 2)
    assert metrics == {}
    np.testing.assert_allclose(float(loss), float(want_l), rtol=1e-5)
    _close_tree(lm_params_to_numpy(port, grads), want_g, GRAD_REL)
    kw = dict(lr=3e-3, warmup_steps=0)
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
    err = np.concatenate([np.abs(a - np.asarray(b)).ravel() for a, b in zip(
        jax.tree.leaves(lm_params_to_numpy(port)), jax.tree.leaves(rp))])
    assert err.max() <= 2 * kw["lr"] and np.mean(err > 5e-5) <= 1e-3


# --- launchers -------------------------------------------------------------------
def test_launcher_serves_on_cpu(capsys):
    """``launch.serve --arch whisper-base --smoke``: no frames, as the
    reference's CLI, so the decoder cross-attends to zeros."""
    res = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--requests", "3", "--slots", "2", "--max-new",
                          "4"])
    vocab = registry.smoke_config(ARCH).vocab
    assert sorted(r.uid for r in res) == [0, 1, 2]
    assert all(len(r.tokens) == 4 and bool(((r.tokens >= 0)
                                            & (r.tokens < vocab)).all())
               for r in res)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_launch_train_needs_frames():
    """launch.train has no frames to give (the reference's CLI fails with
    KeyError: 'frames'): its entry point raises a ValueError naming them;
    ``build(args, extra_inputs=...)`` trains."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
            "--global-batch", "4", "--seq-len", "16"]
    with pytest.raises(ValueError, match="'frames'"):
        launch_train.main(argv)
    args = launch_train.parse(argv)
    cfg = launch_train.config(args)
    r = launch_train.build(args, extra_inputs=lambda s: {
        "frames": _frames(cfg, 4, 100 + s)})
    hist = launch_train.train_steps(r, 0, 2)
    assert r.data_fn(0)["frames"].shape == (4, 32, 64)
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[1]["loss"] < hist[0]["loss"]
