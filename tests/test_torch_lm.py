"""The port's dense layers and LM (``repro_torch.models``) against the
reference (``repro.models``), on the same weights and inputs.

Weights are the reference's own init, carried across as numpy by
``convert.lm_params_from_numpy`` / ``tensor_from_numpy``; inputs are made
with numpy from a seed. The reference's flash path needs an ambient mesh
with a ``model`` axis (layers.py:89), so every comparison that involves
``attn_impl="flash"`` traces the reference under a 1x1 ("data", "model")
mesh; there its prefill runs the Pallas kernel in interpret mode.

Tolerances: layers f32 2e-5, bf16 2e-2; LM logits f32 1e-5, bf16 5e-2 —
in bf16 both sides round at the same points, and a one-ulp flip in an
early layer carries through (JAX's own flash and einsum paths differ by
3.7e-2 at this size).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import registry as rregistry
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy, tensor_from_numpy
from repro_torch.models import layers
from repro_torch.models.lm import LM

LAYER_TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}
LOGIT_ATOL = {"float32": 1e-5, "bfloat16": 5e-2}


def mesh_1x1():
    return jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"),
                                      **compat.axis_types_kwarg(2)))


def _ctx(attn_impl):
    return mesh_1x1() if attn_impl == "flash" else contextlib.nullcontext()


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(dtype, attn_impl="flash", **kw):
    return (rregistry.smoke_config("llama3-8b", dtype=dtype,
                                   attn_impl=attn_impl, **kw),
            registry.smoke_config("llama3-8b", dtype=dtype,
                                  attn_impl=attn_impl, **kw))


def _gemma_cfgs(dtype, attn_impl="flash"):
    """gemma's SMOKE (2 layers, d_model 64, 4 heads, geglu, tied
    embeddings) at gemma-7b's head dim, 256: the flash path at D = 256."""
    over = dict(head_dim=256, dtype=dtype, attn_impl=attn_impl)
    return (rregistry.smoke_config("gemma-7b", **over),
            registry.smoke_config("gemma-7b", **over))


def _x(shape, dtype, seed=0, scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    a *= scale
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(
        getattr(torch, dtype))


# --- layers ------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    jx, tx = _x((3, 5, 64), dtype)
    g = np.random.default_rng(1).normal(size=64).astype(np.float32)
    want = rlayers.rmsnorm(jx, jnp.asarray(g), 1e-6)
    got = layers.rmsnorm(tx, torch.from_numpy(g), 1e-6)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_matches_reference(dtype, theta):
    jx, tx = _x((2, 12, 4, 32), dtype)
    pos = np.arange(7, 19, dtype=np.int32)
    want = rlayers.apply_rope(jx, jnp.asarray(pos), theta)
    got = layers.apply_rope(tx, torch.from_numpy(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL[dtype])
    np.testing.assert_allclose(
        layers.rope_freqs(32, theta).numpy(),
        np.asarray(rlayers.rope_freqs(32, theta)), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ffn_kind", ["swiglu", "geglu"])
def test_ffn_matches_reference(dtype, ffn_kind):
    rcfg, pcfg = _cfgs(dtype, ffn_kind=ffn_kind)
    p = rlayers.ffn_init(jax.random.PRNGKey(3), rcfg)
    jx, tx = _x((2, 6, rcfg.d_model), dtype)
    want = rlayers.ffn(p, rcfg, jx)
    got = layers.ffn({k: _t(v) for k, v in p.items()}, pcfg, tx)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_attention_without_cache_matches_reference(dtype, attn_impl):
    rcfg, pcfg = _cfgs(dtype, attn_impl)
    p = rlayers.attn_init(jax.random.PRNGKey(4), rcfg)
    jx, tx = _x((2, 9, rcfg.d_model), dtype, scale=0.5)
    with _ctx(attn_impl):
        want, _ = rlayers.attention(p, rcfg, jx)
    got, cache = layers.attention({k: _t(v) for k, v in p.items()}, pcfg, tx)
    assert cache is None
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_attention_with_cache_matches_reference(dtype, attn_impl):
    """Prefill S=7 into an empty (B, 16, Hkv, hd) cache, then two decode
    steps at positions 7 and 8: outputs and cache contents agree."""
    rcfg, pcfg = _cfgs(dtype, attn_impl)
    p = rlayers.attn_init(jax.random.PRNGKey(5), rcfg)
    tp = {k: _t(v) for k, v in p.items()}
    shape = (2, 16, rcfg.n_kv_heads, rcfg.hd)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rc = {"k": jnp.zeros(shape, jdt), "v": jnp.zeros(shape, jdt), "len": 0}
    pc = {"k": torch.zeros(shape, dtype=getattr(torch, dtype)),
          "v": torch.zeros(shape, dtype=getattr(torch, dtype)), "len": 0}
    jx, tx = _x((2, 7, rcfg.d_model), dtype, seed=6, scale=0.5)
    with _ctx(attn_impl):
        for step in range(3):
            if step:
                jx, tx = _x((2, 1, rcfg.d_model), dtype, seed=6 + step,
                            scale=0.5)
            n = tx.shape[1]
            pos = np.arange(pc["len"], pc["len"] + n)
            want, rc = rlayers.attention(p, rcfg, jx, positions=jnp.asarray(pos),
                                         cache=rc)
            got, pc = layers.attention(tp, pcfg, tx,
                                       positions=torch.from_numpy(pos),
                                       cache=pc)
            assert pc["len"] == int(rc["len"])
            np.testing.assert_allclose(_np(got), _np(want),
                                       **LAYER_TOL[dtype])
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(pc[key]), _np(rc[key]),
                                   **LAYER_TOL[dtype])


def test_sdpa_q_chunked_path_matches_unchunked(monkeypatch):
    """The q-chunked branch of ``_sdpa`` (S > _Q_CHUNK) equals the
    one-shot form."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.normal(size=(1, 32, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 32, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 32, 2, 16)).astype(np.float32))
    whole = layers._sdpa(q, k, v, causal=True, window=5)
    monkeypatch.setattr(layers, "_Q_CHUNK", 8)
    chunked = layers._sdpa(q, k, v, causal=True, window=5)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-6)


def test_cache_overflow_raises():
    """The reference's dynamic_update_slice clamps a write past the end of
    the cache onto its last entries; the port raises instead."""
    _, pcfg = _cfgs("float32")
    tp = layers.attn_init(torch.Generator().manual_seed(0), pcfg)
    shape = (1, 4, pcfg.n_kv_heads, pcfg.hd)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape), "len": 3}
    with pytest.raises(ValueError, match="cache of length 4"):
        layers.attention(tp, pcfg, torch.zeros(1, 2, pcfg.d_model),
                         positions=torch.arange(3, 5), cache=cache)


def test_decode_updates_cache_in_place():
    """The port writes k/v into the cache it is given (the reference
    returns a new one): decode hands back the same tensors, one longer."""
    _, pcfg = _cfgs("float32")
    model = LM(pcfg, device="cpu", seed=0)
    logits, cache = model.prefill(np.array([[3, 4, 5]]), 8)
    k_before = cache["dense"]["k"]
    _, after = model.decode(cache, torch.argmax(logits, -1))
    assert after["dense"]["k"] is k_before and after["len"] == 4
    assert bool(k_before[:, :, 3].abs().sum() > 0)


@pytest.mark.parametrize("arch", sorted(registry.ALIASES))
def test_every_registry_arch_builds(arch):
    """Every registry architecture builds at its SMOKE config, prefills
    and decodes one step on the CPU (the cross-attending ones attend to
    their cache's zeros): finite float32 logits of (B, vocab)."""
    cfg = registry.smoke_config(arch)
    model = LM(cfg, device="cpu", seed=0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 5))
    logits, cache = model.prefill(toks, 8)
    logits, cache = model.decode(cache, torch.argmax(logits, -1))
    assert logits.shape == (2, cfg.vocab) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all()) and cache["len"] == 6


# --- the LM --------------------------------------------------------------------
def _models(rcfg, pcfg, seed=0):
    model = rlm.build(rcfg)
    params = model.init(jax.random.PRNGKey(seed))
    port = lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    return model, params, port


def _run_both(rcfg, pcfg, tokens, max_len, steps):
    """Prefill + ``steps`` greedy decode steps on both, the reference's
    tokens fed to both; yields (what, reference logits, port logits)."""
    model, params, port = _models(rcfg, pcfg)
    with _ctx(rcfg.attn_impl):
        rl, rc = model.prefill(params, {"tokens": jnp.asarray(tokens)},
                               max_len)
        pl, pc = port.prefill(tokens, max_len)
        yield "prefill", rl, pl
        for step in range(steps):
            tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
            rl, rc = model.decode(params, rc, jnp.asarray(tok))
            pl, pc = port.decode(pc, torch.from_numpy(tok))
            yield f"decode {step}", rl, pl
    assert set(pc) == set(rc)
    for seg in set(rc) - {"len"}:
        assert set(pc[seg]) == set(rc[seg])
        for leaf in rc[seg]:
            np.testing.assert_allclose(_np(pc[seg][leaf]),
                                       _np(rc[seg][leaf]),
                                       atol=LOGIT_ATOL[rcfg.dtype])
    assert pc["len"] == int(rc["len"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["flash", "einsum"])
def test_lm_prefill_decode_logits_match_reference(dtype, attn_impl):
    rcfg, pcfg = _cfgs(dtype, attn_impl)
    tokens = np.random.default_rng(0).integers(
        0, rcfg.vocab, (2, 11)).astype(np.int32)
    for what, want, got in _run_both(rcfg, pcfg, tokens, 16, 3):
        assert got.dtype == torch.float32 and got.shape == (2, rcfg.vocab)
        np.testing.assert_allclose(_np(got), _np(want),
                                   atol=LOGIT_ATOL[dtype], rtol=0,
                                   err_msg=what)


def test_lm_prefill_runs_pallas_under_the_mesh():
    """The reference comparison above really is against its flash kernel:
    under the 1x1 mesh its prefill jaxpr holds a pallas_call."""
    rcfg, _ = _cfgs("float32")
    model = rlm.build(rcfg)
    params = model.init(jax.random.PRNGKey(0))
    toks = jnp.zeros((1, 8), jnp.int32)
    with mesh_1x1():
        jaxpr = jax.make_jaxpr(
            lambda p, t: model.prefill(p, {"tokens": t}, 8))(params, toks)
    assert "pallas_call" in str(jaxpr)


def test_lm_one_layer_at_llama3_8b_attention_geometry():
    """One block at llama3-8b's attention geometry (d_model 4096, 32 query
    heads, 8 kv heads, head dim 128, rope theta 5e5) with a narrow FFN and
    vocabulary, f32, flash prefill + two decode steps."""
    full = rregistry.config("llama3-8b")
    over = dict(n_layers=1, d_ff=256, vocab=512, dtype="float32",
                attn_impl="flash")
    rcfg = dataclasses.replace(full, **over)
    pcfg = dataclasses.replace(registry.config("llama3-8b"), **over)
    assert (pcfg.d_model, pcfg.n_heads, pcfg.n_kv_heads, pcfg.hd) == \
        (4096, 32, 8, 128)
    tokens = np.random.default_rng(2).integers(
        0, rcfg.vocab, (2, 12)).astype(np.int32)
    for what, want, got in _run_both(rcfg, pcfg, tokens, 16, 2):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0,
                                   err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["flash", "einsum"])
def test_gemma_prefill_decode_logits_match_reference(dtype, attn_impl):
    """A gemma-shaped LM at head dim 256 (geglu, tied unembedding): prefill
    through the flash path at D = 256 and decode through ``_sdpa``, against
    the reference with converted weights."""
    rcfg, pcfg = _gemma_cfgs(dtype, attn_impl)
    assert (pcfg.hd, pcfg.ffn_kind, pcfg.tie_embeddings) == \
        (256, "geglu", True)
    tokens = np.random.default_rng(5).integers(
        0, rcfg.vocab, (2, 11)).astype(np.int32)
    for what, want, got in _run_both(rcfg, pcfg, tokens, 16, 3):
        assert got.dtype == torch.float32 and got.shape == (2, rcfg.vocab)
        np.testing.assert_allclose(_np(got), _np(want),
                                   atol=LOGIT_ATOL[dtype], rtol=0,
                                   err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma_attention_at_head_dim_256_matches_reference(dtype):
    """The attention layer alone at head dim 256, flash prefill and two
    ``_sdpa`` decode steps, against the reference's (Pallas in interpret
    mode under the mesh)."""
    rcfg, pcfg = _gemma_cfgs(dtype)
    p = rlayers.attn_init(jax.random.PRNGKey(9), rcfg)
    tp = {k: _t(v) for k, v in p.items()}
    shape = (2, 16, rcfg.n_kv_heads, rcfg.hd)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rc = {"k": jnp.zeros(shape, jdt), "v": jnp.zeros(shape, jdt), "len": 0}
    pc = {"k": torch.zeros(shape, dtype=getattr(torch, dtype)),
          "v": torch.zeros(shape, dtype=getattr(torch, dtype)), "len": 0}
    with mesh_1x1():
        for step in range(3):
            jx, tx = _x((2, 9 if step == 0 else 1, rcfg.d_model), dtype,
                        seed=20 + step, scale=0.5)
            pos = np.arange(pc["len"], pc["len"] + tx.shape[1])
            want, rc = rlayers.attention(p, rcfg, jx,
                                         positions=jnp.asarray(pos), cache=rc)
            got, pc = layers.attention(tp, pcfg, tx,
                                       positions=torch.from_numpy(pos),
                                       cache=pc)
            np.testing.assert_allclose(_np(got), _np(want),
                                       **LAYER_TOL[dtype])


def test_lm_one_layer_at_gemma_7b_attention_geometry():
    """One block at gemma-7b's attention geometry (d_model 3072, 16 query
    and 16 kv heads, head dim 256, geglu, tied embeddings) with a narrow
    FFN and vocabulary, f32, flash prefill + two decode steps."""
    full = rregistry.config("gemma-7b")
    over = dict(n_layers=1, d_ff=256, vocab=512, dtype="float32",
                attn_impl="flash")
    rcfg = dataclasses.replace(full, **over)
    pcfg = dataclasses.replace(registry.config("gemma-7b"), **over)
    assert (pcfg.d_model, pcfg.n_heads, pcfg.n_kv_heads, pcfg.hd) == \
        (3072, 16, 16, 256)
    tokens = np.random.default_rng(3).integers(
        0, rcfg.vocab, (2, 12)).astype(np.int32)
    for what, want, got in _run_both(rcfg, pcfg, tokens, 16, 2):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0,
                                   err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trips_gemma_tied_tree_bitwise(dtype):
    """gemma's parameter tree (tied embeddings: no ``lm_head``) converts
    into the port and back bit for bit (bf16 leaves come back as float32
    holding the same values, ``tensor_to_numpy``'s contract)."""
    from repro_torch.convert import lm_params_to_numpy
    rcfg, pcfg = _gemma_cfgs(dtype)
    tree = jax.tree.map(np.asarray,
                        rlm.build(rcfg).init(jax.random.PRNGKey(4)))
    assert "lm_head" not in tree
    model = lm_params_from_numpy(pcfg, tree, device="cpu")
    assert model.lm_head is None
    back = lm_params_to_numpy(model, dict(model.named_parameters()))
    assert set(back) == set(tree)

    def same(a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        if b.dtype == jnp.bfloat16:
            assert a.dtype == np.float32
            a = a.astype(b.dtype)
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    jax.tree.map(same, back, tree)


def test_converter_checks_tree():
    rcfg, pcfg = _cfgs("float32")
    tree = jax.tree.map(np.asarray,
                        rlm.build(rcfg).init(jax.random.PRNGKey(0)))
    with pytest.raises(KeyError):
        lm_params_from_numpy(pcfg, {k: v for k, v in tree.items()
                                    if k != "lm_head"}, device="cpu")
    bad = dict(tree, embed=tree["embed"][:, :8])
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_numpy(pcfg, bad, device="cpu")


def test_bf16_leaves_convert_bit_exactly():
    x = jnp.asarray(np.random.default_rng(3).normal(size=(5, 7)),
                    jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(x))
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                          np.asarray(x).view(np.uint16))


# --- the MoE family: mixtral-8x7b (moe), deepseek-v3-671b (mla_*) -----------
MOE_ARCHS = ["mixtral-8x7b", "deepseek-v3-671b"]


def _moe_cfgs(arch, attn_impl="flash", **kw):
    return (rregistry.smoke_config(arch, attn_impl=attn_impl, **kw),
            registry.smoke_config(arch, attn_impl=attn_impl, **kw))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("attn_impl", ["flash", "einsum"])
def test_moe_prefill_decode_logits_match_reference(arch, attn_impl):
    """Prefill and 4 greedy decode steps of the SMOKE model (float32)
    against the reference with converted weights: mixtral's windowed GQA
    (K5's plain version under flash) and MoE, deepseek's MLA (absorbed
    form; never K5) with a dense prefix and the shared expert; the cache
    contents of every segment at the end."""
    rcfg, pcfg = _moe_cfgs(arch, attn_impl)
    tokens = np.random.default_rng(7).integers(
        0, rcfg.vocab, (2, 11)).astype(np.int32)
    for what, want, got in _run_both(rcfg, pcfg, tokens, 16, 4):
        assert got.dtype == torch.float32 and got.shape == (2, rcfg.vocab)
        np.testing.assert_allclose(_np(got), _np(want),
                                   atol=LOGIT_ATOL[rcfg.dtype], rtol=0,
                                   err_msg=what)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_long_prefill_matches_reference(arch):
    """A 40-token prompt, split into MoE chunks (``_MOE_CHUNK_TOKENS`` set
    to 16 on both sides; their capacity boundaries move) and, for
    mixtral, past its SMOKE window (16), then 2 decode steps."""
    from repro.models import moe as rmoe
    from repro_torch.models import moe
    rcfg, pcfg = _moe_cfgs(arch)
    tokens = np.random.default_rng(8).integers(
        0, rcfg.vocab, (2, 40)).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rmoe, "_MOE_CHUNK_TOKENS", 16)
        mp.setattr(moe, "_MOE_CHUNK_TOKENS", 16)
        for what, want, got in _run_both(rcfg, pcfg, tokens, 48, 2):
            np.testing.assert_allclose(_np(got), _np(want),
                                       atol=LOGIT_ATOL[rcfg.dtype], rtol=0,
                                       err_msg=what)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_segments_and_cache_layout_match_reference(arch):
    rcfg, pcfg = _moe_cfgs(arch)
    model = LM(pcfg, device="cpu", seed=0)
    assert [(s.name, s.kind, s.n_blocks) for s in model.segments] == [
        (s.name, s.kind, s.n_blocks) for s in rlm.segments_for(rcfg)]
    want = jax.tree.map(lambda a: tuple(a.shape),
                        rlm.build(rcfg).init_cache(3, 20))
    got = model.init_cache(3, 20)
    assert got.pop("len") == 0 and want.pop("len") == ()
    assert jax.tree.map(lambda t: tuple(t.shape), got) == want


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("attn_impl", ["flash", "einsum"])
def test_moe_loss_and_aux_match_reference(arch, attn_impl):
    """ce + 0.01 * aux, aux summed over the MoE blocks."""
    rcfg, pcfg = _moe_cfgs(arch, attn_impl)
    model, params, port = _models(rcfg, pcfg, seed=2)
    toks = np.random.default_rng(9).integers(
        0, rcfg.vocab, (3, 17)).astype(np.int32)
    with _ctx(attn_impl):
        want, wm = model.loss(params, {"tokens": jnp.asarray(toks)})
    got, gm = port.loss(toks)
    assert float(gm["aux"]) > 0
    np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(gm["aux"]), float(wm["aux"]), rtol=1e-6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got),
                               float(gm["ce"]) + 0.01 * float(gm["aux"]),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trips_moe_trees_bitwise(arch, dtype):
    """Every segment's tree (the dense prefix, the expert leaves, the
    float32 router and its bias, the shared expert, the MLA weights)
    converts into the port and back bit for bit."""
    from repro_torch.convert import lm_params_to_numpy
    rcfg, pcfg = _moe_cfgs(arch, dtype=dtype)
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
    blk = model.blocks[-1]
    assert blk.moe["router"].dtype == blk.moe["router_bias"].dtype \
        == torch.float32
    with pytest.raises(KeyError, match="moe"):
        bad = dict(tree, moe={k: v for k, v in tree["moe"].items()
                              if k != "ln2"})
        lm_params_from_numpy(pcfg, bad, device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decays_follow_the_reference_leaves(arch):
    """Every block leaf decays (the reference's are stacked, ndim >= 2):
    the router's bias, the shared expert and the norms included; the
    final norm does not."""
    _, pcfg = _moe_cfgs(arch)
    decays = LM(pcfg, device="cpu", seed=0).decays()
    last = pcfg.n_layers - 1
    assert decays[f"blocks.{last}.moe.router_bias"]
    assert decays[f"blocks.{last}.moe.w2"] and decays[f"blocks.0.ln1"]
    assert decays["embed"] and not decays["final_ln"]
    if pcfg.n_shared_experts:
        assert decays[f"blocks.{last}.moe.shared.w1"]
        assert decays["blocks.0.attn.wkr"]


# --- the state-space family: zamba2-7b (mamba_group, mamba), rwkv6 (rwkv) ---
# Constant-initialised leaves are perturbed in both packages before every
# comparison (test_torch_mamba2.perturb_ssm). bf16 logits: each Mamba2 and
# RWKV layer holds the bf16 layer limit alone (test_torch_mamba2,
# test_torch_rwkv6); in zamba2 the shared attention's one-ulp flips (as in
# the dense models) pass through the next group's gated Mamba2 blocks,
# which grow them to 0.05-0.12 at this size (the reference's own flash and
# einsum paths differ by 0.03 on the same weights), so zamba2's bf16 limit
# is 0.15; rwkv6's stays 5e-2.
SSM_ARCHS = ["zamba2-7b", "rwkv6-1.6b"]
SSM_LOGIT_ATOL = {"float32": 1e-5, "bfloat16": 0.15}


def _ssm_run_both(arch, dtype, attn_impl, tokens, max_len, steps):
    """Prefill + ``steps`` greedy decode steps of the perturbed SMOKE model
    on both, the reference's tokens fed to both; yields (what, reference
    logits, port logits), then holds every cache leaf."""
    from test_torch_mamba2 import ssm_models
    rcfg, _, model, params, port = ssm_models(arch, dtype, attn_impl)
    with _ctx(attn_impl):
        rl, rc = model.prefill(params, {"tokens": jnp.asarray(tokens)},
                               max_len)
        pl, pc = port.prefill(tokens, max_len)
        yield "prefill", rl, pl
        for step in range(steps):
            tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
            rl, rc = model.decode(params, rc, jnp.asarray(tok))
            pl, pc = port.decode(pc, torch.from_numpy(tok))
            yield f"decode {step}", rl, pl
    assert pc.pop("len") == int(rc.pop("len"))
    assert jax.tree.structure(jax.tree.map(_np, pc)) == \
        jax.tree.structure(jax.tree.map(_np, rc))
    # each cache leaf within 1e-5 (float32) or 6e-2 (bf16: the few ulps
    # the flips above compound to) of its largest |value|; the float32 SSM
    # and WKV states sum bf16 inputs
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        _np(g), _np(w), rtol=0, atol=(1e-5 if dtype == "float32" else 6e-2)
        * max(1.0, float(np.abs(_np(w)).max()))), pc, rc)


@pytest.mark.parametrize("arch,attn_impl", [("zamba2-7b", "flash"),
                                            ("zamba2-7b", "einsum"),
                                            ("rwkv6-1.6b", "flash")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_prefill_decode_logits_match_reference(arch, attn_impl, dtype):
    """Prefill (zamba2's shared block through K5's plain version under
    flash, the Mamba2 chunked scan; rwkv6's recurrence) and 3 greedy
    decode steps (the O(1) states), then every state and k/v leaf."""
    rcfg = registry.smoke_config(arch)
    tokens = np.random.default_rng(0).integers(
        0, rcfg.vocab, (2, 11)).astype(np.int32)
    tol = SSM_LOGIT_ATOL[dtype] if arch == "zamba2-7b" else \
        LOGIT_ATOL[dtype]
    for what, want, got in _ssm_run_both(arch, dtype, attn_impl, tokens, 16,
                                         3):
        assert got.dtype == torch.float32 and got.shape == (2, rcfg.vocab)
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0,
                                   err_msg=what)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_segments_and_cache_layout_match_reference(arch):
    """zamba2-smoke: 2 groups of 2 Mamba2 blocks and a 1-block tail, the
    shared block's k/v beside each group's stacked (n_groups, k, ...)
    states; rwkv6: one segment, its three state leaves."""
    rcfg = rregistry.smoke_config(arch)
    model = LM(registry.smoke_config(arch), device="cpu", seed=0)
    assert [(s.name, s.kind, s.n_blocks) for s in model.segments] == [
        (s.name, s.kind, s.n_blocks) for s in rlm.segments_for(rcfg)]
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        rlm.build(rcfg).init_cache(3, 20))
    got = model.init_cache(3, 20)
    assert got.pop("len") == 0 and want.pop("len") == ((), "int32")
    assert jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).split(".")[1]), got) == want
    if arch == "zamba2-7b":
        assert [(s.kind, s.n_blocks) for s in model.segments] == [
            ("mamba_group", 2), ("mamba", 1)]
        assert got["mamba_group"]["mambas"]["m"]["ssm"].shape == \
            (2, 2, 3, 8, 16, 16)
        assert model.shared_attn is not None


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_loss_matches_reference(arch):
    from test_torch_mamba2 import ssm_models
    _, _, model, params, port = ssm_models(arch)
    toks = np.random.default_rng(9).integers(
        0, port.cfg.vocab, (3, 17)).astype(np.int32)
    with mesh_1x1():
        want, wm = model.loss(params, {"tokens": jnp.asarray(toks)})
    got, gm = port.loss(toks)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(gm["aux"]) == float(wm["aux"]) == 0.0


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trips_ssm_trees_bitwise(arch, dtype):
    """zamba2's tree (the group's ``mambas`` stacked (n_groups, k, ...),
    the tail, the unstacked ``shared_attn``) and rwkv6's convert into the
    port and back bit for bit; a tree without ``shared_attn`` is refused."""
    from repro_torch.convert import lm_params_to_numpy
    from test_torch_mamba2 import _ref_params
    pcfg = registry.smoke_config(arch, dtype=dtype)
    tree = jax.tree.map(np.asarray, _ref_params(arch, dtype, 0))
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
    if arch == "zamba2-7b":
        assert float(model.blocks[1].mambas[1].mamba["a_log"][2]) == \
            float(tree["mamba_group"]["mambas"]["mamba"]["a_log"][1, 1, 2])
        with pytest.raises(KeyError, match="shared_attn"):
            lm_params_from_numpy(pcfg, {k: v for k, v in tree.items()
                                        if k != "shared_attn"}, device="cpu")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_decays_follow_reference_ndim_rule(arch):
    """A leaf decays where the reference's has ndim >= 2: every stacked
    block leaf (the Mamba2 and RWKV vectors included), not ``final_ln``
    nor ``shared_attn``'s unstacked (D,) norms."""
    from repro_torch.convert import lm_params_to_numpy
    from test_torch_mamba2 import _ref_params
    model = LM(registry.smoke_config(arch), device="cpu", seed=0)
    decays = model.decays()
    got = lm_params_to_numpy(model, {n: torch.full(p.shape, float(decays[n]))
                                     for n, p in model.named_parameters()})
    want = jax.tree.map(lambda a: np.full(a.shape, float(a.ndim >= 2)),
                        _ref_params(arch, "float32", 0))
    jax.tree.map(np.testing.assert_array_equal, got, want)
    if arch == "zamba2-7b":
        assert not decays["shared_attn.ln1"] and decays["shared_attn.attn.wq"]
        assert decays["blocks.0.mambas.1.mamba.a_log"]
        assert decays["blocks.2.mamba.dt_bias"]
