"""The port's multi-head latent attention (``layers.mla_attention``)
against the reference's (``repro.models.layers.mla_attention``), at the
deepseek-v3-671b SMOKE size (4 heads, q rank 32, kv rank 16, nope 16,
rope 8, v 16) on the same weights and inputs.

The full form (no cache: training) goes through ``_sdpa`` on the nope and
rope halves concatenated; the absorbed form (a cache: prefill and
decode) scores in the latent space against the cached kv_c and k_rope,
written in place. Neither reaches K5, in the port as in the reference.
Tolerances: f32 2e-5, bf16 2e-2 (test_torch_lm.py's layer tolerances).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import layers as rlayers
from repro_torch.configs import registry
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.lm import LM

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
ARCH = "deepseek-v3-671b"


def _cfgs(dtype, **over):
    return (rregistry.smoke_config(ARCH, dtype=dtype, **over),
            registry.smoke_config(ARCH, dtype=dtype, **over))


def _params(rcfg, seed):
    p = rlayers.mla_init(jax.random.PRNGKey(seed), rcfg)
    return p, {k: tensor_from_numpy(np.asarray(v)) for k, v in p.items()}


def _x(shape, dtype, seed, scale=0.5):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    a *= scale
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_shapes_match_reference_init(dtype):
    rcfg, pcfg = _cfgs(dtype)
    want = {k: tuple(v.shape) for k, v in
            rlayers.mla_init(jax.random.PRNGKey(0), rcfg).items()}
    assert layers.mla_shapes(pcfg) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_full_form_matches_reference(dtype):
    """No cache: nope + rope concatenated into one head dim through
    ``_sdpa``, v's head dim dv."""
    rcfg, pcfg = _cfgs(dtype)
    rp, pp = _params(rcfg, 1)
    jx, tx = _x((2, 11, rcfg.d_model), dtype, 2)
    want, wc = rlayers.mla_attention(rp, rcfg, jx)
    got, gc = layers.mla_attention(pp, pcfg, tx)
    assert wc is None and gc is None
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_absorbed_prefill_and_decode_match_reference(dtype):
    """A prefill of 7 tokens into an empty (B, 16, R) / (B, 16, dr) cache,
    then 3 decode steps: outputs and the cache contents agree, the cache
    written in place. XLA's CPU runtime here refuses the reference's
    absorbed bf16 x bf16 = f32 einsums, so the bf16 port is held to the
    reference in float32 on the same bf16 values, at the bf16 limit."""
    rcfg, pcfg = _cfgs(dtype)
    rp, pp = _params(rcfg, 3)
    if dtype == "bfloat16":
        rcfg = dataclasses.replace(rcfg, dtype="float32")
        rp = {k: v.astype(jnp.float32) for k, v in rp.items()}
    B, T = 2, 16
    tdt = getattr(torch, dtype)
    rc = {"kv_c": jnp.zeros((B, T, rcfg.kv_lora_rank)),
          "k_rope": jnp.zeros((B, T, rcfg.qk_rope_head_dim)), "len": 0}
    pc = {"kv_c": torch.zeros((B, T, pcfg.kv_lora_rank), dtype=tdt),
          "k_rope": torch.zeros((B, T, pcfg.qk_rope_head_dim), dtype=tdt),
          "len": 0}
    kv_c = pc["kv_c"]
    for step in range(4):
        _, tx = _x((B, 7 if step == 0 else 1, rcfg.d_model), dtype,
                   10 + step)
        jx = jnp.asarray(tx.float().numpy())
        pos = np.arange(pc["len"], pc["len"] + tx.shape[1])
        want, rc = rlayers.mla_attention(rp, rcfg, jx,
                                         positions=jnp.asarray(pos),
                                         cache=rc)
        got, pc = layers.mla_attention(pp, pcfg, tx,
                                       positions=torch.from_numpy(pos),
                                       cache=pc)
        assert pc["len"] == int(rc["len"]) and pc["kv_c"] is kv_c
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype],
                                   err_msg=f"step {step}")
    for key in ("kv_c", "k_rope"):
        np.testing.assert_allclose(_np(pc[key]), _np(rc[key]), **TOL[dtype])


def test_absorbed_decode_equals_the_full_form():
    """The absorbed form after a prefill of s tokens, decoding token s,
    gives the full form's output at position s (float32)."""
    _, pcfg = _cfgs("float32")
    _, pp = _params(rregistry.smoke_config(ARCH, dtype="float32"), 4)
    _, tx = _x((2, 9, pcfg.d_model), "float32", 5)
    full, _ = layers.mla_attention(pp, pcfg, tx)
    cache = {"kv_c": torch.zeros(2, 12, pcfg.kv_lora_rank),
             "k_rope": torch.zeros(2, 12, pcfg.qk_rope_head_dim), "len": 0}
    _, cache = layers.mla_attention(pp, pcfg, tx[:, :8], cache=cache)
    step, _ = layers.mla_attention(pp, pcfg, tx[:, 8:],
                                   positions=torch.tensor([8]), cache=cache)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 8].numpy(),
                               atol=2e-5, rtol=2e-5)


def test_mla_never_takes_k5(monkeypatch):
    """With ``attn_impl="flash"`` an MLA model's prefill, decode and loss
    run no flash kernel: the reference's MLA calls ``_sdpa``."""
    def refuse(*args, **kwargs):
        raise AssertionError("MLA reached the flash kernel")

    monkeypatch.setattr(ops, "flash_attention", refuse)
    cfg = registry.smoke_config(ARCH, attn_impl="flash")
    model = LM(cfg, device="cpu", seed=0)
    logits, cache = model.prefill(np.array([[3, 4, 5, 6]]), 8)
    model.decode(cache, torch.argmax(logits, -1))
    model.loss(np.array([[3, 4, 5, 6, 7]]))


def test_mla_cache_overflow_raises():
    _, pcfg = _cfgs("float32")
    _, pp = _params(rregistry.smoke_config(ARCH, dtype="float32"), 0)
    cache = {"kv_c": torch.zeros(1, 4, pcfg.kv_lora_rank),
             "k_rope": torch.zeros(1, 4, pcfg.qk_rope_head_dim), "len": 3}
    with pytest.raises(ValueError, match="cache of length 4"):
        layers.mla_attention(pp, pcfg, torch.zeros(1, 2, pcfg.d_model),
                             positions=torch.arange(3, 5), cache=cache)


def test_mla_at_deepseek_v3_head_geometry():
    """One MLA layer at deepseek-v3-671b's head geometry (128 heads, q rank
    1536, kv rank 512, nope 128, rope 64, v 128) at a narrow d_model, f32,
    full form and a decode step, against the reference."""
    over = dict(d_model=256, dtype="float32")
    rcfg = dataclasses.replace(rregistry.config(ARCH), **over)
    pcfg = dataclasses.replace(registry.config(ARCH), **over)
    assert (pcfg.n_heads, pcfg.q_lora_rank, pcfg.kv_lora_rank,
            pcfg.qk_nope_head_dim, pcfg.qk_rope_head_dim,
            pcfg.v_head_dim) == (128, 1536, 512, 128, 64, 128)
    rp, pp = _params(rcfg, 6)
    jx, tx = _x((1, 5, 256), "float32", 7)
    want, _ = rlayers.mla_attention(rp, rcfg, jx)
    got, _ = layers.mla_attention(pp, pcfg, tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    rc = {"kv_c": jnp.zeros((1, 8, 512)), "k_rope": jnp.zeros((1, 8, 64)),
          "len": 0}
    pc = {"kv_c": torch.zeros(1, 8, 512), "k_rope": torch.zeros(1, 8, 64),
          "len": 0}
    want, rc = rlayers.mla_attention(rp, rcfg, jx, cache=rc)
    got, pc = layers.mla_attention(pp, pcfg, tx, cache=pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
