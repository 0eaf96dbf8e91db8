"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
(``repro.optim.adamw``), on the same numpy parameters and gradients.

The int8 moment store is bitwise the reference's; one update step, with
float32 or int8 moments, equal within 1e-6; the learning-rate schedule
equal in float32. The weight-decay rule follows the reference's leaves:
its per-block norm gammas are stacked (n_layers, D) and decay, so the
port's 1-d per-block gammas must decay too, while ``final_ln`` does not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import lm as rlm
from repro.optim import adamw as radamw
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.optim import adamw

TOL = dict(atol=1e-6, rtol=1e-6)


def _x(shape, seed=0, scale=3.0):
    return np.asarray(np.random.default_rng(seed).normal(size=shape)
                      * scale, dtype=np.float32)


@pytest.mark.parametrize("shape", [(), (5,), (128,), (300,), (4, 130),
                                   (2, 3, 256)])
def test_quantize_bitwise_equal(shape):
    x = _x(shape, seed=len(shape))
    if x.size > 8:
        x.reshape(-1)[:3] = 0.0
    want = radamw.quantize(jnp.asarray(x))
    got = adamw.quantize(torch.from_numpy(x))
    assert got.shape == want.shape == shape
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(adamw.dequantize(got).numpy(),
                                  np.asarray(radamw.dequantize(want)))


def test_quantize_rounds_half_to_even():
    """A block whose absmax is 127 has scale 1, so x.5 values round to the
    even neighbour, in both."""
    x = np.zeros(128, np.float32)
    x[:6] = [127.0, 2.5, 3.5, -2.5, -0.5, 0.5]
    got = adamw.quantize(torch.from_numpy(x)).q.numpy()[:6]
    want = np.asarray(radamw.quantize(jnp.asarray(x)).q)[:6]
    np.testing.assert_array_equal(got, [127, 2, 4, -2, 0, 0])
    np.testing.assert_array_equal(got, want)


def test_schedule_float32_equal():
    for cfg_kw in (dict(), dict(lr=1.0, warmup_steps=10, total_steps=100),
                   dict(lr=3e-3, warmup_steps=0, total_steps=7)):
        rc, pc = radamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
        for s in (0, 1, 5, 10, 11, 50, 99, 100, 150, 10000):
            want = radamw.schedule(rc, jnp.asarray(s))
            got = adamw.schedule(pc, s)
            assert got.dtype == torch.float32 and want.dtype == jnp.float32
            assert float(got) == float(want), (cfg_kw, s)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 130)).astype(np.float32),
            "stack": rng.normal(size=(3, 4, 256)).astype(np.float32),
            "gamma": rng.normal(size=(200,)).astype(np.float32)}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("steps", [1, 3])
def test_update_matches_reference(quantized, steps):
    """AdamW steps on the same parameters and gradients: new parameters,
    moments, grad_norm and lr within 1e-6 (clip active: grad_clip 1.0
    against norms of ~40)."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
              quantized_state=quantized)
    rc, pc = radamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    p0 = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    rs, ps = radamw.init(rc, jp), adamw.init(pc, tp)
    for i in range(steps):
        g = _tree(100 + i)
        jp, rs, rm = radamw.update(rc, {k: jnp.asarray(v) for k, v in
                                        g.items()}, rs, jp)
        tp, ps, pm = adamw.update(pc, {k: torch.from_numpy(v) for k, v in
                                       g.items()}, ps, tp)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), **TOL)
        assert float(pm["lr"]) == float(rm["lr"])
    assert ps.step == int(rs.step) == steps
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL,
                                   err_msg=k)
        for got, want in ((ps.m[k], rs.m[k]), (ps.v[k], rs.v[k])):
            if quantized:
                got, want = adamw.dequantize(got), radamw.dequantize(want)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=k)


def test_update_consumes_grads_and_writes_params_in_place():
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    p = {k: torch.from_numpy(v) for k, v in _tree(1).items()}
    ids = {k: id(v) for k, v in p.items()}
    grads = {k: torch.from_numpy(v) for k, v in _tree(2).items()}
    new, _, _ = adamw.update(cfg, grads, adamw.init(cfg, p), p)
    assert grads == {}
    assert {k: id(v) for k, v in new.items()} == ids


def test_bf16_parameters_round_like_the_reference():
    """bf16 parameters: the float32 update is rounded to bf16 (nearest
    even), in place; equal to the reference's bf16 result."""
    cfg = dict(lr=3e-2, warmup_steps=0, quantized_state=True)
    rc, pc = radamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    p0, g = _tree(3), _tree(4)
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p0.items()}
    jg = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in g.items()}
    tg = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in g.items()}
    jp, _, _ = radamw.update(rc, jg, radamw.init(rc, jp), jp)
    tp, _, _ = adamw.update(pc, tg, adamw.init(pc, tp), tp)
    for k in p0:
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp[k].float().numpy(), np.asarray(jp[k].astype(jnp.float32)))


def test_weight_decay_follows_the_reference_leaves():
    """With zero gradients an AdamW step is pure decay. The reference
    decays its stacked (n_layers, D) per-block gammas (ndim 2) and not
    final_ln (D,); the port's per-block gammas are 1-d but are slices of
    those leaves, so ``LM.decays`` marks them, and the step equals the
    reference's on every leaf."""
    rcfg = rregistry.smoke_config("llama3-8b")
    pcfg = registry.smoke_config("llama3-8b")
    params = rlm.build(rcfg).init(jax.random.PRNGKey(0))
    # non-unit gammas, so that a decay shows
    params = dict(params, final_ln=params["final_ln"] * 1.5)
    params["dense"] = dict(params["dense"],
                           ln1=params["dense"]["ln1"] * 2.0)
    model = lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    decays = model.decays()
    assert decays["blocks.0.ln1"] and decays["blocks.1.ln2"]
    assert decays["embed"] and decays["blocks.0.attn.wq"]
    assert not decays["final_ln"]

    kw = dict(lr=0.1, warmup_steps=0, weight_decay=0.5)
    rc, pc = radamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    zeros = jax.tree.map(jnp.zeros_like, params)
    want, _, _ = radamw.update(rc, zeros, radamw.init(rc, params), params)
    tp = dict(model.named_parameters())
    with torch.no_grad():
        grads = {k: torch.zeros_like(v) for k, v in tp.items()}
        adamw.update(pc, grads, adamw.init(pc, tp), tp, decay=decays)
    got = lm_params_to_numpy(model)
    ln1 = got["dense"]["ln1"]
    np.testing.assert_allclose(ln1, np.asarray(params["dense"]["ln1"])
                               * (1 - 0.1 * 0.5), rtol=1e-6)
    np.testing.assert_array_equal(got["final_ln"],
                                  np.asarray(params["final_ln"]))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=1e-6, atol=1e-7), got, want)
    # the default rule (ndim >= 2) would have left the 1-d gammas alone
    assert pc.weight_decay > 0 and not all(
        p.dim() >= 2 for n, p in tp.items() if decays[n])


def test_init_moments_are_zero_and_shaped():
    p = {k: torch.from_numpy(v) for k, v in _tree(5).items()}
    for quantized in (False, True):
        st = adamw.init(adamw.AdamWConfig(quantized_state=quantized), p)
        assert st.step == 0
        for k, v in p.items():
            m = adamw.dequantize(st.m[k]) if quantized else st.m[k]
            assert m.shape == v.shape and not m.any()
            if quantized:
                assert st.m[k].q.shape[-1] % adamw.BLOCK == 0
