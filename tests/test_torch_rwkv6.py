"""The port's RWKV-6 block (``repro_torch.models.rwkv6``) against the
reference (``repro.models.rwkv6``), on the same weights and inputs.

Weights are the reference's own init carried across as numpy, with the
constant-initialised leaves perturbed first (``perturb_ssm``): at the
reference's init every mix is 0.5 and ``u_bonus`` 0, where a swapped mix
or a dropped bonus term would pass unseen. The carried state and the
inputs are seeded numpy normals.

Tolerances: float32 within 1e-5 of the output's largest |value| (the
recurrence sums in another order), bf16 2e-2 (the LM tests' bf16 layer
limit).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import rwkv6 as rrwkv
from repro_torch.configs import registry
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import rwkv6
from test_torch_mamba2 import (_lm_decode_vs_prefill, _np, close,
                               perturb_ssm)

ARCH = "rwkv6-1.6b"


def _cfgs(dtype="float32"):
    return (rregistry.smoke_config(ARCH, dtype=dtype),
            registry.smoke_config(ARCH, dtype=dtype))


def _params(rcfg, seed=1):
    p = perturb_ssm(rrwkv.rwkv6_init(jax.random.PRNGKey(seed), rcfg), seed)
    return p, {k: tensor_from_numpy(np.asarray(v)) for k, v in p.items()}


def _state(rcfg, b, dtype, seed):
    """A carried state of seeded normals: tm_prev and cm_prev in
    ``dtype``, wkv float32."""
    rng = np.random.default_rng(seed)
    H, N = rrwkv.rwkv_dims(rcfg)
    st = {"tm_prev": rng.normal(size=(b, 1, rcfg.d_model)),
          "wkv": rng.normal(size=(b, H, N, N)),
          "cm_prev": rng.normal(size=(b, 1, rcfg.d_model))}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    return ({k: jnp.asarray(v, jnp.float32).astype(
                jnp.float32 if k == "wkv" else jdt) for k, v in st.items()},
            {k: torch.from_numpy(v.astype(np.float32)).to(
                torch.float32 if k == "wkv" else tdt)
             for k, v in st.items()})


def _x(shape, dtype, seed):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(
        getattr(torch, dtype))


def test_dims_init_and_state_match_reference():
    rcfg, pcfg = _cfgs("bfloat16")
    assert rwkv6.rwkv_dims(pcfg) == rrwkv.rwkv_dims(rcfg) == (2, 64)
    want = rrwkv.rwkv6_init(jax.random.PRNGKey(0), rcfg)
    got = rwkv6.rwkv6_init(torch.Generator().manual_seed(0), pcfg, "cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[1] == str(w.dtype), k
        if w.dtype == jnp.float32:
            np.testing.assert_array_equal(_np(got[k]), _np(w))
    assert float(got["ww"].float().std()) < 2e-3      # scale 1e-3
    st = rwkv6.rwkv6_block_state(pcfg, 3, "cpu")
    ref = rrwkv.rwkv6_block_state(rcfg, 3)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in st.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in ref.items()}


def test_head_size_must_divide_d_model():
    """The reference asserts d_model % 64 == 0; the port raises."""
    _, pcfg = _cfgs()
    with pytest.raises(ValueError, match="head size 64"):
        rwkv6.rwkv_dims(dataclasses.replace(pcfg, d_model=96))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 9])
def test_time_mix_with_carried_state_matches_reference(dtype, s):
    """time_mix from a carried state (tm_prev and wkv not zero), one token
    and a sequence: the output and the new state."""
    rcfg, pcfg = _cfgs(dtype)
    p, tp = _params(rcfg)
    jst, tst = _state(rcfg, 2, dtype, seed=s)
    jx, tx = _x((2, s, rcfg.d_model), dtype, seed=10 + s)
    want, ws = rrwkv.time_mix(p, rcfg, jx, jst)
    got, gs = rwkv6.time_mix(tp, pcfg, tx, tst)
    assert got.dtype == tx.dtype and set(gs) == set(ws)
    close(got, want, dtype)
    for k in ws:
        assert gs[k].dtype == (torch.float32 if k == "wkv" else tx.dtype)
        close(gs[k], ws[k], dtype if k != "wkv" else "float32", k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_with_carried_state_matches_reference(dtype):
    rcfg, pcfg = _cfgs(dtype)
    p, tp = _params(rcfg, seed=2)
    jst, tst = _state(rcfg, 2, dtype, seed=3)
    jx, tx = _x((2, 7, rcfg.d_model), dtype, seed=4)
    want, ws = rrwkv.channel_mix(p, rcfg, jx, jst)
    got, gs = rwkv6.channel_mix(tp, pcfg, tx, tst)
    close(got, want, dtype)
    np.testing.assert_array_equal(_np(gs["cm_prev"]), _np(ws["cm_prev"]))


def value_axis_step(s_prev, r, k, v, w, u):
    """``rwkv6.wkv_step`` with ``u_bonus`` along the value axis m: the
    control of the bonus's axis."""
    kv = k[..., :, None] * v[..., None, :]
    out = torch.matmul(r[..., None, :], s_prev + u[..., None, :] * kv)
    return out[..., 0, :], w[..., None] * s_prev + kv


def test_bonus_on_the_value_axis_is_caught(monkeypatch):
    """``u_bonus`` multiplies the key axis n of k^T v (the reference's
    ``u[..., None]``); with it on the value axis the output leaves the
    reference's float32 limit by far, so the comparison above tells the
    two apart (at the zero init it could not)."""
    rcfg, pcfg = _cfgs()
    p, tp = _params(rcfg)
    jst, tst = _state(rcfg, 2, "float32", seed=5)
    jx, tx = _x((2, 4, rcfg.d_model), "float32", seed=6)
    want, _ = rrwkv.time_mix(p, rcfg, jx, jst)
    monkeypatch.setattr(rwkv6, "wkv_step", value_axis_step)
    moved, _ = rwkv6.time_mix(tp, pcfg, tx, tst)
    assert float(np.abs(_np(moved) - _np(want)).max()) > 1e-2


def test_decode_after_prefill_equals_longer_prefill():
    """S tokens then one decode step give the last logits of a prefill of
    S + 1 (float32 SMOKE, 1e-4); with the wkv state zeroed before the
    decode they must lie beyond it."""
    assert _lm_decode_vs_prefill(ARCH, 12) <= 1e-4

    def zero_wkv(cache):
        cache["rwkv"]["wkv"].zero_()
    assert _lm_decode_vs_prefill(ARCH, 12, zero_wkv) > 1e-3
