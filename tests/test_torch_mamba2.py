"""The port's Mamba2 block (``repro_torch.models.mamba2``) against the
reference (``repro.models.mamba2``), on the same weights and inputs.

Weights are the reference's own init carried across as numpy, with the
constant-initialised leaves perturbed first (``perturb_ssm``: seeded
uniform noise in both packages): at the reference's init (A = -1, D = 1,
dt_bias 0) a term that read the wrong head's decay or skip would pass
unseen. Inputs are seeded numpy normals.

Tolerances: float32 within 1e-5 of the output's largest |value| (at
least 1e-5): the scan sums in another order, and over a 256-token chunk
the cumulative log-decay reaches ~-200, where one float32 ulp is 1.5e-5,
so exp(cum_i - cum_j) carries that much relative error; bf16 inputs 2e-2
(the LM tests' bf16 layer limit: both sides round at the same points, and
a one-ulp flip moves an output by at most an ulp).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import lm as rlm
from repro.models import mamba2 as rmamba
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy, tensor_from_numpy
from repro_torch.models import mamba2

ARCH = "zamba2-7b"
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}

# the leaves the reference initialises to constants, and the ranges they
# are drawn from before a comparison
SSM_NOISE = {"a_log": (-1.0, 0.5), "d_skip": (0.5, 1.5),
             "dt_bias": (-1.0, 0.5), "u_bonus": (-0.5, 0.5),
             "w_bias": (-7.0, -3.0), "mix_r": (0.1, 0.9),
             "mix_k": (0.1, 0.9), "mix_v": (0.1, 0.9), "mix_w": (0.1, 0.9),
             "cmix_k": (0.1, 0.9)}


def perturb_ssm(tree, seed=0):
    """``tree`` with every constant-initialised SSM / RWKV leaf (by its
    name, ``SSM_NOISE``) drawn uniform from its range, float32, from
    numpy's generator at ``seed``."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = getattr(path[-1], "key", None)
        if name in SSM_NOISE:
            lo, hi = SSM_NOISE[name]
            return jnp.asarray(rng.uniform(lo, hi, a.shape).astype(np.float32))
        return a
    return jax.tree_util.tree_map_with_path(draw, tree)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, dtype, seed):
    """The reference's init of ``arch``'s SMOKE config at ``seed``, the
    constant leaves perturbed (one init per process)."""
    model = rlm.build(rregistry.smoke_config(arch, dtype=dtype))
    return perturb_ssm(jax.jit(model.init)(jax.random.PRNGKey(seed)), seed)


def ssm_models(arch, dtype="float32", attn_impl="flash", seed=0, **kw):
    """(reference cfg, port cfg, reference model, its perturbed params,
    the port's LM with them) at ``arch``'s SMOKE config."""
    over = dict(dtype=dtype, attn_impl=attn_impl, **kw)
    rcfg = rregistry.smoke_config(arch, **over)
    pcfg = registry.smoke_config(arch, **over)
    model = rlm.build(rcfg)
    params = (_ref_params(arch, dtype, seed) if not kw else perturb_ssm(
        jax.jit(model.init)(jax.random.PRNGKey(seed)), seed))
    port = lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    return rcfg, pcfg, model, params, port


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, dtype, what=""):
    """``got`` against ``want`` at ``TOL[dtype]``; float32 scaled by the
    largest |want|."""
    got, want = _np(got), _np(want)
    tol = dict(TOL[dtype])
    if dtype == "float32":
        tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, **tol, err_msg=what)


def _cfgs(dtype="float32"):
    return (rregistry.smoke_config(ARCH, dtype=dtype),
            registry.smoke_config(ARCH, dtype=dtype))


def _params(rcfg, seed=1):
    p = perturb_ssm(rmamba.mamba2_init(jax.random.PRNGKey(seed), rcfg),
                    seed)
    return p, {k: tensor_from_numpy(np.asarray(v)) for k, v in p.items()}


def _x(shape, dtype, seed):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(
        getattr(torch, dtype))


def test_dims_and_init_leaves_match_reference():
    rcfg, pcfg = _cfgs("bfloat16")
    assert mamba2.mamba2_dims(pcfg) == rmamba.mamba2_dims(rcfg)
    want = rmamba.mamba2_init(jax.random.PRNGKey(0), rcfg)
    got = mamba2.mamba2_init(torch.Generator().manual_seed(0), pcfg, "cpu")
    assert list(got) == list(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[1] == str(w.dtype), k
        if k in ("a_log", "d_skip", "dt_bias", "norm_g"):
            np.testing.assert_array_equal(_np(got[k]), _np(w))
    state = mamba2.mamba2_init_state(pcfg, 3, "cpu")
    ref = rmamba.mamba2_init_state(rcfg, 3)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in state.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in ref.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk", [(64, 16), (40, 40), (96, 32)])
def test_ssd_chunked_matches_reference(dtype, s, chunk):
    """The chunked scan alone, one chunk and several: the output and the
    final state, from seeded x, dt > 0, A < 0, B and C."""
    rng = np.random.default_rng(s + chunk)
    b, h, p, n = 2, 4, 8, 16
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.05, 1.2, (b, s, h)).astype(np.float32)
    A = -rng.uniform(0.3, 2.0, h).astype(np.float32)
    B = rng.normal(size=(b, s, n)).astype(np.float32)
    C = rng.normal(size=(b, s, n)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    want, wh = rmamba._ssd_chunked(
        jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(A),
        jnp.asarray(B).astype(jdt), jnp.asarray(C).astype(jdt), chunk)
    got, gh = mamba2._ssd_chunked(
        torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
        torch.from_numpy(A), torch.from_numpy(B).to(tdt),
        torch.from_numpy(C).to(tdt), chunk)
    assert got.dtype == tdt and gh.dtype == torch.float32
    close(got, want, dtype)
    close(gh, wh, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [11, 300])
def test_training_forward_matches_reference(dtype, s):
    """No state: the training path, S < chunk (one chunk of S) and S =
    300, which the chunk (256) does not divide (zero-padded for the scan,
    as in the reference)."""
    rcfg, pcfg = _cfgs(dtype)
    p, tp = _params(rcfg)
    jx, tx = _x((2, s, rcfg.d_model), dtype, seed=s)
    want, ws = rmamba.mamba2_forward(p, rcfg, jx)
    got, gs = mamba2.mamba2_forward(tp, pcfg, tx)
    assert ws is None and gs is None and got.dtype == tx.dtype
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [3, 11, 256, 512])
def test_prefill_then_decode_matches_reference(dtype, s):
    """Prefill (the state after the prompt: the last ssm_conv conv inputs,
    zero-padded on the left when S < ssm_conv, and the final SSM state),
    then two O(1) decode steps: outputs and every state leaf."""
    rcfg, pcfg = _cfgs(dtype)
    p, tp = _params(rcfg, seed=2)
    jx, tx = _x((2, s, rcfg.d_model), dtype, seed=s)
    want, ws = rmamba.mamba2_forward(p, rcfg, jx, return_state=True)
    got, gs = mamba2.mamba2_forward(tp, pcfg, tx, return_state=True)
    for step in range(3):
        close(got, want, dtype, f"step {step}")
        assert set(gs) == set(ws) == {"conv", "ssm"}
        for k in ws:
            assert tuple(gs[k].shape) == ws[k].shape
            assert gs[k].dtype == (torch.float32 if k == "ssm" else tx.dtype)
            close(gs[k], ws[k], dtype, f"{k} step {step}")
        jx, tx = _x((2, 1, rcfg.d_model), dtype, seed=100 + step)
        want, ws = rmamba.mamba2_forward(p, rcfg, jx, state=ws)
        got, gs = mamba2.mamba2_forward(tp, pcfg, tx, state=gs)


def test_unaligned_prefill_raises():
    """A prefill of 300 tokens (> the 256-token chunk, not a multiple of
    it) would decay the final state through the padding: the reference
    asserts, the port raises a ValueError naming the chunk."""
    rcfg, pcfg = _cfgs()
    p, tp = _params(rcfg)
    jx, tx = _x((1, 300, rcfg.d_model), "float32", seed=0)
    with pytest.raises(AssertionError, match="multiple of the ssd chunk"):
        rmamba.mamba2_forward(p, rcfg, jx, return_state=True)
    with pytest.raises(ValueError, match="SSD chunk 256"):
        mamba2.mamba2_forward(tp, pcfg, tx, return_state=True)


def test_intra_chunk_decay_gradient_is_finite():
    """Over a whole 256-token chunk at the reference's init, exp(cum_i -
    cum_j) overflows above the diagonal: the reference's where(mask,
    exp(.), 0) keeps the forward finite but its gradient is NaN (a_log,
    dt_bias, in_dt). The port takes exp of the masked difference (-inf
    above the diagonal): the same forward, a finite gradient, equal to the
    reference's at a chunk of 64, where nothing overflows (the same
    function, in 4 chunks)."""
    rcfg, pcfg = _cfgs()
    p = rmamba.mamba2_init(jax.random.PRNGKey(1), rcfg)
    tp = {k: tensor_from_numpy(np.asarray(v)).requires_grad_()
          for k, v in p.items()}
    x = np.random.default_rng(0).normal(
        size=(1, 256, rcfg.d_model)).astype(np.float32)

    def ref_loss(chunk):
        def f(p, x):
            y, _ = rmamba.mamba2_forward(p, rcfg, x, chunk=chunk)
            return jnp.sum(y * y)
        return jax.jit(jax.grad(f))(p, jnp.asarray(x))

    nan = ref_loss(256)
    assert not np.isfinite(np.asarray(nan["a_log"])).all()
    want = ref_loss(64)
    y, _ = mamba2.mamba2_forward(tp, pcfg, torch.from_numpy(x))
    (y * y).sum().backward()
    for k, w in want.items():
        w = np.asarray(w)
        g = tp[k].grad.numpy()
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=k)


def test_softplus_is_logaddexp_as_jax():
    """``jax.nn.softplus`` is logaddexp(x, 0); the port's is the same
    function (within an ulp of jax's on [-30, 30]), not F.softplus's
    log1p(exp(x)) with its threshold at 20."""
    x = np.linspace(-30, 30, 20001).astype(np.float32)
    got = mamba2.softplus(torch.from_numpy(x))
    assert torch.equal(got, torch.logaddexp(torch.from_numpy(x),
                                            torch.zeros(())))
    want = np.asarray(jax.nn.softplus(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=2.5e-7, atol=1e-30)


def test_ssm_paths_take_no_einsum(monkeypatch):
    """The reference's three- and four-operand einsums are pairwise
    products in a fixed order here: no ``torch.einsum`` (whose path
    ``opt_einsum`` may choose) runs in any mode of the Mamba2 block or
    the RWKV mixes."""
    from repro_torch.models import rwkv6

    def banned(*a, **k):
        raise AssertionError("torch.einsum on an SSM path")
    monkeypatch.setattr(torch, "einsum", banned)
    _, pcfg = _cfgs()
    tp = mamba2.mamba2_init(torch.Generator().manual_seed(0), pcfg, "cpu")
    x = torch.randn(2, 20, pcfg.d_model)
    mamba2.mamba2_forward(tp, pcfg, x)
    _, st = mamba2.mamba2_forward(tp, pcfg, x, return_state=True)
    mamba2.mamba2_forward(tp, pcfg, x[:, :1], state=st)
    rcfg = registry.smoke_config("rwkv6-1.6b")
    rp = rwkv6.rwkv6_init(torch.Generator().manual_seed(0), rcfg, "cpu")
    st = rwkv6.rwkv6_block_state(rcfg, 2, "cpu")
    x = torch.randn(2, 5, rcfg.d_model)
    rwkv6.time_mix(rp, rcfg, x, st)
    rwkv6.channel_mix(rp, rcfg, x, st)


def perturbed_port(arch, seed=0):
    """The port's float32 SMOKE LM of ``arch`` from ``seed``, its
    constant-initialised leaves drawn as ``perturb_ssm`` draws them."""
    from repro_torch.models.lm import LM
    port = LM(registry.smoke_config(arch), device="cpu", seed=seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.rsplit(".", 1)[-1] in SSM_NOISE:
                lo, hi = SSM_NOISE[name.rsplit(".", 1)[-1]]
                p.copy_(torch.from_numpy(rng.uniform(lo, hi, tuple(p.shape))
                                         .astype(np.float32)))
    return port


def _lm_decode_vs_prefill(arch, s, corrupt=None):
    """|logits of (prefill s tokens, decode token s) - logits of prefill
    s + 1 tokens|, float32 SMOKE with perturbed leaves; ``corrupt(cache)``
    runs on the cache between prefill and decode."""
    port = perturbed_port(arch)
    toks = np.random.default_rng(3).integers(
        1, port.cfg.vocab, (2, s + 1)).astype(np.int32)
    _, cache = port.prefill(toks[:, :s], s + 4)
    if corrupt is not None:
        corrupt(cache)
    inc, _ = port.decode(cache, torch.from_numpy(toks[:, s]))
    full, _ = port.prefill(toks, s + 4)
    return float((inc - full).abs().max())


def _zero_ssm(cache):
    for seg in ("mamba_group", "mamba_tail"):
        node = cache[seg]["mambas"] if seg == "mamba_group" else cache[seg]
        node["m"]["ssm"].zero_()


def _unshifted_conv(cache):
    """The cached conv inputs [c0, c1, c2, c3] moved one row back to [c0,
    c0, c1, c2], so decode's shift leaves [c0, c1, c2, new]: the window of
    a decode that wrote its input without shifting out the oldest."""
    for seg in ("mamba_group", "mamba_tail"):
        node = cache[seg]["mambas"] if seg == "mamba_group" else cache[seg]
        conv = node["m"]["conv"]
        conv[..., 1:, :] = conv[..., :-1, :].clone()


@pytest.mark.parametrize("corrupt,holds", [(None, True), (_zero_ssm, False),
                                           (_unshifted_conv, False)])
def test_decode_after_prefill_equals_longer_prefill(corrupt, holds):
    """The O(1) conv and SSM decode state against the chunked scan: S
    tokens then one decode step give the last logits of a prefill of S + 1
    (float32, 1e-4); the controls (SSM state zeroed, conv buffer not
    shifted) must lie beyond it."""
    err = _lm_decode_vs_prefill(ARCH, 12, corrupt)
    assert (err <= 1e-4) if holds else (err > 1e-3), err
