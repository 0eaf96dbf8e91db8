"""K6 and K7, the port's flash-attention backward, against the reference.

On CPU tensors the bindings take the kernels' plain PyTorch version
(``flash_cuda.flash_bwd_plain``), and ``ops.FlashAttention`` (K5 forward,
K6/K7 backward) runs it under ``torch.autograd``. Two references: the
Pallas backward ``flash_attention_bwd_blocks`` in interpret mode, fed the
same (q, k, v, out, lse, do), and ``jax.grad`` of the reference's
``ops.flash_attention`` (its custom_vjp). Inputs are made with numpy from
a seed and handed to both. Tolerances are the reference sweep's: f32 2e-5,
bf16 2e-2. ``gradcheck`` holds the Function to finite differences in
float64. The ``gpu``-marked test holds the CUDA kernels against the plain
version on the card and skips here; the reference is imported by a
fixture, so the file collects on the card's machine, which has no JAX.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_cuda, ops

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
SHAPES = [(64, 4, 4, 32),        # MHA
          (128, 8, 2, 64),       # GQA 4:1
          (256, 4, 1, 64),       # MQA
          (96, 2, 2, 80)]        # ragged seq + odd head dim


@pytest.fixture(scope="module")
def jref():
    import jax
    import jax.numpy as jnp
    from repro.kernels import flash_attention as rfa
    from repro.kernels import ops as rops
    return jax, jnp, rfa, rops


def _arrays(seed, b, h, hkv, s, d):
    """q, k, v, do as float32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, s, d)).astype(np.float32) * 1.0,
            rng.normal(size=(b, hkv, s, d)).astype(np.float32) * 0.5,
            rng.normal(size=(b, hkv, s, d)).astype(np.float32),
            rng.normal(size=(b, h, s, d)).astype(np.float32))


def _both(jnp, arrays, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _tensor(jnp, x):
    """A JAX array as a torch tensor of the same dtype and values."""
    a = np.asarray(x.astype(jnp.float32))
    t = torch.from_numpy(a.copy())
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("s,h,hkv,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bwd_matches_pallas_bwd(jref, s, h, hkv, d, causal, dtype):
    """flash_bwd_plain on the reference forward's own out and lse equals
    the Pallas backward kernels (interpret mode), dq, dk and dv."""
    _, jnp, rfa, _ = jref
    arrays = _arrays(s + 3 * h + d, 2, h, hkv, s, d)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(jnp, arrays, dtype)
    blk = 32 if s % 64 else 64
    kw = dict(sm_scale=d ** -0.5, causal=causal, bq=blk, bk=blk,
              interpret=True)
    out, lse = rfa.flash_attention_blocks(jq, jk, jv, **kw)
    want = rfa.flash_attention_bwd_blocks(jq, jk, jv, out, lse, jdo, **kw)
    got = flash_cuda.flash_bwd_plain(
        tq, tk, tv, _tensor(jnp, out), torch.from_numpy(np.asarray(lse)),
        tdo, sm_scale=d ** -0.5, causal=causal)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    for name, g, w, t in zip("qkv", got, want, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        np.testing.assert_allclose(_np(g), _np(w), **tol, err_msg=f"d{name}")


@pytest.mark.parametrize("s,h,hkv,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_matches_jax_grad(jref, s, h, hkv, d, causal, dtype):
    """Gradients through ``ops.flash_attention`` (the Function) equal
    ``jax.grad`` through the reference's ``ops.flash_attention``."""
    jax, jnp, _, rops = jref
    arrays = _arrays(7 * s + h + d, 1, h, hkv, s, d)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(jnp, arrays, dtype)

    def loss(q, k, v):
        out = rops.flash_attention(q, k, v, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, causal=causal, device="cpu")
    torch.sum(out.float() * tdo.float()).backward()
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    for name, t, w in zip("qkv", leaves, want):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(_np(t.grad), _np(w), **tol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("window", [16, 64])
def test_autograd_sliding_window_matches_jax_grad(jref, window):
    jax, jnp, _, rops = jref
    arrays = _arrays(window, 1, 2, 2, 128, 64)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(jnp, arrays, "float32")

    def loss(q, k, v):
        return jnp.sum(rops.flash_attention(q, k, v, causal=True,
                                            window=window) * jdo)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, causal=True, window=window,
                              device="cpu")
    torch.sum(out * tdo).backward()
    for name, t, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(_np(t.grad), _np(w), **F32_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 3), (False, 4)])
def test_gradcheck_float64(causal, window):
    """The Function's gradients against finite differences, in float64 on
    the CPU, with GQA (4 query heads over 2 kv heads) and a ragged S."""
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((1, n, 7, 32), generator=gen,
                           dtype=torch.float64, requires_grad=True)
               for n in (4, 2, 2))

    def f(q, k, v):
        return ops.FlashAttention.apply(q, k, v, 0.3, causal, window)

    assert torch.autograd.gradcheck(f, (q, k, v))


def test_bindings_agree_with_plain_bwd():
    """On CPU tensors ``flash_bwd_dq`` and ``flash_bwd_dkv`` take the
    plain version from lse and dd = rowsum(do * out), and ``flash_bwd``
    is exactly ``flash_bwd_plain``; no launch is counted."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(1, 2, 4, 2, 50, 32))
    kw = dict(sm_scale=0.2, causal=True, window=20, kv_len=40)
    out, lse = flash_cuda.flash_fwd(q, k, v, **kw)
    dd = torch.sum(do * out, dim=-1)
    before = dict(flash_cuda.LAUNCHES)
    want = flash_cuda.flash_bwd_plain(q, k, v, out, lse, do, **kw)
    got = flash_cuda.flash_bwd(q, k, v, out, lse, do, **kw)
    dq = flash_cuda.flash_bwd_dq(q, k, v, do, lse, dd, **kw)
    dk, dv = flash_cuda.flash_bwd_dkv(q, k, v, do, lse, dd, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)
    assert flash_cuda.LAUNCHES == before


def test_masked_rows_and_keys_get_zero_gradient():
    """Queries with no valid key (kv_len 0) get dq = 0, and keys past
    kv_len get dk = dv = 0: p is 0 there, not exp(NEG_BIG - lse)."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(2, 1, 2, 1, 20, 32))
    for kv_len in (0, 9):
        out, lse = flash_cuda.flash_fwd_plain(q, k, v, sm_scale=0.2,
                                              kv_len=kv_len)
        dq, dk, dv = flash_cuda.flash_bwd_plain(q, k, v, out, lse, do,
                                                sm_scale=0.2, kv_len=kv_len)
        assert torch.isfinite(dq).all() and torch.isfinite(dk).all()
        assert torch.equal(dk[:, :, kv_len:], torch.zeros_like(dk[:, :, kv_len:]))
        assert torch.equal(dv[:, :, kv_len:], torch.zeros_like(dv[:, :, kv_len:]))
        if kv_len == 0:
            assert torch.equal(dq, torch.zeros_like(dq))
        else:
            assert dq[:, :, :kv_len].abs().sum() > 0


def test_gqa_group_sums_into_its_kv_head():
    """dk and dv of a kv head are the sums over the query heads of its
    group: equal to the gradients of the same attention with k and v
    repeated per query head, summed back."""
    q, k, v, do = (torch.from_numpy(a).double()
                   for a in _arrays(3, 1, 6, 2, 33, 32))
    out, lse = flash_cuda.flash_fwd_plain(q, k, v, sm_scale=0.3)
    dq, dk, dv = flash_cuda.flash_bwd_plain(q, k, v, out, lse, do,
                                            sm_scale=0.3)
    kr, vr = (torch.repeat_interleave(t, 3, dim=1) for t in (k, v))
    _, dkr, dvr = flash_cuda.flash_bwd_plain(q, kr, vr, out, lse, do,
                                             sm_scale=0.3)
    torch.testing.assert_close(dk, dkr.reshape(1, 2, 3, 33, 32).sum(2))
    torch.testing.assert_close(dv, dvr.reshape(1, 2, 3, 33, 32).sum(2))


def test_backward_operands_are_checked():
    """What the card wrappers check before a launch (``_bwd_operands``,
    run here on CPU tensors): do matching q, lse and dd as (B, H, Sq)
    float32, a whole GQA group, a built head dim; a do with a strided head
    dim is copied, a contiguous one is used in place."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(5, 1, 4, 2, 8, 32))
    lse, dd = torch.zeros((1, 4, 8)), torch.zeros((1, 4, 8))
    ok = flash_cuda._bwd_operands(q, k, v, do, lse, dd, 8, None)
    assert ok[0] is do
    with pytest.raises(ValueError, match="must match q"):
        flash_cuda._bwd_operands(q, k, v, do[:, :2], lse, dd, 8, None)
    with pytest.raises(ValueError, match="lse must be float32"):
        flash_cuda._bwd_operands(q, k, v, do, lse[..., :4], dd, 8, None)
    with pytest.raises(ValueError, match="dd must be float32"):
        flash_cuda._bwd_operands(q, k, v, do, lse, dd.double(), 8, None)
    with pytest.raises(ValueError, match="multiple"):
        flash_cuda._bwd_operands(q[:, :3], k, v, do[:, :3], lse[:, :3],
                                 dd[:, :3], 8, None)
    with pytest.raises(ValueError, match="head dim 16 not supported"):
        flash_cuda._bwd_operands(q[..., :16], k[..., :16], v[..., :16],
                                 do[..., :16], lse, dd, 8, None)
    strided = torch.from_numpy(_arrays(6, 1, 4, 2, 8, 64)[3])[..., ::2]
    got = flash_cuda._bwd_operands(q, k, v, strided, lse, dd, 8, None)[0]
    assert got.stride(3) == 1 and torch.equal(got, strided)


@pytest.mark.parametrize("name", [flash_cuda.DQ, flash_cuda.DKV])
def test_c_signatures_match_bindings(name):
    """Each C entry point takes as many parameters as its binding declares,
    pointers where the binding passes c_void_p; the source instantiates
    every supported head dim."""
    src = flash_cuda.BWD_LIBRARY.source.read_text()
    m = re.search(rf"int {name}\(([^)]*)\)", src)
    params = [p.strip() for p in m.group(1).split(",")]
    argtypes = flash_cuda.BWD_SIGNATURES[name]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is flash_cuda._P), p
    for d in flash_cuda.HEAD_DIMS:
        assert f"case {d}: return launch<T, {d}>" in src


# a head dim the kernels do not take, with and without a window
PAD_CASES = [(d, w) for d in (8, 16, 48) for w in (None, 16)]


@pytest.mark.parametrize("d,window", PAD_CASES)
def test_padded_head_dim_grads_equal_plain(d, window):
    """Through ops.flash_attention's zero padding of D (8, 16 -> 32;
    48 -> 64) and the slice back, autograd gives dq, dk and dv of shape D
    equal to the plain backward at D (sm_scale 1/sqrt(D) of the unpadded
    D)."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(d, 2, 4, 2, 70, d))
    kw = dict(sm_scale=d ** -0.5, causal=True, window=window)
    out, lse = flash_cuda.flash_fwd_plain(q, k, v, **kw)
    want = flash_cuda.flash_bwd_plain(q, k, v, out, lse, do, **kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = ops.flash_attention(*leaves, causal=True, window=window,
                              device="cpu")
    torch.sum(got * do).backward()
    for name, t, w in zip("qkv", leaves, want):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(_np(t.grad), _np(w), **F32_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("d,window", PAD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_head_dim_grads_match_jax_grad(jref, d, window, dtype):
    """The same gradients against ``jax.grad`` through the reference's
    padding wrapper (D padded to 128 lanes), in interpret mode."""
    jax, jnp, _, rops = jref
    arrays = _arrays(5 * d + 2, 1, 4, 2, 70, d)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(jnp, arrays, dtype)

    def loss(q, k, v):
        out = rops.flash_attention(q, k, v, causal=True, window=window)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, causal=True, window=window,
                              device="cpu")
    torch.sum(out.float() * tdo.float()).backward()
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    for name, t, w in zip("qkv", leaves, want):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(_np(t.grad), _np(w), **tol,
                                   err_msg=f"d{name}")


# Head dims above 128: 256 (gemma-7b), and 136 and 192, which pad to 256.
# S = 160 is ragged for both packages' tiles; GQA groups of 1 (gemma's MHA)
# and 4.
WIDE_CASES = [(d, g, w) for d in (256, 136, 192) for g in (1, 4)
              for w in (None, 64)]


@pytest.mark.parametrize("d,group,window", WIDE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_head_dim_grads_match_jax_grad(jref, d, group, window, dtype):
    """dq, dk and dv through ops.flash_attention at head dims above 128
    (D = 256 as it is, 136 and 192 zero-padded to 256) against
    ``jax.grad`` through the reference's padding wrapper, in interpret
    mode."""
    jax, jnp, _, rops = jref
    arrays = _arrays(3 * d + group, 1, 4, 4 // group, 160, d)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(jnp, arrays, dtype)

    def loss(q, k, v):
        out = rops.flash_attention(q, k, v, causal=True, window=window)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, causal=True, window=window,
                              device="cpu")
    torch.sum(out.float() * tdo.float()).backward()
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    for name, t, w in zip("qkv", leaves, want):
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape
        np.testing.assert_allclose(_np(t.grad), _np(w), **tol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bwd_at_head_dim_256_matches_pallas_bwd(jref, group, dtype):
    """flash_bwd_plain at D = 256, on the reference forward's own out and
    lse, equals the Pallas backward kernels in interpret mode."""
    _, jnp, rfa, _ = jref
    d = 256
    arrays = _arrays(group + 5, 1, 4, 4 // group, 128, d)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(jnp, arrays, dtype)
    kw = dict(sm_scale=d ** -0.5, causal=True, bq=64, bk=64, interpret=True)
    out, lse = rfa.flash_attention_blocks(jq, jk, jv, **kw)
    want = rfa.flash_attention_bwd_blocks(jq, jk, jv, out, lse, jdo, **kw)
    got = flash_cuda.flash_bwd_plain(
        tq, tk, tv, _tensor(jnp, out), torch.from_numpy(np.asarray(lse)),
        tdo, sm_scale=d ** -0.5, causal=True)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(_np(g), _np(w), **tol, err_msg=f"d{name}")


# --- on the card ----------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("causal,window,dtype,s", [
    (True, None, torch.bfloat16, 1000), (False, None, torch.float32, 256),
    (True, 64, torch.bfloat16, 512), (True, None, torch.float32, 333)])
def test_cuda_flash_bwd_matches_plain(causal, window, dtype, s):
    """K6 and K7 against the plain backward on the same card inputs, for
    every head dim, through the autograd Function (K5 forward). bf16
    gradients may differ by one ulp (2**-7 |want|, plus 1e-4 near 0) on at
    most 1% of the elements; float32 within 1e-4 of the largest |grad|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for d in flash_cuda.HEAD_DIMS:
        q, k, v, do = (torch.from_numpy(a).to(dev, dtype)
                       for a in _arrays(d + s, 2, 8, 2, s, d))
        q = q * 2
        kw = dict(sm_scale=d ** -0.5, causal=causal, window=window)
        out, lse = flash_cuda.flash_fwd(q, k, v, **kw)
        before = dict(flash_cuda.LAUNCHES)
        got = flash_cuda.flash_bwd(q, k, v, out, lse, do, **kw)
        want = flash_cuda.flash_bwd_plain(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        assert flash_cuda.LAUNCHES[flash_cuda.DQ] == before[flash_cuda.DQ] + 1
        assert flash_cuda.LAUNCHES[flash_cuda.DKV] == \
            before[flash_cuda.DKV] + 1
        for g, w in zip(got, want):
            g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
            if dtype == torch.bfloat16:
                np.testing.assert_allclose(g, w, atol=1e-4, rtol=2 ** -7)
                assert float(np.mean(g != w)) <= 1e-2
            else:
                np.testing.assert_allclose(
                    g, w, atol=1e-4 * float(np.abs(w).max()), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_bwd_strided_view(dtype):
    """K6 and K7 on (B, S, H, D) tensors seen through transpose(1, 2), as
    the model hands them over, for every head dim and a ragged S, against
    the plain backward on the same views; dk and dv come out in k's
    layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda")
    for d in flash_cuda.HEAD_DIMS:
        rng = np.random.default_rng(d + 1)
        q, k, v, do = (torch.from_numpy(
            rng.normal(size=(1, 300, n, d)).astype(np.float32) * sd).to(
                dev, dtype).transpose(1, 2)
            for n, sd in ((8, 2.0), (2, 1.0), (2, 1.0), (8, 1.0)))
        kw = dict(sm_scale=d ** -0.5, causal=True, window=None)
        out, lse = flash_cuda.flash_fwd(q, k, v, **kw)
        got = flash_cuda.flash_bwd(q, k, v, out, lse, do, **kw)
        want = flash_cuda.flash_bwd_plain(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        assert got[1].stride() == k.stride() and got[2].stride() == v.stride()
        for g, w in zip(got, want):
            g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
            if dtype == torch.bfloat16:
                np.testing.assert_allclose(g, w, atol=1e-4, rtol=2 ** -7)
                assert float(np.mean(g != w)) <= 1e-2
            else:
                np.testing.assert_allclose(
                    g, w, atol=1e-4 * float(np.abs(w).max()), rtol=0)


@pytest.mark.gpu
def test_cuda_flash_bwd_rejects_misaligned_bf16():
    """A bf16 do whose data pointer is off 16 bytes (a cp.async of K7
    would read it out of line) raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda")
    q = torch.randn((1, 4, 8, 32), device=dev).to(torch.bfloat16)
    k, v = (torch.randn((1, 2, 8, 32), device=dev).to(torch.bfloat16)
            for _ in range(2))
    out, lse = flash_cuda.flash_fwd(q, k, v, sm_scale=0.2)
    do = torch.zeros(q.numel() + 1, dtype=torch.bfloat16,
                     device=dev)[1:].view(q.shape)
    dd = torch.zeros(lse.shape, device=dev)
    before = dict(flash_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="16"):
        flash_cuda.flash_bwd_dkv(q, k, v, do, lse, dd, sm_scale=0.2)
    with pytest.raises(ValueError, match="16"):
        flash_cuda.flash_bwd(q, k, v, out, lse, do, sm_scale=0.2)
    assert flash_cuda.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_bwd_bidirectional_at_whisper_encoder_shape(dtype):
    """K6 and K7 with causal=False at head dim 64 and Sq = Skv = 1500
    (whisper-base's encoder in training: 8 heads, 1500 frames) against the
    plain backward, through the autograd Function's bindings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda")
    q, k, v, do = (torch.from_numpy(a).to(dev, dtype)
                   for a in _arrays(64, 2, 8, 8, 1500, 64))
    q = q * 2
    kw = dict(sm_scale=64 ** -0.5, causal=False, window=None)
    out, lse = flash_cuda.flash_fwd(q, k, v, **kw)
    before = dict(flash_cuda.LAUNCHES)
    got = flash_cuda.flash_bwd(q, k, v, out, lse, do, **kw)
    want = flash_cuda.flash_bwd_plain(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash_cuda.LAUNCHES[flash_cuda.DQ] == before[flash_cuda.DQ] + 1
    assert flash_cuda.LAUNCHES[flash_cuda.DKV] == before[flash_cuda.DKV] + 1
    for g, w in zip(got, want):
        g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
        if dtype == torch.bfloat16:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=2 ** -7)
            assert float(np.mean(g != w)) <= 1e-2
        else:
            np.testing.assert_allclose(
                g, w, atol=1e-4 * float(np.abs(w).max()), rtol=0)
