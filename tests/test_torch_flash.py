"""K5, the port's flash-attention forward, against the reference.

The port's ``ops.flash_attention`` runs here on CPU tensors, where the
kernel binding takes the kernel's plain PyTorch version
(``flash_cuda.flash_fwd_plain``); the reference's ``ops.flash_attention``
runs its Pallas kernel in interpret mode, as tests/test_kernels.py runs it.
Inputs are made with numpy from a seed and handed to both. Tolerances are
the reference sweep's: f32 2e-5, bf16 2e-2 (one bf16 ulp of the output).
The ``gpu``-marked test holds the CUDA kernel against its plain version on
the card and skips here. The card's machine has no JAX, so the reference
is imported by a fixture: the file collects there and ``-m gpu`` selects
the card test alone.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_cuda, ops

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(scope="module")
def jref():
    import jax.numpy as jnp
    from repro.kernels import ops as rops
    return jnp, rops


def _qkv(seed, b, h, hkv, s, d, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.normal(size=(b, h, s, d)).astype(np.float32) * 0.5,
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32) * 0.5,
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32) * 0.5)


def _both(jnp, arrays, dtype):
    """The same values as JAX and torch arrays of ``dtype`` (float32 or
    bfloat16; both round to nearest even)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("s,h,hkv,d", [
    (64, 4, 4, 32),          # MHA
    (128, 8, 2, 64),         # GQA 4:1
    (256, 4, 1, 64),         # MQA
    (96, 2, 2, 80),          # ragged seq + odd head dim
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_sweep_matches_reference(jref, s, h, hkv, d, causal, dtype):
    jnp, rops = jref
    arrays = _qkv(s + h * 7 + d, 2, h, hkv, s, d)
    (jq, jk, jv), (tq, tk, tv) = _both(jnp, arrays, dtype)
    want = rops.flash_attention(jq, jk, jv, causal=causal)
    got = ops.flash_attention(tq, tk, tv, causal=causal, device="cpu")
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("window", [16, 64])
def test_flash_sliding_window_matches_reference(jref, window):
    jnp, rops = jref
    arrays = _qkv(9, 1, 2, 2, 128, 64)
    (jq, jk, jv), (tq, tk, tv) = _both(jnp, arrays, "float32")
    want = rops.flash_attention(jq, jk, jv, causal=True, window=window)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                              device="cpu")
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_flash_matches_model_sdpa(jref):
    """K5 semantics == the reference model's einsum ``_sdpa`` (B, S, H, D),
    and == the port's own ``_sdpa``: the (B, Hkv, G) grouping of ``_sdpa``
    and K5's kv head h // G agree."""
    from repro.models.layers import _sdpa as ref_sdpa

    from repro_torch.models.layers import _sdpa
    jnp, _ = jref
    rng = np.random.default_rng(13)
    B, S, H, HKV, D = 2, 64, 4, 2, 32
    q = rng.normal(size=(B, S, H, D)).astype(np.float32) * 0.5
    k = rng.normal(size=(B, S, HKV, D)).astype(np.float32) * 0.5
    v = rng.normal(size=(B, S, HKV, D)).astype(np.float32) * 0.5
    want = np.asarray(ref_sdpa(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, window=None))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), causal=True, device="cpu")
    np.testing.assert_allclose(_np(got.transpose(1, 2)), want, **F32_TOL)
    port = _sdpa(tq, tk, tv, causal=True, window=None)
    np.testing.assert_allclose(_np(port), want, **F32_TOL)


@pytest.mark.parametrize("causal,window,kv_len", [
    (True, None, None), (False, None, 70), (True, 16, None), (True, 8, 50)])
def test_plain_lse_is_logsumexp(causal, window, kv_len):
    """The plain version's lse is the logsumexp of the scaled, masked
    logits (float64 oracle), and its out the softmax-weighted values, on
    every query with a valid key (the rest: see the next test)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 4, 2, 96, 32))
    scale = 32 ** -0.5
    out, lse = flash_cuda.flash_fwd_plain(q, k, v, sm_scale=scale,
                                          causal=causal, window=window,
                                          kv_len=kv_len)
    kk = torch.repeat_interleave(k.double(), 2, dim=1)
    vv = torch.repeat_interleave(v.double(), 2, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.double(), kk) * scale
    ok = flash_cuda.mask(96, 96, causal=causal, window=window,
                         kv_len=96 if kv_len is None else kv_len,
                         device="cpu")
    logits = torch.where(ok, logits, -torch.inf)
    has = ok.any(-1)
    assert has.any()
    np.testing.assert_allclose(lse[..., has].numpy(),
                               torch.logsumexp(logits, -1)[..., has].numpy(),
                               atol=2e-5, rtol=2e-5)
    probs = torch.softmax(logits[..., has, :], -1)
    np.testing.assert_allclose(out[..., has, :].numpy(),
                               torch.einsum("bhqk,bhkd->bhqd", probs,
                                            vv).numpy(), **F32_TOL)


def test_plain_fully_masked_rows_are_zero():
    """A query with no valid key (kv_len 0) gives out 0 and
    lse = NEG_BIG + log(1e-30), as the Pallas kernel's finish step does."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 2, 1, 8, 32))
    out, lse = flash_cuda.flash_fwd_plain(q, k, v, sm_scale=0.2,
                                          causal=True, kv_len=0)
    assert torch.equal(out, torch.zeros_like(out))
    np.testing.assert_allclose(
        lse.numpy(), np.float32(flash_cuda.NEG_BIG) + np.log(np.float32(1e-30)))


def test_wrapper_rejects_bad_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 3, 2, 8, 32))
    with pytest.raises(ValueError, match="multiple"):
        flash_cuda.flash_fwd(q, k, v, sm_scale=1.0)
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 4, 2, 8, 32))
    with pytest.raises(ValueError, match="kv_len"):
        flash_cuda.flash_fwd(q, k, v, sm_scale=1.0, kv_len=9)
    with pytest.raises(ValueError, match="window"):
        flash_cuda.flash_fwd(q, k, v, sm_scale=1.0, window=0)
    with pytest.raises(TypeError, match="dtypes"):
        flash_cuda.flash_fwd(q, k.double(), v, sm_scale=1.0)
    with pytest.raises(ValueError, match="not supported"):
        flash_cuda.flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"),
                             sm_scale=1.0)


def test_c_signature_matches_binding():
    """The C entry point takes as many parameters as the binding declares,
    pointers where the binding passes c_void_p; the source instantiates
    every supported head dim."""
    src = flash_cuda.LIBRARY.source.read_text()
    m = re.search(rf"int {flash_cuda.NAME}\(([^)]*)\)", src)
    params = [p.strip() for p in m.group(1).split(",")]
    argtypes = flash_cuda.SIGNATURES[flash_cuda.NAME]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is flash_cuda._P), p
    for d in flash_cuda.HEAD_DIMS:
        assert f"case {d}: return launch<T, {d}>" in src


@pytest.mark.parametrize("name,params", [
    (flash_cuda.SMEM, ["int dtype", "int d"]),
    (flash_cuda.BWD_SMEM, ["int dtype", "int d", "int dkv"])])
def test_smem_queries_match_bindings(name, params):
    """The shared-memory queries take the (int) arguments the bindings
    declare, and switch over every supported head dim."""
    lib = flash_cuda.LIBRARY if name == flash_cuda.SMEM \
        else flash_cuda.BWD_LIBRARY
    src = lib.source.read_text()
    m = re.search(rf"int {name}\(([^)]*)\)", src)
    assert [p.strip() for p in m.group(1).split(",")] == params
    assert lib.signatures[name] == [flash_cuda._I] * len(params)
    for d in flash_cuda.HEAD_DIMS:
        assert f"case {d}: return " in src


# a head dim the kernels do not take, with and without a window; 112 is
# zamba2-7b's (3584 / 32), padded to 128
PAD_CASES = [(d, w) for d in (8, 16, 48, 112) for w in (None, 16)]


def test_padded_head_dim():
    """The smallest head dim the kernels take that holds D: D in (128, 256]
    pads to 256, as the reference pads to a multiple of 128 lanes; above
    256 (the reference would pad to 384) none does."""
    assert [ops.padded_head_dim(d) for d in (1, 8, 32, 33, 48, 64, 72, 80,
                                              100, 128, 129, 136, 192,
                                              256)] == \
        [32, 32, 32, 64, 64, 64, 80, 80, 128, 128, 256, 256, 256, 256]
    with pytest.raises(ValueError, match="head dim 257 > 256"):
        ops.padded_head_dim(257)
    q = torch.zeros((1, 2, 8, 257))
    with pytest.raises(ValueError, match="head dim 257 > 256"):
        ops.flash_attention(q, q, q, device="cpu")


@pytest.mark.parametrize("d,window", PAD_CASES)
def test_padded_head_dim_equals_plain(d, window):
    """ops.flash_attention zero-pads q, k, v along D to the next head dim
    the kernels take (8, 16 -> 32; 48 -> 64; 112 -> 128) with
    sm_scale = 1/sqrt(D) of
    the unpadded D, and slices out back: the plain version at D."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(d, 2, 4, 2, 70, d))
    got = ops.flash_attention(q, k, v, causal=True, window=window,
                              device="cpu")
    want, _ = flash_cuda.flash_fwd_plain(q, k, v, sm_scale=d ** -0.5,
                                         causal=True, window=window)
    assert got.shape == q.shape and got.dtype == q.dtype
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("d,window", PAD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_head_dim_matches_reference(jref, d, window, dtype):
    """The padded path against the reference's own padding wrapper (it
    pads D to 128 lanes), in interpret mode."""
    jnp, rops = jref
    arrays = _qkv(3 * d + 1, 1, 4, 2, 70, d)
    (jq, jk, jv), (tq, tk, tv) = _both(jnp, arrays, dtype)
    want = rops.flash_attention(jq, jk, jv, causal=True, window=window)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                              device="cpu")
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# Head dims above 128: 256 (gemma-7b), and 136 and 192, which pad to 256.
# S = 160 is ragged for both packages' tiles (the reference pads S to 256
# in interpret mode); GQA groups of 1 (gemma's MHA) and 4.
WIDE_CASES = [(d, g, w) for d in (256, 136, 192) for g in (1, 4)
              for w in (None, 64)]


@pytest.mark.parametrize("d,group,window", WIDE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_head_dim_matches_reference(jref, d, group, window, dtype):
    """Head dims above 128 through ops.flash_attention (D = 256 as it is,
    136 and 192 zero-padded to 256) against the reference's padding
    wrapper in interpret mode."""
    jnp, rops = jref
    arrays = _qkv(d + 7 * group, 1, 4, 4 // group, 160, d)
    (jq, jk, jv), (tq, tk, tv) = _both(jnp, arrays, dtype)
    want = rops.flash_attention(jq, jk, jv, causal=True, window=window)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                              device="cpu")
    assert got.shape == tq.shape and got.dtype == tq.dtype
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("group,window", [(1, None), (4, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_at_head_dim_256_matches_reference(jref, group, window, dtype):
    """K5's lse (and out) at D = 256, from the binding's plain version,
    against the Pallas kernel's own lse in interpret mode, on S padded to
    its tile as the reference's wrapper pads it (kv_len masks the pad)."""
    from repro.kernels import flash_attention as rfa
    jnp, _ = jref
    s, d = 160, 256
    arrays = _qkv(group + 31, 1, 4, 4 // group, s, d)
    (jq, jk, jv), (tq, tk, tv) = _both(jnp, arrays, dtype)
    pad = ((0, 0), (0, 0), (0, 256 - s), (0, 0))
    want, wlse = rfa.flash_attention_blocks(
        *(jnp.pad(t, pad) for t in (jq, jk, jv)), sm_scale=d ** -0.5,
        causal=True, window=window, bq=128, bk=128, kv_len=s,
        interpret=True)
    got, lse = flash_cuda.flash_fwd(tq, tk, tv, sm_scale=d ** -0.5,
                                    causal=True, window=window)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_np(got), _np(want[:, :, :s]), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(wlse)[..., :s],
                               **F32_TOL)


def _misaligned(bad, dtype, b=1, h=4, s=8, d=32, device="cpu"):
    """A (b, h, s, d) view of standard normals whose data pointer
    (``offset``), row stride (d + 1 elements) or head stride (s*d + 1) is
    off 16 bytes in bf16."""
    kw = dict(dtype=dtype, device=device)
    if bad == "offset":
        x = torch.zeros(b * h * s * d + 1, **kw)[1:].view(b, h, s, d)
    elif bad == "row_stride":
        x = torch.zeros((b, h, s, d + 1), **kw)[..., :d]
    else:
        x = torch.zeros((b, h, s * d + 1), **kw)[..., :s * d].view(b, h, s, d)
    gen = torch.Generator().manual_seed(s * d)
    return x.copy_(torch.randn((b, h, s, d), generator=gen))


@pytest.mark.parametrize("bad", ["offset", "row_stride", "head_stride"])
def test_card_checks_reject_misaligned_bf16(bad):
    """The bf16 kernels read 16-byte pieces (TMA in K5, cp.async in K6
    and K7), so the card checks (run here on CPU tensors) raise on bf16
    data whose pointer or batch, head or row stride is not a multiple of
    16 bytes; float32 (the FMA kernels) takes the same layouts."""
    k = torch.zeros((1, 2, 8, 32))
    flash_cuda._check_card(("q", _misaligned(bad, torch.float32)), ("k", k))
    kb = k.to(torch.bfloat16)
    with pytest.raises(ValueError, match="16"):
        flash_cuda._check_card(("q", _misaligned(bad, torch.bfloat16)),
                               ("k", kb))
    flash_cuda._check_card(("q", torch.zeros((1, 4, 8, 32),
                                             dtype=torch.bfloat16)), ("k", kb))


def test_build_key_covers_headers(tmp_path):
    """A library is keyed by its source, every csrc/*.cuh and the flags:
    a changed header (one the source includes) gives another build
    target, so a stale library is never loaded. Hashing needs no nvcc."""
    from repro_torch.kernels import cubuild
    lib = cubuild.CudaLibrary("flash_attention", flash_cuda.SIGNATURES)
    lib.source = tmp_path / "flash_attention.cu"
    lib.source.write_text('#include "mma_bf16.cuh"\n')
    header = tmp_path / "mma_bf16.cuh"
    header.write_text("// one\n")
    first = lib._target()
    assert lib._target() == first
    header.write_text("// two\n")
    assert lib._target() != first
    header.write_text("// one\n")
    assert lib._target() == first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert lib._target() != first


def test_bf16_forward_is_built_on_hopper_primitives():
    """K5's source includes the Hopper primitives (TMA tensor loads,
    wgmma), not the mma.sync helpers K6 and K7 keep; the header holds
    both instructions and the source no longer carries the mma.sync
    forward body. Reading the sources needs no nvcc."""
    csrc = flash_cuda.LIBRARY.source.parent
    src = flash_cuda.LIBRARY.source.read_text()
    includes = re.findall(r'#include "([^"]+)"', src)
    assert "hopper.cuh" in includes and "mma_bf16.cuh" not in includes
    header = (csrc / "hopper.cuh").read_text()
    assert "wgmma.mma_async" in header
    assert "cp.async.bulk.tensor" in header
    for gone in ("fwd_tc", "FwdTc", "mma_bf16::", "ldmatrix"):
        assert gone not in src, gone
    bwd = flash_cuda.BWD_LIBRARY.source.read_text()
    assert '#include "mma_bf16.cuh"' in bwd


# --- on the card ----------------------------------------------------------------
# The bf16 K5's tile edges (128 query rows and 128 keys a tile, 64 keys
# at D = 256): S on both sides of a tile, windows of 48 and 64, kv_len < S
# (negative: S less that many).
EDGE_CASES = [(True, None, torch.bfloat16, s, None) for s in (127, 128, 129)]
EDGE_CASES += [(False, None, torch.bfloat16, 129, None),
               (True, 48, torch.bfloat16, 1000, None),
               (True, 64, torch.bfloat16, 129, None),
               (True, None, torch.bfloat16, 1000, -37),
               (False, None, torch.bfloat16, 128, -37)]


@pytest.mark.gpu
@pytest.mark.parametrize("causal,window,dtype,s,short", [
    (True, None, torch.bfloat16, 1000, None),
    (False, None, torch.float32, 256, None),
    (True, 64, torch.bfloat16, 512, None),
    (True, None, torch.float32, 333, None)] + EDGE_CASES)
def test_cuda_flash_matches_plain(causal, window, dtype, s, short):
    """The CUDA kernel against its plain version on the same card inputs,
    out and lse, for every head dim. q is scaled so that the logits have
    standard deviation 2 and attention is peaked. Both sides are float32
    results rounded once: bf16 out may differ by one ulp (2**-7 |want|,
    plus 1e-4 near 0), on at most 1% of the elements; f32 out and lse by
    2e-5 (another summation order). ``short``: kv_len = S + short."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kv_len = None if short is None else s + short
    for d in flash_cuda.HEAD_DIMS:
        q, k, v = _qkv(d + s, 2, 8, 2, s, d)
        q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in (q * 8, k, v))
        before = flash_cuda.LAUNCHES[flash_cuda.NAME]
        out, lse = flash_cuda.flash_fwd(q, k, v, sm_scale=d ** -0.5,
                                        causal=causal, window=window,
                                        kv_len=kv_len)
        pout, plse = flash_cuda.flash_fwd_plain(
            q, k, v, sm_scale=d ** -0.5, causal=causal, window=window,
            kv_len=kv_len)
        torch.cuda.synchronize()
        assert flash_cuda.LAUNCHES[flash_cuda.NAME] == before + 1
        if dtype == torch.bfloat16:
            np.testing.assert_allclose(_np(out.cpu()), _np(pout.cpu()),
                                       atol=1e-4, rtol=2 ** -7)
            assert float((out != pout).double().mean()) <= 1e-2
        else:
            np.testing.assert_allclose(_np(out.cpu()), _np(pout.cpu()),
                                       **F32_TOL)
        np.testing.assert_allclose(lse.cpu().numpy(), plse.cpu().numpy(),
                                   **F32_TOL)


def _agree(got, want, dtype):
    """bf16: one ulp (2**-7 |want|, plus 1e-4 near 0) on at most 1% of
    the elements; float32: 2e-5."""
    g, w = _np(got.cpu()), _np(want.cpu())
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=2 ** -7)
        assert float(np.mean(g != w)) <= 1e-2
    else:
        np.testing.assert_allclose(g, w, **F32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_strided_view(dtype):
    """A (B, S, H, D) tensor seen through transpose(1, 2), as the model
    hands it over, for every head dim, a ragged S and the bf16 tile's
    edges (S 127, 128, 129, 1000; windows of 48 and 64; kv_len < S): the
    kernel reads the strides in place, writes out in q's layout and agrees
    with the plain version on the same view."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda")
    masks = [dict(causal=True, window=None), dict(causal=True, window=48),
             dict(causal=True, window=64), dict(causal=False, window=None),
             dict(causal=True, window=None, short=-37)]
    for s in (300, 127, 128, 129, 1000):
        for d in flash_cuda.HEAD_DIMS:
            rng = np.random.default_rng(d + s)
            q, k, v = (torch.from_numpy(
                rng.normal(size=(2, s, n, d)).astype(np.float32) * sd).to(
                    dev, dtype).transpose(1, 2)
                for n, sd in ((8, 2.0), (2, 1.0), (2, 1.0)))
            for mask in masks if s != 300 else masks[:1]:
                kw = dict(sm_scale=d ** -0.5, causal=mask["causal"],
                          window=mask["window"])
                if "short" in mask:
                    kw["kv_len"] = s + mask["short"]
                out, lse = flash_cuda.flash_fwd(q, k, v, **kw)
                pout, plse = flash_cuda.flash_fwd_plain(q, k, v, **kw)
                torch.cuda.synchronize()
                assert out.stride() == q.stride()
                _agree(out, pout, dtype)
                np.testing.assert_allclose(lse.cpu().numpy(),
                                           plse.cpu().numpy(), **F32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["offset", "row_stride", "head_stride"])
def test_cuda_flash_rejects_misaligned_bf16(bad):
    """On the card a bf16 q, k or v that a 16-byte cp.async would read out
    of line raises before the launch; float32 in the same layout runs the
    FMA kernel and agrees with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda")
    before = flash_cuda.LAUNCHES[flash_cuda.NAME]
    kv = torch.zeros((1, 2, 8, 32), dtype=torch.bfloat16, device=dev)
    good = dict(q=torch.zeros((1, 4, 8, 32), dtype=torch.bfloat16,
                              device=dev), k=kv, v=kv.clone())
    for name, heads in (("q", 4), ("k", 2), ("v", 2)):
        args = {**good, name: _misaligned(bad, torch.bfloat16, h=heads,
                                          device=dev)}
        with pytest.raises(ValueError, match="16"):
            flash_cuda.flash_fwd(args["q"], args["k"], args["v"],
                                 sm_scale=0.2)
    assert flash_cuda.LAUNCHES[flash_cuda.NAME] == before
    q = _misaligned(bad, torch.float32, device=dev)
    k, v = (_misaligned(bad, torch.float32, h=2, device=dev) for _ in range(2))
    out, lse = flash_cuda.flash_fwd(q, k, v, sm_scale=0.2)
    pout, plse = flash_cuda.flash_fwd_plain(q, k, v, sm_scale=0.2)
    torch.cuda.synchronize()
    _agree(out, pout, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_bidirectional_at_whisper_encoder_shape(dtype):
    """K5 with causal=False at head dim 64 and Sq = Skv = 1500 (whisper-
    base's encoder: 8 heads, 1500 frames; the frames' rows seen through
    transpose(1, 2), as the model hands them over) against its plain
    version: out and lse, every key attended."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1500)
    q, k, v = (torch.from_numpy(
        rng.normal(size=(2, 1500, 8, 64)).astype(np.float32) * sd).to(
            dev, dtype).transpose(1, 2) for sd in (2.0, 1.0, 1.0))
    kw = dict(sm_scale=64 ** -0.5, causal=False, window=None)
    before = flash_cuda.LAUNCHES[flash_cuda.NAME]
    out, lse = flash_cuda.flash_fwd(q, k, v, **kw)
    pout, plse = flash_cuda.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_cuda.LAUNCHES[flash_cuda.NAME] == before + 1
    _agree(out, pout, dtype)
    np.testing.assert_allclose(lse.cpu().numpy(), plse.cpu().numpy(),
                               **F32_TOL)
    causal, _ = flash_cuda.flash_fwd_plain(q, k, v, **dict(kw, causal=True))
    assert float((causal.float() - pout.float()).abs().max()) > 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_at_zamba2_head_dim_112(dtype):
    """zamba2-7b's head dim (112) through ``ops.flash_attention`` on the
    card: q, k, v seen through transpose(1, 2) as the model hands them
    over, zero-padded to the D = 128 instantiation; out and, under
    autograd (K6 and K7), dq, dk, dv sliced back to 112 against the plain
    versions at D = 112, with sm_scale 112**-0.5; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(112)
    q, k, v = (torch.from_numpy(
        rng.normal(size=(2, 300, 4, 112)).astype(np.float32) * sd).to(
            dev, dtype).transpose(1, 2).requires_grad_()
        for sd in (2.0, 1.0, 1.0))
    do = torch.from_numpy(rng.normal(size=(2, 4, 300, 112)).astype(
        np.float32)).to(dev, dtype)
    kw = dict(sm_scale=112 ** -0.5, causal=True, window=None)
    before = dict(flash_cuda.LAUNCHES)
    out = ops.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert {n: flash_cuda.LAUNCHES[n] - before[n] for n in before} == {
        flash_cuda.NAME: 1, flash_cuda.DQ: 1, flash_cuda.DKV: 1}
    assert ops.padded_head_dim(112) == 128
    qd, kd, vd = (t.detach() for t in (q, k, v))
    pout, _ = flash_cuda.flash_fwd_plain(qd, kd, vd, **kw)
    assert out.shape == pout.shape
    _agree(out.detach(), pout, dtype)
    # the plain backward from K5's own out and lse, as the kernels take
    # them (K5 is deterministic: the wrapper's forward gave the same)
    kout, klse = flash_cuda.flash_fwd(
        *(torch.nn.functional.pad(t, (0, 16)) for t in (qd, kd, vd)), **kw)
    for g, w in zip(grads, flash_cuda.flash_bwd_plain(
            qd, kd, vd, kout[..., :112], klse, do, **kw)):
        assert g.shape == w.shape
        if dtype == torch.bfloat16:
            _agree(g, w, dtype)
        else:
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= 1e-4 * scale
