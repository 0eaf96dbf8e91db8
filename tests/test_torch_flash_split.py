"""The numerics of the bf16 tensor-core flash kernels (K5 forward, K6 dq,
K7 dk/dv), emulated in plain torch on the CPU and held against the
reference.

On the card the bf16 kernels run their products on bf16 tensor cores with
float32 sums. q.k^T and do.v^T take bf16 operands as they are (a product
of two bf16 values is exact in float32) and scale s after the product;
p (in P.V and P^T.dO) and ds (in dS.K and dS^T.Q) are float32 results, so
each is cut into hi = bf16(x) and lo = bf16(x - hi) and its product is
taken as hi.B + lo.B. K6 and K7 take p as K5 does, 2^(q.k * c - lse *
log2(e)) with c = scale * log2(e) and the exponent one FFMA, and sum
their outputs tile by tile: each tile's product (K6: a tile of keys, 64;
32 at D = 256; K7: a (query head, tile of 64 queries) pair, heads of the
group in order) is taken fresh and added to the running float32 sum.
This file repeats that arithmetic in torch at a
small size and holds out, lse, dq, dk and dv to the reference
(``ops.flash_attention`` in interpret mode, which pads S, and ``jax.vjp``
through it) by the rule chip_smoke.py holds the kernels to on the card:
bf16 results within one bf16 ulp (2**-7 |want|, plus 1e-4 near 0) on at
most 1% of the elements, lse within 2e-5. The same arithmetic without the
split (p or ds rounded to bf16 once, in any one of the four products)
must fail that rule, so the rule sees the split. A split that fails here
will fail on the card.

Sizes: B=1, H=4, Hkv=2, S=200, D=32, bf16, q drawn at standard deviation 2
(chip_smoke's K5_Q_STD, so attention is peaked) and k, v, do at 1; causal,
and causal with window 16. At this size the split leaves 0.1-0.4% of the
elements one ulp off (dq 0.3%) and every unsplit control already fails
(24-41% of its elements differ; dq's 38-41%), so S stays 200. The same
holds at D = 256, gemma-7b's head dim, which the ``*_at_head_dim_256``
tests check: there K6 takes tiles of 32 keys (``k6_keys``), and the
kernels take their outputs in chunks of 64 columns, which moves no
rounding point of this arithmetic.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_cuda

B, H, HKV, S, D = 1, 4, 2, 200, 32
Q_STD = 2.0
# chip_smoke.py's agreement rule
BF16_ATOL, BF16_RTOL, BF16_FLIP_SHARE = 1e-4, 2 ** -7, 1e-2
F32_TOL = 2e-5


def _inputs(d=D):
    rng = np.random.default_rng(14 if d == D else d)
    q = rng.normal(size=(B, H, S, d)).astype(np.float32) * Q_STD
    k, v = (rng.normal(size=(B, HKV, S, d)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, H, S, d)).astype(np.float32)
    return q, k, v, do


def _bf16(a):
    """numpy float32 -> torch bf16 (round to nearest even, as JAX)."""
    return torch.from_numpy(a).to(torch.bfloat16)


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _product(x, y, split):
    """x . y in float32 with x cut into bf16 halves, or rounded once."""
    if not split:
        return torch.matmul(x.to(torch.bfloat16).float(), y)
    hi, lo = _split(x)
    return torch.matmul(hi, y) + torch.matmul(lo, y)


def _operands(q, k, v, window):
    """float32 q, k and v (k, v repeated over the GQA group), the mask,
    the products q.k and the scaled scores s = (q.k) * scale."""
    g = H // HKV
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(g, dim=1) for t in (k, v))
    ok = flash_cuda.mask(S, S, causal=True, window=window, kv_len=S,
                         device="cpu")
    qk = torch.matmul(qf, kf.transpose(-1, -2))
    return qf, kf, vf, ok, qk, qk * q.shape[-1] ** -0.5


LOG2E = np.float32(1.4426950408889634)
K7_BQ = 64                    # queries a K7 tile


def k6_keys(d):
    """Keys a K6 tile at head dim d."""
    return 32 if d > 128 else 64


def _probs(qk, lse, ok, d):
    """The backward kernels' p: 2^(q.k * c - lse * log2(e)), c and lse *
    log2(e) float32 products, the exponent one rounding (an FFMA), 0 off
    the mask."""
    c = float(np.float32(d ** -0.5) * LOG2E)
    l2 = lse * torch.tensor(LOG2E)
    x = (qk.double() * c - l2.double()[..., None]).float()
    return torch.where(ok, torch.exp2(x), 0.0)


def _tiled(x, y, tile, split):
    """x . y over x's last axis, one tile of it at a time: each tile's
    product fresh, added to the float32 sum in order."""
    acc = None
    for n0 in range(0, x.shape[-1], tile):
        part = _product(x[..., n0:n0 + tile], y[..., n0:n0 + tile, :], split)
        acc = part if acc is None else acc + part
    return acc


def emulate_fwd(q, k, v, *, window, split_pv=True):
    """K5's bf16 arithmetic: (out bf16, lse float32), p split in P.V."""
    _, _, vf, ok, _, s = _operands(q, k, v, window)
    m = torch.amax(torch.where(ok, s, flash_cuda.NEG_BIG), -1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    lm = torch.clamp_min(torch.sum(p, -1, keepdim=True), 1e-30)
    out = (_product(p, vf, split_pv) / lm).to(torch.bfloat16)
    return out, (m + torch.log(lm))[..., 0]


def emulate_bwd(q, k, v, do, out, lse, *, window, split_dsk=True,
                split_pdo=True, split_dsq=True):
    """K6's and K7's bf16 arithmetic from a forward's out and lse: dq, and
    (dk, dv) summed over each GQA group, all bf16; p from q.k by
    ``_probs``, ds split in dS.K (K6) and dS^T.Q (K7), p in P^T.dO (K7);
    dq summed over K6's key tiles, dk and dv over K7's (query head, query
    tile) pairs, each tile fresh."""
    qf, kf, vf, ok, qk, _ = _operands(q, k, v, window)
    d = q.shape[-1]
    g = H // HKV
    dof = do.float()
    dd = torch.sum(dof * out.float(), -1, keepdim=True)
    p = _probs(qk, lse, ok, d)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - dd) * d ** -0.5
    dq = _tiled(ds, kf, k6_keys(d), split_dsk).to(torch.bfloat16)

    def over_group(x, y, split):
        # x (B, H, S, S) queries x keys, y (B, H, S, D): sum of x^T . y
        # over the group's heads in order, each head tile by tile
        xt = x.transpose(-1, -2).reshape(B, HKV, g, S, S)
        yg = y.reshape(B, HKV, g, S, d)
        acc = None
        for gi in range(g):
            for q0 in range(0, S, K7_BQ):
                part = _product(xt[:, :, gi, :, q0:q0 + K7_BQ],
                                yg[:, :, gi, q0:q0 + K7_BQ], split)
                acc = part if acc is None else acc + part
        return acc.to(torch.bfloat16)

    return dq, over_group(ds, qf, split_dsq), over_group(p, dof, split_pdo)


def agreement(got, want):
    """(passes, max |err|, share of elements that differ): bf16 within
    one ulp on at most BF16_FLIP_SHARE of the elements, float32 within
    F32_TOL."""
    g, w = got.double(), want.double()
    err = (g - w).abs()
    share = float((got != want).double().mean())
    if got.dtype == torch.bfloat16:
        ok = bool((err <= BF16_ATOL + BF16_RTOL * w.abs()).all()) \
            and share <= BF16_FLIP_SHARE
    else:
        ok = bool((err <= F32_TOL + F32_TOL * w.abs()).all())
    return ok, float(err.max()), share


def _reference(d):
    """(inputs as torch bf16, {window: {out, lse, dq, dk, dv}} of the
    reference) at head dim d."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import flash_attention as rfa
    from repro.kernels import ops as rops

    arrays = _inputs(d)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    pad = ((0, 0), (0, 0), (0, 256 - S), (0, 0))
    results = {}
    for window in (None, 16):
        def f(q, k, v, window=window):
            return rops.flash_attention(q, k, v, causal=True, window=window)
        out, vjp = jax.vjp(f, jq, jk, jv)
        dq, dk, dv = vjp(jdo)
        # lse from the reference kernel itself, on S padded as the wrapper
        # pads it
        _, lse = rfa.flash_attention_blocks(
            *(jnp.pad(t, pad) for t in (jq, jk, jv)), sm_scale=d ** -0.5,
            causal=True, window=window, bq=128, bk=128, kv_len=S,
            interpret=True)
        results[window] = {
            name: torch.from_numpy(np.array(x.astype(jnp.float32))).to(
                torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
            for name, x in (("out", out), ("lse", lse[..., :S]), ("dq", dq),
                            ("dk", dk), ("dv", dv))}
    return tuple(_bf16(a) for a in arrays), results


@pytest.fixture(scope="module")
def reference():
    """The reference at D = 32, computed once."""
    return _reference(D)


@pytest.fixture(scope="module")
def reference_256():
    """The reference at D = 256 (gemma-7b's head dim), computed once."""
    return _reference(256)


def _emulate(inputs, want, window, **split):
    """{out, lse, dq, dk, dv} of the emulation. The backward takes the
    reference forward's out and lse, as on the card K6, K7 and their plain
    version take the same ones: an out one ulp off moves dd =
    rowsum(do * out), and with it every ds of its row."""
    q, k, v, do = inputs
    fwd = {n: split[n] for n in ("split_pv",) if n in split}
    bwd = {n: split[n] for n in ("split_dsk", "split_pdo", "split_dsq")
           if n in split}
    out, lse = emulate_fwd(q, k, v, window=window, **fwd)
    dq, dk, dv = emulate_bwd(q, k, v, do, want["out"], want["lse"],
                             window=window, **bwd)
    return dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv)


@pytest.mark.parametrize("window", [None, 16])
def test_split_matches_reference(reference, window):
    """With p and ds split, out, lse, dq, dk and dv pass the card's
    rule."""
    inputs, want = reference
    got = _emulate(inputs, want[window], window)
    for name, w in want[window].items():
        ok, err, share = agreement(got[name], w)
        assert ok, f"{name}: max err {err}, differing share {share}"


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("control,which", [
    ("split_pv", "out"),      # p rounded to bf16 in P.V (K5)
    ("split_dsk", "dq"),      # ds rounded to bf16 in dS.K (K6)
    ("split_pdo", "dv"),      # p rounded to bf16 in P^T.dO (K7)
    ("split_dsq", "dk")])     # ds rounded to bf16 in dS^T.Q (K7)
def test_unsplit_control_fails(reference, window, control, which):
    """Each product taken with its float32 operand rounded to bf16 once
    fails the rule: the share of differing elements is far above 1%."""
    inputs, want = reference
    got = _emulate(inputs, want[window], window, **{control: False})
    ok, err, share = agreement(got[which], want[window][which])
    assert not ok, f"{control} passed: err {err}, share {share}"
    assert share > 10 * BF16_FLIP_SHARE


@pytest.mark.parametrize("window", [None, 16])
def test_split_matches_reference_at_head_dim_256(reference_256, window):
    """At D = 256, with p and ds split, out, lse, dq, dk and dv pass the
    card's rule."""
    inputs, want = reference_256
    got = _emulate(inputs, want[window], window)
    for name, w in want[window].items():
        ok, err, share = agreement(got[name], w)
        assert ok, f"{name}: max err {err}, differing share {share}"


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("control,which", [
    ("split_pv", "out"), ("split_dsk", "dq"), ("split_pdo", "dv"),
    ("split_dsq", "dk")])
def test_unsplit_control_fails_at_head_dim_256(reference_256, window,
                                               control, which):
    """At D = 256 each product taken with its float32 operand rounded to
    bf16 once still fails the rule."""
    inputs, want = reference_256
    got = _emulate(inputs, want[window], window, **{control: False})
    ok, err, share = agreement(got[which], want[window][which])
    assert not ok, f"{control} passed: err {err}, share {share}"
    assert share > 10 * BF16_FLIP_SHARE
