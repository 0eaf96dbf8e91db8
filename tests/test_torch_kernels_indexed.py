"""The kind-indexed (K3) and weight-grid (K4) wrappers of
``repro_torch.kernels.ops`` against the reference Pallas wrappers
(interpret mode on the CPU) and the pure oracle, at atol 1e-5, with
``device="cpu"`` (the kernels' plain versions behind the real padding and
layout code). The K1/K2 sweeps are in tests/test_torch_kernels.py.

N = 1003 is not a multiple of the 4 nodes a thread of K3/K4 writes, and
P = 37, S = 70 pass the kernels' pod (32) and scheme (64) chunks: on the
card those are the kernels' scalar and partial-chunk paths. The plain
versions' own rules — the fused -inf fill, the sum over the real criteria
only — are pinned here bit for bit, and so are K4's ideal points against
the (S, P, N, C) construction they replaced."""
import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch.core import topsis as port_topsis
from repro_torch.kernels import ops, topsis_cuda

NS = [1, 4, 100, 1000, 1003]
CS = [2, 5, 6, 8]
ATOL = 1e-5


def _same(got, want, atol=ATOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    assert np.isfinite(got[finite]).all()
    np.testing.assert_allclose(got[finite], want[finite], atol=atol, rtol=0)


# --- K3: kind-indexed --------------------------------------------------------
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("c", CS)
def test_kinds_sweep(n, c):
    rng = np.random.default_rng(n * 13 + c)
    k, p = 3, 8
    kinds = rng.uniform(0.05, 10.0, (k, n, c)).astype(np.float32)
    kidx = rng.integers(0, k, p)
    ws = rng.uniform(0.1, 1.0, (p, c)).astype(np.float32)
    benefit = rng.random(c) > 0.5
    valid = rng.random((p, n)) > 0.1
    valid[:, 0] = True
    got = ops.topsis_closeness_kinds(kinds, kidx, ws, benefit, valid=valid,
                                     device="cpu")
    _same(got, ref_ops.topsis_closeness_kinds(kinds, kidx, ws, benefit,
                                              valid=valid))
    # the resident-mirror form: criteria already padded to C_PAD
    padded = np.zeros((k, n, ops.C_PAD), np.float32)
    padded[..., :c] = kinds
    _same(ops.topsis_closeness_kinds(padded, kidx, ws, benefit, valid=valid,
                                     device="cpu"), got, atol=0)
    unmasked = ops.topsis_closeness_kinds(kinds, kidx, ws, benefit,
                                          device="cpu")
    for i in range(p):
        _same(unmasked[i], ref_oracle.topsis_closeness_ref(
            kinds[kidx[i]], ws[i], benefit))


def test_kinds_rejects_out_of_range_kind():
    kinds = np.ones((2, 5, 5), np.float32)
    with pytest.raises(IndexError, match="kind_idx out of range"):
        ops.topsis_closeness_kinds(kinds, np.array([0, 2]), np.ones(5),
                                   np.ones(5, bool), device="cpu")


# --- K4: weight grid ---------------------------------------------------------
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("c", CS)
def test_grid_sweep(n, c):
    rng = np.random.default_rng(n * 17 + c)
    p, s = 4, 4
    mats = rng.uniform(0.05, 10.0, (p, n, c)).astype(np.float32)
    ws = rng.dirichlet(np.ones(c), s).astype(np.float32)
    benefit = rng.random(c) > 0.5
    valid = rng.random((p, n)) > 0.1
    valid[:, 0] = True
    got = ops.topsis_closeness_grid(mats, ws, benefit, valid=valid,
                                    device="cpu")
    assert got.shape == (s, p, n)
    _same(got, ref_ops.topsis_closeness_grid(mats, ws, benefit, valid=valid))
    unmasked = ops.topsis_closeness_grid(mats, ws, benefit, device="cpu")
    for si in range(s):
        row = ops.topsis_closeness_batched(mats, ws[si], benefit,
                                           valid=valid, device="cpu")
        _same(got[si], row, atol=1e-6)
        for i in range(p):
            _same(unmasked[si, i], ref_oracle.topsis_closeness_ref(
                mats[i], ws[si], benefit))


def test_grid_rejects_a_weight_vector():
    with pytest.raises(ValueError, match=r"weights must be \(S, 5\)"):
        ops.topsis_closeness_grid(np.ones((2, 4, 5)), np.ones(5),
                                  np.ones(5, bool), device="cpu")


# --- ragged chunks -------------------------------------------------------------
def test_kinds_and_grid_past_their_chunks():
    """P = 37 pods (a whole pod chunk of 32 and 5 more) and S = 70 schemes
    (64 and 6), at N = 1003, against the reference wrappers."""
    rng = np.random.default_rng(37)
    c, k, p, s, n = 5, 3, 37, 70, 1003
    kinds = rng.uniform(0.05, 10.0, (k, n, c)).astype(np.float32)
    kidx = rng.integers(0, k, p)
    ws = rng.uniform(0.1, 1.0, (p, c)).astype(np.float32)
    benefit = np.array([False, False, True, True, True])
    valid = rng.random((p, n)) > 0.1
    _same(ops.topsis_closeness_kinds(kinds, kidx, ws, benefit, valid=valid,
                                     device="cpu"),
          ref_ops.topsis_closeness_kinds(kinds, kidx, ws, benefit,
                                         valid=valid))
    mats = kinds[kidx[:4], :60]
    grid_w = rng.dirichlet(np.ones(c), s).astype(np.float32)
    got = ops.topsis_closeness_grid(mats, grid_w, benefit,
                                    valid=valid[:4, :60], device="cpu")
    assert got.shape == (s, 4, 60)
    _same(got, ref_ops.topsis_closeness_grid(mats, grid_w, benefit,
                                             valid=valid[:4, :60]))


# --- the plain versions' rules, bit for bit ------------------------------------
def _bits(t):
    return t.contiguous().view(torch.int32)


def _k3_k4_operands(c, seed):
    rng = np.random.default_rng(seed)
    k, p, s, n = 3, 6, 5, 103
    kinds = rng.uniform(0.05, 10.0, (k, n, c))
    kidx = rng.integers(0, k, p)
    benefit = rng.random(c) > 0.5
    valid = rng.random((p, n)) > 0.2
    valid[1] = False                      # a pod with no valid node
    k3 = ops.kinds_operands(kinds, kidx, rng.dirichlet(np.ones(c), p),
                            benefit, valid=valid, device="cpu")
    k4 = ops.grid_operands(kinds[kidx], rng.dirichlet(np.ones(c), s),
                           benefit, valid=valid, device="cpu")
    return k3, k4


@pytest.mark.parametrize("c", CS)
def test_plain_fill_is_fill_invalid_of_the_unmasked_output(c):
    """The mask argument of kinds_plain / grid_plain writes exactly
    fill_invalid's -inf over the unmasked output, NaN rows of an
    out-of-range kind included."""
    k3, k4 = _k3_k4_operands(c, seed=c)
    kidx = k3[0].clone()
    kidx[2], kidx[3] = -1, 3              # K = 3: both out of range
    for plain, args in ((topsis_cuda.kinds_plain, (kidx,) + k3[1:]),
                        (topsis_cuda.grid_plain, k4)):
        valid = args[-2]
        got = plain(*args)
        want = topsis_cuda.fill_invalid(plain(*args[:-2], None, c), valid)
        assert torch.equal(_bits(got), _bits(want))
        assert torch.isneginf(got[..., ~valid]).all()
    rows = topsis_cuda.kinds_plain(kidx, *k3[1:-2], None, c)
    assert torch.isnan(rows[2:4]).all() and not torch.isnan(rows[4:]).any()


@pytest.mark.parametrize("c", CS)
def test_c_limited_sum_equals_the_8_wide_sum_bitwise(c):
    """Summing the c real criteria gives the same bits as summing all 8 of
    the zero-padded operands: the padded criteria add exact zeros, so K3
    and K4 may stop at c."""
    k3, k4 = _k3_k4_operands(c, seed=10 + c)
    for plain, args in ((topsis_cuda.kinds_plain, k3),
                        (topsis_cuda.grid_plain, k4)):
        assert torch.equal(_bits(plain(*args)),
                           _bits(plain(*args[:-1], topsis_cuda.C_PAD)))
    if c > 1:
        fewer = topsis_cuda.kinds_plain(*k3[:-1], c - 1)
        assert not torch.equal(_bits(fewer), _bits(topsis_cuda.kinds_plain(
            *k3)))


def _weighted_tensor_ideals(mats, weights, benefit, valid):
    """K4's ideal points as grid_operands built them before: the masked
    extremes of the (S, P, N, C) weighted tensor."""
    c = len(benefit)
    m = torch.as_tensor(mats, dtype=torch.float32)
    ws = torch.as_tensor(weights, dtype=torch.float32)
    ws = ws / torch.clamp_min(torch.sum(ws, dim=-1, keepdim=True), 1e-12)
    inv_norm = 1.0 / torch.clamp_min(
        torch.sqrt(torch.sum(m * m, dim=-2)), 1e-12)
    v = m[None] * inv_norm[None, :, None, :] * ws[:, None, None, :]
    return port_topsis.masked_ideal_points(
        v, benefit, None if valid is None else torch.as_tensor(valid)[None])


@pytest.mark.parametrize("seed", range(8))
def test_grid_ideal_points_equal_the_weighted_tensor_construction(seed):
    """a+- from the per-pod masked extremes of u = x * inv_norm, times w,
    against the (S, P, N, C) construction: the same floats bit for bit
    wherever they are not zero, with zero and negative weights, negative
    criteria, invalid nodes and a pod with no valid node. A zero's sign
    may differ (which of +0 and -0 a max over both returns is the
    reduction's choice); it changes no distance, so the closeness is
    bitwise equal too."""
    rng = np.random.default_rng(seed)
    p, n, c, s = 4, 41, int(rng.integers(2, 9)), 6
    mats = rng.normal(0.0, 3.0, (p, n, c)).astype(np.float32)
    ws = rng.normal(0.0, 1.0, (s, c)).astype(np.float32)
    ws[rng.random((s, c)) < 0.3] = 0.0
    benefit = rng.random(c) > 0.5
    valid = None
    if seed % 4:
        valid = rng.random((p, n)) > 0.3
        valid[seed % p] = False
    args = ops.grid_operands(mats, ws, benefit, valid=valid, device="cpu")
    old = _weighted_tensor_ideals(mats, ws, benefit, valid)
    for new, want in zip(args[3:5], old):
        new = new[..., :c]
        assert torch.equal(new, want)
        nonzero = want != 0
        assert torch.equal(_bits(new)[nonzero], _bits(want)[nonzero])
    before = topsis_cuda.grid_plain(
        *args[:3], *(ops._pad_c(a) for a in old), *args[5:])
    assert torch.equal(_bits(topsis_cuda.grid_plain(*args)), _bits(before))


@pytest.mark.parametrize("seed", range(8))
def test_single_ideal_points_equal_the_weighted_tensor_construction(seed):
    """K1's a+- (the fused kernel's rule, mirrored by its plain version):
    the masked column extremes of x, times inv_norm, times w, against
    ``masked_ideal_points`` on v = x * inv_norm * w from the same inv_norm
    and w — the same floats bit for bit wherever they are not zero, with
    zero and negative weights, negative criteria, invalid nodes and (seed 3)
    no valid node. A zero's sign may differ; the closeness is bitwise
    equal."""
    rng = np.random.default_rng(seed)
    n, c = 57, int(rng.integers(1, 9))
    x = torch.zeros((n, ops.C_PAD))
    x[:, :c] = torch.as_tensor(rng.normal(0.0, 3.0, (n, c)),
                               dtype=torch.float32)
    w = rng.normal(0.0, 1.0, c).astype(np.float32)
    w[rng.random(c) < 0.3] = 0.0
    benefit = rng.random(c) > 0.5
    valid = None
    if seed % 4:
        valid = torch.as_tensor(rng.random(n) > 0.3)
        if seed == 3:
            valid[:] = False
    inv_norm, wn, a_pos, a_neg = topsis_cuda.single_reductions_plain(
        x, w, benefit, valid, c)
    for t in (inv_norm, wn, a_pos, a_neg):
        assert torch.all(t[c:] == 0)         # the padded criteria
    v = x[:, :c] * inv_norm[:c] * wn[:c]
    old = port_topsis.masked_ideal_points(v, benefit, valid)
    for new, want in zip((a_pos, a_neg), old):
        new = new[:c]
        assert torch.equal(new, want)
        nonzero = want != 0
        assert torch.equal(_bits(new)[nonzero], _bits(want)[nonzero])
    got = topsis_cuda.fill_invalid(topsis_cuda.closeness_plain(
        x, inv_norm, wn, a_pos, a_neg, c), valid)
    before = topsis_cuda.fill_invalid(topsis_cuda.closeness_plain(
        x, inv_norm, wn, *(ops._pad_c(a) for a in old), c), valid)
    assert torch.equal(_bits(got), _bits(before))


@pytest.mark.parametrize("wrapper", ["kinds", "grid"])
@pytest.mark.parametrize("bad_c", [0, 9, 5.0, True])
def test_kinds_and_grid_reject_a_bad_criteria_count(wrapper, bad_c):
    k3, k4 = _k3_k4_operands(5, seed=0)
    args = k3 if wrapper == "kinds" else k4
    with pytest.raises(ValueError, match="real criteria"):
        getattr(topsis_cuda, wrapper)(*args[:-1], bad_c)
