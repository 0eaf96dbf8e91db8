"""The kind-indexed (K3) and weight-grid (K4) wrappers of
``repro_torch.kernels.ops`` against the reference Pallas wrappers
(interpret mode on the CPU) and the pure oracle, at atol 1e-5, with
``device="cpu"`` (the kernels' plain versions behind the real padding and
layout code). The K1/K2 sweeps are in tests/test_torch_kernels.py."""
import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch.kernels import ops

NS = [1, 4, 100, 1000]
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
