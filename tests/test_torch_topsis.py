"""The port's TOPSIS engine (``repro_torch.core.topsis``) against the
reference ``repro.core.topsis`` on the same seeded numpy inputs.

* numpy functions: bitwise equal to the reference's (the same code);
* torch float32 functions: within 1e-5 of ``closeness_np`` and of the
  JAX float32 functions, with the identical -inf pattern;
* grid row ``s`` equals scoring under ``ws[s]`` alone.
"""
import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core import topsis as ref
from repro_torch.core import topsis as port

BENEFIT5 = np.array([False, False, True, True, True])
ATOL = 1e-5          # float32 device math against the float64 reference


def _inputs(n, c, seed, invalid=0.3):
    rng = np.random.default_rng(seed)
    mat = rng.uniform(0.1, 10.0, (n, c))
    w = rng.uniform(0.05, 1.0, c)
    benefit = rng.random(c) > 0.5
    valid = rng.random(n) > invalid
    valid[0] = True
    return mat, w, benefit, valid


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _same(got, want, atol=ATOL):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    assert np.isfinite(got[finite]).all()
    np.testing.assert_allclose(got[finite], want[finite], atol=atol, rtol=0)


# --- numpy functions: bitwise ------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("masked", [False, True])
def test_numpy_closeness_bitwise(seed, masked):
    mat, w, benefit, valid = _inputs(37, 5 + seed % 2, seed)
    valid = valid if masked else None
    a = ref.closeness_np(mat, w, benefit, valid)
    b = port.closeness_np(mat, w, benefit, valid)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("seed", range(3))
def test_numpy_batched_and_grid_bitwise(seed):
    rng = np.random.default_rng(seed)
    mats = rng.uniform(0.1, 10.0, (3, 17, 5))
    ws = rng.uniform(0.01, 1.0, (4, 5))
    valids = rng.random((3, 17)) > 0.3
    ps = np.broadcast_to(ws[0], (3, 5))
    assert np.array_equal(ref.batched_closeness_np(mats, ps, BENEFIT5, valids),
                          port.batched_closeness_np(mats, ps, BENEFIT5,
                                                    valids))
    assert np.array_equal(ref.closeness_grid_np(mats, ws, BENEFIT5, valids),
                          port.closeness_grid_np(mats, ws, BENEFIT5, valids))


@pytest.mark.parametrize("seed", range(3))
def test_numpy_explain_bitwise(seed):
    mat, w, benefit, valid = _inputs(12, 5, seed)
    names = [f"c{j}" for j in range(5)]
    assert ref.explain_np(mat, w, benefit, valid, names) \
        == port.explain_np(mat, w, benefit, valid, names)


# --- torch float32 vs numpy and JAX -------------------------------------------
@pytest.mark.parametrize("n,c", [(1, 2), (4, 5), (100, 6), (1000, 8)])
@pytest.mark.parametrize("masked", [False, True])
def test_torch_closeness_matches_numpy_and_jax(n, c, masked):
    mat, w, benefit, valid = _inputs(n, c, seed=n + c)
    valid = valid if masked else None
    got = port.closeness(_t(mat), _t(w), _t(benefit, torch.bool),
                         None if valid is None else _t(valid, torch.bool))
    _same(got.closeness, ref.closeness_np(mat, w, benefit, valid).closeness)
    jx = ref.closeness(np.float32(mat), np.float32(w), benefit, valid)
    _same(got.closeness, np.asarray(jx.closeness, dtype=np.float64))
    _same(got.d_pos, np.asarray(jx.d_pos, dtype=np.float64))
    _same(got.d_neg, np.asarray(jx.d_neg, dtype=np.float64))
    assert int(port.select(_t(mat), _t(w), _t(benefit, torch.bool),
                           None if valid is None else _t(valid, torch.bool))) \
        == int(np.argmax(ref.closeness_np(mat, w, benefit, valid).closeness))


def test_torch_degenerate_all_equal_and_invalid_rows():
    mat = np.ones((6, 5))
    got = port.closeness(_t(mat), _t(np.ones(5)), _t(BENEFIT5, torch.bool))
    assert torch.all(got.closeness == 0.5)
    valid = np.array([True, False, True, False, False, True])
    got = port.closeness(_t(mat), _t(np.ones(5)), _t(BENEFIT5, torch.bool),
                         _t(valid, torch.bool)).closeness.numpy()
    want = np.asarray(ref.closeness(mat, np.ones(5), BENEFIT5,
                                    valid).closeness)
    assert np.array_equal(got, want)
    assert np.array_equal(np.isneginf(got), ~valid)


def test_torch_normalize_and_ideal_points_match_jax():
    mat, w, benefit, valid = _inputs(30, 6, seed=5)
    r = port.normalize_matrix(_t(mat))
    _same(r, np.asarray(ref.normalize_matrix(np.float32(mat)), np.float64))
    for valid_ in (None, valid):
        got = port.masked_ideal_points(
            r, _t(benefit, torch.bool),
            None if valid_ is None else _t(valid_, torch.bool))
        want = ref.masked_ideal_points(np.asarray(r), benefit, valid_)
        for g, wnt in zip(got, want):
            _same(g, np.asarray(wnt, np.float64), atol=1e-7)


@pytest.mark.parametrize("seed", range(3))
def test_torch_batched_matches_jax(seed):
    rng = np.random.default_rng(seed)
    mats = rng.uniform(0.1, 10.0, (5, 40, 5))
    ws = rng.uniform(0.01, 1.0, (5, 5))
    valids = rng.random((5, 40)) > 0.3
    got = port.batched_closeness(_t(mats), _t(ws), _t(BENEFIT5, torch.bool),
                                 _t(valids, torch.bool)).closeness
    _same(got, ref.batched_closeness_np(mats, ws, BENEFIT5, valids))
    jx = ref.batched_closeness_cc(np.float32(mats), np.float32(ws), BENEFIT5,
                                  valids)
    _same(got, np.asarray(jx, np.float64))


@pytest.mark.parametrize("s", [1, 3, 6])
def test_torch_grid_matches_numpy_jax_and_per_scheme(s):
    rng = np.random.default_rng(s)
    mats = rng.uniform(0.1, 10.0, (3, 23, 5))
    ws = rng.uniform(0.01, 1.0, (s, 5))
    ws /= ws.sum(axis=1, keepdims=True)
    valids = rng.random((3, 23)) > 0.3
    valids[:, 0] = True
    b = _t(BENEFIT5, torch.bool)
    got = port.closeness_grid(_t(mats), _t(ws), b, _t(valids, torch.bool))
    assert got.shape == (s, 3, 23)
    _same(got, ref.closeness_grid_np(mats, ws, BENEFIT5, valids))
    _same(got, np.asarray(ref.closeness_grid(np.float32(mats),
                                             np.float32(ws), BENEFIT5,
                                             valids), np.float64))
    for si in range(s):
        row = port.batched_closeness(
            _t(mats), _t(np.broadcast_to(ws[si], (3, 5))), b,
            _t(valids, torch.bool)).closeness
        _same(got[si], row.numpy().astype(np.float64), atol=1e-6)
    unmasked = port.closeness_grid(_t(mats), _t(ws), b)
    _same(unmasked, ref.closeness_grid_np(mats, ws, BENEFIT5))
