"""The port's TOPSIS kernel wrappers (``repro_torch.kernels.ops``) against
the reference Pallas wrappers (``repro.kernels.ops``, interpret mode on the
CPU, as tests/test_kernels.py runs them) and the pure oracles, at atol 1e-5.

Here the port runs with ``device="cpu"``: each wrapper computes its global
reductions, pads to C_PAD = 8 and calls the kernel binding, which takes the
kernel's plain PyTorch version because the tensors lie on the CPU. The
K3/K4 sweeps are in tests/test_torch_kernels_indexed.py. K1's plain
version (the fused kernel's function: its own reductions and -inf fill)
is swept here too. The ``gpu``-marked tests compare each CUDA kernel with
its plain version on the card and skip where there is none. The card's
machine has no JAX, so the reference is imported by a fixture rather
than at the top: the file collects there, and ``-m gpu`` selects the card
tests alone.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, topsis_cuda
from repro_torch.kernels import ref as port_ref

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


@pytest.fixture(scope="module")
def reference():
    """The JAX package's Pallas wrappers and pure oracle."""
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref as ref_oracle
    return ref_ops, ref_oracle


def _single_inputs(n, c, seed):
    rng = np.random.default_rng(seed)
    mat = rng.uniform(0.05, 10.0, (n, c)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, c).astype(np.float32)
    benefit = rng.random(c) > 0.5
    valid = rng.random(n) > 0.1
    valid[0] = True
    return mat, w, benefit, valid


# --- K1: single matrix ------------------------------------------------------
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("c", CS)
def test_single_sweep(n, c, reference):
    ref_ops, ref_oracle = reference
    mat, w, benefit, valid = _single_inputs(n, c, seed=n * 31 + c)
    got = ops.topsis_closeness(mat, w, benefit, device="cpu")
    _same(got, ref_oracle.topsis_closeness_ref(mat, w, benefit))
    _same(got, port_ref.topsis_closeness_ref(torch.from_numpy(mat),
                                             torch.from_numpy(w), benefit))
    got_v = ops.topsis_closeness(mat, w, benefit, valid=valid, device="cpu")
    _same(got_v, ref_ops.topsis_closeness(mat, w, benefit, valid=valid))


# K1's plain version as the fused kernel computes it: the reductions, the
# closeness over the real criteria and the -inf, from the padded rows.
FUSED_NS = [1, 7, 128, 1000, 4097]
FUSED_CS = [1, 5, 6, 8]


def _fused_plain(mat, w, benefit, valid):
    x = ops._pad_c(torch.from_numpy(mat))
    return topsis_cuda.single_plain(
        x, w, benefit, None if valid is None else torch.from_numpy(valid),
        len(benefit))


def _against_float64(got, mat, w, benefit, valid):
    """Within ATOL of the float64 numpy reference, -inf where it is."""
    from repro_torch.core.topsis import closeness_np
    _same(got, closeness_np(mat.astype(np.float64), w.astype(np.float64),
                            benefit, valid).closeness)


@pytest.mark.parametrize("n", FUSED_NS)
@pytest.mark.parametrize("c", FUSED_CS)
def test_single_fused_plain_sweep(n, c, reference):
    """K1's plain version, masked and unmasked, against the reference's
    Pallas wrapper (interpret mode) and the float64 numpy reference."""
    ref_ops, _ = reference
    mat, w, benefit, valid = _single_inputs(n, c, seed=n * 17 + c)
    for mask in (valid, None):
        got = _fused_plain(mat, w, benefit, mask)
        _same(got, ref_ops.topsis_closeness(mat, w, benefit, valid=mask))
        _against_float64(got, mat, w, benefit, mask)
        _same(ops.topsis_closeness(mat, w, benefit, valid=mask,
                                   device="cpu"), got, atol=0)


@pytest.mark.parametrize("case", ["one_valid", "no_valid", "negative_weight",
                                  "negative_weight_masked"])
def test_single_fused_plain_edge_cases(case, reference):
    """One valid node (closeness 0.5 there, -inf elsewhere), no valid node
    (all -inf) and a negative weight, against the reference's Pallas
    wrapper and float64 numpy."""
    ref_ops, _ = reference
    mat, w, benefit, valid = _single_inputs(301, 5, seed=11)
    if case == "one_valid":
        valid = np.zeros(301, bool)
        valid[137] = True
    elif case == "no_valid":
        valid = np.zeros(301, bool)
    else:
        w = np.array([0.5, -0.2, 0.4, 0.3, 0.1], np.float32)
        if case == "negative_weight":
            valid = None
    got = _fused_plain(mat, w, benefit, valid)
    _same(got, ref_ops.topsis_closeness(mat, w, benefit, valid=valid))
    _against_float64(got, mat, w, benefit, valid)
    if case == "one_valid":
        assert float(got[137]) == 0.5
        assert int(torch.isneginf(got).sum()) == 300
    if case == "no_valid":
        assert bool(torch.isneginf(got).all())


def test_single_weights_are_normalised_in_order():
    """K1's weight normalisation (the kernel sums the weights left to
    right): w / max(sum, 1e-12) in float32 from a sequential sum."""
    w = np.array([0.1, 0.7, 1e-8, 0.2, 3.0], np.float32)
    total = np.float32(0.0)
    for v in w:
        total = np.float32(total + v)
    assert np.array_equal(topsis_cuda.normalized_weights(w), w / total)
    assert np.array_equal(topsis_cuda.normalized_weights(np.zeros(3)),
                          np.zeros(3, np.float32))
    params = topsis_cuda.single_params(w, [True, False, True, True, False],
                                       5)
    assert list(params.w)[:5] == [float(v) for v in w]
    assert params.benefit == 0b01101


# --- K2: per-pod batch ------------------------------------------------------
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("c", CS)
def test_batched_sweep(n, c, reference):
    ref_ops, ref_oracle = reference
    rng = np.random.default_rng(n * 7 + c)
    p = 8
    mats = rng.uniform(0.05, 10.0, (p, n, c)).astype(np.float32)
    ws = rng.uniform(0.1, 1.0, (p, c)).astype(np.float32)
    benefit = rng.random(c) > 0.5
    valid = rng.random((p, n)) > 0.1
    valid[:, 0] = True
    got = ops.topsis_closeness_batched(mats, ws, benefit, valid=valid,
                                       device="cpu")
    _same(got, ref_ops.topsis_closeness_batched(mats, ws, benefit,
                                                valid=valid))
    unmasked = ops.topsis_closeness_batched(mats, ws, benefit, device="cpu")
    for i in range(p):
        _same(unmasked[i], ref_oracle.topsis_closeness_ref(mats[i], ws[i],
                                                           benefit))


def test_degenerate_all_equal_gives_half():
    mat = np.ones((16, 5), np.float32)
    got = ops.topsis_closeness(mat, np.ones(5), np.ones(5, bool),
                               device="cpu")
    assert torch.all(got == 0.5)


def test_tensor_inputs_stay_on_their_device(reference):
    _, ref_oracle = reference
    mat, w, benefit, _ = _single_inputs(50, 5, seed=3)
    got = ops.topsis_closeness(torch.from_numpy(mat), torch.from_numpy(w),
                               benefit)
    assert got.device.type == "cpu"
    _same(got, ref_oracle.topsis_closeness_ref(mat, w, benefit))


def test_numpy_input_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    mat, w, benefit, _ = _single_inputs(8, 5, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.topsis_closeness(mat, w, benefit)


def test_cpu_path_launches_no_kernel():
    before = dict(topsis_cuda.LAUNCHES)
    mat, w, benefit, valid = _single_inputs(100, 5, seed=1)
    ops.topsis_closeness(mat, w, benefit, valid=valid, device="cpu")
    ops.topsis_closeness_batched(mat[None], w, benefit, device="cpu")
    assert topsis_cuda.LAUNCHES == before


@pytest.mark.parametrize("bad", ["too_many_criteria", "wrong_width",
                                 "meta_device", "not_a_tensor"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    x = torch.zeros(4, topsis_cuda.C_PAD)
    small = torch.zeros(topsis_cuda.C_PAD)
    if bad == "too_many_criteria":
        with pytest.raises(ValueError, match="at most 8 criteria"):
            ops.topsis_closeness(np.ones((4, 9)), np.ones(9),
                                 np.ones(9, bool), device="cpu")
    elif bad == "wrong_width":
        with pytest.raises(ValueError, match="last axis 8"):
            topsis_cuda.single(torch.zeros(4, 5), np.ones(5), np.ones(5, bool),
                               None, 5)
    elif bad == "meta_device":
        with pytest.raises(ValueError, match="not supported"):
            topsis_cuda.single(x.to("meta"), np.ones(8), np.ones(8, bool))
    else:
        with pytest.raises(ValueError, match="criteria tensor"):
            topsis_cuda.batched(np.zeros((1, 4, 8)), small, small, small,
                                small)


def test_ctypes_signatures_match_the_cuda_source():
    """Each C entry point in csrc/topsis.cu takes as many parameters as the
    binding declares, pointers where the binding passes c_void_p."""
    src = Path(topsis_cuda.SOURCE).read_text()
    for name, argtypes in topsis_cuda.SIGNATURES.items():
        m = re.search(rf"int {name}\(([^)]*)\)", src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), name
        for p, t in zip(params, argtypes):
            is_ptr = "*" in p
            assert is_ptr == (t is topsis_cuda._PTR), (name, p)
    # K1-K4 and K1's launch-floor kernel
    assert len(re.findall(r"__global__", src)) == 5
    # K1's by-value struct: the same fields as its ctypes mirror
    m = re.search(r"struct SingleWeights \{([^}]*)\}", src)
    assert m and re.findall(r"(\w+)(?:\[\d+\])?;", m.group(1)) == \
        [f for f, _ in topsis_cuda.SingleWeights._fields_]


def test_single_cluster_constants_match_the_cuda_source():
    """K1's on-chip capacity (the boundary between its resident and
    re-reading paths) and cluster size, as the wrapper and the tests take
    them, are the source's."""
    src = Path(topsis_cuda.SOURCE).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("K1_THREADS") == topsis_cuda.SINGLE_THREADS
    assert const("K1_CLUSTER") == topsis_cuda.SINGLE_CLUSTER
    assert const("QUAD") == topsis_cuda._QUAD
    assert topsis_cuda.single_resident_rows() == 16 * 512 * 4
    with pytest.raises(ValueError, match="weights"):
        topsis_cuda.single(torch.zeros(4, 8), np.ones(4), np.ones(5, bool),
                           None, 5)


def test_math_check_signature_matches_its_source():
    """The card's check of K3's and K4's branch-free square root and
    division: its one C entry point against its binding."""
    src = Path(topsis_cuda.MATH_CHECK.source).read_text()
    for name, argtypes in topsis_cuda.MATH_CHECK.signatures.items():
        m = re.search(rf"int {name}\(([^)]*)\)", src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        assert [("*" in p) for p in params] == \
            [t is topsis_cuda._PTR for t in argtypes], name
    with pytest.raises(ValueError, match="on the card"):
        topsis_cuda.math_check(torch.device("cpu"))


# --- on the card -------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """Each CUDA kernel against its plain PyTorch version on the same card
    inputs (~10% invalid nodes), at main-path widths cut to test size.
    Tolerance 1e-5: float32 with another summation order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n, p, k, s, c = 3001, 16, 3, 5, 6
    benefit = np.array([False, False, True, True, True, False])
    valid = rng.random((p, n)) > 0.1
    kinds = rng.uniform(0.05, 10.0, (k, n, c))
    kidx = rng.integers(0, k, p)
    ws = rng.dirichlet(np.ones(c), s)
    mats = kinds[kidx]
    cases = {
        "topsis_single": lambda d: ops.topsis_closeness(
            mats[0], ws[0], benefit, valid=valid[0], device=d),
        "topsis_batched": lambda d: ops.topsis_closeness_batched(
            mats, ws[0], benefit, valid=valid, device=d),
        "topsis_kinds": lambda d: ops.topsis_closeness_kinds(
            kinds, kidx, ws[0], benefit, valid=valid, device=d),
        "topsis_grid": lambda d: ops.topsis_closeness_grid(
            mats, ws, benefit, valid=valid, device=d),
    }
    for name, run in cases.items():
        before = topsis_cuda.LAUNCHES[name]
        got = run(dev)
        torch.cuda.synchronize()
        assert topsis_cuda.LAUNCHES[name] == before + 1
        _same(got.cpu(), run("cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("c", [5, 6, 8])
def test_cuda_kinds_and_grid_match_plain_at_ragged_shapes(c):
    """K3 and K4 against their plain versions on the card, masked and
    unmasked: N not a multiple of 4 (the scalar path), of the 512-node tile
    and below one 4-node group; P = 37 and S = 70 past the pod (32) and
    scheme (64) chunks; K = 3 kinds staged in shared memory and K = 40
    read from global memory; a pod of kind -1 and one of kind K give NaN
    (and -inf where masked). Tolerance 1e-5: float32 with fused
    multiply-adds where the plain version rounds each product."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(c)
    benefit = rng.random(c) > 0.5
    for n, k, p, s in ((1003, 3, 37, 70), (1024, 3, 37, 70), (3, 3, 5, 2),
                       (1001, 40, 9, 3)):
        kinds = rng.uniform(0.05, 10.0, (k, n, c))
        kidx = rng.integers(0, k, p)
        valid = rng.random((p, n)) > 0.1
        ws = rng.dirichlet(np.ones(c), max(p, s))
        k3 = ops.kinds_operands(kinds, kidx, ws[:p], benefit, valid=valid,
                                device=dev)
        bad = k3[0].clone()
        bad[1], bad[2] = -1, k
        k4 = ops.grid_operands(kinds[kidx], ws[:s], benefit, valid=valid,
                               device=dev)
        for name, kernel, plain, args in (
                ("topsis_kinds", topsis_cuda.kinds, topsis_cuda.kinds_plain,
                 (bad,) + k3[1:]),
                ("topsis_grid", topsis_cuda.grid, topsis_cuda.grid_plain,
                 k4)):
            for mask in (args[-2], None):
                run = args[:-2] + (mask, c)
                before = topsis_cuda.LAUNCHES[name]
                got = kernel(*run)
                torch.cuda.synchronize()
                assert topsis_cuda.LAUNCHES[name] == before + 1
                want = plain(*run)
                assert torch.equal(torch.isnan(got), torch.isnan(want))
                if name == "topsis_kinds":
                    assert torch.isnan(want[1:3]).any()
                _same(got.cpu(), want.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("c", range(1, 9))
def test_cuda_single_matches_plain_at_ragged_and_boundary_n(c):
    """The fused K1 against its plain version on the card, masked and
    unmasked, at ragged N (the scalar path), N below one CTA's share, and
    at the on-chip capacity and one node past it (the re-reading path); one
    valid node and none. Tolerance 1e-5: the sum of squares is summed as a
    tree, not in torch's order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(100 + c)
    benefit = rng.random(c) > 0.5
    w = rng.uniform(-0.2, 1.0, c).astype(np.float32)
    cap = topsis_cuda.single_resident_rows()
    for n in (1, 3, 1003, 1024, 15001, 16384, 16385, cap, cap + 1):
        x = torch.zeros((n, topsis_cuda.C_PAD), device=dev)
        x[:, :c] = torch.as_tensor(rng.uniform(0.05, 10.0, (n, c)),
                                   dtype=torch.float32, device=dev)
        valid = torch.as_tensor(rng.random(n) > 0.1, device=dev)
        masks = [valid, None]
        if n == 1003:
            one = torch.zeros(n, dtype=torch.bool, device=dev)
            one[500] = True
            masks += [one, torch.zeros_like(one)]
        for mask in masks:
            before = topsis_cuda.LAUNCHES["topsis_single"]
            got = topsis_cuda.single(x, w, benefit, mask, c)
            torch.cuda.synchronize()
            assert topsis_cuda.LAUNCHES["topsis_single"] == before + 1
            want = topsis_cuda.single_plain(x, w, benefit, mask, c)
            _same(got.cpu(), want.cpu())


@pytest.mark.gpu
def test_branch_free_sqrt_and_division_are_ieee_on_the_card():
    """csrc/topsis_math.cuh's sqrt_in equals sqrtf on every float of its
    range and div_in equals '/' on 2^32 sampled quotients, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    counts = topsis_cuda.math_check(torch.device("cuda"))
    assert counts["sqrt_mismatches"] == 0 and counts["div_mismatches"] == 0
    assert counts["sqrt_tried"] > 1.9e9 and counts["div_tried"] > 4e9
