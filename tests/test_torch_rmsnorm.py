"""K8, the port's fused RMSNorm, against the reference.

The port's ``ops.rmsnorm`` runs here on CPU tensors, where the kernel
binding takes its plain version (``ref.rmsnorm_ref``); the reference's
``ops.rmsnorm`` runs its Pallas kernel in interpret mode. Inputs are made
with numpy from a seed and handed to both, at the shapes and dtypes of
tests/test_kernels.py's sweep; tolerances are that sweep's (f32 2e-5,
bf16 2e-2). The ``gpu``-marked test holds the CUDA kernel against its plain
version on the card and skips here; the reference is imported by a fixture
so that the file collects on the card's machine, which has no JAX.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, rmsnorm_cuda
from repro_torch.kernels import ref as port_ref
from repro_torch.models import layers

SHAPES = [(4, 64), (2, 7, 96), (1, 128), (3, 300), (256, 1024),
          (5, 2, 3, 512)]
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture(scope="module")
def jref():
    import jax.numpy as jnp
    from repro.kernels import ops as rops
    return jnp, rops


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed + sum(shape))
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape[-1]).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_sweep_matches_reference(jref, shape, dtype):
    jnp, rops = jref
    x, g = _inputs(shape)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(rops.rmsnorm(jx, jnp.asarray(g)), np.float32)
    got = ops.rmsnorm(tx, g, device="cpu")
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


def test_kernel_formula_differs_from_model_rmsnorm():
    """K8 multiplies gamma in float32 before rounding; the model's rmsnorm
    rounds first (reference layers.py:45). In bf16 the two differ, which
    is why the model does not call K8."""
    x, g = _inputs((64, 256), seed=1)
    tx = torch.from_numpy(x).bfloat16()
    tg = torch.from_numpy(g)
    k8 = port_ref.rmsnorm_ref(tx, tg)
    model = layers.rmsnorm(tx, tg, 1e-6)
    assert not torch.equal(k8, model)
    np.testing.assert_allclose(k8.float().numpy(), model.float().numpy(),
                               **TOL["bfloat16"])


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError, match="2-d"):
        rmsnorm_cuda.rmsnorm(torch.zeros(4), torch.zeros(4))
    with pytest.raises(ValueError, match="gamma"):
        rmsnorm_cuda.rmsnorm(torch.zeros(2, 4), torch.zeros(5))
    with pytest.raises(ValueError, match="not supported"):
        rmsnorm_cuda.rmsnorm(torch.zeros(2, 4, device="meta"),
                             torch.zeros(4, device="meta"))


def _offset(rows, d, dtype, elements, device="cpu"):
    """A contiguous (rows, d) view starting ``elements`` into its storage."""
    flat = torch.zeros(rows * d + elements, dtype=dtype, device=device)
    return flat[elements:].view(rows, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_register_path_needs_aligned_data(dtype):
    """Rows a multiple of 16 bytes wide take the kernel's 16-byte loads, so
    x and gamma must be 16-byte aligned there; other widths take any
    alignment."""
    d = 64
    rmsnorm_cuda._check_aligned(_offset(2, d, dtype, 0),
                                _offset(1, d, torch.float32, 0)[0])
    with pytest.raises(ValueError, match="x's data is not 16-byte"):
        rmsnorm_cuda._check_aligned(_offset(2, d, dtype, 1),
                                    _offset(1, d, torch.float32, 0)[0])
    with pytest.raises(ValueError, match="gamma's data is not 16-byte"):
        rmsnorm_cuda._check_aligned(_offset(2, d, dtype, 0),
                                    _offset(1, d, torch.float32, 1)[0])
    rmsnorm_cuda._check_aligned(_offset(2, 7, dtype, 1),
                                _offset(1, 7, torch.float32, 1)[0])


def test_c_signature_matches_binding():
    src = rmsnorm_cuda.LIBRARY.source.read_text()
    m = re.search(rf"int {rmsnorm_cuda.NAME}\(([^)]*)\)", src)
    params = [p.strip() for p in m.group(1).split(",")]
    argtypes = rmsnorm_cuda.SIGNATURES[rmsnorm_cuda.NAME]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is rmsnorm_cuda._P), p


# --- on the card ----------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rmsnorm_matches_plain(dtype):
    """The CUDA kernel against its plain version on the card, on rows whose
    width takes the 16-byte vector path (4096, 512) and on widths that do
    not (300, 7). Both sides are float32 results rounded once: bf16 may
    differ by one ulp (2**-7 |want|, plus 1e-4 near 0), f32 by 2e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda")
    for shape in [(8192, 4096), (33, 512), (5, 300), (3, 7)]:
        x, g = _inputs(shape)
        tx = torch.from_numpy(x).to(dev, dtype)
        tg = torch.from_numpy(g).to(dev)
        before = rmsnorm_cuda.LAUNCHES[rmsnorm_cuda.NAME]
        got = rmsnorm_cuda.rmsnorm(tx, tg)
        want = rmsnorm_cuda.rmsnorm_plain(tx, tg)
        torch.cuda.synchronize()
        assert rmsnorm_cuda.LAUNCHES[rmsnorm_cuda.NAME] == before + 1
        tol = (dict(atol=1e-4, rtol=2 ** -7) if dtype == torch.bfloat16
               else TOL["float32"])
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rmsnorm_every_width_path(dtype):
    """Widths that take each instantiation of the register path (1 to 16
    vectors a thread, 1 to 8 warps a row), the widest beyond it, and the
    other widths' kernel, against the plain version, by one ulp for bf16
    and 2e-5 for f32; misaligned data on the register path raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda")
    n = 16 // torch.tensor([], dtype=dtype).element_size()
    widths = [n * v for v in (1, 3, 64, 96, 256, 512, 1024, 2048, 4096,
                              8192)] + [3 * n + 1]
    for d in widths:
        x, g = _inputs((33, d))
        tx = torch.from_numpy(x).to(dev, dtype)
        tg = torch.from_numpy(g).to(dev)
        got = rmsnorm_cuda.rmsnorm(tx, tg)
        want = rmsnorm_cuda.rmsnorm_plain(tx, tg)
        torch.cuda.synchronize()
        tol = (dict(atol=1e-4, rtol=2 ** -7) if dtype == torch.bfloat16
               else TOL["float32"])
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol,
                                   err_msg=f"D={d}")
    with pytest.raises(ValueError, match="16-byte"):
        rmsnorm_cuda.rmsnorm(_offset(2, 64, dtype, 1, dev),
                             torch.ones(64, device=dev))
