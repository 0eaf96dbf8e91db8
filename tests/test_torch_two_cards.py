"""The flash and RMSNorm kernels (K5, K6/K7, K8) on two cards in one
process.

A kernel that takes more than 48 KB of dynamic shared memory needs
``cudaFuncAttributeMaxDynamicSharedMemorySize`` set on each device it
launches on. Each launcher keeps one flag bit a device, so a process that
launches on card 0 first must still set the attribute on card 1 (a launch
there would be refused otherwise). Needs two cards: skips below two, and
on the CPU. Imports no JAX (run on the card with ``-m gpu``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_cuda, rmsnorm_cuda


def _agree(got, want):
    """bf16 within one ulp (2**-7 |want|, plus 1e-4 near 0) on at most 1%
    of the elements."""
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    np.testing.assert_allclose(g, w, atol=1e-4, rtol=2 ** -7)
    assert float(np.mean(g != w)) <= 1e-2


@pytest.mark.gpu
def test_cuda_kernels_launch_on_a_second_card():
    """K5, K6, K7 (bf16, D = 128 and 256: up to 231,496 bytes of dynamic
    shared memory) and K8 (bf16 rows of 16,384: 64 KB of gamma) on card 0,
    then card 1, each against its plain version on the same card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (run with -m gpu on the card)")
    rng = np.random.default_rng(0)
    for index in (0, 1):
        dev = torch.device("cuda", index)
        for d in (128, 256):
            q, k, v, do = (torch.from_numpy(rng.normal(
                size=(1, h, 300, d)).astype(np.float32)).to(dev,
                                                            torch.bfloat16)
                for h in (8, 2, 2, 8))
            kw = dict(sm_scale=d ** -0.5, causal=True)
            out, lse = flash_cuda.flash_fwd(q, k, v, **kw)
            pout, _ = flash_cuda.flash_fwd_plain(q, k, v, **kw)
            got = flash_cuda.flash_bwd(q, k, v, out, lse, do, **kw)
            want = flash_cuda.flash_bwd_plain(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize(dev)
            assert out.device == dev and all(g.device == dev for g in got)
            _agree(out, pout)
            for g, w in zip(got, want):
                _agree(g, w)
        x = torch.from_numpy(rng.normal(size=(8, 16384)).astype(
            np.float32)).to(dev, torch.bfloat16)
        gamma = torch.from_numpy(rng.normal(size=16384).astype(
            np.float32)).to(dev)
        got = rmsnorm_cuda.rmsnorm(x, gamma)
        want = rmsnorm_cuda.rmsnorm_plain(x, gamma)
        torch.cuda.synchronize(dev)
        _agree(got, want)
