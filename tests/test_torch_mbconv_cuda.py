"""The fused MBConv CUDA kernel (`metrabs_tpu_torch/csrc/mbconv.cu`) on the
card, against its plain PyTorch version on the same device and inputs.

These tests need an NVIDIA GPU with the CUDA toolkit (sm_90a) and skip
elsewhere. The file imports neither jax nor the test conftest's jax setup:

    python -m pytest --noconftest -m cuda tests/test_torch_mbconv_cuda.py

Tolerances: float32 atol and rtol 1e-5 (the kernel follows the plain
version's operations in order and is built without FMA contraction; only the
SE mean sums in another order); bfloat16 7e-2 / 5e-2 on v and 1e-2 on the
mean, the JAX kernel's bf16 tolerance (tests/test_mbconv_pallas.py).
"""

import numpy as np
import pytest
import torch

from metrabs_tpu_torch.ops import mbconv, mbconv_cuda

pytestmark = pytest.mark.cuda
TOLS = {torch.float32: (dict(atol=1e-5, rtol=1e-5), dict(atol=1e-5, rtol=1e-5)),
        torch.bfloat16: (dict(atol=7e-2, rtol=5e-2), dict(atol=1e-2, rtol=1e-2))}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: python -m pytest --noconftest -m cuda '
                    'tests/test_torch_mbconv_cuda.py on a GPU machine')
    return torch.device('cuda')


def inputs(dev, n, e, h, w, dtype, seed=0):
    g = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.tensor(np.asarray(a, np.float32), device=dev).to(dt)
    return (t(g.normal(size=(n, e, h, w)) * 2, dtype), t(g.normal(size=(e, 1, 3, 3)) * 0.3),
            t(g.uniform(0.5, 1.5, e)), t(g.normal(size=e) * 0.2),
            t(g.uniform(0.5, 1.5, e)), t(g.normal(size=e) * 0.2))


def check(args):
    got_v, got_mean = mbconv_cuda.fused_mbconv_inner(*args)
    want_v, want_mean = mbconv.fused_mbconv_inner(*args)
    torch.cuda.synchronize()
    assert got_v.dtype == args[0].dtype and got_v.shape == args[0].shape
    assert got_mean.dtype == torch.float32 and got_mean.shape == args[0].shape[:2]
    tol_v, tol_mean = TOLS[args[0].dtype]
    torch.testing.assert_close(got_v.float(), want_v.float(), **tol_v)
    torch.testing.assert_close(got_mean, want_mean, **tol_mean)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('shape', [(2, 16, 12, 10), (2, 40, 7, 9), (3, 33, 16, 16),
                                   (1, 24, 24, 24), (2, 8, 3, 130), (1, 4, 200, 180)],
                         ids=lambda s: 'x'.join(map(str, s)))
def test_kernel_matches_plain(dev, dtype, shape):
    """Odd H and W, E not a multiple of 32, a plane wider than the block and
    one larger than the shared-memory tile (strips)."""
    check(inputs(dev, *shape, dtype))


def test_zero_border(dev):
    e = 8
    u = torch.zeros((1, e, 6, 6), device=dev)
    u[0, :, 0, 0] = 1.0
    ones = torch.ones(e, device=dev)
    args = (u, torch.ones((e, 1, 3, 3), device=dev), ones, ones * 0.5, ones, ones * 0)
    check(args)
    v, _ = mbconv_cuda.fused_mbconv_inner(*args)
    assert torch.isfinite(v).all()


def test_launch_count_and_errors(dev):
    args = inputs(dev, 1, 8, 5, 5, torch.float32)
    before = mbconv_cuda.fused_mbconv_inner.launches
    mbconv_cuda.fused_mbconv_inner(*args)
    mbconv_cuda.fused_mbconv_inner(*args)
    assert mbconv_cuda.fused_mbconv_inner.launches == before + 2
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        mbconv_cuda.fused_mbconv_inner(args[0].half(), *args[1:])
    with pytest.raises(ValueError, match='contiguous'):
        mbconv_cuda.fused_mbconv_inner(args[0].transpose(2, 3), *args[1:])
    with pytest.raises(ValueError, match='on cuda'):
        mbconv_cuda.fused_mbconv_inner(args[0], args[1].cpu(), *args[2:])
    assert mbconv_cuda.fused_mbconv_inner.launches == before + 2
