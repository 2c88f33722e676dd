"""The fused MBConv CUDA kernel (`metrabs_tpu_torch/csrc/mbconv.cu`) on the
card, against its plain PyTorch version on the same device and inputs.

These tests need an NVIDIA GPU with the CUDA toolkit (sm_90a) and skip
elsewhere. The file imports neither jax nor the test conftest's jax setup:

    python -m pytest --noconftest -m cuda tests/test_torch_mbconv_cuda.py

Agreement: v exactly equal in float32 and bfloat16 (the kernel follows the
plain version's operations in order and is built without FMA contraction);
the SE mean within 1e-5 (it sums the same values in another order).
"""

import numpy as np
import pytest
import torch

from metrabs_tpu_torch.ops import mbconv, mbconv_cuda

pytestmark = pytest.mark.cuda
MEAN_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: python -m pytest --noconftest -m cuda '
                    'tests/test_torch_mbconv_cuda.py on a GPU machine')
    return torch.device('cuda')


def inputs(dev, n, e, h, w, dtype, seed=0):
    g = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    u = t(g.normal(size=(n, e, h, w)) * 2).to(dtype)
    return (u,) + mbconv.inner_constants(
        t(g.normal(size=(e, 1, 3, 3)) * 0.3), t(g.uniform(0.5, 1.5, e)), t(g.normal(size=e) * 0.2),
        t(g.uniform(0.5, 1.5, e)), t(g.normal(size=e) * 0.2))


def check(args):
    got_v, got_mean = mbconv_cuda.fused_mbconv_inner(*args)
    want_v, want_mean = mbconv.fused_mbconv_inner(*args)
    torch.cuda.synchronize()
    assert got_v.dtype == args[0].dtype and got_v.shape == args[0].shape
    assert got_mean.dtype == torch.float32 and got_mean.shape == args[0].shape[:2]
    torch.testing.assert_close(got_v, want_v, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got_mean, want_mean, equal_nan=True, **MEAN_TOL)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('shape', [
    (4, 100, 8, 8), (3, 50, 12, 12), (2, 70, 16, 16), (1, 30, 24, 24),  # ragged last step
    (2, 64, 8, 8), (2, 16, 12, 10), (2, 40, 7, 9), (3, 33, 16, 16), (1, 24, 24, 24),
    (2, 8, 3, 130),
    (1, 4, 200, 180), (1, 3, 61, 67)],  # planes above a warp step's budget: the strip kernel
    ids=lambda s: 'x'.join(map(str, s)))
def test_kernel_matches_plain(dev, dtype, shape):
    """The stage planes 8x8 to 24x24, N*E not a multiple of the planes per
    warp step, odd H and W (shorter runs), and planes for the strip
    kernel."""
    check(inputs(dev, *shape, dtype))


@pytest.mark.parametrize('bn0', ['random', 'identity'])
def test_every_finite_bf16_input(dev, bn0):
    """u holds each of the 65280 finite bfloat16 values once (255 planes of
    16x16), subnormals and the largest values included, so the packed bf16
    BN meets every input it can get; with the first BN the identity, the
    first silu (the kernel's table and the values it computes) does too."""
    bits = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    values = bits[torch.isfinite(bits.float())]
    assert values.numel() == 255 * 16 * 16
    _, taps, sb = inputs(dev, 1, 255, 16, 16, torch.bfloat16)
    if bn0 == 'identity':
        sb[0], sb[1] = 1.0, 0.0
    u = values.reshape(1, 255, 16, 16).to(dev).contiguous()
    check((u, taps, sb))


def test_zero_border(dev):
    e = 8
    u = torch.zeros((1, e, 6, 6), device=dev)
    u[0, :, 0, 0] = 1.0
    ones = torch.ones(e, device=dev)
    args = (u,) + mbconv.inner_constants(torch.ones((e, 1, 3, 3), device=dev), ones,
                                         ones * 0.5, ones, ones * 0)
    check(args)
    v, _ = mbconv_cuda.fused_mbconv_inner(*args)
    assert torch.isfinite(v).all()


def test_launch_count_and_errors(dev):
    u, taps, sb = inputs(dev, 1, 8, 5, 5, torch.float32)
    before = mbconv_cuda.fused_mbconv_inner.launches
    by_shape = mbconv_cuda.fused_mbconv_inner.launches_by_shape
    before_shape = by_shape.get((1, 8, 5, 5, 'float32'), 0)
    mbconv_cuda.fused_mbconv_inner(u, taps, sb)
    mbconv_cuda.fused_mbconv_inner(u, taps, sb)
    assert mbconv_cuda.fused_mbconv_inner.launches == before + 2
    assert by_shape[(1, 8, 5, 5, 'float32')] == before_shape + 2
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        mbconv_cuda.fused_mbconv_inner(u.half(), taps, sb)
    with pytest.raises(ValueError, match='contiguous'):
        mbconv_cuda.fused_mbconv_inner(u.transpose(2, 3), taps, sb)
    with pytest.raises(ValueError, match='aligned'):
        shifted = torch.empty(u.numel() + 1, device=dev)[1:].view(u.shape)
        mbconv_cuda.fused_mbconv_inner(shifted, taps, sb)
    with pytest.raises(ValueError, match='on cuda'):
        mbconv_cuda.fused_mbconv_inner(u, taps.cpu(), sb)
    with pytest.raises(ValueError, match='taps must be'):
        mbconv_cuda.fused_mbconv_inner(u, taps[:, :8].contiguous(), sb)
    assert mbconv_cuda.fused_mbconv_inner.launches == before + 2
