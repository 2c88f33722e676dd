"""The CUDA warp kernel (`metrabs_tpu_torch/csrc/warp.cu`) on the card, against
its plain PyTorch version on the same device and inputs.

These tests need an NVIDIA GPU with the CUDA toolkit (sm_90a) and skip
elsewhere. The file imports neither jax nor the test conftest's jax setup, so
that it runs on a GPU machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_warp_cuda.py

Tolerance: 1e-4 on linear [0, 1] values; the kernel is built without FMA
contraction and evaluates the plain version's operations in its order, so
in practice the two agree exactly.
"""

import numpy as np
import pytest
import torch

# By its directory-local name (pytest puts tests/ on sys.path): a `tests`
# package installed in site-packages can shadow `tests._torch_port`.
import _torch_port
from _torch_port import CASES, make_case
from metrabs_tpu_torch.ops import warp, warp_cuda

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: python -m pytest --noconftest -m cuda '
                    'tests/test_torch_warp_cuda.py on a GPU machine')
    return torch.device('cuda')


def kernel_inputs(name, dev, seed=0):
    case = make_case(name, np.random.default_rng(seed))
    t = {k: torch.tensor(v, device=dev) for k, v in case.items() if k != 'output_shape'}
    flat, info, per_image = warp.build_flat_pyramid(t.pop('images'), 3)
    params, geom = warp.pyramid_warp_params(level_info=info, per_image_len=per_image, **t)
    return flat, params, geom, case['output_shape']


@pytest.mark.parametrize('name', CASES)
def test_kernel_matches_plain(dev, name):
    flat, params, geom, shape = kernel_inputs(name, dev)
    got = warp_cuda.warp_pyramid(flat, params, geom, shape)
    want = warp.warp_pyramid(flat, params, geom, shape)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize('out', [(64, 130), (7, 9), (33, 3), (16, 1), (20, 132)],
                         ids=lambda s: 'x'.join(map(str, s)))
def test_kernel_matches_plain_exactly_at_any_width(dev, out):
    """Output widths that end a row partway through a block's 128 columns
    (a thread's later pixels past the row end, masked) and one that fills
    its blocks; the kernel and the plain version round alike, so they agree
    exactly."""
    case = _torch_port.random_case(np.random.default_rng(3), out=out, distort=True)
    t = {k: torch.tensor(v, device=dev) for k, v in case.items() if k != 'output_shape'}
    flat, info, per_image = warp.build_flat_pyramid(t.pop('images'), 3)
    params, geom = warp.pyramid_warp_params(level_info=info, per_image_len=per_image, **t)
    got = warp_cuda.warp_pyramid(flat, params, geom, out)
    want = warp.warp_pyramid(flat, params, geom, out)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() == 0.0


def test_launch_counter_counts_kernel_launches(dev):
    flat, params, geom, shape = kernel_inputs('basic', dev)
    before = warp_cuda.warp_pyramid.launches
    warp_cuda.warp_pyramid(flat, params, geom, shape)
    warp_cuda.warp_pyramid(flat, params, geom, shape)
    warp.warp_pyramid(flat, params, geom, shape)  # the plain version counts nothing
    assert warp_cuda.warp_pyramid.launches == before + 2


def test_empty_batch(dev):
    flat, params, geom, shape = kernel_inputs('basic', dev)
    out = warp_cuda.warp_pyramid(flat, params[:0], geom[:0], shape)
    assert out.shape == (0,) + tuple(shape) + (3,)


@pytest.mark.parametrize('fault', ['dtype', 'strided', 'channels', 'geom_dtype',
                                   'params_on_cpu', 'crop_count'])
def test_wrapper_rejects_bad_inputs(dev, fault):
    flat, params, geom, shape = kernel_inputs('basic', dev)
    if fault == 'dtype':
        params = params.double()
    elif fault == 'strided':
        flat = torch.cat([flat, flat], dim=1)[:, ::2]
    elif fault == 'channels':
        flat = torch.cat([flat, flat[:, :1]], dim=1)
    elif fault == 'geom_dtype':
        geom = geom.int()
    elif fault == 'params_on_cpu':
        params = params.cpu()
    else:
        geom = geom[:-1]
    with pytest.raises(ValueError):
        warp_cuda.warp_pyramid(flat, params, geom, shape)


def test_geometry_outside_the_pyramid_gives_nan(dev):
    flat, params, geom, shape = kernel_inputs('basic', dev)
    geom = geom.clone()
    geom[0, 0] = flat.shape[0]
    out = warp_cuda.warp_pyramid(flat, params, geom, shape)
    assert torch.isnan(out[0]).all() and torch.isfinite(out[1:]).all()
