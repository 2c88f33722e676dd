"""The port's crop warp against the JAX package's two warp backends.

The plain PyTorch warp (what the kernel wrapper runs on CPU tensors) is held
against the JAX gather backend at atol 2e-4, the tolerance the TPU kernel is
held to against that backend (tests/test_warp_pallas.py), and against the
TPU kernel itself in interpret mode at 3e-4 (the f32-mode matmul
reassociation plus the gather difference), on linear [0, 1] values. Cases
are those of tests/test_warp_pallas.py; none is in the TPU kernel's clamped
regime (crop_scale <= 1/8). The CUDA kernel itself is tested on the card
(tests/test_torch_warp_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.ops import warp as jax_warp
from metrabs_tpu.ops import warp_pallas
from metrabs_tpu_torch.ops import warp, warp_cuda
from tests._torch_port import CASES, make_case, random_case

GATHER_TOL = 2e-4
TILED_TOL = 3e-4


def torch_case(case):
    return {k: (v if k == 'output_shape' else torch.tensor(v)) for k, v in case.items()}


def kernel_wrapper_warp(case, precision):
    """The estimator's route: pyramid + per-crop params + the kernel wrapper."""
    flat, info, per_image = warp.build_flat_pyramid(case['images'], 3)
    params, geom = warp.pyramid_warp_params(
        case['intrinsic_matrix'], case['new_invprojmat'], case['distortion_coeffs'],
        case['crop_scales'], case['image_ids'], info, per_image)
    return warp_cuda.warp_pyramid(flat, params, geom, case['output_shape'],
                                  precision=precision)


def jax_case(case):
    return {k: (v if k == 'output_shape' else jnp.asarray(v)) for k, v in case.items()}


@pytest.mark.parametrize('name', CASES)
def test_plain_warp_matches_jax_gather(rng, name):
    case = make_case(name, rng)
    want = np.asarray(jax_warp.warp_images_with_pyramid(**jax_case(case)))
    got = warp.warp_images_with_pyramid(**torch_case(case)).numpy()
    np.testing.assert_allclose(got, want, atol=GATHER_TOL, rtol=0)
    if name == 'zero_border':
        assert np.all(got == 0)
    else:
        assert np.abs(got).max() > 0.1


@pytest.mark.parametrize('name', CASES)
def test_wrapper_matches_jax_tiled_kernel(rng, name):
    case = make_case(name, rng)
    want = np.asarray(warp_pallas.warp_images_with_pyramid_tiled(
        **jax_case(case), interpret=True, precision='f32'))
    before = warp_cuda.warp_pyramid.launches
    got = kernel_wrapper_warp(torch_case(case), 'f32').numpy()
    np.testing.assert_allclose(got, want, atol=TILED_TOL, rtol=0)
    assert warp_cuda.warp_pyramid.launches == before  # CPU tensors: the plain version


@pytest.mark.parametrize('precision', ['highest', 'f32', 'high', 'bf16x3', 'bf16x2',
                                       'default', 'bf16'])
def test_every_precision_name_is_float32(rng, precision):
    case = torch_case(random_case(rng, n_crops=2, out=(32, 32)))
    got = kernel_wrapper_warp(case, precision)
    np.testing.assert_array_equal(got.numpy(), warp.warp_images_with_pyramid(**case).numpy())


@pytest.mark.parametrize('precision', ['HIGHEST', 'fp32', 'bf16x4', ''])
def test_unknown_precision_raises(rng, precision):
    case = torch_case(random_case(rng, n_crops=2, out=(32, 32)))
    with pytest.raises(ValueError, match='unknown warp precision'):
        kernel_wrapper_warp(case, precision)


def test_wrapper_rejects_other_devices(rng):
    case = torch_case(random_case(rng, n_crops=2, out=(32, 32)))
    case['images'] = case['images'].to('meta')
    with pytest.raises(ValueError, match='CPU or CUDA'):
        kernel_wrapper_warp(case, 'highest')


@pytest.mark.parametrize('scale', [0.9, 0.45, 0.2, 0.1, 3.0])
def test_select_pyramid_level_matches_jax(rng, scale):
    scales = (scale * rng.uniform(0.9, 1.1, size=6)).astype(np.float32)
    k = np.tile(np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32), (6, 1, 1))
    got = warp.select_pyramid_level(torch.tensor(scales), torch.tensor(k), 3)
    want = jax_warp.select_pyramid_level(jnp.asarray(scales), jnp.asarray(k), 3)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize('n', [2, 3])
def test_avg_pool_matches_jax(rng, n):
    x = rng.uniform(size=(2, 13, 17, 3)).astype(np.float32)
    np.testing.assert_allclose(warp.avg_pool_nxn(torch.tensor(x), n).numpy(),
                               np.asarray(jax_warp.avg_pool_nxn(jnp.asarray(x), n)),
                               atol=1e-6, rtol=0)


def test_pyramid_and_gather_match_jax_layout(rng):
    """The pixel-major pyramid holds the values of the JAX channel-major one."""
    images = rng.uniform(size=(2, 31, 45, 3)).astype(np.float32)
    flat, info, per_image = warp.build_flat_pyramid(torch.tensor(images), 3)
    jflat, jinfo, jper_image = jax_warp.build_flat_pyramid(jnp.asarray(images), 3)
    assert info == jinfo and per_image == jper_image
    np.testing.assert_allclose(flat.numpy().T, np.asarray(jflat), atol=1e-6, rtol=0)
    coords = rng.uniform(-5, 50, size=(4, 6, 7, 2)).astype(np.float32)
    level = np.array([0, 1, 2, 1])
    base = np.array([i[0] for i in info])[level] + np.array([0, 1, 0, 1]) * per_image
    hp = np.array([i[1] for i in info])[level]
    wp = np.array([i[2] for i in info])[level]
    got = warp.bilinear_gather_flat(flat, *(torch.tensor(a) for a in (base, hp, wp, coords)))
    want = jax_warp.bilinear_gather_flat(jflat, *(jnp.asarray(a) for a in (base, hp, wp, coords)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_warp_coords_matches_jax(rng):
    case = random_case(rng, distort=True)
    got = warp.warp_coords(torch.tensor(case['new_invprojmat']),
                           torch.tensor(case['intrinsic_matrix']),
                           torch.tensor(case['distortion_coeffs']), (16, 24))
    want = jax_warp.warp_coords(jnp.asarray(case['new_invprojmat']),
                                jnp.asarray(case['intrinsic_matrix']),
                                jnp.asarray(case['distortion_coeffs']), (16, 24))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-5)


def test_nan_coordinates_sample_the_zero_ring(rng):
    case = torch_case(random_case(rng, n_crops=2, out=(8, 8)))
    case['new_invprojmat'][0] = float('nan')
    got = warp.warp_images_with_pyramid(**case)
    assert torch.all(got[0] == 0) and torch.isfinite(got).all()
