"""The port's native host image ops (`metrabs_tpu_torch/utils/native.py`,
`csrc/improc.cpp`) against the JAX package's (`metrabs_tpu/utils/native.py`
on the committed `native/libmetrabs_improc.so`): the same seeded inputs give
the same bits; the port's `bilinear_warp` as the third implementation of the
pyramid warp, beside the port's plain warp and JAX's (the check of
tests/test_native.py rebuilt for the port); a failed build raises."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.ops import warp as jax_warp
from metrabs_tpu.utils import native as jax_native
from metrabs_tpu_torch.ops import camera, cuda_build
from metrabs_tpu_torch.ops import warp as torch_warp
from metrabs_tpu_torch.utils import native

WARP_ATOL = 5e-4  # tests/test_native.py's tolerance of the C++ warp against XLA's


@pytest.fixture(autouse=True)
def jax_library_loaded():
    """JAX's module falls back to numpy without its library: the comparison
    must be against the C++."""
    assert jax_native.native_available(), 'native/libmetrabs_improc.so is missing'


@pytest.mark.parametrize('shape', [(37, 53, 3), (1, 1, 1), (16, 16)])
@pytest.mark.parametrize('gamma', [2.2, 1 / 2.2, 1.0])
def test_gamma_decode_equals_jax(shape, gamma):
    img = np.random.default_rng(0).integers(0, 256, size=shape, dtype=np.uint8)
    got = native.gamma_decode_u8(img, gamma)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_native.gamma_decode_u8(img, gamma))


@pytest.mark.parametrize('gamma', [2.2, 1 / 2.2, 0.6])
def test_gamma_encode_equals_jax(gamma):
    img = np.random.default_rng(1).uniform(-0.2, 1.2, size=(19, 23, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.gamma_encode_f32(img, gamma),
                                  jax_native.gamma_encode_f32(img, gamma))


@pytest.mark.parametrize('shape', [(10, 14, 3), (11, 15, 3), (64, 48, 1)])
def test_box_downsample_equals_jax(shape):
    img = np.random.default_rng(2).uniform(size=shape).astype(np.float32)
    np.testing.assert_array_equal(native.box_downsample_2x2(img),
                                  jax_native.box_downsample_2x2(img))


@pytest.mark.parametrize('center', [(5.0, 28.0), (16.0, 16.0), (-3.0, 2.5), (40.0, 40.0)])
def test_paste_over_equals_jax_and_the_numpy_version(center):
    from metrabs_tpu_torch.data.augment.occlusion import paste_over as np_paste
    rng = np.random.default_rng(3)
    dst = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    src = rng.uniform(size=(10, 12, 3)).astype(np.float32)
    alpha = rng.uniform(size=(10, 12)).astype(np.float32)
    got = native.paste_over(src, alpha, dst.copy(), center)
    np.testing.assert_array_equal(got, jax_native.paste_over(src, alpha, dst.copy(), center))
    if all(float(c).is_integer() for c in center):
        # At half-integer centres the C++ rounds half away from zero
        # (lround), numpy's version to even: they place the patch 1 px apart.
        np.testing.assert_allclose(got, np_paste(src, dst.copy(), alpha, np.asarray(center),
                                                 inplace=True), atol=1e-5)


def test_bilinear_warp_equals_jax():
    rng = np.random.default_rng(4)
    img = rng.uniform(size=(32, 40, 3)).astype(np.float32)
    k = np.array([[20.0, 0, 16], [0, 21.0, 15], [0, 0, 1]])
    new_k = np.array([[18.0, 0.5, 8], [0, 18.0, 9], [0, 0, 1]])
    d = np.array([-0.2, 0.05, 1e-3, -1e-3, 0.01, 0.02, -0.01, 0.005, 1e-3, -5e-4, 2e-4, -1e-4])
    args = (img, np.linalg.inv(new_k), k, d, (17, 19))
    np.testing.assert_array_equal(native.bilinear_warp(*args), jax_native.bilinear_warp(*args))


@pytest.mark.parametrize('antialias_factor', [1, 2])
def test_pyramid_warp_3way_all_levels_full_distortion(antialias_factor):
    """tests/test_native.py's three-way check for the port: every pyramid
    level, all 12 coefficients, both antialias factors. The port's
    `bilinear_warp` on the box-downsampled level image with the
    level-adjusted K, the port's plain warp and JAX's warp agree within
    5e-4; the level images are those `build_flat_pyramid` makes."""
    rng = np.random.default_rng(42)
    n_levels, res = 3, 32
    out_side = res * antialias_factor
    img = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    k_old = np.array([[50.0, 0, 32], [0, 50.0, 32], [0, 0, 1]])
    d12 = np.array([-0.15, 0.05, 1e-3, -1e-3, 0.01, 0.02, -0.01, 0.005,
                    1e-3, -5e-4, 2e-4, -1e-4])
    base_scales = np.array([1.0, 0.4, 0.2], np.float32)
    image_ids = np.array([0, 1, 0])
    new_invproj = []
    for scale in base_scales:
        f = res * 0.9 * scale
        m = np.linalg.inv(np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1]]))
        if antialias_factor > 1:
            m = m @ camera.corner_aligned_scale_mat(1.0 / antialias_factor).double().numpy()
        new_invproj.append(m)
    case = dict(intrinsic_matrix=np.tile(k_old[None], (3, 1, 1)).astype(np.float32),
                new_invprojmat=np.asarray(new_invproj, np.float32),
                distortion_coeffs=np.tile(d12[None], (3, 1)).astype(np.float32),
                crop_scales=base_scales * antialias_factor, image_ids=image_ids)

    got_jax = np.asarray(jax_warp.warp_images_with_pyramid(
        jnp.asarray(img), **{k: jnp.asarray(v) for k, v in case.items()},
        output_shape=(out_side, out_side)))
    t = {k: torch.as_tensor(v) for k, v in case.items()}
    got_plain = torch_warp.warp_images_with_pyramid(
        torch.as_tensor(img), **t, output_shape=(out_side, out_side)).numpy()
    levels, _ = torch_warp.select_pyramid_level(t['crop_scales'], t['intrinsic_matrix'],
                                                n_levels)
    if antialias_factor == 1:
        assert levels.tolist() == [0, 1, 2]
    flat, info, per_image = torch_warp.build_flat_pyramid(torch.as_tensor(img), n_levels)
    params, geom = torch_warp.pyramid_warp_params(level_info=info, per_image_len=per_image, **t)
    got_native = native.warp_params_oracle(flat, params, geom, (out_side, out_side))
    for i, level in enumerate(levels.tolist()):
        msg = f'crop {i} (level {level}, antialias {antialias_factor})'
        np.testing.assert_allclose(got_native[i], got_plain[i], atol=WARP_ATOL, err_msg=msg)
        np.testing.assert_allclose(got_native[i], got_jax[i], atol=WARP_ATOL, err_msg=msg)
    np.testing.assert_allclose(got_plain, got_jax, atol=WARP_ATOL)
    # The level images cut from the flat buffer are the explicit box pyramid.
    offset, hp, wp = info[2]
    level2 = flat.reshape(2, per_image, 3)[0, offset:offset + hp * wp].reshape(hp, wp, 3)
    np.testing.assert_allclose(level2[1:-1, 1:-1].numpy(), native.box_downsample_2x2(
        native.box_downsample_2x2(img[0])), atol=1e-6)


def test_failed_build_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    """With the compiler failing (`CXX=false`) into an empty build directory,
    the build raises naming the compiler, `native_available` says False and
    each function raises rather than computing in numpy."""
    monkeypatch.setattr(cuda_build, 'BUILD_DIR', tmp_path)
    monkeypatch.setenv('CXX', 'false')
    monkeypatch.setattr(native, '_LIB', None)
    with pytest.raises(RuntimeError, match='false failed on .*improc.cpp'):
        cuda_build.build_host_library('improc')
    assert not native.native_available()
    img = np.zeros((4, 4, 3), np.float32)
    for call in (lambda: native.gamma_decode_u8(img.astype(np.uint8)),
                 lambda: native.gamma_encode_f32(img, 2.2),
                 lambda: native.box_downsample_2x2(img),
                 lambda: native.paste_over(img, img[..., 0], img.copy(), (1, 1)),
                 lambda: native.bilinear_warp(img, np.eye(3), np.eye(3), [0.0], (2, 2))):
        with pytest.raises(RuntimeError, match='false failed'):
            call()
    assert not list(tmp_path.glob('*.so'))
