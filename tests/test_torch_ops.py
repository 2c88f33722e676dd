"""Parity of the geometry ops of `metrabs_tpu_torch` with `metrabs_tpu`.

Same float32 inputs (numpy, seeded) through the JAX function and its port.
Tolerances: atol 1e-4 on pixel-scale values and 1e-3 on millimetre values,
rtol 1e-5: both sides compute in float32, so only the order of operations
differs (einsum vs explicit sums, LU solve vs torch.linalg.solve), which
moves results by a few ulps of values up to ~1e4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.models.backbones import common as jax_common
from metrabs_tpu.ops import camera as jcam
from metrabs_tpu.ops import distortion as jdist
from metrabs_tpu.ops import heatmap as jhm
from metrabs_tpu.ops import heatmap_decode as jsa
from metrabs_tpu.ops import masked as jmasked
from metrabs_tpu.ops import reconstruct as jrec
from metrabs_tpu.ops import rotation as jrot
from metrabs_tpu.pipeline import estimator as jest
from metrabs_tpu_torch.models.backbones import common as tcommon
from metrabs_tpu_torch.ops import camera as tcam
from metrabs_tpu_torch.ops import distortion as tdist
from metrabs_tpu_torch.ops import heatmap as thm
from metrabs_tpu_torch.ops import heatmap_decode as tsa
from metrabs_tpu_torch.ops import masked as tmasked
from metrabs_tpu_torch.ops import reconstruct as trec
from metrabs_tpu_torch.ops import rotation as trot
from metrabs_tpu_torch.pipeline import estimator as test_

PX = dict(atol=1e-4, rtol=1e-5)
MM = dict(atol=1e-3, rtol=1e-5)


def t(a):
    return torch.tensor(np.array(a))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or PX))


def dist_coeffs(rng, n, scale=1.0):
    d = np.zeros((n, 12), np.float32)
    d[:, 0] = rng.uniform(-0.2, 0.2, n) * scale
    d[:, 1] = rng.uniform(-0.05, 0.05, n) * scale
    d[:, 2:4] = rng.uniform(-0.01, 0.01, (n, 2)) * scale
    d[:, 4] = rng.uniform(-0.01, 0.01, n) * scale
    d[:, 5:8] = rng.uniform(-0.02, 0.02, (n, 3)) * scale
    d[:, 8:12] = rng.uniform(-0.005, 0.005, (n, 4)) * scale
    return d


def test_divide_no_nan(rng):
    x = rng.normal(size=(4, 5)).astype(np.float32)
    y = rng.normal(size=(4, 5)).astype(np.float32)
    y[1, 2] = y[3, 0] = 0.0
    close(tmasked.divide_no_nan(t(x), t(y)), jmasked.divide_no_nan(x, y))


@pytest.mark.parametrize('axis', [None, 0, 1, (1, 2)])
def test_reduce_mean_masked(rng, axis):
    x = rng.normal(size=(3, 4, 2)).astype(np.float32)
    valid = rng.uniform(size=(3, 4)) > 0.4
    valid[2] = False
    close(tmasked.reduce_mean_masked(t(x), t(valid), axis=axis),
          jmasked.reduce_mean_masked(x, valid, axis=axis))


@pytest.mark.parametrize('fixed_ref', [False, True])
def test_mean_stdev_masked(rng, fixed_ref):
    x = rng.normal(size=(5, 17, 2)).astype(np.float32) * 100
    valid = rng.uniform(size=(5, 17)) > 0.3
    valid[0] = False
    ref = rng.normal(size=(5, 1, 2)).astype(np.float32) if fixed_ref else None
    got = tmasked.mean_stdev_masked(t(x), t(valid), -2, -1,
                                    fixed_ref=None if ref is None else t(ref))
    want = jmasked.mean_stdev_masked(x, valid, -2, -1, fixed_ref=ref)
    for g, w in zip(got, want):
        close(g, w, **MM)


@pytest.mark.parametrize('fov,shape', [(55.0, (240, 320)), (30.0, (1080, 1920)),
                                       (90.0, (700, 500))])
def test_intrinsics_from_fov(fov, shape):
    close(tcam.intrinsics_from_fov(fov, shape), jcam.intrinsics_from_fov(fov, shape))


@pytest.mark.parametrize('factor', [0.5, 0.25, 1 / 3, 2.0])
def test_corner_aligned_scale_mat(factor):
    close(tcam.corner_aligned_scale_mat(factor), jcam.corner_aligned_scale_mat(factor))


def test_project_and_homogeneous(rng):
    p = (rng.normal(size=(3, 7, 3)) + [0, 0, 5]).astype(np.float32)
    close(tcam.project(t(p)), jcam.project(p))
    close(tcam.to_homogeneous(t(p)), jcam.to_homogeneous(p))


def test_lookat_rotation_matrix(rng):
    fwd = rng.normal(size=(6, 3)).astype(np.float32)
    fwd[0] = [0, -2, 0]  # parallel to up: the fallback basis
    up = np.array([0, -1, 0], np.float32)
    close(trot.lookat_rotation_matrix(t(fwd), t(up)), jrot.lookat_rotation_matrix(fwd, up))
    ups = rng.normal(size=(6, 3)).astype(np.float32)
    close(trot.lookat_rotation_matrix(t(fwd), t(ups)), jrot.lookat_rotation_matrix(fwd, ups))


@pytest.mark.parametrize('n_coeffs', [4, 5, 8, 12])
def test_pad_distortion_coeffs(rng, n_coeffs):
    d = rng.normal(size=(3, n_coeffs)).astype(np.float32)
    close(tdist.pad_distortion_coeffs(t(d)), jdist.pad_distortion_coeffs(d))


def test_pad_distortion_coeffs_rejects_13():
    with pytest.raises(ValueError):
        tdist.pad_distortion_coeffs(torch.zeros(2, 13))


@pytest.mark.parametrize('coeff_shape', ['per_batch', 'shared'])
def test_distort_points(rng, coeff_shape):
    pts = rng.uniform(-0.6, 0.6, size=(4, 9, 2)).astype(np.float32)
    d = dist_coeffs(rng, 4)
    d = d[:, None, :] if coeff_shape == 'per_batch' else d[0]
    close(tdist.distort_points(t(pts), t(d)), jdist.distort_points(pts, d))


def test_undistort_points_inverts_distort(rng):
    pts = rng.uniform(-0.5, 0.5, size=(4, 9, 2)).astype(np.float32)
    d = dist_coeffs(rng, 4)[:, None, :]
    distorted = jdist.distort_points(pts, d)
    got = tdist.undistort_points(t(np.asarray(distorted)), t(d))
    close(got, jdist.undistort_points(distorted, d))
    # The fixed 5-step inverse is close to, not exactly, the true inverse.
    close(got, pts, atol=1e-3, rtol=0)


@pytest.mark.parametrize('axes', [(2, 1, 3), (2, 1)])
def test_soft_argmax(rng, axes):
    shape = (3, 4, 5, 8, 17) if len(axes) == 3 else (3, 4, 5, 17)
    logits = rng.normal(size=shape).astype(np.float32) * 3
    close(tsa.soft_argmax(t(logits), axes), jsa.soft_argmax(logits, axes))


@pytest.mark.parametrize('centered', [True, False])
@pytest.mark.parametrize('stride', [32, 16, 8])
def test_heatmap_mappings(rng, centered, stride):
    c = rng.uniform(0, 1, size=(2, 17, 3)).astype(np.float32)
    kw = dict(proc_side=256, stride=stride, centered_stride=centered)
    close(thm.heatmap_to_image(t(c[..., :2]), **kw), jhm.heatmap_to_image(c[..., :2], **kw))
    close(thm.heatmap_to_metric(t(c), box_size_mm=2200.0, **kw),
          jhm.heatmap_to_metric(c, box_size_mm=2200.0, **kw), **MM)


@pytest.mark.parametrize('centered', [True, False])
def test_is_within_fov(rng, centered):
    c = rng.uniform(-10, 270, size=(4, 17, 2)).astype(np.float32)
    kw = dict(proc_side=256, stride=32, centered_stride=centered)
    np.testing.assert_array_equal(trec.is_within_fov(t(c), **kw).numpy(),
                                  np.asarray(jrec.is_within_fov(c, **kw)))


def _recon_inputs(rng, n=6, j=17):
    """2D predictions consistent-ish with 3D ones, as a trained model gives."""
    rel = (rng.normal(size=(n, j, 3)) * [300, 400, 200]).astype(np.float32)
    depth = rng.uniform(2000, 6000, size=(n, 1)).astype(np.float32)
    f = 256 / 2200 * depth  # the crop's focal length
    k = np.zeros((n, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = f[:, 0]
    k[:, :2, 2] = 128
    k[:, 2, 2] = 1
    cam = rel + np.concatenate([np.zeros((n, 1, 2)), depth[:, :, None]], -1)
    p2d = np.einsum('njk,nck->njc', cam / cam[..., 2:], k)[..., :2]
    p2d += rng.normal(size=p2d.shape) * 4
    p2d[:, :2] = rng.uniform(-30, 300, size=(n, 2, 2))  # some joints leave the FOV
    return p2d.astype(np.float32), rel, k


@pytest.mark.parametrize('weak', [False, True])
@pytest.mark.parametrize('valid', ['all', 'partly', 'none', 'absent'])
def test_reconstruct_absolute(rng, weak, valid):
    p2d, rel, k = _recon_inputs(rng)
    sample_valid = {'all': np.ones(6, bool), 'partly': np.arange(6) % 3 != 1,
                    'none': np.zeros(6, bool), 'absent': None}[valid]
    if sample_valid is not None and not sample_valid.all():
        # Padding crops carry non-finite coordinates; they must not leak.
        p2d[~sample_valid] = np.nan
    kw = dict(proc_side=256, stride=32, mix_3d_inside_fov=0.5, weak_perspective=weak)
    got = trec.reconstruct_absolute(
        t(p2d), t(rel), t(k), sample_valid=None if sample_valid is None else t(sample_valid),
        **kw)
    want = np.asarray(jrec.reconstruct_absolute(p2d, rel, k, sample_valid=sample_valid, **kw))
    keep = np.ones(6, bool) if sample_valid is None or weak else sample_valid
    np.testing.assert_allclose(got.numpy()[keep], want[keep], atol=1e-3, rtol=1e-4)
    assert np.isfinite(got.numpy()[keep]).all()


def test_fixed_padding_amounts():
    for k, rate, shift in [(3, 1, 0), (3, 1, 1), (3, 2, 0), (3, 4, 0), (5, 1, 1), (1, 1, 0)]:
        assert (tcommon.fixed_padding_amounts(k, rate, shift)
                == jax_common.fixed_padding_amounts(k, rate, shift))


def test_tf_preproc(rng):
    x = rng.uniform(size=(2, 4, 4, 3)).astype(np.float32)
    close(tcommon.tf_preproc(t(x)), jax_common.tf_preproc(jnp.asarray(x)))


@pytest.mark.parametrize('distorted', [False, True])
def test_get_new_rotation_and_scale(rng, distorted):
    n = 7
    k = np.tile(np.array([[800, 0, 640], [0, 800, 360], [0, 0, 1]], np.float32), (n, 1, 1))
    d = dist_coeffs(rng, n) if distorted else np.zeros((n, 12), np.float32)
    up = (rng.normal(size=(n, 3)) * 0.2 + [0, -1, 0]).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0, 900, (n, 2)), rng.uniform(50, 400, (n, 2))],
                           1).astype(np.float32)
    boxes[2] = 0.0
    valid = np.ones(n, bool)
    valid[[2, 5]] = False
    got = test_._get_new_rotation_and_scale(t(k), t(d), t(up), t(boxes), t(valid), 256)
    want = jest._get_new_rotation_and_scale(k, d, up, boxes, valid, 256)
    close(got[0], want[0])
    close(got[1], want[1])
