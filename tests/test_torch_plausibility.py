"""The port's plausibility filter and pose NMS (`metrabs_tpu_torch/pipeline/
plausibility.py`, `metrabs_tpu_torch/ops/nms.py`) against
`metrabs_tpu/pipeline/plausibility.py` and `metrabs_tpu/ops/nms.py`.

Random poses from a numpy seed: people of plausible size at a few metres,
with per-pose and per-aug noise, some with a broken limb, some near
duplicates of others; boxes around and beside their 2D projections. The
boolean outputs must be identical; real-valued ones agree to float32
rounding (rtol 1e-4 on stdevs in mm: the poses lie metres away, where a
float32 ulp is ~5e-4 mm; atol 1e-5 on similarities in [0, 1]). The
JAX functions run per image (as the estimator vmaps them); the port's take
the image axis as a batch axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.ops import nms as jax_nms
from metrabs_tpu.pipeline import bone_priors
from metrabs_tpu.pipeline import plausibility as jax_plaus
from metrabs_tpu.pipeline.skeletons import H36M_17
from metrabs_tpu_torch.ops import nms
from metrabs_tpu_torch.pipeline import plausibility as plaus

N_IMAGES, N_POSES, N_AUG = 3, 10, 3
J2B = H36M_17.joint2bone_matrix()
MEAN_BONES = bone_priors.priors_for_joint_info(H36M_17)


def template():
    return np.asarray([bone_priors.BASE_TEMPLATE_MM[n] for n in H36M_17.names], np.float32)


def scene(seed=0):
    """poses3d [B, n, A, 17, 3] mm, poses2d [B, n, A, 17, 2] px, boxes
    [B, n, 5], valid [B, n]."""
    g = np.random.default_rng(seed)
    base = template()
    shape = (N_IMAGES, N_POSES)
    scale = g.uniform(0.8, 1.2, shape)[..., None, None]
    center = np.stack([g.uniform(-1500, 1500, shape), g.uniform(-300, 300, shape),
                       g.uniform(2500, 6000, shape)], axis=-1)[..., None, :]
    poses = base * scale + center + g.normal(0, 30, shape + (17, 3))
    poses[:, 1, 16] += [900.0, 0, 0]  # a broken arm: implausible
    poses[:, 2] = poses[:, 3] + g.normal(0, 20, (N_IMAGES, 17, 3))  # a duplicate
    aug_spread = g.choice([20.0, 400.0], p=[0.8, 0.2], size=shape)
    aug_spread[:, 2:4] = 20.0  # the duplicates stay duplicates after the aug mean
    aug_noise = g.normal(0, 1, shape + (N_AUG, 17, 3)) * aug_spread[..., None, None, None]
    poses3d = (poses[:, :, None] + aug_noise).astype(np.float32)
    proj = 1000.0 * poses3d[..., :2] / poses3d[..., 2:] + [960.0, 540.0]
    mean2d = proj.mean(axis=2)
    lo, hi = mean2d.min(axis=-2), mean2d.max(axis=-2)
    boxes = np.concatenate([lo - 10, hi - lo + 20], axis=-1)
    boxes[:, 4, :2] += 3 * boxes[:, 4, 2:4]  # a box beside its pose
    scores = g.uniform(0.3, 1.0, shape)
    boxes5 = np.concatenate([boxes, scores[..., None]], axis=-1).astype(np.float32)
    valid = g.uniform(size=shape) > 0.15
    return poses3d, proj.astype(np.float32), boxes5, valid


def per_image(fn, *arrays, **kwargs):
    return np.stack([np.asarray(fn(*(jnp.asarray(a[b]) for a in arrays), **kwargs))
                     for b in range(arrays[0].shape[0])])


def t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def test_is_pose_plausible():
    poses3d = scene()[0].mean(axis=2)
    want = np.asarray(jax_plaus.is_pose_plausible(poses3d, J2B, MEAN_BONES))
    got = plaus.is_pose_plausible(*t(poses3d, J2B, MEAN_BONES)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not want[:, 1].any() and want.sum() > want.size // 2


def test_is_pose_plausible_slices_to_model_joints():
    """Poses extended by a joint transform feed only the model joints."""
    poses3d = scene(1)[0].mean(axis=2)
    extended = np.concatenate([poses3d, poses3d[..., :3, :] * 5], axis=-2)
    want = np.asarray(jax_plaus.is_pose_plausible(extended, J2B, MEAN_BONES))
    got = plaus.is_pose_plausible(*t(extended, J2B, MEAN_BONES)).numpy()
    np.testing.assert_array_equal(got, want)


def test_scale_align_and_point_stdev():
    poses3d = scene()[0]
    want = np.asarray(jax_plaus.point_stdev(jax_plaus.scale_align(poses3d), -3, -1))
    got = plaus.point_stdev(plaus.scale_align(torch.as_tensor(poses3d)), -3, -1).numpy()
    assert got.shape == want.shape == (N_IMAGES, N_POSES, 17)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_are_augmentation_results_consistent():
    poses3d = scene()[0]
    want = per_image(jax_plaus.are_augmentation_results_consistent, poses3d)
    got = plaus.are_augmentation_results_consistent(torch.as_tensor(poses3d)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_is_pose_consistent_with_box():
    _, poses2d, boxes, _ = scene()
    mean2d = poses2d.mean(axis=2)
    want = np.asarray(jax_plaus.is_pose_consistent_with_box(mean2d, boxes))
    got = plaus.is_pose_consistent_with_box(*t(mean2d, boxes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not want[:, 4].any() and want.sum() > want.size // 2


def test_compute_pose_similarity():
    poses = scene()[0].mean(axis=2)
    want = per_image(jax_plaus.compute_pose_similarity, poses)
    got = plaus.compute_pose_similarity(torch.as_tensor(poses)).numpy()
    assert got.shape == (N_IMAGES, N_POSES, N_POSES)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (want[:, 2, 3] > 0.4).all()  # the duplicates


@pytest.mark.parametrize('max_output', [150, 3])
def test_pose_non_max_suppression(max_output):
    poses3d, _, boxes, valid = scene()
    poses = poses3d.mean(axis=2)
    want = per_image(jax_plaus.pose_non_max_suppression, poses, boxes[..., 4], valid,
                     max_output=max_output)
    got = plaus.pose_non_max_suppression(*t(poses, boxes[..., 4], valid),
                                         max_output=max_output).numpy()
    np.testing.assert_array_equal(got, want)
    assert not (want[:, 2] & want[:, 3]).any()
    assert (want.sum(axis=-1) <= max_output).all()


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_suppress_implausible_poses(seed):
    poses3d, poses2d, boxes, valid = scene(seed)
    want = per_image(lambda *a: jax_plaus.suppress_implausible_poses(
        *a, jnp.asarray(J2B), jnp.asarray(MEAN_BONES)), poses3d, poses2d, boxes, valid)
    got = plaus.suppress_implausible_poses(
        *t(poses3d, poses2d, boxes, valid, J2B, MEAN_BONES)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not (want & ~valid).any()


def nms_case(seed, n=12, ties=False):
    g = np.random.default_rng(seed)
    overlap = g.uniform(size=(4, n, n)).astype(np.float32)
    overlap = (overlap + overlap.transpose(0, 2, 1)) / 2
    scores = (g.integers(0, 4, (4, n)) / 4 if ties else g.uniform(size=(4, n))).astype(np.float32)
    valid = g.uniform(size=(4, n)) > 0.25
    return overlap, scores, valid


@pytest.mark.parametrize('ties', [False, True], ids=['distinct', 'ties'])
@pytest.mark.parametrize('max_output', [100, 2])
def test_greedy_nms(ties, max_output):
    """Tied scores are visited in index order on both sides (stable argsort);
    invalid candidates are never kept and never suppress."""
    overlap, scores, valid = nms_case(3, ties=ties)
    want = per_image(jax_nms.greedy_nms, overlap, scores, valid, threshold=0.6,
                     max_output=max_output)
    got = nms.greedy_nms(*t(overlap, scores, valid), 0.6, max_output).numpy()
    np.testing.assert_array_equal(got, want)
    assert not (got & ~valid).any() and (got.sum(axis=-1) <= max_output).all()


def test_greedy_nms_invalid_never_suppresses():
    overlap = np.ones((1, 3, 3), np.float32)
    scores = np.array([[0.9, 0.8, 0.7]], np.float32)
    valid = np.array([[False, True, True]])
    got = nms.greedy_nms(*t(overlap, scores, valid), 0.5, 10).numpy()
    np.testing.assert_array_equal(got, [[False, True, False]])
    np.testing.assert_array_equal(
        got[0], np.asarray(jax.jit(jax_nms.greedy_nms, static_argnums=(3, 4))(
            overlap[0], scores[0], valid[0], 0.5, 10)))
