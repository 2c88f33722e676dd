"""The port's evaluation layer against the JAX package's on the same inputs
(float32 on both sides unless said otherwise, on the CPU):

 - `ops.procrustes`: `procrustes_align` and `rigid_align` with scaling and
   reflection each on and off, on poses 3-5 m from the camera with invalid
   joints, an all-invalid row and a mirrored pose; aligned poses agree to
   ALIGN_ATOL_MM in float64 on both sides and to 2 float32 ulps at 4 m in
   float32 (where the two eigensolvers' rotations differ by ~2e-7), and the
   all-invalid row stays finite;
 - `eval.metrics.compute_pose3d_metrics` (2D error, wrist metrics, mean- and
   root-relative) and `eval.harness.evaluate_predictions` (all joints, and
   the 3DPW protocol's 14-joint subset at 50 mm) to METRIC_RTOL;
 - `matched_pose_metrics` and the association functions (keypoint and
   mask-IoU association, RLE decoding) equal to JAX's; `pose_to_mask` draws
   JAX's cv2 masks without cv2 (F4), at thicknesses 1-8;
 - the prediction dumps (NPZ and HDF5) read back equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from metrabs_tpu.eval import association as jax_association
from metrabs_tpu.eval import harness as jax_harness
from metrabs_tpu.eval import metrics as jax_metrics
from metrabs_tpu.ops import procrustes as jax_procrustes
from metrabs_tpu.pipeline import skeletons as jax_skeletons
from metrabs_tpu_torch.eval import association, harness, metrics
from metrabs_tpu_torch.ops import procrustes
from metrabs_tpu_torch.pipeline import skeletons

ALIGN_ATOL_MM = {'float64': 1e-4, 'float32': 1e-3}  # float32: 2 ulps at 4096 mm
METRIC_RTOL = 1e-5


def pose_pairs(seed: int = 0, n: int = 6, j: int = 17):
    """(pred, true, valid): true poses 3-5 m away, predictions a rotated,
    scaled, shifted and noisy copy; pose 1 mirrored (a reflection aligns
    it), pose 2 all invalid, pose 3 with three invalid joints."""
    rng = np.random.default_rng(seed)
    true = rng.normal(0, 300, (n, j, 3)) + np.array([0, 0, 4000]) + rng.normal(0, 500, (n, 1, 3))
    rot = Rotation.random(n, random_state=seed).as_matrix()
    pred = (np.einsum('njc,nkc->njk', true - true.mean(1, keepdims=True), rot)
            * rng.uniform(0.8, 1.2, (n, 1, 1)) + rng.normal(0, 200, (n, 1, 3))
            + true.mean(1, keepdims=True) + rng.normal(0, 30, (n, j, 3)))
    pred[1, :, 0] *= -1
    valid = np.ones((n, j), bool)
    valid[2] = False
    valid[3, [0, 5, 9]] = False
    return pred.astype(np.float32), true.astype(np.float32), valid


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
@pytest.mark.parametrize('scale', [False, True], ids=['rigid', 'scaled'])
@pytest.mark.parametrize('reflection', [False, True], ids=['proper', 'reflection'])
def test_rigid_align_matches_jax(scale, reflection, dtype):
    pred, true, valid = (a.astype(dtype) if a.dtype != bool else a for a in pose_pairs())
    with jax.enable_x64(dtype == 'float64'):
        want = np.asarray(jax_procrustes.rigid_align(
            jnp.asarray(pred), jnp.asarray(true), joint_validity_mask=jnp.asarray(valid),
            scale_align=scale, reflection_align=reflection))
    got = procrustes.rigid_align(torch.tensor(pred), torch.tensor(true),
                                 joint_validity_mask=torch.tensor(valid), scale_align=scale,
                                 reflection_align=reflection).numpy()
    assert got.dtype == want.dtype == dtype
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ALIGN_ATOL_MM[dtype])
    # The alignment did its work on the valid poses (the mirrored one only
    # with reflection allowed).
    rows = [0, 3, 4, 5] + ([1] if reflection else [])
    err = lambda p: np.linalg.norm(p - true, axis=-1)[rows][valid[rows]].mean()
    assert err(got) < 0.3 * err(pred), (err(got), err(pred))


def test_procrustes_align_without_mask_and_transform_match_jax():
    pred, true, _ = pose_pairs(seed=1)
    ones = np.ones(pred.shape[:2], bool)
    atol = ALIGN_ATOL_MM['float32']
    got = procrustes.procrustes_align(torch.tensor(true), torch.tensor(pred),
                                      torch.tensor(ones), allow_scaling=True).numpy()
    want = np.asarray(jax_procrustes.procrustes_align(true, pred, ones, allow_scaling=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(
        procrustes.rigid_align(torch.tensor(pred), torch.tensor(true), scale_align=True).numpy(),
        got, rtol=0, atol=atol)
    for g, w in zip(procrustes.procrustes_transform(torch.tensor(true), torch.tensor(pred),
                                                    torch.tensor(ones), True),
                    jax_procrustes.procrustes_transform(true, pred, ones, True)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_all_invalid_rows_stay_finite_with_gradients():
    pred, true, valid = pose_pairs()
    pred_t = torch.tensor(pred, requires_grad=True)
    out = procrustes.rigid_align(pred_t, torch.tensor(true),
                                 joint_validity_mask=torch.tensor(valid), scale_align=True)
    out.square().sum().backward()
    assert torch.isfinite(out).all() and torch.isfinite(pred_t.grad).all()


@pytest.mark.parametrize('mean_relative', [True, False], ids=['mean_rel', 'root_rel'])
@pytest.mark.parametrize('threshold', [150.0, 50.0])
def test_pose3d_metrics_match_jax(mean_relative, threshold):
    pred, true, valid = pose_pairs(seed=2)
    rng = np.random.default_rng(3)
    p2, t2 = rng.uniform(0, 256, (2,) + pred.shape[:2] + (2,)).astype(np.float32)
    kwargs = dict(coords2d_true=t2, coords2d_pred=p2, mean_relative=mean_relative,
                  threshold_mm=threshold)
    want = jax_metrics.compute_pose3d_metrics(pred, true, valid,
                                              joint_info=jax_skeletons.H36M_17, **kwargs)
    got = metrics.compute_pose3d_metrics(pred, true, valid, joint_info=skeletons.H36M_17,
                                         device='cpu', **kwargs)
    assert got.keys() == want.keys() and {'pck_wrists', 'auc_wrists', 'mean_error_2d'} <= set(got)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].device.type == 'cpu'
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=METRIC_RTOL, err_msg=k)
    rel = metrics.compute_pose3d_metrics(pred, true, valid, coords3d_pred_is_abs=False,
                                         device='cpu')
    assert 'mean_error_abs' not in rel and 'pck_wrists' not in rel


def dump(seed=4, n=40):
    rng = np.random.default_rng(seed)
    pred, true, valid = pose_pairs(seed, n)
    return dict(poses3d_pred_cam=pred, poses3d_true_cam=true, joint_validity_mask=valid,
                image_path=np.array([f'img_{i}.jpg' for i in range(n)]),
                poses3d_pred_world=pred + rng.normal(size=3).astype(np.float32))


@pytest.mark.parametrize('protocol', ['h36m', '3dpw'])
def test_evaluate_predictions_matches_jax(protocol):
    assert harness.BENCHMARK_PROTOCOLS.keys() == jax_harness.BENCHMARK_PROTOCOLS.keys()
    assert harness.JOINT_SUBSETS == jax_harness.JOINT_SUBSETS
    proto = harness.BENCHMARK_PROTOCOLS[protocol]
    assert proto == harness.EvalProtocol(**vars(jax_harness.BENCHMARK_PROTOCOLS[protocol]))
    subset = harness.JOINT_SUBSETS.get(proto.joint_subset)
    preds = dump()
    want = jax_harness.evaluate_predictions(preds, jax_skeletons.H36M_17,
                                            proto.pck_threshold_mm, subset)
    got = harness.evaluate_predictions(preds, skeletons.H36M_17, proto.pck_threshold_mm, subset,
                                       device='cpu')
    assert got.keys() == want.keys()
    assert ('pck_wrists' in got) == (subset is None)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL), k


@pytest.mark.parametrize('root_index,eval_joints', [(None, None), (0, [1, 2, 3, 5, 8, 16])])
def test_matched_pose_metrics_match_jax(root_index, eval_joints):
    rng = np.random.default_rng(5)
    gts = [rng.normal(0, 300, (k, 17, 3)) + [0, 0, 4000] for k in (2, 3, 0, 1)]
    preds = [np.concatenate([g + rng.normal(0, 60, g.shape), rng.normal(0, 300, (1, 17, 3))])
             [rng.permutation(len(g) + 1)] for g in gts]
    preds[3] = preds[3][:0]
    kwargs = dict(threshold_mm=100.0, root_index=root_index, eval_joints=eval_joints)
    got = harness.matched_pose_metrics(preds, gts, **kwargs)
    assert got == jax_harness.matched_pose_metrics(preds, gts, **kwargs)
    assert 0 < got['recall'] < 1


def test_prediction_dumps_read_back(tmp_path):
    preds = dump()
    harness.save_predictions(str(tmp_path / 'p.npz'), preds)
    with np.load(tmp_path / 'p.npz') as f:
        assert all(np.array_equal(f[k], v) for k, v in preds.items())


@pytest.mark.parametrize('name', ['p.h5', 'p.hdf5'])
def test_hdf5_dump_raises_naming_the_roadmap(tmp_path, name):
    """F5: the HDF5 writer imported h5py, which the card's machine lacks."""
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        harness.save_predictions(str(tmp_path / name), dump())
    assert not (tmp_path / name).exists()


def annotated(pose2d, confidence=0.9):
    """A COCO-19 annotation with the association joints of an H36M-17 pose."""
    out = np.zeros((19, 3), np.float32)
    for name in association.ASSOC_JOINTS:
        out[skeletons.COCO_19.ids[name], :2] = pose2d[skeletons.H36M_17.ids[name]]
        out[skeletons.COCO_19.ids[name], 2] = confidence
    return out


def test_keypoint_association_matches_jax():
    rng = np.random.default_rng(6)
    poses2d = [(rng.normal(size=(3, 17, 2)) * 30 + rng.uniform(50, 500, (3, 1, 2))).astype(
        np.float32) for _ in range(4)]
    poses3d = [rng.normal(size=(3, 17, 3)).astype(np.float32) for _ in range(4)]
    truth = [np.stack([annotated(p, c) for p, c in zip(frame[::-1], (0.9, 0.1, 0.9))])
             for frame in poses2d]
    poses2d[2], poses3d[2] = poses2d[2][:0], poses3d[2][:0]
    args = (poses3d, poses2d, truth)
    got = association.associate_sequence(*args, skeletons.H36M_17, skeletons.COCO_19)
    want = jax_association.associate_sequence(*args, jax_skeletons.H36M_17,
                                              jax_skeletons.COCO_19)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[2]).all() and not np.isnan(got[0]).any()
    prev = np.zeros((3, 17, 2), np.float32)
    for p, t in ((poses2d[0][0], truth[0][1]), (poses2d[1][1], truth[0][0])):
        assert association.pose2d_auc(p, t, prev[0], skeletons.H36M_17, skeletons.COCO_19) == (
            jax_association.pose2d_auc(p, t, prev[0], jax_skeletons.H36M_17,
                                       jax_skeletons.COCO_19))


def test_mask_association_matches_jax():
    pytest.importorskip('cv2', reason='cv2 draws the stick figures of pose_to_mask')
    from metrabs_tpu.utils import rlemask as jax_rlemask
    rng = np.random.default_rng(7)
    poses2d = (rng.normal(size=(3, 17, 2)) * 20 + [[[60, 60]], [[180, 160]], [[60, 200]]])
    masks = [jax_rlemask.encode(jax_association.pose_to_mask(p, (256, 256),
                                                             jax_skeletons.H36M_17, 10))
             for p in poses2d[:2]]
    masks.append(association.pose_to_mask(poses2d[2], (256, 256), skeletons.H36M_17, 10))
    poses3d = rng.normal(size=(3, 17, 3))
    order = [2, 0, 1]
    args = (poses3d[order], poses2d[order] * 2.0, (512, 512), masks)
    got = association.associate_predictions_to_masks(*args, skeletons.H36M_17)
    want = jax_association.associate_predictions_to_masks(*args, jax_skeletons.H36M_17)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, poses3d)
    for m in masks[:2]:
        np.testing.assert_array_equal(association.decode_rle(m), jax_association.decode_rle(m))
    assert association.associate_predictions_to_masks(
        poses3d, poses2d, (256, 256), [], skeletons.H36M_17).shape == (0, 17, 3)


@pytest.mark.parametrize('thickness', range(1, 9))
def test_pose_to_mask_equals_jax_without_cv2(thickness):
    """F4: `pose_to_mask` imported cv2. It now draws with `data.cvfree` and
    gives the cv2-drawn masks of JAX's, for confident and unconfident joints
    (a torso corner unconfident: no quad) and for poses without
    confidences."""
    pytest.importorskip('cv2', reason="JAX's pose_to_mask draws with cv2")
    rng = np.random.default_rng(thickness)
    poses = rng.uniform(10, 110, (4, 17, 2))
    conf = rng.uniform(0, 1, (4, 17, 1))
    conf[0] = 1.0
    conf[1, skeletons.H36M_17.ids['lsho']] = 0.1
    for pose in list(np.concatenate([poses, conf], -1)) + list(poses[:2]):
        np.testing.assert_array_equal(
            association.pose_to_mask(pose, (120, 130), skeletons.H36M_17, thickness),
            jax_association.pose_to_mask(pose, (120, 130), jax_skeletons.H36M_17, thickness))
