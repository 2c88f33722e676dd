"""Track association for multi-person benchmark evaluation (a copy of
`metrabs_tpu/eval/association.py`, numpy and scipy on the host).

As the reference's 3DPW harness: predictions are matched to annotated
tracks by Hungarian assignment over a 2D-AUC similarity (falling back to
temporal consistency with the previous frame's assignment when too few
annotated joints are confident), or to annotated person masks by the IoU of
each prediction drawn as a stick figure, rasterised as OpenCV would by
`data.cvfree`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import scipy.optimize

from metrabs_tpu_torch.data import cvfree
from metrabs_tpu_torch.data.masks import mask_iou
from metrabs_tpu_torch.utils.joint_info import JointInfo
from metrabs_tpu_torch.utils.rlemask import decode as decode_rle

ASSOC_JOINTS = ('lsho', 'rsho', 'lelb', 'relb', 'lhip', 'rhip', 'lkne', 'rkne')


def pose2d_auc(pose2d_pred: np.ndarray, pose2d_true: np.ndarray,
               prev_pose2d_pred: np.ndarray, joint_info3d: JointInfo,
               joint_info2d: JointInfo,
               confidence_threshold: float = 0.2) -> float:
    """Torso-scale-normalized linear AUC between a predicted and annotated 2D
    pose; annotated joints below the confidence threshold are ignored. With
    fewer than 5 usable joints, similarity to the track's previous prediction
    is used instead (temporal association)."""
    pose2d_true = pose2d_true.copy()
    pose2d_true[pose2d_true[:, 2] < confidence_threshold] = np.nan
    ids3 = joint_info3d.ids
    ids2 = joint_info2d.ids
    indices_true = [ids2[name] for name in ASSOC_JOINTS]
    indices_pred = [ids3[name] for name in ASSOC_JOINTS]
    size = np.linalg.norm(pose2d_pred[ids3['rsho']] - pose2d_pred[ids3['lhip']])
    dist = np.linalg.norm(
        pose2d_true[indices_true, :2] - pose2d_pred[indices_pred], axis=-1)
    if np.count_nonzero(~np.isnan(dist)) < 5:
        dist = np.linalg.norm(
            prev_pose2d_pred[indices_pred] - pose2d_pred[indices_pred], axis=-1)
    with np.errstate(invalid='ignore'):
        return float(np.nanmean(np.maximum(0, 1 - dist / size)))


def associate_predictions(
        poses3d_pred: np.ndarray, poses2d_pred: np.ndarray,
        poses2d_true: np.ndarray, prev_poses2d_pred_ordered: np.ndarray,
        joint_info3d: JointInfo, joint_info2d: JointInfo):
    """Hungarian assignment of predictions to annotated tracks.

    Returns (poses3d ordered per track [n_tracks, J, 3] with NaN rows for
    unmatched tracks, updated per-track previous 2D predictions).
    """
    auc_matrix = np.array([
        [pose2d_auc(pp, pt, prev, joint_info3d, joint_info2d)
         for pp in poses2d_pred]
        for pt, prev in zip(poses2d_true, prev_poses2d_pred_ordered)])
    auc_matrix = np.nan_to_num(auc_matrix)
    true_indices, pred_indices = scipy.optimize.linear_sum_assignment(-auc_matrix)

    n_tracks = len(poses2d_true)
    result = np.full((n_tracks, joint_info3d.n_joints, 3), np.nan)
    poses2d_ordered = np.array(prev_poses2d_pred_ordered).copy()
    for ti, pi in zip(true_indices, pred_indices):
        result[ti] = poses3d_pred[pi]
        poses2d_ordered[ti] = poses2d_pred[pi]
    return result, poses2d_ordered


def associate_sequence(
        poses3d_per_frame: Sequence[np.ndarray],
        poses2d_per_frame: Sequence[np.ndarray],
        poses2d_true_per_frame: Sequence[np.ndarray],
        joint_info3d: JointInfo, joint_info2d: JointInfo) -> np.ndarray:
    """Runs association over a whole sequence, threading the per-track
    previous-frame predictions (`predict_tdpw.py` sequence loop). Returns
    [n_frames, n_tracks, J, 3] with NaNs for unmatched frames."""
    n_tracks = poses2d_true_per_frame[0].shape[0]
    prev = np.zeros((n_tracks, joint_info3d.n_joints, 2), np.float32)
    out = []
    for p3, p2, t2 in zip(poses3d_per_frame, poses2d_per_frame,
                          poses2d_true_per_frame):
        if len(p3) == 0:
            out.append(np.full((n_tracks, joint_info3d.n_joints, 3), np.nan))
            continue
        result, prev = associate_predictions(
            p3, p2, t2, prev, joint_info3d, joint_info2d)
        out.append(result)
    return np.stack(out)


# Mask-IoU association: when a frame has segmentation-mask annotations
# instead of confident 2D keypoints, each prediction is rasterised as a thick
# stick figure and matched to the annotated person masks by Hungarian
# assignment over mask IoU.


def pose_to_mask(pose2d: np.ndarray, imshape, joint_info: JointInfo,
                 thickness: int, thresh: float = 0.2) -> np.ndarray:
    """Rasterizes a 2D pose as a thick stick figure plus a filled torso
    polygon into a [h, w] uint8 mask (`predict_tdpw.py:238-255`). pose2d is
    [J, 2] or [J, 3] (x, y, conf); with confidences, only edges whose both
    endpoints exceed `thresh` draw, and the torso fills only when all four
    corner joints (lhip/rhip/rsho/lsho) are confident. The lines and the
    quad are OpenCV's (`cvfree.line`, `cvfree.fill_poly`)."""
    result = np.zeros(imshape[:2], dtype=np.uint8)
    if pose2d.shape[1] == 3:
        is_valid = pose2d[:, 2] > thresh
    else:
        is_valid = np.ones(pose2d.shape[0], dtype=bool)
    for i1, i2 in joint_info.edges:
        if is_valid[i1] and is_valid[i2]:
            p1 = pose2d[i1, :2]
            p2 = pose2d[i2, :2]
            if not (np.all(np.isfinite(p1)) and np.all(np.isfinite(p2))):
                continue
            cvfree.line(result, np.round(p1).astype(int), np.round(p2).astype(int), 1,
                        thickness=thickness)
    # Torso fill (`predict_tdpw.py:252-255`): the stick figure alone has far
    # less area than a person, which skews mask IoU; the quad between the hip
    # and (contralateral-ordered) shoulder joints restores the bulk.
    ids = joint_info.ids
    torso_names = ('lhip', 'rhip', 'rsho', 'lsho')
    if all(name in ids for name in torso_names):
        torso = [ids[name] for name in torso_names]
        corners = pose2d[torso, :2]
        if np.all(is_valid[torso]) and np.all(np.isfinite(corners)):
            cvfree.fill_poly(result, [np.round(corners).astype(np.int32)], 1)
    return result


def associate_predictions_to_masks(
        poses3d_pred: np.ndarray, poses2d_pred: np.ndarray, frame_shape,
        masks: Sequence, joint_info3d: JointInfo,
        thickness: int = 8) -> np.ndarray:
    """Hungarian assignment of predictions to annotated person masks by
    stick-figure-vs-mask IoU (`predict_tdpw.py:194-206`). `masks` are COCO
    RLE dicts or dense [h, w] binary arrays (possibly at a different
    resolution than the frame; predictions are rescaled to mask space).
    Returns poses3d ordered per mask [n_masks, J, 3], NaN where unmatched."""
    if len(masks) == 0:
        # A frame where the tracker lost everyone: nothing to associate
        # (np.array([]) would be shape (0,) and crash the shape unpack).
        return np.full((0, joint_info3d.n_joints, 3), np.nan)
    masks = np.array([decode_rle(m) for m in masks])
    mask_shape = masks.shape[1:3]
    mask_size = np.array([mask_shape[1], mask_shape[0]], np.float32)
    frame_size = np.array([frame_shape[1], frame_shape[0]], np.float32)
    poses2d_pred = np.asarray(poses2d_pred) * mask_size / frame_size
    pose_masks = np.array([
        pose_to_mask(p, mask_shape, joint_info3d, thickness)
        for p in poses2d_pred])
    iou_matrix = np.array([[mask_iou(m1, m2) for m2 in pose_masks]
                           for m1 in masks])
    true_indices, pred_indices = scipy.optimize.linear_sum_assignment(
        -iou_matrix)
    result = np.full((len(masks), joint_info3d.n_joints, 3), np.nan)
    for ti, pi in zip(true_indices, pred_indices):
        result[ti] = poses3d_pred[pi]
    return result
