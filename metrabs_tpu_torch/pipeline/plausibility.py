"""Pose plausibility filtering and 3D-pose non-maximum suppression
(`metrabs_tpu/pipeline/plausibility.py`).

Masked and fixed-shape, as in JAX: padded pose sets with validity masks and
the greedy NMS loop of `ops.nms`. Every function takes any leading batch
axes, so the estimator filters all images of a batch at once where JAX maps
over them. The bone-length priors come from `pipeline.bone_priors` or the
package, whose trainer measures them with `BoneLengthStats` (numpy, on the
host) from the ground-truth 3D batches it trains on.
"""

from __future__ import annotations

import numpy as np
import torch

from metrabs_tpu_torch.ops.nms import greedy_nms


def is_pose_plausible(poses: torch.Tensor, joint2bone_mat: torch.Tensor,
                      mean_bones: torch.Tensor) -> torch.Tensor:
    """A pose is implausible if any bone is at once way off relative to the
    prior mean (< 0.1x or > 3x) and absolutely (> 300 mm). poses [..., J, 3];
    joint2bone_mat [n_bones, J_model]: only the first J_model joints feed the
    check (a joint transform may have appended more)."""
    n_joints = joint2bone_mat.shape[-1]
    bones = torch.einsum('bj,...jc->...bc', joint2bone_mat, poses[..., :n_joints, :])
    lengths = torch.linalg.norm(bones, dim=-1)
    relative = lengths / mean_bones
    absdiff_big = torch.abs(lengths - mean_bones) > 300.0
    implausible = torch.any(((relative > 3.0) | (relative < 0.1)) & absdiff_big, dim=-1)
    return ~implausible


def scale_align(poses: torch.Tensor) -> torch.Tensor:
    """Rescales each pose to its group's mean RMS scale; poses
    [..., n_items, J, 3]."""
    square_scales = torch.mean(torch.square(poses), dim=(-2, -1), keepdim=True)
    mean_square = torch.mean(square_scales, dim=-3, keepdim=True)
    return poses * torch.sqrt(mean_square / square_scales)


def point_stdev(poses: torch.Tensor, item_axis: int, coord_axis: int) -> torch.Tensor:
    """Per-point standard deviation over the items, the coordinates' variances
    summed."""
    mean = torch.mean(poses, dim=item_axis, keepdim=True)
    var = torch.mean(torch.square(poses - mean), dim=item_axis, keepdim=True)
    avg_stdev = torch.sqrt(torch.sum(var, dim=coord_axis, keepdim=True))
    return avg_stdev.squeeze((item_axis, coord_axis))


def are_augmentation_results_consistent(poses3d: torch.Tensor) -> torch.Tensor:
    """More than a quarter of the joints have a TTA stdev below 200 mm;
    poses3d [..., num_aug, J, 3]."""
    n_joints = poses3d.shape[-2]
    stdevs = point_stdev(scale_align(poses3d), item_axis=-3, coord_axis=-1)
    return torch.sum((stdevs < 200).to(torch.int32), dim=-1) > (n_joints // 4)


def is_pose_consistent_with_box(pose2d: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """The pose's 2D bounding box covers more than half the detection box's
    area; pose2d [..., J, 2], box [..., 4+] (x, y, w, h)."""
    posebox_start = torch.amin(pose2d, dim=-2)
    posebox_end = torch.amax(pose2d, dim=-2)
    box_start = box[..., :2]
    box_end = box[..., :2] + box[..., 2:4]
    box_area = torch.prod(box[..., 2:4], dim=-1)
    inter_start = torch.maximum(box_start, posebox_start)
    inter_end = torch.minimum(box_end, posebox_end)
    inter_area = torch.prod(torch.relu(inter_end - inter_start), dim=-1)
    return inter_area > 0.5 * box_area


def compute_pose_similarity(poses: torch.Tensor) -> torch.Tensor:
    """Pairwise scale-aligned similarity in [0, 1]: the mean over the
    farthest quarter of joints of relu(1 - dist / 300 mm). poses
    [..., n, J, 3] -> [..., n, n]."""
    n_joints = poses.shape[-2]
    square_scales = torch.mean(torch.square(poses), dim=(-2, -1), keepdim=True)
    s1 = square_scales.unsqueeze(-4)  # [..., 1, n, 1, 1]
    s2 = square_scales.unsqueeze(-3)  # [..., n, 1, 1, 1]
    mean_sq = (s1 + s2) / 2
    f1 = torch.sqrt(mean_sq / s1)
    f2 = torch.sqrt(mean_sq / s2)
    dists = torch.linalg.norm(f1 * poses.unsqueeze(-4) - f2 * poses.unsqueeze(-3), dim=-1)
    worst = torch.topk(dists, max(n_joints // 4, 1), dim=-1).values
    return torch.mean(torch.relu(1 - worst / 300.0), dim=-1)


def pose_non_max_suppression(poses: torch.Tensor, scores: torch.Tensor,
                             is_pose_valid: torch.Tensor, overlap_threshold: float = 0.4,
                             max_output: int = 150) -> torch.Tensor:
    """Greedy similarity NMS over [..., n] poses; returns the keep mask."""
    similarity = compute_pose_similarity(poses)
    return greedy_nms(similarity, scores, is_pose_valid, overlap_threshold, max_output)


def suppress_implausible_poses(poses3d: torch.Tensor, poses2d: torch.Tensor,
                               boxes: torch.Tensor, box_valid: torch.Tensor,
                               joint2bone_mat: torch.Tensor, mean_bones: torch.Tensor,
                               overlap_threshold: float = 0.4,
                               max_output: int = 150) -> torch.Tensor:
    """The whole filter on padded pose sets: poses3d [..., n, num_aug, J, 3],
    poses2d [..., n, num_aug, J, 2], boxes [..., n, 5], box_valid [..., n].
    Returns the final keep mask [..., n]."""
    poses3d_mean = torch.mean(poses3d, dim=-3)
    poses2d_mean = torch.mean(poses2d, dim=-3)
    plausible = (is_pose_plausible(poses3d_mean, joint2bone_mat, mean_bones)
                 & are_augmentation_results_consistent(poses3d)
                 & is_pose_consistent_with_box(poses2d_mean, boxes)
                 & box_valid)
    return pose_non_max_suppression(poses3d_mean, boxes[..., 4], plausible,
                                    overlap_threshold, max_output)


class BoneLengthStats:
    """Streaming mean bone lengths of ground-truth 3D poses, on the host. A
    bone sample counts only where both of its joints are valid (and its
    length is finite); an edge never observed reports NaN, not a 0 mm bone,
    which the plausibility check would always fail."""

    def __init__(self, edges):
        self.edges = tuple((int(i), int(j)) for i, j in edges)
        self._sum = np.zeros(len(self.edges), np.float64)
        self._count = np.zeros(len(self.edges), np.int64)

    def update(self, coords3d_mm: np.ndarray, validity: np.ndarray) -> None:
        """coords3d_mm [B, J, 3] camera-space mm; validity [B, J] bool."""
        c = np.asarray(coords3d_mm, np.float64)
        v = np.asarray(validity, bool)
        for b, (i, j) in enumerate(self.edges):
            ok = v[:, i] & v[:, j]
            if not ok.any():
                continue
            d = np.linalg.norm(c[ok, i] - c[ok, j], axis=-1)
            ok_finite = np.isfinite(d)
            self._sum[b] += d[ok_finite].sum()
            self._count[b] += int(ok_finite.sum())

    @property
    def n_samples(self) -> int:
        return int(self._count.min()) if len(self.edges) else 0

    def mean_lengths(self) -> np.ndarray:
        """Per-edge mean bone length in mm, float32; NaN where unobserved."""
        with np.errstate(invalid='ignore'):
            out = self._sum / np.maximum(self._count, 1)
        return np.where(self._count > 0, out, np.nan).astype(np.float32)


def compute_bone_mean_lengths(coords3d_mm, validity, edges) -> np.ndarray:
    """`BoneLengthStats` of one in-memory set of poses."""
    stats = BoneLengthStats(edges)
    stats.update(coords3d_mm, validity)
    return stats.mean_lengths()
