"""3D pose evaluation metrics (`metrabs_tpu/eval/metrics.py`): MPJPE
(root- or mean-relative), absolute MPJPE, 2D pixel error, PA-MPJPE through
scale-aligned Procrustes, PCK and AUC at a threshold (and their wrist-only
variants where the joint names have wrists), and NCPS (all joints of a pose
within the threshold after alignment) with its AUC over a fixed 50-150 mm
ramp. Every reduction is masked by joint validity.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from metrabs_tpu_torch.ops import masked
from metrabs_tpu_torch.ops.procrustes import rigid_align
from metrabs_tpu_torch.pipeline.estimator import checked_device
from metrabs_tpu_torch.utils.joint_info import JointInfo


def auc_score(x: torch.Tensor, t1: float, t2: float) -> torch.Tensor:
    """The linear ramp from 1 at `t1` to 0 at `t2`."""
    return torch.clamp(1.0 - torch.clamp(x - t1, min=0.0) / (t2 - t1), min=0.0)


def center_relative(diff: torch.Tensor, validity: Optional[torch.Tensor],
                    center_is_mean: bool = True) -> torch.Tensor:
    if center_is_mean:
        center = masked.reduce_mean_masked(diff, validity, axis=1, keepdim=True)
    else:
        center = diff[:, -1:]
    return diff - center


def compute_pose3d_metrics(
        coords3d_pred, coords3d_true, joint_validity_mask, *,
        coords3d_pred_is_abs: bool = True, coords2d_true=None, coords2d_pred=None,
        joint_info: Optional[JointInfo] = None, mean_relative: bool = True,
        threshold_mm: float = 150.0, device='cuda') -> Dict[str, torch.Tensor]:
    """The metrics of predicted against true poses [N, J, 3] in mm with
    validity [N, J] (and 2D poses [N, J, 2+] in px), as 0-d float32 tensors
    on `device`, where the inputs (tensors or arrays) are moved, in float32
    as JAX computes them."""
    device = checked_device(device)
    as_tensor = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    coords3d_pred, coords3d_true = as_tensor(coords3d_pred), as_tensor(coords3d_true)
    joint_validity_mask = torch.as_tensor(joint_validity_mask, device=device).bool()
    metrics = {}
    diff = coords3d_pred - coords3d_true
    dist = torch.linalg.norm(center_relative(diff, joint_validity_mask, mean_relative), dim=-1)
    metrics['mean_error'] = masked.reduce_mean_masked(dist, joint_validity_mask)

    if coords3d_pred_is_abs:
        metrics['mean_error_abs'] = masked.reduce_mean_masked(
            torch.linalg.norm(diff, dim=-1), joint_validity_mask)

    if coords2d_true is not None and coords2d_pred is not None:
        metrics['mean_error_2d'] = masked.reduce_mean_masked(
            torch.linalg.norm(as_tensor(coords2d_true) - as_tensor(coords2d_pred)[..., :2],
                              dim=-1), joint_validity_mask)

    aligned = rigid_align(coords3d_pred, coords3d_true, joint_validity_mask=joint_validity_mask,
                          scale_align=True)
    dist_pa = torch.linalg.norm(aligned - coords3d_true, dim=-1)
    metrics['mean_error_procrustes'] = masked.reduce_mean_masked(dist_pa, joint_validity_mask)

    auc = auc_score(dist, 0.0, threshold_mm)
    metrics['mean_auc'] = masked.reduce_mean_masked(auc, joint_validity_mask)
    is_correct = (dist <= threshold_mm).float()
    metrics['mean_pck'] = masked.reduce_mean_masked(is_correct, joint_validity_mask)

    if joint_info is not None:
        wrists = [i for name, i in joint_info.ids.items() if 'lwri' in name or 'rwri' in name]
        if wrists:
            # Columns by slices: an index tensor would be copied to the card.
            cols = lambda x: torch.cat([x[:, i:i + 1] for i in wrists], dim=1)
            metrics['pck_wrists'] = masked.reduce_mean_masked(cols(is_correct),
                                                              cols(joint_validity_mask))
            metrics['auc_wrists'] = masked.reduce_mean_masked(cols(auc), cols(joint_validity_mask))

    max_dist_pa = torch.max(torch.where(joint_validity_mask, dist_pa, 0.0), dim=1).values
    # The NCPS ramp is 50-150 mm whatever the PCK threshold, as the reference
    # has it (at the 3DPW protocol's 50 mm a threshold-based edge would
    # divide by zero).
    metrics['ncps_auc'] = torch.mean(auc_score(max_dist_pa, 50.0, 150.0))
    metrics['ncps'] = torch.mean((max_dist_pa <= threshold_mm).float())
    return metrics
