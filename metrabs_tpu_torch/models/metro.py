"""Metro: the root-relative-only 3D heatmap model (`metrabs_tpu/models/
metro.py`) and its losses. No intrinsics input and no absolute
reconstruction: the head decodes a metric root-relative pose directly, so
Metro cannot drive the absolute multi-person estimator (the loader refuses
it there, as JAX's does). Training supervises the 3D batch with a
root-relative L1 and the 2D batch with weak 2D supervision after a
mean/stdev alignment of the predicted to the annotated skeleton (without
intrinsics there is no absolute scale)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from metrabs_tpu_torch.config import ModelConfig, TrainConfig
from metrabs_tpu_torch.models.heads import Head3D
from metrabs_tpu_torch.ops import masked
from metrabs_tpu_torch.train import losses as losses_mod


class Metro(nn.Module):
    def __init__(self, cfg: ModelConfig, backbone: nn.Module):
        super().__init__()
        self.cfg = cfg
        self.backbone = backbone
        self.heatmap_head = Head3D(cfg, cfg.n_joints, backbone.out_channels)

    def forward(self, image: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[N, S, S, 3] NHWC crops -> [N, J, 3] root-relative joints in mm; in
        train mode the head decodes at `stride_train`."""
        return self.heatmap_head(self.backbone(image, generator=generator),
                                 train=self.training)


def align_2d_skeletons(coords_pred: torch.Tensor, coords_true: torch.Tensor,
                       joint_validity_mask: torch.Tensor) -> torch.Tensor:
    """Mean/stdev alignment of predicted [N, J, 2] to annotated 2D skeletons
    over the valid joints (divide-no-nan: a skeleton without spread keeps
    the annotations' mean)."""
    mean_pred, stdev_pred = masked.mean_stdev_masked(
        coords_pred, joint_validity_mask, items_axis=1, dimensions_axis=2)
    mean_true, stdev_true = masked.mean_stdev_masked(
        coords_true, joint_validity_mask, items_axis=1, dimensions_axis=2)
    return masked.divide_no_nan(coords_pred - mean_pred, stdev_pred) * stdev_true + mean_true


def compute_metro_losses(coords3d_rel_pred: torch.Tensor, coords3d_pred_2d: torch.Tensor,
                         batch3d: Dict, batch2d: Dict,
                         index_groups: Sequence[Sequence[int]], *, cfg: ModelConfig,
                         tcfg: TrainConfig) -> Dict[str, torch.Tensor]:
    """loss3d (root-relative L1 of the 3D batch), loss2d (aligned weak 2D of
    the 2D batch) and loss = loss3d + loss2d_factor * loss2d."""
    losses = {}
    mask3d = batch3d['joint_validity_mask']
    true_rootrel = losses_mod.center_relative_pose(batch3d['coords3d_true'], mask3d,
                                                   tcfg.mean_relative)
    pred_rootrel = losses_mod.center_relative_pose(coords3d_rel_pred, mask3d,
                                                   tcfg.mean_relative)
    losses['loss3d'] = masked.batch_mean_masked(
        torch.abs((true_rootrel - pred_rootrel) / 1000.0), mask3d)

    scale_2d = 1.0 / cfg.proc_side * cfg.box_size_mm / 1000.0
    coords2d_pred_2d = align_2d_skeletons(
        losses_mod.get_2dlike_joints(coords3d_pred_2d[..., :2], index_groups),
        batch2d['coords2d_true'], batch2d['joint_validity_mask'])
    losses['loss2d'] = masked.batch_mean_masked(
        torch.abs((batch2d['coords2d_true'] - coords2d_pred_2d) * scale_2d),
        batch2d['joint_validity_mask'])
    losses['loss'] = losses['loss3d'] + tcfg.loss2d_factor * losses['loss2d']
    return losses
