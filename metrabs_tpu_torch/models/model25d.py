"""Model25D: the 2.5D head with the bone-length absolute depth solve
(`metrabs_tpu/models/model25d.py`), and its losses.

The head predicts (x px, y px, z relative mm); the absolute depth comes from
the fixed-iteration Levenberg-Marquardt bone-length solve
(`ops.lm_solver`). With `sample_valid`, the invalid (padding) samples are
replaced before the solve by a well-conditioned diagonal neutral pose, as in
JAX, so that they stay finite; the estimator masks them anyway.

Training supervises the raw 2.5D head (`forward_25d`): the 3D batch's 2D
pixels (`loss23d`, which needs its `coords2d_true`) and relative depth
around `0.5 * box_size_mm` (`loss_z`), combined z/3 + 2 * 2d/3, and weak 2D
supervision of the 2D batch; the bone-length solve runs only at inference.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from metrabs_tpu_torch.config import ModelConfig, TrainConfig
from metrabs_tpu_torch.models.heads import Head25D
from metrabs_tpu_torch.ops import masked
from metrabs_tpu_torch.train import losses as losses_mod
from metrabs_tpu_torch.ops.lm_solver import reconstruct_absolute_by_bone_lengths


class Model25D(nn.Module):
    """`bones` [B] joint-index pairs and `bone_lengths_ideal` [B] mm: the
    package's assets (manifest `bones_25d`, `bone_lengths_ideal`)."""

    def __init__(self, cfg: ModelConfig, backbone: nn.Module,
                 bones: Sequence[Tuple[int, int]] = (),
                 bone_lengths_ideal: Sequence[float] = ()):
        super().__init__()
        self.cfg = cfg
        self.backbone = backbone
        self.heatmap_head = Head25D(cfg, cfg.n_joints, backbone.out_channels)
        self.bones = tuple(tuple(int(i) for i in b) for b in bones)
        self.bone_lengths_ideal = tuple(float(x) for x in bone_lengths_ideal)
        self._assets = {}

    def _device_assets(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(bone index [B, 2], ideal lengths [B]) on `device`, made once per
        device: copying them to the card on every call would wait for it."""
        if device not in self._assets:
            self._assets[device] = (
                torch.tensor(self.bones, dtype=torch.long, device=device).reshape(-1, 2),
                torch.tensor(self.bone_lengths_ideal, dtype=torch.float32, device=device))
        return self._assets[device]

    def forward_25d(self, image: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[N, S, S, 3] NHWC crops -> [N, J, 3] (x px, y px, z mm)."""
        return self.heatmap_head(self.backbone(image, generator=generator),
                                 train=self.training)

    def forward(self, image: torch.Tensor, intrinsics: torch.Tensor,
                sample_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[N, S, S, 3] crops + [N, 3, 3] intrinsics -> [N, J, 3] absolute
        camera-space joints in mm."""
        coords25d = self.forward_25d(image)
        if sample_valid is not None:
            n_j = coords25d.shape[-2]
            spread = torch.linspace(0.25, 0.75, n_j, device=coords25d.device) * self.cfg.proc_side
            neutral = torch.stack([spread, spread,
                                   torch.full_like(spread, 0.5 * self.cfg.box_size_mm)], dim=-1)
            coords25d = torch.where(sample_valid[:, None, None], coords25d, neutral)
        bones, lengths = self._device_assets(coords25d.device)
        # The FOV trust border always uses stride_train, as the reference.
        return reconstruct_absolute_by_bone_lengths(
            coords25d, intrinsics.float(), lengths, bones, proc_side=self.cfg.proc_side,
            stride=self.cfg.stride_train, centered_stride=self.cfg.centered_stride)


def compute_model25d_losses(coords25d_pred: torch.Tensor, coords25d_pred_2d: torch.Tensor,
                            batch3d: Dict, batch2d: Dict,
                            index_groups: Sequence[Sequence[int]], *, cfg: ModelConfig,
                            tcfg: TrainConfig) -> Dict[str, torch.Tensor]:
    """loss23d, loss_z, loss3d = loss_z / 3 + 2 * loss23d / 3, loss2d and
    loss = loss3d + loss2d_factor * loss2d."""
    losses = {}
    scale_2d = 1.0 / cfg.proc_side * cfg.box_size_mm / 1000.0
    mask3d = batch3d['joint_validity_mask']
    losses['loss23d'] = masked.batch_mean_masked(
        torch.abs((batch3d['coords2d_true'] - coords25d_pred[..., :2]) * scale_2d), mask3d)
    z_ref = losses_mod.center_relative_pose(
        batch3d['coords3d_true'][..., 2:], mask3d,
        tcfg.mean_relative)[..., 0] + 0.5 * cfg.box_size_mm
    losses['loss_z'] = masked.batch_mean_masked(
        torch.abs(z_ref - coords25d_pred[..., 2]), mask3d) / 1000.0
    coords2d_pred_2d = losses_mod.get_2dlike_joints(coords25d_pred_2d[..., :2], index_groups)
    losses['loss2d'] = masked.batch_mean_masked(
        torch.abs((batch2d['coords2d_true'] - coords2d_pred_2d) * scale_2d),
        batch2d['joint_validity_mask'])
    losses['loss3d'] = losses['loss_z'] / 3 + 2 * losses['loss23d'] / 3
    losses['loss'] = losses['loss3d'] + tcfg.loss2d_factor * losses['loss2d']
    return losses
