"""The MeTRAbs crop model, plain mode (`metrabs_tpu/models/metrabs.py`,
`latent_mode=''`): backbone + dual-heatmap head + absolute reconstruction.

The backbone computes in its parameters' dtype (bfloat16 when serving); the
head decode and the reconstruction run in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from metrabs_tpu_torch.config import ModelConfig
from metrabs_tpu_torch.models.backbones.builder import build_backbone
from metrabs_tpu_torch.models.heads import MetrabsHeads
from metrabs_tpu_torch.ops import reconstruct


class Metrabs(nn.Module):
    def __init__(self, cfg: ModelConfig, backbone: nn.Module):
        super().__init__()
        self.cfg = cfg
        self.backbone = backbone
        self.heatmap_heads = MetrabsHeads(cfg, cfg.n_joints)

    def backbone_and_head(self, image: torch.Tensor):
        features = self.backbone(image)
        coords2d, coords3d = self.heatmap_heads(features)
        return features, coords2d, coords3d

    def forward(self, image: torch.Tensor, intrinsics: torch.Tensor,
                sample_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[N, S, S, 3] NHWC crops + [N, 3, 3] intrinsics -> [N, J, 3] absolute
        camera-space joints in millimeters. `sample_valid` masks padding crops
        out of the reconstruction's pooled RMS normalization."""
        _, coords2d, coords3d = self.backbone_and_head(image)
        # The FOV trust border always uses stride_train, as the reference.
        return reconstruct.reconstruct_absolute(
            coords2d, coords3d, intrinsics.float(),
            proc_side=self.cfg.proc_side, stride=self.cfg.stride_train,
            centered_stride=self.cfg.centered_stride,
            mix_3d_inside_fov=self.cfg.mix_3d_inside_fov,
            weak_perspective=self.cfg.weak_perspective,
            sample_valid=sample_valid)


def build_crop_model(cfg: ModelConfig, backbone_builder=None) -> Metrabs:
    """An uninitialized crop model for `cfg`: flat layout, BN folded iff
    `cfg.bn_fold`. `backbone_builder` (default `build_backbone`) takes the
    same arguments as `build_backbone`."""
    backbone = (backbone_builder or build_backbone)(
        cfg.backbone, centered_stride=cfg.centered_stride,
        stride_test=cfg.stride_test if cfg.stride_test != cfg.stride_train else None,
        bn_fold=cfg.bn_fold)
    return Metrabs(cfg, backbone)
