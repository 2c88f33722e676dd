"""The MeTRAbs crop model, plain mode (`metrabs_tpu/models/metrabs.py`,
`latent_mode=''`): backbone + dual-heatmap head + absolute reconstruction.

The backbone and the head's conv compute in `cfg.dtype` (float32 master
weights train in bfloat16); the head decode and the reconstruction run in
float32.
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
        self.heatmap_heads = MetrabsHeads(cfg, cfg.n_joints, backbone.out_channels)

    def backbone_and_head(self, image: torch.Tensor, train: bool = False,
                          generator: Optional[torch.Generator] = None):
        """(features NCHW, coords2d [N, J, 2] px, coords3d_rel [N, J, 3] mm).
        `train` is JAX's flag and must be the module's mode (`.train()`:
        batch-statistics BN and drop-connect from `generator`; the head
        decodes at `stride_train`)."""
        if train != self.training:
            raise ValueError(f'train={train} but the module is in '
                             f'{"train" if self.training else "eval"} mode')
        features = self.backbone(image, generator=generator)
        coords2d, coords3d = self.heatmap_heads(features, train=train)
        return features, coords2d, coords3d

    def forward(self, image: torch.Tensor, intrinsics: torch.Tensor,
                sample_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[N, S, S, 3] NHWC crops + [N, 3, 3] intrinsics -> [N, J, 3] absolute
        camera-space joints in millimeters. `sample_valid` masks padding crops
        out of the reconstruction's pooled RMS normalization. In train mode
        the head decodes at `stride_train`, as JAX's `train=True`."""
        _, coords2d, coords3d = self.backbone_and_head(image, train=self.training)
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
    `cfg.bn_fold`, computing in `cfg.dtype`, blocks rematerialised in the
    backward pass iff `cfg.backbone_remat`. `backbone_builder` (default
    `build_backbone`) takes the same arguments as `build_backbone`."""
    backbone = (backbone_builder or build_backbone)(
        cfg.backbone, centered_stride=cfg.centered_stride,
        stride_test=cfg.stride_test if cfg.stride_test != cfg.stride_train else None,
        bn_fold=cfg.bn_fold, dtype=getattr(torch, cfg.dtype), remat=cfg.backbone_remat)
    return Metrabs(cfg, backbone)
