"""Prediction heads (`metrabs_tpu/models/heads.py`): only `MetrabsHeads` is ported.

One 1x1 conv (computing in `cfg.dtype`, as flax's `Conv(dtype=...)`) gives [n_points] 2D logits
followed by [depth * n_points] 3D logits (channel = d * n_points + j); the
logits are upcast to float32 and decoded by soft-argmax at `stride_train`
in training and `stride_test` otherwise.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from metrabs_tpu_torch.config import ModelConfig
from metrabs_tpu_torch.models.backbones.common import Conv2d
from metrabs_tpu_torch.ops import heatmap as heatmap_ops
from metrabs_tpu_torch.ops import heatmap_decode as sa


class MetrabsHeads(nn.Module):
    def __init__(self, cfg: ModelConfig, n_points: int, in_channels: int = 1280):
        super().__init__()
        self.cfg = cfg
        self.n_points = n_points
        self.conv_final = Conv2d(in_channels, n_points * (1 + cfg.depth), 1)

    def forward(self, features: torch.Tensor, train: bool = False):
        """NCHW features -> (coords2d [N, J, 2] px, coords3d_rel [N, J, 3] mm)."""
        cfg = self.cfg
        j = self.n_points
        x = self.conv_final(features.to(getattr(torch, cfg.dtype)))
        x = x.float().permute(0, 2, 3, 1)  # b h w c
        logits2d = x[..., :j]
        logits3d = x[..., j:].reshape(x.shape[:3] + (cfg.depth, j))  # b h w d j
        stride = cfg.stride_train if train else cfg.stride_test
        coords3d = sa.soft_argmax(logits3d, axes=(2, 1, 3))
        coords3d_rel = heatmap_ops.heatmap_to_metric(
            coords3d, proc_side=cfg.proc_side, stride=stride,
            box_size_mm=cfg.box_size_mm, centered_stride=cfg.centered_stride)
        coords2d = sa.soft_argmax(logits2d, axes=(2, 1))
        coords2d_pred = heatmap_ops.heatmap_to_image(
            coords2d, proc_side=cfg.proc_side, stride=stride,
            centered_stride=cfg.centered_stride)
        return coords2d_pred, coords3d_rel
