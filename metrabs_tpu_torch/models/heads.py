"""Prediction heads (`metrabs_tpu/models/heads.py`): `MetrabsHeads`, `Head3D`
(Metro) and `Head25D` (Model25D).

Each is one 1x1 conv `conv_final` (computing in `cfg.dtype`, as flax's
`Conv(dtype=...)`). `MetrabsHeads` gives [n_points] 2D logits followed by
[depth * n_points] 3D logits, the other two only the 3D logits; channel =
d * n_points + j. The logits are upcast to float32 and decoded by
soft-argmax at `stride_train` in training and `stride_test` otherwise.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from metrabs_tpu_torch.config import ModelConfig
from metrabs_tpu_torch.models.backbones.common import Conv2d
from metrabs_tpu_torch.ops import heatmap as heatmap_ops
from metrabs_tpu_torch.ops import heatmap_decode as sa


class _Head(nn.Module):
    def __init__(self, cfg: ModelConfig, n_points: int, in_channels: int, n_2d: int):
        super().__init__()
        self.cfg = cfg
        self.n_points = n_points
        self.conv_final = Conv2d(in_channels, n_2d + n_points * cfg.depth, 1)

    def _logits(self, features: torch.Tensor) -> torch.Tensor:
        """NCHW features -> float32 logits [N, H, W, C]."""
        x = self.conv_final(features.to(getattr(torch, self.cfg.dtype)))
        return x.float().permute(0, 2, 3, 1)

    def _coords3d(self, logits3d: torch.Tensor) -> torch.Tensor:
        """[N, H, W, depth * J] -> soft-argmax (x, y, z) in [0, 1], [N, J, 3]."""
        logits3d = logits3d.reshape(logits3d.shape[:3] + (self.cfg.depth, self.n_points))
        return sa.soft_argmax(logits3d, axes=(2, 1, 3))

    def _stride(self, train: bool) -> int:
        return self.cfg.stride_train if train else self.cfg.stride_test


class MetrabsHeads(_Head):
    def __init__(self, cfg: ModelConfig, n_points: int, in_channels: int = 1280):
        super().__init__(cfg, n_points, in_channels, n_points)

    def forward(self, features: torch.Tensor, train: bool = False):
        """NCHW features -> (coords2d [N, J, 2] px, coords3d_rel [N, J, 3] mm)."""
        cfg = self.cfg
        x = self._logits(features)
        stride = self._stride(train)
        coords3d_rel = heatmap_ops.heatmap_to_metric(
            self._coords3d(x[..., self.n_points:]), proc_side=cfg.proc_side, stride=stride,
            box_size_mm=cfg.box_size_mm, centered_stride=cfg.centered_stride)
        coords2d = sa.soft_argmax(x[..., :self.n_points], axes=(2, 1))
        coords2d_pred = heatmap_ops.heatmap_to_image(
            coords2d, proc_side=cfg.proc_side, stride=stride,
            centered_stride=cfg.centered_stride)
        return coords2d_pred, coords3d_rel


class Head3D(_Head):
    """Metro's root-relative 3D head: NCHW features -> [N, J, 3] mm."""

    def __init__(self, cfg: ModelConfig, n_points: int, in_channels: int = 1280):
        super().__init__(cfg, n_points, in_channels, 0)

    def forward(self, features: torch.Tensor, train: bool = False) -> torch.Tensor:
        cfg = self.cfg
        return heatmap_ops.heatmap_to_metric(
            self._coords3d(self._logits(features)), proc_side=cfg.proc_side,
            stride=self._stride(train), box_size_mm=cfg.box_size_mm,
            centered_stride=cfg.centered_stride)


class Head25D(_Head):
    """Model25D's head: NCHW features -> [N, J, 3], xy in pixels and z
    relative in millimeters."""

    def __init__(self, cfg: ModelConfig, n_points: int, in_channels: int = 1280):
        super().__init__(cfg, n_points, in_channels, 0)

    def forward(self, features: torch.Tensor, train: bool = False) -> torch.Tensor:
        cfg = self.cfg
        return heatmap_ops.heatmap_to_25d(
            self._coords3d(self._logits(features)), proc_side=cfg.proc_side,
            stride=self._stride(train), box_size_mm=cfg.box_size_mm,
            centered_stride=cfg.centered_stride)
