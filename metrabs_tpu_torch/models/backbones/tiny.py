"""Tiny stride-32 backbone of the JAX package's tests
(`metrabs_tpu/models/backbones/tiny.py`): five 3x3 stride-2 convs with
flax's 'SAME' padding, each with a bias or, with `use_bn`, a BatchNorm
(momentum 0.99 and flax's default eps 1e-5), then relu."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from metrabs_tpu_torch.models.backbones import common


class TinyBackbone(nn.Module):
    """[N, S, S, 3] NHWC -> NCHW [N, width, S/32, S/32]."""

    def __init__(self, width: int = 32, use_bn: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.use_bn = use_bn
        self.dtype = dtype
        self.out_channels = width
        for i in range(5):
            self.add_module(f'conv{i}', common.Conv2d(3 if i == 0 else width, width, 3,
                                                      stride=2, bias=not use_bn))
            if use_bn:
                self.add_module(f'bn{i}', common.GhostBatchNorm(width, 1e-5, 0.99))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` is unused (no drop-connect)."""
        x = x.to(self.dtype or self.conv0.weight.dtype).permute(0, 3, 1, 2)
        for i in range(5):
            x = getattr(self, f'conv{i}')(common.pad_same(x, 3, 2))
            if self.use_bn:
                x = getattr(self, f'bn{i}')(x)
            x = F.relu(x)
        return x
