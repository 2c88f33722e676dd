"""Metro: the root-relative-only 3D heatmap model (`metrabs_tpu/models/
metro.py`), forward only. No intrinsics input and no absolute
reconstruction: the head decodes a metric root-relative pose directly, so
Metro cannot drive the absolute multi-person estimator (the loader refuses
it there, as JAX's does)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from metrabs_tpu_torch.config import ModelConfig
from metrabs_tpu_torch.models.heads import Head3D


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
