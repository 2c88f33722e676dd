"""Model25D: the 2.5D head with the bone-length absolute depth solve
(`metrabs_tpu/models/model25d.py`), forward only.

The head predicts (x px, y px, z relative mm); the absolute depth comes from
the fixed-iteration Levenberg-Marquardt bone-length solve
(`ops.lm_solver`). With `sample_valid`, the invalid (padding) samples are
replaced before the solve by a well-conditioned diagonal neutral pose, as in
JAX, so that they stay finite; the estimator masks them anyway.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from metrabs_tpu_torch.config import ModelConfig
from metrabs_tpu_torch.models.heads import Head25D
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
