"""Heatmap-coordinate to image/metric mappings (`metrabs_tpu/ops/heatmap.py`).

Heatmap coordinate u in [0, 1] maps to pixel u * last_receptive_center, plus
stride // 2 with centered striding; being off by stride / 2 costs
millimeters.
"""

from __future__ import annotations

import torch


def heatmap_to_image(coords: torch.Tensor, *, proc_side: int, stride: int,
                     centered_stride: bool = True) -> torch.Tensor:
    """Normalized heatmap xy in [0, 1] -> pixel coordinates."""
    last_image_pixel = proc_side - 1
    last_receptive_center = last_image_pixel - (last_image_pixel % stride)
    out = coords * float(last_receptive_center)
    if centered_stride:
        out = out + float(stride // 2)
    return out


def heatmap_to_25d(coords: torch.Tensor, *, proc_side: int, stride: int, box_size_mm: float,
                   centered_stride: bool = True) -> torch.Tensor:
    """xy in pixels, z in millimeters."""
    coords2d = heatmap_to_image(coords[..., :2], proc_side=proc_side, stride=stride,
                                centered_stride=centered_stride)
    return torch.cat([coords2d, coords[..., 2:] * box_size_mm], dim=-1)


def heatmap_to_metric(coords: torch.Tensor, *, proc_side: int, stride: int,
                      box_size_mm: float, centered_stride: bool = True) -> torch.Tensor:
    """All three axes in millimeters, root-relative."""
    coords2d = heatmap_to_image(
        coords[..., :2], proc_side=proc_side, stride=stride,
        centered_stride=centered_stride) * (box_size_mm / proc_side)
    return torch.cat([coords2d, coords[..., 2:] * box_size_mm], dim=-1)
