"""Camera intrinsics helpers and basic projective ops (`metrabs_tpu/ops/camera.py`)."""

from __future__ import annotations

import math

import torch


def to_homogeneous(x: torch.Tensor) -> torch.Tensor:
    """Appends a 1 along the last axis."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def project(points: torch.Tensor) -> torch.Tensor:
    """Pinhole projection without z-clamping (the multiperson 2D output path)."""
    return points[..., :2] / points[..., 2:3]


def intrinsics_from_fov(fov_degrees, imshape, device=None) -> torch.Tensor:
    """[1, 3, 3] intrinsics whose focal length makes the larger image side
    span `fov_degrees`; principal point at the image center. `imshape` is
    (height, width). Computed in float32 like the JAX version."""
    shape = torch.tensor(imshape, dtype=torch.float32, device=device)
    fov = torch.as_tensor(fov_degrees, dtype=torch.float32, device=device)
    fov_radians = fov * torch.tensor(math.pi / 180.0, dtype=torch.float32, device=device)
    focal = torch.max(shape) / (torch.tan(fov_radians / 2) * 2)
    _0 = torch.zeros_like(focal)
    _1 = torch.ones_like(focal)
    return torch.stack([
        torch.stack([focal, _0, shape[1] / 2]),
        torch.stack([_0, focal, shape[0] / 2]),
        torch.stack([_0, _0, _1])])[None]


def corner_aligned_scale_mat(factor: float, device=None) -> torch.Tensor:
    """[3, 3] intrinsics adjustment for resizing by `factor` with
    pixel-center-preserving semantics."""
    factor = torch.tensor(factor, dtype=torch.float32, device=device)
    shift = (factor - 1) / 2
    _0 = torch.zeros_like(factor)
    _1 = torch.ones_like(factor)
    return torch.stack([
        torch.stack([factor, _0, shift]),
        torch.stack([_0, factor, shift]),
        torch.stack([_0, _0, _1])])
