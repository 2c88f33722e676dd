"""OpenCV-style 12-coefficient lens distortion (`metrabs_tpu/ops/distortion.py`).

Coefficients (k1 k2 p1 p2 k3 k4 k5 k6 s1 s2 s3 s4): rational radial,
tangential and thin-prism terms. Branch-free: zero coefficients reduce
exactly to the identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NUM_DIST_COEFFS = 12


def pad_distortion_coeffs(d: torch.Tensor) -> torch.Tensor:
    """Zero-pads the trailing axis to the full 12-coefficient vector."""
    n = d.shape[-1]
    if n > NUM_DIST_COEFFS:
        raise ValueError(f'Expected at most {NUM_DIST_COEFFS} coeffs, got {n}')
    if n == NUM_DIST_COEFFS:
        return d
    return F.pad(d, (0, NUM_DIST_COEFFS - n))


def distortion_terms(undist_points2d: torch.Tensor, distortion_coeffs: torch.Tensor):
    """(a, b, c) with distorted = p * (a + b) + c.

    The coefficients' batch dims align with the leading dims of the points;
    the remaining point dims broadcast, as in the JAX version."""
    d = pad_distortion_coeffs(distortion_coeffs.to(undist_points2d.dtype))
    if d.ndim > 1:
        new_shape = (tuple(d.shape[:-1]) + (1,) * (undist_points2d.ndim - d.ndim)
                     + (NUM_DIST_COEFFS,))
    else:
        new_shape = (1,) * (undist_points2d.ndim - 1) + (NUM_DIST_COEFFS,)
    d = d.reshape(new_shape)

    r2 = torch.sum(torch.square(undist_points2d), dim=-1, keepdim=True)
    a_num = ((d[..., 4:5] * r2 + d[..., 1:2]) * r2 + d[..., 0:1]) * r2 + 1.0
    a_den = ((d[..., 7:8] * r2 + d[..., 6:7]) * r2 + d[..., 5:6]) * r2 + 1.0
    a = a_num / a_den
    p2p1 = torch.stack([d[..., 3], d[..., 2]], dim=-1)
    b = 2.0 * torch.sum(undist_points2d * p2p1, dim=-1, keepdim=True)
    s2s4 = torch.stack([d[..., 9], d[..., 11]], dim=-1)
    s1s3 = torch.stack([d[..., 8], d[..., 10]], dim=-1)
    c = (s2s4 * r2 + p2p1 + s1s3) * r2
    return a, b, c


def distort_points(undist_points2d: torch.Tensor,
                   distortion_coeffs: torch.Tensor) -> torch.Tensor:
    """Forward lens distortion of normalized 2D points."""
    a, b, c = distortion_terms(undist_points2d, distortion_coeffs)
    return undist_points2d * (a + b) + c


def undistort_points(dist_points2d: torch.Tensor, distortion_coeffs: torch.Tensor,
                     num_iters: int = 5) -> torch.Tensor:
    """Inverse distortion by fixed-point iteration (5 steps, as the reference)."""
    undist = dist_points2d
    for _ in range(num_iters):
        a, b, c = distortion_terms(undist, distortion_coeffs)
        undist = (dist_points2d - c - undist * b) / a
    return undist
