"""Absolute-pose reconstruction from 2D and metric 3D predictions
(`metrabs_tpu/ops/reconstruct.py`).

The full-perspective reference point is the Tikhonov-regularized weighted
least-squares solve of the reference (`l2_regularizer=1e-2`), written as
batched 3x3 normal equations. Training passes a per-sample
`mix_3d_inside_fov` [N, 1, 1] and differentiates through both the solve and
the weak-perspective branch; `project_pose` is the losses' projection.
"""

from __future__ import annotations

from typing import Optional

import torch

from metrabs_tpu_torch.ops import masked
from metrabs_tpu_torch.ops.camera import to_homogeneous


def is_within_fov(imcoords: torch.Tensor, *, proc_side: int, stride: int,
                  centered_stride: bool = True,
                  border_factor: float = 0.75) -> torch.Tensor:
    """True where 2D image coords lie inside the stride-aware trusted band."""
    offset = 0.0 if centered_stride else -stride / 2.0
    lower = stride * border_factor + offset
    upper = proc_side - stride * border_factor + offset
    return torch.all((imcoords >= lower) & (imcoords <= upper), dim=-1)


def back_project(camcoords2d: torch.Tensor, delta_z: torch.Tensor,
                 z_offset: torch.Tensor) -> torch.Tensor:
    """Lifts normalized 2D points to 3D given per-joint depth offsets."""
    return to_homogeneous(camcoords2d) * (delta_z + z_offset[..., None])[..., None]


def project_pose(coords3d: torch.Tensor, intrinsic_matrix: torch.Tensor) -> torch.Tensor:
    """Projects camera-space 3D joints to pixels with z clamped to >= 1 mm
    (the training losses' projection; serving uses `camera.project`)."""
    projected = coords3d / torch.clamp(coords3d[..., 2:], min=1.0)
    return torch.einsum('...nk,...jk->...nj', projected, intrinsic_matrix[..., :2, :])


def reconstruct_ref_weakpersp(normalized_2d: torch.Tensor, coords3d_rel: torch.Tensor,
                              validity_mask: torch.Tensor) -> torch.Tensor:
    """Weak-perspective reference point: depth from the ratio of 3D to 2D
    spread, placed so that the masked means align."""
    _, stdev3d = masked.mean_stdev_masked(
        coords3d_rel[..., :2], validity_mask, items_axis=-2, dimensions_axis=-1)
    mean2d, stdev2d = masked.mean_stdev_masked(
        normalized_2d[..., :2], validity_mask, items_axis=-2, dimensions_axis=-1)
    stdev2d = torch.clamp(stdev2d, min=1e-5)
    stdev3d = torch.clamp(stdev3d, min=1e-5)
    old_mean = masked.reduce_mean_masked(coords3d_rel, validity_mask, axis=-2,
                                         keepdim=True)
    new_mean_z = masked.divide_no_nan(stdev3d, stdev2d)
    new_mean = to_homogeneous(mean2d) * new_mean_z
    return torch.squeeze(new_mean - old_mean, dim=-2)


def reconstruct_ref_fullpersp(normalized_2d: torch.Tensor, coords3d_rel: torch.Tensor,
                              validity_mask: torch.Tensor,
                              sample_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-perspective reference point by weighted, Tikhonov-regularized
    least squares, solved as batched 3x3 normal equations.

    `sample_valid` ([...] bool) excludes padding crops from the pooled RMS
    normalization; exclusion is where-before-square, since padding crops may
    carry non-finite coordinates."""
    def rms_normalize(x):
        if sample_valid is None:
            scale = torch.sqrt(torch.mean(torch.square(x)))
        else:
            mask = sample_valid.reshape(
                sample_valid.shape + (1,) * (x.ndim - sample_valid.ndim))
            mask = torch.broadcast_to(mask, x.shape).bool()
            xm = torch.where(mask, x, torch.zeros_like(x))
            scale = torch.sqrt(torch.sum(torch.square(xm))
                               / torch.clamp(torch.sum(mask.to(x.dtype)), min=1.0))
        scale = torch.clamp(scale, min=1e-10)
        return scale, x / scale

    scale2d, p = rms_normalize(normalized_2d)
    rel_backproj = normalized_2d * coords3d_rel[..., 2:] - coords3d_rel[..., :2]
    scale_rel_backproj, b = rms_normalize(rel_backproj)

    w = validity_mask.to(normalized_2d.dtype) + 1e-4
    w2 = torch.square(w)

    # M = sum_j w_j^2 [[1,0,-px],[0,1,-py],[-px,-py,px^2+py^2]] + 1e-2 I
    # v = sum_j w_j^2 [bx, by, -(px bx + py by)]
    sw = torch.sum(w2, dim=-1)
    swp = torch.sum(w2[..., None] * p, dim=-2)
    swpp = torch.sum(w2 * torch.sum(torch.square(p), dim=-1), dim=-1)
    zeros = torch.zeros_like(sw)
    M = torch.stack([
        torch.stack([sw, zeros, -swp[..., 0]], dim=-1),
        torch.stack([zeros, sw, -swp[..., 1]], dim=-1),
        torch.stack([-swp[..., 0], -swp[..., 1], swpp], dim=-1)], dim=-2)
    M = M + 1e-2 * torch.eye(3, dtype=M.dtype, device=M.device)

    swb = torch.sum(w2[..., None] * b, dim=-2)
    swpb = torch.sum(w2 * torch.sum(p * b, dim=-1), dim=-1)
    v = torch.cat([swb, -swpb[..., None]], dim=-1)

    ref = torch.linalg.solve(M, v[..., None])[..., 0]
    return torch.cat([ref[..., :2] * scale_rel_backproj,
                      ref[..., 2:] * (scale_rel_backproj / scale2d)], dim=-1)


def reconstruct_absolute(
        coords2d: torch.Tensor, coords3d_rel: torch.Tensor, intrinsics: torch.Tensor,
        *, proc_side: int, stride: int, centered_stride: bool = True,
        mix_3d_inside_fov=None, weak_perspective: bool = False,
        sample_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fuses 2D pixel and metric root-relative 3D predictions into absolute
    camera-space 3D joints: inside the FOV band the 2D-based estimate
    (optionally blended with the 3D one by `mix_3d_inside_fov`, a float or a
    tensor broadcasting against [N, J, 3]) wins, outside the 3D-based one.
    The RMS normalisation of the full-perspective solve pools over the whole
    batch."""
    inv_intrinsics = torch.linalg.inv(intrinsics.to(coords2d.dtype))
    coords2d_normalized = (to_homogeneous(coords2d)
                           @ inv_intrinsics.transpose(-1, -2))[..., :2]
    in_fov = is_within_fov(coords2d, proc_side=proc_side, stride=stride,
                           centered_stride=centered_stride)
    if weak_perspective:
        ref = reconstruct_ref_weakpersp(coords2d_normalized, coords3d_rel, in_fov)
    else:
        ref = reconstruct_ref_fullpersp(coords2d_normalized, coords3d_rel, in_fov,
                                        sample_valid=sample_valid)
    coords_abs_3d_based = coords3d_rel + ref[..., None, :]
    coords_abs_2d_based = back_project(coords2d_normalized, coords3d_rel[..., 2],
                                       ref[..., 2])
    if mix_3d_inside_fov is not None:
        coords_abs_2d_based = (mix_3d_inside_fov * coords_abs_3d_based
                               + (1 - mix_3d_inside_fov) * coords_abs_2d_based)
    return torch.where(in_fov[..., None], coords_abs_2d_based, coords_abs_3d_based)
