"""Fixed-iteration Levenberg-Marquardt depth solve from bone lengths
(`metrabs_tpu/ops/lm_solver.py`), Model25D's absolute reconstruction.

One unknown per example (the reference depth z), so LM is damped 1D
Gauss-Newton: 10 fixed iterations, a step taken only where it lowers the
cost (damping x0.5 then, x4 otherwise), lengths under a 1e-10 floor and a
1e-20 guard on the step's denominator. No host synchronisation: the
intrinsics are inverted in closed form (`torch.linalg.inv` checks its
input on the host).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from metrabs_tpu_torch.ops.camera import to_homogeneous
from metrabs_tpu_torch.ops.reconstruct import back_project, is_within_fov

Bones = Union[torch.Tensor, Sequence[Tuple[int, int]]]


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., 3, 3] matrices by the adjugate over the determinant."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    cof = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1)], dim=-2)
    det = a * cof[..., 0, 0] + b * cof[..., 1, 0] + c * cof[..., 2, 0]
    return cof / det[..., None, None]


def _bone_index(bones: Bones, device) -> torch.Tensor:
    return torch.as_tensor(bones, dtype=torch.long, device=device)


def optimize_z_offset_by_bones(
        coords2d_normalized: torch.Tensor, delta_z: torch.Tensor,
        bone_lengths_ideal: torch.Tensor, bones: Bones, bone_weights: torch.Tensor,
        initial_guess: torch.Tensor, max_iter: int = 10) -> torch.Tensor:
    """The z minimising sum over bones of w_b (||bone_b(z)|| - ideal_b)^2,
    where with x_j = homog(normalized 2D) and y_j = x_j delta_z_j the bone
    vector at depth z is a_b z + b_b, so ||bone||^2 = c z^2 + d z + e."""
    idx = _bone_index(bones, coords2d_normalized.device)
    x = to_homogeneous(coords2d_normalized)  # [..., J, 3]
    y = x * delta_z[..., None]
    a = x[..., idx[:, 0], :] - x[..., idx[:, 1], :]
    b = y[..., idx[:, 0], :] - y[..., idx[:, 1], :]
    c = torch.sum(torch.square(a), dim=-1)  # [..., n_bones]
    d = 2 * torch.sum(a * b, dim=-1)
    e = torch.sum(torch.square(b), dim=-1)

    def lengths(z):  # z: [..., 1]
        return torch.sqrt(torch.clamp(torch.square(z) * c + z * d + e, min=1e-10))

    def residuals(z):
        return (lengths(z) - bone_lengths_ideal) * bone_weights

    z = torch.broadcast_to(torch.as_tensor(initial_guess, dtype=torch.float32)[..., None],
                           coords2d_normalized.shape[:-2] + (1,))
    damping = torch.full_like(z, 1e-3)
    for _ in range(max_iter):
        r = residuals(z)
        jac = (2 * z * c + d) / (2 * lengths(z)) * bone_weights
        jtj = torch.sum(torch.square(jac), dim=-1, keepdim=True)
        jtr = torch.sum(jac * r, dim=-1, keepdim=True)
        z_new = z - jtr / (jtj + damping * jtj + 1e-20)
        cost_old = torch.sum(torch.square(r), dim=-1, keepdim=True)
        cost_new = torch.sum(torch.square(residuals(z_new)), dim=-1, keepdim=True)
        improved = cost_new < cost_old
        z = torch.where(improved, z_new, z)
        damping = torch.where(improved, damping * 0.5, damping * 4.0)
    return z[..., 0]


def reconstruct_absolute_by_bone_lengths(
        coords25d: torch.Tensor, intrinsics: torch.Tensor, bone_lengths_ideal: torch.Tensor,
        bones: Bones, *, proc_side: int, stride: int, centered_stride: bool = True,
        mean_relative: bool = True, only_in_fov: bool = True,
        max_iter: int = 10) -> torch.Tensor:
    """Model25D's absolute reconstruction: [..., J, 3] (x px, y px, z mm
    relative) and intrinsics [..., 3, 3] -> camera-space joints in mm. Only
    bones with both joints inside the FOV band count (others weigh 1e-8)."""
    idx = _bone_index(bones, coords25d.device)
    inv_intrinsics = inv3x3(intrinsics.to(coords25d.dtype))
    coords2d_normalized = (to_homogeneous(coords25d[..., :2])
                           @ inv_intrinsics.transpose(-1, -2))[..., :2]
    z = coords25d[..., 2]
    z_relative = z - (torch.mean(z, dim=-1, keepdim=True) if mean_relative else z[..., -1:])
    if only_in_fov:
        in_fov = is_within_fov(coords25d[..., :2], proc_side=proc_side, stride=stride,
                               centered_stride=centered_stride)
        bone_weights = (in_fov[..., idx[:, 0]] & in_fov[..., idx[:, 1]]).float() + 1e-8
    else:
        bone_weights = torch.ones(coords25d.shape[:-2] + (len(idx),), device=coords25d.device)
    maxi = torch.amax(coords2d_normalized, dim=-2)
    mini = torch.amin(coords2d_normalized, dim=-2)
    distance_guess = 1500.0 / torch.amax(maxi - mini, dim=-1)
    z_ref = optimize_z_offset_by_bones(coords2d_normalized, z_relative, bone_lengths_ideal,
                                       idx, bone_weights, distance_guess, max_iter)
    return back_project(coords2d_normalized, z_relative, z_ref)
