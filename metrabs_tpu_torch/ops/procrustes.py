"""Batched, differentiable Procrustes alignment (`metrabs_tpu/ops/
procrustes.py`): registers Y to X by rotation and translation, optionally
uniform scale and reflection, over the valid joints of each pose. PA-MPJPE
(`eval.metrics`) and `rigid_align` use it.

Without reflection the rotation is Horn's: the top eigenvector of a
symmetric 4x4 matrix built from the 3x3 correlation matrix is the rotation's
quaternion, and its eigenvalue is the reflection-corrected sum of singular
values, the scale factor (float32 SVD of a clean rigid correlation matrix
loses ~1e-3 of rotation accuracy; its top eigenvalue is well separated).
The eigenvector's sign is arbitrary, but the rotation is quadratic in it.
With reflection the rotation is U V^T of the SVD.

All-invalid (padding) poses give zero point counts and norms; the
divide-no-nan normalisation keeps them finite, as in JAX.

On the card, `torch.linalg.eigh` and `torch.linalg.svd` read their error
flags back to the host (they have no `_ex` form): one wait per call, over
the whole batch.
"""

from __future__ import annotations

from typing import Optional

import torch


def _normalize_masked(Z: torch.Tensor, mask: torch.Tensor, n_points: torch.Tensor):
    """(mean, norm, centered / norm) of the valid points; an all-invalid pose
    gives zeros."""
    zero = torch.zeros((), dtype=Z.dtype, device=Z.device)
    Z = torch.where(mask, Z, zero)
    mean = torch.sum(Z, dim=-2, keepdim=True) / torch.clamp(n_points, min=1)
    centered = torch.where(mask, Z - mean, zero)
    norm = torch.sqrt(torch.sum(torch.square(centered), dim=(-2, -1), keepdim=True))
    safe_norm = torch.where(norm > 0, norm, torch.ones_like(norm))
    return mean, norm, centered / safe_norm


def _horn_rotation(a: torch.Tensor):
    """The proper rotation Q maximising tr(Q A) for the 3x3 correlation
    matrices `a` [..., 3, 3], and that maximum (the top eigenvalue)."""
    e = lambda i, j: a[..., i, j]
    N = torch.stack([
        torch.stack([e(0, 0) + e(1, 1) + e(2, 2), e(1, 2) - e(2, 1), e(2, 0) - e(0, 2),
                     e(0, 1) - e(1, 0)], dim=-1),
        torch.stack([e(1, 2) - e(2, 1), e(0, 0) - e(1, 1) - e(2, 2), e(0, 1) + e(1, 0),
                     e(2, 0) + e(0, 2)], dim=-1),
        torch.stack([e(2, 0) - e(0, 2), e(0, 1) + e(1, 0), e(1, 1) - e(0, 0) - e(2, 2),
                     e(1, 2) + e(2, 1)], dim=-1),
        torch.stack([e(0, 1) - e(1, 0), e(2, 0) + e(0, 2), e(1, 2) + e(2, 1),
                     e(2, 2) - e(0, 0) - e(1, 1)], dim=-1)], dim=-2)
    eigvals, eigvecs = torch.linalg.eigh(N)
    lam = eigvals[..., -1]
    w, x, y, z = eigvecs[..., -1].unbind(-1)
    Q = torch.stack([
        torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
                    dim=-1),
        torch.stack([2 * (y * x + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
                    dim=-1),
        torch.stack([2 * (z * x - w * y), 2 * (z * y + w * x), w * w - x * x - y * y + z * z],
                    dim=-1)], dim=-2)
    return Q, lam


def procrustes_transform(X: torch.Tensor, Y: torch.Tensor, validity_mask: torch.Tensor,
                         allow_scaling: bool = False, allow_reflection: bool = False):
    """(meanY, T, output_scale, meanX) such that the aligned Y is
    ((Y - meanY) @ T) * output_scale + meanX. X, Y [..., J, 3];
    validity_mask [..., J] bool."""
    mask = validity_mask[..., None]
    n_points = torch.sum(mask.to(X.dtype), dim=-2, keepdim=True)
    meanX, normX, normalizedX = _normalize_masked(X, mask, n_points)
    meanY, normY, normalizedY = _normalize_masked(Y, mask, n_points)
    A = torch.einsum('...ji,...jk->...ik', normalizedY, normalizedX)
    # A degenerate or all-invalid Y (normY == 0) aligns with scale 0.
    safe_scale = torch.where(normY > 0, normX / torch.where(normY > 0, normY, 1.0),
                             torch.zeros_like(normX))
    if not allow_reflection:
        Q, lam = _horn_rotation(A)
        T = Q.transpose(-1, -2)  # row vectors: y @ T ~ x
        singular_sum = lam
    else:
        U, s, Vh = torch.linalg.svd(A, full_matrices=False)
        T = U @ Vh
        singular_sum = torch.sum(s, dim=-1)
    if allow_scaling:
        output_scale = safe_scale * singular_sum[..., None, None]
    else:
        output_scale = torch.ones_like(normX)
    return meanY, T, output_scale, meanX


def procrustes_align(X: torch.Tensor, Y: torch.Tensor, validity_mask: torch.Tensor,
                     allow_scaling: bool = False, allow_reflection: bool = False) -> torch.Tensor:
    """Y aligned to X in the least-squares sense over the valid joints."""
    meanY, T, output_scale, meanX = procrustes_transform(X, Y, validity_mask, allow_scaling,
                                                         allow_reflection)
    return torch.einsum('...jc,...ck->...jk', Y - meanY, T) * output_scale + meanX


def rigid_align(coords_pred: torch.Tensor, coords_true: torch.Tensor, *,
                joint_validity_mask: Optional[torch.Tensor] = None,
                scale_align: bool = False, reflection_align: bool = False) -> torch.Tensor:
    """The predictions [..., J, 3] aligned to the ground truth."""
    if joint_validity_mask is None:
        joint_validity_mask = torch.ones(coords_pred.shape[:-1], dtype=torch.bool,
                                         device=coords_pred.device)
    return procrustes_align(coords_true, coords_pred, joint_validity_mask,
                            allow_scaling=scale_align, allow_reflection=reflection_align)
