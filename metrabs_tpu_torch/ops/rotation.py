"""Rotation-matrix construction (`metrabs_tpu/ops/rotation.py`).

Row-vector convention: R maps camera-space points p via p @ R.T, and
`lookat_rotation_matrix` stacks the new basis vectors as rows.
"""

from __future__ import annotations

import torch


def lookat_rotation_matrix(forward_vector: torch.Tensor,
                           up_vector: torch.Tensor) -> torch.Tensor:
    """[batch, 3, 3] rotation whose +Z axis points along `forward_vector`
    ([batch, 3]); `up_vector` is [batch, 3] or [3]. Falls back to a rotation
    about the old Y when forward is parallel to up."""
    up_vector = torch.broadcast_to(up_vector, forward_vector.shape)
    new_z = forward_vector / torch.linalg.norm(forward_vector, dim=-1, keepdim=True)
    new_x = torch.linalg.cross(new_z, up_vector, dim=-1)
    zeros = torch.zeros_like(new_z[..., 2])
    new_x_alt = torch.stack([new_z[..., 2], zeros, -new_z[..., 0]], dim=-1)
    x_norm = torch.linalg.norm(new_x, dim=-1, keepdim=True)
    new_x = torch.where(x_norm == 0, new_x_alt, new_x)
    new_x = new_x / torch.linalg.norm(new_x, dim=-1, keepdim=True)
    new_y = torch.linalg.cross(new_z, new_x, dim=-1)
    return torch.stack([new_x, new_y, new_z], dim=-2)

