"""Fixed-shape greedy non-maximum suppression (`metrabs_tpu/ops/nms.py`).

Shared by the detector's box NMS and the 3D pose NMS: visit the candidates in
descending score order (stable, as `jnp.argsort`); keep one if it is still
unsuppressed and fewer than `max_output` are kept, then suppress everything
whose overlap with it exceeds the threshold. Invalid candidates are never
kept and never suppress others.

Batched over leading axes: the loop takes n steps for the whole batch, each
a few tensor operations on the device, with no host round trip.
"""

from __future__ import annotations

import torch


def greedy_nms(overlap: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               threshold: float, max_output: int) -> torch.Tensor:
    """overlap [..., n, n] pairwise overlap or similarity; scores, valid
    [..., n]. Returns the keep mask [..., n]."""
    batch_shape = scores.shape[:-1]
    n = scores.shape[-1]
    overlap = overlap.reshape(-1, n, n)
    scores = scores.reshape(-1, n)
    valid = valid.reshape(-1, n)
    b = scores.shape[0]
    neg_inf = torch.tensor(float('-inf'), dtype=scores.dtype, device=scores.device)
    order = torch.argsort(-torch.where(valid, scores, neg_inf), dim=-1, stable=True)
    rows = torch.arange(b, device=scores.device)
    alive = torch.ones((b, n), dtype=torch.bool, device=scores.device)
    keep = torch.zeros((b, n), dtype=torch.bool, device=scores.device)
    n_kept = torch.zeros(b, dtype=torch.int64, device=scores.device)
    for i in range(n):
        idx = order[:, i]
        can_keep = alive[rows, idx] & valid[rows, idx] & (n_kept < max_output)
        keep[rows, idx] = can_keep
        n_kept += can_keep
        alive &= ~(can_keep[:, None] & (overlap[rows, idx] > threshold))
    return keep.reshape(batch_shape + (n,))
