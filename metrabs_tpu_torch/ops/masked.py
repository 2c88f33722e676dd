"""Masked reductions with `divide_no_nan` semantics (`metrabs_tpu/ops/masked.py`).

Invalid entries are zeroed and the divisor is the count of valid entries
(0/0 = 0), so fully padded batches stay finite.

`batch_mean_masked` and `batch_mean` are the losses' means over every
dim, the batch's included: in a data-parallel step
(`parallel.mesh.data_parallel`) the sum and the count of every rank's rows
are summed over 'data' first, so that the mean, and its gradient, are
those of the global batch (a per-rank mean averaged over the ranks is not
where ranks hold different numbers of valid entries).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from metrabs_tpu_torch.parallel import mesh as mesh_mod

Axis = Union[None, int, Sequence[int]]


def _expand_mask(mask: torch.Tensor, target_ndim: int) -> torch.Tensor:
    """Right-pads the mask shape with singleton dims to the target rank."""
    return mask.reshape(mask.shape + (1,) * (target_ndim - mask.ndim))


def _dims(axis: Axis, ndim: int):
    return tuple(range(ndim)) if axis is None else axis


def divide_no_nan(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    y_is_zero = y == 0
    return torch.where(y_is_zero, torch.zeros_like(x),
                       x / torch.where(y_is_zero, torch.ones_like(y), y))


def reduce_mean_masked(x: torch.Tensor, is_valid: Optional[torch.Tensor],
                       axis: Axis = None, keepdim: bool = False) -> torch.Tensor:
    """Mean over `axis`, ignoring entries where `is_valid` is False; the mask
    covers the leading dims of `x` and broadcasts over the trailing ones."""
    dims = _dims(axis, x.ndim)
    if is_valid is None:
        return torch.mean(x, dim=dims, keepdim=keepdim)
    mask = _expand_mask(is_valid, x.ndim)
    sum_valid = torch.sum(torch.where(mask, x, torch.zeros_like(x)), dim=dims,
                          keepdim=keepdim)
    n_valid = torch.sum(torch.broadcast_to(mask, x.shape).to(x.dtype), dim=dims,
                        keepdim=keepdim)
    return divide_no_nan(sum_valid, n_valid)


def reduce_sum_masked(x: torch.Tensor, is_valid: torch.Tensor, axis: Axis = None,
                      keepdim: bool = False) -> torch.Tensor:
    mask = _expand_mask(is_valid, x.ndim)
    return torch.sum(torch.where(mask, x, torch.zeros_like(x)),
                     dim=_dims(axis, x.ndim), keepdim=keepdim)


def mean_stdev_masked(x: torch.Tensor, is_valid: torch.Tensor, items_axis: int,
                      dimensions_axis: int,
                      fixed_ref: Optional[torch.Tensor] = None):
    """Masked mean and pooled standard deviation: squared deviations pool
    over the items and dimensions axes, divided by the item count only."""
    if fixed_ref is not None:
        mean = fixed_ref
    else:
        mean = reduce_mean_masked(x, is_valid, axis=items_axis, keepdim=True)
    centered = x - mean
    mask = _expand_mask(is_valid, x.ndim)
    n_valid = torch.sum(torch.broadcast_to(mask, x.shape).to(x.dtype),
                        dim=items_axis, keepdim=True)
    n_valid = n_valid.narrow(dimensions_axis, 0, 1)
    sum_sq = reduce_sum_masked(torch.square(centered), is_valid,
                               axis=(items_axis, dimensions_axis), keepdim=True)
    stdev = torch.sqrt(divide_no_nan(sum_sq, n_valid) + 1e-10)
    return mean, stdev


def batch_mean_masked(x: torch.Tensor, is_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """`reduce_mean_masked(x, is_valid)` over every dim, over the global
    batch in a data-parallel step (module docstring)."""
    layout = mesh_mod.active_layout()
    if layout is None or not layout.distributed:
        return reduce_mean_masked(x, is_valid)
    if is_valid is None:
        return batch_mean(x)
    mask = _expand_mask(is_valid, x.ndim)
    sums = torch.stack([torch.sum(torch.where(mask, x, torch.zeros_like(x))),
                        torch.sum(torch.broadcast_to(mask, x.shape).to(x.dtype))])
    sums = mesh_mod.batch_sum(sums)
    return divide_no_nan(sums[0], sums[1])


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """`torch.mean(x)`, over the global batch in a data-parallel step."""
    layout = mesh_mod.active_layout()
    if layout is None or not layout.distributed:
        return torch.mean(x)
    return mesh_mod.batch_sum(torch.sum(x)) / (x.numel() * layout.n_data)
