"""Soft-argmax heatmap decoding (`metrabs_tpu/ops/heatmap_decode.py`).

The decode runs in float32 whatever the backbone's compute dtype.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

Axes = Union[int, Sequence[int]]


def _normalize_axes(axes: Axes, ndim: int):
    axes = (axes,) if isinstance(axes, int) else tuple(axes)
    return tuple(ax if ax >= 0 else ndim + ax for ax in axes)


def softmax_multi_axis(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Softmax jointly over several axes."""
    axes = _normalize_axes(axes, x.ndim)
    m = torch.amax(x, dim=axes, keepdim=True)
    e = torch.exp(x - m)
    return e / torch.sum(e, dim=axes, keepdim=True)


def decode_heatmap(inp: torch.Tensor, axes: Axes, output_coord_axis: int = -1) -> torch.Tensor:
    """Per-axis expected coordinate in [0, 1] of a normalized heatmap, stacked
    along `output_coord_axis` in the order the axes were given."""
    heatmap_axes = _normalize_axes(axes, inp.ndim)
    results = []
    for ax in heatmap_axes:
        other_axes = tuple(a for a in heatmap_axes if a != ax)
        marginal = torch.sum(inp, dim=other_axes, keepdim=True) if other_axes else inp
        n_bins = inp.shape[ax]
        coords = torch.linspace(0.0, 1.0, n_bins, dtype=inp.dtype, device=inp.device)
        coords = coords.reshape((n_bins,) + (1,) * (inp.ndim - ax - 1))
        decoded = torch.sum(marginal * coords, dim=ax, keepdim=True)
        for a in sorted(heatmap_axes, reverse=True):
            decoded = decoded.squeeze(a)
        results.append(decoded)
    return torch.stack(results, dim=output_coord_axis)


def soft_argmax(logits: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Softmax + expected coordinate, in [0, 1] per axis."""
    return decode_heatmap(softmax_multi_axis(logits.float(), axes), axes)
