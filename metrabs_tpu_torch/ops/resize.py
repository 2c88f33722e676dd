"""Image resizing with `jax.image.resize`'s semantics, for the detector.

`resize_linear` is `jax.image.resize(method='linear', antialias=...)`: the
scale-and-translate triangle kernel, widened by 1/scale when downsampling
with antialias, with normalized weights and half-pixel centers. It builds one
weight matrix per spatial axis, in float32 and cast to the image's dtype as
JAX does, and contracts the image with them, the cheaper axis first (the
order JAX's einsum picks; it only changes bfloat16 rounding). It is not
`F.interpolate(antialias=True)`, whose kernel support and edge handling
differ.

`upsample_nearest_2x` is `jax.image.resize(method='nearest')` to twice the
size, i.e. every pixel repeated 2x2.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def linear_weight_matrix(in_size: int, out_size: int, antialias: bool,
                         device=None) -> torch.Tensor:
    """[in_size, out_size] float32 weights (`jax._src.image.scale.
    compute_weight_mat` with the triangle kernel and zero translation)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=torch.float32,
                                                   device=device)[:, None]) / kernel_scale
    weights = torch.clamp_min(1 - torch.abs(x), 0)
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_linear(images: torch.Tensor, size: Tuple[int, int],
                  antialias: bool) -> torch.Tensor:
    """images [N, H, W, C] (float) -> [N, out_h, out_w, C] in the same dtype."""
    _, h, w, _ = images.shape
    out_h, out_w = size
    x = images
    # The cheaper contraction first: H first costs out_h * W * H + out_h * out_w * W.
    h_first = out_h * w * h + out_h * out_w * w <= h * out_w * w + out_h * out_w * h
    for axis in ((1, 2) if h_first else (2, 1)):
        in_size, out_size = x.shape[axis], size[axis - 1]
        if in_size == out_size:
            continue  # JAX skips an axis whose size does not change
        wm = linear_weight_matrix(in_size, out_size, antialias, x.device).to(x.dtype)
        x = (torch.einsum('nhwc,hH->nHwc', x, wm) if axis == 1
             else torch.einsum('nhwc,wW->nhWc', x, wm))
    return x


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """NCHW [N, C, H, W] -> [N, C, 2H, 2W], each pixel repeated 2x2."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
