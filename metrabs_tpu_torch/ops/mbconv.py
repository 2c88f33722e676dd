"""The fused MBConv inner chain, plain PyTorch version
(`metrabs_tpu/ops/mbconv_pallas.py::fused_mbconv_inner`, TPU kernel K2).

Between the two 1x1 convolutions of an EfficientNetV2 MBConv block, over
the expanded tensor u [N, E, H, W] (NCHW, the port's layout):

    v = silu(BN1(dw3x3(silu(BN0(u)))))   and   se_mean = mean over H, W of v

in the JAX kernel's dtype order: each BN applies its float32 scale and bias
cast to u's dtype, a multiply and an add each rounded to that dtype; silu
is computed in float32 and rounded back; the depthwise conv zero-pads the
*activated* tensor (SAME) and accumulates its 9 taps in float32 in (dy, dx)
order before casting; the SE mean is a float32 sum over v divided by H * W.
The taps are written out, not left to `conv2d`, so that the CUDA kernel
(`csrc/mbconv.cu`) follows this function operation for operation.

`fold_bn` gives the per-channel constants from inference BatchNorm
statistics, as `GhostBatchNorm(fold=True)` does
(`metrabs_tpu/models/backbones/common.py:72-88`); `inner_constants` packs
them with the depthwise taps into the two float32 arrays the chain takes,
which a module computes once and keeps.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def fold_bn(weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, bias) [E] float32: gamma * rsqrt(var + eps) and
    beta - mean * scale."""
    scale = weight.float() * torch.rsqrt(var.float() + eps)
    return scale, bias.float() - mean.float() * scale


def inner_constants(dw_weight: torch.Tensor, scale0: torch.Tensor, bias0: torch.Tensor,
                    scale1: torch.Tensor, bias1: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused chain's constants in the form `fused_mbconv_inner` takes:
    taps [E, 9] float32 (the depthwise weight [E, 1, 3, 3], row-major) and
    sb [4, E] float32 (scale0, bias0, scale1, bias1), both contiguous."""
    e = dw_weight.shape[0]
    taps = dw_weight.float().reshape(e, 9).contiguous()
    sb = torch.stack([scale0, bias0, scale1, bias1]).float().contiguous()
    return taps, sb


def _bn_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    y = x * scale.to(dt)[:, None, None] + bias.to(dt)[:, None, None]
    yf = y.float()
    return (yf * torch.sigmoid(yf)).to(dt)


def fused_mbconv_inner(u: torch.Tensor, taps: torch.Tensor, sb: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u [N, E, H, W] (bfloat16 or float32), the raw expand-conv output;
    taps [E, 9] and sb [4, E] float32 from `inner_constants`. Returns
    (v [N, E, H, W] in u's dtype, se_mean [N, E] float32)."""
    n, e, h, w = u.shape
    a = F.pad(_bn_silu(u, sb[0], sb[1]), (1, 1, 1, 1))
    acc = torch.zeros((n, e, h, w), dtype=torch.float32, device=u.device)
    for dy in range(3):
        for dx in range(3):
            tap = a[:, :, dy:dy + h, dx:dx + w].float()
            acc = acc + tap * taps[:, dy * 3 + dx, None, None]
    v = _bn_silu(acc.to(u.dtype), sb[2], sb[3])
    se_mean = v.float().sum(dim=(2, 3)) / float(h * w)
    return v, se_mean
