"""Shared backbone building blocks (`metrabs_tpu/models/backbones/common.py`):
explicit padding with the centered-stride bottom-right shift, inference
BatchNorm, and the family's input preprocessing."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from metrabs_tpu_torch.ops.mbconv import fold_bn


def fixed_padding_amounts(kernel_size: int, rate: int = 1,
                          shift: int = 0) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Explicit SAME-equivalent padding ((top, bottom), (left, right)) for a
    VALID conv, with an optional bottom-right shift of the sampling grid."""
    effective = kernel_size + (kernel_size - 1) * (rate - 1)
    pad_total = effective - 1
    pad_beg = pad_total // 2
    pad_end = pad_total - pad_beg
    return ((pad_beg - shift, pad_end + shift), (pad_beg - shift, pad_end + shift))


def pad_nchw(x: torch.Tensor, pads: Tuple[Tuple[int, int], Tuple[int, int]]) -> torch.Tensor:
    """Zero-pads an NCHW tensor by `fixed_padding_amounts`' result."""
    (top, bottom), (left, right) = pads
    return F.pad(x, (left, right, top, bottom))


class FrozenBatchNorm2d(nn.Module):
    """Inference-mode BatchNorm over NCHW: y = (x - mean) * rsqrt(var + eps) *
    weight + bias, computed in float32 and cast back to the input dtype, as
    flax's BatchNorm does with float32 statistics. Parameter names follow
    `nn.BatchNorm2d` (weight, bias, running_mean, running_var)."""

    def __init__(self, num_features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mean = self.running_mean.float().reshape(shape)
        mul = (torch.rsqrt(self.running_var.float() + self.eps)
               * self.weight.float()).reshape(shape)
        y = (x.float() - mean) * mul + self.bias.float().reshape(shape)
        return y.to(x.dtype)

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-channel float32 (scale, bias) of this BN, for the fused MBConv
        kernel (`GhostBatchNorm(fold=True)` in JAX)."""
        return fold_bn(self.weight, self.bias, self.running_mean, self.running_var,
                       self.eps)


def tf_preproc(x: torch.Tensor) -> torch.Tensor:
    """Gamma-space RGB in [0, 1] -> [-1, 1] (the EfficientNetV2 family)."""
    return 2.0 * x - 1.0
