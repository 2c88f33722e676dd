"""Shared backbone building blocks (`metrabs_tpu/models/backbones/common.py`):
explicit padding with the centered-stride bottom-right shift, a convolution
that computes in its input's dtype, inference and train-mode BatchNorm,
drop-connect, and the family's input preprocessing."""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

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


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computing in its input's dtype, as flax's `Conv(dtype=...,
    param_dtype=float32)`: float32 weights are cast to bfloat16 for bfloat16
    activations (a no-op when the dtypes agree). A call may give the stride
    and dilation: the train and test plans of an EfficientNetV2 block share
    one weight but may differ in both."""

    def forward(self, x: torch.Tensor, stride: Optional[int] = None,
                dilation: Optional[int] = None) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, stride or self.stride,
                        self.padding, dilation or self.dilation, self.groups)


def at_least_f32(dtype: torch.dtype) -> torch.dtype:
    """flax's statistics dtype: float32, or float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


class FrozenBatchNorm2d(nn.Module):
    """Inference-mode BatchNorm over NCHW: y = (x - mean) * rsqrt(var + eps) *
    weight + bias, computed in float32 (float64 for float64 inputs) and cast
    back to the input dtype, as flax's BatchNorm does. Parameter names follow
    `nn.BatchNorm2d` (weight, bias, running_mean, running_var)."""

    def __init__(self, num_features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        centered = (x.to(at_least_f32(x.dtype))
                    - self.running_mean.float().reshape(1, -1, 1, 1))
        return self._scale_shift(centered, self.running_var, x.dtype)

    def _scale_shift(self, centered: torch.Tensor, var: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
        """The rest of flax's `_normalize`: centered * (rsqrt(var + eps) *
        weight) + bias, in at least float32, cast to `dtype`."""
        shape = (1, -1, 1, 1)
        mul = (torch.rsqrt(var.to(at_least_f32(var.dtype)) + self.eps)
               * self.weight.float()).reshape(shape)
        return (centered * mul + self.bias.float().reshape(shape)).to(dtype)

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-channel float32 (scale, bias) of this BN, for the fused MBConv
        kernel (`GhostBatchNorm(fold=True)` in JAX)."""
        return fold_bn(self.weight, self.bias, self.running_mean, self.running_var,
                       self.eps)


class GhostBatchNorm(FrozenBatchNorm2d):
    """BatchNorm that normalises with batch statistics in train mode
    (`common.GhostBatchNorm` of the JAX package, flax's `nn.BatchNorm`), and
    is `FrozenBatchNorm2d` in eval mode.

    Train mode, over each of `splits` consecutive batch slices in turn: mean
    and the biased variance E[x^2] - E[x]^2 (clamped at 0) in at least
    float32 (in the input's dtype with `bf16_stats`), normalisation with
    them, and the
    running statistics updated as momentum * running + (1 - momentum) *
    batch. `F.batch_norm` is not used: it writes the unbiased variance into
    `running_var`. `update_stats` is cleared while a checkpointed block
    recomputes its forward (`frozen_stats`), so that a step updates the
    running statistics once."""

    def __init__(self, num_features: int, eps: float, momentum: float, splits: int = 1,
                 bf16_stats: bool = False):
        super().__init__(num_features, eps)
        self.momentum = momentum
        self.splits = splits
        self.bf16_stats = bf16_stats
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        n = x.shape[0]
        if n % self.splits:
            raise ValueError(f'Batch {n} not divisible by ghost splits {self.splits}')
        parts = [self._batch_norm(part) for part in x.split(n // self.splits)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        stats = x if self.bf16_stats else x.to(at_least_f32(x.dtype))
        mean = stats.mean(dim=(0, 2, 3))
        var = torch.clamp((stats * stats).mean(dim=(0, 2, 3)) - mean * mean, min=0)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean.float())
                self.running_var.copy_(m * self.running_var + (1 - m) * var.float())
        centered = stats - mean.reshape(1, -1, 1, 1)
        return self._scale_shift(centered.to(at_least_f32(centered.dtype)), var, x.dtype)


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Within: the `GhostBatchNorm`s of `module` leave their running
    statistics alone (a checkpointed block's recompute)."""
    bns = [m for m in module.modules() if isinstance(m, GhostBatchNorm)]
    saved = [bn.update_stats for bn in bns]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn, flag in zip(bns, saved):
            bn.update_stats = flag


def drop_mask(n: int, survival_prob: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """[n] bool: which samples keep their residual branch, each with
    probability `survival_prob` (`jax.random.bernoulli`: uniform < p)."""
    p = min(max(survival_prob, 1e-6), 1.0)
    return torch.rand(n, generator=generator, device=device) < p


def stochastic_depth(x: torch.Tensor, residual: torch.Tensor, survival_prob: float,
                     keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Residual add with drop-connect: x + residual / p where `keep` [N] (from
    `drop_mask`) holds, x elsewhere; x + residual without a mask."""
    if keep is None:
        return x + residual
    p = torch.tensor(min(max(survival_prob, 1e-6), 1.0), dtype=torch.float32)
    scaled = residual / p.to(device=residual.device, dtype=residual.dtype)
    return x + torch.where(keep.reshape((-1,) + (1,) * (residual.ndim - 1)), scaled,
                           torch.zeros_like(scaled))


def tf_preproc(x: torch.Tensor) -> torch.Tensor:
    """Gamma-space RGB in [0, 1] -> [-1, 1] (the EfficientNetV2 family)."""
    return 2.0 * x - 1.0
