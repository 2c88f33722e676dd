"""Shared backbone building blocks (`metrabs_tpu/models/backbones/common.py`):
explicit padding with the centered-stride bottom-right shift and flax's
'SAME' padding, a convolution that computes in its input's dtype, the
activations, inference and train-mode BatchNorm, flax's GroupNorm,
drop-connect, rematerialised blocks, and each family's input
preprocessing."""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from metrabs_tpu_torch.ops.mbconv import fold_bn
from metrabs_tpu_torch.parallel import mesh as mesh_mod


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


def same_pads(n: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's 'SAME' padding (before, after) of one axis of length `n`: at
    stride 2 an even side pads (0, 1), not symmetrically."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """An NCHW tensor padded for a VALID `kernel` x `kernel` window at
    `stride` to give flax's 'SAME' output (max pools pad with -inf)."""
    top, bottom = same_pads(x.shape[2], kernel, stride)
    left, right = same_pads(x.shape[3], kernel, stride)
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computing in its input's dtype, as flax's `Conv(dtype=...,
    param_dtype=float32)`: float32 weights are cast to bfloat16 for bfloat16
    activations (a no-op when the dtypes agree). A call may give the stride
    and dilation: the train and test plans of an EfficientNetV2 block share
    one weight but may differ in both. A weight sharded over a mesh's
    'model' axis (`parallel.mesh.shard_module` sets `tp`) runs
    column-parallel."""

    tp = None

    def forward(self, x: torch.Tensor, stride: Optional[int] = None,
                dilation: Optional[int] = None) -> torch.Tensor:
        if self.tp is not None:
            return mesh_mod.column_parallel_conv2d(self, x, stride, dilation)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, stride or self.stride,
                        self.padding, dilation or self.dilation, self.groups)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) * (1.0 / 6.0)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


ACTIVATIONS = {
    'relu': F.relu,
    'silu': F.silu,
    'swish': F.silu,
    'hard_swish': hard_swish,
    'gelu': lambda x: F.gelu(x, approximate='tanh'),  # flax's nn.gelu
}


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
    running statistics once.

    In a data-parallel step over several 'data' ranks
    (`parallel.mesh.data_parallel`) the splits are those of the global
    batch, [all 3D rows; all 2D rows], as JAX's sharded step computes them:
    a split may straddle ranks and a rank's rows fall in several splits.
    Each rank sums x and x^2 over its rows of every split, the [splits, 2,
    C] sums are all-reduced over 'data', and the running statistics, which
    stay replicated, are updated once per split in order."""

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
        layout = mesh_mod.active_layout()
        if layout is not None and layout.distributed:
            return self._global_batch_norm(x, layout)
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

    def _global_batch_norm(self, x: torch.Tensor, layout) -> torch.Tensor:
        """Train mode over the global batch of `layout` (class docstring):
        the sums in at least float32, the statistics rounded to the input's
        dtype with `bf16_stats`."""
        g = self.splits
        if layout.n_global % g:
            raise ValueError(f'Batch {layout.n_global} not divisible by ghost splits {g}')
        acc = at_least_f32(x.dtype)
        stats_dtype = x.dtype if self.bf16_stats else acc
        xs = x.to(acc)
        split = (layout.rows // (layout.n_global // g)).to(x.device)  # [n] split of each row
        onehot = F.one_hot(split, g).to(acc)  # [n, g]
        sums = torch.stack([onehot.T @ xs.sum(dim=(2, 3)), onehot.T @ (xs * xs).sum(dim=(2, 3))],
                           dim=1)  # [g, 2, C]
        sums = mesh_mod.all_reduce_sum(sums, layout.group)
        count = float(layout.n_global // g * x.shape[2] * x.shape[3])
        mean = (sums[:, 0] / count).to(stats_dtype)
        var = torch.clamp((sums[:, 1] / count).to(stats_dtype) - mean * mean, min=0)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                for k in range(g):
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean[k].float())
                    self.running_var.copy_(m * self.running_var + (1 - m) * var[k].float())
        centered = (x.to(stats_dtype) - mean[split][:, :, None, None]).to(acc)
        mul = (torch.rsqrt(var[split].to(acc) + self.eps) * self.weight.float())[:, :, None, None]
        return (centered * mul + self.bias.float().reshape(1, -1, 1, 1)).to(x.dtype)


class BnOptions:
    """How a backbone's BatchNorms are built: none with `bn_fold` (the convs
    carry a bias instead), else `GhostBatchNorm` with the family's `eps`
    and `momentum` and the backbone's ghost splits and statistics dtype."""

    def __init__(self, bn_fold: bool, ghost_splits: int = 1, bf16_stats: bool = False, *,
                 eps: float, momentum: float):
        self.bn_fold, self.ghost_splits, self.bf16_stats = bn_fold, ghost_splits, bf16_stats
        self.eps, self.momentum = eps, momentum

    def __call__(self, c: int) -> nn.Module:
        if self.bn_fold:
            return nn.Identity()
        return GhostBatchNorm(c, self.eps, self.momentum, self.ghost_splits, self.bf16_stats)


class GroupNormCompat(nn.Module):
    """flax's `nn.GroupNorm` over NCHW, as the JAX package's GroupNormCompat
    wraps it (the reference's resnet50v1_5_groupnorm: 32 groups, eps 1e-5):
    statistics per sample and group of `C / groups` consecutive channels,
    mean and E[x^2] - E[x]^2 (clamped at 0) in at least float32, then
    `FrozenBatchNorm2d`'s scale and shift. The scale and shift sit under
    `gn`, the name of the wrapped module in the JAX tree."""

    def __init__(self, num_features: int, eps: float = 1e-5, groups: int = 32):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.gn = nn.Module()
        self.gn.weight = nn.Parameter(torch.ones(num_features))
        self.gn.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        xs = x.to(at_least_f32(x.dtype)).reshape(n, self.groups, c // self.groups, h, w)
        mean = xs.mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp((xs * xs).mean(dim=(2, 3, 4), keepdim=True) - mean * mean, min=0)
        centered = (xs - mean).reshape(n, c, h, w)
        var = var.expand(-1, -1, c // self.groups, -1, -1).reshape(n, c, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.gn.weight.float().reshape(1, -1, 1, 1)
        return (centered * mul + self.gn.bias.float().reshape(1, -1, 1, 1)).to(x.dtype)


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


def call_block(block: nn.Module, *args, remat: bool = False):
    """`block(*args)`; with `remat` and gradients on, recomputed in the
    backward pass (`torch.utils.checkpoint`, non-reentrant) with the block's
    running statistics left alone during the recompute."""
    if not (remat and torch.is_grad_enabled()):
        return block(*args)
    return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), frozen_stats(block)))


def drop_mask(n: int, survival_prob: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """[n] bool: which samples keep their residual branch, each with
    probability `survival_prob` (`jax.random.bernoulli`: uniform < p); in a
    data-parallel step, this rank's rows of the global batch's draw."""
    p = min(max(survival_prob, 1e-6), 1.0)
    return mesh_mod.batch_rand(n, generator, device) < p


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


# Per-family input preprocessing of gamma-space RGB in [0, 1], in the
# input's dtype.

def tf_preproc(x: torch.Tensor) -> torch.Tensor:
    """-> [-1, 1] (EfficientNetV2, ResNet V2)."""
    return 2.0 * x - 1.0


def torch_preproc(x: torch.Tensor) -> torch.Tensor:
    """ImageNet mean and standard deviation (ResNet V1.5)."""
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=x.dtype, device=x.device)
    std = torch.tensor([0.229, 0.224, 0.225], dtype=x.dtype, device=x.device)
    return (x - mean) / std


def caffe_preproc(x: torch.Tensor) -> torch.Tensor:
    """255 x minus the BGR-ordered means, applied to RGB values as they are,
    as the reference does (ResNet V1 and the basic-block ResNets)."""
    mean = torch.tensor([103.939, 116.779, 123.68], dtype=x.dtype, device=x.device)
    return 255.0 * x - mean


def mobilenet_preproc(x: torch.Tensor) -> torch.Tensor:
    """MobileNetV3's x 255 then Rescaling(1 / 127.5, -1)."""
    return (255.0 / 127.5) * x - 1.0
