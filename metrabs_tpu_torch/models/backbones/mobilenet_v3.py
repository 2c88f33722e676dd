"""MobileNetV3 Small/Large (and their minimalistic '-mini' variants)
(`metrabs_tpu/models/backbones/mobilenet_v3.py`).

Same architecture as the JAX module: inverted residual blocks with optional
squeeze-excite (hard-sigmoid gate), relu or hard-swish, BN momentum 0.999
and eps 1e-3; a stride-2 block pads explicitly (`correct_pad`) before a
VALID depthwise conv, with the bottom-right shift on the final stride-2
block under `centered_stride`; the stem conv is flax 'SAME' at stride 2
(on an even side it pads (0, 1)); the tail is conv_1 (1x1, BN, act) and
conv_2 (1x1 with bias, act, no BN) to 1024 (small) or 1280 (large)
channels. The minimalistic variant uses relu, 3x3 kernels and no SE. The
width multiplier is 1.0, the only one `build_backbone` makes.

Module names follow the JAX tree (`stem_conv`, `block_<i>/{expand,
depthwise, project}` with `<name>_bn`, `squeeze_excite/{conv, conv_1}`,
`conv_1`, `conv_1_bn`, `conv_2`). BN layouts, train mode, `remat` and
`dtype` as in `efficientnet_v2`'s docstring. Internally NCHW; the public
input is NHWC gamma-space RGB in [0, 1].
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from metrabs_tpu_torch.models.backbones import common

BN_MOMENTUM = 0.999
BN_EPSILON = 1e-3


def _depth(v: float, divisor: int = 8, min_value: Optional[int] = None) -> int:
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def correct_pad(kernel_size: int, shift: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    pad_total = kernel_size - 1
    pad_beg = pad_total // 2
    pad_end = pad_total - pad_beg
    return ((pad_beg - shift, pad_end + shift), (pad_beg - shift, pad_end + shift))


def _conv(cin: int, cout: int, k: int = 1, stride: int = 1, groups: int = 1,
          bias: bool = False) -> common.Conv2d:
    """VALID conv; callers pad explicitly."""
    return common.Conv2d(cin, cout, k, stride=stride, groups=groups, bias=bias)


class SEBlock(nn.Module):
    def __init__(self, filters: int, se_ratio: float):
        super().__init__()
        self.conv = _conv(filters, _depth(filters * se_ratio), bias=True)
        self.conv_1 = _conv(_depth(filters * se_ratio), filters, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se = torch.mean(x, dim=(2, 3), keepdim=True)
        se = self.conv_1(F.relu(self.conv(se)))
        return x * common.hard_sigmoid(se)


class InvertedResBlock(nn.Module):
    def __init__(self, infilters: int, expansion: float, filters: int, kernel_size: int,
                 stride: int, se_ratio: Optional[float], activation: Callable, block_id: int,
                 bn: common.BnOptions, bottomright_stride: bool = False):
        super().__init__()
        self.kernel_size, self.stride, self.activation = kernel_size, stride, activation
        self.bottomright_stride = bottomright_stride
        self.residual = stride == 1 and infilters == filters
        expanded = infilters
        if block_id:
            expanded = _depth(infilters * expansion)
            self.expand = _conv(infilters, expanded, bias=bn.bn_fold)
            self.expand_bn = bn(expanded)
        self.depthwise = _conv(expanded, expanded, kernel_size, stride, groups=expanded,
                               bias=bn.bn_fold)
        self.depthwise_bn = bn(expanded)
        if se_ratio:
            self.squeeze_excite = SEBlock(expanded, se_ratio)
        self.project = _conv(expanded, filters, bias=bn.bn_fold)
        self.project_bn = bn(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if hasattr(self, 'expand'):
            x = self.activation(self.expand_bn(self.expand(x)))
        if self.stride == 2:
            x = common.pad_nchw(x, correct_pad(self.kernel_size,
                                               1 if self.bottomright_stride else 0))
        else:
            x = common.pad_same(x, self.kernel_size, 1)
        x = self.activation(self.depthwise_bn(self.depthwise(x)))
        if hasattr(self, 'squeeze_excite'):
            x = self.squeeze_excite(x)
        x = self.project_bn(self.project(x))
        return shortcut + x if self.residual else x


# Stack tables: (expansion, filters, kernel, stride, se, act, final_s2), as
# in the JAX module (`mobilenet_v3.py:121-156` there).
def _small_stack(depth, kernel, act, se):
    relu = F.relu
    return [
        (1.0, depth(16), 3, 2, se, relu, False),
        (72.0 / 16, depth(24), 3, 2, None, relu, False),
        (88.0 / 24, depth(24), 3, 1, None, relu, False),
        (4.0, depth(40), kernel, 2, se, act, False),
        (6.0, depth(40), kernel, 1, se, act, False),
        (6.0, depth(40), kernel, 1, se, act, False),
        (3.0, depth(48), kernel, 1, se, act, False),
        (3.0, depth(48), kernel, 1, se, act, False),
        (6.0, depth(96), kernel, 2, se, act, True),
        (6.0, depth(96), kernel, 1, se, act, False),
        (6.0, depth(96), kernel, 1, se, act, False),
    ]


def _large_stack(depth, kernel, act, se):
    relu = F.relu
    return [
        (1.0, depth(16), 3, 1, None, relu, False),
        (4.0, depth(24), 3, 2, None, relu, False),
        (3.0, depth(24), 3, 1, None, relu, False),
        (3.0, depth(40), kernel, 2, se, relu, False),
        (3.0, depth(40), kernel, 1, se, relu, False),
        (3.0, depth(40), kernel, 1, se, relu, False),
        (6.0, depth(80), 3, 2, None, act, False),
        (2.5, depth(80), 3, 1, None, act, False),
        (2.3, depth(80), 3, 1, None, act, False),
        (2.3, depth(80), 3, 1, None, act, False),
        (6.0, depth(112), 3, 1, se, act, False),
        (6.0, depth(112), 3, 1, se, act, False),
        (6.0, depth(160), kernel, 2, se, act, True),
        (6.0, depth(160), kernel, 1, se, act, False),
        (6.0, depth(160), kernel, 1, se, act, False),
    ]


class MobileNetV3(nn.Module):
    """[N, S, S, 3] NHWC gamma-space RGB in [0, 1] -> NCHW features
    [N, 1024 (small) or 1280 (large), S/32, S/32]."""

    def __init__(self, model_type: str = 'small', minimalistic: bool = False, centered_stride: bool = True,
                 ghost_splits: int = 1, remat: bool = False, bn_fold: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if minimalistic:
            kernel, act, se = 3, F.relu, None
        else:
            kernel, act, se = 5, common.hard_swish, 0.25
        bn = common.BnOptions(bn_fold, ghost_splits, eps=BN_EPSILON, momentum=BN_MOMENTUM)
        self.act, self.remat, self.bn_fold, self.dtype = act, remat, bn_fold, dtype
        self.stem_conv = _conv(3, 16, 3, 2, bias=bn_fold)
        self.stem_bn = bn(16)
        stack = (_small_stack if model_type == 'small' else _large_stack)(
            _depth, kernel, act, se)
        channels = 16
        self.n_blocks = len(stack)
        for i, (exp, filters, k, s, se_r, a, final_s2) in enumerate(stack):
            self.add_module(f'block_{i}', InvertedResBlock(
                channels, exp, filters, k, s, se_r, a, i, bn,
                bottomright_stride=final_s2 and centered_stride))
            channels = filters
        last_conv_ch = _depth(channels * 6)
        last_point_ch = 1024 if model_type == 'small' else 1280
        self.conv_1 = _conv(channels, last_conv_ch, bias=bn_fold)
        self.conv_1_bn = bn(last_conv_ch)
        self.conv_2 = _conv(last_conv_ch, last_point_ch, bias=True)
        self.out_channels = last_point_ch

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` is unused (no drop-connect)."""
        if self.bn_fold and self.training:
            raise ValueError('bn_fold is an inference-only layout')
        x = common.mobilenet_preproc(x.to(self.dtype or self.stem_conv.weight.dtype))
        x = common.pad_same(x.permute(0, 3, 1, 2), 3, 2)
        x = self.act(self.stem_bn(self.stem_conv(x)))
        for i in range(self.n_blocks):
            x = common.call_block(getattr(self, f'block_{i}'), x, remat=self.remat)
        x = self.act(self.conv_1_bn(self.conv_1(x)))
        return self.act(self.conv_2(x))
