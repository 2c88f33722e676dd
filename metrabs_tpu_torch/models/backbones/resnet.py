"""ResNet backbones: depths 18/34/50/101/152, V1 / V1.5 / V2, GroupNorm for
V1/V1.5, dilated -strideN plans and a test-time stride
(`metrabs_tpu/models/backbones/resnet.py`).

Same architecture as the JAX module. Every strided or dilated conv is
"dense SAME, then subsample" (`DenseSameConv`: explicit symmetric fixed
padding and a VALID conv; with the bottom-right shift on the last strided
stage a 1x1 kernel crops its first row and column instead). Output strides
4/8/16 turn late strides into dilations (`get_strides_and_dilations`). V1
strides the first block of conv3-5 on its 1x1, V1.5 on its 3x3, V2
(pre-activation) the last block of conv2-4. BN eps 1e-5, momentum 0.997;
GroupNorm (32 groups) drops the convs' bias. Preprocessing by variant:
caffe for V1 and the basic-block depths 18/34, torch for V1.5, tf for V2.

The stride plan is chosen by the module's mode: train mode runs
`output_stride`, eval mode `output_stride_test` where given; both share one
parameter layout. The stem's max pool pads with zeros (not -inf), (0, 2) in
eval mode at test stride 4 and (1, 1) otherwise; the first block of a
basic-block stage takes the test-dilation correction dil * stride_train /
stride_test on its conv2. Module names follow the JAX tree (`stem_conv`,
`stem_bn`, `stage<s>_block<b>/{conv<k>, bn<k>}`, `preact_bn`, `post_bn`;
`DenseSameConv` wraps its conv as `conv`). BN layouts, train mode, `remat`
and `dtype` as in `efficientnet_v2`'s docstring. Internally NCHW; the
public input is NHWC gamma-space RGB in [0, 1].
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from metrabs_tpu_torch.models.backbones import common

BN_MOMENTUM = 0.997
BN_EPSILON = 1e-5
BLOCK_COUNTS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
                152: [3, 8, 36, 3]}
STAGE_FILTERS = (64, 128, 256, 512)


def get_strides_and_dilations(output_stride: int, centered_stride: bool):
    """Stride/dilation plan of the three strided stages."""
    brs = [False, False, False]
    i_last_strided = int(np.round(np.log2(output_stride))) - 3
    if centered_stride and i_last_strided >= 0:
        brs[i_last_strided] = True
    dil_in = [1, 1, 1]
    dil_out = [1, 1, 1]
    strides = [2, 2, 2]
    i_first_nonstrided = i_last_strided + 1
    for i in range(max(0, i_first_nonstrided), 3):
        strides[i] = 1
        dil_in[i] = 2 ** (i - i_first_nonstrided)
        dil_out[i] = dil_in[i] * 2
    return strides, dil_in, dil_out, brs


class DenseSameConv(nn.Module):
    """Center-aligned strided conv: explicit fixed padding and a VALID conv.
    Stride, dilation and the bottom-right shift come with the call (the
    train and test plans differ in them)."""

    def __init__(self, cin: int, cout: int, kernel: int, bias: bool):
        super().__init__()
        self.kernel = kernel
        self.conv = common.Conv2d(cin, cout, kernel, bias=bias)

    def forward(self, x: torch.Tensor, stride: int = 1, dilation: int = 1,
                bottomright: bool = False) -> torch.Tensor:
        shift = 1 if (bottomright and stride > 1) else 0
        (pt, pb), (pl, pr) = common.fixed_padding_amounts(self.kernel, dilation, shift)
        if pt < 0 or pl < 0:
            x = x[:, :, max(-pt, 0):, max(-pl, 0):]
            pt, pl = max(pt, 0), max(pl, 0)
        if pt or pb or pl or pr:
            x = F.pad(x, (pl, pr, pt, pb))
        return self.conv(x, stride, dilation)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One block's stride, dilation, conv2 dilation (basic blocks) and
    bottom-right shift in one of the two plans."""
    stride: int = 1
    dilation: int = 1
    dilation2: int = 1
    bottomright: bool = False


def _norm_factory(use_group_norm: bool, bn_fold: bool, ghost_splits: int):
    if use_group_norm:
        return lambda c: common.GroupNormCompat(c, BN_EPSILON)
    return common.BnOptions(bn_fold, ghost_splits, eps=BN_EPSILON, momentum=BN_MOMENTUM)


class BottleneckBlock(nn.Module):
    """V1/V1.5 bottleneck; its convs carry a bias unless GroupNorm follows."""

    def __init__(self, cin: int, filters: int, conv_shortcut: bool, v1_5: bool, norm,
                 bias: bool):
        super().__init__()
        self.v1_5 = v1_5
        if conv_shortcut:
            self.conv0 = DenseSameConv(cin, 4 * filters, 1, bias)
            self.bn0 = norm(4 * filters)
        self.conv1 = (common.Conv2d(cin, filters, 1, bias=bias) if v1_5
                      else DenseSameConv(cin, filters, 1, bias))
        self.bn1 = norm(filters)
        self.conv2 = DenseSameConv(filters, filters, 3, bias)
        self.bn2 = norm(filters)
        self.conv3 = common.Conv2d(filters, 4 * filters, 1, bias=bias)
        self.bn3 = norm(4 * filters)

    def forward(self, x: torch.Tensor, p: Plan) -> torch.Tensor:
        shortcut = x
        if hasattr(self, 'conv0'):
            shortcut = self.bn0(self.conv0(x, p.stride, bottomright=p.bottomright))
        if self.v1_5:
            h = F.relu(self.bn1(self.conv1(x)))
            h = self.conv2(h, p.stride, p.dilation, p.bottomright)
        else:
            h = F.relu(self.bn1(self.conv1(x, p.stride, bottomright=p.bottomright)))
            h = self.conv2(h, 1, p.dilation)
        h = F.relu(self.bn2(h))
        h = self.bn3(self.conv3(h))
        return F.relu(shortcut + h)


class BasicBlock(nn.Module):
    """ResNet-18/34 basic block; its convs carry a bias only when BN is
    folded."""

    def __init__(self, cin: int, filters: int, conv_shortcut: bool, norm, bn_fold: bool):
        super().__init__()
        if conv_shortcut:
            self.conv0 = DenseSameConv(cin, filters, 1, bn_fold)
            self.bn0 = norm(filters)
        self.conv1 = DenseSameConv(cin, filters, 3, bn_fold)
        self.bn1 = norm(filters)
        self.conv2 = DenseSameConv(filters, filters, 3, bn_fold)
        self.bn2 = norm(filters)

    def forward(self, x: torch.Tensor, p: Plan) -> torch.Tensor:
        shortcut = x
        if hasattr(self, 'conv0'):
            shortcut = self.bn0(self.conv0(x, p.stride, bottomright=p.bottomright))
        h = F.relu(self.bn1(self.conv1(x, p.stride, p.dilation, p.bottomright)))
        h = self.bn2(self.conv2(h, 1, p.dilation2))
        return F.relu(shortcut + h)


class PreactBlock(nn.Module):
    """V2 pre-activation bottleneck (BatchNorm only, never folded)."""

    def __init__(self, cin: int, filters: int, conv_shortcut: bool, norm):
        super().__init__()
        self.preact_bn = norm(cin)
        if conv_shortcut:
            self.conv0 = DenseSameConv(cin, 4 * filters, 1, True)
        self.conv1 = common.Conv2d(cin, filters, 1, bias=False)
        self.bn1 = norm(filters)
        self.conv2 = DenseSameConv(filters, filters, 3, False)
        self.bn2 = norm(filters)
        self.conv3 = common.Conv2d(filters, 4 * filters, 1, bias=True)

    def forward(self, x: torch.Tensor, p: Plan) -> torch.Tensor:
        preact = F.relu(self.preact_bn(x))
        if hasattr(self, 'conv0'):
            shortcut = self.conv0(preact, p.stride, bottomright=p.bottomright)
        else:
            shortcut = x
            if p.stride > 1:
                if p.bottomright:
                    shortcut = shortcut[:, :, 1:, 1:]
                shortcut = shortcut[:, :, ::p.stride, ::p.stride]
        h = F.relu(self.bn1(self.conv1(preact)))
        h = F.relu(self.bn2(self.conv2(h, p.stride, p.dilation, p.bottomright)))
        return shortcut + self.conv3(h)


def block_plans(depth: int, variant: str, output_stride: int, train_stride: int,
                centered_stride: bool) -> List[Plan]:
    """Every block's plan, stage by stage, at `output_stride`;
    `train_stride` is the training plan's (the basic block's conv2
    correction)."""
    basic = depth in (18, 34)
    strides, dil_in, dil_out, brs = get_strides_and_dilations(output_stride, centered_stride)
    strides_train = get_strides_and_dilations(train_stride, centered_stride)[0]
    plans = []
    for si, n_blocks in enumerate(BLOCK_COUNTS[depth]):
        for b in range(n_blocks):
            first, last = b == 0, b == n_blocks - 1
            if variant == 'v2' and not basic:
                if si < 3:
                    plans.append(Plan(strides[si] if last else 1, dil_in[si],
                                      bottomright=brs[si] if last else False))
                else:
                    plans.append(Plan(1, dil_out[-1]))
            elif si == 0:
                plans.append(Plan(1, dil_in[0], dil_in[0]))
            else:
                stride = strides[si - 1] if first else 1
                dil = dil_out[si - 1]
                if basic:
                    dil2 = int(dil * strides_train[si - 1] / strides[si - 1]) if first else dil
                    plans.append(Plan(stride, dil, dil2, brs[si - 1] if first else False))
                else:
                    if first and variant == 'v1_5':
                        dil = dil_in[si - 1]
                    plans.append(Plan(stride, dil, bottomright=brs[si - 1] if first else False))
    return plans


class ResNet(nn.Module):
    """[N, S, S, 3] NHWC gamma-space RGB in [0, 1] -> NCHW features [N, 512
    (depths 18/34) or 2048, S/os, S/os]. `variant`: '' (V1), 'v1_5' or
    'v2'; depths 18/34 are always the basic-block architecture."""

    def __init__(self, depth: int = 50, variant: str = '', output_stride: int = 32,
                 output_stride_test: Optional[int] = None, centered_stride: bool = True,
                 ghost_splits: int = 1, use_group_norm: bool = False, remat: bool = False,
                 bn_fold: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        basic = depth in (18, 34)
        self.v2 = variant == 'v2' and not basic
        self.v1_5 = variant == 'v1_5' and not basic
        if bn_fold and (self.v2 or use_group_norm):
            raise ValueError('bn_fold is inference-only and supports V1/V1.5/basic '
                             'BatchNorm ResNets only')
        self.bn_fold, self.remat, self.dtype = bn_fold, remat, dtype
        self.stride_test = output_stride_test or output_stride
        self.plans = {mode: block_plans(depth, variant, stride, output_stride, centered_stride)
                      for mode, stride in ((True, output_stride), (False, self.stride_test))}
        norm = _norm_factory(use_group_norm, bn_fold, ghost_splits)
        self.stem_conv = common.Conv2d(
            3, 64, 7, stride=2, bias=(not basic and not use_group_norm) or bn_fold)
        if not self.v2:
            self.stem_bn = norm(64)
        self.block_names = []
        cin = 64
        for si, (filters, n_blocks) in enumerate(zip(STAGE_FILTERS, BLOCK_COUNTS[depth])):
            for b in range(n_blocks):
                first = b == 0
                if basic:
                    block = BasicBlock(cin, filters, first and si > 0, norm, bn_fold)
                    cin = filters
                elif self.v2:
                    block = PreactBlock(cin, filters, first, norm)
                    cin = 4 * filters
                else:
                    block = BottleneckBlock(cin, filters, first, self.v1_5, norm,
                                            bias=not use_group_norm)
                    cin = 4 * filters
                self.block_names.append(f'stage{si}_block{b}')
                self.add_module(self.block_names[-1], block)
        if self.v2:
            self.post_bn = norm(cin)
        self.out_channels = cin

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` is unused (no drop-connect)."""
        if self.bn_fold and self.training:
            raise ValueError('bn_fold is an inference-only layout')
        x = x.to(self.dtype or self.stem_conv.weight.dtype)
        if self.v2:
            x = common.tf_preproc(x)
        elif self.v1_5:
            x = common.torch_preproc(x)
        else:
            x = common.caffe_preproc(x)
        h = self.stem_conv(F.pad(x.permute(0, 3, 1, 2), (3, 3, 3, 3)))
        if not self.v2:
            h = F.relu(self.stem_bn(h))
        if not self.training and self.stride_test == 4:
            h = F.pad(h, (0, 2, 0, 2))
        else:
            h = F.pad(h, (1, 1, 1, 1))
        h = F.max_pool2d(h, 3, stride=2)
        for name, plan in zip(self.block_names, self.plans[self.training]):
            h = common.call_block(getattr(self, name), h, plan, remat=self.remat)
        if self.v2:
            h = F.relu(self.post_bn(h))
        return h
