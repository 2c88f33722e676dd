"""Backbone dispatch by name (`metrabs_tpu/models/backbones/builder.py`), with
the same name grammar and errors:

  efficientnetv2-{s,m,l,xl}[-stride4|8|16]
  resnet{18,34,50,101,152}[v1-5|v2][-groupnorm][-stride4|8|16]
  mobilenetv3-{small,large}[-mini]
  tiny (the JAX package's test backbone)

Each family's input preprocessing is built into its module.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
import torch.nn as nn

from metrabs_tpu_torch.models.backbones.efficientnet_v2 import (
    EFFNETV2_PARAMS, EfficientNetV2)
from metrabs_tpu_torch.models.backbones.mobilenet_v3 import MobileNetV3
from metrabs_tpu_torch.models.backbones.resnet import ResNet
from metrabs_tpu_torch.models.backbones.tiny import TinyBackbone


def backbone_supports_bn_fold(backbone_name: str) -> bool:
    """Families with a conv->BN structure that `io.weights.fold_bn_variables`
    folds (the JAX package's rule; ResNet V2 and GroupNorm variants are
    excluded)."""
    name = backbone_name.lower().replace('_', '-')
    if name.startswith('efficientnetv2') or name.startswith('mobilenetv3'):
        return True
    if name.startswith('resnet'):
        return 'v2' not in name and 'groupnorm' not in name
    return False


def build_backbone(name: str, *, centered_stride: bool = True, ghost_splits: int = 1,
                   dtype: Optional[torch.dtype] = None,
                   stride_test: Optional[int] = None, remat: bool = False,
                   bn_fold: bool = False, fuse_mbconv: str = 'off',
                   bn_bf16_stats: bool = False) -> nn.Module:
    """`stride_test`: test-time output stride when it differs from the
    training stride of the name's -strideN suffix (default 32); ResNet and
    EfficientNetV2 only. `dtype`: the compute dtype (None: the weights'
    dtype); `ghost_splits` and `remat` shape training (`efficientnet_v2`
    docstring). `bn_fold`: the folded-BN serving layout
    (`io.weights.fold_bn_variables`), where `backbone_supports_bn_fold`.
    EfficientNetV2 only: `fuse_mbconv`, the fused MBConv inner chain
    (`efficientnet_v2` docstring; a loader takes it through
    `backbone_builder`, e.g. `functools.partial(build_backbone,
    fuse_mbconv='on')`), and `bn_bf16_stats`; another family raises for
    them rather than running without."""
    name = name.lower().replace('_', '-')
    if bn_fold and not backbone_supports_bn_fold(name):
        raise ValueError(f'bn_fold is not supported for {name!r}')
    if not name.startswith('efficientnetv2') and (fuse_mbconv != 'off' or bn_bf16_stats):
        raise ValueError(f'fuse_mbconv and bn_bf16_stats are EfficientNetV2 options; '
                         f'{name!r} has neither')
    if name.startswith('efficientnetv2'):
        m = re.match(r'(efficientnetv2-[smlx]+)(?:-stride(\d+))?$', name)
        if not m or name not in EFFNETV2_PARAMS:
            raise ValueError(f'Cannot parse EffNetV2 name {name!r}')
        model_name_test = None
        if stride_test is not None:
            base = m.group(1)
            model_name_test = base if stride_test == 32 else f'{base}-stride{stride_test}'
            if model_name_test not in EFFNETV2_PARAMS:
                raise ValueError(
                    f'No -stride{stride_test} variant tables for {base!r}; available: '
                    f'{sorted(k for k in EFFNETV2_PARAMS if "stride" in k)}')
        return EfficientNetV2(model_name=name, model_name_test=model_name_test,
                              centered_stride=centered_stride, bn_fold=bn_fold,
                              fuse_mbconv=fuse_mbconv, ghost_splits=ghost_splits,
                              bn_bf16_stats=bn_bf16_stats, remat=remat, dtype=dtype)
    if name.startswith('resnet'):
        m = re.match(r'resnet(\d+)(v1-5|v2)?(-groupnorm)?(?:-stride(\d+))?$', name)
        if not m:
            raise ValueError(f'Cannot parse ResNet name {name!r}')
        variant = {'v1-5': 'v1_5', 'v2': 'v2', None: ''}[m.group(2)]
        if m.group(3) and variant == 'v2':
            raise ValueError('groupnorm is not supported for ResNet V2')
        return ResNet(depth=int(m.group(1)), variant=variant,
                      output_stride=int(m.group(4)) if m.group(4) else 32,
                      output_stride_test=stride_test, centered_stride=centered_stride,
                      ghost_splits=ghost_splits, use_group_norm=bool(m.group(3)),
                      remat=remat, bn_fold=bn_fold, dtype=dtype)
    if stride_test is not None:
        raise ValueError(f'stride_test is only supported for resnet/efficientnetv2 '
                         f'backbones, got {name!r}')
    if name.startswith('mobilenetv3'):
        m = re.match(r'mobilenetv3-(small|large)(-?mini)?$', name)
        if not m:
            raise ValueError(f'Cannot parse MobileNet name {name!r}')
        return MobileNetV3(model_type=m.group(1), minimalistic=bool(m.group(2)),
                           centered_stride=centered_stride, ghost_splits=ghost_splits,
                           remat=remat, bn_fold=bn_fold, dtype=dtype)
    if name.startswith('tiny'):
        return TinyBackbone(dtype=dtype)
    raise ValueError(f'No backbone builder found for {name!r}')
