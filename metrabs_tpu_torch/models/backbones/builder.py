"""Backbone dispatch by name (`metrabs_tpu/models/backbones/builder.py`).

Ported: the EfficientNetV2 family (`efficientnetv2-{s,m,l,xl}` and the
dilated `-stride4|8|16` plans) and the tests' `tiny` backbone. Other
families raise NotImplementedError rather than falling back to a different
network.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
import torch.nn as nn

from metrabs_tpu_torch.models.backbones.efficientnet_v2 import (
    EFFNETV2_PARAMS, EfficientNetV2)
from metrabs_tpu_torch.models.backbones.tiny import TinyBackbone


def build_backbone(name: str, *, centered_stride: bool = True, ghost_splits: int = 1,
                   dtype: Optional[torch.dtype] = None,
                   stride_test: Optional[int] = None, remat: bool = False,
                   bn_fold: bool = False, fuse_mbconv: str = 'off',
                   bn_bf16_stats: bool = False) -> nn.Module:
    """`stride_test`: test-time output stride when it differs from the
    training stride of the name's -strideN suffix (default 32).
    `dtype`: the compute dtype (None: the weights' dtype); `ghost_splits`,
    `remat` and `bn_bf16_stats` shape training (`efficientnet_v2` docstring).
    `bn_fold`: the folded-BN serving layout (`io.weights.fold_bn_variables`).
    `fuse_mbconv`: the fused MBConv inner chain (`efficientnet_v2` docstring);
    a loader takes it through `backbone_builder`, e.g.
    `functools.partial(build_backbone, fuse_mbconv='on')`."""
    name = name.lower().replace('_', '-')
    if name.startswith('tiny'):
        if stride_test is not None:
            raise ValueError(f'stride_test is not supported for {name!r}')
        return TinyBackbone(dtype=dtype)
    if not name.startswith('efficientnetv2'):
        raise NotImplementedError(
            f'Backbone {name!r} is not yet ported to metrabs_tpu_torch; only '
            f'efficientnetv2-* and tiny are')
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
