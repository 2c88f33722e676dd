"""EfficientNetV2 backbones (S/M/L/XL and the dilated -stride4/8/16 plans)
(`metrabs_tpu/models/backbones/efficientnet_v2.py`).

Same architecture semantics as the JAX module: MBConv / FusedMBConv blocks
with SE (reduction from the block's input filters), silu, BN momentum 0.9
and eps 1e-3, explicit fixed padding before every spatial conv with the
`br` bottom-right shift on the last stride-2 block, drop-connect with
survival 1 - (1 - SURVIVAL_PROB) * i / n_blocks, and the flat `blocks.{i}`
layout (the JAX `blocks_{i}`). Padding is `F.pad` followed by a VALID conv:
PyTorch's symmetric conv padding cannot express the `br` shift.

The module's mode is JAX's `train` flag. Train mode: BatchNorm on batch
statistics (`common.GhostBatchNorm`, with `ghost_splits` and
`bn_bf16_stats`), drop-connect masks drawn from the forward's `generator`
before each block is called, and the training plan `model_name` (eval mode
runs `model_name_test` when given; both share one parameter layout).
`remat` recomputes each block below `remat_until_block` in the backward
pass (`torch.utils.checkpoint`, non-reentrant), with the running statistics
left alone during the recompute. Convolutions compute in `dtype` (None: the
weights' dtype), so float32 master weights train in bfloat16 as flax's
`dtype=bfloat16, param_dtype=float32` does; BN reductions run in float32.

Two BN layouts: folded (`bn_fold=True`, inference only: every conv carries a
bias and no BN module exists; weights from `io.weights.fold_bn_variables`)
and unfolded (BatchNorm after each conv). Internally NCHW; the public input
is NHWC gamma-space RGB in [0, 1].

`fuse_mbconv` ('off' | 'auto' | 'on' | 'interpret', default 'off' as in JAX)
runs, in eval mode only as in JAX, the inner chain of the qualifying MBConv
blocks (unfolded BN, expand !=
1, 3x3, stride 1, no dilation, no `br` shift) as one fused operation, the
port of TPU kernel K2: 'on' calls `ops.mbconv_cuda.fused_mbconv_inner` (the
CUDA kernel on a CUDA tensor, its plain version on a CPU tensor), 'auto'
does so only on a CUDA tensor, 'interpret' calls the plain version
`ops.mbconv.fused_mbconv_inner` on any device. With the depthwise weight
sharded over a mesh's 'model' axis the chain runs on this rank's channel
slice and its v and SE mean are all-gathered (every step of the chain is
per channel). The parameters are the same either way; with `bn_fold=True` every block takes the unfused branch, as in
JAX (there is no folded-BN fused variant). A fused block computes the
chain's float32 constants (depthwise taps and both BNs' scale and bias) once
in eval mode and keeps them as non-persistent buffers, so its forward
launches only the expand conv, the fused chain, the SE convs and the project
conv; `train()` and `eval()` drop them, to be made again from the weights.
The fused chain has no backward: an eval-mode forward that autograd would
differentiate through it raises.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from metrabs_tpu_torch.models.backbones import common
from metrabs_tpu_torch.ops import mbconv as mbconv_ops
from metrabs_tpu_torch.ops import mbconv_cuda

BN_MOMENTUM = 0.9
BN_EPSILON = 1e-3
SURVIVAL_PROB = 0.8
FUSE_MODES = ('off', 'auto', 'on', 'interpret')


@dataclasses.dataclass(frozen=True)
class BlockArgs:
    num_repeat: int
    kernel_size: int
    strides: int
    dilation_in: int
    dilation_out: int
    expand_ratio: int
    input_filters: int
    output_filters: int
    se_ratio: Optional[float]
    conv_type: int  # 0 = MBConv, 1 = Fused
    bottomright_stride: bool


def decode_block_string(s: str) -> BlockArgs:
    """Decodes 'r2_k3_s1_din1_dout1_e4_i24_o48_c1[_se0.25][_br]' strings."""
    opts = {}
    flags = set()
    for p in s.split('_'):
        m = re.match(r'([a-z]+)([\d.]+)$', p)
        if m:
            opts[m.group(1)] = m.group(2)
        else:
            flags.add(p)
    return BlockArgs(
        num_repeat=int(opts['r']),
        kernel_size=int(opts['k']),
        strides=int(opts['s']),
        dilation_in=int(opts.get('din', 1)),
        dilation_out=int(opts.get('dout', 1)),
        expand_ratio=int(opts['e']),
        input_filters=int(opts['i']),
        output_filters=int(opts['o']),
        se_ratio=float(opts['se']) if 'se' in opts else None,
        conv_type=int(opts.get('c', 0)),
        bottomright_stride='br' in flags)


# Stage tables of the reference (`effnetv2_configs.py:155-247`), as in the
# JAX module (which cannot be imported here: it imports flax).
_V2_S = ['r2_k3_s1_din1_dout1_e1_i24_o24_c1',
         'r4_k3_s2_din1_dout1_e4_i24_o48_c1',
         'r4_k3_s2_din1_dout1_e4_i48_o64_c1',
         'r6_k3_s2_din1_dout1_e4_i64_o128_se0.25',
         'r9_k3_s1_din1_dout1_e6_i128_o160_se0.25',
         'r15_k3_s2_din1_dout1_e6_i160_o256_se0.25_br']
_V2_S_STRIDE16 = ['r2_k3_s1_din1_dout1_e1_i24_o24_c1',
                  'r4_k3_s2_din1_dout1_e4_i24_o48_c1',
                  'r4_k3_s2_din1_dout1_e4_i48_o64_c1',
                  'r6_k3_s2_din1_dout1_e4_i64_o128_se0.25_br',
                  'r9_k3_s1_din1_dout1_e6_i128_o160_se0.25',
                  'r15_k3_s1_din1_dout2_e6_i160_o256_se0.25']
_V2_S_STRIDE8 = ['r2_k3_s1_din1_dout1_e1_i24_o24_c1',
                 'r4_k3_s2_din1_dout1_e4_i24_o48_c1',
                 'r4_k3_s2_din1_dout1_e4_i48_o64_c1_br',
                 'r6_k3_s1_din1_dout2_e4_i64_o128_se0.25',
                 'r9_k3_s1_din2_dout2_e6_i128_o160_se0.25',
                 'r15_k3_s1_din2_dout4_e6_i160_o256_se0.25']
_V2_S_STRIDE4 = ['r2_k3_s1_din1_dout1_e1_i24_o24_c1',
                 'r4_k3_s2_din1_dout1_e4_i24_o48_c1_br',
                 'r4_k3_s1_din1_dout2_e4_i48_o64_c1',
                 'r6_k3_s1_din2_dout4_e4_i64_o128_se0.25',
                 'r9_k3_s1_din4_dout4_e6_i128_o160_se0.25',
                 'r15_k3_s1_din4_dout8_e6_i160_o256_se0.25']
_V2_M = ['r3_k3_s1_din1_dout1_e1_i24_o24_c1',
         'r5_k3_s2_din1_dout1_e4_i24_o48_c1',
         'r5_k3_s2_din1_dout1_e4_i48_o80_c1',
         'r7_k3_s2_din1_dout1_e4_i80_o160_se0.25',
         'r14_k3_s1_din1_dout1_e6_i160_o176_se0.25',
         'r18_k3_s2_din1_dout1_e6_i176_o304_se0.25_br',
         'r5_k3_s1_din1_dout1_e6_i304_o512_se0.25']
_V2_L = ['r4_k3_s1_din1_dout1_e1_i32_o32_c1',
         'r7_k3_s2_din1_dout1_e4_i32_o64_c1',
         'r7_k3_s2_din1_dout1_e4_i64_o96_c1',
         'r10_k3_s2_din1_dout1_e4_i96_o192_se0.25',
         'r19_k3_s1_din1_dout1_e6_i192_o224_se0.25',
         'r25_k3_s2_din1_dout1_e6_i224_o384_se0.25_br',
         'r7_k3_s1_din1_dout1_e6_i384_o640_se0.25']
_V2_L_STRIDE16 = ['r4_k3_s1_din1_dout1_e1_i32_o32_c1',
                  'r7_k3_s2_din1_dout1_e4_i32_o64_c1',
                  'r7_k3_s2_din1_dout1_e4_i64_o96_c1',
                  'r10_k3_s2_din1_dout1_e4_i96_o192_se0.25_br',
                  'r19_k3_s1_din1_dout1_e6_i192_o224_se0.25',
                  'r25_k3_s1_din1_dout2_e6_i224_o384_se0.25',
                  'r7_k3_s1_din2_dout2_e6_i384_o640_se0.25']
_V2_L_STRIDE8 = ['r4_k3_s1_din1_dout1_e1_i32_o32_c1',
                 'r7_k3_s2_din1_dout1_e4_i32_o64_c1',
                 'r7_k3_s2_din1_dout1_e4_i64_o96_c1_br',
                 'r10_k3_s1_din1_dout2_e4_i96_o192_se0.25',
                 'r19_k3_s1_din2_dout2_e6_i192_o224_se0.25',
                 'r25_k3_s1_din2_dout4_e6_i224_o384_se0.25',
                 'r7_k3_s1_din4_dout4_e6_i384_o640_se0.25']
_V2_L_STRIDE4 = ['r4_k3_s1_din1_dout1_e1_i32_o32_c1',
                 'r7_k3_s2_din1_dout1_e4_i32_o64_c1_br',
                 'r7_k3_s1_din1_dout2_e4_i64_o96_c1',
                 'r10_k3_s1_din2_dout4_e4_i96_o192_se0.25',
                 'r19_k3_s1_din4_dout4_e6_i192_o224_se0.25',
                 'r25_k3_s1_din4_dout8_e6_i224_o384_se0.25',
                 'r7_k3_s1_din8_dout8_e6_i384_o640_se0.25']
_V2_XL = ['r4_k3_s1_din1_dout1_e1_i32_o32_c1',
          'r8_k3_s2_din1_dout1_e4_i32_o64_c1',
          'r8_k3_s2_din1_dout1_e4_i64_o96_c1',
          'r16_k3_s2_din1_dout1_e4_i96_o192_se0.25',
          'r24_k3_s1_din1_dout1_e6_i192_o256_se0.25',
          'r32_k3_s2_din1_dout1_e6_i256_o512_se0.25_br',
          'r8_k3_s1_din1_dout1_e6_i512_o640_se0.25']

# name -> (stage strings, width_coefficient, depth_coefficient)
EFFNETV2_PARAMS = {
    'efficientnetv2-s': (_V2_S, 1.0, 1.0),
    'efficientnetv2-s-stride4': (_V2_S_STRIDE4, 1.0, 1.0),
    'efficientnetv2-s-stride8': (_V2_S_STRIDE8, 1.0, 1.0),
    'efficientnetv2-s-stride16': (_V2_S_STRIDE16, 1.0, 1.0),
    'efficientnetv2-m': (_V2_M, 1.0, 1.0),
    'efficientnetv2-l': (_V2_L, 1.0, 1.0),
    'efficientnetv2-l-stride4': (_V2_L_STRIDE4, 1.0, 1.0),
    'efficientnetv2-l-stride8': (_V2_L_STRIDE8, 1.0, 1.0),
    'efficientnetv2-l-stride16': (_V2_L_STRIDE16, 1.0, 1.0),
    'efficientnetv2-xl': (_V2_XL, 1.0, 1.0),
}


def round_filters(filters: float, width_coefficient: float,
                  divisor: int = 8, min_depth: int = 8) -> int:
    if not width_coefficient:
        return int(filters)
    filters *= width_coefficient
    return int(max(min_depth, int(filters + divisor / 2) // divisor * divisor))


def round_repeats(repeats: int, depth_coefficient: float) -> int:
    return int(math.ceil(depth_coefficient * repeats))


def expand_blocks(model_name: str) -> List[BlockArgs]:
    """One BlockArgs per layer; the first block of a stage carries its stride."""
    stage_strings, width, depth = EFFNETV2_PARAMS[model_name]
    blocks = []
    for s in stage_strings:
        args = decode_block_string(s)
        in_f = round_filters(args.input_filters, width)
        out_f = round_filters(args.output_filters, width)
        repeats = round_repeats(args.num_repeat, depth)
        first = dataclasses.replace(args, input_filters=in_f, output_filters=out_f,
                                    num_repeat=1)
        blocks.append(first)
        rest = dataclasses.replace(first, input_filters=out_f, strides=1,
                                   bottomright_stride=False,
                                   dilation_in=args.dilation_out)
        blocks.extend([rest] * (repeats - 1))
    return blocks


def _conv(cin: int, cout: int, k: int = 1, stride: int = 1, dilation: int = 1,
          groups: int = 1, bias: bool = False) -> common.Conv2d:
    """VALID conv; callers pad explicitly."""
    return common.Conv2d(cin, cout, k, stride=stride, padding=0, dilation=dilation,
                         groups=groups, bias=bias)


def _pads(a: BlockArgs):
    return common.fixed_padding_amounts(a.kernel_size, a.dilation_in,
                                        1 if a.bottomright_stride else 0)


# (bn_fold, ghost_splits, bf16_stats) -> the family's BatchNorm factory.
_BnOptions = functools.partial(common.BnOptions, eps=BN_EPSILON, momentum=BN_MOMENTUM)


class SqueezeExcite(nn.Module):
    def __init__(self, filters: int, se_filters: int):
        super().__init__()
        self.reduce = _conv(filters, se_filters, bias=True)
        self.expand = _conv(se_filters, filters, bias=True)

    def forward(self, x: torch.Tensor,
                precomputed_mean: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`precomputed_mean` [N, C, 1, 1]: the spatial mean, already reduced
        by the fused MBConv kernel."""
        if precomputed_mean is None:
            se = torch.mean(x, dim=(2, 3), keepdim=True)
        else:
            se = precomputed_mean.to(x.dtype)
        se = self.expand(F.silu(self.reduce(se)))
        return torch.sigmoid(se) * x


class _Block(nn.Module):
    """A block with a training plan `a_train` and a test plan `a_test` of
    the same weights (they differ in stride, dilation and `br` only); the
    module's mode picks one."""

    def __init__(self, a_train: BlockArgs, a_test: BlockArgs):
        super().__init__()
        self.a_train, self.a_test = a_train, a_test

    @property
    def a(self) -> BlockArgs:
        return self.a_train if self.training else self.a_test

    def has_residual(self) -> bool:
        a = self.a
        return a.strides == 1 and a.input_filters == a.output_filters

    def _residual(self, inputs, x, keep, survival_prob):
        if self.has_residual():
            return common.stochastic_depth(inputs, x, survival_prob, keep)
        return x


class MBConv(_Block):
    """expand 1x1 -> depthwise kxk -> SE -> project 1x1; with `fuse` the
    inner chain of a qualifying block is one fused operation in eval mode
    (module docstring)."""

    def __init__(self, a_train: BlockArgs, a_test: BlockArgs, bn: common.BnOptions,
                 fuse: str = 'off'):
        super().__init__(a_train, a_test)
        if fuse not in FUSE_MODES:
            raise ValueError(f'fuse_mbconv must be one of {FUSE_MODES}, got {fuse!r}')
        a = a_test
        self.fuse = fuse
        self.fusable = (not bn.bn_fold and a.expand_ratio != 1 and a.kernel_size == 3
                        and a.strides == 1 and a.dilation_in == 1
                        and not a.bottomright_stride)
        filters = a.input_filters * a.expand_ratio
        if a.expand_ratio != 1:
            self.expand_conv = _conv(a.input_filters, filters, bias=bn.bn_fold)
            self.norm0 = bn(filters)
        self.depthwise_conv = _conv(filters, filters, a.kernel_size, a.strides,
                                    a.dilation_in, groups=filters, bias=bn.bn_fold)
        self.norm1 = bn(filters)
        if a.se_ratio:
            self.se = SqueezeExcite(filters, max(1, int(a.input_filters * a.se_ratio)))
        self.project_conv = _conv(filters, a.output_filters, bias=bn.bn_fold)
        self.norm2 = bn(a.output_filters)
        if self.fusable:
            # The fused chain's constants (`ops.mbconv.inner_constants`): made
            # from the weights at the first fused call in eval mode and kept
            # until `train()`, `eval()` or `load_state_dict` drops them (an
            # in-place edit of the weights needs one of those); not part of
            # the state dict.
            self.register_buffer('inner_taps', None, persistent=False)
            self.register_buffer('inner_sb', None, persistent=False)
            self.register_load_state_dict_post_hook(
                lambda module, incompatible_keys: module._drop_inner_constants())

    def _drop_inner_constants(self):
        self.inner_taps = self.inner_sb = None

    def train(self, mode: bool = True):
        """Also drops the fused chain's kept constants (`eval()` too), so that
        they are made again from the weights of the moment."""
        if self.fusable:
            self._drop_inner_constants()
        return super().train(mode)

    def _inner_constants(self):
        """(taps [E, 9], sb [4, E]) float32, kept. Made again if a cast of the
        module (`.to(dtype)`) has cast the kept ones. With the depthwise
        weight sharded over 'model', those of this rank's channel slice."""
        if self.inner_taps is None or self.inner_taps.dtype != torch.float32:
            with torch.no_grad():
                folded = self.norm0.folded() + self.norm1.folded()
                tp = self.depthwise_conv.tp
                if tp is not None:
                    folded = tuple(t[tp.local_slice(t.shape[0])] for t in folded)
                self.inner_taps, self.inner_sb = mbconv_ops.inner_constants(
                    self.depthwise_conv.weight, *folded)
        return self.inner_taps, self.inner_sb

    def _use_fused(self, x: torch.Tensor) -> bool:
        return (not self.training and self.fusable
                and (self.fuse in ('on', 'interpret') or (self.fuse == 'auto' and x.is_cuda)))

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                survival_prob: float = 1.0) -> torch.Tensor:
        a = self.a
        inputs = x
        if self._use_fused(x):
            u = self.expand_conv(x)
            if torch.is_grad_enabled() and u.requires_grad:
                raise RuntimeError(
                    'The fused MBConv chain has no backward: in eval mode with '
                    "gradients (finetune_in_inference_mode), build the backbone with "
                    "fuse_mbconv='off'")
            inner = (mbconv_ops.fused_mbconv_inner if self.fuse == 'interpret'
                     else mbconv_cuda.fused_mbconv_inner)
            tp = self.depthwise_conv.tp
            if tp is not None:  # the chain is per channel: K2 on this rank's slice
                u = u[:, tp.local_slice(u.shape[1])]
            x, se_mean = inner(u.contiguous(), *self._inner_constants())
            if tp is not None:
                x, se_mean = tp.gather(x, 1), tp.gather(se_mean, 1)
            if a.se_ratio:
                x = self.se(x, se_mean[:, :, None, None])
        else:
            if a.expand_ratio != 1:
                x = F.silu(self.norm0(self.expand_conv(x)))
            x = self.depthwise_conv(common.pad_nchw(x, _pads(a)), a.strides, a.dilation_in)
            x = F.silu(self.norm1(x))
            if a.se_ratio:
                x = self.se(x)
        x = self.norm2(self.project_conv(x))
        return self._residual(inputs, x, keep, survival_prob)


class FusedMBConv(_Block):
    """Fused expand kxk (or a single kxk conv when expand_ratio == 1) -> SE ->
    project 1x1."""

    def __init__(self, a_train: BlockArgs, a_test: BlockArgs, bn: common.BnOptions):
        super().__init__(a_train, a_test)
        a = a_test
        filters = a.input_filters * a.expand_ratio
        if a.expand_ratio != 1:
            self.expand_conv = _conv(a.input_filters, filters, a.kernel_size,
                                     a.strides, a.dilation_in, bias=bn.bn_fold)
            self.norm0 = bn(filters)
            self.project_conv = _conv(filters, a.output_filters, bias=bn.bn_fold)
        else:
            self.project_conv = _conv(filters, a.output_filters, a.kernel_size,
                                      a.strides, a.dilation_in, bias=bn.bn_fold)
        if a.se_ratio:
            self.se = SqueezeExcite(filters, max(1, int(a.input_filters * a.se_ratio)))
        self.norm1 = bn(a.output_filters)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                survival_prob: float = 1.0) -> torch.Tensor:
        a = self.a
        inputs = x
        if a.expand_ratio != 1:
            x = self.expand_conv(common.pad_nchw(x, _pads(a)), a.strides, a.dilation_in)
            x = F.silu(self.norm0(x))
        if a.se_ratio:
            x = self.se(x)
        if a.expand_ratio == 1:
            x = self.project_conv(common.pad_nchw(x, _pads(a)), a.strides, a.dilation_in)
        else:
            x = self.project_conv(x)
        x = self.norm1(x)
        if a.expand_ratio == 1:
            x = F.silu(x)
        return self._residual(inputs, x, keep, survival_prob)


class EfficientNetV2(nn.Module):
    """[N, S, S, 3] NHWC gamma-space RGB in [0, 1] -> NCHW features
    [N, 1280, S/32, S/32] (or finer for the -strideN plans).

    `model_name_test`: the test-time plan (a dilated -strideN variant of the
    same family); all plans of a family share one parameter layout. Other
    arguments: module docstring."""

    def __init__(self, model_name: str = 'efficientnetv2-s',
                 model_name_test: Optional[str] = None,
                 centered_stride: bool = True, feature_size: int = 1280,
                 bn_fold: bool = False, fuse_mbconv: str = 'off', ghost_splits: int = 1,
                 bn_bf16_stats: bool = False, remat: bool = False,
                 remat_until_block: int = 10_000, dtype: Optional[torch.dtype] = None):
        super().__init__()
        plans = [expand_blocks(name) for name in (model_name, model_name_test or model_name)]
        if not centered_stride:
            plans = [[dataclasses.replace(b, bottomright_stride=False) for b in blocks]
                     for blocks in plans]
        blocks_train, blocks = plans
        bn = _BnOptions(bn_fold, ghost_splits, bn_bf16_stats)
        self.bn_fold = bn_fold
        self.remat, self.remat_until_block = remat, remat_until_block
        self.dtype = dtype
        self.out_channels = feature_size
        self.stem_pads = common.fixed_padding_amounts(3)
        self.stem_conv = _conv(3, blocks[0].input_filters, 3, 2, bias=bn_fold)
        self.stem_bn = bn(blocks[0].input_filters)
        self.blocks = nn.ModuleList([
            FusedMBConv(a_train, a, bn) if a.conv_type == 1
            else MBConv(a_train, a, bn, fuse_mbconv)
            for a_train, a in zip(blocks_train, blocks)])
        self.head_conv = _conv(blocks[-1].output_filters, feature_size, bias=bn_fold)
        self.head_bn = bn(feature_size)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` draws the drop-connect masks in train mode (None: the
        default generator)."""
        if self.bn_fold and self.training:
            raise ValueError('bn_fold is an inference-only layout')
        dtype = self.dtype or self.stem_conv.weight.dtype
        x = common.tf_preproc(x.to(dtype)).permute(0, 3, 1, 2)
        h = self.stem_conv(common.pad_nchw(x, self.stem_pads))
        h = F.silu(self.stem_bn(h))
        n_blocks = len(self.blocks)
        drop_rate = 1.0 - SURVIVAL_PROB
        for i, block in enumerate(self.blocks):
            survival = 1.0 - drop_rate * float(i) / n_blocks
            keep = None
            if self.training and block.has_residual():
                # Drawn here, outside a checkpointed call: a recompute does
                # not rewind the generator.
                keep = common.drop_mask(h.shape[0], survival, generator, h.device)
            h = common.call_block(block, h, keep, survival,
                                  remat=self.remat and i < self.remat_until_block)
        return F.silu(self.head_bn(self.head_conv(h)))
