"""The model-FLOP count of the port's crop models (the counterpart of
`bench.py:124-155` and `scripts/mfu_experiments.py:174-205`, which take
XLA's cost analysis of the JAX forward).

`forward_flops(model, inputs)` counts 2 x the multiply-adds of every
convolution and matrix product in one eval forward, with
`torch.utils.flop_counter.FlopCounterMode`. On the `meta` device nothing is
computed, so the full-width models count in seconds on a CPU. MFU and
TFLOP/s follow as crops/s x forward FLOPs per crop (x 3 for a train step:
the forward and twice the forward for the backward).

XLA's `cost_analysis()['flops']` also counts every elementwise instruction,
reduction and pooling window, so it reads above this count (`main` prints
the ratio; 1.007-1.053 at the published sizes): the BatchNorms, activations,
residual adds, SE scaling and pooling that the model-FLOP definition leaves
out.

    python scripts/_flops_torch.py [--models efficientnetv2-l@384 ...]
        [--device cuda]

prints GFLOP per crop of each model beside the JAX package's XLA count, and
checks on `--device` that a real forward at batch 1 counts the same.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_MODELS = ('efficientnetv2-l@384', 'resnet152@384', 'mobilenetv3-large@256')
# XLA's counts of the JAX package's forward, GFLOP per crop (BENCH_r05.json's
# `gflops_per_crop`): counts of the model, not TPU times.
XLA_GFLOP_PER_CROP = {'efficientnetv2-l@384': 72.83, 'resnet152@384': 66.88,
                      'mobilenetv3-large@256': 0.78}


def forward_flops(model: torch.nn.Module, inputs) -> int:
    """2 x multiply-adds of the convolutions and matrix products of one
    `model(*inputs)` without gradients."""
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(*inputs)
    return counter.get_total_flops()


def crop_model_and_inputs(backbone: str, proc_side: int, batch: int = 1, device='meta',
                          dtype: str = 'bfloat16'):
    """(the eval-mode Metrabs crop model of `backbone` at `proc_side`, BN
    folded where the family folds, as served; (crops, intrinsics)) on
    `device`, uninitialised."""
    from metrabs_tpu_torch.config import ModelConfig
    from metrabs_tpu_torch.models.backbones.builder import backbone_supports_bn_fold
    from metrabs_tpu_torch.models.metrabs import build_crop_model

    cfg = ModelConfig(proc_side=proc_side, backbone=backbone, n_joints=17, dtype=dtype,
                      depth=8, bn_fold=backbone_supports_bn_fold(backbone))
    with torch.device(device):
        model = build_crop_model(cfg).eval()
        crops = torch.zeros(batch, proc_side, proc_side, 3, dtype=getattr(torch, dtype))
        intrinsics = torch.eye(3).expand(batch, 3, 3)
    return model, (crops, intrinsics)


def gflop_per_crop(backbone: str, proc_side: int, batch: int = 1, device='meta') -> float:
    model, inputs = crop_model_and_inputs(backbone, proc_side, batch, device)
    return forward_flops(model, inputs) / batch / 1e9


def parse_model(spec: str):
    backbone, _, side = spec.partition('@')
    return backbone, int(side)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--models', nargs='+', default=list(DEFAULT_MODELS),
                        help='backbone@proc_side')
    parser.add_argument('--device', default='cuda',
                        help='where the batch-1 forward that checks the meta count runs')
    args = parser.parse_args(argv)

    from metrabs_tpu_torch.pipeline.estimator import checked_device
    device = checked_device(args.device)
    records = {}
    print(f'{"model":28s} {"GFLOP/crop":>11s} {"XLA (JAX)":>10s} {"XLA/port":>9s}  s')
    for spec in args.models:
        backbone, side = parse_model(spec)
        t0 = time.perf_counter()
        meta = gflop_per_crop(backbone, side)
        on_device = gflop_per_crop(backbone, side, device=device)
        if on_device != meta:
            raise RuntimeError(f'{spec}: {on_device} GFLOP on {device}, {meta} on meta')
        xla = XLA_GFLOP_PER_CROP.get(spec)
        records[spec] = dict(gflop_per_crop=meta, xla_gflop_per_crop=xla,
                             xla_over_port=None if xla is None else xla / meta)
        ratio = '' if xla is None else f'{xla / meta:9.4f}'
        print(f'{spec:28s} {meta:11.4f} {xla if xla is not None else "":>10} {ratio:>9s}  '
              f'{time.perf_counter() - t0:.1f}')
    result = dict(device=str(device), models=records)
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
