"""Ablation profile of the EffNetV2-L@384 crop model on the card (the
counterpart of `scripts/profile_cropmodel.py`).

    python scripts/profile_cropmodel_torch.py [--backbone efficientnetv2-l]
        [--res 384] [--batch 128]

Times, per batch of `--batch` bf16 crops (BN folded where the family folds,
weights minted from a seed): the full model (backbone, head, decode and
absolute reconstruction) against backbone + head against the backbone
alone; the backbone at 256 and 192 px against the ratio of its forward
FLOPs (`scripts/_flops_torch.py`); and the backbone at batch 32 and 64.
JAX's `timed_scan` is an on-device loop; here `--calls` back-to-back calls
go between two CUDA events after a warm-up, and the median of 3 such runs
per call is kept. Prints the table and one JSON line. Defaults to the card
and raises without CUDA (`--device cpu` for tests).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts import _flops_torch as flops  # noqa: E402
from scripts import _minting_torch as minting  # noqa: E402
from scripts import _tracelib_torch as tracelib  # noqa: E402


def per_call_ms(fn, device, calls: int, repeats: int = 3) -> float:
    """Median over `repeats` of (time of `calls` back-to-back `fn()` between
    two CUDA events) / `calls`, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(repeats):
        if device.type == 'cuda':
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / calls)
    return statistics.median(times)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--backbone', default='efficientnetv2-l')
    parser.add_argument('--res', type=int, default=384)
    parser.add_argument('--batch', type=int, default=128)
    parser.add_argument('--dtype', default='bfloat16')
    parser.add_argument('--scales', type=int, nargs='+', default=[256, 192],
                        help='backbone resolutions against --res')
    parser.add_argument('--batches', type=int, nargs='+', default=[32, 64],
                        help='backbone batch sizes against --batch')
    parser.add_argument('--calls', type=int, default=10)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    from metrabs_tpu_torch.pipeline.estimator import checked_device
    device = checked_device(args.device)
    rng = np.random.default_rng(0)
    dtype = getattr(torch, args.dtype)
    model, cfg = minting.minted_crop_model(args.backbone, args.res, device, args.dtype)
    image = lambda b, r: torch.as_tensor(rng.uniform(size=(b, r, r, 3)), dtype=dtype,
                                         device=device)
    k = torch.tensor([[400.0, 0, args.res / 2], [0, 400.0, args.res / 2], [0, 0, 1]],
                     device=device).expand(args.batch, 3, 3)
    timed = lambda fn: per_call_ms(fn, device, args.calls)
    crops = image(args.batch, args.res)
    rec = {}
    with torch.inference_mode():
        rec['full_ms'] = timed(lambda: model(crops, k))
        rec['backbone_head_ms'] = timed(lambda: model.backbone_and_head(crops))
        rec['backbone_ms'] = timed(lambda: model.backbone(crops))
        bb_gflop = lambda r: flops.forward_flops(*backbone_on_meta(args, r)) / 1e9
        base_gflop = bb_gflop(args.res)
        rec['backbone_gflop_per_crop'] = base_gflop
        rec['resolution_scaling'] = {}
        for r in args.scales:
            crops_r = image(args.batch, r)
            ms = timed(lambda: model.backbone(crops_r))
            rec['resolution_scaling'][r] = dict(ms=ms, speedup=rec['backbone_ms'] / ms,
                                        flop_ratio=base_gflop / bb_gflop(r),
                                        area_ratio=(args.res / r) ** 2)
        rec['batch_scaling'] = {}
        for b in args.batches:
            crops_b = image(b, args.res)
            ms = timed(lambda: model.backbone(crops_b))
            rec['batch_scaling'][b] = dict(ms=ms, crops_per_s=b / ms * 1e3)
    n = args.batch
    print(f'{args.backbone}@{args.res} {args.dtype} batch {n}, BN folded {cfg.bn_fold}; per '
          f'call, median of 3 runs of {args.calls} back-to-back calls')
    print(f'full model  : {rec["full_ms"]:9.3f} ms/batch ({n / rec["full_ms"] * 1e3:8.1f} '
          f'crops/s)')
    print(f'bb+head     : {rec["backbone_head_ms"]:9.3f} ms/batch -> decode/reconstruct '
          f'{rec["full_ms"] - rec["backbone_head_ms"]:.3f} ms')
    print(f'backbone    : {rec["backbone_ms"]:9.3f} ms/batch ({n / rec["backbone_ms"] * 1e3:8.1f}'
          f' crops/s), {base_gflop:.3f} GFLOP/crop')
    for r, v in rec['resolution_scaling'].items():
        print(f'backbone@{r}: {v["ms"]:9.3f} ms/batch, speedup {v["speedup"]:.2f}x (FLOP ratio '
              f'{v["flop_ratio"]:.2f}x, area ratio {v["area_ratio"]:.2f}x)')
    for b, v in rec['batch_scaling'].items():
        print(f'backbone b={b:3d}: {v["ms"]:9.3f} ms/batch ({v["crops_per_s"]:8.1f} crops/s)')
    result = dict(backbone=args.backbone, res=args.res, batch=n, dtype=args.dtype,
                  bn_fold=cfg.bn_fold, calls=args.calls, device=str(device), **rec)
    if device.type == 'cuda':
        result['card'] = tracelib.card_name()
        print(result['card'])
    print(json.dumps(result))
    return result


def backbone_on_meta(args, res: int):
    model, (crops, _) = flops.crop_model_and_inputs(args.backbone, res, dtype=args.dtype)
    return model.backbone, (crops,)


if __name__ == '__main__':
    main()
