"""Training-MFU experiments at the flagship configuration (the counterpart
of `scripts/mfu_experiments.py`).

    python scripts/mfu_experiments_torch.py                  # every variant
    python scripts/mfu_experiments_torch.py --variants remat_all no_remat

The dual-stream Metrabs train step (EffNetV2-L@384 bf16, AdamW + EMA, batch
64 + 64 by default, weights minted from a seed) in each of JAX's variants
(`VARIANTS`, the same names): where block remat stops
(`remat_until_block`), the first moment in bf16 (`optimizer_mu_dtype`) and
BN batch statistics in bf16 (`bn_bf16_stats`). Per variant: ms per step
(the median of `--steps` steps between CUDA events, after `--warmup`),
crops/s, model TFLOP/s = crops/s x 3 x forward FLOPs per crop
(`scripts/_flops_torch.py`: the forward and twice the forward for the
backward; remat's recompute not credited, as in JAX), MFU against the H100
SXM's dense bf16 peak (PEAK_BF16_TFLOPS, NVIDIA's data sheet; the card's
name and power limit are printed beside it), the hardware rate with
remat's extra forward (4 x) where remat is on, and the peak memory. A
variant that fails is recorded with its error (out of memory by name) and
the sweep goes on; the records are written to `--out` after each variant.
Defaults to the card and raises without CUDA (`--device cpu` for tests).
"""

from __future__ import annotations

import argparse
import gc
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

PEAK_BF16_TFLOPS = 989.0  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
# EffNetV2-L stage boundaries (cumulative blocks: 4, 11, 18, 28, 47, 72, 79).
VARIANTS = {
    'remat_all': dict(remat=True),
    'no_remat': dict(remat=False),
    'remat_first18': dict(remat=True, remat_until_block=18),
    'remat_first28': dict(remat=True, remat_until_block=28),
    'remat_first47': dict(remat=True, remat_until_block=47),
    'mu_bf16': dict(remat=True, mu_dtype='bfloat16'),
    'remat_first28_mu_bf16': dict(remat=True, remat_until_block=28, mu_dtype='bfloat16'),
    'bn_stats_bf16': dict(remat=True, bn_bf16_stats=True),
    'bn_stats_bf16_mu_bf16': dict(remat=True, bn_bf16_stats=True, mu_dtype='bfloat16'),
}


def run_variant(args, variant: dict, device, fwd_flops: float) -> dict:
    n = args.batch
    state, step, _, _ = minting.minted_trainer(args.backbone, args.res, device, args.dtype,
                                               **variant)
    b3, b2 = minting.random_train_batches(n, args.res, np.random.default_rng(0), device)
    gen = torch.Generator(device=device).manual_seed(0)
    losses = []
    times = tracelib.times_ms(lambda: losses.append(step(state, b3, b2, generator=gen)['loss']),
                              device, n=args.steps, n_warm=args.warmup)
    ms = statistics.median(times)
    crops_s = 2 * n / ms * 1e3
    model_tflops = crops_s * 3 * fwd_flops / 1e12
    rec = dict(ms_per_step=ms, ms_min=min(times), ms_max=max(times), crops_per_sec=crops_s,
               batch=f'{n}+{n}', res=args.res, backbone=args.backbone,
               fwd_flops_per_crop=fwd_flops, model_tflops=model_tflops,
               mfu_pct=100 * model_tflops / PEAK_BF16_TFLOPS,
               loss_first=float(losses[0]), loss_last=float(losses[-1]))
    if variant.get('remat', True):
        hw = crops_s * 4 * fwd_flops / 1e12
        rec.update(hw_tflops=hw, hw_util_pct=100 * hw / PEAK_BF16_TFLOPS)
    return rec


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--backbone', default='efficientnetv2-l')
    parser.add_argument('--res', type=int, default=384)
    parser.add_argument('--batch', type=int, default=64, help='per stream')
    parser.add_argument('--dtype', default='bfloat16')
    parser.add_argument('--warmup', type=int, default=3)
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--variants', nargs='+', choices=tuple(VARIANTS), default=None)
    parser.add_argument('--out', default='runs/mfu_torch.json')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    from metrabs_tpu_torch.pipeline.estimator import checked_device
    device = checked_device(args.device)
    card = tracelib.card_name() if device.type == 'cuda' else 'not measured'
    fwd = flops.gflop_per_crop(args.backbone, args.res) * 1e9
    print(f'{card}; peak {PEAK_BF16_TFLOPS} TFLOP/s dense bf16 (H100 SXM data sheet); forward '
          f'{fwd / 1e9:.3f} GFLOP/crop ({args.backbone}@{args.res})', flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results = {}
    for name in args.variants or list(VARIANTS):
        print(f'=== {name}: {VARIANTS[name]}', flush=True)
        t0 = time.time()
        if device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(device)
        try:
            rec = run_variant(args, VARIANTS[name], device, fwd)
        except torch.cuda.OutOfMemoryError as e:
            rec = dict(error='out of memory', detail=str(e).splitlines()[0][:300])
        except Exception as e:  # keep the sweep's other variants
            rec = dict(error=repr(e)[:500])
        if device.type == 'cuda':
            rec['peak_memory_gib'] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        rec['wall_s'] = time.time() - t0
        results[name] = rec
        print(f'  {rec}', flush=True)
        gc.collect()
        if device.type == 'cuda':
            torch.cuda.empty_cache()
        with open(args.out, 'w') as f:
            json.dump(dict(config=vars(args), card=card, peak_bf16_tflops=PEAK_BF16_TFLOPS,
                           variants=results), f, indent=1)

    print('\n| variant | ms/step | crops/s | model TFLOP/s | MFU % | peak GiB |')
    print('|---|---|---|---|---|---|')
    for name, rec in results.items():
        peak = rec.get('peak_memory_gib')
        peak = '' if peak is None else f'{peak:.2f}'
        if 'error' in rec:
            print(f'| {name} | FAILED ({rec["error"][:60]}) | | | | {peak} |')
        else:
            print(f'| {name} | {rec["ms_per_step"]:.1f} | {rec["crops_per_sec"]:.1f} | '
                  f'{rec["model_tflops"]:.2f} | {rec["mfu_pct"]:.2f} | {peak} |')
    result = dict(backbone=args.backbone, res=args.res, batch=args.batch, device=str(device),
                  card=card, peak_bf16_tflops=PEAK_BF16_TFLOPS, fwd_flops_per_crop=fwd,
                  variants=results)
    print(card)
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
