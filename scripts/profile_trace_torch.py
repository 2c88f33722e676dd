"""Device-time attribution of the port's crop model, detect call and train
step under torch.profiler (the counterpart of `scripts/profile_trace_
{cropmodel,fused,train}.py`).

    python scripts/profile_trace_torch.py --mode cropmodel [--bn-fold on|off]
    python scripts/profile_trace_torch.py --mode detect [--k2 on|off]
    python scripts/profile_trace_torch.py --mode train [--no-remat] [--bn-bf16-stats]

- cropmodel: EffNetV2-L@384, batch 128, bf16, depth 8; BN folded where the
  family folds (`--bn-fold`);
- detect: `detect_poses_batched` on 8 minted 1080p frames, YOLOv4-416 +
  EffNetV2-S@256 bf16, num_aug 2, threshold 0, max_detections 16; `--k2
  on` serves the crop model unfolded with `fuse_mbconv='on'` (K1 and K2 in
  its 28 qualifying blocks), `off` folded (K1 only);
- train: the Metrabs train step at EffNetV2-L@384 bf16, 16 + 16, AdamW +
  EMA, blocks rematerialised unless `--no-remat`.

Weights are minted from a seed (0.8x He). After a warm-up, `--iters` runs go
through `metrabs_tpu_torch.utils.profiling.trace` with shapes recorded; the
newest trace is parsed by `scripts/_tracelib_torch.py`. Prints the device
time per iteration, the host wall per iteration (without the profiler,
median of `--iters`, and under it) and the device-busy share, the device
time by category (the categories cover every device event), the top 25
kernels with launches and ms per iteration, and the memory format of each
convolution's input; then one JSON line of these figures. A profile whose
K1 or K2 records fall short of the launches their wrappers counted (the
profiler drops records now and then) is taken again, up to 3 times.
Defaults to the card and raises without CUDA (`--device cpu` for tests).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts import _minting_torch as minting  # noqa: E402
from scripts import _tracelib_torch as tracelib  # noqa: E402

PROFILE_TRIES = 3
MODE_DEFAULTS = dict(
    cropmodel=dict(backbone='efficientnetv2-l', res=384, batch=128),
    detect=dict(backbone='efficientnetv2-s', res=256, batch=minting.N_FRAMES),
    train=dict(backbone='efficientnetv2-l', res=384, batch=16))
DETECT = dict(num_aug=2, max_detections=16, internal_batch_size=64, detector_threshold=0.0,
              suppress_implausible_poses=True)


def synchronize(device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def label_norm_modules(modules):
    """A `tracelib.BN_LABEL` range around each forward of every normalisation
    module (a class name with 'BatchNorm' or 'GroupNorm') in `modules`, so
    that their kernels count as BatchNorm whatever ops they are made of.
    Backward kernels of a hand-written norm are not labelled."""
    open_ranges, handles = [], []

    def enter(module, args):
        open_ranges.append(torch.profiler.record_function(tracelib.BN_LABEL))
        open_ranges[-1].__enter__()

    def leave(module, args, output):
        open_ranges.pop().__exit__(None, None, None)

    for root in modules:
        for m in root.modules():
            if any(k in type(m).__name__ for k in ('BatchNorm', 'GroupNorm')):
                handles += [m.register_forward_pre_hook(enter), m.register_forward_hook(leave)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def kernel_counters():
    """{category: launches counted by the K1 and K2 wrappers since the last
    `reset_kernel_counters()`}."""
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda
    return {tracelib.K1: warp_cuda.warp_pyramid.launches,
            tracelib.K2: mbconv_cuda.fused_mbconv_inner.launches}


def reset_kernel_counters() -> None:
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda
    warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0


def profile(run, iters: int, outdir: str, device, modules=()) -> dict:
    """`run()` once to warm up, `iters` times timed on the host's clock, then
    `iters` times under `profiling.trace(outdir, record_shapes=True)`:
    `tracelib.summarise` of the trace plus the host wall per iteration
    (median unprofiled, mean profiled), the busy share of each (the kernels'
    times barely move under the profiler, the host's do) and the K1 and K2
    launches their wrappers counted in the profiled run.
    On the card, a trace without device events or with fewer K1 or K2 records
    than launches is taken again, up to PROFILE_TRIES times."""
    from metrabs_tpu_torch.utils import profiling

    run()
    synchronize(device)
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        synchronize(device)
        walls.append(time.perf_counter() - t0)
    with label_norm_modules(modules):
        for attempt in range(1, PROFILE_TRIES + 1):
            shutil.rmtree(outdir, ignore_errors=True)
            reset_kernel_counters()
            with profiling.trace(outdir, record_shapes=True):
                synchronize(device)
                t0 = time.perf_counter()
                for _ in range(iters):
                    run()
                synchronize(device)
                profiled_s = time.perf_counter() - t0
            counted = kernel_counters()
            summary = tracelib.summarise(tracelib.load_latest_trace(outdir), iters)
            lost = {k: (summary['category_launches'][k], n) for k, n in counted.items()
                    if summary['category_launches'][k] != n}
            if device.type != 'cuda' or (summary['device_events'] and not lost):
                break
            print(f'profile {attempt}: {summary["device_events"]} device events, K1/K2 records '
                  f'against launches {lost}: profiling again', flush=True)
        else:
            raise RuntimeError(f'torch.profiler lost records in {PROFILE_TRIES} profiles')
    wall_ms = statistics.median(walls) * 1e3
    summary.update(
        wall_ms=wall_ms, profiled_wall_ms=profiled_s * 1e3 / iters,
        busy_share=summary['busy_ms'] / wall_ms,
        profiled_busy_share=summary['busy_ms'] / (profiled_s * 1e3 / iters),
        wrapper_launches={k: n / iters for k, n in counted.items()}, attempts=attempt)
    return summary


def build_cropmodel(args, device):
    bn_fold = None if args.bn_fold == 'auto' else args.bn_fold == 'on'
    model, cfg = minting.minted_crop_model(args.backbone, args.res, device, args.dtype,
                                           bn_fold=bn_fold)
    rng = np.random.default_rng(0)
    image = torch.as_tensor(rng.uniform(size=(args.batch, args.res, args.res, 3)),
                            dtype=getattr(torch, args.dtype), device=device)
    k = torch.tensor([[400.0, 0, args.res / 2], [0, 400.0, args.res / 2], [0, 0, 1]],
                     device=device).expand(args.batch, 3, 3)

    def run():
        with torch.inference_mode():
            return model(image, k)

    return run, [model], dict(bn_fold=cfg.bn_fold)


def build_detect(args, device, est=None, frames=None):
    """The detect run of `est` (default: the minted detect cell) on `frames`
    (default: the minted 1080p frames)."""
    if est is None:
        est = minting.minted_estimator(device, args.backbone, args.res, args.dtype,
                                       detector=True, k2=args.k2 == 'on')
    if frames is None:
        frames = minting.synthetic_frames(torch.Generator(device=device).manual_seed(
            minting.SEED), device)[:args.batch]

    def run():
        return est.detect_poses_batched(frames, **DETECT)

    return run, [est.crop_model, est.detector.model], dict(
        bn_fold=est.cfg.bn_fold, k2=args.k2, frames=list(frames.shape))


def build_train(args, device):
    state, step, cfg, _ = minting.minted_trainer(
        args.backbone, args.res, device, args.dtype, remat=not args.no_remat,
        bn_bf16_stats=args.bn_bf16_stats)
    b3, b2 = minting.random_train_batches(args.batch, args.res, np.random.default_rng(0), device)
    gen = torch.Generator(device=device).manual_seed(0)
    return (lambda: step(state, b3, b2, generator=gen)), [state.model], dict(
        remat=cfg.backbone_remat, bn_bf16_stats=args.bn_bf16_stats)


def print_summary(s: dict, what: str) -> None:
    print(f'{what}: device {s["device_ms"]:.3f} ms/iter ({s["timeline"]}), busy '
          f'{s["busy_ms"]:.3f} ms; host wall {s["wall_ms"]:.2f} ms/iter (median of '
          f'{s["iters"]}), {s["profiled_wall_ms"]:.2f} under the profiler; busy share '
          f'{100 * s["busy_share"]:.1f}% ({100 * s["profiled_busy_share"]:.1f}% profiled)')
    total = max(s['device_ms'], 1e-12)
    for cat, ms in sorted(s['categories_ms'].items(), key=lambda kv: -kv[1]):
        print(f'  {cat:32s} {ms:10.3f} ms  {100 * ms / total:5.1f}%  '
              f'{s["category_launches"][cat] / s["iters"]:8.1f} launches')
    print(f'top {len(s["top_kernels"])} kernels (per iteration):')
    for k in s['top_kernels']:
        print(f'  {k["ms"]:9.3f} ms {k["launches"]:7.1f}x  [{k["category"]}] {k["name"][:100]}')
    print('convolution inputs by memory format: ' + ', '.join(
        f'{k} {v}' for k, v in sorted(s['conv_input_formats'].items())))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--mode', choices=tuple(MODE_DEFAULTS), default='cropmodel')
    parser.add_argument('--backbone')
    parser.add_argument('--res', type=int)
    parser.add_argument('--batch', type=int,
                        help='crops (cropmodel), frames (detect), per stream (train)')
    parser.add_argument('--dtype', default='bfloat16')
    parser.add_argument('--iters', type=int, default=3)
    parser.add_argument('--bn-fold', choices=('auto', 'on', 'off'), default='auto',
                        help='cropmodel: fold BN (auto: where the family folds)')
    parser.add_argument('--k2', choices=('on', 'off'), default='on',
                        help='detect: unfolded with the fused MBConv kernel, or folded')
    parser.add_argument('--no-remat', action='store_true')
    parser.add_argument('--bn-bf16-stats', action='store_true')
    parser.add_argument('--outdir', help='trace directory (default runs/trace_torch_<mode>)')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    for k, v in MODE_DEFAULTS[args.mode].items():
        if getattr(args, k) is None:
            setattr(args, k, v)

    from metrabs_tpu_torch.pipeline.estimator import checked_device
    device = checked_device(args.device)
    outdir = args.outdir or os.path.join('runs', f'trace_torch_{args.mode}')
    run, modules, extra = dict(cropmodel=build_cropmodel, detect=build_detect,
                               train=build_train)[args.mode](args, device)
    summary = profile(run, args.iters, outdir, device, modules)
    print_summary(summary, f'{args.mode} {args.backbone}@{args.res} {args.dtype} batch '
                           f'{args.batch} {extra}')
    result = dict(mode=args.mode, backbone=args.backbone, res=args.res, batch=args.batch,
                  dtype=args.dtype, device=str(device), **extra, **summary)
    if device.type == 'cuda':
        result['card'] = tracelib.card_name()
        print(result['card'])
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
