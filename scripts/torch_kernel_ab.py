#!/usr/bin/env python3
"""A/B of the port's two CUDA kernels against other builds of them, on one GPU.

    python3 scripts/torch_kernel_ab.py --parent runs/parent
    python3 scripts/torch_kernel_ab.py --probe no_taps

`--parent DIR`: the kernels of another checkout (both C interfaces must
match this one's), e.g. the parent commit unpacked with `git archive`.
`--probe NAME`: this checkout's K2 built with `-DMBCONV_PROBE_<NAME>`, one
part of its work changed or taken out (the probes `csrc/mbconv.cu` lists),
to measure what that part costs; K2 cases in bfloat16 only.

Builds both sides with the same nvcc flags, then, at chip_smoke.py's warp
case (not for a probe) and at each of its K2_CASES, checks what both give
and times them in turns other, change, change, other (device time from
torch.profiler, mean of 25 calls, as chip_smoke.py). Prints the card's name
and power limit, then one JSON line per case with both pairs of times beside
the case's bound. Needs a CUDA GPU and nvcc.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from metrabs_tpu_torch.ops import mbconv, mbconv_cuda  # noqa: E402
from metrabs_tpu_torch.ops import warp as warp_ops  # noqa: E402
from metrabs_tpu_torch.ops import warp_cuda  # noqa: E402

PROBES = ('fast_silu', 'no_act_math', 'no_out_math', 'no_taps')


def use(libs, side):
    """Points both wrappers at `side`'s libraries."""
    warp_lib, mbconv_lib = libs[side]
    warp_cuda._library = lambda: warp_lib
    mbconv_cuda._library = lambda: mbconv_lib


def ab(libs, fn):
    """Device times of `fn` (ms) and its results in turns other, change,
    change, other."""
    times, outs = {'other': [], 'change': []}, {}
    for side in ('other', 'change', 'change', 'other'):
        use(libs, side)
        outs[side] = fn()
        times[side].append(chip_smoke.device_time_ms(fn))
    return times, outs


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument('--parent', type=Path,
                       help='root of the other checkout (e.g. unpacked with git archive)')
    group.add_argument('--probe', choices=PROBES,
                       help='K2 with one part changed (csrc/mbconv.cu) against this K2')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA GPU')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    libs = {'change': (warp_cuda._library(), mbconv_cuda._library())}
    if args.probe:
        define = f'MBCONV_PROBE_{args.probe.upper()}'
        libs['other'] = (libs['change'][0], mbconv_cuda._library(defines=(define,)))
        label = f'probe {args.probe}'
    else:
        csrc = args.parent.resolve() / 'metrabs_tpu_torch' / 'csrc'
        libs['other'] = (warp_cuda._library(csrc), mbconv_cuda._library(csrc))
        label = f'parent {args.parent}'

    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    if not args.probe:
        k1_ab(libs, label, gen, dev)
    for case, shape, dtype, _ in chip_smoke.K2_CASES:
        if args.probe and dtype != torch.bfloat16:
            continue
        u, dw, (bn0, bn1) = chip_smoke.k2_case(shape, dtype, gen, dev)
        taps, sb = mbconv.inner_constants(dw, *bn0.folded(), *bn1.folded())
        times, outs = ab(libs, lambda: mbconv_cuda.fused_mbconv_inner(u, taps, sb))
        n_bytes, bound_ms, bound_by = chip_smoke.k2_bound(u.shape, u.element_size())
        diff = (outs['change'][0].float() - outs['other'][0].float()).abs()
        print(json.dumps(dict(kernel='fused_mbconv_inner', other=label, case=case,
                              shape=list(shape), dtype=str(dtype)[6:],
                              other_ms=times['other'], change_ms=times['change'],
                              bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by,
                              max_abs_diff_v=diff.max().item())), flush=True)
        del u, outs, diff


def k1_ab(libs, label, gen, dev):
    """The A/B of the warp kernel at chip_smoke.py's warp case."""
    frames = chip_smoke.synthetic_frames(gen, dev)
    flat, level_info, per_image_len = warp_ops.build_flat_pyramid(
        (frames.float() / 255.0) ** 2.2, 3)
    params, geom = warp_ops.pyramid_warp_params(
        level_info=level_info, per_image_len=per_image_len, **chip_smoke.warp_case(dev))
    side = (chip_smoke.PROC_SIDE, chip_smoke.PROC_SIDE)
    times, outs = ab(libs, lambda: warp_cuda.warp_pyramid(flat, params, geom, side))
    n_bytes, bound_ms, bound_by = chip_smoke.k1_bound(flat, params, geom, side)
    print(json.dumps(dict(kernel='warp_pyramid', other=label,
                          shape=list(outs['change'].shape), other_ms=times['other'],
                          change_ms=times['change'], bytes=n_bytes, bound_ms=bound_ms,
                          bound_by=bound_by, max_abs_diff=(
                              outs['change'] - outs['other']).abs().max().item())),
          flush=True)


if __name__ == '__main__':
    main()
