"""Flagship (EffNetV2-L@384) serving: serial `detect_poses_batched` calls
against `detect_poses_pipelined` (the counterpart of
`scripts/bench_pipelined_flagship.py`).

    python scripts/bench_pipelined_flagship_torch.py [--batch 8] [--n-batches 6]

The crop model is EffNetV2-L@384 bf16, BN folded (K1 warps its crops), the
detector a float32 YOLOv4-416 as in the JAX script, weights minted from a
seed; `--n-batches` batches of `--batch` random 1080p frames (on the card,
or with `--host-input` as host arrays), num_aug 2, threshold 0 (every
detection slot valid), max_detections 16. Times the serial path (each
batch's result copied to the host) and the pipelined one at in_flight 2 and
3, each the best of `--repeats` (3) runs after a warm-up of both, as ms per
batch and frames/s, and checks that the pipelined results equal the serial ones (the
masks exactly, the rest within 1e-3, the JAX script's check) and that K1
ran. The port's pipelined path overlaps nothing yet (each batch waits for
the device inside `detect_poses_batched`), so its ratio to the serial path
is what the script records. Writes `--out` and prints one JSON line.
Defaults to the card and raises without CUDA (`--device cpu` for tests).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts import _minting_torch as minting  # noqa: E402
from scripts import _tracelib_torch as tracelib  # noqa: E402


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--backbone', default='efficientnetv2-l')
    p.add_argument('--res', type=int, default=384)
    p.add_argument('--dtype', default='bfloat16')
    p.add_argument('--batch', type=int, default=8, help='frames per batch')
    p.add_argument('--n-batches', type=int, default=6)
    p.add_argument('--num-aug', type=int, default=2)
    p.add_argument('--threshold', type=float, default=0.0,
                   help='0.0 = dense (every candidate box survives)')
    p.add_argument('--height', type=int, default=1080)
    p.add_argument('--width', type=int, default=1920)
    p.add_argument('--host-input', action='store_true',
                   help='feed host numpy frames (the host-to-device copy is then timed too)')
    p.add_argument('--repeats', type=int, default=3, help='runs per path; the best is kept')
    p.add_argument('--out', default='runs/pipelined_torch.json')
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)

    from metrabs_tpu_torch.ops import warp_cuda
    from metrabs_tpu_torch.pipeline.estimator import checked_device

    device = checked_device(args.device)
    est = minting.minted_estimator(device, args.backbone, args.res, args.dtype, detector=True,
                                   detector_dtype='float32')
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 255, size=(args.batch, args.height, args.width, 3),
                            dtype=np.uint8) for _ in range(args.n_batches)]
    if not args.host_input:
        batches = [torch.as_tensor(b, device=device) for b in batches]
    kwargs = dict(num_aug=args.num_aug, max_detections=16, detector_threshold=args.threshold)

    def run_serial():
        return [{k: v.cpu().numpy() for k, v in est.detect_poses_batched(b, **kwargs).items()}
                for b in batches]

    def run_pipelined(depth):
        return list(est.detect_poses_pipelined(batches, in_flight=depth, **kwargs))

    warp_cuda.warp_pyramid.launches = 0
    run_serial()
    k1_launches = warp_cuda.warp_pyramid.launches
    run_pipelined(2)

    def best_s(fn):
        best = float('inf')
        for _ in range(args.repeats):
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    n_frames = args.batch * args.n_batches
    results = {}
    for name, fn in (('serial', run_serial), ('pipelined_if2', lambda: run_pipelined(2)),
                     ('pipelined_if3', lambda: run_pipelined(3))):
        dt = best_s(fn)
        results[name] = dict(s_total=dt, ms_per_batch=dt / args.n_batches * 1e3,
                             fps=n_frames / dt)
        print(f'{name}: {results[name]}', flush=True)
    for name in ('pipelined_if2', 'pipelined_if3'):
        results[name]['vs_serial'] = results['serial']['s_total'] / results[name]['s_total']

    serial, pipelined = run_serial(), run_pipelined(2)
    worst = 0.0
    for a, b in zip(serial, pipelined, strict=True):
        if not np.array_equal(a['valid'], b['valid']):
            raise AssertionError('pipelined valid masks differ from the serial ones')
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-3, err_msg=k)
            worst = max(worst, float(np.abs(a[k].astype(np.float64) - b[k]).max(initial=0)))
    print(f'pipelined == serial outputs: ok (max |difference| {worst:.3g}); K1 launches per '
          f'serial run {k1_launches}', flush=True)
    if device.type == 'cuda' and k1_launches == 0:
        raise AssertionError('K1 did not run on the serving path')
    result = dict(config=vars(args), device=str(device), results=results,
                  max_abs_difference=worst, k1_launches_serial=k1_launches,
                  valid_per_batch=[int(r['valid'].sum()) for r in serial])
    if device.type == 'cuda':
        result['card'] = tracelib.card_name()
        print(result['card'])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
