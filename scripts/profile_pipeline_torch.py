"""Stage times of the port's serving pipeline (the counterpart of
`scripts/profile_pipeline.py`).

    python scripts/profile_pipeline_torch.py [--backbone efficientnetv2-s]
        [--n-boxes 10] [--num-aug 5] [--height 1080] [--width 1920]
        [--res 256] [--detector none|yolov4]

Times, as the median of `--iters` (>= 20) calls between CUDA events:
 (a) the gamma decode of a uint8 frame and the pyramid build
     (`ops/warp.py::build_flat_pyramid`, 3 levels);
 (b) the warp of n_boxes x num_aug crops through K1 (`ops/warp_cuda.py`;
     its parameters computed once, outside the timing);
 (c) the crop model's forward on as many crops;
 (d) `estimate_poses_batched` end to end on the frame and its boxes;
and with `--detector yolov4` (a minted YOLOv4-416):
 (e) the detector's forward on its preprocessed input;
 (f) the box NMS (`ops/nms.py::greedy_nms` through `yolov4.box_nms`) on the
     candidates of that frame: its host time per call without the profiler
     (the host's clock from the call to its return, no wait) and its time
     with the device's work waited for.
Weights are minted from a seed (0.8x He). Prints each stage and one JSON
line. Defaults to the card and raises without CUDA (`--device cpu` for
tests).
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

from scripts import _minting_torch as minting  # noqa: E402
from scripts import _tracelib_torch as tracelib  # noqa: E402


def captured_call(obj, attr: str, run):
    """(args, kwargs) of the first call of `obj.attr` during `run()`."""
    original, seen = getattr(obj, attr), []

    def wrapper(*args, **kwargs):
        seen.append((args, kwargs))
        return original(*args, **kwargs)

    setattr(obj, attr, wrapper)
    try:
        run()
    finally:
        setattr(obj, attr, original)
    return seen[0]


def host_ms(fn, device, n: int) -> float:
    """Median host time of `fn()` from call to return, the device's work
    waited for between calls but not inside the timing."""
    times = []
    for _ in range(n):
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    return statistics.median(times)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--backbone', default='efficientnetv2-s')
    parser.add_argument('--n-boxes', type=int, default=10)
    parser.add_argument('--num-aug', type=int, default=5)
    parser.add_argument('--height', type=int, default=1080)
    parser.add_argument('--width', type=int, default=1920)
    parser.add_argument('--res', type=int, default=256)
    parser.add_argument('--dtype', default='bfloat16')
    parser.add_argument('--detector', choices=('none', 'yolov4'), default='none')
    parser.add_argument('--iters', type=int, default=20)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    from metrabs_tpu_torch.detect import yolov4
    from metrabs_tpu_torch.ops import warp as warp_ops
    from metrabs_tpu_torch.ops import warp_cuda
    from metrabs_tpu_torch.pipeline.estimator import checked_device

    device = checked_device(args.device)
    rng = np.random.default_rng(0)
    h, w, res = args.height, args.width, args.res
    n_crops = args.n_boxes * args.num_aug
    image = torch.as_tensor(rng.integers(0, 255, size=(1, h, w, 3), dtype=np.uint8),
                            device=device)
    timed = lambda fn: statistics.median(tracelib.times_ms(fn, device, n=args.iters))
    stages = {}

    # (a) gamma decode + pyramid
    def decode_and_pyramid():
        return warp_ops.build_flat_pyramid((image.float() / 255.0) ** 2.2, 3)

    stages['decode_pyramid_ms'] = timed(decode_and_pyramid)
    print(f'(a) decode+pyramid ({h}x{w}): {stages["decode_pyramid_ms"]:.3f} ms', flush=True)

    # (b) K1 on n_crops crops
    flat, level_info, per_image_len = decode_and_pyramid()
    k = torch.tensor([[1500.0, 0, w / 2], [0, 1500.0, h / 2], [0, 0, 1]], device=device)
    new_k = torch.tensor([[250.0, 0, res / 2], [0, 250.0, res / 2], [0, 0, 1]],
                         device=device)
    params, geom = warp_ops.pyramid_warp_params(
        level_info=level_info, per_image_len=per_image_len,
        intrinsic_matrix=k.expand(n_crops, 3, 3),
        new_invprojmat=torch.linalg.inv(new_k).expand(n_crops, 3, 3),
        distortion_coeffs=torch.zeros(n_crops, 12, device=device),
        crop_scales=torch.full((n_crops,), 0.9, device=device),
        image_ids=torch.zeros(n_crops, dtype=torch.long, device=device))
    stages['warp_k1_ms'] = timed(lambda: warp_cuda.warp_pyramid(flat, params, geom, (res, res)))
    print(f'(b) warp through K1 ({n_crops} crops {res}px): {stages["warp_k1_ms"]:.3f} ms',
          flush=True)

    # (c) crop-model forward
    est = minting.minted_estimator(device, args.backbone, res, args.dtype,
                                   detector=args.detector == 'yolov4')
    crops = torch.as_tensor(rng.uniform(size=(n_crops, res, res, 3)),
                            dtype=getattr(torch, args.dtype), device=device)
    with torch.inference_mode():
        stages['crop_model_ms'] = timed(lambda: est.crop_model(crops,
                                                               new_k.expand(n_crops, 3, 3)))
    print(f'(c) crop model forward ({args.backbone}, {n_crops} crops): '
          f'{stages["crop_model_ms"]:.3f} ms', flush=True)

    # (d) estimate_poses_batched end to end
    bw, bh = min(350, w // 2), min(580, h // 2)  # the JAX script's boxes where they fit
    boxes = np.stack([np.array([rng.uniform(0, w - bw - 50), rng.uniform(0, h - bh - 20), bw, bh],
                               np.float32) for _ in range(args.n_boxes)])[None]
    stages['estimate_ms'] = timed(lambda: est.estimate_poses_batched(
        image, boxes, num_aug=args.num_aug, internal_batch_size=max(64, n_crops)))
    print(f'(d) estimate_poses_batched ({args.n_boxes} boxes x {args.num_aug} aug): '
          f'{stages["estimate_ms"]:.3f} ms -> {n_crops / stages["estimate_ms"] * 1e3:.1f} '
          f'crops/s', flush=True)

    if args.detector == 'yolov4':
        detect = lambda: est.detector.detect_batched(image, threshold=0.3)
        with torch.inference_mode():
            (resized,), _ = captured_call(est.detector.model, 'forward', detect)
            stages['detector_forward_ms'] = timed(lambda: est.detector.model(resized))
            nms_args, nms_kwargs = captured_call(yolov4, 'box_nms', detect)
            nms = lambda: yolov4.box_nms(*nms_args, **nms_kwargs)
            nms()
            stages['box_nms_host_ms'] = host_ms(nms, device, args.iters)
            stages['box_nms_ms'] = timed(nms)
        print(f'(e) detector forward (YOLOv4-{est.detector.input_size}, '
              f'{list(resized.shape)}): {stages["detector_forward_ms"]:.3f} ms', flush=True)
        print(f'(f) box NMS ({list(nms_args[0].shape)} candidates): host '
              f'{stages["box_nms_host_ms"]:.3f} ms per call without the profiler, '
              f'{stages["box_nms_ms"]:.3f} ms with its device work', flush=True)

    result = dict(backbone=args.backbone, res=res, n_boxes=args.n_boxes, num_aug=args.num_aug,
                  height=h, width=w, dtype=args.dtype, detector=args.detector,
                  iters=args.iters, device=str(device), **stages)
    if device.type == 'cuda':
        result['card'] = tracelib.card_name()
        print(result['card'])
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
