"""Can the host loader keep the card's train step fed? (the counterpart of
`scripts/bench_data_pipeline.py`)

    python scripts/bench_data_pipeline_torch.py [--batch 32] [--workers N]
        [--res 256] [--step-ms MS]

Runs the real per-example path: a 640x480 frame JPEG-encoded once by
`data/jpeg.py` (the bytes cv2.imencode writes at quality 90), then per
example its decode (libjpeg-turbo's, as cv2's) and
`data/loading.py::load_and_transform3d` with every augmentation (camera
turn, zoom warp, occluders, colour), through
`data/pipeline.py::ParallelBatchLoader`; reports ms per batch, examples/s
and batches/s against the device step. The step is `--step-ms` or, without
it, the median of 10 train steps timed here on the card between CUDA events
(EffNetV2-S@256 bf16, `--batch` + `--batch`, weights minted from a seed),
after the loader's measurement. Prints the figures and one JSON line.
Defaults to the card and raises without CUDA (`--device cpu` for tests,
which must then give `--step-ms`).
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

STEP_BACKBONE = 'efficientnetv2-s'


def device_step_ms(batch: int, res: int, device, n_warmup: int = 3, n_steps: int = 10) -> float:
    """Median ms of the EffNetV2-S@res bf16 train step at batch + batch."""
    state, step, _, _ = minting.minted_trainer(STEP_BACKBONE, res, device, remat=False)
    b3, b2 = minting.random_train_batches(batch, res, np.random.default_rng(0), device)
    gen = torch.Generator(device=device).manual_seed(0)
    return statistics.median(tracelib.times_ms(lambda: step(state, b3, b2, generator=gen), device,
                                               n=n_steps, n_warm=n_warmup))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--batch', type=int, default=32)
    parser.add_argument('--workers', type=int, default=os.cpu_count() or 8)
    parser.add_argument('--res', type=int, default=256)
    parser.add_argument('--n-batches', type=int, default=30)
    parser.add_argument('--step-ms', type=float, default=None,
                        help='device ms per step to compare against (default: timed here)')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    from metrabs_tpu_torch.config import ModelConfig
    from metrabs_tpu_torch.data import jpeg
    from metrabs_tpu_torch.data.camera import Camera
    from metrabs_tpu_torch.data.loading import Example3D, LoadConfig, load_and_transform3d
    from metrabs_tpu_torch.data.pipeline import ParallelBatchLoader
    from metrabs_tpu_torch.pipeline.estimator import checked_device
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17

    device = checked_device(args.device)
    if args.step_ms is None and device.type != 'cuda':
        raise ValueError('--step-ms is required off the card')
    cfg = ModelConfig(proc_side=args.res, stride_train=32, stride_test=32, n_joints=17)
    lcfg = LoadConfig()
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 255, size=(480, 640, 3), dtype=np.uint8)
    # The JAX script hands `frame` to cv2 as BGR; the same bytes, in RGB order here.
    enc = jpeg.encode(frame[..., ::-1], 90)
    k = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]], np.float32)
    cam = Camera(intrinsic_matrix=k, extrinsic_matrix=np.eye(4, dtype=np.float32),
                 world_up=(0, -1, 0))
    pose = (rng.normal(size=(17, 3)) * 250 + [0, 0, 4000]).astype(np.float32)
    im_pts = cam.world_to_image(pose)
    x0, y0 = im_pts.min(0) - 20
    x1, y1 = im_pts.max(0) + 20
    bbox = np.array([x0, y0, x1 - x0, y1 - y0], np.float32)

    def load_fn(example, ex_rng):
        ex = Example3D(image_path='synthetic/h36m_bench.jpg', camera=cam, bbox=bbox,
                       world_coords=pose, image=jpeg.decode(enc))
        return load_and_transform3d(ex, H36M_17, True, ex_rng, cfg, lcfg)

    def example_stream():
        while True:
            yield None

    loader = ParallelBatchLoader(load_fn, example_stream(), args.batch, n_workers=args.workers,
                                 prefetch_batches=4)
    try:
        next(loader)  # warm the pool
        times = []
        t0 = time.perf_counter()
        for _ in range(args.n_batches):
            t = time.perf_counter()
            batch = next(loader)
            times.append(time.perf_counter() - t)
        dt = time.perf_counter() - t0
    finally:
        loader.close()
    assert batch['image'].shape == (args.batch, args.res, args.res, 3)
    per_batch_ms = dt / args.n_batches * 1e3
    ex_per_s = args.batch * args.n_batches / dt
    print(f'loader: {per_batch_ms:.1f} ms/batch of {args.batch} ({ex_per_s:.0f} examples/s, '
          f'{1e3 / per_batch_ms:.2f} batches/s, {args.workers} workers; wait per batch median '
          f'{statistics.median(times) * 1e3:.1f} ms)', flush=True)

    step_source = 'given' if args.step_ms is not None else (
        f'timed: {STEP_BACKBONE}@{args.res} bf16 {args.batch}+{args.batch}, median of 10')
    step_ms = args.step_ms if args.step_ms is not None else device_step_ms(
        args.batch, args.res, device)
    # JAX's margin sets one batch against a step; the dual-stream step takes
    # a batch of each stream, from one loader each.
    one_stream = step_ms / per_batch_ms
    ratio = step_ms / (2 * per_batch_ms)
    verdict = 'SATURATES' if ratio >= 1.0 else 'STARVES'
    print(f'device step {step_ms:.1f} ms ({step_source}) -> loader margin {one_stream:.2f}x '
          f'per batch, {ratio:.2f}x for {args.batch}+{args.batch} from this pool ({verdict} '
          f'the device)')
    per_ex_ms = per_batch_ms * args.workers / args.batch
    need = 2 * args.batch * per_ex_ms / step_ms
    print(f'per-example CPU cost ~{per_ex_ms:.1f} ms -> a training host needs ~{need:.0f} busy '
          f'cores to saturate one card at batch {args.batch}+{args.batch}')
    result = dict(batch=args.batch, workers=args.workers, res=args.res,
                  n_batches=args.n_batches, ms_per_batch=per_batch_ms,
                  examples_per_s=ex_per_s, batches_per_s=1e3 / per_batch_ms,
                  step_ms=step_ms, step_source=step_source, margin_one_stream=one_stream,
                  margin=ratio, verdict=verdict,
                  per_example_cpu_ms=per_ex_ms, cores_needed=need, device=str(device),
                  host_cpus=os.cpu_count())
    if device.type == 'cuda':
        result['card'] = tracelib.card_name()
        print(result['card'])
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
