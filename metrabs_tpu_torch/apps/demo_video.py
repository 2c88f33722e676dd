"""Video demo: streaming multi-person estimation (`metrabs_tpu/apps/
demo_video.py`), on videos read and written by `data.video`.

Frames are batched (--frame-batch); the trailing partial batch is padded to
--frame-batch (results sliced back), and --letterbox HxW resizes and pads
every frame to one size with the intrinsics transformed to match, so every
estimator call sees one shape. --stream K sends K frame batches per
`detect_poses_stream` call. An overlay video is written with --out.

Usage:
  python -m metrabs_tpu_torch.apps.demo_video --video in.mp4 \
      [--package dir] [--out out.mp4] [--max-frames N] [--fov 55] \
      [--letterbox 1080x1920] [--device cuda]

The input is Motion JPEG, mp4v or H.264 (progressive I, P and B slices,
its frames in cv2's output order) in an AVI, Matroska or MP4 file
(`data.video`). `--out`
writes mp4v, as JAX's demo does, into the container its extension names
(`.mp4`, `.avi` or `.mkv`); any other extension raises.
JAX's flags plus `--device` (default cuda); `--fast-load` is accepted and
does nothing (`demo_image`).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def fov_intrinsics(fov_degrees: float, h: int, w: int) -> np.ndarray:
    """Intrinsics whose larger side spans the FOV, principal point at the
    centre."""
    focal = max(h, w) / (np.tan(np.radians(fov_degrees) / 2) * 2)
    return np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                    np.float32)


def letterbox_frame(rgb: np.ndarray, out_h: int, out_w: int):
    """Aspect-preserving resize (INTER_AREA) onto a zero canvas; returns the
    canvas and the (scale, x_offset, y_offset) mapping original -> canvas
    pixels."""
    from metrabs_tpu_torch.data import cvfree
    h, w = rgb.shape[:2]
    s = min(out_h / h, out_w / w)
    nh, nw = int(round(h * s)), int(round(w * s))
    resized = cvfree.resize(rgb, (nw, nh), interpolation=cvfree.INTER_AREA)
    canvas = np.zeros((out_h, out_w, 3), np.uint8)
    oy, ox = (out_h - nh) // 2, (out_w - nw) // 2
    canvas[oy:oy + nh, ox:ox + nw] = resized
    return canvas, s, ox, oy


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--video', required=True)
    parser.add_argument('--package', default=None)
    parser.add_argument('--out', default=None,
                        help='overlay video, mp4v in .mp4, .avi or .mkv')
    parser.add_argument('--num-aug', type=int, default=2)
    parser.add_argument('--skeleton', default='')
    parser.add_argument('--fov', type=float, default=55.0)
    parser.add_argument('--fast-load', action='store_true',
                        help='accepted for JAX compatibility; does nothing here')
    parser.add_argument('--frame-batch', type=int, default=8)
    parser.add_argument('--max-frames', type=int, default=0)
    parser.add_argument('--max-boxes', type=int, default=8)
    parser.add_argument(
        '--letterbox', default=None,
        help='HxW canonical frame size (e.g. 1080x1920): resize+pad frames '
             'and transform intrinsics so any source shares one shape')
    parser.add_argument(
        '--stream', type=int, default=0,
        help='run K frame-batches per estimator call (detect_poses_stream). '
             'Requires the camera to be constant over the video.')
    parser.add_argument('--device', default='cuda',
                        help="the device to estimate on (default cuda; 'cpu' for a CPU run)")
    args = parser.parse_args(argv)
    if args.out and os.path.splitext(args.out)[1].lower() not in ('.mp4', '.avi', '.mkv'):
        raise NotImplementedError(
            f'--out {args.out}: the port writes mp4v into .mp4, .avi or .mkv only')
    letterbox_hw = None
    if args.letterbox:
        lh, lw = args.letterbox.lower().split('x')
        letterbox_hw = (int(lh), int(lw))

    from metrabs_tpu_torch.apps import demo_image
    from metrabs_tpu_torch.apps.predict_common import to_host
    from metrabs_tpu_torch.data import video
    estimator = demo_image.load_estimator(args.package, args.device, args.fast_load)

    if args.stream and estimator.detector is None:
        raise SystemExit('--stream requires a detector-equipped model')

    source = video.index(args.video)
    fps = source.fps or 30.0
    writer = None
    edges = estimator.skeletons.joint_edges(args.skeleton)

    n_frames = 0
    n_poses_total = 0

    def prepare(batch):
        """Letterbox + pad a frame list into a dispatchable batch dict."""
        n_real = len(batch)
        intrinsics = None
        if letterbox_hw is not None:
            lh, lw = letterbox_hw
            boxed = [letterbox_frame(rgb, lh, lw) for rgb in batch]
            frames_in = [b[0] for b in boxed]
            # K' = shift/scale @ K_fov(original size): the letterboxed
            # canvas keeps the original camera's geometry exactly.
            intrinsics = np.stack([
                np.array([[s, 0, ox], [0, s, oy], [0, 0, 1]], np.float32)
                @ fov_intrinsics(args.fov, *rgb.shape[:2])
                for rgb, (_, s, ox, oy) in zip(batch, boxed)])
            unmaps = [(s, ox, oy) for _, s, ox, oy in boxed]
        else:
            frames_in = batch
            unmaps = [(1.0, 0, 0)] * n_real
        # Pad the trailing partial batch to the full --frame-batch so every
        # call has one shape; padded rows are dropped.
        while len(frames_in) < args.frame_batch:
            frames_in = frames_in + [frames_in[-1]]
            if intrinsics is not None:
                intrinsics = np.concatenate(
                    [intrinsics, intrinsics[-1:]], axis=0)
        return dict(images=np.stack(frames_in), intrinsics=intrinsics,
                    unmaps=unmaps, n_real=n_real, rgbs=batch)

    def dispatch_one(images, intrinsics):
        if estimator.detector is not None:
            out = estimator.detect_poses_batched(
                images, num_aug=args.num_aug, skeleton=args.skeleton,
                default_fov_degrees=args.fov, intrinsic_matrix=intrinsics,
                max_detections=args.max_boxes)
        else:
            h, w = images.shape[1:3]
            boxes = np.tile(
                np.array([[[w * .25, h * .05, w * .5, h * .9]]], np.float32),
                (images.shape[0], 1, 1))
            out = estimator.estimate_poses_batched(
                images, boxes, num_aug=args.num_aug, skeleton=args.skeleton,
                default_fov_degrees=args.fov, intrinsic_matrix=intrinsics)
        return {key: to_host(val) for key, val in out.items()}

    def dispatch_stream(prepared):
        """K prepared batches in one call. Stream camera args are shared
        across K, so all letterboxed intrinsics must agree: true for any
        fixed-size source."""
        intr0 = prepared[0]['intrinsics']
        for p in prepared[1:]:
            same = ((intr0 is None and p['intrinsics'] is None)
                    or (intr0 is not None and p['intrinsics'] is not None
                        and np.allclose(intr0, p['intrinsics'])))
            if not same:
                raise SystemExit(
                    '--stream needs constant intrinsics across batches '
                    '(source frame size changed mid-video); rerun without '
                    '--stream or with --letterbox')
        k_real = len(prepared)
        while len(prepared) < args.stream:  # pad to K
            prepared = prepared + [prepared[-1]]
        images_k = np.stack([p['images'] for p in prepared])
        out = estimator.detect_poses_stream(
            images_k, num_aug=args.num_aug, skeleton=args.skeleton,
            default_fov_degrees=args.fov, intrinsic_matrix=intr0,
            max_detections=args.max_boxes)
        # One device->host copy per output array, then host-side slicing.
        out_np = {key: to_host(val) for key, val in out.items()}
        return [{key: val[k] for key, val in out_np.items()}
                for k in range(k_real)]

    def render(prep, result):
        nonlocal n_frames, n_poses_total, writer
        n_real = prep['n_real']
        poses2d = np.array(result['poses2d'])[:n_real]
        valid = np.asarray(result['valid'])[:n_real]
        # Map overlay coordinates back to original-frame pixels.
        for bi, (s, ox, oy) in enumerate(prep['unmaps']):
            poses2d[bi, ..., 0] = (poses2d[bi, ..., 0] - ox) / s
            poses2d[bi, ..., 1] = (poses2d[bi, ..., 1] - oy) / s
        for bi, rgb in enumerate(prep['rgbs']):
            n_poses_total += int(valid[bi].sum())
            if args.out:
                if writer is None:
                    writer = video.VideoWriter(args.out, fps, (rgb.shape[1], rgb.shape[0]),
                                               'mp4v')
                writer.write(demo_image.draw_poses(rgb, poses2d[bi][valid[bi]], edges))
        n_frames += n_real

    frames = video.iter_frames(args.video)
    batch = []
    pending = []
    done = False
    try:
        while not done:
            frame = next(frames, None)
            ok = frame is not None
            if ok:
                batch.append(frame)
            # Stop reading when the stream ends or the frame budget is
            # reached, but always flush the pending partial batch first.
            read_frames = n_frames + sum(p['n_real'] for p in pending)
            done = (not ok) or bool(
                args.max_frames and read_frames + len(batch) >= args.max_frames)
            if done and args.max_frames:
                batch = batch[:max(0, args.max_frames - read_frames)]
            if batch and (len(batch) == args.frame_batch or done):
                pending.append(prepare(batch))
                batch = []
            if pending and (len(pending) == max(1, args.stream) or done):
                if args.stream:
                    for prep, res in zip(pending, dispatch_stream(pending)):
                        render(prep, res)
                else:
                    for prep in pending:
                        render(prep, dispatch_one(prep['images'],
                                                  prep['intrinsics']))
                pending = []
    finally:
        frames.close()
        if writer is not None:
            writer.close()
    print(json.dumps({'frames': n_frames, 'total_poses': n_poses_total}))


if __name__ == '__main__':
    main()
