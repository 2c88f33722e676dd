#!/usr/bin/env python3
"""The port's mp4v encoder and decoder (`metrabs_tpu_torch.data.mpeg4`)
against cv2's FFmpeg on the same frames: 24 frames of the 1080x1920
portrait JPEG fixture, shifted (4, 3) px per frame, written at 25 fps into
an .mp4 by each. Prints one JSON object: per writer the encode time per
frame (median, one thread for the port; `cv2.VideoWriter.write` as cv2 runs
it, its colour conversion included), bytes per frame, the PSNR over RGB of
the frames `cv2.VideoCapture` reads back, and the decode time per frame of
the port's decoder (to RGB) and of `cv2.VideoCapture.read` on the cv2 file.

Needs cv2 with FFmpeg, so it runs on a development machine, not on the
card's, which has no cv2.

    python scripts/mp4v_vs_cv2_torch.py [--frames 24] [--out-dir runs/mp4v_vs_cv2]
"""

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'tests'))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse))


def main(argv=None):
    import cv2

    from _torch_mp4v_fixtures import shifted_frames
    from metrabs_tpu_torch.data import mpeg4, video

    parser = argparse.ArgumentParser()
    parser.add_argument('--frames', type=int, default=24)
    parser.add_argument('--out-dir', default=str(ROOT / 'runs' / 'mp4v_vs_cv2'))
    args = parser.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    frames = shifted_frames(args.frames)
    h, w = frames[0].shape[:2]
    result = {}

    path = os.path.join(args.out_dir, 'port.mp4')
    times = []
    with video.VideoWriter(path, 25.0, (w, h), 'mp4v') as writer:
        for frame in frames:
            t = time.perf_counter()
            writer.write(frame)
            times.append(time.perf_counter() - t)
    idx = video.index(path)
    decoder = mpeg4.Decoder(idx.config, path)
    dec_times = []
    for i in range(idx.n_frames):
        packet = idx.packet(i)
        t = time.perf_counter()
        decoder.decode(packet)
        dec_times.append(time.perf_counter() - t)
    result['port'] = dict(encode_ms=statistics.median(times) * 1e3,
                          decode_ms=statistics.median(dec_times) * 1e3,
                          bytes_per_frame=float(np.mean(idx.sizes)))

    path_cv2 = os.path.join(args.out_dir, 'cv2.mp4')
    writer = cv2.VideoWriter(path_cv2, cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*'mp4v'), 25.0,
                             (w, h))
    times = []
    for frame in frames:
        bgr = np.ascontiguousarray(frame[..., ::-1])
        t = time.perf_counter()
        writer.write(bgr)
        times.append(time.perf_counter() - t)
    writer.release()
    cap = cv2.VideoCapture(path_cv2, cv2.CAP_FFMPEG)
    dec_times = []
    while True:
        t = time.perf_counter()
        ok, _ = cap.read()
        if not ok:
            break
        dec_times.append(time.perf_counter() - t)
    cap.release()
    result['cv2'] = dict(encode_ms=statistics.median(times) * 1e3,
                         decode_ms=statistics.median(dec_times) * 1e3,
                         bytes_per_frame=float(np.mean(video.index(path_cv2).sizes)))

    for name, p in (('port', path), ('cv2', path_cv2)):
        cap = cv2.VideoCapture(p, cv2.CAP_FFMPEG)
        values = []
        for frame in frames:
            ok, bgr = cap.read()
            values.append(psnr(bgr[..., ::-1], frame))
        cap.release()
        result[name]['psnr_db'] = float(np.mean(values))
    result['frames'] = args.frames
    result['size'] = [w, h]
    print(json.dumps(result))


if __name__ == '__main__':
    main()
