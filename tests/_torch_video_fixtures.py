"""Writes the fixtures of the port's JPEG encoder and Motion JPEG video layer
with cv2, which the card's machine lacks (`chip_smoke.py` holds the port to
the recorded hashes there):

- `tests/torch_fixtures/jpeg_encode/manifest.json`: for each case (an image
  minted by `chip_smoke.encode_case_image` from a numpy seed, or a decoded
  JPEG fixture) the SHA-256 and length of `cv2.imencode('.jpg', bgr)` at
  OpenCV's defaults;
- `tests/torch_fixtures/video/*.avi|*.mkv`: Motion JPEG clips written by
  `cv2.VideoWriter` (FFmpeg) from shifted copies of the portrait JPEG
  fixture, and `manifest.json`: per file cv2's frame count, frame rate and
  size, the frames `cv2.VideoCapture` reads, and per packet the SHA-256 of
  `cv2.imdecode` of its bytes (RGB), in file order.

    python tests/_torch_video_fixtures.py
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
ENCODE_DIR = ROOT / 'tests' / 'torch_fixtures' / 'jpeg_encode'
VIDEO_DIR = ROOT / 'tests' / 'torch_fixtures' / 'video'
FRAME_3DPW = ROOT / 'tests' / 'torch_fixtures' / 'jpeg' / 'frame_3dpw_1080x1920.jpg'

# (kind, height, width, seed or fixture name, quality)
ENCODE_CASES = [
    ('noise', 1, 1, 0, 95), ('noise', 2, 3, 1, 95), ('noise', 17, 33, 2, 95),
    ('noise', 67, 93, 3, 95), ('noise', 48, 80, 4, 95), ('waves', 67, 93, 5, 95),
    ('waves', 48, 80, 6, 30), ('waves', 129, 257, 7, 100), ('waves', 1080, 1920, 8, 95),
    ('gray', 33, 47, 9, 95),
    ('fixture', 1920, 1080, 'frame_3dpw_1080x1920.jpg', 95),
    ('fixture', 1002, 1000, 'frame_h36m_1000x1002.jpg', 95),
    ('fixture', 67, 93, 'odd_s420_67x93.jpg', 95),
]

# (file name, frames, fps, (width, height) or None for the fixture's size)
VIDEO_CASES = [
    ('mjpg_1080x1920.avi', 3, 25.0, None),
    ('mjpg_1080x1920.mkv', 3, 25.0, None),
    ('mjpg_320x568_ntsc.mkv', 8, 30000 / 1001, (320, 568)),
    ('mjpg_320x568.avi', 8, 30.0, (320, 568)),
    ('mjpg_93x67.avi', 5, 10.0, (93, 67)),
    ('mjpg_93x67.mkv', 5, 10.0, (93, 67)),
]


def rgb_digest(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def clip_frames(n: int, size):
    """The clip's RGB frames: the portrait fixture (resized with INTER_AREA
    to `size` if given), shifted 24 px right per frame with wraparound."""
    import cv2
    base = cv2.imread(str(FRAME_3DPW), cv2.IMREAD_COLOR)[..., ::-1]
    if size is not None:
        base = cv2.resize(base, size, interpolation=cv2.INTER_AREA)
    return [np.ascontiguousarray(np.roll(base, 24 * k, axis=1)) for k in range(n)]


def write_encode_manifest() -> None:
    import cv2

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    cases = []
    for kind, h, w, source, quality in ENCODE_CASES:
        case = dict(kind=kind, height=h, width=w, source=source, quality=quality)
        im = chip_smoke.encode_case_image(ROOT, case)
        bgr = im if im.ndim == 2 else im[..., ::-1]
        data = cv2.imencode('.jpg', bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
        case.update(sha256=hashlib.sha256(data).hexdigest(), bytes=len(data))
        cases.append(case)
    ENCODE_DIR.mkdir(parents=True, exist_ok=True)
    (ENCODE_DIR / 'manifest.json').write_text(json.dumps(dict(cases=cases), indent=1) + '\n')


def write_videos() -> None:
    import cv2

    sys.path.insert(0, str(ROOT))
    from metrabs_tpu_torch.data import video

    VIDEO_DIR.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for name, n, fps, size in VIDEO_CASES:
        path = VIDEO_DIR / name
        frames = clip_frames(n, size)
        h, w = frames[0].shape[:2]
        writer = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*'MJPG'),
                                 fps, (w, h))
        assert writer.isOpened(), name
        for frame in frames:
            writer.write(frame[..., ::-1])
        writer.release()
        cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG)
        meta = dict(frame_count=cap.get(cv2.CAP_PROP_FRAME_COUNT), fps=cap.get(cv2.CAP_PROP_FPS),
                    width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                    height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
        n_read = 0
        while cap.read()[0]:
            n_read += 1
        cap.release()
        # The packets as the port's demuxer finds them, decoded by cv2.
        idx = video.index(str(path))
        packets = [idx.packet(i) for i in range(idx.n_frames)]
        manifest[name] = dict(
            written=dict(frames=n, fps=fps, width=w, height=h), cv2=dict(meta, frames_read=n_read),
            packet_sha256_rgb=[rgb_digest(cv2.imdecode(np.frombuffer(p, np.uint8),
                                                       cv2.IMREAD_COLOR)[..., ::-1])
                               for p in packets],
            file_sha256=hashlib.sha256(path.read_bytes()).hexdigest())
    (VIDEO_DIR / 'manifest.json').write_text(json.dumps(manifest, indent=1) + '\n')


if __name__ == '__main__':
    write_encode_manifest()
    write_videos()
