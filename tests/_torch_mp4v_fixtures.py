"""Writes the mp4v fixtures of the port's video layer with cv2, which the
card's machine lacks (`chip_smoke.py` holds the port's decoder to the
recorded hashes there):

- `tests/torch_fixtures/mp4v/*.mp4|*.avi|*.mkv`: MPEG-4 Part 2 clips
  written by `cv2.VideoWriter` (FFmpeg's mpeg4 encoder, FourCC `mp4v`: an
  I-VOP every 12 frames, so each clip of 14 frames crosses a GOP) from
  shifted copies of the portrait JPEG fixture, in the three containers.
  cv2 rounds an odd mp4v frame size down to even (asked for 93x67 it
  writes 92x66), so the small clip is 92x66, which is not a multiple of 16
  either way;
- `manifest.json` (whose Xvid entries `tests/_torch_h264_fixtures.py`
  writes): per file cv2's frame count, frame rate and size, and per
  frame the SHA-256 of FFmpeg's luma plane (`cv2.CAP_PROP_CONVERT_RGB` 0,
  [H, W] uint8), of `cv2.VideoCapture`'s frame (as RGB) and of the packet
  (`cv2.CAP_PROP_FORMAT` -1).

    python tests/_torch_mp4v_fixtures.py
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
MP4V_DIR = ROOT / 'tests' / 'torch_fixtures' / 'mp4v'
FRAME_3DPW = ROOT / 'tests' / 'torch_fixtures' / 'jpeg' / 'frame_3dpw_1080x1920.jpg'
SHIFT = (3, 4)  # (down, right) pixels per frame, with wraparound

# (stem, frames, fps, (width, height) or None for the fixture's size)
SIZES = [
    ('mp4v_92x66', 14, 10.0, (92, 66)),
    ('mp4v_320x568', 14, 30000 / 1001, (320, 568)),
    ('mp4v_1080x1920', 14, 25.0, None),
]
CONTAINERS = ('.mp4', '.avi', '.mkv')
CASES = [(stem + ext, n, fps, size) for stem, n, fps, size in SIZES for ext in CONTAINERS]
# Xvid-stamped clips, written by tests/_torch_h264_fixtures.py with libxvidcore:
# (stem, fps, (width, height) or None, quantiser), in AVI (FourCC XVID) and Matroska.
XVID_SIZES = [('xvid_96x66', 10.0, (96, 66), 4), ('xvid_320x568', 25.0, (320, 568), 4),
              ('xvid_1080x1920', 25.0, None, 8)]
XVID_CASES = [(stem + ext, fps, size, q) for stem, fps, size, q in XVID_SIZES
              for ext in ('.avi', '.mkv')]


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes() if isinstance(a, np.ndarray)
                          else a).hexdigest()


def shifted_frames(n: int, size=None):
    """RGB frames: the portrait fixture (resized with INTER_AREA to `size`
    if given), shifted by SHIFT pixels per frame."""
    import cv2
    base = cv2.imread(str(FRAME_3DPW), cv2.IMREAD_COLOR)[..., ::-1]
    if size is not None:
        base = cv2.resize(base, size, interpolation=cv2.INTER_AREA)
    return [np.ascontiguousarray(np.roll(base, (SHIFT[0] * k, SHIFT[1] * k), axis=(0, 1)))
            for k in range(n)]


def cv2_write(path: str, frames, fps: float) -> None:
    import cv2
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*'mp4v'), fps,
                             (w, h))
    assert writer.isOpened(), path
    for frame in frames:
        writer.write(frame[..., ::-1])
    writer.release()


def cv2_read(path: str, params=()):
    """cv2's frames of a file (as read, BGR or raw per the params) and its
    metadata."""
    import cv2
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG, list(params))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame.copy())
    meta = dict(frame_count=cap.get(cv2.CAP_PROP_FRAME_COUNT), fps=cap.get(cv2.CAP_PROP_FPS),
                width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    cap.release()
    return frames, meta


def cv2_lumas(path: str):
    import cv2
    return cv2_read(path, [cv2.CAP_PROP_CONVERT_RGB, 0])[0]


def cv2_packets(path: str):
    import cv2
    return [p.tobytes() for p in cv2_read(path, [cv2.CAP_PROP_FORMAT, -1])[0]]


def write_fixtures() -> None:
    MP4V_DIR.mkdir(parents=True, exist_ok=True)
    path = MP4V_DIR / 'manifest.json'
    manifest = json.loads(path.read_text()) if path.exists() else {}  # keeps the Xvid entries
    for name, n, fps, size in CASES:
        path = MP4V_DIR / name
        frames = shifted_frames(n, size)
        cv2_write(path, frames, fps)
        bgr, meta = cv2_read(path)
        manifest[name] = dict(
            written=dict(frames=n, fps=fps, width=frames[0].shape[1], height=frames[0].shape[0]),
            cv2=dict(meta, frames_read=len(bgr)),
            luma_sha256=[sha256(y) for y in cv2_lumas(path)],
            rgb_sha256=[sha256(f[..., ::-1]) for f in bgr],
            packet_sha256=[sha256(p) for p in cv2_packets(path)],
            file_sha256=sha256(path.read_bytes()))
    (MP4V_DIR / 'manifest.json').write_text(json.dumps(manifest, indent=1) + '\n')


if __name__ == '__main__':
    write_fixtures()
