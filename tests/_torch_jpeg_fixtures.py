"""Writes the JPEG fixtures of the port's decoder, `tests/torch_fixtures/
jpeg/*.jpg`, with cv2, and `manifest.json`: for each file the SHA-256 and
shape of `cv2.imread(path, cv2.IMREAD_COLOR)` converted to RGB. The card's
machine has no cv2; `chip_smoke.py` holds the decoder to these hashes there.

    python tests/_torch_jpeg_fixtures.py

The set: the five chroma samplings and gray, progressive, restart
intervals, odd sizes down to 1x1, qualities 30 and 100, EXIF orientations
1-8 (an APP1 segment spliced in after SOI), and four full-size frames of
synthetic content: a portrait 1080x1920 (3DPW's frames), a 1000x1002
(Human3.6M's), a 2048x2048 and a landscape 1920x1080 (MPI-INF-3DHP's test
sequences TS1-4 and TS5-6), each at most 400 KiB.
"""

from __future__ import annotations

import hashlib
import json
import struct
from pathlib import Path

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parent / 'torch_fixtures' / 'jpeg'
MANIFEST = FIXTURE_DIR / 'manifest.json'
FRAME_3DPW = 'frame_3dpw_1080x1920.jpg'  # width x height, portrait
FRAME_H36M = 'frame_h36m_1000x1002.jpg'
FRAME_3DHP_TS1 = 'frame_3dhp_2048x2048.jpg'  # MPI-INF-3DHP's TS1-4 frames
FRAME_3DHP_TS5 = 'frame_3dhp_1920x1080.jpg'  # its TS5-6 frames (landscape)
MAX_FRAME_BYTES = 400 * 1024


def rgb_digest(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def synthetic_image(height: int, width: int, seed: int, noise: float = 20.0,
                    channels: int = 3) -> np.ndarray:
    """Smooth colour waves, a few flat discs and Gaussian noise, uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:height, :width].astype(np.float32)
    scale = max(height, width) / 64
    im = np.stack([128 + 90 * np.sin(x / (7 * scale) + k) * np.cos(y / (5 * scale) - k)
                   for k in range(channels)], -1)
    for _ in range(6):
        cy, cx = rng.uniform(0, height), rng.uniform(0, width)
        radius = rng.uniform(0.05, 0.2) * max(height, width)
        im[(y - cy) ** 2 + (x - cx) ** 2 < radius ** 2] = rng.uniform(20, 235, channels)
    im += rng.normal(0, noise, im.shape)
    return np.clip(im, 0, 255).astype(np.uint8)


def exif_app1(orientation: int, little_endian: bool) -> bytes:
    """An APP1 Exif segment whose IFD0 holds one Orientation entry."""
    bo = '<' if little_endian else '>'
    tiff = ((b'II' if little_endian else b'MM') + struct.pack(bo + 'HI', 42, 8)
            + struct.pack(bo + 'H', 1) + struct.pack(bo + 'HHI', 0x0112, 3, 1)
            + struct.pack(bo + 'HH', orientation, 0) + struct.pack(bo + 'I', 0))
    body = b'Exif\0\0' + tiff
    return b'\xff\xe1' + struct.pack('>H', len(body) + 2) + body


def fixture_specs():
    """(name, height, width, gray, encode options, EXIF orientation or None)."""
    import cv2
    sampling = dict(s444=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                    s422=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                    s420=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                    s440=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                    s411=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)
    q, prog, rst, sf = (cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_PROGRESSIVE,
                        cv2.IMWRITE_JPEG_RST_INTERVAL, cv2.IMWRITE_JPEG_SAMPLING_FACTOR)
    specs = [(f'{name}_48x80.jpg', 48, 80, False, {q: 90, sf: value}, None)
             for name, value in sampling.items()]
    specs += [
        ('gray_48x80.jpg', 48, 80, True, {q: 90}, None),
        ('progressive_s420_61x75.jpg', 61, 75, False, {q: 85, prog: 1}, None),
        ('progressive_gray_33x47.jpg', 33, 47, True, {q: 85, prog: 1}, None),
        ('restart_s420_70x90.jpg', 70, 90, False, {q: 85, rst: 3}, None),
        ('restart_progressive_s422_41x57.jpg', 41, 57, False,
         {q: 85, rst: 2, prog: 1, sf: sampling['s422']}, None),
        ('odd_s420_67x93.jpg', 67, 93, False, {q: 90}, None),
        ('odd_s440_93x67.jpg', 93, 67, False, {q: 90, sf: sampling['s440']}, None),
        ('odd_s422_1x1.jpg', 1, 1, False, {q: 90, sf: sampling['s422']}, None),
        ('odd_s420_1x1.jpg', 1, 1, False, {q: 90}, None),
        ('odd_gray_1x1.jpg', 1, 1, True, {q: 90}, None),
        ('odd_s420_2x3.jpg', 2, 3, False, {q: 90}, None),
        ('quality30_s420_64x64.jpg', 64, 64, False, {q: 30}, None),
        ('quality100_s444_64x64.jpg', 64, 64, False, {q: 100, sf: sampling['s444']}, None),
    ]
    specs += [(f'exif_orientation{o}_40x64.jpg', 40, 64, False, {q: 90}, o) for o in range(1, 9)]
    specs += [(FRAME_3DPW, 1920, 1080, False, {q: 85}, None),
              (FRAME_H36M, 1002, 1000, False, {q: 85}, None),
              (FRAME_3DHP_TS1, 2048, 2048, False, {q: 75}, None),
              (FRAME_3DHP_TS5, 1080, 1920, False, {q: 75}, None)]
    return specs


def write_fixtures() -> dict:
    import cv2
    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for i, (name, height, width, gray, options, orientation) in enumerate(fixture_specs()):
        full_size = height * width > 1e6
        im = synthetic_image(height, width, seed=i, noise=6.0 if full_size else 20.0,
                             channels=1 if gray else 3)
        params = [v for kv in options.items() for v in kv]
        ok, buf = cv2.imencode('.jpg', im[..., 0] if gray else im[..., ::-1], params)
        assert ok, name
        data = buf.tobytes()
        if orientation is not None:
            data = data[:2] + exif_app1(orientation, little_endian=orientation % 2 == 0) + data[2:]
        if full_size and len(data) > MAX_FRAME_BYTES:
            raise ValueError(f'{name}: {len(data)} bytes, above {MAX_FRAME_BYTES}')
        path = FIXTURE_DIR / name
        path.write_bytes(data)
        rgb = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        manifest[name] = dict(sha256_rgb=rgb_digest(rgb), shape=list(rgb.shape),
                              file_sha256=hashlib.sha256(data).hexdigest())
    MANIFEST.write_text(json.dumps(manifest, indent=1, sort_keys=True) + '\n')
    return manifest


def read_manifest() -> dict:
    return json.loads(MANIFEST.read_text())


if __name__ == '__main__':
    written = write_fixtures()
    total = sum((FIXTURE_DIR / n).stat().st_size for n in written)
    print(f'{len(written)} fixtures, {total / 1024:.1f} KiB, in {FIXTURE_DIR}')
