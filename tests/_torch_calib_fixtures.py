"""Writes the checkerboard fixtures of the port's calibration,
`tests/torch_fixtures/calib/{a,b}/*`, and `manifest.json` with what cv2
answers on them. The card's machine has no cv2; `chip_smoke.py` holds the
port to these numbers there and re-renders one view of (b) against its
hash.

    python tests/_torch_calib_fixtures.py

The set:
 (a) `a/calib_{0..7}.png`: the 8 views of tests/test_calibrate.py (its
     poses, its cv2 warp of a flat 6x9 board, its 5x5 Gaussian blur), 640x480
     gray PNG, 25 mm squares; `a/calib_8_partial.png`: a colour PNG of a board
     whose last column of inner corners lies outside the frame (numpy
     renderer, no lens distortion).
 (b) `b/view_{0..7}.jpg`: 1920x1080 colour JPEGs (the port's encoder, equal
     to cv2.imwrite's) of a 6x9 board of 40 mm squares through K_TRUE and
     DIST_TRUE, drawn by `utils.calibration.render_checkerboard` (numpy and
     the port's inverse lens map); `b/view_8_empty.jpg`: a scene with no
     board.
For every view the manifest records the file's and the gray image's
SHA-256 (`cv2.imread(path, IMREAD_GRAYSCALE)`), `cv2.findChessboardCorners`'s
found flag and corners, and the corners after calibrate_camera.py's
refinement (`cv2.cornerSubPix` with its window rule); for each directory,
what `metrabs_tpu.apps.calibrate_camera.main` writes (cv2.calibrateCamera on
those corners) and the arguments it was run with; for the rendered views,
the renderer's arguments and the SHA-256 of its RGB output.
"""

from __future__ import annotations

import hashlib
import json
import math
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / 'tests'))

FIXTURE_DIR = REPO / 'tests' / 'torch_fixtures' / 'calib'
MANIFEST = FIXTURE_DIR / 'manifest.json'
PATTERN = (9, 6)  # (cols, rows) inner corners, calibrate_camera.py's defaults
K_TRUE = [[1400.0, 0.0, 968.0], [0.0, 1400.0, 532.0], [0.0, 0.0, 1.0]]
DIST_TRUE = [-0.25, 0.08, 0.0012, -0.0008, 0.0]
SQUARE_B = 40.0
# (rotation axis, degrees, the board's centre in camera coordinates in mm):
# tilts of 20-40 degrees at 0.74-1.0 m, the board in the centre, the four
# corners and the four sides of the frame.
VIEWS_B = [((1, 0.3, 0), 20, (0, 0, 900)), ((1, -1, 0.2), 35, (-390, -200, 900)),
           ((-1, -1, 0.1), 35, (390, -200, 900)), ((1, 1, -0.3), 35, (-380, 210, 880)),
           ((-1, 1, 0.3), 35, (400, 200, 900)), ((0, 1, 0.2), 40, (-350, 20, 850)),
           ((0.2, -1, 0), 40, (360, -20, 850)), ((1, 0, 0.5), 40, (20, 230, 820))]
K_PARTIAL = [[520.0, 0.0, 320.0], [0.0, 520.0, 240.0], [0.0, 0.0, 1.0]]


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def pose(axis, degrees, centre, square: float):
    """(quaternion, translation) of a board whose centre sits at `centre`,
    rounded to the values the manifest keeps."""
    from metrabs_tpu_torch.utils import calibration

    a = np.asarray(axis, float)
    a = a / np.linalg.norm(a)
    half = math.radians(degrees) / 2
    q = [round(math.cos(half), 6)] + [round(float(x), 6) for x in a * math.sin(half)]
    rot = calibration.rotation_from_quaternion(q)
    mid = np.array([(PATTERN[0] - 1) * square / 2, (PATTERN[1] - 1) * square / 2, 0.0])
    t = [round(float(x), 3) for x in np.asarray(centre, float) - rot @ mid]
    return q, t


def empty_scene(h: int, w: int) -> np.ndarray:
    """A table-top with a few flat objects and no board (RGB uint8)."""
    rng = np.random.default_rng(14)
    y, x = np.mgrid[:h, :w].astype(np.float64)
    img = np.stack([96 + 30 * x / w, 110 + 20 * y / h, 124 - 25 * x / w], -1)
    for _ in range(12):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(0.03, 0.15, 2) * h
        inside = ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 < 1
        img[inside] = rng.uniform(20, 235, 3)
    for _ in range(6):
        y0, x0 = rng.integers(0, h - 100), rng.integers(0, w - 100)
        img[y0:y0 + rng.integers(20, 100), x0:x0 + rng.integers(20, 100)] = rng.uniform(20, 235, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def app_refine(cv2, gray, corners):
    """metrabs_tpu/apps/calibrate_camera.py::find_corners's refinement of
    found corners: (half window, refined corners)."""
    pts = corners.reshape(PATTERN[1], PATTERN[0], 2)
    spacing = min(float(np.median(np.linalg.norm(np.diff(pts, axis=1), axis=-1))),
                  float(np.median(np.linalg.norm(np.diff(pts, axis=0), axis=-1))))
    half = int(np.clip(spacing * 0.4, 2, 11))
    criteria = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3)
    return half, cv2.cornerSubPix(gray, corners.copy(), (half, half), (-1, -1), criteria)


def main() -> None:
    import cv2

    import test_calibrate
    from metrabs_tpu.apps import calibrate_camera as jax_app
    from metrabs_tpu_torch.data import cvfree, jpeg
    from metrabs_tpu_torch.utils import calibration

    for sub in ('a', 'b'):
        (FIXTURE_DIR / sub).mkdir(parents=True, exist_ok=True)
        for old in (FIXTURE_DIR / sub).iterdir():
            old.unlink()
    views = {}

    # (a): tests/test_calibrate.py's views, then the partial board.
    test_calibrate._render_views(FIXTURE_DIR / 'a')
    for i in range(8):
        views[f'a/calib_{i}.png'] = dict(made_by='tests/test_calibrate.py::_render_views, '
                                                 f'pose {i}')
    q, t = pose((1, 0.4, 0), 15, (275, 0, 600), 25.0)
    part = calibration.render_checkerboard((480, 640), K_PARTIAL, [0.0] * 5, q, t,
                                           square=25.0, margin=20.0)
    cvfree.write_png(str(FIXTURE_DIR / 'a' / 'calib_8_partial.png'), part)
    views['a/calib_8_partial.png'] = dict(
        made_by='render_checkerboard', render=dict(
            image_size=[480, 640], intrinsic_matrix=K_PARTIAL, distortion_coeffs=[0.0] * 5,
            quaternion=q, translation=t, square=25.0, margin=20.0),
        sha256_rgb=sha256(part.tobytes()))

    # (b): the board through the lens, then a scene without a board.
    for i, (axis, degrees, centre) in enumerate(VIEWS_B):
        q, t = pose(axis, degrees, centre, SQUARE_B)
        render = dict(image_size=[1080, 1920], intrinsic_matrix=K_TRUE,
                      distortion_coeffs=DIST_TRUE, quaternion=q, translation=t,
                      square=SQUARE_B)
        rgb = calibration.render_checkerboard(**render)
        data = jpeg.encode(rgb)
        ok, want = cv2.imencode('.jpg', rgb[..., ::-1])
        assert ok and want.tobytes() == data, 'the port\'s JPEG encoder differs from cv2\'s'
        (FIXTURE_DIR / 'b' / f'view_{i}.jpg').write_bytes(data)
        views[f'b/view_{i}.jpg'] = dict(made_by='render_checkerboard', render=render,
                                        sha256_rgb=sha256(rgb.tobytes()))
    empty = empty_scene(1080, 1920)
    (FIXTURE_DIR / 'b' / 'view_8_empty.jpg').write_bytes(jpeg.encode(empty))
    views['b/view_8_empty.jpg'] = dict(made_by='_torch_calib_fixtures.py::empty_scene',
                                       sha256_rgb=sha256(empty.tobytes()))

    for name, rec in views.items():
        path = FIXTURE_DIR / name
        gray = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        found, corners = cv2.findChessboardCorners(gray, PATTERN)
        rec.update(file_sha256=sha256(path.read_bytes()),
                   gray_sha256=sha256(gray.tobytes()), shape=list(gray.shape),
                   found=bool(found))
        if found:
            half, refined = app_refine(cv2, gray, corners)
            rec.update(corners=corners.reshape(-1, 2).astype(float).tolist(), half_window=half,
                       refined=refined.reshape(-1, 2).astype(float).tolist())

    runs = {}
    for sub, pattern, square in (('a', '*.png', 25.0), ('b', '*.jpg', SQUARE_B)):
        out = FIXTURE_DIR / f'{sub}_intrinsics.json'
        argv = ['--images', str(FIXTURE_DIR / sub / pattern), '--rows', str(PATTERN[1]),
                '--cols', str(PATTERN[0]), '--square-mm', str(square), '--out', str(out)]
        jax_app.main(argv)
        result = json.loads(out.read_text())
        out.unlink()
        runs[sub] = dict(images=f'{sub}/{pattern}', square_mm=square, result=result,
                         views=[n for n in sorted(views) if n.startswith(sub + '/')
                                and views[n]['found']])
    manifest = dict(cv2_version=cv2.__version__, pattern_size=PATTERN, k_true=K_TRUE,
                    dist_true=DIST_TRUE, views=views, calibrations=runs)
    MANIFEST.write_text(json.dumps(manifest, indent=1) + '\n')
    total = sum(p.stat().st_size for p in FIXTURE_DIR.rglob('*') if p.is_file())
    print(f'{len(views)} views, {total / 2 ** 20:.2f} MiB; found: '
          + ', '.join(n for n in sorted(views) if views[n]['found']))


if __name__ == '__main__':
    main()
