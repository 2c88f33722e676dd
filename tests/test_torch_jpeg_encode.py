"""The port's host JPEG encoder (`metrabs_tpu_torch/csrc/jpeg_encode.cpp`
through `data/jpeg.py::encode`) against `cv2.imencode('.jpg', bgr)` at
OpenCV's defaults, byte for byte: on minted images of every size class the
4:2:0 edge handling distinguishes (1x1 to 1080x1920, odd widths and
heights), at qualities 1-100, in gray, on decoded fixtures, against the
manifest that `chip_smoke.py` checks on the card, on threads; and
`improc.imwrite` round-trips through the port's decoder and cv2's.
"""

import hashlib
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import pytest

from _torch_jpeg_fixtures import FIXTURE_DIR, read_manifest
from _torch_video_fixtures import ENCODE_CASES, ENCODE_DIR, ROOT
from metrabs_tpu_torch.data import improc, jpeg

sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the fixture cases' minting, shared with the card)

SIZES = [(1, 1), (2, 3), (17, 33), (67, 93), (48, 80), (1080, 1920), (8, 8), (9, 17), (16, 15),
         (31, 1), (1, 40)]


def cv2_encode(rgb: np.ndarray, quality: int = 95) -> bytes:
    bgr = rgb if rgb.ndim == 2 else rgb[..., ::-1]
    ok, buf = cv2.imencode('.jpg', np.ascontiguousarray(bgr), [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize('size', SIZES, ids=lambda s: f'{s[0]}x{s[1]}')
@pytest.mark.parametrize('content', ['noise', 'waves'])
def test_encode_equals_cv2(size, content):
    case = dict(kind=content, height=size[0], width=size[1], source=sum(size))
    rgb = chip_smoke.encode_case_image(ROOT, case)
    assert jpeg.encode(rgb) == cv2_encode(rgb)


@pytest.mark.parametrize('quality', [1, 10, 30, 49, 50, 51, 75, 90, 99, 100])
def test_encode_every_quality_equals_cv2(quality):
    rgb = chip_smoke.encode_case_image(ROOT, dict(kind='waves', height=41, width=57,
                                                   source=quality))
    assert jpeg.encode(rgb, quality) == cv2_encode(rgb, quality)


@pytest.mark.parametrize('shape', [(1, 1), (33, 47), (64, 64), (1, 1, 1), (19, 23, 1)])
def test_encode_gray_equals_cv2(shape):
    gray = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    assert jpeg.encode(gray) == cv2_encode(gray.reshape(shape[:2]))


@pytest.mark.parametrize('name', ['frame_3dpw_1080x1920.jpg', 'frame_h36m_1000x1002.jpg',
                                  'odd_s420_67x93.jpg', 's444_48x80.jpg', 'gray_48x80.jpg'])
def test_encode_decoded_fixture_equals_cv2(name):
    rgb = improc.imread(str(FIXTURE_DIR / name))
    assert jpeg.encode(rgb) == cv2_encode(rgb)


def test_encode_extremes_equal_cv2():
    """Flat black and white, saturated colours and a checkerboard, where the
    quantiser's rounding and the largest coefficients are met."""
    checker = (np.indices((40, 56)).sum(0) % 2 * 255).astype(np.uint8)
    for rgb in (np.zeros((24, 40, 3), np.uint8), np.full((24, 40, 3), 255, np.uint8),
                np.stack([checker, 255 - checker, checker], -1),
                np.tile(np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8), (9, 11, 1))):
        for quality in (1, 95, 100):
            assert jpeg.encode(rgb, quality) == cv2_encode(rgb, quality)


def test_manifest_hashes_regenerate_equal():
    """Every case of the manifest that chip_smoke.py holds the card to
    encodes to the recorded SHA-256, and the manifest lists ENCODE_CASES."""
    cases = json.loads((ENCODE_DIR / 'manifest.json').read_text())['cases']
    assert [(c['kind'], c['height'], c['width'], c['source'], c['quality'])
            for c in cases] == [tuple(c) for c in ENCODE_CASES]
    for case in cases:
        rgb = chip_smoke.encode_case_image(ROOT, case)
        data = jpeg.encode(rgb, case['quality'])
        assert hashlib.sha256(data).hexdigest() == case['sha256'], case
        assert data == cv2_encode(rgb, case['quality'])


def test_header_segments_in_libjpeg_order():
    data = jpeg.encode(np.zeros((17, 33, 3), np.uint8))
    markers, pos = [], 2
    while data[pos + 1] != 0xDA:
        length = int.from_bytes(data[pos + 2:pos + 4], 'big')
        markers.append((data[pos + 1], length))
        pos += 2 + length
    assert data[:2] == b'\xff\xd8' and data[-2:] == b'\xff\xd9'
    assert markers == [(0xE0, 16), (0xDB, 67), (0xDB, 67), (0xC0, 17)] + [(0xC4, n) for n in (
        31, 181, 31, 181)]
    assert data[6:11] == b'JFIF\0'


def test_encode_on_threads():
    images = [chip_smoke.encode_case_image(ROOT, dict(kind='waves', height=120, width=160,
                                                      source=k)) for k in range(8)]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(jpeg.encode, images))
    assert got == [cv2_encode(im) for im in images]


def test_encode_refuses_bad_input():
    with pytest.raises(ValueError, match='uint8'):
        jpeg.encode(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match='image'):
        jpeg.encode(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError, match='65535'):
        jpeg.encode(np.zeros((0, 4, 3), np.uint8))


@pytest.mark.parametrize('ext', ['.jpg', '.jpeg', '.png'])
def test_imwrite_round_trips(tmp_path, ext):
    rgb = chip_smoke.encode_case_image(ROOT, dict(kind='waves', height=45, width=61, source=3))
    path = tmp_path / f'out{ext}'
    improc.imwrite(str(path), rgb)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
    got = improc.imread(str(path))
    np.testing.assert_array_equal(got, want)
    if ext == '.png':
        np.testing.assert_array_equal(got, rgb)
        assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED).shape == rgb.shape
    else:
        assert Path(path).read_bytes() == cv2_encode(rgb)
        assert cv2.imwrite(str(tmp_path / f'cv{ext}'), rgb[..., ::-1])
        assert (tmp_path / f'cv{ext}').read_bytes() == Path(path).read_bytes()


def test_imwrite_refuses_other_formats(tmp_path):
    with pytest.raises(NotImplementedError, match='.jpg'):
        improc.imwrite(str(tmp_path / 'x.bmp'), np.zeros((2, 2, 3), np.uint8))


def test_decode_fixture_manifest_still_holds():
    """The encoder's build beside the decoder's leaves the decoder's numbers
    as they were."""
    name = 'frame_3dpw_1080x1920.jpg'
    got = improc.imread(str(FIXTURE_DIR / name))
    assert hashlib.sha256(got.tobytes()).hexdigest() == read_manifest()[name]['sha256_rgb']
