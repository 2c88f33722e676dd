"""The port's host JPEG decoder (`metrabs_tpu_torch/csrc/jpeg_decode.cpp`
through `data/jpeg.py`) against `cv2.imread(path, cv2.IMREAD_COLOR)` in RGB,
bit for bit: on every committed fixture (and its manifest hash, which is how
the card's machine, without cv2, checks it), on images cv2 encodes with
random sizes, qualities, samplings, progressive mode and restart intervals,
and on threads; Adobe CMYK, YCCK and RGB-coded files (the image fixtures
of `tests/torch_fixtures/images` against JAX's imread, and random Pillow
encodings) in colour and in gray. Truncated and corrupt files raise
ValueError naming the file, the unsupported kinds NotImplementedError, and
`imread` picks the decoder by the file's signature, not its name.
"""

import json
import struct
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import _torch_image_fixtures as image_fixtures
from _torch_jpeg_fixtures import FIXTURE_DIR, MANIFEST, exif_app1, read_manifest, rgb_digest
from metrabs_tpu.data import improc as jax_improc
from metrabs_tpu_torch.data import improc, jpeg

FIXTURES = sorted(read_manifest())
SAMPLINGS = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]


def cv2_rgb(data: bytes) -> np.ndarray:
    im = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(im, cv2.COLOR_BGR2RGB)


def encoded(shape, seed=0, options=None) -> bytes:
    im = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    params = [v for kv in (options or {}).items() for v in kv]
    ok, buf = cv2.imencode('.jpg', im, params)
    assert ok
    return buf.tobytes()


def test_manifest_covers_every_fixture_file():
    on_disk = sorted(p.name for p in FIXTURE_DIR.glob('*.jpg'))
    assert on_disk == FIXTURES and len(FIXTURES) >= 20
    assert json.loads(MANIFEST.read_text()).keys() == set(FIXTURES)


@pytest.mark.parametrize('name', FIXTURES)
def test_fixture_decodes_equal_to_cv2(name):
    path = str(FIXTURE_DIR / name)
    want = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    got = improc.imread(path)
    assert got.dtype == np.uint8 and got.flags['C_CONTIGUOUS']
    np.testing.assert_array_equal(got, want)
    entry = read_manifest()[name]
    assert list(got.shape) == entry['shape'] and rgb_digest(got) == entry['sha256_rgb']
    np.testing.assert_array_equal(got, jax_improc.imread(path))


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(height=st.integers(1, 70), width=st.integers(1, 70), quality=st.integers(1, 100),
       sampling=st.sampled_from(SAMPLINGS), progressive=st.booleans(),
       restart=st.integers(0, 4), gray=st.booleans(), smooth=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_random_encodings_decode_equal_to_cv2(height, width, quality, sampling, progressive,
                                             restart, gray, smooth, seed):
    rng = np.random.default_rng(seed)
    shape = (height, width) if gray else (height, width, 3)
    if smooth:  # low-frequency content: long zero runs and end-of-band runs
        base = rng.uniform(0, 255, (2, 2) + shape[2:])
        im = cv2.resize(base, (width, height), interpolation=cv2.INTER_LINEAR)
        im = np.clip(im + rng.normal(0, 2, im.shape), 0, 255).astype(np.uint8)
    else:
        im = rng.integers(0, 256, shape, dtype=np.uint8)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    ok, buf = cv2.imencode('.jpg', im, params)
    assert ok
    data = buf.tobytes()
    np.testing.assert_array_equal(jpeg.decode(data), cv2_rgb(data))


@pytest.mark.parametrize('little_endian', [True, False], ids=['II', 'MM'])
@pytest.mark.parametrize('orientation', list(range(0, 10)))
def test_exif_orientation_as_cv2_applies_it(orientation, little_endian):
    """All eight orientations in both byte orders; 0 and 9 leave the image."""
    data = encoded((24, 40, 3), seed=orientation)
    data = data[:2] + exif_app1(orientation, little_endian) + data[2:]
    got = jpeg.decode(data)
    np.testing.assert_array_equal(got, cv2_rgb(data))
    assert jpeg.header(data)[2] == orientation


def test_threads_decode_in_parallel_equal_to_serial():
    names = [n for n in FIXTURES if not n.startswith('frame_')] * 3
    data = [(FIXTURE_DIR / n).read_bytes() for n in names]
    with ThreadPoolExecutor(8) as pool:
        threaded = list(pool.map(jpeg.decode, data))
    for d, got in zip(data, threaded):
        np.testing.assert_array_equal(got, jpeg.decode(d))


@pytest.mark.parametrize('cut', [0.3, 0.6, 0.95, 'no_eoi'])
@pytest.mark.parametrize('progressive', [False, True])
def test_truncated_files_raise_value_error_with_the_path(tmp_path, cut, progressive):
    data = encoded((48, 64, 3), seed=1, options={cv2.IMWRITE_JPEG_PROGRESSIVE: int(progressive)})
    data = data[:-2] if cut == 'no_eoi' else data[:int(len(data) * cut)]
    path = tmp_path / 'truncated.jpg'
    path.write_bytes(data)
    with pytest.raises(ValueError, match='truncated.jpg'):
        improc.imread(str(path))


def _segments(data: bytes):
    """(marker, offset of its FF) of the segments before the first scan."""
    pos, out = 2, []
    while True:
        marker = data[pos + 1]
        out.append((marker, pos))
        if marker == 0xDA:
            return out
        pos += 2 + struct.unpack('>H', data[pos + 2:pos + 4])[0]


def _corrupted(kind: str) -> bytes:
    data = bytearray(encoded((48, 64, 3), seed=2))
    segments = dict(_segments(bytes(data)))
    if kind == 'no_soi':
        data[1] = 0xD9
    elif kind == 'bad_huffman_table':  # the first DHT's code counts over-subscribed
        at = segments[0xC4] + 5
        data[at:at + 2] = b'\x04\x04'
    elif kind == 'bad_segment_length':
        at = segments[0xDB] + 2
        data[at:at + 2] = b'\x00\x01'
    elif kind == 'scan_names_unknown_component':
        at = segments[0xDA] + 5
        data[at] = 0x7F
    elif kind == 'zero_height':
        at = segments[0xC0] + 5
        data[at:at + 2] = b'\x00\x00'
    elif kind == 'garbage_entropy':  # a marker in place of the entropy data
        at = segments[0xDA] + 2 + struct.unpack('>H', data[segments[0xDA] + 2:][:2])[0]
        data[at:at + 2] = b'\xff\xd9'
    return bytes(data)


@pytest.mark.parametrize('kind', ['no_soi', 'bad_huffman_table', 'bad_segment_length',
                                  'scan_names_unknown_component', 'zero_height',
                                  'garbage_entropy'])
def test_corrupt_files_raise_value_error_with_the_path(tmp_path, kind):
    path = tmp_path / f'{kind}.jpg'
    data = _corrupted(kind)
    path.write_bytes(data)
    if kind == 'no_soi':  # not a JPEG signature: imread refuses the format
        with pytest.raises(NotImplementedError, match='no_soi.jpg'):
            improc.imread(str(path))
        with pytest.raises(ValueError, match='no_soi'):
            jpeg.decode(data, str(path))
        return
    with pytest.raises(ValueError, match=f'{kind}.jpg'):
        improc.imread(str(path))


def _sof_variant(marker: int = None, precision: int = None) -> bytes:
    data = bytearray(encoded((16, 16, 3), seed=3))
    sof = dict(_segments(bytes(data)))[0xC0]
    if marker is not None:
        data[sof + 1] = marker
    if precision is not None:
        data[sof + 4] = precision
    return bytes(data)


def _rgb_coded() -> bytes:
    """A 4:4:4 file whose components are named R, G and B and that has no
    JFIF segment: libjpeg reads it as RGB-coded."""
    data = bytearray(encoded((16, 16, 3), seed=4, options={
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR: cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}))
    segments = dict(_segments(bytes(data)))
    for i, name in enumerate(b'RGB'):
        data[segments[0xC0] + 10 + 3 * i] = name
        data[segments[0xDA] + 5 + 2 * i] = name
    app0 = segments[0xE0]
    length = struct.unpack('>H', data[app0 + 2:app0 + 4])[0]
    return bytes(data[:app0] + data[app0 + 2 + length:])


def _cmyk() -> bytes:
    import io

    import PIL.Image
    out = io.BytesIO()
    PIL.Image.new('CMYK', (16, 16), (10, 20, 30, 40)).save(out, 'JPEG')
    return out.getvalue()


@pytest.mark.parametrize('kind', ['arithmetic', 'lossless', 'hierarchical', 'twelve_bit'])
def test_unsupported_kinds_raise_not_implemented(kind):
    data = dict(arithmetic=lambda: _sof_variant(marker=0xC9),
                lossless=lambda: _sof_variant(marker=0xC3),
                hierarchical=lambda: _sof_variant(marker=0xC5),
                twelve_bit=lambda: _sof_variant(precision=12))[kind]()
    with pytest.raises(NotImplementedError, match='not supported'):
        jpeg.decode(data, 'x.jpg')


@pytest.mark.parametrize('kind', ['rgb_coded', 'cmyk'])
def test_rgb_coded_and_cmyk_decode_equal_to_cv2(kind):
    """RGB by component IDs (no JFIF, no Adobe marker) and Pillow's Adobe
    CMYK, which the decoder refused before it read their colour spaces, in
    colour and in gray."""
    data = dict(rgb_coded=_rgb_coded, cmyk=_cmyk)[kind]()
    np.testing.assert_array_equal(jpeg.decode(data, 'x.jpg'), cv2_rgb(data))
    np.testing.assert_array_equal(
        jpeg.decode(data, 'x.jpg', gray=True),
        cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE))


def test_imread_dispatches_on_the_signature_not_the_name(tmp_path):
    im = np.random.default_rng(5).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    jpeg_named_png = str(tmp_path / 'a.png')
    (tmp_path / 'a.png').write_bytes(encoded((20, 30, 3), seed=5))
    png_named_jpg = str(tmp_path / 'b.jpg')
    cv2.imwrite(str(tmp_path / 'b.png'), im)
    (tmp_path / 'b.jpg').write_bytes((tmp_path / 'b.png').read_bytes())
    for path in (jpeg_named_png, png_named_jpg):
        want = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(improc.imread(path), want)
    np.testing.assert_array_equal(improc.image_extents(jpeg_named_png), [30, 20])
    (tmp_path / 'c.jpg').write_bytes(b'GIF89a' + bytes(20))
    assert cv2.imread(str(tmp_path / 'c.jpg')) is None  # a GIF with a 0x0 screen
    with pytest.raises(ValueError, match='GIF screen'):
        improc.imread(str(tmp_path / 'c.jpg'))
    (tmp_path / 'd.jpg').write_bytes(b'\x00\x00\x00\x0cjP  \r\n\x87\n' + bytes(20))
    with pytest.raises(NotImplementedError, match='not JPEG, PNG, WebP, TIFF'):
        improc.imread(str(tmp_path / 'd.jpg'))  # JPEG 2000, not yet read
    with pytest.raises(FileNotFoundError):
        improc.imread(str(tmp_path / 'missing.jpg'))


IMAGE_JPEGS = sorted(n for n in image_fixtures.read_manifest() if n.endswith('.jpg'))


def test_image_fixtures_cover_cmyk_ycck_and_rgb():
    spaces = set()
    for name in IMAGE_JPEGS:
        data = (image_fixtures.FIXTURE_DIR / name).read_bytes()
        adobe = data.find(b'Adobe')
        n_components = data[data.find(b'\xff\xc0') + 9] if b'\xff\xc0' in data else \
            data[data.find(b'\xff\xc2') + 9]
        spaces.add((n_components, data[adobe + 11] if adobe >= 0 else None))
    assert {(4, 0), (4, 2), (3, 0), (3, None)} <= spaces


@pytest.mark.parametrize('name', IMAGE_JPEGS)
def test_cmyk_ycck_and_rgb_fixtures_equal_jax_imread(name):
    """Adobe CMYK (baseline, 4:2:0, progressive, EXIF-turned), YCCK, and
    RGB-coded files (Adobe transform 0, component IDs R, G, B) against JAX's
    imread (cv2) in colour, cv2 in gray, PIL's size and the manifest."""
    path = str(image_fixtures.FIXTURE_DIR / name)
    entry = image_fixtures.read_manifest()[name]
    got = improc.imread(path)
    np.testing.assert_array_equal(got, jax_improc.imread(path))
    assert image_fixtures.digest(got) == entry['sha256_rgb']
    gray = improc.imread(path, gray=True)
    np.testing.assert_array_equal(gray, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    assert image_fixtures.digest(gray) == entry['sha256_gray']
    np.testing.assert_array_equal(improc.image_extents(path), jax_improc.image_extents(path))


@pytest.mark.parametrize('seed', range(6))
def test_random_cmyk_and_rgb_encodings_equal_cv2(seed):
    from PIL import Image
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(1, 60, 2))
    cmyk = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    for options in (dict(quality=int(rng.integers(5, 100)), subsampling=int(rng.integers(0, 3))),
                    dict(quality=60, progressive=True)):
        data = image_fixtures.pil_bytes(Image.fromarray(cmyk, 'CMYK'), 'JPEG', **options)
        for transform in (0, 2):  # CMYK, then the same file read as YCCK
            edited = bytearray(data)
            edited[edited.find(b'Adobe') + 11] = transform
            np.testing.assert_array_equal(jpeg.decode(bytes(edited)), cv2_rgb(bytes(edited)))
            np.testing.assert_array_equal(
                jpeg.decode(bytes(edited), gray=True),
                cv2.imdecode(np.frombuffer(bytes(edited), np.uint8), cv2.IMREAD_GRAYSCALE))
    rgb = image_fixtures.pil_bytes(Image.fromarray(cmyk[..., :3]), 'JPEG', keep_rgb=True,
                                   subsampling=0, quality=int(rng.integers(5, 100)))
    np.testing.assert_array_equal(jpeg.decode(rgb), cv2_rgb(rgb))
    np.testing.assert_array_equal(jpeg.decode(rgb, gray=True),
                                  cv2.imdecode(np.frombuffer(rgb, np.uint8), cv2.IMREAD_GRAYSCALE))
