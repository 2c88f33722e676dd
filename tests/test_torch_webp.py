"""The port's WebP decoder (`metrabs_tpu_torch/data/webp.py` with
`csrc/webp_decode.cpp`: VP8L lossless and VP8 lossy) against cv2.imread bit
for bit, in colour and in gray: every WebP fixture of
`tests/torch_fixtures/images` against the JAX package's `imread` (cv2),
`image_extents` (PIL) and the manifest's hashes; the fixtures' coverage of
the VP8 tools (every loop-filter type, sharpness, 2-8 token partitions,
segmentation, the skip flag) and of VP8L's colour indexing; random images
through Pillow's and libwebp's encoders; the EXIF orientation of a VP8X
file's EXIF chunk; an animation's first frame on its canvas; corrupt and
truncated files; and the slice as a whole: JAX's demo_image on JAX's read
against the port's on its own read of a turned lossy WebP.
"""

import json
import os
import tempfile

import cv2
import numpy as np
import pytest

import _torch_image_fixtures as fx
from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from metrabs_tpu.data import improc as jax_improc
from metrabs_tpu_torch.data import improc, webp

WEBP_FIXTURES = sorted(n for n in fx.read_manifest() if n.endswith('.webp'))
POSES3D = dict(atol=1.0, rtol=1e-3)  # tests/test_torch_estimator.py


def cv2_read(data: bytes, gray: bool = False):
    """cv2.imread of the bytes written to a file, as JAX's imread reads, in
    RGB order (None where cv2 fails)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'x.webp')
        with open(path, 'wb') as f:
            f.write(data)
        im = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    return im if im is None or gray else np.ascontiguousarray(im[..., ::-1])


def assert_equal_to_cv2(data: bytes) -> None:
    for gray in (False, True):
        got = webp.decode(data, 'x.webp', gray=gray)
        assert got.dtype == np.uint8 and got.flags['C_CONTIGUOUS']
        np.testing.assert_array_equal(got, cv2_read(data, gray))


@pytest.mark.parametrize('name', WEBP_FIXTURES)
def test_fixture_equals_jax_imread_and_the_manifest(name):
    path = str(fx.FIXTURE_DIR / name)
    entry = fx.read_manifest()[name]
    got = improc.imread(path)
    np.testing.assert_array_equal(got, jax_improc.imread(path))
    assert list(got.shape) == entry['shape_rgb'] and fx.digest(got) == entry['sha256_rgb']
    gray = improc.imread(path, gray=True)
    np.testing.assert_array_equal(gray, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    assert list(gray.shape) == entry['shape_gray'] and fx.digest(gray) == entry['sha256_gray']
    np.testing.assert_array_equal(improc.image_extents(path), jax_improc.image_extents(path))
    assert list(improc.image_extents(path)) == entry['pil_size']
    assert improc.is_image_readable(path) and jax_improc.is_image_readable(path)


def test_fixtures_cover_the_vp8_tools():
    tools = [webp.vp8_tools((fx.FIXTURE_DIR / n).read_bytes()) for n in WEBP_FIXTURES]
    lossy = [t for t in tools if t is not None]
    assert {t['filter_type'] for t in lossy} == {0, 1, 2}
    assert {t['partitions'] for t in lossy} >= {1, 2, 4, 8}
    assert {t['sharpness'] for t in lossy if t['filter_type']} >= {0, 3, 6, 7}
    assert any(t['segmentation'] and t['segment_map'] for t in lossy)
    assert any(not t['segmentation'] for t in lossy)
    assert any(t['skip_probability'] for t in lossy)
    assert len(tools) - len(lossy) >= 8  # lossless files
    kinds = {n.split('_')[1] for n in WEBP_FIXTURES}
    assert {'lossy', 'lossless', 'animated', 'exif'} <= kinds


@pytest.mark.parametrize('seed', range(24))
def test_random_pillow_encodings_equal_cv2(seed):
    """Pillow's lossy and lossless encoders over sizes, qualities, methods,
    alpha, noise levels and few-colour images (VP8L's colour indexing)."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    for _ in range(3):
        h, w = (int(v) for v in rng.integers(1, 80, 2))
        im = fx.noisy(h, w, int(rng.integers(1 << 16)), float(rng.choice([0.0, 3.0, 30.0])))
        if rng.random() < 0.25:
            im = (im // 64 * 64).astype(np.uint8)
        mode = 'RGB'
        if rng.random() < 0.3:
            im = np.dstack([im, rng.integers(0, 256, (h, w), dtype=np.uint8)])
            mode = 'RGBA'
        options = dict(quality=int(rng.integers(0, 101)), method=int(rng.integers(0, 7)))
        if rng.random() < 0.5:
            options['lossless'] = True
        assert_equal_to_cv2(fx.pil_bytes(Image.fromarray(im, mode), 'WEBP', **options))


LIBWEBP_OPTIONS = {
    'simple_filter': dict(filter_type=0, filter_strength=50),
    'simple_sharpness4': dict(filter_type=0, filter_sharpness=4, filter_strength=100),
    'normal_sharpness2': dict(filter_type=1, filter_sharpness=2, filter_strength=40),
    'no_filter': dict(filter_strength=0, autofilter=0),
    'autofilter': dict(autofilter=1),
    'partitions2': dict(partitions=1, method=2),
    'partitions4_segments1': dict(partitions=2, method=0, segments=1),
    'partitions8_segments3': dict(partitions=3, method=1, segments=3),
    'segments2_quality10': dict(segments=2, quality=10.0),
    'segments4_sns100': dict(segments=4, sns_strength=100, quality=95.0),
    'skip_method0': dict(method=0, quality=30.0),
    'sharp_yuv': dict(use_sharp_yuv=1),
    'lossless_fast': dict(lossless=1, quality=0.0, method=0),
    'lossless_best': dict(lossless=1, quality=100.0, method=6),
    'near_lossless': dict(lossless=1, near_lossless=60),
}


@pytest.mark.parametrize('case', sorted(LIBWEBP_OPTIONS))
def test_libwebp_tools_equal_cv2(case):
    """libwebp's advanced encoder (the bundled libwebp through ctypes) with
    the tools Pillow's options do not reach."""
    rng = np.random.default_rng(len(case))
    for h, w in ((150, 140), (33, 47)):
        im = fx.noisy(h, w, int(rng.integers(1 << 16)), 10.0)
        if case == 'skip_method0':
            im[h // 4:, :w // 2] = 90
        data = fx.libwebp_encode(im, **LIBWEBP_OPTIONS[case])
        assert_equal_to_cv2(data)
    tools = webp.vp8_tools(data)
    if 'partitions' in LIBWEBP_OPTIONS[case]:
        assert tools['partitions'] == 2 ** LIBWEBP_OPTIONS[case]['partitions']
    if case.startswith('simple'):
        assert tools['filter_type'] == 1


@pytest.mark.parametrize('lossless', [False, True])
@pytest.mark.parametrize('orientation', range(1, 9))
def test_exif_orientation_equals_cv2(orientation, lossless):
    """The EXIF chunk of a VP8X file turns the image as cv2 turns it, in
    colour and in gray (the same rule as F12 for PNG)."""
    from PIL import Image
    im = fx.noisy(37, 53, orientation)
    data = fx.pil_bytes(Image.fromarray(im), 'WEBP', lossless=lossless, quality=70)
    turned = fx.with_exif(data, fx.tiff_orientation(orientation, little=lossless), 53, 37)
    assert_equal_to_cv2(turned)
    assert webp.decode(turned).shape[:2] == ((53, 37) if orientation >= 5 else (37, 53))
    np.testing.assert_array_equal(improc_extents(turned), [53, 37])


def improc_extents(data: bytes):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'x.webp')
        with open(path, 'wb') as f:
            f.write(data)
        return improc.image_extents(path)


def test_exif_needs_the_vp8x_flag_and_a_bare_tiff_block():
    from PIL import Image
    data = fx.pil_bytes(Image.fromarray(fx.noisy(37, 53, 3)), 'WEBP', quality=70)
    chunks = fx.webp_chunks(data)
    unflagged = fx.riff([fx.vp8x(0, 53, 37)] + chunks + [(b'EXIF', fx.tiff_orientation(6))])
    prefixed = fx.with_exif(data, b'Exif\x00\x00' + fx.tiff_orientation(6), 53, 37)
    for case in (unflagged, prefixed):
        assert_equal_to_cv2(case)
        assert webp.decode(case).shape == (37, 53, 3)


def test_animation_gives_its_first_frame_on_the_canvas():
    from PIL import Image
    small = [fx.pil_bytes(Image.fromarray(fx.noisy(18, 26, 50)), 'WEBP', lossless=True),
             fx.pil_bytes(Image.fromarray(fx.noisy(40, 60, 51)), 'WEBP', quality=60)]
    for offset in ((0, 0), (8, 4), (34, 22)):
        data = fx.animated_offset(small, [offset, (0, 0)], (60, 40))
        assert_equal_to_cv2(data)
        got = webp.decode(data)
        x, y = offset
        assert not got[:y].any() and not got[:, :x].any() and got[y:y + 18, x:x + 26].any()


def _truncated_riff():
    data = (fx.FIXTURE_DIR / 'webp_lossy_pillow.webp').read_bytes()
    return data[:len(data) // 2]


def _cut_bitstream(name: str):
    """The RIFF sizes kept, the bitstream cut short: the decoder runs out."""
    data = (fx.FIXTURE_DIR / name).read_bytes()
    chunks = fx.webp_chunks(data)
    return fx.riff([(k, p[:len(p) // 3]) for k, p in chunks])


CORRUPT = {
    'truncated_riff': _truncated_riff,
    'lossy_cut': lambda: _cut_bitstream('webp_lossy_pillow.webp'),
    'lossless_cut': lambda: _cut_bitstream('webp_lossless_pillow.webp'),
    'bad_vp8_start_code': lambda: (fx.FIXTURE_DIR / 'webp_lossy_pillow.webp').read_bytes()
    .replace(b'\x9d\x01\x2a', b'\x9d\x01\x2b', 1),
    'bad_vp8l_signature': lambda: fx.riff(
        [(b'VP8L', b'\x2e' + fx.webp_chunks(
            (fx.FIXTURE_DIR / 'webp_lossless_pillow.webp').read_bytes())[0][1][1:])]),
    'no_bitstream': lambda: fx.riff([fx.vp8x(0, 10, 10)]),
}


@pytest.mark.parametrize('case', sorted(CORRUPT))
def test_corrupt_files_raise_where_cv2_returns_none(case, tmp_path):
    data = CORRUPT[case]()
    assert cv2_read(data) is None
    with pytest.raises(ValueError):
        webp.decode(data, 'x.webp')
    path = tmp_path / 'x.webp'
    path.write_bytes(data)
    assert improc.is_image_readable(str(path)) == jax_improc.is_image_readable(str(path)) is False


def test_phone_sized_lossy_webp_equals_the_manifest_turned():
    path = str(fx.FIXTURE_DIR / 'webp_large_o6.webp')
    got = improc.imread(path)
    assert got.shape == (fx.LARGE[1], fx.LARGE[0], 3)
    assert fx.digest(got) == fx.read_manifest()['webp_large_o6.webp']['sha256_rgb']


@pytest.mark.parametrize('name', ['webp_exif_o6_lossy.webp', 'webp_animated_offset.webp'])
def test_demo_image_on_webp_matches_jax(name, tmp_path, capsys, one_torch_thread):
    """The slice: JAX's demo_image (cv2's read, JAX's estimator) against the
    port's (its own read, its estimator on the CPU) on the tiny package's
    minted weights, which the port loads through its converter."""
    from _torch_port import make_family_package
    from metrabs_tpu.apps import demo_image as jax_demo_image
    from metrabs_tpu_torch.apps import demo_image
    package = make_family_package(str(tmp_path / 'pkg'), 'tiny')
    path = str(fx.FIXTURE_DIR / name)
    common = ['--image', path, '--package', package, '--num-aug', '2',
              '--boxes', '2,3,30,35;8,5,25,30']
    with pytest.warns(UserWarning, match='bone_mean_lengths'):
        jax_demo_image.main(common)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with pytest.warns(UserWarning, match='bone_mean_lengths'):
        demo_image.main(common + ['--device', 'cpu', '--out', str(tmp_path / 'o.jpg')])
    got = json.loads([t for t in capsys.readouterr().out.splitlines() if t.startswith('{')][-1])
    assert got.keys() == want.keys() and got['n_poses'] == want['n_poses'] == 2
    np.testing.assert_allclose(got['pose0_pelvis_mm'], want['pose0_pelvis_mm'], **POSES3D)
    assert improc.imread(str(tmp_path / 'o.jpg')).shape == jax_improc.imread(path).shape


def test_unsupported_vp8_tools_raise_by_name():
    """A VP8 inter frame (a key frame's tag bit flipped) is refused by name,
    not decoded."""
    data = bytearray((fx.FIXTURE_DIR / 'webp_lossy_pillow.webp').read_bytes())
    start = data.find(b'VP8 ') + 8
    data[start] |= 1
    with pytest.raises(NotImplementedError, match='VP8 inter frame'):
        webp.decode(bytes(data), 'x.webp')
