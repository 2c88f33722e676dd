"""The port's PNG decoder (`metrabs_tpu_torch/data/png.py` with
`csrc/png_decode.cpp`) against cv2.imread bit for bit, in colour and in
gray: every PNG fixture of `tests/torch_fixtures/images` against the JAX
package's `imread` (cv2), `image_extents` (PIL) and the manifest's hashes
(how the card's machine checks them); random PNGs over every colour type,
depth, interlace and filter; the EXIF orientation of an `eXIf` chunk before
or after IDAT (fault F12: the port ignored it) and its malformed cases;
corrupt and truncated files, where cv2 returns None and the port raises;
and the slice as a whole: JAX's demo_image on JAX's read against the port's
on its own read of a palette PNG.
"""

import itertools
import json
import os
import struct
import tempfile
import zlib

import cv2
import numpy as np
import pytest

import _torch_image_fixtures as fx
from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from metrabs_tpu.data import improc as jax_improc
from metrabs_tpu_torch.data import cvfree, exif, improc, png

PNG_FIXTURES = sorted(n for n in fx.read_manifest() if n.endswith('.png'))
KINDS = [(ct, d) for ct, depths in fx.DEPTHS.items() for d in depths]
POSES3D = dict(atol=1.0, rtol=1e-3)  # tests/test_torch_estimator.py


def cv2_decode(data: bytes, gray: bool = False):
    """cv2.imread of the bytes written to a file (as JAX's imread reads),
    in RGB order: cv2.imdecode reads an APNG otherwise."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'x.png')
        with open(path, 'wb') as f:
            f.write(data)
        im = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    return im if im is None or gray else np.ascontiguousarray(im[..., ::-1])


def assert_equal_to_cv2(data: bytes) -> None:
    for gray in (False, True):
        want = cv2_decode(data, gray)
        got = png.decode(data, 'x.png', gray=gray)
        assert got.dtype == np.uint8 and got.flags['C_CONTIGUOUS']
        np.testing.assert_array_equal(got, want)


def test_manifest_covers_every_fixture_file():
    on_disk = sorted(p.name for p in fx.FIXTURE_DIR.iterdir() if p.name != 'manifest.json')
    assert on_disk == sorted(fx.read_manifest())
    assert json.loads(fx.MANIFEST.read_text()).keys() == set(on_disk)
    kinds = set()
    for name in PNG_FIXTURES:
        info = png.parse((fx.FIXTURE_DIR / name).read_bytes())
        kinds.add((info['colour_type'], info['depth'], info['interlace']))
    assert kinds >= {(ct, d, i) for ct, d in KINDS for i in (0, 1)}


@pytest.mark.parametrize('name', PNG_FIXTURES)
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


@pytest.mark.parametrize('interlace', [False, True])
@pytest.mark.parametrize('kind', KINDS, ids=[f'ct{ct}_d{d}' for ct, d in KINDS])
@pytest.mark.parametrize('filt', range(5))
def test_random_png_equals_cv2(kind, interlace, filt):
    """Every colour type and depth, each filter on every row, Adam7 or not,
    sizes that leave Adam7 passes empty, with and without tRNS and short
    palettes."""
    ct, depth = kind
    rng = np.random.default_rng(1000 * ct + 10 * depth + 2 * filt + interlace)
    for h, w in ((1, 1), (3, 5), (int(rng.integers(6, 30)), int(rng.integers(6, 30)))):
        n_palette = int(rng.integers(1, 1 << depth)) if ct == 3 and rng.random() < 0.5 else None
        assert_equal_to_cv2(fx.random_png(rng, ct, depth, h, w, interlace, filt,
                                          with_trns=bool(rng.random() < 0.5),
                                          n_palette=n_palette))


def test_mixed_filters_and_split_idat_equal_cv2():
    rng = np.random.default_rng(7)
    for ct, depth in KINDS:
        data = fx.random_png(rng, ct, depth, 19, 27, bool(rng.random() < 0.5),
                             lambda i: int(rng.integers(0, 5)), idat_pieces=4)
        assert_equal_to_cv2(data)


def test_cv2_and_pillow_writers_equal_cv2():
    from PIL import Image
    rng = np.random.default_rng(8)
    im = fx.noisy(31, 45, 3)
    for level in (0, 1, 9):  # cv2 picks filters per row, Paeth among them
        assert_equal_to_cv2(cv2.imencode('.png', im, [cv2.IMWRITE_PNG_COMPRESSION, level])[1]
                            .tobytes())
    deep = im.astype(np.uint16) * 257 + rng.integers(0, 256, im.shape).astype(np.uint16)
    assert_equal_to_cv2(cv2.imencode('.png', deep)[1].tobytes())
    rgba = np.dstack([im, rng.integers(0, 256, im.shape[:2], dtype=np.uint8)])
    for mode in ('1', 'L', 'LA', 'P', 'RGBA', 'I;16'):
        pil = Image.fromarray(rgba, 'RGBA').convert(mode) if mode != 'I;16' else \
            Image.fromarray(deep[..., 0])
        assert_equal_to_cv2(fx.pil_bytes(pil, 'PNG'))
    for colors in (2, 4, 16, 256):
        quantized = Image.fromarray(rgba, 'RGBA').quantize(colors)
        assert_equal_to_cv2(fx.pil_bytes(quantized, 'PNG'))
    frames = [Image.fromarray(fx.noisy(20, 24, 40 + k)) for k in range(3)]
    apng = fx.pil_bytes(frames[0], 'PNG', save_all=True, append_images=frames[1:])
    assert_equal_to_cv2(apng)
    np.testing.assert_array_equal(png.decode(apng), np.asarray(frames[0]))
    for mode in ('P', 'L', 'LA', 'RGBA'):
        converted = [Image.fromarray(np.dstack([np.asarray(f), rgba[:20, :24, 3]]), 'RGBA')
                     .convert(mode) for f in frames]
        assert_equal_to_cv2(fx.pil_bytes(converted[0], 'PNG', save_all=True,
                                         append_images=converted[1:]))


def test_apng_gives_its_default_image_as_cv2_imread_does():
    """cv2.imread of a file gives an APNG's IDAT image, also where the IDAT
    is not a frame of the animation (cv2.imdecode of the same bytes gives
    the first fdAT frame) and at 16 bits."""
    from PIL import Image
    frames = [Image.fromarray(fx.noisy(20, 24, 40 + k)) for k in range(3)]
    hidden = fx.pil_bytes(frames[0], 'PNG', save_all=True, append_images=frames[1:],
                          default_image=True)
    assert_equal_to_cv2(hidden)
    np.testing.assert_array_equal(png.decode(hidden), np.asarray(frames[0]))
    decoded = cv2.imdecode(np.frombuffer(hidden, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(decoded, np.asarray(frames[1]))
    deep = [Image.fromarray(fx.noisy(20, 24, 40 + k)[..., 0].astype(np.uint16) * 257 + k)
            for k in range(2)]
    assert_equal_to_cv2(fx.pil_bytes(deep[0], 'PNG', save_all=True, append_images=deep[1:]))


def test_stored_samples_keep_alpha():
    rng = np.random.default_rng(9)
    for ct, c in ((0, 1), (4, 2), (2, 3), (6, 4)):
        samples = rng.integers(0, 256, (11, 13, c)).astype(np.uint16)
        data = fx.png_file(samples, 8, ct, interlace=bool(ct & 2), filters=lambda i: i % 5)
        got = png.decode_stored(data)
        np.testing.assert_array_equal(got, samples[..., 0] if c == 1 else samples)
    with pytest.raises(NotImplementedError, match='depth 16'):
        png.decode_stored(fx.random_png(rng, 2, 16, 4, 4))


@pytest.mark.parametrize('after_idat', [False, True])
@pytest.mark.parametrize('orientation', range(1, 9))
def test_f12_exif_orientation_equals_cv2(orientation, after_idat):
    """F12: cv2 applies the Orientation of an eXIf chunk, before or after
    IDAT, in colour and in gray; the port read the stored image."""
    rng = np.random.default_rng(orientation)
    for ct, depth, little in ((2, 8, False), (0, 16, True), (3, 4, False)):
        data = fx.random_png(rng, ct, depth, 37, 53, filters=4,
                             exif=fx.tiff_orientation(orientation, little),
                             exif_after_idat=after_idat)
        assert_equal_to_cv2(data)
        want_shape = (53, 37) if orientation >= 5 else (37, 53)
        assert png.decode(data).shape[:2] == want_shape


def _png_with_chunks(before_idat, after_idat=(), samples=None, crc_bad=()) -> bytes:
    samples = fx.noisy(37, 53, 5).astype(np.uint16) if samples is None else samples
    h, w = samples.shape[:2]
    chunks = [(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0)), *before_idat,
              (b'IDAT', zlib.compress(fx.png_scanlines(samples, 8, False, 1))), *after_idat,
              (b'IEND', b'')]
    out = fx.PNG_SIGNATURE
    for i, (kind, body) in enumerate(chunks):
        chunk = bytearray(fx.png_chunk(kind, body))
        if i in crc_bad:
            chunk[-1] ^= 1
        out += bytes(chunk)
    return out


T3, T6 = (b'eXIf', fx.tiff_orientation(3)), (b'eXIf', fx.tiff_orientation(6))
EXIF_CASES = {
    'two_before_first_wins': ([T3, T6], []),
    'two_after_first_wins': ([], [T3, T6]),
    'before_wins_over_after': ([T6], [T3]),
    'too_short_skipped': ([(b'eXIf', b'MM')], [T6]),
    'bad_tiff_header_skipped': ([(b'eXIf', b'MM\x00\x2b' + bytes(8))], [T6]),
    'valid_header_unparsable_kept': ([(b'eXIf', b'MM\x00\x2a' + b'\xff' * 4)], [T6]),
    'no_entries': ([(b'eXIf', fx.tiff_orientation(6)[:8] + b'\x00\x00')], []),
    'truncated_ifd': ([(b'eXIf', fx.tiff_orientation(6)[:14])], []),
    'value_9': ([(b'eXIf', fx.tiff_orientation(9))], []),
    'prefixed_with_exif_header': ([(b'eXIf', b'Exif\x00\x00' + fx.tiff_orientation(6))], []),
}


@pytest.mark.parametrize('case', sorted(EXIF_CASES))
def test_exif_chunk_rules_equal_cv2(case):
    """libpng keeps the first eXIf chunk that starts with a TIFF header and
    has a good CRC; OpenCV's ExifReader then reads its Orientation."""
    before, after = EXIF_CASES[case]
    assert_equal_to_cv2(_png_with_chunks(before, after))


def test_exif_chunk_with_a_bad_crc_is_skipped():
    data = _png_with_chunks([T6], [T3], crc_bad=(1,))
    assert_equal_to_cv2(data)
    assert png.parse(data)['orientation'] == 3


def test_exif_parser_reads_both_byte_orders_and_the_first_entry():
    block = bytearray(fx.tiff_orientation(6, little=True))
    assert exif.orientation(bytes(block)) == 6
    two = (b'MM' + struct.pack('>HI', 42, 8) + struct.pack('>H', 2)
           + struct.pack('>HHIHH', 0x112, 3, 1, 8, 0) + struct.pack('>HHIHH', 0x112, 3, 1, 3, 0))
    assert exif.orientation(two) == 8
    assert_equal_to_cv2(_png_with_chunks([(b'eXIf', two)]))
    assert exif.orientation(b'') == 1 and exif.orientation(b'II*\x00') == 1


CORRUPT = {
    'ihdr_crc': lambda: _png_with_chunks([], crc_bad=(0,)),
    'idat_crc': lambda: _png_with_chunks([], crc_bad=(1,)),
    'no_iend': lambda: _png_with_chunks([])[:-12],
    'truncated_idat': lambda: _png_with_chunks([])[:200],
    'short_image_data': lambda: _png_with_chunks([])[:33] + fx.png_chunk(
        b'IDAT', zlib.compress(b'\x00' * 50)) + fx.png_chunk(b'IEND', b''),
    'bad_filter_type': lambda: _png_with_chunks([])[:33] + fx.png_chunk(
        b'IDAT', zlib.compress(b'\x07' * (1 + 53 * 3) * 37)) + fx.png_chunk(b'IEND', b''),
    'bad_zlib': lambda: _png_with_chunks([])[:33] + fx.png_chunk(
        b'IDAT', b'\x78\x9c\xff\xff\xff') + fx.png_chunk(b'IEND', b''),
}


@pytest.mark.parametrize('case', sorted(CORRUPT))
def test_corrupt_files_raise_where_cv2_returns_none(case, tmp_path):
    data = CORRUPT[case]()
    assert cv2_decode(data) is None
    with pytest.raises(ValueError):
        png.decode(data, 'x.png')
    path = tmp_path / 'x.png'
    path.write_bytes(data)
    assert improc.is_image_readable(str(path)) == jax_improc.is_image_readable(str(path)) is False


def test_ancillary_chunk_with_bad_crc_is_skipped():
    data = _png_with_chunks([(b'tEXt', b'a\x00b')], crc_bad=(1,))
    assert_equal_to_cv2(data)


def test_paeth_phone_png_unfilters_in_cpp():
    """The 4032x3024 Paeth fixture decodes without Python's per-pixel loop
    (`cvfree.read_png` is `data.png`'s): equal to cv2, colour and gray."""
    data = (fx.FIXTURE_DIR / 'png_large_paeth.png').read_bytes()
    raw = zlib.decompress(b''.join(
        data[p + 8:p + 8 + struct.unpack('>I', data[p:p + 4])[0]]
        for p in [i - 4 for i in range(len(data)) if data[i:i + 4] == b'IDAT']))
    assert set(raw[::1 + 3 * fx.LARGE[1]]) == {4}  # Paeth on every row
    assert_equal_to_cv2(data)
    assert 'paeth' not in cvfree.read_png.__code__.co_names


@pytest.mark.parametrize('name', ['png_pillow_quantize16.png', 'png_exif_o6.png'])
def test_demo_image_on_png_matches_jax(name, tmp_path, capsys, one_torch_thread):
    """The slice: JAX's demo_image (cv2's read, JAX's estimator) against the
    port's (its own read, its estimator on the CPU) on the tiny package's
    minted weights, which the port loads through its converter."""
    from _torch_port import make_family_package
    from metrabs_tpu.apps import demo_image as jax_demo_image
    from metrabs_tpu_torch.apps import demo_image
    package = make_family_package(str(tmp_path / 'pkg'), 'tiny')
    path = str(fx.FIXTURE_DIR / name)
    common = ['--image', path, '--package', package, '--num-aug', '2',
              '--boxes', '2,3,30,40;10,5,25,30']
    with pytest.warns(UserWarning, match='bone_mean_lengths'):
        jax_demo_image.main(common)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with pytest.warns(UserWarning, match='bone_mean_lengths'):
        demo_image.main(common + ['--device', 'cpu', '--out', str(tmp_path / 'o.png')])
    got = json.loads([t for t in capsys.readouterr().out.splitlines() if t.startswith('{')][-1])
    assert got.keys() == want.keys() and got['n_poses'] == want['n_poses'] == 2
    np.testing.assert_allclose(got['pose0_pelvis_mm'], want['pose0_pelvis_mm'], **POSES3D)
    assert improc.imread(str(tmp_path / 'o.png')).shape == jax_improc.imread(path).shape


def test_imread_dispatches_every_png_kind_by_signature(tmp_path):
    rng = np.random.default_rng(11)
    for (ct, depth), ext in zip(KINDS, itertools.cycle(['.jpg', '.webp', '.png'])):
        path = tmp_path / f'ct{ct}_d{depth}{ext}'
        path.write_bytes(fx.random_png(rng, ct, depth, 9, 14, filters=2))
        np.testing.assert_array_equal(improc.imread(str(path)), jax_improc.imread(str(path)))
