"""The port's TIFF reader (`metrabs_tpu_torch/data/tiff.py` with
`csrc/tiff_decode.cpp`) against cv2.imread bit for bit, in colour and in
gray: every TIFF fixture of `tests/torch_fixtures/images` against the JAX
package's `imread` (cv2), `image_extents` (PIL) and the manifest's hashes;
random encodings over compression, predictor, depth, photometric, planar
configuration, strips and tiles, byte order and BigTIFF; the rules cv2's
libtiff follows (16 bits to 8 in colour and in gray, Orientation 1-8,
palettes, alpha, CMYK, FillOrder, the clipped-tile skew of 16-bit gray,
codecs failing part way); JPEG-compressed TIFFs that libtiff writes;
corrupt and truncated files, where cv2 returns None and the port raises;
and the phone-sized TIFF that apps.demo_image reads on the card.
"""

import os
import tempfile

import cv2
import numpy as np
import pytest

import _torch_image_fixtures as fx
from metrabs_tpu.data import improc as jax_improc
from metrabs_tpu_torch.data import improc, tiff

TIFF_FIXTURES = sorted(n for n in fx.read_manifest() if n.startswith('tiff_'))


def cv2_read(data: bytes, gray: bool = False):
    """cv2.imread of the bytes in a file, RGB in colour; None where cv2
    returns None."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'x.tif')
        with open(path, 'wb') as f:
            f.write(data)
        im = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    return im if im is None or gray else np.ascontiguousarray(im[..., ::-1])


def assert_equal_to_cv2(data: bytes) -> None:
    """Colour and gray equal to cv2's read, or ValueError where cv2 returns
    None."""
    for gray in (False, True):
        want = cv2_read(data, gray)
        if want is None:
            with pytest.raises(ValueError):
                tiff.decode(data, 'x.tif', gray=gray)
            continue
        got = tiff.decode(data, 'x.tif', gray=gray)
        assert got.dtype == np.uint8 and got.flags['C_CONTIGUOUS']
        np.testing.assert_array_equal(got, want)


def test_fixtures_cover_the_tiff_kinds():
    kinds = set()
    for name in TIFF_FIXTURES:
        t = tiff.parse((fx.FIXTURE_DIR / name).read_bytes())
        kinds |= {('compression', t['compression']), ('photometric', t['photometric']),
                  ('planar', t['planar']), ('tiled', t['tiled']), ('bits', t['bits']),
                  ('predictor', t['predictor']), ('big_endian', t['big_endian'])}
    assert kinds >= {('compression', c) for c in (1, 5, 7, 8, 32946, 32773)}
    assert kinds >= {('photometric', p) for p in (0, 1, 2, 3, 5, 6)}
    assert any(tiff.parse((fx.FIXTURE_DIR / n).read_bytes())['ycbcr'] for n in TIFF_FIXTURES)
    assert kinds >= {('planar', 2), ('tiled', True), ('bits', 1), ('bits', 4), ('bits', 16),
                     ('predictor', 2), ('big_endian', True)}


@pytest.mark.parametrize('name', TIFF_FIXTURES)
def test_fixture_equals_jax_imread_and_the_manifest(name):
    path = str(fx.FIXTURE_DIR / name)
    entry = fx.read_manifest()[name]
    got = improc.imread(path)
    np.testing.assert_array_equal(got, jax_improc.imread(path))
    assert list(got.shape) == entry['shape_rgb'] and fx.digest(got) == entry['sha256_rgb']
    gray = improc.imread(path, gray=True)
    np.testing.assert_array_equal(gray, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    assert fx.digest(gray) == entry['sha256_gray']
    if entry['pil_size'] == fx.PIL_RAISES:
        with pytest.raises(Exception):
            jax_improc.image_extents(path)
        with pytest.raises(ValueError, match='PIL does not identify'):
            improc.image_extents(path)
    else:
        np.testing.assert_array_equal(improc.image_extents(path), jax_improc.image_extents(path))
    assert improc.is_image_readable(path) and jax_improc.is_image_readable(path)


CASES = [(ph, bits) for ph, depths in {0: (1, 8, 16), 1: (1, 8, 16), 2: (8, 16), 3: (1, 4, 8),
                                        5: (8,)}.items() for bits in depths]


@pytest.mark.parametrize('case', CASES, ids=[f'ph{p}_b{b}' for p, b in CASES])
@pytest.mark.parametrize('seed', range(4))
def test_random_encodings_equal_cv2(case, seed):
    """Compression (none, LZW new and old, Deflate, PackBits) x predictor x
    planar configuration x strips or tiles x byte order x BigTIFF, at every
    depth and photometric cv2 reads, extra samples of each kind."""
    photometric, bits = case
    rng = np.random.default_rng(1000 * photometric + 10 * bits + seed)
    colour = {0: 1, 1: 1, 2: 3, 3: 1, 5: 4}[photometric]
    for _ in range(3):
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        spp = colour + int(rng.random() < 0.3)
        samples = rng.integers(0, 1 << bits, (h, w, spp))
        colormap = rng.integers(0, 65536 if rng.random() < 0.5 else 256, (1 << bits, 3)) \
            if photometric == 3 else None
        tile = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3))) \
            if rng.random() < 0.5 else None
        compression = int(rng.choice([1, 5, 8, 32946, 32773]))
        data = fx.tiff_file(
            samples, bits, photometric, compression=compression,
            predictor=2 if bits >= 8 and rng.random() < 0.5 else 1,
            planar=2 if spp > 1 and rng.random() < 0.5 else 1, tile=tile,
            rows_per_strip=int(rng.integers(1, h + 2)), big=bool(rng.random() < 0.3),
            little=bool(rng.random() < 0.5), colormap=colormap,
            extra_samples=[int(rng.integers(0, 3))] if spp > colour else None,
            old_lzw=bool(rng.random() < 0.3))
        assert_equal_to_cv2(data)


@pytest.mark.parametrize('subsampling', [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)])
def test_random_ycbcr_equals_cv2(subsampling):
    """YCbCr blocks, not JPEG-compressed: TIFFYCbCrtoRGB's tables (default
    and tagged coefficients and reference black and white), strips read to
    libtiff's rounded-down scanline size, clipped tiles (the 4x4 put
    routine's skew)."""
    rng = np.random.default_rng(subsampling[0] * 10 + subsampling[1])
    for k in range(8):
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 70))
        extra = [[], [(529, 5, [(2990, 10000), (5870, 10000), (1140, 10000)])],
                 [(532, 5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])]][k % 3]
        data = fx.tiff_file(rng.integers(0, 256, (h, w, 3)), 8, 6,
                            compression=int(rng.choice([1, 5, 8, 32773])),
                            tile=(16 * int(rng.integers(1, 4)), 16) if k % 2 else None,
                            rows_per_strip=subsampling[1] * int(rng.integers(1, 5)),
                            ycbcr=subsampling, little=bool(k % 4 < 2), extra=extra)
        assert_equal_to_cv2(data)


@pytest.mark.parametrize('little', [True, False])
def test_16_bit_rules(little):
    """16-bit RGB reads in colour as (v + 128) // 257 (libtiff's
    Bitdepth16To8), 16-bit gray as v >> 8 in colour and in gray (its BW map
    takes the high byte); gray from RGB is icvCvt_BGRA2Gray of the 8-bit
    values."""
    rng = np.random.default_rng(16)
    v = rng.integers(0, 65536, (9, 11, 3))
    data = fx.tiff_file(v, 16, 2, compression=5, predictor=2, little=little)
    np.testing.assert_array_equal(tiff.decode(data), (v + 128) // 257)
    assert_equal_to_cv2(data)
    g = fx.tiff_file(v[..., 0], 16, 1, little=little)
    np.testing.assert_array_equal(tiff.decode(g, gray=True), v[..., 0] >> 8)
    np.testing.assert_array_equal(tiff.decode(g)[..., 1], v[..., 0] >> 8)
    assert_equal_to_cv2(g)
    # The 25% of samples where the high byte and the rounding differ.
    assert ((v + 128) // 257 != v >> 8).mean() > 0.2


@pytest.mark.parametrize('tiled', [False, True])
@pytest.mark.parametrize('orientation', list(range(0, 10)))
def test_orientation_as_cv2_applies_it(orientation, tiled):
    """2-4 flip as cv2 flips (a tiled file's horizontal flip tile by tile,
    as TIFFReadRGBATile mirrors each); 5-8 read as None in cv2 (OpenCV 5.0
    fails on the turned image) and raise; 0 and 9 are ignored, as libtiff
    ignores them. PIL's size swaps for 5-8."""
    rng = np.random.default_rng(orientation)
    v = rng.integers(0, 256, (19, 37, 3))
    data = fx.tiff_file(v, 8, 2, rows_per_strip=4, tile=(16, 16) if tiled else None,
                        extra=[(274, 3, [orientation])])
    assert_equal_to_cv2(data)
    if 5 <= orientation <= 8:
        with pytest.raises(ValueError, match='Orientation'):
            tiff.decode(data)
        assert tiff.header(data) == (19, 37)
    else:
        assert tiff.header(data) == (37, 19)


@pytest.mark.parametrize('width', [11, 16, 27, 40])
def test_gray_clipped_tiles_read_as_libtiff_skews_them(width):
    """put16bitbwtile, and the 8-bit gray and palette put routines with an
    extra sample, skip a clipped tile's hidden samples as bytes: the rows of
    a right-edge tile come out shifted, in both byte orders."""
    rng = np.random.default_rng(width)
    v = rng.integers(0, 65536, (35, width, 2))
    cmap = rng.integers(0, 65536, (256, 3))
    for little in (True, False):
        assert_equal_to_cv2(fx.tiff_file(v[..., 0], 16, 1, tile=(16, 16), little=little))
        assert_equal_to_cv2(fx.tiff_file(v[..., 0], 16, 0, tile=(16, 32), little=little,
                                         compression=5, predictor=2))
        assert_equal_to_cv2(fx.tiff_file(v, 16, 1, tile=(16, 16), little=little,
                                         extra_samples=[2]))
        for extra in (None, [0], [1], [2]):
            assert_equal_to_cv2(fx.tiff_file(v >> 8, 8, 1, tile=(16, 16), little=little,
                                             extra_samples=extra))
        assert_equal_to_cv2(fx.tiff_file(v >> 8, 8, 3, tile=(32, 16), colormap=cmap,
                                         extra_samples=[0]))


@pytest.mark.parametrize('extra', [None, 0, 1, 2])
def test_gray_with_an_extra_plane_reads_as_rgb_of_the_gray_plane(extra):
    """gtStripSeparate takes the gray plane as red, green and blue (no
    MinIsWhite inversion; 16 bits as (v + 128) // 257) and premultiplies an
    unassociated alpha plane; a palette with an extra plane, and sub-byte
    gray, read as None in cv2."""
    rng = np.random.default_rng(13)
    v = rng.integers(0, 65536, (21, 19, 2))
    es = None if extra is None else [extra]
    for photometric in (0, 1):
        data = fx.tiff_file(v >> 8, 8, photometric, planar=2, extra_samples=es, tile=(16, 16))
        assert_equal_to_cv2(data)
        want = v[..., 0] >> 8
        if extra == 2:
            want = (want * (v[..., 1] >> 8) + 127) // 255
        np.testing.assert_array_equal(tiff.decode(data)[..., 0], want)
        assert_equal_to_cv2(fx.tiff_file(v, 16, photometric, planar=2, extra_samples=es))
    assert_equal_to_cv2(fx.tiff_file(v >> 8, 8, 3, planar=2, extra_samples=es,
                                     colormap=rng.integers(0, 65536, (256, 3))))
    assert_equal_to_cv2(fx.tiff_file(v & 1, 1, 1, planar=2, extra_samples=es))


def test_alpha_palette_cmyk_and_signed_rules():
    """Unassociated alpha premultiplies ((v * a + 127) // 255), associated
    and unspecified alpha are dropped; a 16-bit colormap is scaled by its
    high byte, an 8-bit one (every entry below 256) taken as is, one of the
    wrong length ignored (a gray read); CMYK is k * (255 - c) // 255 with
    k = 255 - K; signed samples read as their bits."""
    rng = np.random.default_rng(5)
    rgba = rng.integers(0, 256, (9, 13, 4))
    for extra, want in ((2, (rgba[..., :3] * rgba[..., 3:] + 127) // 255), (1, rgba[..., :3]),
                        (0, rgba[..., :3])):
        data = fx.tiff_file(rgba, 8, 2, extra_samples=[extra])
        assert_equal_to_cv2(data)
        np.testing.assert_array_equal(tiff.decode(data), want)
    index = rng.integers(0, 16, (7, 9))
    cmap16 = rng.integers(0, 65536, (16, 3))
    np.testing.assert_array_equal(tiff.decode(fx.tiff_file(index, 4, 3, colormap=cmap16)),
                                  (cmap16 >> 8)[index])
    cmap8 = rng.integers(0, 256, (16, 3))
    np.testing.assert_array_equal(tiff.decode(fx.tiff_file(index, 4, 3, colormap=cmap8)),
                                  cmap8[index])
    assert_equal_to_cv2(fx.tiff_file(rng.integers(0, 256, (7, 9)), 8, 3, colormap=cmap8))
    cmyk = rng.integers(0, 256, (7, 9, 4))
    k = 255 - cmyk[..., 3:]
    np.testing.assert_array_equal(tiff.decode(fx.tiff_file(cmyk, 8, 5)), k * (255 - cmyk[..., :3])
                                  // 255)
    for bits in (8, 16):
        assert_equal_to_cv2(fx.tiff_file(rng.integers(0, 1 << bits, (7, 9, 3)), bits, 2,
                                         sample_format=2))


@pytest.mark.parametrize('compression', [1, 5, 8, 32773])
def test_fill_order_2_reverses_the_raw_bits(compression):
    """libtiff reverses the bits of every byte of a FillOrder 2 strip before
    its codec; data written without the reversal then reads as cv2 reads it
    (zeros where the codec fails)."""
    rng = np.random.default_rng(compression)
    for bits, ph, spp in ((1, 1, 1), (8, 2, 3), (16, 1, 1)):
        v = rng.integers(0, 1 << bits, (9, 13, spp))
        assert_equal_to_cv2(fx.tiff_file(v, bits, ph, compression=compression,
                                         extra=[(266, 3, [2])]))


def test_jpeg_compressed_tiffs_equal_cv2():
    """YCbCr (JPEGCOLORMODE_RGB) at 4:2:0, 4:2:2 and 4:4:4 in strips and
    tiles, and RGB as coded, written by the system libtiff; Pillow's."""
    from PIL import Image
    rgb = fx.noisy(45, 61, 7)
    for kw in (dict(rows_per_strip=16), dict(rows_per_strip=45), dict(tile=(32, 16)),
               dict(rows_per_strip=16, subsampling=(1, 1)),
               dict(rows_per_strip=8, subsampling=(2, 1)), dict(rows_per_strip=16, ycbcr=False),
               dict(tile=(16, 16), ycbcr=False, quality=95)):
        assert_equal_to_cv2(fx.libtiff_jpeg(rgb, **kw))
    for mode in ('RGB', 'L', 'CMYK'):
        assert_equal_to_cv2(fx.pil_bytes(Image.fromarray(rgb).convert(mode), 'TIFF',
                                         compression='jpeg'))


def test_pillow_and_cv2_writers_equal_cv2():
    from PIL import Image
    rng = np.random.default_rng(6)
    rgb = fx.noisy(23, 31, 8)
    im = Image.fromarray(rgb)
    for mode in ('1', 'L', 'LA', 'P', 'RGB', 'RGBA', 'CMYK', 'I;16'):
        pil = im.convert(mode) if mode != 'I;16' else Image.fromarray(
            rng.integers(0, 65536, (23, 31)).astype(np.uint16))
        for compression in ('raw', 'tiff_lzw', 'tiff_adobe_deflate', 'packbits'):
            assert_equal_to_cv2(fx.pil_bytes(pil, 'TIFF', compression=compression))
    for image in (rgb, rgb[..., 0], rgb.astype(np.uint16) * 257):
        assert_equal_to_cv2(cv2.imencode('.tiff', image)[1].tobytes())


@pytest.mark.parametrize('case', ['float32', 'uint32', 'gray_4bit', 'rgb_4bit', 'palette_16bit',
                                  'five_samples', 'lzma', 'zstd', 'predictor_3_integer',
                                  'cmyk_16bit'])
def test_kinds_cv2_returns_none_for_raise_value_error(case):
    rng = np.random.default_rng(7)
    data = {
        'float32': lambda: fx.tiff_file(
            rng.random((5, 7, 3)).astype(np.float32).view(np.uint32), 32, 2, sample_format=3),
        'uint32': lambda: fx.tiff_file(rng.integers(0, 1 << 31, (5, 7, 3)), 32, 2),
        'gray_4bit': lambda: fx.tiff_file(rng.integers(0, 16, (5, 7)), 4, 1),
        'rgb_4bit': lambda: fx.tiff_file(rng.integers(0, 16, (5, 7, 3)), 4, 2),
        'palette_16bit': lambda: fx.tiff_file(rng.integers(0, 65536, (5, 7)), 16, 3,
                                              colormap=rng.integers(0, 65536, (65536, 3))),
        'five_samples': lambda: fx.tiff_file(rng.integers(0, 256, (5, 7, 5)), 8, 2,
                                             extra_samples=[0, 0]),
        'lzma': lambda: fx.tiff_file(rng.integers(0, 256, (5, 7, 3)), 8, 2, extra=[
            (259, 3, [34925])]),
        'zstd': lambda: fx.tiff_file(rng.integers(0, 256, (5, 7, 3)), 8, 2, extra=[
            (259, 3, [50000])]),
        'predictor_3_integer': lambda: fx.tiff_file(rng.integers(0, 256, (5, 7, 3)), 8, 2,
                                                    compression=5, extra=[(317, 3, [3])]),
        'cmyk_16bit': lambda: fx.tiff_file(rng.integers(0, 65536, (5, 7, 4)), 16, 5),
    }[case]()
    assert cv2_read(data) is None and cv2_read(data, gray=True) is None
    with pytest.raises(ValueError):
        tiff.decode(data)


@pytest.mark.parametrize('compression', [2, 3, 4, 6])
def test_ccitt_and_old_jpeg_are_refused_by_name(compression):
    data = fx.tiff_file(np.zeros((4, 8), int), 1, 0, extra=[(259, 3, [compression])])
    with pytest.raises(NotImplementedError, match='CCITT|old-style JPEG'):
        tiff.decode(data)


def _corrupt(case: str) -> bytes:
    rng = np.random.default_rng(11)
    v = rng.integers(0, 256, (24, 29, 3))
    v[::3] = 7
    data = bytearray(fx.tiff_file(v, 8, 2, compression={'lzw': 5, 'deflate': 8,
                                                        'packbits': 32773}.get(case[:-8], 5),
                                  rows_per_strip=6, predictor=2 if 'lzw' in case else 1))
    if case.endswith('_garbled'):
        for k in range(60, 66):
            data[k] ^= 0x5A
        return bytes(data)
    return {'truncated_half': bytes(data[:len(data) // 2]), 'no_header': b'II*\0\xff\xff\xff\x7f',
            'truncated_ifd': bytes(data[:-20])}[case]


@pytest.mark.parametrize('case', ['lzw_garbled', 'deflate_garbled', 'packbits_garbled',
                                  'truncated_half', 'no_header', 'truncated_ifd'])
def test_corrupt_and_truncated_files(case, tmp_path):
    """A codec failing inside a strip reads as cv2 reads it (what was decoded,
    zeros after; neither the predictor nor the byte swap applied); a strip
    or directory past the end of the file, where cv2 returns None, raises;
    is_image_readable agrees with JAX's."""
    data = _corrupt(case)
    assert_equal_to_cv2(data)
    path = tmp_path / 'x.tif'
    path.write_bytes(data)
    assert improc.is_image_readable(str(path)) == jax_improc.is_image_readable(str(path))


def test_image_extents_follow_pil(tmp_path):
    """PIL's size where PIL opens the file (little-endian BigTIFF, 16-bit
    gray in either order), a raise where it does not (big-endian BigTIFF,
    big-endian 16-bit MinIsWhite, 2 samples of gray without alpha)."""
    rng = np.random.default_rng(12)
    cases = {
        'big_le': fx.tiff_file(rng.integers(0, 256, (5, 7, 3)), 8, 2, big=True),
        'big_be': fx.tiff_file(rng.integers(0, 256, (5, 7, 3)), 8, 2, big=True, little=False),
        'gray16_be': fx.tiff_file(rng.integers(0, 65536, (5, 7)), 16, 1, little=False),
        'white16_be': fx.tiff_file(rng.integers(0, 65536, (5, 7)), 16, 0, little=False),
        'white16_le': fx.tiff_file(rng.integers(0, 65536, (5, 7)), 16, 0),
        'gray_two_samples': fx.tiff_file(rng.integers(0, 256, (5, 7, 2)), 8, 1),
        'orientation6': fx.tiff_file(rng.integers(0, 256, (5, 7, 3)), 8, 2, orientation=6),
    }
    for name, data in cases.items():
        path = str(tmp_path / f'{name}.tif')
        with open(path, 'wb') as f:
            f.write(data)
        try:
            want = jax_improc.image_extents(path)
        except Exception:
            with pytest.raises(ValueError):
                improc.image_extents(path)
            continue
        np.testing.assert_array_equal(improc.image_extents(path), want)


def test_phone_sized_demo_tiff_equals_cv2(tmp_path):
    """The 4032x3024 16-bit RGB LZW TIFF (predictor 2, 256x256 tiles) that
    chip_smoke mints for apps.demo_image: equal to cv2 in colour and gray."""
    data = fx.large_tiff()
    path = str(tmp_path / 'large.tif')
    with open(path, 'wb') as f:
        f.write(data)
    t = tiff.parse(data)
    assert (t['width'], t['height'], t['bits'], t['compression'], t['predictor'],
            t['tiled']) == (4032, 3024, 16, 5, 2, True)
    np.testing.assert_array_equal(improc.imread(path), jax_improc.imread(path))
    np.testing.assert_array_equal(improc.imread(path, gray=True),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
