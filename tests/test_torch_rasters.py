"""The port's readers of BMP (`data/bmp.py`), PNM/PAM/PFM (`data/pnm.py`),
GIF (`data/gif.py`), Sun raster (`data/sunras.py`) and Radiance HDR
(`data/hdr.py`), with `csrc/raster_decode.cpp`, against cv2.imread bit for
bit, in colour and in gray: every fixture of `tests/torch_fixtures/images`
of these formats against the JAX package's `imread` (cv2), `image_extents`
(PIL, raises included) and the manifest's hashes; random files over BMP's
depth x compression x row order (RLE streams with every escape), PNM's
kinds, maxvals and ASCII layouts, GIF's screens, tables, transparency and
interlace, Sun raster's depths, types and colormaps, and Radiance's run
lengths; each rule cv2 follows by name; corrupt and truncated files.
"""

import os
import tempfile

import cv2
import numpy as np
import pytest

import _torch_image_fixtures as fx
from metrabs_tpu.data import improc as jax_improc
from metrabs_tpu_torch.data import bmp, gif, hdr, improc, pnm, sunras

PREFIXES = ('bmp_', 'pnm_', 'gif_', 'sunras_', 'hdr_')
FIXTURES = sorted(n for n in fx.read_manifest() if n.startswith(PREFIXES))
MODULES = dict(bmp=bmp, pnm=pnm, gif=gif, sunras=sunras, hdr=hdr)


def cv2_read(data: bytes, gray: bool = False):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'x.img')
        with open(path, 'wb') as f:
            f.write(data)
        im = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    return im if im is None or gray else np.ascontiguousarray(im[..., ::-1])


def assert_equal_to_cv2(module, data: bytes) -> None:
    """Colour and gray equal to cv2's read, or ValueError where cv2 returns
    None."""
    for gray in (False, True):
        want = cv2_read(data, gray)
        if want is None:
            with pytest.raises(ValueError):
                module.decode(data, 'x', gray=gray)
            continue
        got = module.decode(data, 'x', gray=gray)
        assert got.dtype == np.uint8 and got.flags['C_CONTIGUOUS']
        np.testing.assert_array_equal(got, want)


def test_fixtures_cover_every_format():
    assert {n.split('_')[0] for n in FIXTURES} == {p[:-1] for p in PREFIXES}


@pytest.mark.parametrize('name', FIXTURES)
def test_fixture_equals_jax_imread_and_the_manifest(name):
    path = str(fx.FIXTURE_DIR / name)
    entry = fx.read_manifest()[name]
    for key, gray in (('rgb', False), ('gray', True)):
        if entry[f'sha256_{key}'] is None:  # cv2 returns None (a PFM's other mode)
            with pytest.raises(ValueError):
                improc.imread(path, gray=gray)
            continue
        got = improc.imread(path, gray=gray)
        want = cv2.imread(path, cv2.IMREAD_GRAYSCALE) if gray else jax_improc.imread(path)
        np.testing.assert_array_equal(got, want)
        assert list(got.shape) == entry[f'shape_{key}'] and fx.digest(got) == \
            entry[f'sha256_{key}']
    if entry['pil_size'] == fx.PIL_RAISES:
        with pytest.raises(Exception):
            jax_improc.image_extents(path)
        with pytest.raises(ValueError, match='PIL does not identify'):
            improc.image_extents(path)
    else:
        np.testing.assert_array_equal(improc.image_extents(path), jax_improc.image_extents(path))
    assert improc.is_image_readable(path) == jax_improc.is_image_readable(path)


@pytest.mark.parametrize('bits', [1, 4, 8, 16, 24, 32])
@pytest.mark.parametrize('seed', range(3))
def test_random_bmp_equals_cv2(bits, seed):
    """Every header size, palettes shorter than 2^bits, 555 and 565 and other
    masks, BI_BITFIELDS after the header and inside V4/V5 headers,
    bottom-up and top-down rows."""
    rng = np.random.default_rng(100 * bits + seed)
    for _ in range(6):
        w, h = int(rng.integers(1, 30)), int(rng.integers(1, 20))
        header = int(rng.choice([12, 40, 108, 124])) if bits in (1, 4, 8, 24) else \
            int(rng.choice([40, 108, 124]))
        pitch = ((w * bits + 7) // 8 + 3) & -4
        pixels = rng.integers(0, 256, pitch * h).astype(np.uint8).tobytes()
        palette, used = None, 0
        if bits <= 8:
            n = 1 << bits if header == 12 or rng.random() < 0.6 else int(rng.integers(1, 1 << bits))
            used = 0 if n == 1 << bits else n
            palette = rng.integers(0, 256, n * (3 if header == 12 else 4)).astype(
                np.uint8).tobytes()
        compression, masks, header_masks = 0, None, None
        if bits == 16 and rng.random() < 0.6:
            compression = 3
            masks = [(0x7c00, 0x3e0, 0x1f), (0xf800, 0x7e0, 0x1f), (0xf00, 0xf0, 0xf)][
                int(rng.integers(0, 3))]
        if bits == 32 and rng.random() < 0.6:
            compression = 3
            if header > 40 and rng.random() < 0.5:
                header_masks = (0xff0000, 0xff00, 0xff, int(rng.choice([0, 0xff000000])))
            else:
                masks = (0xff0000, 0xff00, 0xff)
        data = fx.bmp_file(pixels, w, h, bits, compression, palette, header, masks, header_masks,
                           top_down=header != 12 and bool(rng.random() < 0.3), colours_used=used)
        assert_equal_to_cv2(bmp, data)


@pytest.mark.parametrize('bits', [4, 8])
@pytest.mark.parametrize('seed', range(6))
def test_random_rle_bmp_equals_cv2(bits, seed):
    """RLE8 and RLE4 streams of runs, literals, deltas, ends of line and of
    bitmap, bottom-up and top-down, some ending before the image does."""
    rng = np.random.default_rng(10 * bits + seed)
    for _ in range(15):
        w, h = int(rng.integers(1, 25)), int(rng.integers(1, 15))
        palette = rng.integers(0, 256, (1 << bits) * 4).astype(np.uint8).tobytes()
        stream = fx.rle_stream(rng, w, h, bits) + (b'\0\0' * h if rng.random() < 0.5 else b'')
        assert_equal_to_cv2(bmp, fx.bmp_file(stream, w, h, bits, 1 if bits == 8 else 2, palette,
                                             top_down=bool(rng.random() < 0.2)))


def test_rle4_escapes_skip_no_rows():
    """OpenCV 5.0's RLE4 masks the rows out of its escapes: an end of bitmap
    ends the row only (the next code is read), a delta moves dx pixels on;
    a file that ends there reads as None. RLE8 honours both."""
    palette = bytes(range(64))
    ended = fx.bmp_file(b'\0\1', 4, 2, 4, 2, palette)
    assert cv2_read(ended) is None
    with pytest.raises(ValueError):
        bmp.decode(ended)
    two_rows = fx.bmp_file(b'\0\1\0\1', 4, 2, 4, 2, palette)
    assert_equal_to_cv2(bmp, two_rows)
    delta = fx.bmp_file(bytes([1, 0x12, 0, 2, 2, 1, 1, 0x34]) + b'\0\0', 4, 2, 4, 2, palette)
    assert_equal_to_cv2(bmp, delta)
    assert_equal_to_cv2(bmp, fx.bmp_file(b'\0\1', 4, 2, 8, 1, bytes(range(256)) * 4))


def test_32_bit_header_masks_truncate_gray():
    """A V4/V5 header's own 8-bit masks take OpenCV 5.0's masked path: the
    colour is the bytes, gray r * 0.299f + g * 0.587f + b * 0.114f in float,
    truncated; masks after an INFO header keep the rounded icvCvt gray."""
    rng = np.random.default_rng(3)
    pixels = rng.integers(0, 256, (40, 50, 4)).astype(np.uint8)
    masked = fx.bmp_file(fx.bmp_rows(pixels, 32), 50, 40, 32, 3, header_size=124,
                         header_masks=(0xff0000, 0xff00, 0xff, 0xff000000))
    assert bmp.parse(masked)['masked']
    assert_equal_to_cv2(bmp, masked)
    plain = fx.bmp_file(fx.bmp_rows(pixels, 32), 50, 40, 32, 3, masks=(0xff0000, 0xff00, 0xff))
    assert_equal_to_cv2(bmp, plain)
    assert (bmp.decode(masked, gray=True) != bmp.decode(plain, gray=True)).any()


def test_pillow_and_cv2_writers_equal_cv2():
    from PIL import Image
    rgb = fx.noisy(23, 31, 60)
    im = Image.fromarray(rgb)
    for mode in ('1', 'L', 'P', 'RGB', 'RGBA'):
        assert_equal_to_cv2(bmp, fx.pil_bytes(im.convert(mode), 'BMP'))
    for image in (rgb[..., ::-1], rgb[..., 0], np.dstack([rgb, rgb[..., :1]])):
        assert_equal_to_cv2(bmp, cv2.imencode('.bmp', image)[1].tobytes())
    for mode in ('1', 'L', 'RGB'):
        assert_equal_to_cv2(pnm, fx.pil_bytes(im.convert(mode), 'PPM'))
    for ext, image in (('.ppm', rgb[..., ::-1]), ('.pgm', rgb[..., 0]), ('.pbm', rgb[..., 0]),
                       ('.pgm', rgb[..., 0].astype(np.uint16) * 257)):
        assert_equal_to_cv2(pnm, cv2.imencode(ext, image)[1].tobytes())
    for mode in ('P', 'L', 'RGB', '1'):
        assert_equal_to_cv2(gif, fx.pil_bytes(im.convert(mode), 'GIF'))
    assert_equal_to_cv2(sunras, cv2.imencode('.ras', rgb[..., ::-1])[1].tobytes())
    assert_equal_to_cv2(sunras, cv2.imencode('.ras', rgb[..., 1])[1].tobytes())


def _ascii(values, rng) -> bytes:
    out = bytearray()
    for v in values:
        out += str(int(v)).encode() + [b' ', b'\n', b'\t\r\n'][int(rng.integers(0, 3))]
        if rng.random() < 0.02:
            out += b'# a comment\n'
    return bytes(out)


@pytest.mark.parametrize('kind', range(1, 7))
@pytest.mark.parametrize('seed', range(3))
def test_random_pnm_equals_cv2(kind, seed):
    """P1-P6 at maxvals 1-65535, samples above maxval, comments, PBM's digits
    without separators, truncation."""
    rng = np.random.default_rng(10 * kind + seed)
    for _ in range(8):
        w, h = int(rng.integers(1, 20)), int(rng.integers(1, 15))
        maxval = 1 if kind in (1, 4) else int(rng.choice([1, 2, 15, 100, 255, 256, 1000, 65535]))
        channels = 3 if kind in (3, 6) else 1
        head = (b'P%d' % kind + (b'\n# comment\n' if rng.random() < 0.3 else b' ')
                + b'%d %d' % (w, h) + (b'\n' if kind in (1, 4) else b'\n%d\n' % maxval))
        if kind == 4:
            body = rng.integers(0, 256, h * -(-w // 8)).astype(np.uint8).tobytes()
        elif kind in (5, 6):
            top = min(65536, (maxval + 1) * (3 if rng.random() < 0.2 else 1))
            body = rng.integers(0, top, (h, w, channels)).astype(
                '>u2' if maxval > 255 else np.uint8).tobytes()
        elif kind == 1 and rng.random() < 0.5:
            body = b''.join(str(int(v)).encode() for v in rng.integers(0, 2, w * h)) + b'\n'
        else:
            body = _ascii(rng.integers(0, maxval + 1 + int(rng.integers(0, 4)), h * w * channels),
                          rng)
        data = head + body
        if rng.random() < 0.1:
            data = data[:-int(rng.integers(1, 4))]
        assert_equal_to_cv2(pnm, data)


def test_pnm_maxval_is_not_scaled_in_binary():
    """A P5 with maxval 100 reads back as stored; the same samples in P2
    (ASCII) are scaled to 255, above maxval clamped first."""
    stored = bytes([0, 50, 99, 100, 120, 255, 3, 7])
    binary = b'P5\n4 2\n100\n' + stored
    np.testing.assert_array_equal(pnm.decode(binary, gray=True).reshape(-1), list(stored))
    assert_equal_to_cv2(pnm, binary)
    ascii_ = b'P2\n4 2\n100\n' + b' '.join(str(v).encode() for v in stored) + b'\n'
    np.testing.assert_array_equal(pnm.decode(ascii_, gray=True).reshape(-1),
                                  [min(v, 100) * 255 // 100 for v in stored])
    assert_equal_to_cv2(pnm, ascii_)
    deep = b'P5\n2 1\n65535\n' + np.array([0x1234, 0xff80], '>u2').tobytes()
    np.testing.assert_array_equal(pnm.decode(deep, gray=True), [[0x12, 0xff]])


@pytest.mark.parametrize('tuple_type,depth', [(b'GRAYSCALE', 1), (None, 1), (b'RGB', 3),
                                              (None, 3), (b'BLACKANDWHITE', 1), (None, 2),
                                              (None, 4)])
@pytest.mark.parametrize('maxval', [1, 100, 255, 300, 65535])
def test_pam_equals_cv2(tuple_type, depth, maxval):
    """GRAYSCALE and RGB tuples unscaled (RGB's channels land swapped in
    cv2's BGR image), maxval 1 as packed bits, no tuple type at depths 2
    and 4 or above maxval 255 as None."""
    rng = np.random.default_rng(depth * maxval)
    values = rng.integers(0, maxval + 1, (3, 7, depth))
    assert_equal_to_cv2(pnm, fx.pam_file(values, maxval, tuple_type))


@pytest.mark.parametrize('tuple_type', [b'GRAYSCALE_ALPHA', b'RGB_ALPHA'])
def test_pam_with_alpha_is_refused_by_name(tuple_type):
    values = np.zeros((3, 7, 2 if tuple_type == b'GRAYSCALE_ALPHA' else 4), np.uint8)
    with pytest.raises(NotImplementedError, match='ALPHA'):
        pnm.decode(fx.pam_file(values, 255, tuple_type))


@pytest.mark.parametrize('scale', [-1.0, 1.0, -2.5, 3.0, -0.01])
@pytest.mark.parametrize('channels', [1, 3])
def test_pfm_scaling_rule(scale, channels):
    """Each sample times float(1 / |scale|), rounded half to even, saturated
    (NaN, infinities and values past the int range give 0): 0.33 gives 0,
    1.2 gives 1, 0.5 gives 0, 2.5 gives 2. PF reads only in colour and Pf
    only in gray (cv2 returns None otherwise)."""
    rng = np.random.default_rng(channels)
    values = rng.normal(100, 80, (4, 6, channels)).astype(np.float32)
    values.reshape(-1)[:8] = [0.33, 1.2, 0.5, 2.5, np.nan, np.inf, -np.inf, 3e9]
    data = fx.pfm_file(values if channels == 3 else values[..., 0], scale)
    assert_equal_to_cv2(pnm, data)
    if scale == -1.0:
        got = pnm.decode(data, gray=channels == 1)
        assert list(got.reshape(-1)[:8]) == [0, 1, 0, 2, 0, 0, 0, 0]


@pytest.mark.parametrize('seed', range(8))
def test_random_gif_equals_cv2(seed):
    """Screens larger than the frame, global and local tables of every size,
    transparency, interlace, indices past the tables, later frames,
    truncation."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        sw, sh = int(rng.integers(1, 30)), int(rng.integers(1, 30))
        w, h = int(rng.integers(1, sw + 1)), int(rng.integers(1, sh + 1))
        global_bits = int(rng.integers(1, 9)) if rng.random() < 0.8 else None
        table = rng.integers(0, 256, (1 << global_bits, 3)) if global_bits else None
        local_bits = int(rng.integers(1, 9)) if table is None or rng.random() < 0.3 else None
        local = rng.integers(0, 256, (1 << local_bits, 3)) if local_bits else None
        n = max(1 << (global_bits or 0), 1 << (local_bits or 0))
        index = rng.integers(0, min(256, n + (2 if rng.random() < 0.1 else 0)), (h, w))
        frames = [dict(index=index, x=int(rng.integers(0, sw - w + 1)),
                       y=int(rng.integers(0, sh - h + 1)), local_table=local,
                       interlace=bool(rng.random() < 0.3),
                       transparent=int(rng.integers(0, n)) if rng.random() < 0.4 else None)]
        if rng.random() < 0.3:
            frames.append(dict(index=index[::-1]))
        background = int(rng.integers(0, (1 << global_bits) + int(rng.random() < 0.1))) \
            if global_bits else int(rng.integers(0, 4))
        data = fx.gif_file(frames, (sw, sh), table, background, loop=bool(rng.random() < 0.3))
        if rng.random() < 0.05:
            data = data[:-int(rng.integers(1, 5))]
        assert_equal_to_cv2(gif, data)


def test_gif_transparency_shows_the_background_colour():
    """A transparent index leaves the screen's colour, the global table's
    background entry (black without a global table), not its own."""
    rng = np.random.default_rng(9)
    table = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    index = rng.integers(0, 8, (5, 7))
    data = fx.gif_file([dict(index=index, transparent=2)], (7, 5), table, background=5)
    got = gif.decode(data)
    np.testing.assert_array_equal(got[index == 2], np.broadcast_to(table[5], got[index == 2].shape))
    np.testing.assert_array_equal(got[index != 2], table[index[index != 2]])
    assert_equal_to_cv2(gif, data)
    local = fx.gif_file([dict(index=index, transparent=2, local_table=table[:8])], (7, 5))
    assert (gif.decode(local)[index == 2] == 0).all()
    assert_equal_to_cv2(gif, local)


@pytest.mark.parametrize('depth', [1, 8, 24, 32])
@pytest.mark.parametrize('seed', range(3))
def test_random_sun_raster_equals_cv2(depth, seed):
    """Old and standard types, colormaps of every length, and the types cv2
    returns None for (byte-encoded, RGB-ordered), truncation."""
    rng = np.random.default_rng(10 * depth + seed)
    for _ in range(10):
        w, h = int(rng.integers(1, 20)), int(rng.integers(1, 10))
        pitch = ((w * depth + 7) // 8 + 1) & ~1
        pixels = rng.integers(0, 256, pitch * h).astype(np.uint8).tobytes()
        colormap = b''
        if depth <= 8 and rng.random() < 0.5:
            colormap = rng.integers(0, 256, 3 * int(rng.integers(1, (1 << depth) + 1))).astype(
                np.uint8).tobytes()
        data = fx.sun_file(w, h, depth, pixels, int(rng.choice([0, 1, 1, 2, 3])), colormap)
        if rng.random() < 0.1:
            data = data[:-3]
        assert_equal_to_cv2(sunras, data)


def test_sun_raster_gray_without_colormap_reads_black():
    """OpenCV converts a colormap to gray but leaves its gray table zero
    without one: a 1- or 8-bit file without a colormap reads all black in
    gray, its ramp in colour."""
    data = fx.sun_file(9, 5, 8, fx.sun_rows(np.arange(45).reshape(5, 9), 8))
    assert (sunras.decode(data, gray=True) == 0).all()
    np.testing.assert_array_equal(sunras.decode(data)[..., 0], np.arange(45).reshape(5, 9))
    assert_equal_to_cv2(sunras, data)


@pytest.mark.parametrize('seed', range(4))
def test_random_radiance_equals_cv2(seed):
    """cv2's run-length writer at widths below 8 (flat), 8 and up; values
    above 1 saturate."""
    rng = np.random.default_rng(seed)
    for _ in range(5):
        values = (rng.random((int(rng.integers(1, 12)), int(rng.integers(1, 40)), 3))
                  * rng.choice([0.5, 1.3, 10])).astype(np.float32)
        assert_equal_to_cv2(hdr, cv2.imencode('.hdr', values[..., ::-1])[1].tobytes())


def test_radiance_scaling_and_header_rules():
    """x255 after RGBE quantisation (0.917 gives 233), a product past the
    int range gives 0, a zero exponent black; XYZE, other orientations and
    truncated data read as None."""
    rgbe = np.array([[[234, 117, 0, 128], [255, 255, 255, 170], [7, 8, 9, 0]]], np.uint8)
    rgbe = np.repeat(rgbe, 2, 0)
    data = fx.hdr_flat(rgbe)
    got = hdr.decode(data)
    assert got[0, 0].tolist() == [233, 117, 0] and got[0, 1].tolist() == [0, 0, 0]
    assert got[0, 2].tolist() == [0, 0, 0]
    assert_equal_to_cv2(hdr, data)
    for bad in (data.replace(b'rgbe\n', b'xyze\n'), data.replace(b'-Y 2', b'+Y 2'),
                data.replace(b'+X 3', b'-X 3'), data[:-3], data.replace(b'\n\n', b'\nx\n')):
        assert cv2_read(bad) is None
        with pytest.raises(ValueError):
            hdr.decode(bad)
    with pytest.raises(ValueError, match='PIL does not identify'):
        hdr.header(data)


CORRUPT = {
    'bmp_truncated': lambda: fx.bmp_file(bytes(100), 20, 10, 24)[:-30],
    'bmp_bad_bits': lambda: fx.bmp_file(bytes(100), 5, 5, 2),
    'bmp_rle8_run_past_row': lambda: fx.bmp_file(bytes([9, 1]) + b'\0\1', 4, 2, 8, 1,
                                                 bytes(1024)),
    'pnm_truncated': lambda: b'P6\n9 7\n255\n' + bytes(50),
    'pnm_bad_number': lambda: b'P2\n2 2\n255\n1 x 3 4\n',
    'pam_no_endhdr': lambda: b'P7\nWIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\n',
    'pfm_zero_scale': lambda: b'Pf\n2 2\n0\n' + bytes(16),
    'gif_no_trailer': lambda: fx.gif_file([dict(index=np.zeros((3, 3), int))], (3, 3),
                                          np.zeros((4, 3)))[:-1],
    'gif_frame_outside': lambda: fx.gif_file([dict(index=np.zeros((3, 3), int), x=2)], (3, 3),
                                             np.zeros((4, 3))),
    # A 3x4 frame whose LZW data holds 3x3 indices.
    'gif_short_lzw': lambda: fx.gif_file([dict(index=np.zeros((3, 3), int))], (3, 4),
                                         np.zeros((4, 3))).replace(
        b'\x2c\0\0\0\0\x03\0\x03\0', b'\x2c\0\0\0\0\x03\0\x04\0'),
    'sunras_truncated': lambda: fx.sun_file(9, 5, 24, bytes(60)),
    'sunras_rle': lambda: fx.sun_file(4, 2, 8, bytes(8), kind=2),
    'hdr_bad_run': lambda: (b'#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 8\n'
                            + bytes([2, 2, 0, 8, 200, 5])),
}


@pytest.mark.parametrize('case', sorted(CORRUPT))
def test_corrupt_files_raise_where_cv2_returns_none(case, tmp_path):
    data = CORRUPT[case]()
    module = MODULES[case.split('_')[0].replace('pam', 'pnm').replace('pfm', 'pnm')]
    assert cv2_read(data) is None and cv2_read(data, gray=True) is None
    with pytest.raises(ValueError):
        module.decode(data, 'x')
    path = tmp_path / 'x.img'
    path.write_bytes(data)
    assert improc.is_image_readable(str(path)) == jax_improc.is_image_readable(str(path)) is False


def test_phone_sized_demo_bmp_equals_cv2(tmp_path):
    """The 4032x3024 24-bit BMP that chip_smoke mints for apps.demo_image."""
    path = str(tmp_path / 'large.bmp')
    with open(path, 'wb') as f:
        f.write(fx.large_bmp())
    np.testing.assert_array_equal(improc.imread(path), jax_improc.imread(path))
    np.testing.assert_array_equal(improc.imread(path, gray=True),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
