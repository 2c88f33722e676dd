"""Writes the still-image fixtures of `tests/torch_fixtures/images` and their
`manifest.json`: PNGs of every colour type and depth (built here through
`zlib`, with any filter, Adam7, PLTE, tRNS, eXIf and APNG chunks), JPEGs
that Pillow writes in CMYK and RGB (and edits of them: YCCK, RGB by
component IDs), WebPs that Pillow writes and that the libwebp Pillow bundles
writes through its advanced `WebPConfig` (ctypes), with the EXIF
orientation of each kind; TIFFs built here (`tiff_file`: strips and tiles,
classic and BigTIFF, both byte orders, planar 1 and 2, every compression
and predictor the port reads, old-style LZW, Orientation), written by
Pillow and cv2, and JPEG-compressed YCbCr ones written by the system
libtiff (ctypes); BMPs (cv2, Pillow, and built here: OS/2, V4, V5, RLE4,
RLE8, 555, 565, BI_BITFIELDS, top-down), PNM/PAM/PFM, GIFs (Pillow and built
here: a frame on a larger screen, local tables, transparency, interlace),
Sun rasters and Radiance files (cv2 and built here). The manifest holds,
for each file, the SHA-256 and shape of `cv2.imread` in colour (as RGB) and
in gray (null where cv2 returns None), and PIL's size ("PIL raises" where
PIL does not identify the file).

The phone-sized TIFF and BMP of `apps.demo_image` are minted at run time
(`large_tiff`, `large_bmp`; numpy only, so that the card's machine mints
them too).

Run `python tests/_torch_image_fixtures.py` to rewrite them (cv2, Pillow:
this machine only; the card's machine checks the hashes).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import glob
import hashlib
import io
import json
import os
import struct
import zlib
from pathlib import Path

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parent / 'torch_fixtures' / 'images'
MANIFEST = FIXTURE_DIR / 'manifest.json'
PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
LARGE = (3024, 4032)  # height, width of the phone-sized fixtures
PIL_RAISES = 'PIL raises'


def digest(im: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(im).tobytes()).hexdigest()


def read_manifest() -> dict:
    return json.loads(MANIFEST.read_text())


# --- PNG --------------------------------------------------------------------

def png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))


def tiff_orientation(value: int, little: bool = False) -> bytes:
    """A TIFF-structured EXIF block whose IFD0 holds one Orientation entry."""
    e = '<' if little else '>'
    return ((b'II' if little else b'MM') + struct.pack(e + 'HI', 42, 8) + struct.pack(e + 'H', 1)
            + struct.pack(e + 'HHIHH', 0x112, 3, 1, value, 0) + struct.pack(e + 'I', 0))


def _filter_row(row: np.ndarray, prior: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    r, p = row.astype(np.int32), prior.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]]) if len(r) else r
    up_left = np.concatenate([np.zeros(bpp, np.int32), p[:-bpp]]) if len(p) else p
    if kind == 0:
        pred = np.zeros_like(r)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = p
    elif kind == 3:
        pred = (left + p) >> 1
    else:
        est = left + p - up_left
        pa, pb, pc = np.abs(est - left), np.abs(est - p), np.abs(est - up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, p, up_left))
    return ((r - pred) & 255).astype(np.uint8)


def pack_samples(samples: np.ndarray, depth: int) -> bytes:
    """One row of samples (uint16 values) at `depth` bits, big-endian."""
    if depth == 16:
        return samples.astype('>u2').tobytes()
    if depth == 8:
        return samples.astype(np.uint8).tobytes()
    per = 8 // depth
    padded = np.zeros(-(-len(samples) // per) * per, np.uint8)
    padded[:len(samples)] = samples
    groups = padded.reshape(-1, per)
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return np.bitwise_or.reduce(groups << shifts, axis=1).astype(np.uint8).tobytes()


def png_scanlines(samples: np.ndarray, depth: int, interlace: bool, filters) -> bytes:
    """The filtered scanlines of [H, W, S] integer samples. `filters` is one
    filter type for every row, or a callable (row index) -> type."""
    h, w, s = samples.shape
    bpp = max(1, s * depth // 8)
    out = []
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    row_index = 0
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prior = None
        for row in sub:
            raw = np.frombuffer(pack_samples(row.reshape(-1), depth), np.uint8)
            if prior is None:
                prior = np.zeros_like(raw)
            kind = filters(row_index) if callable(filters) else filters
            row_index += 1
            out.append(bytes([kind]) + _filter_row(raw, prior, bpp, kind).tobytes())
            prior = raw
    return b''.join(out)


def png_file(samples: np.ndarray, depth: int, colour_type: int, interlace: bool = False,
             filters=0, palette=None, trns: bytes = None, exif: bytes = None,
             exif_after_idat: bool = False, extra_before_idat: bytes = b'',
             idat_pieces: int = 1, level: int = 6) -> bytes:
    """A PNG of [H, W, S] samples (S from the colour type), built chunk by
    chunk."""
    h, w = samples.shape[:2]
    ihdr = struct.pack('>IIBBBBB', w, h, depth, colour_type, 0, 0, int(interlace))
    stream = zlib.compress(png_scanlines(samples, depth, interlace, filters), level)
    cut = np.linspace(0, len(stream), idat_pieces + 1).astype(int)
    idat = b''.join(png_chunk(b'IDAT', stream[a:b]) for a, b in zip(cut[:-1], cut[1:]))
    head = png_chunk(b'IHDR', ihdr)
    if palette is not None:
        head += png_chunk(b'PLTE', np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        head += png_chunk(b'tRNS', trns)
    ex = png_chunk(b'eXIf', exif) if exif is not None else b''
    head += extra_before_idat
    if not exif_after_idat:
        head += ex
    tail = ex if exif_after_idat else b''
    return PNG_SIGNATURE + head + idat + tail + png_chunk(b'IEND', b'')


def random_png(rng, colour_type: int, depth: int, h: int, w: int, interlace=False, filters=0,
               with_trns=False, n_palette: int = None, **kwargs) -> bytes:
    s = SAMPLES[colour_type]
    top = (1 << depth) if colour_type != 3 else min(1 << depth, n_palette or (1 << depth))
    samples = rng.integers(0, top, (h, w, s)).astype(np.uint16)
    palette = trns = None
    if colour_type == 3:
        n = n_palette or (1 << depth)
        palette = rng.integers(0, 256, (n, 3))
        if with_trns:
            trns = rng.integers(0, 256, max(1, n // 2)).astype(np.uint8).tobytes()
    elif with_trns and colour_type in (0, 2):
        values = rng.integers(0, 1 << depth, SAMPLES[colour_type])
        trns = values.astype('>u2').tobytes()
    return png_file(samples, depth, colour_type, interlace, filters, palette, trns, **kwargs)


# --- WebP through the libwebp Pillow bundles --------------------------------

class WebPConfig(ctypes.Structure):
    """libwebp's `WebPConfig` (encode.h): ints and floats, then padding."""
    _fields_ = [(name, ctypes.c_float if name in ('quality', 'target_PSNR') else ctypes.c_int)
                for name in ('lossless', 'quality', 'method', 'image_hint', 'target_size',
                             'target_PSNR', 'segments', 'sns_strength', 'filter_strength',
                             'filter_sharpness', 'filter_type', 'autofilter', 'alpha_compression',
                             'alpha_filtering', 'alpha_quality', 'pass_', 'show_compressed',
                             'preprocessing', 'partitions', 'partition_limit',
                             'emulate_jpeg_size', 'thread_level', 'low_memory', 'near_lossless',
                             'exact', 'use_delta_palette', 'use_sharp_yuv', 'qmin', 'qmax')] + [
        ('pad', ctypes.c_uint32 * 16)]


class WebPPicture(ctypes.Structure):
    """libwebp's `WebPPicture` (encode.h), with room to spare at the end."""
    _fields_ = [('use_argb', ctypes.c_int), ('colorspace', ctypes.c_int),
                ('width', ctypes.c_int), ('height', ctypes.c_int),
                ('y', ctypes.c_void_p), ('u', ctypes.c_void_p), ('v', ctypes.c_void_p),
                ('y_stride', ctypes.c_int), ('uv_stride', ctypes.c_int),
                ('a', ctypes.c_void_p), ('a_stride', ctypes.c_int),
                ('pad1', ctypes.c_uint32 * 2),
                ('argb', ctypes.c_void_p), ('argb_stride', ctypes.c_int),
                ('pad2', ctypes.c_uint32 * 3),
                ('writer', ctypes.c_void_p), ('custom_ptr', ctypes.c_void_p),
                ('extra_info_type', ctypes.c_int), ('extra_info', ctypes.c_void_p),
                ('stats', ctypes.c_void_p), ('error_code', ctypes.c_int),
                ('progress_hook', ctypes.c_void_p), ('user_data', ctypes.c_void_p),
                ('pad3', ctypes.c_uint32 * 3), ('pad4', ctypes.c_void_p),
                ('pad5', ctypes.c_void_p), ('pad6', ctypes.c_uint32 * 8),
                ('memory_', ctypes.c_void_p), ('memory_argb_', ctypes.c_void_p),
                ('pad7', ctypes.c_void_p * 2), ('spare', ctypes.c_uint8 * 256)]


class WebPMemoryWriter(ctypes.Structure):
    _fields_ = [('mem', ctypes.c_void_p), ('size', ctypes.c_size_t),
                ('max_size', ctypes.c_size_t), ('pad', ctypes.c_uint32 * 4)]


_WEBP_ENCODER_ABI = 0x020f


def _libwebp() -> ctypes.CDLL:
    import PIL
    libs = Path(PIL.__file__).resolve().parent.parent / 'pillow.libs'
    ctypes.CDLL(str(next(libs.glob('libsharpyuv-*.so*'))), mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(str(next(libs.glob('libwebp-*.so*'))))
    lib.WebPConfigInitInternal.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int]
    lib.WebPPictureInitInternal.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.WebPPictureImportRGB.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.WebPPictureImportRGBA.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.WebPEncode.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.WebPValidateConfig.argtypes = [ctypes.c_void_p]
    lib.WebPMemoryWriterInit.argtypes = [ctypes.c_void_p]
    lib.WebPMemoryWriterClear.argtypes = [ctypes.c_void_p]
    lib.WebPPictureFree.argtypes = [ctypes.c_void_p]
    return lib


def libwebp_encode(image: np.ndarray, **options) -> bytes:
    """A WebP of an RGB (or RGBA) uint8 image written by libwebp's advanced
    API: `options` are `WebPConfig` fields (quality, method, segments,
    filter_strength, filter_sharpness, filter_type, partitions, lossless,
    sns_strength, autofilter...), set after WebPConfigInit's defaults."""
    lib = _libwebp()
    config = WebPConfig()
    assert lib.WebPConfigInitInternal(ctypes.byref(config), 0, 75.0, _WEBP_ENCODER_ABI)
    for key, value in options.items():
        setattr(config, key, value)
    assert lib.WebPValidateConfig(ctypes.byref(config)), options
    image = np.ascontiguousarray(image, np.uint8)
    h, w, c = image.shape
    pic = WebPPicture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), _WEBP_ENCODER_ABI)
    pic.width, pic.height, pic.use_argb = w, h, int(bool(config.lossless))
    importer = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    assert importer(ctypes.byref(pic), image.ctypes.data, w * c)
    writer = WebPMemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    pic.custom_ptr = ctypes.addressof(writer)
    try:
        assert lib.WebPEncode(ctypes.byref(config), ctypes.byref(pic)), pic.error_code
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


def riff(chunks) -> bytes:
    """A WebP file of (fourcc, payload) chunks."""
    body = b'WEBP' + b''.join(k + struct.pack('<I', len(d)) + d + b'\0' * (len(d) & 1)
                              for k, d in chunks)
    return b'RIFF' + struct.pack('<I', len(body)) + body


def webp_chunks(data: bytes) -> list:
    out, pos = [], 12
    while pos + 8 <= len(data):
        k, n = data[pos:pos + 4], struct.unpack_from('<I', data, pos + 4)[0]
        out.append((k, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def vp8x(flags: int, width: int, height: int):
    return b'VP8X', struct.pack('<I', flags) + struct.pack('<I', width - 1)[:3] + struct.pack(
        '<I', height - 1)[:3]


def with_exif(data: bytes, block: bytes, width: int, height: int) -> bytes:
    """A simple-format WebP rewritten as VP8X (EXIF flag) with an EXIF chunk
    after the bitstream."""
    chunks = webp_chunks(data)
    flags = 0x08
    if chunks[0][0] == b'VP8X':
        flags |= struct.unpack('<I', chunks[0][1][:4])[0]
        chunks = chunks[1:]
    return riff([vp8x(flags, width, height)] + chunks + [(b'EXIF', block)])


def animated_offset(frames, offsets, canvas) -> bytes:
    """An animated WebP of simple-format frames at even offsets on a canvas
    (width, height), each shown 100 ms, no blending."""
    anmf = []
    for data, (x, y) in zip(frames, offsets):
        sub = webp_chunks(data)
        if sub[0][0] == b'VP8X':
            sub = sub[1:]
        fourcc, payload = next((k, p) for k, p in sub if k in (b'VP8 ', b'VP8L'))
        if fourcc == b'VP8 ':
            w, h = (struct.unpack_from('<H', payload, 6)[0] & 0x3fff,
                    struct.unpack_from('<H', payload, 8)[0] & 0x3fff)
        else:
            bits = struct.unpack_from('<I', payload, 1)[0]
            w, h = (bits & 0x3fff) + 1, ((bits >> 14) & 0x3fff) + 1
        head = b''.join(struct.pack('<I', v)[:3] for v in (x // 2, y // 2, w - 1, h - 1, 100))
        body = b''.join(k + struct.pack('<I', len(d)) + d + b'\0' * (len(d) & 1) for k, d in sub)
        anmf.append((b'ANMF', head + b'\x02' + body))
    anim = (b'ANIM', struct.pack('<IH', 0xff204060, 0))
    return riff([vp8x(0x02 | 0x10, *canvas), anim] + anmf)


# --- content ----------------------------------------------------------------

def scene(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Synthetic RGB content: gradients, discs and bars, integer-valued (the
    same on every machine)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.int64)
    im = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                   (xx + 2 * yy) * 255 // max(w + 2 * h - 3, 1)], -1)
    for _ in range(6):
        cx, cy = rng.integers(0, w), rng.integers(0, h)
        r = int(rng.integers(max(2, min(h, w) // 10), max(3, min(h, w) // 3)))
        im[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = rng.integers(0, 256, 3)
    for _ in range(3):
        x0 = int(rng.integers(0, w))
        im[:, x0:x0 + max(1, w // 30)] = rng.integers(0, 256, 3)
    return im.astype(np.uint8)


def noisy(h: int, w: int, seed: int, sigma: float = 12.0) -> np.ndarray:
    im = scene(h, w, seed).astype(np.float64)
    im += np.random.default_rng(seed + 1).normal(0, sigma, im.shape)
    return np.clip(np.round(im), 0, 255).astype(np.uint8)


def pil_bytes(image, fmt: str, **options) -> bytes:
    out = io.BytesIO()
    image.save(out, fmt, **options)
    return out.getvalue()


# --- the fixture set --------------------------------------------------------

def png_fixtures() -> dict:
    from PIL import Image
    import cv2
    rng = np.random.default_rng(23)
    files = {}
    for ct, depths in DEPTHS.items():
        for depth in depths:
            for interlace in (False, True):
                name = f'png_ct{ct}_d{depth}{"_adam7" if interlace else ""}.png'
                files[name] = random_png(rng, ct, depth, 17, 23, interlace, lambda i: i % 5)
    files['png_ct0_d8_trns.png'] = random_png(rng, 0, 8, 19, 13, filters=4, with_trns=True)
    files['png_ct2_d16_trns.png'] = random_png(rng, 2, 16, 19, 13, filters=3, with_trns=True)
    files['png_ct3_d2_trns.png'] = random_png(rng, 3, 2, 19, 13, filters=1, with_trns=True)
    files['png_ct3_d8_short_palette.png'] = random_png(rng, 3, 8, 19, 13, filters=2,
                                                      n_palette=40)
    rgba = np.dstack([noisy(37, 53, 4), rng.integers(0, 256, (37, 53), dtype=np.uint8)])
    quantized = Image.fromarray(rgba, 'RGBA').quantize(16)
    files['png_pillow_quantize16.png'] = pil_bytes(quantized, 'PNG')
    # A 4-bit palette photo-sized PNG (with tRNS) for demo_image on the card.
    scene_rgba = np.dstack([scene(480, 640, 3), np.full((480, 640), 255, np.uint8)])
    scene_rgba[:40, :40, 3] = 0
    files['png_palette16_640x480.png'] = pil_bytes(
        Image.fromarray(scene_rgba, 'RGBA').quantize(16), 'PNG')
    deep = (noisy(29, 41, 5).astype(np.uint16) * 257
            + rng.integers(0, 256, (29, 41, 3)).astype(np.uint16))
    files['png_cv2_rgb16.png'] = cv2.imencode('.png', deep)[1].tobytes()
    files['png_cv2_gray16.png'] = cv2.imencode('.png', deep[..., 0])[1].tobytes()
    frames = [Image.fromarray(noisy(24, 32, 10 + k)) for k in range(3)]
    files['png_pillow_apng.png'] = pil_bytes(frames[0], 'PNG', save_all=True,
                                             append_images=frames[1:], duration=100)
    samples = noisy(21, 34, 6).astype(np.uint16)
    files['png_idat_split.png'] = png_file(samples, 8, 2, filters=lambda i: (i * 3) % 5,
                                           idat_pieces=5)
    files['png_exif_o6.png'] = png_file(samples, 8, 2, filters=4, exif=tiff_orientation(6))
    files['png_exif_o3_after_idat.png'] = png_file(samples, 8, 2, filters=1,
                                                   exif=tiff_orientation(3), exif_after_idat=True)
    files['png_exif_o8_ii.png'] = png_file(samples, 8, 2, filters=3,
                                           exif=tiff_orientation(8, little=True))
    files['png_exif_o5_gray16_adam7.png'] = png_file(
        deep[..., :1], 16, 0, interlace=True, filters=4, exif=tiff_orientation(5))
    big = scene(*LARGE, seed=1).astype(np.uint16)
    files['png_large_paeth.png'] = png_file(big, 8, 2, filters=4, level=9)
    return files


def jpeg_fixtures() -> dict:
    from PIL import Image
    import cv2
    files = {}
    cmyk = np.dstack([noisy(37, 53, 7), noisy(37, 53, 8)[..., :1]])
    files['jpeg_cmyk.jpg'] = pil_bytes(Image.fromarray(cmyk, 'CMYK'), 'JPEG', quality=90)
    files['jpeg_cmyk_420.jpg'] = pil_bytes(Image.fromarray(cmyk, 'CMYK'), 'JPEG', quality=75,
                                           subsampling=2)
    files['jpeg_cmyk_progressive.jpg'] = pil_bytes(Image.fromarray(cmyk, 'CMYK'), 'JPEG',
                                                   quality=80, progressive=True)
    ycck = bytearray(files['jpeg_cmyk_420.jpg'])
    adobe = ycck.find(b'Adobe')
    ycck[adobe + 11] = 2  # the Adobe transform: YCCK
    files['jpeg_ycck.jpg'] = bytes(ycck)
    rgb = noisy(33, 47, 9)
    files['jpeg_rgb_pillow.jpg'] = pil_bytes(Image.fromarray(rgb), 'JPEG', quality=85,
                                             keep_rgb=True, subsampling=0)
    data = bytearray(cv2.imencode('.jpg', rgb[..., ::-1], [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])[1].tobytes())
    # Components named R, G and B, the JFIF segment taken out: libjpeg reads
    # the file as RGB-coded.
    pos, segments = 2, {}
    while data[pos] == 0xFF and data[pos + 1] != 0xDA:
        segments.setdefault(data[pos + 1], pos)
        pos += 2 + struct.unpack('>H', data[pos + 2:pos + 4])[0]
    segments[0xDA] = pos
    for i, letter in enumerate(b'RGB'):
        data[segments[0xC0] + 10 + 3 * i] = letter
        data[segments[0xDA] + 5 + 2 * i] = letter
    app0 = segments[0xE0]
    length = struct.unpack('>H', data[app0 + 2:app0 + 4])[0]
    files['jpeg_rgb_ids.jpg'] = bytes(data[:app0] + data[app0 + 2 + length:])
    exif = Image.Exif()
    exif[0x0112] = 6
    files['jpeg_cmyk_exif_o6.jpg'] = pil_bytes(Image.fromarray(cmyk, 'CMYK'), 'JPEG',
                                               quality=90, exif=exif.tobytes())
    return files


def webp_fixtures() -> dict:
    from PIL import Image
    files = {}
    im = noisy(45, 70, 11)
    alpha = np.random.default_rng(12).integers(0, 256, im.shape[:2], dtype=np.uint8)
    files['webp_lossy_pillow.webp'] = pil_bytes(Image.fromarray(im), 'WEBP', quality=80)
    files['webp_lossy_q5.webp'] = pil_bytes(Image.fromarray(im), 'WEBP', quality=5, method=6)
    files['webp_lossy_odd_size.webp'] = pil_bytes(Image.fromarray(noisy(37, 53, 13)), 'WEBP',
                                                  quality=60)
    files['webp_lossy_alpha.webp'] = pil_bytes(Image.fromarray(np.dstack([im, alpha])), 'WEBP',
                                               quality=70)
    files['webp_lossless_pillow.webp'] = pil_bytes(Image.fromarray(im), 'WEBP', lossless=True)
    files['webp_lossless_alpha.webp'] = pil_bytes(Image.fromarray(np.dstack([im, alpha])),
                                                  'WEBP', lossless=True, quality=100, method=6)
    for n in (2, 4, 16, 200):  # colour indexing at 8, 4, 2 and 1 pixels per byte
        pal = (im.astype(np.int32) * n // 256 * (255 // max(n - 1, 1))).astype(np.uint8)
        if n == 200:
            pal = (im // 8 * 8).astype(np.uint8)
        files[f'webp_lossless_colors{n}.webp'] = pil_bytes(Image.fromarray(pal), 'WEBP',
                                                           lossless=True, quality=50)
    files['webp_lossless_fast.webp'] = libwebp_encode(im, lossless=1, quality=0.0, method=0)
    files['webp_lossless_best.webp'] = libwebp_encode(noisy(60, 90, 14, 4.0), lossless=1,
                                                      quality=100.0, method=6)
    tall = noisy(150, 140, 15)
    files['webp_simple_filter.webp'] = libwebp_encode(tall, filter_type=0, filter_strength=70)
    files['webp_normal_sharpness7.webp'] = libwebp_encode(tall, filter_type=1,
                                                          filter_strength=80, filter_sharpness=7)
    files['webp_no_filter.webp'] = libwebp_encode(tall, filter_strength=0, autofilter=0)
    files['webp_partitions8.webp'] = libwebp_encode(tall, partitions=3, method=0)
    files['webp_partitions2_segments2.webp'] = libwebp_encode(
        tall, partitions=1, method=2, segments=2, filter_type=0, filter_sharpness=3)
    files['webp_partitions4_simple_sharp.webp'] = libwebp_encode(
        tall, partitions=2, method=1, filter_type=0, filter_sharpness=6, filter_strength=90)
    files['webp_segments1.webp'] = libwebp_encode(tall, segments=1, quality=40.0)
    files['webp_segments3.webp'] = libwebp_encode(tall, segments=3, sns_strength=100)
    files['webp_segments4.webp'] = libwebp_encode(tall, segments=4, sns_strength=80,
                                                  quality=90.0)
    flat = np.full((150, 140, 3), 100, np.uint8)
    flat[40:90, 30:100] = (200, 50, 20)  # all-zero macroblocks: the skip flag
    files['webp_skip.webp'] = libwebp_encode(flat, quality=50.0, method=0)
    frames = [Image.fromarray(noisy(40, 60, 20 + k)) for k in range(3)]
    files['webp_animated_pillow.webp'] = pil_bytes(frames[0], 'WEBP', save_all=True,
                                                   append_images=frames[1:], duration=100,
                                                   quality=70)
    small = [pil_bytes(Image.fromarray(noisy(20, 30, 30)), 'WEBP', quality=70),
             pil_bytes(Image.fromarray(noisy(40, 60, 31)), 'WEBP', lossless=True)]
    files['webp_animated_offset.webp'] = animated_offset(small, [(10, 6), (0, 0)], (60, 40))
    files['webp_exif_o6_lossy.webp'] = with_exif(files['webp_lossy_odd_size.webp'],
                                                 tiff_orientation(6), 53, 37)
    files['webp_exif_o3_lossless.webp'] = with_exif(files['webp_lossless_pillow.webp'],
                                                    tiff_orientation(3, little=True), 70, 45)
    files['webp_exif_o7_alpha.webp'] = with_exif(files['webp_lossy_alpha.webp'],
                                                 tiff_orientation(7), 70, 45)
    big = scene(*LARGE, seed=2)
    files['webp_large_o6.webp'] = with_exif(
        pil_bytes(Image.fromarray(big), 'WEBP', quality=60), tiff_orientation(6), *LARGE[::-1])
    return files


# --- TIFF -------------------------------------------------------------------

_TIFF_TYPES = {1: 'B', 3: 'H', 4: 'I', 5: 'II', 16: 'Q'}


def lzw_encode(data: bytes, old_style: bool = False) -> bytes:
    """TIFF LZW of `data`: MSB-first codes with the early change, or the old
    LSB-first form without it; a clear code whenever the table fills."""
    acc, buf, nbits = bytearray(), 0, 0

    def put(code, width):
        nonlocal buf, nbits
        if old_style:
            buf |= code << nbits
            nbits += width
            while nbits >= 8:
                acc.append(buf & 255)
                buf >>= 8
                nbits -= 8
        else:
            buf = (buf << width) | code
            nbits += width
            while nbits >= 8:
                acc.append((buf >> (nbits - 8)) & 255)
                nbits -= 8
                buf &= (1 << nbits) - 1

    def width_for(nxt):
        limit = nxt + (0 if old_style else 1)
        return 9 if limit <= 512 else 10 if limit <= 1024 else 11 if limit <= 2048 else 12

    table, nxt, w = {bytes([i]): i for i in range(256)}, 258, b''
    put(256, 9)
    for b in data:
        c = bytes([b])
        if w + c in table:
            w += c
            continue
        put(table[w], width_for(nxt))
        table[w + c] = nxt
        nxt += 1
        w = c
        if nxt >= 4094:
            put(256, width_for(nxt))
            table, nxt = {bytes([i]): i for i in range(256)}, 258
    if w:
        put(table[w], width_for(nxt))
        nxt += 1
    put(257, width_for(nxt))
    if nbits:
        acc.append((buf << (8 - nbits)) & 255 if not old_style else buf & 255)
    return bytes(acc)


def lzw_literal(data: bytes) -> bytes:
    """TIFF LZW of `data` in 9-bit literal codes only (a clear code every
    253, before the width grows): valid LZW that numpy writes fast, at 9
    bits a byte."""
    raw = np.frombuffer(data, np.uint8).astype(np.uint16)
    groups = -(-len(raw) // 253)
    codes = np.full((groups, 254), 256, np.uint16)
    flat = np.zeros(groups * 253, np.uint16)
    flat[:len(raw)] = raw
    codes[:, 1:] = flat.reshape(groups, 253)
    codes = codes.reshape(-1)[:1 + len(raw) + (len(raw) - 1) // 253]
    codes = np.concatenate([codes, [257], np.zeros(-(len(codes) + 1) % 8, np.uint16)])
    c = codes.reshape(-1, 8).T  # eight 9-bit codes make nine bytes, MSB first
    out = np.empty((9, c.shape[1]), np.uint16)
    out[0] = c[0] >> 1
    for i in range(1, 8):
        out[i] = ((c[i - 1] & ((1 << i) - 1)) << (8 - i)) | (c[i] >> (i + 1))
    out[8] = c[7] & 255
    return out.T.astype(np.uint8).tobytes()


def packbits(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
        else:
            j = i
            while j < n and j - i < 128 and not (j + 1 < n and data[j] == data[j + 1]):
                j += 1
            j = max(j, i + 1)
            out += bytes([j - i - 1]) + data[i:j]
            i = j
    return bytes(out)


def pack_bits(values: np.ndarray, bits: int, order: str = '>') -> bytes:
    """One row of samples at `bits` bits: 8, 16 (in `order`) or any width
    packed MSB first."""
    if bits == 16:
        return np.asarray(values).astype(order + 'u2').tobytes()
    if bits == 8:
        return np.asarray(values).astype(np.uint8).tobytes()
    v = np.asarray(values, np.uint32)
    b = ((v[:, None] >> np.arange(bits - 1, -1, -1, dtype=np.uint32)) & 1).astype(np.uint8)
    return np.packbits(b.reshape(-1)).tobytes()


def tiff_file(samples, bits: int, photometric: int, compression: int = 1, predictor: int = 1,
              planar: int = 1, tile=None, rows_per_strip=None, big: bool = False,
              little: bool = True, extra=(), colormap=None, sample_format=None,
              extra_samples=None, orientation=None, old_lzw: bool = False,
              literal_lzw: bool = False, ycbcr=None) -> bytes:
    """A TIFF of [H, W, S] integer samples built tag by tag: strips
    (`rows_per_strip`) or tiles (`tile` = (width, length)), classic or
    BigTIFF, either byte order, planar 1 or 2, compression 1, 5 (LZW; old
    style, or literal codes), 8 and 32946 (Deflate) or 32773 (PackBits),
    predictor 2; `extra` adds (tag, type, values). With `ycbcr` = (h, v),
    8-bit Y, Cb, Cr samples stored in YCbCr blocks (h x v luma samples, the
    block's first Cb and Cr)."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, s = samples.shape
    order = '<' if little else '>'
    planes = [samples] if planar == 1 else [samples[..., i:i + 1] for i in range(s)]
    if tile:
        tw, th = tile
        grid = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        rps = rows_per_strip or h
        grid = [(y, 0) for y in range(0, h, rps)]
    chunks = []
    for p in planes:
        ps = p.shape[2]
        for y, x in grid:
            if tile:
                blk = np.zeros((th, tw, ps), p.dtype)
                sub = p[y:y + th, x:x + tw]
                blk[:sub.shape[0], :sub.shape[1]] = sub
            else:
                blk = p[y:y + rps]
            if ycbcr:
                bh, bv = ycbcr
                pad = np.zeros((-(-blk.shape[0] // bv) * bv, -(-blk.shape[1] // bh) * bh, 3),
                               np.uint8)
                pad[:blk.shape[0], :blk.shape[1]] = blk
                ry, rx = pad.shape[0] // bv, pad.shape[1] // bh
                luma = pad[..., 0].reshape(ry, bv, rx, bh).transpose(0, 2, 1, 3)
                raw = np.concatenate([luma.reshape(ry, rx, bv * bh), pad[::bv, ::bh, 1:]],
                                     -1).tobytes()
            else:
                if predictor == 2:
                    d = blk.astype(np.int64)
                    d[:, 1:] = d[:, 1:] - d[:, :-1]
                    blk = d & ((1 << bits) - 1)
                raw = (np.asarray(blk).astype(order + 'u2' if bits == 16 else np.uint8).tobytes()
                       if bits in (8, 16) else
                       b''.join(pack_bits(r.reshape(-1), bits, order) for r in blk))
            if compression == 5:
                raw = lzw_literal(raw) if literal_lzw else lzw_encode(raw, old_lzw)
            elif compression in (8, 32946):
                raw = zlib.compress(raw)
            elif compression == 32773:
                raw = packbits(raw)
            chunks.append(raw)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * s), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [s]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if ycbcr:
        tags[530] = (3, list(ycbcr))
    if sample_format:
        tags[339] = (3, [sample_format] * s)
    if extra_samples is not None:
        tags[338] = (3, list(extra_samples))
    if orientation:
        tags[274] = (3, [orientation])
    if colormap is not None:
        tags[320] = (3, [int(v) for v in np.asarray(colormap).T.reshape(-1)])
    if tile:
        tags[322], tags[323] = (4, [tile[0]]), (4, [tile[1]])
    else:
        tags[278] = (4, [rows_per_strip or h])
    for tag, kind, values in extra:
        tags[tag] = (kind, values)
    head = 16 if big else 8
    data, offsets = bytearray(), []
    for c in chunks:
        offsets.append(head + len(data))
        data += c + b'\0' * (len(c) & 1)
    off_tag, count_tag = (324, 325) if tile else (273, 279)
    tags[off_tag] = (16 if big else 4, offsets)
    tags[count_tag] = (16 if big else 4, [len(c) for c in chunks])
    ifd_at = head + len(data)
    inline = 8 if big else 4
    extra_at = ifd_at + (8 if big else 2) + len(tags) * (20 if big else 12) + (8 if big else 4)
    ifd, ext = bytearray(struct.pack(order + ('Q' if big else 'H'), len(tags))), bytearray()
    for tag in sorted(tags):
        kind, values = tags[tag]
        payload = b''.join(struct.pack(order + _TIFF_TYPES[kind], *(v if kind == 5 else (v,)))
                           for v in values)
        ifd += struct.pack(order + ('HHQ' if big else 'HHI'), tag, kind, len(values))
        if len(payload) <= inline:
            ifd += payload.ljust(inline, b'\0')
        else:
            ifd += struct.pack(order + ('Q' if big else 'I'), extra_at + len(ext))
            ext += payload + b'\0' * (len(payload) & 1)
    ifd += b'\0' * (8 if big else 4)
    mark = b'II' if little else b'MM'
    top = (mark + struct.pack(order + 'HHHQ', 43, 8, 0, ifd_at) if big
           else mark + struct.pack(order + 'HI', 42, ifd_at))
    return top + bytes(data) + bytes(ifd) + bytes(ext)


def _libtiff():
    lib = ctypes.CDLL(ctypes.util.find_library('tiff') or 'libtiff.so.6')
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    for f in (lib.TIFFWriteEncodedTile, lib.TIFFWriteEncodedStrip):
        f.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_ssize_t]
        f.restype = ctypes.c_ssize_t
    return lib


def libtiff_jpeg(rgb: np.ndarray, tile=None, rows_per_strip=16, subsampling=(2, 2),
                 ycbcr: bool = True, quality: int = 75) -> bytes:
    """A JPEG-compressed TIFF that the system libtiff writes (YCbCr with
    JPEGCOLORMODE_RGB, or RGB as coded), in strips or tiles."""
    import tempfile
    lib = _libtiff()
    h, w, c = rgb.shape
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'x.tif')
        tif = lib.TIFFOpen(path.encode(), b'w')

        def field(tag, *values):
            assert lib.TIFFSetField(ctypes.c_void_p(tif), ctypes.c_uint32(tag), *values) == 1

        field(256, ctypes.c_uint32(w))
        field(257, ctypes.c_uint32(h))
        field(258, ctypes.c_int(8))
        field(277, ctypes.c_int(c))
        field(284, ctypes.c_int(1))
        field(259, ctypes.c_int(7))
        if ycbcr:
            field(262, ctypes.c_int(6))
            field(530, ctypes.c_int(subsampling[0]), ctypes.c_int(subsampling[1]))
            field(65538, ctypes.c_int(1))  # TIFFTAG_JPEGCOLORMODE: RGB
        else:
            field(262, ctypes.c_int(2))
        field(65537, ctypes.c_int(quality))  # TIFFTAG_JPEGQUALITY
        if tile:
            field(322, ctypes.c_uint32(tile[0]))
            field(323, ctypes.c_uint32(tile[1]))
            n = 0
            for ty in range(0, h, tile[1]):
                for tx in range(0, w, tile[0]):
                    blk = np.zeros((tile[1], tile[0], c), np.uint8)
                    sub = rgb[ty:ty + tile[1], tx:tx + tile[0]]
                    blk[:sub.shape[0], :sub.shape[1]] = sub
                    assert lib.TIFFWriteEncodedTile(ctypes.c_void_p(tif), n, blk.ctypes.data,
                                                    blk.nbytes) > 0
                    n += 1
        else:
            field(278, ctypes.c_uint32(rows_per_strip))
            for i, y in enumerate(range(0, h, rows_per_strip)):
                blk = np.ascontiguousarray(rgb[y:y + rows_per_strip])
                assert lib.TIFFWriteEncodedStrip(ctypes.c_void_p(tif), i, blk.ctypes.data,
                                                 blk.nbytes) > 0
        lib.TIFFClose(ctypes.c_void_p(tif))
        with open(path, 'rb') as f:
            return f.read()


@functools.lru_cache(maxsize=1)
def large_scene() -> np.ndarray:
    """The phone-sized scene of the minted TIFF and BMP (read-only)."""
    im = scene(*LARGE, seed=7)
    im.flags.writeable = False
    return im


def large_rgb16() -> np.ndarray:
    """The phone-sized 16-bit RGB scene: large_scene() times 257 plus a
    slow low-byte pattern."""
    h, w = LARGE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.uint16)
    low = (xx // 7 + yy // 5) % 64
    return large_scene().astype(np.uint16) * 257 + low[..., None]


def large_tiff() -> bytes:
    """The 4032x3024 16-bit RGB TIFF of demo_image: LZW (literal codes) with
    predictor 2 in 256x256 tiles, little-endian."""
    return tiff_file(large_rgb16(), 16, 2, compression=5, predictor=2, tile=(256, 256),
                     literal_lzw=True)


# --- BMP --------------------------------------------------------------------

def bmp_file(pixels: bytes, width: int, height: int, bits: int, compression: int = 0,
             palette: bytes = None, header_size: int = 40, masks=None, header_masks=None,
             top_down: bool = False, colours_used: int = 0) -> bytes:
    """A BMP of raw (already padded, or RLE) pixel data: BITMAPCOREHEADER (12
    bytes, 3-byte palette entries) or a longer header (4-byte entries);
    `masks` (R, G, B) follow the header, `header_masks` (R, G, B, A) go
    inside a V3+ header."""
    if header_size == 12:
        info = struct.pack('<IHHHH', 12, width, height, 1, bits)
    else:
        info = struct.pack('<IiiHHIIiiII', header_size, width, -height if top_down else height,
                           1, bits, compression, len(pixels), 2835, 2835, colours_used, 0)
        body = bytearray(header_size - 40)
        if header_masks is not None:
            body[:16] = struct.pack('<IIII', *header_masks)
        info += bytes(body)
    after = b'' if masks is None else struct.pack('<III', *masks)
    offset = 14 + len(info) + len(after) + len(palette or b'')
    return (b'BM' + struct.pack('<IHHI', offset + len(pixels), 0, 0, offset) + info + after
            + (palette or b'') + pixels)


def bmp_rows(rows: np.ndarray, bits: int) -> bytes:
    """[H, W(, C)] values as bottom-up rows at `bits`, each padded to 4 bytes
    (24 and 32 bits: B, G, R[, A] given as such)."""
    out = []
    for row in rows[::-1]:
        raw = pack_bits(row.reshape(-1), bits) if bits < 8 else row.astype(np.uint8).tobytes() \
            if bits != 16 else row.astype('<u2').tobytes()
        out.append(raw + b'\0' * (-len(raw) % 4))
    return b''.join(out)


def rle_stream(rng, width: int, height: int, bits: int) -> bytes:
    """Random RLE8 or RLE4 data: runs, literals, deltas, ends of line and
    an end of bitmap."""
    out, x, y = bytearray(), 0, 0
    while y < height:
        r = rng.random()
        if r < 0.4 and x < width:
            n = int(rng.integers(1, width - x + 1))
            out += bytes([n, int(rng.integers(0, 256))])
            x += n
        elif r < 0.7 and width - x >= 3:
            n = int(rng.integers(3, width - x + 1))
            nb = n if bits == 8 else (n + 1) // 2
            out += bytes([0, n]) + rng.integers(0, 256, nb).astype(np.uint8).tobytes()
            out += b'\0' * (nb % 2)
            x += n
        elif r < 0.8:
            dx, dy = int(rng.integers(0, max(1, width - x))), int(rng.integers(0, 2))
            out += bytes([0, 2, dx, dy])
            x, y = x + dx, y + dy
        elif r < 0.97:
            out += b'\0\0'
            x, y = 0, y + 1
        else:
            break
    return bytes(out + b'\0\1')


def large_bmp() -> bytes:
    """The 4032x3024 24-bit BMP of demo_image (bottom-up)."""
    h, w = LARGE
    rows = large_scene()[::-1, :, ::-1].reshape(h, w * 3)  # bottom-up B, G, R; no padding
    return bmp_file(rows.tobytes(), w, h, 24)


def gray_tiff(gray: np.ndarray) -> bytes:
    """An 8-bit MinIsBlack TIFF of a gray image, PackBits in 16-row strips."""
    return tiff_file(gray, 8, 1, compression=32773, rows_per_strip=16)


def gray_bmp(gray: np.ndarray) -> bytes:
    """An 8-bit BMP of a gray image with a gray palette."""
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, 1)
    palette[:, 3] = 0
    return bmp_file(bmp_rows(gray, 8), gray.shape[1], gray.shape[0], 8,
                    palette=palette.tobytes())


# --- GIF, PNM, Sun raster, Radiance -----------------------------------------

def gif_lzw(indices, min_code_size: int) -> bytes:
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out, buf, nb = bytearray(), 0, 0

    def put(code, width):
        nonlocal buf, nb
        buf |= code << nb
        nb += width
        while nb >= 8:
            out.append(buf & 255)
            buf >>= 8
            nb -= 8

    width, table, nxt, w = min_code_size + 1, {(i,): i for i in range(clear)}, eoi + 1, ()
    put(clear, width)
    for k in indices:
        wk = w + (int(k),)
        if wk in table:
            w = wk
            continue
        put(table[w], width)
        if nxt < 4096:
            table[wk] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        else:
            put(clear, width)
            width, table, nxt = min_code_size + 1, {(i,): i for i in range(clear)}, eoi + 1
        w = (int(k),)
    if w:
        put(table[w], width)
    put(eoi, width)
    if nb:
        out.append(buf & 255)
    return bytes(out)


def gif_file(frames, screen, global_table=None, background: int = 0, version=b'89a',
             loop: bool = False) -> bytes:
    """A GIF of frames, each a dict of `index` [h, w], `x`, `y`,
    `local_table`, `interlace`, `transparent` and `disposal`, on a screen
    (width, height)."""
    def table_bytes(table):
        bits = max(1, int(np.ceil(np.log2(max(2, len(table))))))
        t = np.zeros((1 << bits, 3), np.uint8)
        t[:len(table)] = table
        return bits, t.tobytes()

    def blocks(data):
        return b''.join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                        for i in range(0, len(data), 255)) + b'\0'

    flags, gct = 0, b''
    if global_table is not None:
        bits, gct = table_bytes(global_table)
        flags = 0x80 | (7 << 4) | (bits - 1)
    out = b'GIF' + version + struct.pack('<HHBBB', *screen, flags, background, 0) + gct
    if loop:
        out += b'\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00'
    for f in frames:
        index = np.asarray(f['index'], np.uint8)
        h, w = index.shape
        t = f.get('transparent')
        if t is not None or f.get('disposal'):
            packed = (f.get('disposal', 0) << 2) | (t is not None)
            out += b'\x21\xf9\x04' + struct.pack('<BHB', packed, 10, t or 0) + b'\0'
        image_flags, lct = 0, b''
        if f.get('local_table') is not None:
            bits, lct = table_bytes(f['local_table'])
            image_flags = 0x80 | (bits - 1)
        rows = index
        if f.get('interlace'):
            image_flags |= 0x40
            rows = index[np.concatenate([np.arange(a, h, b) for a, b in
                                         ((0, 8), (4, 8), (2, 4), (1, 2))])]
        mcs = max(2, int(index.max()).bit_length())
        out += (b'\x2c' + struct.pack('<HHHHB', f.get('x', 0), f.get('y', 0), w, h, image_flags)
                + lct + bytes([mcs]) + blocks(gif_lzw(rows.reshape(-1), mcs)))
    return out + b'\x3b'


def sun_file(width: int, height: int, depth: int, pixels: bytes, kind: int = 1,
             colormap: bytes = b'') -> bytes:
    return struct.pack('>8I', 0x59a66a95, width, height, depth, len(pixels), kind,
                       1 if colormap else 0, len(colormap)) + colormap + pixels


def sun_rows(rows: np.ndarray, depth: int) -> bytes:
    out = []
    for row in rows:
        raw = pack_bits(row.reshape(-1), depth) if depth == 1 else row.astype(np.uint8).tobytes()
        out.append(raw + b'\0' * (len(raw) & 1))
    return b''.join(out)


def pam_file(values: np.ndarray, maxval: int, tuple_type: bytes = None) -> bytes:
    h, w, depth = values.shape
    head = b'P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n' % (w, h, depth, maxval)
    if tuple_type:
        head += b'TUPLTYPE ' + tuple_type + b'\n'
    return head + b'ENDHDR\n' + values.astype('>u2' if maxval > 255 else np.uint8).tobytes()


def pfm_file(values: np.ndarray, scale: float) -> bytes:
    """PF (3 channels) or Pf (1) with rows bottom-up, little-endian for a
    negative scale."""
    kind = b'PF' if values.ndim == 3 else b'Pf'
    order = '<' if scale < 0 else '>'
    return (kind + b'\n%d %d\n' % (values.shape[1], values.shape[0]) + repr(scale).encode()
            + b'\n' + values[::-1].astype(order + 'f4').tobytes())


def hdr_flat(rgbe: np.ndarray, head: bytes = b'#?RADIANCE\n') -> bytes:
    h, w, _ = rgbe.shape
    return (head + b'FORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n' % (h, w)
            + rgbe.astype(np.uint8).tobytes())


def tiff_fixtures() -> dict:
    from PIL import Image
    import cv2
    rng = np.random.default_rng(24)
    files = {}
    rgb = noisy(37, 53, 40).astype(np.uint16)
    deep = rgb * 257 + rng.integers(0, 256, rgb.shape).astype(np.uint16)
    for comp, cname in ((1, 'raw'), (5, 'lzw'), (8, 'deflate'), (32946, 'deflate_old'),
                        (32773, 'packbits')):
        files[f'tiff_rgb8_{cname}.tif'] = tiff_file(rgb, 8, 2, compression=comp, rows_per_strip=8)
    files['tiff_rgb16_lzw_pred2_tiles_be.tif'] = tiff_file(
        deep, 16, 2, compression=5, predictor=2, tile=(32, 16), little=False)
    files['tiff_rgb16_deflate_pred2_planar2.tif'] = tiff_file(
        deep, 16, 2, compression=8, predictor=2, planar=2, rows_per_strip=10)
    files['tiff_rgb8_lzw_old_style.tif'] = tiff_file(rgb, 8, 2, compression=5, old_lzw=True)
    files['tiff_bigtiff_be_tiles.tif'] = tiff_file(rgb, 8, 2, compression=32946, tile=(16, 16),
                                                   big=True, little=False, predictor=2)
    files['tiff_gray16_tiles_clipped.tif'] = tiff_file(deep[..., 0], 16, 1, tile=(16, 16))
    files['tiff_gray16_miniswhite_be.tif'] = tiff_file(deep[..., 1], 16, 0, compression=5,
                                                       little=False, rows_per_strip=5)
    files['tiff_bilevel_fill2.tif'] = tiff_file(rng.integers(0, 2, (29, 43)), 1, 0,
                                                compression=32773, extra=[(266, 3, [2])])
    files['tiff_rgba_unassoc.tif'] = tiff_file(
        np.dstack([rgb, rng.integers(0, 256, rgb.shape[:2])]), 8, 2, compression=5,
        extra_samples=[2])
    files['tiff_rgba16_assoc_planar2.tif'] = tiff_file(
        np.dstack([deep, rng.integers(0, 65536, rgb.shape[:2])]), 16, 2, planar=2,
        extra_samples=[1])
    alpha = rng.integers(0, 256, rgb.shape[:2])
    files['tiff_gray_alpha_tiles_clipped.tif'] = tiff_file(np.dstack([rgb[..., 0], alpha]), 8,
                                                           1, tile=(32, 16), extra_samples=[2])
    files['tiff_miniswhite_alpha_planar2.tif'] = tiff_file(np.dstack([rgb[..., 1], alpha]), 8, 0,
                                                           planar=2, extra_samples=[2])
    files['tiff_palette4_cmap8.tif'] = tiff_file(rng.integers(0, 16, (23, 31)), 4, 3,
                                                 colormap=rng.integers(0, 256, (16, 3)))
    files['tiff_palette8_cmap16.tif'] = tiff_file(rng.integers(0, 256, (23, 31)), 8, 3,
                                                  compression=5,
                                                  colormap=rng.integers(0, 65536, (256, 3)))
    files['tiff_cmyk_planar2.tif'] = tiff_file(rng.integers(0, 256, (21, 27, 4)), 8, 5,
                                               planar=2, compression=32773)
    for o in range(1, 5):  # cv2.imread returns None for 5-8
        files[f'tiff_orientation{o}.tif'] = tiff_file(rgb[:, :41], 8, 2, rows_per_strip=7,
                                                      orientation=o)
    files['tiff_orientation3_tiles.tif'] = tiff_file(rgb, 8, 2, tile=(32, 16), orientation=3)
    ycc = noisy(45, 61, 44).astype(np.uint16)
    files['tiff_ycbcr_2x2_strips.tif'] = tiff_file(ycc, 8, 6, compression=5, rows_per_strip=6,
                                                   ycbcr=(2, 2))
    files['tiff_ycbcr_4x4_tiles_refbw.tif'] = tiff_file(
        ycc, 8, 6, tile=(32, 32), ycbcr=(4, 4),
        extra=[(532, 5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])])
    files['tiff_jpeg_ycbcr_strips.tif'] = libtiff_jpeg(noisy(45, 61, 41).astype(np.uint8))
    files['tiff_jpeg_ycbcr_tiles.tif'] = libtiff_jpeg(noisy(45, 61, 42).astype(np.uint8),
                                                      tile=(32, 16), subsampling=(2, 1))
    im = Image.fromarray(noisy(33, 47, 43))
    files['tiff_pillow_jpeg_rgb.tif'] = pil_bytes(im, 'TIFF', compression='jpeg', quality=80)
    files['tiff_pillow_lzw_la.tif'] = pil_bytes(im.convert('LA'), 'TIFF', compression='tiff_lzw')
    files['tiff_pillow_i16.tif'] = pil_bytes(Image.fromarray(deep[..., 2]), 'TIFF',
                                             compression='tiff_adobe_deflate')
    files['tiff_pillow_palette.tif'] = pil_bytes(im.quantize(64), 'TIFF', compression='packbits')
    files['tiff_cv2_rgb16.tif'] = cv2.imencode('.tiff', deep[..., ::-1])[1].tobytes()
    files['tiff_cv2_gray8.tif'] = cv2.imencode('.tiff', rgb[..., 0].astype(np.uint8))[1].tobytes()
    return files


def raster_fixtures() -> dict:
    from PIL import Image
    import cv2
    rng = np.random.default_rng(25)
    files = {}
    rgb = noisy(29, 43, 50)
    im = Image.fromarray(rgb)
    # BMP
    for mode in ('1', 'L', 'P', 'RGB', 'RGBA'):
        files[f'bmp_pillow_{mode.lower()}.bmp'] = pil_bytes(im.convert(mode), 'BMP')
    files['bmp_cv2_rgb.bmp'] = cv2.imencode('.bmp', rgb[..., ::-1])[1].tobytes()
    files['bmp_cv2_rgba.bmp'] = cv2.imencode('.bmp', np.dstack(
        [rgb[..., ::-1], rng.integers(0, 256, rgb.shape[:2], dtype=np.uint8)]))[1].tobytes()
    pal4 = np.c_[rng.integers(0, 256, (16, 3)), np.zeros(16, int)].astype(np.uint8).tobytes()
    pal8 = np.c_[rng.integers(0, 256, (256, 3)), np.zeros(256, int)].astype(np.uint8).tobytes()
    files['bmp_rle8.bmp'] = bmp_file(rle_stream(rng, 37, 23, 8), 37, 23, 8, 1, pal8)
    files['bmp_rle4.bmp'] = bmp_file(rle_stream(rng, 37, 23, 4) + b'\0\0' * 24, 37, 23, 4, 2,
                                     pal4)
    files['bmp_os2_8bit.bmp'] = bmp_file(bmp_rows(rng.integers(0, 256, (19, 23)), 8), 23, 19,
                                         8, palette=rng.integers(0, 256, 768).astype(
                                             np.uint8).tobytes(), header_size=12)
    files['bmp_v5_top_down_4bit_short_palette.bmp'] = bmp_file(
        bmp_rows(rng.integers(0, 16, (19, 23)), 4)[::-1], 23, 19, 4, palette=pal4[:4 * 9],
        header_size=124, top_down=True, colours_used=9)
    files['bmp_555.bmp'] = bmp_file(bmp_rows(rng.integers(0, 1 << 15, (17, 21)), 16), 21, 17, 16)
    files['bmp_565_bitfields.bmp'] = bmp_file(bmp_rows(rng.integers(0, 1 << 16, (17, 21)), 16),
                                              21, 17, 16, 3, masks=(0xf800, 0x7e0, 0x1f))
    files['bmp_v4_32bit_bitfields.bmp'] = bmp_file(
        bmp_rows(rng.integers(0, 256, (17, 21, 4)), 32), 21, 17, 32, 3, header_size=108,
        header_masks=(0xff0000, 0xff00, 0xff, 0xff000000))
    files['bmp_1bit_top_down.bmp'] = bmp_file(bmp_rows(rng.integers(0, 2, (13, 35)), 1)[::-1],
                                              35, 13, 1, palette=pal4[:8], top_down=True)
    # PNM, PAM, PFM
    files['pnm_cv2.ppm'] = cv2.imencode('.ppm', rgb[..., ::-1])[1].tobytes()
    files['pnm_cv2.pgm'] = cv2.imencode('.pgm', rgb[..., 0])[1].tobytes()
    files['pnm_cv2.pbm'] = cv2.imencode('.pbm', rgb[..., 1])[1].tobytes()
    files['pnm_pillow_16bit.pgm'] = pil_bytes(Image.fromarray(
        rng.integers(0, 65536, (15, 19)).astype(np.uint16)), 'PPM')
    files['pnm_p5_maxval100.pgm'] = b'P5\n4 2\n100\n' + bytes([0, 50, 99, 100, 120, 255, 3, 7])
    v = rng.integers(0, 110, (7, 9, 3))
    files['pnm_p3_ascii_maxval100.ppm'] = (b'P3\n# a comment\n9 7\n100\n' + b'\n'.join(
        b' '.join(str(int(x)).encode() for x in row.reshape(-1)) for row in v) + b'\n')
    files['pnm_p1_ascii.pbm'] = b'P1\n11 5\n' + b'\n'.join(
        b''.join(b'01'[int(x)].to_bytes(1, 'big') for x in row)
        for row in rng.integers(0, 2, (5, 11))) + b'\n'
    files['pnm_p6_16bit.ppm'] = b'P6 9 7 65535\n' + rng.integers(
        0, 65536, (7, 9, 3)).astype('>u2').tobytes()
    files['pnm_pam_rgb.pam'] = pam_file(rng.integers(0, 256, (7, 9, 3)), 255, b'RGB')
    files['pnm_pam_gray16.pam'] = pam_file(rng.integers(0, 65536, (7, 9, 1)), 65535,
                                           b'GRAYSCALE')
    files['pnm_pam_bw.pam'] = pam_file(rng.integers(0, 2, (7, 9, 1)), 1, b'BLACKANDWHITE')
    f = rng.normal(100, 80, (6, 8, 3)).astype(np.float32)
    f.reshape(-1)[:6] = [0.33, 1.2, 0.5, 2.5, np.nan, 3e9]
    files['pnm_pfm_rgb_le.pfm'] = pfm_file(f, -1.0)
    files['pnm_pfm_gray_be_scale2.pfm'] = pfm_file(f[..., 0], 2.0)
    # GIF
    table = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    local = rng.integers(0, 256, (8, 3)).astype(np.uint8)
    files['gif_pillow_palette.gif'] = pil_bytes(im.quantize(32), 'GIF')
    files['gif_pillow_interlaced_transparent.gif'] = pil_bytes(im.quantize(64), 'GIF',
                                                               transparency=3, interlace=True)
    frames = [Image.fromarray(noisy(20, 30, 51 + k)) for k in range(3)]
    files['gif_pillow_animated.gif'] = pil_bytes(frames[0], 'GIF', save_all=True,
                                                 append_images=frames[1:], duration=50, loop=0)
    index = rng.integers(0, 8, (13, 17))
    files['gif_frame_on_screen_transparent.gif'] = gif_file(
        [dict(index=index, x=5, y=3, transparent=2, disposal=2),
         dict(index=index[::-1])], (29, 21), table, background=5, loop=True)
    files['gif_local_table_no_global.gif'] = gif_file(
        [dict(index=index, x=2, y=1, local_table=local, interlace=True)], (23, 17), version=b'87a')
    files['gif_local_over_global.gif'] = gif_file(
        [dict(index=rng.integers(0, 16, (11, 13)), local_table=local)], (13, 11), table)
    # Sun raster
    files['sunras_cv2_8bit.ras'] = cv2.imencode('.ras', rgb[..., 0])[1].tobytes()
    files['sunras_cv2_24bit.ras'] = cv2.imencode('.ras', rgb[..., ::-1])[1].tobytes()
    files['sunras_1bit_colormap.ras'] = sun_file(
        21, 7, 1, sun_rows(rng.integers(0, 2, (7, 21)), 1), colormap=bytes([10, 200, 30, 250,
                                                                            50, 60]))
    files['sunras_32bit.ras'] = sun_file(9, 5, 32, sun_rows(rng.integers(0, 256, (5, 36)), 32))
    files['sunras_8bit_gray_ramp.ras'] = sun_file(9, 5, 8, sun_rows(rng.integers(0, 256, (5, 9)),
                                                                     8), kind=0)
    # Radiance
    hdr = rng.uniform(0, 1.4, (9, 37, 3)).astype(np.float32)
    files['hdr_cv2_rle.hdr'] = cv2.imencode('.hdr', hdr[..., ::-1])[1].tobytes()
    rgbe = rng.integers(0, 256, (4, 6, 4))
    rgbe[0, 0, 3] = 170  # 2^34: past the int range after x255, saturates to 0
    rgbe[0, 1, 3] = 0
    files['hdr_flat_narrow.hdr'] = hdr_flat(rgbe, b'#?RGBE\n# a comment\nEXPOSURE=1.0\n')
    return files


def cv2_reads(path: str):
    """cv2.imread in colour (as RGB) and in gray, each None where cv2 fails."""
    import cv2
    colour = cv2.imread(path, cv2.IMREAD_COLOR)
    gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    return (None if colour is None else np.ascontiguousarray(colour[..., ::-1])), gray


def pil_size(path):
    """PIL's size of a file, or PIL_RAISES where PIL does not identify it."""
    from PIL import Image, UnidentifiedImageError
    try:
        with Image.open(path) as pil:
            return list(pil.size)
    except UnidentifiedImageError:
        return PIL_RAISES


def manifest_entry(path: str) -> dict:
    colour, gray = cv2_reads(path)
    assert colour is not None or gray is not None, path
    entry = dict(pil_size=pil_size(path))
    for key, im in (('rgb', colour), ('gray', gray)):
        entry[f'sha256_{key}'] = None if im is None else digest(im)
        entry[f'shape_{key}'] = None if im is None else list(im.shape)
    return entry


def main() -> None:
    files = {**png_fixtures(), **jpeg_fixtures(), **webp_fixtures(), **tiff_fixtures(),
             **raster_fixtures()}
    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    for old in glob.glob(str(FIXTURE_DIR / '*')):
        os.remove(old)
    manifest = {}
    for name, data in sorted(files.items()):
        path = FIXTURE_DIR / name
        path.write_bytes(data)
        manifest[name] = manifest_entry(str(path))
    MANIFEST.write_text(json.dumps(manifest, indent=1, sort_keys=True) + '\n')
    total = sum(p.stat().st_size for p in FIXTURE_DIR.iterdir())
    print(f'{len(files)} files, {total / 1e6:.2f} MB with the manifest')


if __name__ == '__main__':
    main()
