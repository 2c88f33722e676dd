"""Writes the still-image fixtures of `tests/torch_fixtures/images` and their
`manifest.json`: PNGs of every colour type and depth (built here through
`zlib`, with any filter, Adam7, PLTE, tRNS, eXIf and APNG chunks), JPEGs
that Pillow writes in CMYK and RGB (and edits of them: YCCK, RGB by
component IDs), WebPs that Pillow writes and that the libwebp Pillow bundles
writes through its advanced `WebPConfig` (ctypes), with the EXIF
orientation of each kind. The manifest holds, for each file, the SHA-256
and shape of `cv2.imread` in colour (as RGB) and in gray, and PIL's size.

Run `python tests/_torch_image_fixtures.py` to rewrite them (cv2, Pillow:
this machine only; the card's machine checks the hashes).
"""

from __future__ import annotations

import ctypes
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


def cv2_reads(path: str):
    """cv2.imread in colour (as RGB) and in gray, each None where cv2 fails."""
    import cv2
    colour = cv2.imread(path, cv2.IMREAD_COLOR)
    gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    return (None if colour is None else np.ascontiguousarray(colour[..., ::-1])), gray


def main() -> None:
    from PIL import Image
    files = {**png_fixtures(), **jpeg_fixtures(), **webp_fixtures()}
    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    for old in glob.glob(str(FIXTURE_DIR / '*')):
        os.remove(old)
    manifest = {}
    for name, data in sorted(files.items()):
        path = FIXTURE_DIR / name
        path.write_bytes(data)
        colour, gray = cv2_reads(str(path))
        assert colour is not None and gray is not None, name
        with Image.open(path) as pil:
            size = list(pil.size)
        manifest[name] = dict(sha256_rgb=digest(colour), shape_rgb=list(colour.shape),
                              sha256_gray=digest(gray), shape_gray=list(gray.shape),
                              pil_size=size)
    MANIFEST.write_text(json.dumps(manifest, indent=1, sort_keys=True) + '\n')
    total = sum(p.stat().st_size for p in FIXTURE_DIR.iterdir())
    print(f'{len(files)} files, {total / 1e6:.2f} MB with the manifest')


if __name__ == '__main__':
    main()
