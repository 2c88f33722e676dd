"""TIFF decoding on the host, equal to `cv2.imread` (OpenCV 5.0 on its
bundled libtiff 4.7) bit for bit, in colour and in gray.

The first directory (IFD0) of a classic or BigTIFF file, in either byte
order, is read with `data.exif.tiff_ifd0`; its strips or tiles are cut out
here, Deflate (8 and 32946) is inflated by Python's `zlib`, JPEG (7) strips
and tiles, their `JPEGTables` joined to each, are decoded by
`csrc/jpeg_decode.cpp` as libtiff's JPEG codec has libjpeg decode them
(YCbCr converted to RGB, JPEGCOLORMODE_RGB; other photometrics as coded),
and `csrc/tiff_decode.cpp` (built with the host C++ compiler at first use by
`ops/cuda_build.py::build_host_library`, called through `ctypes`, which
releases the GIL) decodes LZW (both forms) and PackBits, undoes predictor 2
and converts the samples as OpenCV has libtiff's TIFFRGBAImage convert them.

cv2.imread returns None, and `decode` raises ValueError, for: bit depths
other than 1, 8 and 16 for gray (MinIsWhite, MinIsBlack), 8 and 16 for
RGB, 1, 4 and 8 for a palette, 8 for CMYK (Separated, InkSet CMYK, at least
four samples); more than four samples per pixel; floating-point and 32- or
64-bit samples; LZMA, ZSTD and WebP compression (not built into cv2's
libtiff); predictor 2 on depths other than 8 and 16 and predictor 3 on
integer samples (with LZW and Deflate; other codecs ignore the predictor);
Orientation 5-8 (OpenCV 5.0's imread fails on the turned image); and
corrupt or truncated data. Orientation 2-4 is applied as cv2 applies it.
Signed integer samples read as their unsigned bits, as libtiff reads them.
As libtiff reads them for cv2: FillOrder 2 reverses the bits of every raw
byte; a codec that fails part way leaves what it decoded, zeros after and
neither the predictor nor the byte swap applied (TIFFReadRGBAStrip does
not stop on errors); a 16-bit gray tile clipped at the right edge is read
with put16bitbwtile's byte skew; Orientation 2 and 3 mirror a tiled image
tile by tile; a gray or palette tile clipped at the right edge is read
with the byte skew of tif_getimage.c's put routines (8-bit with extra
samples, and 16-bit gray), and gray in separate planes with an extra
sample is read as RGB of the gray plane (no MinIsWhite inversion), as
gtStripSeparate reads it. YCbCr that is not JPEG-compressed is read in its blocks as
TIFFYCbCrtoRGB converts it (tif_color.c's tables in float, from the
YCbCrCoefficients and ReferenceBlackWhite tags; no chroma interpolation),
a strip read only as far as libtiff's rounded-down TIFFScanlineSize, a
clipped 4x4-subsampled tile with putcontig8bitYCbCr44tile's skew. Refused
with NotImplementedError: CCITT (2, 3, 4), old-style JPEG (6) and the
other rare codecs, YCbCr in separate planes or with a predictor, CIE
L*a*b* and other photometrics, and files without Photometric or
StripByteCounts.
"""

from __future__ import annotations

import ctypes
import threading
import zlib

import numpy as np

from metrabs_tpu_torch.data import exif, jpeg, raster_native
from metrabs_tpu_torch.ops import cuda_build

SIGNATURES = (b'II*\x00', b'MM\x00*', b'II+\x00', b'MM\x00+')
_ERR_LEN = 256
_LOCK = threading.Lock()
_LIB = None

(_WIDTH, _HEIGHT, _BITS, _COMPRESSION, _PHOTOMETRIC, _FILL_ORDER, _STRIP_OFFSETS, _ORIENTATION,
 _SPP, _ROWS_PER_STRIP, _STRIP_COUNTS, _PLANAR, _PREDICTOR, _COLORMAP, _TILE_WIDTH,
 _TILE_LENGTH, _TILE_OFFSETS, _TILE_COUNTS, _INKSET, _EXTRA_SAMPLES, _SAMPLE_FORMAT,
 _JPEG_TABLES) = (256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320, 322,
                  323, 324, 325, 332, 338, 339, 347)
_NONE, _LZW, _OJPEG, _JPEG, _DEFLATE, _ADOBE_DEFLATE, _PACKBITS = 1, 5, 6, 7, 32946, 8, 32773
# Photometric -> the bit depths cv2.imread reads.
_DEPTHS = {0: (1, 8, 16), 1: (1, 8, 16), 2: (8, 16), 3: (1, 4, 8), 5: (8,), 6: (8,)}
_PHOTOMETRIC_NAMES = {4: 'transparency mask', 8: 'CIE L*a*b*', 9: 'ICC L*a*b*',
                      10: 'ITU L*a*b*', 32844: 'LogL', 32845: 'LogLuv', 34892: 'linear raw'}
_NOT_BUILT = {34925: 'LZMA', 50000: 'ZSTD', 50001: 'WebP', 34887: 'LERC', 34933: 'PNG',
              32947: 'DCS'}
_REFUSED = {2: 'CCITT modified Huffman', 3: 'CCITT Group 3', 4: 'CCITT Group 4',
            _OJPEG: 'old-style JPEG', 32809: 'ThunderScan', 32908: 'Pixar film',
            32909: 'Pixar log', 34676: 'SGI log', 34677: 'SGI log24'}
_PREDICTED = (_LZW, _DEFLATE, _ADOBE_DEFLATE)
_YCBCR_COEFFICIENTS, _YCBCR_SUBSAMPLING, _REFERENCE_BLACK_WHITE = 529, 530, 532
# The YCbCr subsamplings tif_getimage.c has put routines for.
_YCBCR_BLOCKS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))


def is_tiff(data: bytes) -> bool:
    return data[:4] in SIGNATURES


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = cuda_build.build_host_library('tiff_decode')
            lib = ctypes.CDLL(str(path))
            lib.metrabs_tiff_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_int]
            lib.metrabs_tiff_predict.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            lib.metrabs_tiff_convert.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int]
            for f in (lib.metrabs_tiff_decompress, lib.metrabs_tiff_predict,
                      lib.metrabs_tiff_convert):
                f.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _one(ifd: dict, tag: int, default=None):
    values = ifd.get(tag)
    return default if not values else values[0]


def _size(ifd: dict, name: str):
    if _WIDTH not in ifd or _HEIGHT not in ifd:
        raise ValueError(f'{name}: a TIFF directory without ImageWidth or ImageLength')
    return int(_one(ifd, _WIDTH)), int(_one(ifd, _HEIGHT))


# The kinds PIL opens (TiffImagePlugin.OPEN_INFO): photometric -> (sample
# format, fill order, bits per sample, extra samples); a big-endian file
# has neither _PIL_LITTLE_ONLY entry.
_PIL_MODES = {
    0: ((1, 1, (1,), ()), (1, 1, (2,), ()), (1, 1, (4,), ()), (1, 1, (8,), ()),
        (1, 1, (16,), ()), (1, 2, (1,), ()), (1, 2, (2,), ()), (1, 2, (4,), ()),
        (1, 2, (8,), ()), (3, 1, (32,), ())),
    1: ((1, 1, (1,), ()), (1, 1, (2,), ()), (1, 1, (4,), ()), (1, 1, (8,), ()),
        (1, 1, (8, 8), (2,)), (1, 1, (12,), ()), (1, 1, (16,), ()), (1, 1, (32,), ()),
        (1, 2, (1,), ()), (1, 2, (2,), ()), (1, 2, (4,), ()), (1, 2, (8,), ()),
        (1, 2, (16,), ()), (2, 1, (8,), ()), (2, 1, (16,), ()), (2, 1, (32,), ()),
        (3, 1, (32,), ())),
    2: ((1, 1, (8, 8, 8), ()), (1, 1, (8, 8, 8, 8), ()), (1, 1, (8, 8, 8, 8), (0,)),
        (1, 1, (8, 8, 8, 8), (1,)), (1, 1, (8, 8, 8, 8), (2,)), (1, 1, (8, 8, 8, 8), (999,)),
        (1, 1, (8, 8, 8, 8, 8), (0, 0)), (1, 1, (8, 8, 8, 8, 8), (1, 0)),
        (1, 1, (8, 8, 8, 8, 8), (2, 0)), (1, 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)),
        (1, 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)), (1, 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)),
        (1, 1, (16, 16, 16), ()), (1, 1, (16, 16, 16, 16), ()), (1, 1, (16, 16, 16, 16), (0,)),
        (1, 1, (16, 16, 16, 16), (1,)), (1, 1, (16, 16, 16, 16), (2,)), (1, 2, (8, 8, 8), ())),
    3: ((1, 1, (1,), ()), (1, 1, (2,), ()), (1, 1, (4,), ()), (1, 1, (8,), ()),
        (1, 1, (8, 8), (0,)), (1, 1, (8, 8), (2,)), (1, 2, (1,), ()), (1, 2, (2,), ()),
        (1, 2, (4,), ()), (1, 2, (8,), ())),
    5: ((1, 1, (8, 8, 8, 8), ()), (1, 1, (8, 8, 8, 8, 8), (0,)),
        (1, 1, (8, 8, 8, 8, 8, 8), (0, 0)), (1, 1, (16, 16, 16, 16), ())),
    6: ((1, 1, (8,), ()), (1, 1, (8, 8, 8), ())),
    8: ((1, 1, (8, 8, 8), ()),),
}
_PIL_LITTLE_ONLY = {(0, (1, 1, (16,), ())), (1, (1, 1, (12,), ())), (1, (1, 1, (32,), ())),
                    (1, (1, 2, (16,), ()))}


def header(data: bytes, name: str = '<bytes>'):
    """(width, height) as PIL's TiffImagePlugin gives it: swapped for
    Orientation 5-8. Where PIL does not identify the file (a big-endian
    BigTIFF, a kind outside its modes) raises ValueError, as PIL raises."""
    if data[:4] == b'MM\x00+':
        raise ValueError(f'{name}: PIL does not identify a big-endian BigTIFF')
    ifd = exif.tiff_ifd0(data, name)
    width, height = _size(ifd, name)
    compression = _one(ifd, _COMPRESSION, _NONE)
    photometric = 6 if compression == _OJPEG else int(_one(ifd, _PHOTOMETRIC, 0))
    formats = tuple(ifd.get(_SAMPLE_FORMAT) or (1,))
    if len(formats) > 1 and max(formats) == min(formats) == 1:
        formats = (1,)
    bits = tuple(ifd.get(_BITS) or (1,))
    extra = tuple(ifd.get(_EXTRA_SAMPLES) or ())
    spp = _one(ifd, _SPP, 3 if compression == _OJPEG and photometric in (2, 6) else 1)
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) == 1:
        bits = bits * spp
    mode = (formats[0] if len(formats) == 1 else formats, _one(ifd, _FILL_ORDER, 1), bits, extra)
    if (spp > 6 or len(bits) != spp or mode not in _PIL_MODES.get(photometric, ())
            or ifd['_order'] == '>' and (photometric, mode) in _PIL_LITTLE_ONLY):
        raise ValueError(f'{name}: PIL does not identify this TIFF kind')
    return (height, width) if _one(ifd, _ORIENTATION) in (5, 6, 7, 8) else (width, height)


def parse(data: bytes, name: str = '<bytes>') -> dict:
    """The fields of the first directory that the decode needs, checked
    against what cv2.imread reads (ValueError where it returns None,
    NotImplementedError for what this decoder refuses)."""
    ifd = exif.tiff_ifd0(data, name)
    width, height = _size(ifd, name)
    bits_all = ifd.get(_BITS) or (1,)
    spp = int(_one(ifd, _SPP, 1))
    compression = int(_one(ifd, _COMPRESSION, _NONE))
    photometric = _one(ifd, _PHOTOMETRIC)
    planar = int(_one(ifd, _PLANAR, 1))
    formats = ifd.get(_SAMPLE_FORMAT) or (1,)
    bits = int(bits_all[0])
    if compression in _REFUSED:
        raise NotImplementedError(f'{name}: {_REFUSED[compression]} compression in a TIFF '
                                  f'(none, LZW, Deflate, PackBits and JPEG are decoded)')
    if compression in _NOT_BUILT:
        raise ValueError(f'{name}: {_NOT_BUILT[compression]} compression (cv2.imread reads '
                         f'none: its libtiff is built without it)')
    if compression not in (_NONE, _LZW, _JPEG, _DEFLATE, _ADOBE_DEFLATE, _PACKBITS):
        raise ValueError(f'{name}: unknown TIFF compression {compression}')
    if photometric is None:
        raise NotImplementedError(f'{name}: a TIFF without a Photometric tag')
    photometric = int(photometric)
    cmap = ifd.get(_COLORMAP)
    if photometric == 3 and (not cmap or len(cmap) != 3 << bits):
        # libtiff ignores a ColorMap of the wrong length and reads a palette
        # image without one as gray (as RGB with three samples).
        if bits < 8:
            raise ValueError(f'{name}: a {bits}-bit palette TIFF without a ColorMap')
        photometric, cmap = (2 if spp == 3 else 1), None
    if photometric in _PHOTOMETRIC_NAMES or photometric not in _DEPTHS:
        raise NotImplementedError(f'{name}: TIFF photometric '
                                  f'{_PHOTOMETRIC_NAMES.get(photometric, photometric)}')
    ycbcr = None
    if photometric == 6 and compression != _JPEG:
        ycbcr = tuple(int(v) for v in (ifd.get(_YCBCR_SUBSAMPLING) or (2, 2))[:2])
        if planar != 1 or _one(ifd, _PREDICTOR, 1) != 1:
            raise NotImplementedError(f'{name}: YCbCr TIFF in separate planes or with a '
                                      f'predictor')
        if bits != 8 or spp != 3 or ycbcr not in _YCBCR_BLOCKS:
            raise ValueError(f'{name}: {bits}-bit YCbCr, {spp} samples, subsampling {ycbcr} '
                             f'(cv2.imread reads none)')
    if not 0 < width < 2 ** 31 or not 0 < height < 2 ** 31 or width * height >= 2 ** 30:
        raise ValueError(f'{name}: bad TIFF size {width}x{height}')
    if spp < 1 or spp > 4 or planar not in (1, 2) or len(set(bits_all[:spp])) > 1:
        raise ValueError(f'{name}: {spp} samples per pixel, planar configuration {planar}, '
                         f'bits {bits_all} (cv2.imread reads none of these)')
    if int(formats[0]) == 3 or bits not in _DEPTHS[photometric]:
        raise ValueError(f'{name}: {bits}-bit {"float " if formats[0] == 3 else ""}samples '
                         f'with photometric {photometric} (cv2.imread reads none)')
    extra = tuple(ifd.get(_EXTRA_SAMPLES) or ())
    tiled = _TILE_OFFSETS in ifd or _TILE_WIDTH in ifd
    colour = {2: 3, 6: 3, 5: 4}.get(photometric, 1)
    if spp - len(extra) < colour or photometric == 5 and _one(ifd, _INKSET, 1) != 1:
        raise ValueError(f'{name}: photometric {photometric} with {spp} samples, {len(extra)} '
                         f'of them extra (cv2.imread reads none)')
    if photometric in (0, 1, 3) and planar == 1 and spp != 1 and bits < 8 \
            or planar == 2 and spp > 1 and (photometric == 3 or bits < 8):
        raise ValueError(f'{name}: {bits}-bit samples, {spp} per pixel, planar configuration '
                         f'{planar}, photometric {photometric} (cv2.imread reads none)')
    alpha = 0
    if photometric == 2 and spp >= 4:
        alpha = int(extra[0]) if extra else 1
    elif photometric in (0, 1) and spp > 1 and extra and extra[0] in (1, 2):
        alpha = int(extra[0])
    predictor = int(_one(ifd, _PREDICTOR, 1)) if compression in _PREDICTED else 1
    if predictor not in (1, 2) or predictor == 2 and bits not in (8, 16):
        raise ValueError(f'{name}: predictor {predictor} on {bits}-bit samples')
    orientation = int(_one(ifd, _ORIENTATION, 1))
    if not 1 <= orientation <= 8:
        orientation = 1
    if orientation >= 5:
        raise ValueError(f'{name}: TIFF Orientation {orientation} (cv2.imread returns None: '
                         f'OpenCV 5.0 fails on the turned image)')
    palette = np.zeros((256, 3), np.uint8)
    if photometric == 3:
        n = 1 << bits
        cmap = np.asarray(cmap, np.int64).reshape(3, n).T
        # tif_getimage.c's checkcmap: a map with every entry below 256 is
        # taken as 8-bit, any other is scaled by its high byte.
        palette[:n] = cmap if cmap.max() < 256 else cmap >> 8
    if tiled:
        tile_w, tile_h = int(_one(ifd, _TILE_WIDTH, 0)), int(_one(ifd, _TILE_LENGTH, 0))
        offsets, counts = ifd.get(_TILE_OFFSETS), ifd.get(_TILE_COUNTS)
        if tile_w <= 0 or tile_h <= 0:
            raise ValueError(f'{name}: bad TIFF tile size {tile_w}x{tile_h}')
    else:
        tile_w = width
        tile_h = min(int(_one(ifd, _ROWS_PER_STRIP, 2 ** 32 - 1)) or height, height)
        offsets, counts = ifd.get(_STRIP_OFFSETS), ifd.get(_STRIP_COUNTS)
        if offsets and counts is None:
            raise NotImplementedError(f'{name}: a TIFF without StripByteCounts')
    return dict(width=width, height=height, bits=bits, spp=spp, compression=compression,
                photometric=photometric, planar=planar, alpha=alpha, predictor=predictor,
                orientation=orientation, tiled=tiled, tile_w=tile_w, tile_h=tile_h,
                offsets=offsets or (), counts=counts or (), palette=palette,
                big_endian=ifd['_order'] == '>', reverse=_one(ifd, _FILL_ORDER, 1) == 2,
                tables=ifd.get(_JPEG_TABLES), ycbcr=ycbcr,
                ycbcr_tables=None if ycbcr is None else _ycbcr_tables(
                    ifd.get(_YCBCR_COEFFICIENTS) or (0.299, 0.587, 0.114),
                    ifd.get(_REFERENCE_BLACK_WHITE) or (0, 255, 128, 255, 128, 255)))


def _stored(data: bytes, t: dict, index: int, name: str) -> bytes:
    """The stored bytes of strip or tile `index`."""
    offset, count = int(t['offsets'][index]), int(t['counts'][index])
    if offset + count > len(data) or count < 0:
        raise ValueError(f'{name}: TIFF {"tile" if t["tiled"] else "strip"} {index} lies past '
                         f'the end of the file')
    return data[offset:offset + count]


def _raw_chunk(data: bytes, t: dict, index: int, need: int, name: str):
    """(the first `need` bytes of strip or tile `index` decompressed,
    whether its codec failed part way) for every codec but JPEG."""
    raw = _stored(data, t, index, name)
    buf = np.zeros(need, np.uint8)
    if t['reverse']:  # FillOrder 2: libtiff reverses the bits of the raw data
        raw = raw.translate(_REVERSED)
    if t['compression'] in (_DEFLATE, _ADOBE_DEFLATE):
        out, failed = _inflate(raw, need)
        buf[:len(out)] = np.frombuffer(out, np.uint8)
        return buf, failed
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = _library().metrabs_tiff_decompress(raw, len(raw), t['compression'], buf.ctypes.data,
                                            need, err, _ERR_LEN)
    if rc == 1:
        raise ValueError(f'{name}: corrupt TIFF data ({err.value.decode()})')
    return buf, rc == 2


def _chunk(data: bytes, t: dict, index: int, rows: int, chunk_w: int, spp: int,
           name: str) -> np.ndarray:
    """The decoded bytes of strip or tile `index`: uint8 [rows, row bytes]."""
    row_bytes = -(-chunk_w * spp * t['bits'] // 8)
    need = rows * row_bytes
    if t['compression'] == _JPEG:
        raw = _stored(data, t, index, name)
        if t['tables'] and raw[:2] == b'\xff\xd8' and len(t['tables']) > 4:
            raw = t['tables'][:-2] + raw[2:]
        ycbcr = t['photometric'] == 6
        pixels = jpeg.decode_tiff_chunk(raw, spp, ycbcr, name)
        if pixels.shape[1] != chunk_w or pixels.shape[0] < rows:
            raise ValueError(f'{name}: a JPEG strip or tile of {pixels.shape[1]}x'
                             f'{pixels.shape[0]}, expected {chunk_w}x{rows}')
        return np.ascontiguousarray(pixels[:rows].reshape(rows, -1))
    buf, failed = _raw_chunk(data, t, index, need, name)
    if failed:
        # libtiff's strip and tile reads report the codec's failure and
        # TIFFRGBAImage goes on with what it decoded (the rest zero), with
        # neither the predictor nor the byte swap of 16-bit samples applied.
        if t['bits'] == 16 and t['big_endian']:
            buf = _swap16(buf)
        return buf.reshape(rows, row_bytes)
    if t['predictor'] == 2:
        err = ctypes.create_string_buffer(_ERR_LEN)
        if _library().metrabs_tiff_predict(buf.ctypes.data, rows, row_bytes, t['bits'], spp,
                                           int(t['big_endian']), err, _ERR_LEN):
            raise ValueError(f'{name}: {err.value.decode()}')
    return buf.reshape(rows, row_bytes)



_REVERSED = bytes(int(f'{i:08b}'[::-1], 2) for i in range(256))


def _swap16(a: np.ndarray) -> np.ndarray:
    """A copy with the bytes of each 16-bit sample swapped."""
    return np.ascontiguousarray(a.reshape(-1, 2)[:, ::-1]).reshape(a.shape)


def _inflate(raw: bytes, need: int):
    """(the first `need` bytes of a zlib stream, or as many as precede its
    end or first error; whether it fell short), as libtiff's ZIPDecode
    leaves them."""
    try:
        out = zlib.decompressobj().decompress(raw, need)
        return out, len(out) < need
    except zlib.error:
        pass
    good, bad = 0, len(raw)  # the longest prefix that inflates without an error
    while bad - good > 1:
        mid = (good + bad) // 2
        try:
            zlib.decompressobj().decompress(raw[:mid], need)
            good = mid
        except zlib.error:
            bad = mid
    return zlib.decompressobj().decompress(raw[:good], need), True


def _ycbcr_tables(coefficients, reference):
    """tif_color.c's TIFFYCbCrToRGBInit in its float arithmetic: the tables
    Y, Cr->R, Cb->B, Cr->G and Cb->G (16-bit fixed point) over 0-255."""
    f32 = np.float32
    red, green, blue = (f32(c) for c in coefficients[:3])
    ref = [f32(r) for r in reference[:6]]

    def fix(x):  # FIX(CLAMP(x, 0, 2)): (int32)(x * (1L << 16) + 0.5)
        x = f32(min(max(x, f32(0)), f32(2)))
        return int(float(f32(x * f32(65536))) + 0.5)

    def code2v(c, black, white, span):
        den = f32(white - black) if white - black != 0 else f32(1)
        v = f32(f32(np.int64(c) - int(black)) * f32(span)) / den
        return int(min(max(v, f32(-4096)), f32(4096)))  # CLAMPw, then (int32)

    f1 = f32(2) - f32(2) * red
    f2 = f32(red * f1) / green
    f3 = f32(2) - f32(2) * blue
    f4 = f32(blue * f3) / green
    d1, d2, d3, d4 = fix(f1), -fix(f2), fix(f3), -fix(f4)
    x = np.arange(256) - 128
    cr = np.array([code2v(v, ref[4] - f32(128), ref[5] - f32(128), 127) for v in x], np.int64)
    cb = np.array([code2v(v, ref[2] - f32(128), ref[3] - f32(128), 127) for v in x], np.int64)
    y = np.array([code2v(v + 128, ref[0], ref[1], 255) for v in x], np.int64)
    half = 1 << 15
    return dict(y=y, cr_r=(d1 * cr + half) >> 16, cb_b=(d3 * cb + half) >> 16, cr_g=d2 * cr,
                cb_g=d4 * cb + half)


def _ycbcr_rgb(data: bytes, t: dict, name: str) -> np.ndarray:
    """RGB uint8 [H, W, 3] of an uncompressed-photometric YCbCr TIFF (not
    JPEG): each chunk's blocks of h x v luma samples and one Cb and Cr,
    converted without interpolation as TIFFYCbCrtoRGB converts them."""
    (h, v), tab = t['ycbcr'], t['ycbcr_tables']
    width, height, tile_w, tile_h = t['width'], t['height'], t['tile_w'], t['tile_h']
    across, down = -(-width // tile_w), -(-height // tile_h)
    if len(t['offsets']) < across * down or len(t['counts']) < across * down:
        raise ValueError(f'{name}: too few strip or tile offsets')
    block = h * v + 2
    out = np.zeros((height, width, 3), np.uint8)
    for ty in range(down):
        rows = tile_h if t['tiled'] else min(tile_h, height - ty * tile_h)
        block_rows, per_row = -(-rows // v), -(-tile_w // h)
        for tx in range(across):
            raw = _raw_chunk(data, t, ty * across + tx, block_rows * per_row * block, name)[0]
            if not t['tiled']:
                # gtStripContig reads a strip's rows times TIFFScanlineSize,
                # which divides a block row's bytes by v rounding down: the
                # bytes past that are zero.
                raw[block_rows * v * (per_row * block // v):] = 0
            visible = min(tile_w, width - tx * tile_w)
            if t['tiled'] and (h, v) == (4, 4) and visible < tile_w:
                # putcontig8bitYCbCr44tile skips a clipped tile's hidden
                # blocks as 10 bytes each, not 18.
                shown = -(-visible // 4)
                stride = shown * block + (tile_w - visible) // 4 * 10
                rows_ = [raw[r * stride:r * stride + shown * block] for r in range(block_rows)]
                raw = np.zeros((block_rows, per_row * block), np.uint8)
                for r, row in enumerate(rows_):
                    raw[r, :len(row)] = row
            blocks = raw.reshape(block_rows, per_row, block).astype(np.int64)
            luma = blocks[..., :h * v].reshape(block_rows, per_row, v, h).transpose(0, 2, 1, 3)
            luma = np.minimum(luma.reshape(block_rows * v, per_row * h), 255)
            cb = np.repeat(np.repeat(blocks[..., h * v], v, axis=0), h, axis=1)
            cr = np.repeat(np.repeat(blocks[..., h * v + 1], v, axis=0), h, axis=1)
            yv = tab['y'][luma]
            rgb = np.stack([yv + tab['cr_r'][cr], yv + ((tab['cb_g'][cb] + tab['cr_g'][cr]) >> 16),
                            yv + tab['cb_b'][cb]], -1)
            y0, x0 = ty * tile_h, tx * tile_w
            vis_h, vis_w = min(rows, height - y0), min(tile_w, width - x0)
            out[y0:y0 + vis_h, x0:x0 + vis_w] = np.clip(rgb[:vis_h, :vis_w], 0, 255)
    return out


def _samples(data: bytes, t: dict, name: str):
    """The samples of the whole image: uint8 [planes, height, row bytes] as
    they are stored (16-bit samples in the file's byte order), rows padded
    to whole tiles, and the photometric and depth they are in."""
    width, height, spp, planar = t['width'], t['height'], t['spp'], t['planar']
    planes, chunk_spp = (1, spp) if planar == 1 else (spp, 1)
    tile_w, tile_h = t['tile_w'], t['tile_h']
    across, down = -(-width // tile_w), -(-height // tile_h)
    bits, photometric = t['bits'], t['photometric']
    if t['compression'] == _JPEG:
        if bits != 8:
            raise ValueError(f'{name}: {bits}-bit JPEG data in a TIFF')
        if photometric == 6:
            if planar != 1 or spp != 3:
                raise ValueError(f'{name}: YCbCr JPEG data with {spp} samples, planar {planar}')
            photometric = 2
    tile_row_bytes = -(-tile_w * chunk_spp * bits // 8)
    if across > 1 and tile_w * chunk_spp * bits % 8:
        raise ValueError(f'{name}: tiles of {tile_w} {bits}-bit pixels do not end on a byte')
    per_plane = across * down
    if len(t['offsets']) < per_plane * planes or len(t['counts']) < per_plane * planes:
        raise ValueError(f'{name}: {len(t["offsets"])} strip or tile offsets for '
                         f'{per_plane * planes} chunks')
    out = np.zeros((planes, down * tile_h, across * tile_row_bytes), np.uint8)
    for p in range(planes):
        for ty in range(down):
            rows = tile_h if t['tiled'] else min(tile_h, height - ty * tile_h)
            for tx in range(across):
                chunk = _chunk(data, t, p * per_plane + ty * across + tx, rows, tile_w, chunk_spp,
                               name)
                visible = width - tx * tile_w
                if t['tiled'] and visible < tile_w and photometric in (0, 1, 3) and bits == 8 \
                        and spp > 1 and planes == 1:
                    # tif_getimage.c's 8-bit gray and palette put routines
                    # skip a clipped tile's hidden pixels as bytes, not as
                    # samples: tile row r starts r * (spp * visible + hidden)
                    # bytes in.
                    flat = chunk.reshape(-1).copy()
                    chunk = chunk.copy()
                    step = spp * visible + (tile_w - visible)
                    for r in range(1, rows):
                        chunk[r, :spp * visible] = flat[r * step:r * step + spp * visible]
                elif t['tiled'] and visible < tile_w and bits == 16 and photometric in (0, 1) \
                        and planes == 1:
                    # put16bitbwtile does the same at 16 bits, with the
                    # samples in the host's (little-endian) order by then.
                    chunk = _swap16(chunk) if t['big_endian'] else chunk.copy()
                    flat = chunk.reshape(-1).copy()
                    step = 2 * spp * visible + (tile_w - visible)
                    for r in range(1, rows):
                        chunk[r, :2 * spp * visible] = flat[r * step:r * step + 2 * spp * visible]
                    if t['big_endian']:
                        chunk = _swap16(chunk)
                out[p, ty * tile_h:ty * tile_h + rows,
                    tx * tile_row_bytes:(tx + 1) * tile_row_bytes] = chunk
    return out, photometric


def decode(data: bytes, name: str = '<bytes>', gray: bool = False) -> np.ndarray:
    """RGB uint8 [H, W, 3] of the first image of a TIFF file as
    `cv2.imread(path, IMREAD_COLOR)` gives it (in RGB order), or with `gray`
    uint8 [H, W] as `IMREAD_GRAYSCALE` gives it, Orientation 2-4 applied."""
    t = parse(data, name)
    channels = 1 if gray else 3
    if t['ycbcr']:
        out = _ycbcr_rgb(data, t, name)
        if gray:  # icvCvt_BGRA2Gray_8u_C4C1R
            out = raster_native.gray14(out)[..., None]
    else:
        samples, photometric = _samples(data, t, name)
        spp = t['spp']
        if photometric in (0, 1) and t['planar'] == 2 and spp > 1:
            # gtStripSeparate and gtTileSeparate take a gray plane as the
            # red, green and blue planes of RGB: no MinIsWhite inversion.
            samples = np.ascontiguousarray(samples[[0, 0, 0, 1]])
            photometric, spp = 2, 4
        out = np.empty((t['height'], t['width'], channels), np.uint8)
        _library().metrabs_tiff_convert(
            samples.ctypes.data, samples.shape[1] * samples.shape[2], samples.shape[2],
            t['planar'], t['width'], t['height'], t['bits'], spp, photometric, t['alpha'],
            int(t['big_endian']), t['palette'].tobytes(), out.ctypes.data, channels)
    orientation = t['orientation']
    if t['tiled'] and orientation in (2, 3):
        # TIFFReadRGBATile mirrors each tile within its visible width.
        for x in range(0, t['width'], t['tile_w']):
            out[:, x:x + t['tile_w']] = out[:, x:x + t['tile_w']][:, ::-1]
        orientation = 4 if orientation == 3 else 1
    out = jpeg.apply_exif_orientation(out, orientation)
    return out[..., 0] if gray else out
