"""PNG decoding on the host, equal to `cv2.imread` (OpenCV 5.0 on libpng)
bit for bit, in colour and in gray.

Every colour type at every legal depth (gray 1-16 bits, RGB 8 and 16, a
palette 1-8, gray with alpha and RGBA 8 and 16), PLTE and tRNS, and Adam7
interlacing. The chunks are parsed here and the IDAT stream is inflated by
Python's `zlib`; `csrc/png_decode.cpp` (built with the host C++ compiler at
first use by `ops/cuda_build.py::build_host_library`, called through
`ctypes`, which releases the GIL) undoes the row filters, puts the passes in
place and converts the samples as OpenCV's reader has libpng convert them.
An APNG gives its default image (the IDAT), as `cv2.imread` of a file does
(`cv2.imdecode` of the same bytes composites the first frame instead).

The first valid `eXIf` chunk (good CRC, a TIFF header), before or after the
IDAT, gives the EXIF orientation, applied as cv2 applies it. A critical
chunk with a bad CRC, a truncated file, a file without IEND or too little
image data raise ValueError, where cv2 returns None; an ancillary chunk
with a bad CRC is skipped, as libpng skips it.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib

import numpy as np

from metrabs_tpu_torch.data import exif
from metrabs_tpu_torch.data.jpeg import apply_exif_orientation
from metrabs_tpu_torch.ops import cuda_build

SIGNATURE = b'\x89PNG\r\n\x1a\n'
# Colour type -> (samples per pixel, legal bit depths).
_KINDS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)),
          6: (4, (8, 16))}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))  # x0, y0, dx, dy
_EXIF_HEADERS = (b'II*\x00', b'MM\x00*')
_ERR_LEN = 256
_LOCK = threading.Lock()
_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = cuda_build.build_host_library('png_decode')
            lib = ctypes.CDLL(str(path))
            lib.metrabs_png_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int]
            lib.metrabs_png_decode.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _chunks(data: bytes, name: str):
    """(type, body) of each chunk up to IEND; ancillary chunks with a bad CRC
    are left out, as libpng discards them."""
    if data[:8] != SIGNATURE:
        raise ValueError(f'{name}: not a PNG file')
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError(f'{name}: truncated PNG (no IEND chunk)')
        length, kind = struct.unpack_from('>I4s', data, pos)
        end = pos + 8 + length
        if length > 0x7fffffff or end + 4 > len(data):
            raise ValueError(f'{name}: truncated PNG ({kind!r} chunk)')
        body = data[pos + 8:end]
        crc_ok = zlib.crc32(kind + body) & 0xffffffff == struct.unpack_from('>I', data, end)[0]
        pos = end + 4
        critical = not kind[0] & 0x20
        if not crc_ok:
            if critical:
                raise ValueError(f'{name}: {kind.decode("latin-1")}: CRC error')
            continue
        yield kind, body
        if kind == b'IEND':
            return


def parse(data: bytes, name: str = '<bytes>') -> dict:
    """The header fields, the palette (256 RGB entries, zero past PLTE's),
    the IDAT stream and the EXIF orientation of a PNG file."""
    info, idat, palette, orientation = None, [], None, None
    for kind, body in _chunks(data, name):
        if info is None:
            if kind != b'IHDR' or len(body) != 13:
                raise ValueError(f'{name}: IHDR must come first')
            width, height, depth, colour_type, compression, filtering, interlace = \
                struct.unpack('>IIBBBBB', body)
            kind_info = _KINDS.get(colour_type)
            if (kind_info is None or depth not in kind_info[1] or compression or filtering
                    or interlace > 1 or not 0 < width < 2 ** 31 or not 0 < height < 2 ** 31):
                raise ValueError(f'{name}: bad IHDR ({width}x{height}, depth {depth}, colour '
                                 f'type {colour_type}, interlace {interlace})')
            info = dict(width=width, height=height, depth=depth, colour_type=colour_type,
                        interlace=interlace, samples=kind_info[0])
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'PLTE' and palette is None:
            if len(body) % 3 or not 0 < len(body) <= 768:
                raise ValueError(f'{name}: bad PLTE length {len(body)}')
            palette = body
        elif kind == b'eXIf' and orientation is None and body[:4] in _EXIF_HEADERS:
            orientation = exif.orientation(body)
        elif kind not in (b'IEND', b'IHDR') and not kind[0] & 0x20 and kind != b'PLTE':
            raise ValueError(f'{name}: unknown critical chunk {kind!r}')
    if not idat:
        raise ValueError(f'{name}: no IDAT chunk')
    if info['colour_type'] == 3 and palette is None:
        raise ValueError(f'{name}: a palette image without PLTE')
    info['palette'] = (palette or b'').ljust(768, b'\x00')
    info['idat'] = b''.join(idat)
    info['orientation'] = 1 if orientation is None else orientation
    return info


def header(data: bytes, name: str = '<bytes>'):
    """(width, height) from IHDR, before any EXIF orientation (PIL's size)."""
    if data[:8] != SIGNATURE or data[12:16] != b'IHDR' or len(data) < 24:
        raise ValueError(f'{name}: not a PNG file')
    return struct.unpack_from('>II', data, 16)


def _raw_size(info: dict) -> int:
    bits = info['samples'] * info['depth']
    passes = _ADAM7 if info['interlace'] else ((0, 0, 1, 1),)
    total = 0
    for x0, y0, dx, dy in passes:
        pw = max(0, -(-(info['width'] - x0) // dx))
        ph = max(0, -(-(info['height'] - y0) // dy))
        if pw and ph:
            total += ph * (1 + (pw * bits + 7) // 8)
    return total


def _pixels(info: dict, name: str, channels: int) -> np.ndarray:
    need = _raw_size(info)
    try:
        raw = zlib.decompressobj().decompress(info['idat'], need)
    except zlib.error as e:
        raise ValueError(f'{name}: corrupt IDAT stream ({e})') from None
    if len(raw) < need:
        raise ValueError(f'{name}: not enough image data ({len(raw)} of {need} bytes)')
    out = np.empty((info['height'], info['width'], channels), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = _library().metrabs_png_decode(
        raw, len(raw), info['width'], info['height'], info['depth'], info['colour_type'],
        info['interlace'], info['palette'], out.ctypes.data, channels, err, _ERR_LEN)
    if rc != 0:
        raise ValueError(f'{name}: corrupt PNG ({err.value.decode()})')
    return out


def decode(data: bytes, name: str = '<bytes>', gray: bool = False) -> np.ndarray:
    """RGB uint8 [H, W, 3] of a PNG file as `cv2.imread(path, IMREAD_COLOR)`
    gives it (in RGB order), or with `gray` uint8 [H, W] as
    `IMREAD_GRAYSCALE` gives it, EXIF orientation applied."""
    info = parse(data, name)
    out = apply_exif_orientation(_pixels(info, name, 1 if gray else 3), info['orientation'])
    return out[..., 0] if gray else out


def decode_stored(data: bytes, name: str = '<bytes>') -> np.ndarray:
    """The stored samples of an 8-bit PNG without a palette: uint8 [H, W]
    (gray) or [H, W, C] in PNG's channel order, alpha kept, no orientation
    applied. Other kinds raise NotImplementedError."""
    info = parse(data, name)
    if info['depth'] != 8 or info['colour_type'] == 3:
        raise NotImplementedError(f'{name}: the stored samples of a PNG of depth '
                                  f'{info["depth"]}, colour type {info["colour_type"]} (8-bit '
                                  f'gray, gray with alpha, RGB and RGBA only)')
    out = _pixels(info, name, info['samples'])
    return out[..., 0] if info['samples'] == 1 else out
