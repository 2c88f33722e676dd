"""Radiance HDR (RGBE) decoding on the host, equal to `cv2.imread` (OpenCV
5.0's HdrDecoder on rgbe.cpp) bit for bit, in colour and in gray.

The header is read line by line as RGBE_ReadHeader reads it with fgets (at
most 127 characters a line): a `FORMAT=32-bit_rle_rgbe` line, then a blank
line, then `-Y <height> +X <width>`, the only orientation cv2.imread
accepts. `csrc/raster_decode.cpp` reads the scanlines (new-style
run-length ones for widths 8-32767, flat otherwise or from the first
scanline that is not run-length encoded on) into float RGB as rgbe2float
gives it. The colour read is each value times 255, rounded half to even and
saturated (OpenCV's convertTo: a value whose product passes the int range
gives 0), and gray is OpenCV 5.0's BGR2GRAY of that. cv2.imread returns None
for XYZE files (`FORMAT=32-bit_rle_xyze`), other orientations, bad
run-lengths and truncated data, and `decode` raises ValueError for them.
PIL does not identify Radiance files: `header` raises ValueError, as PIL
raises.
"""

from __future__ import annotations

import re

import numpy as np

from metrabs_tpu_torch.data import raster_native

SIGNATURES = (b'#?RGBE', b'#?RADIANCE')
_SIZE = re.compile(rb'-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)')


def is_hdr(data: bytes) -> bool:
    return data.startswith(SIGNATURES)


def _lines(data: bytes):
    """fgets with a 128-byte buffer: (line up to its first NUL, position
    after it); None at the end of the file."""
    pos = 0
    while pos < len(data):
        end = data.find(b'\n', pos, pos + 127)
        end = pos + 127 if end < 0 else end + 1
        line = data[pos:end]
        pos = min(end, len(data))
        yield line.split(b'\0', 1)[0], pos
    yield None, pos


def parse(data: bytes, name: str = '<bytes>') -> dict:
    """(width, height) and where the pixels start, or ValueError where
    RGBE_ReadHeader fails."""
    lines = _lines(data)
    line, pos = next(lines)
    while True:
        if line is None:
            raise ValueError(f'{name}: truncated Radiance header')
        if line in (b'', b'\n'):
            raise ValueError(f'{name}: no FORMAT=32-bit_rle_rgbe line (cv2.imread reads only '
                             f'RGBE, not XYZE)')
        if line == b'FORMAT=32-bit_rle_rgbe\n':
            break
        line, pos = next(lines)
    line, pos = next(lines)
    if line != b'\n':
        raise ValueError(f'{name}: no blank line after the Radiance FORMAT line')
    line, pos = next(lines)
    match = None if line is None else _SIZE.match(line)
    if match is None:
        raise ValueError(f'{name}: no -Y <height> +X <width> line (cv2.imread reads no other '
                         f'orientation)')
    height, width = int(match.group(1)), int(match.group(2))
    if width <= 0 or height <= 0 or width > 1 << 20 or height > 1 << 20 or \
            width * height > 1 << 30:
        raise ValueError(f'{name}: bad Radiance size {width}x{height}')
    return dict(width=width, height=height, offset=pos)


def header(data: bytes, name: str = '<bytes>'):
    raise ValueError(f'{name}: PIL does not identify Radiance HDR files')


def decode(data: bytes, name: str = '<bytes>', gray: bool = False) -> np.ndarray:
    """RGB uint8 [H, W, 3] of a Radiance file as `cv2.imread(path,
    IMREAD_COLOR)` gives it (in RGB order), or with `gray` uint8 [H, W] as
    `IMREAD_GRAYSCALE` gives it."""
    info = parse(data, name)
    h, w = info['height'], info['width']
    rgb = np.empty((h, w, 3), np.float32)
    pixels = data[info['offset']:]
    err = raster_native.error_buffer()
    if raster_native.library().metrabs_hdr_scanlines(pixels, len(pixels), w, h, rgb.ctypes.data,
                                                     err, raster_native.ERR_LEN):
        raise ValueError(f'{name}: corrupt Radiance data ({err.value.decode()})')
    with np.errstate(over='ignore'):  # inf, as OpenCV's product gives it, saturates to 0
        out = raster_native.saturate_u8(rgb * np.float32(255))
    return raster_native.gray15(out) if gray else out
