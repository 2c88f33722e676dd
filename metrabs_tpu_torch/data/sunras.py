"""Sun raster decoding on the host, equal to `cv2.imread` (OpenCV 5.0's
SunRasterDecoder) bit for bit, in colour and in gray.

The 32-byte big-endian header (magic 59 A6 6A 95, width, height, depth,
length, type, map type, map length) is read as readHeader reads it:
depths 1, 8, 24 and 32, the old (0) and standard (1) types, no colormap or
an equal-RGB colormap (red, green and blue planes) of at most 2^depth
entries at depths 1 and 8. Rows are padded to 16 bits. 24-bit pixels are
B, G, R and 32-bit ones X, B, G, R; a colormap, or without one a gray ramp,
gives the colour of 1- and 8-bit pixels. In gray, OpenCV converts a
colormap's entries (icvCvt_BGR2Gray) but leaves its gray table zero
without one: a 1- or 8-bit file without a colormap reads all black.

OpenCV 5.0 compares the type field with the decoded image's type, not the
file's, so cv2.imread returns None for byte-encoded (run-length, type 2) and
RGB-ordered (type 3) files, as for other depths and map types and truncated
data; `decode` raises ValueError for all of these.
"""

from __future__ import annotations

import struct

import numpy as np

from metrabs_tpu_torch.data import raster_native

SIGNATURE = b'\x59\xa6\x6a\x95'


def is_sunras(data: bytes) -> bool:
    return data[:4] == SIGNATURE


def header(data: bytes, name: str = '<bytes>'):
    """(width, height) from the header, as PIL's size."""
    if len(data) < 32 or not is_sunras(data):
        raise ValueError(f'{name}: not a Sun raster file')
    return struct.unpack_from('>II', data, 4)


def decode(data: bytes, name: str = '<bytes>', gray: bool = False) -> np.ndarray:
    """RGB uint8 [H, W, 3] of a Sun raster file as `cv2.imread(path,
    IMREAD_COLOR)` gives it (in RGB order), or with `gray` uint8 [H, W] as
    `IMREAD_GRAYSCALE` gives it."""
    if len(data) < 32 or not is_sunras(data):
        raise ValueError(f'{name}: not a Sun raster file')
    width, height, depth, _, kind, map_type, map_length = struct.unpack_from('>7i', data, 4)
    n_palette = 3 << depth if 0 < depth <= 8 else 0
    if not (width > 0 and height > 0 and depth in (1, 8, 24, 32) and kind in (0, 1)
            and (map_type == 0 and map_length == 0
                 or map_type == 1 and 0 < map_length <= n_palette and depth <= 8)):
        raise ValueError(f'{name}: Sun raster of depth {depth}, type {kind}, map type {map_type} '
                         f'(cv2.imread reads none)')
    if width > 1 << 20 or height > 1 << 20 or width * height > 1 << 30:
        raise ValueError(f'{name}: {width}x{height} pixels (cv2.imread refuses them)')
    if 32 + map_length > len(data):
        raise ValueError(f'{name}: truncated Sun raster colormap')
    palette = np.zeros((256, 3), np.uint8)
    gray_palette = np.zeros(256, np.uint8)
    if map_length:
        n = map_length // 3
        planes = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n)
        palette[:n] = planes.T
        gray_palette = raster_native.gray14(palette)
    elif depth <= 8:
        palette[:1 << depth] = (np.arange(1 << depth) * 255 // ((1 << depth) - 1))[:, None]
    pitch = ((width * depth + 7) // 8 + 1) & -2
    start = 32 + map_length
    if start + pitch * height > len(data):
        raise ValueError(f'{name}: truncated Sun raster pixel data')
    rows = np.frombuffer(data, np.uint8, pitch * height, start).reshape(height, pitch)
    if depth <= 8:
        index = np.unpackbits(rows, axis=1)[:, :width] if depth == 1 else rows[:, :width]
        return gray_palette[index] if gray else palette[index]
    step = depth // 8
    bgr = rows[:, :width * step].reshape(height, width, step)[..., step - 3:]
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    return raster_native.gray14(rgb) if gray else rgb
