"""GIF decoding on the host, equal to `cv2.imread` (OpenCV 5.0's own GIF
reader, which reads the first frame) bit for bit, in colour and in gray.

GIF87a and GIF89a: the logical screen, the global colour table, the
extensions before the first image (a graphic control extension's
transparent index counts), the first image descriptor with its local
colour table, interlace and offset, and its LZW data (decoded by
`csrc/raster_decode.cpp`, see data/raster_native.py). As OpenCV 5.0 reads
it: the screen starts as the global table's background colour (black
without a global table); the frame is drawn at its offset, its transparent
pixels leaving the screen as it was; an index is looked up in the global
table overlaid by the local one, and one past both fails. Gray is OpenCV
5.0's BGR2GRAY of the colour image. OpenCV walks the whole file when it
reads the header, so cv2.imread returns None, and `decode` raises
ValueError, for a truncated file or one without its trailer, as for a
background index past the global table, a frame outside the screen or LZW
data that does not fill the frame.
"""

from __future__ import annotations

import struct

import numpy as np

from metrabs_tpu_torch.data import raster_native

SIGNATURES = (b'GIF87a', b'GIF89a')


def is_gif(data: bytes) -> bool:
    return data[:6] in SIGNATURES


def header(data: bytes, name: str = '<bytes>'):
    """(width, height) of the logical screen, as PIL's size."""
    if len(data) < 10 or not is_gif(data):
        raise ValueError(f'{name}: not a GIF file')
    return struct.unpack_from('<HH', data, 6)


def _sub_blocks(data: bytes, pos: int, name: str):
    """(the joined data of the sub-blocks at pos, position after them)."""
    out = []
    while True:
        if pos >= len(data):
            raise ValueError(f'{name}: truncated GIF')
        n = data[pos]
        if pos + 1 + n > len(data):
            raise ValueError(f'{name}: truncated GIF')
        if n == 0:
            return b''.join(out), pos + 1
        out.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n


def parse(data: bytes, name: str = '<bytes>') -> dict:
    """The screen, the global table and the first frame, every block of the
    file walked to the trailer as OpenCV's readHeader walks it."""
    if len(data) < 13 or not is_gif(data):
        raise ValueError(f'{name}: not a GIF file')
    width, height, flags, background = struct.unpack_from('<HHBB', data, 6)
    if width == 0 or height == 0:
        raise ValueError(f'{name}: a GIF screen of {width}x{height}')
    pos = 13
    global_size = 2 << (flags & 7) if flags & 0x80 else 0
    if pos + 3 * global_size > len(data):
        raise ValueError(f'{name}: truncated GIF colour table')
    global_table = np.frombuffer(data, np.uint8, 3 * global_size, pos).reshape(-1, 3)
    pos += 3 * global_size
    if global_size and background >= global_size:
        raise ValueError(f'{name}: GIF background index {background} past its colour table')
    frame, transparent = None, None
    while True:
        if pos >= len(data):
            raise ValueError(f'{name}: truncated GIF (no trailer)')
        kind = data[pos]
        if kind == 0x3B:
            break
        if kind == 0x21:
            if pos + 2 > len(data):
                raise ValueError(f'{name}: truncated GIF')
            label = data[pos + 1]
            body, end = _sub_blocks(data, pos + 2, name)
            if frame is None and label == 0xF9 and len(body) >= 4:
                transparent = body[3] if body[0] & 1 else None
            pos = end
        elif kind == 0x2C:
            if pos + 10 > len(data):
                raise ValueError(f'{name}: truncated GIF')
            left, top, w, h, image_flags = struct.unpack_from('<HHHHB', data, pos + 1)
            pos += 10
            local_size = 2 << (image_flags & 7) if image_flags & 0x80 else 0
            local_table = np.frombuffer(data, np.uint8, 3 * local_size, pos).reshape(-1, 3) \
                if pos + 3 * local_size <= len(data) else None
            pos += 3 * local_size
            if pos >= len(data) or local_table is None:
                raise ValueError(f'{name}: truncated GIF')
            min_code_size = data[pos]
            lzw, pos = _sub_blocks(data, pos + 1, name)
            if frame is None:
                frame = dict(left=left, top=top, width=w, height=h,
                             interlace=bool(image_flags & 0x40), local_table=local_table,
                             min_code_size=min_code_size, lzw=lzw, transparent=transparent)
        else:
            raise ValueError(f'{name}: unknown GIF block {kind:#x}')
    if frame is None:
        raise ValueError(f'{name}: a GIF without an image')
    return dict(width=width, height=height, background=background, global_table=global_table,
                frame=frame)


def decode(data: bytes, name: str = '<bytes>', gray: bool = False) -> np.ndarray:
    """RGB uint8 [H, W, 3] of a GIF's first frame on its screen as
    `cv2.imread(path, IMREAD_COLOR)` gives it (in RGB order), or with `gray`
    uint8 [H, W] as `IMREAD_GRAYSCALE` gives it."""
    info = parse(data, name)
    f = info['frame']
    sw, sh = info['width'], info['height']
    if f['width'] == 0 or f['height'] == 0 or f['left'] + f['width'] > sw or \
            f['top'] + f['height'] > sh:
        raise ValueError(f'{name}: a GIF frame outside its screen')
    table = np.zeros((256, 3), np.uint8)
    g = info['global_table']
    table[:len(g)] = g
    table[:len(f['local_table'])] = f['local_table']
    size = max(len(g), len(f['local_table']))
    index = np.empty(f['width'] * f['height'], np.uint8)
    err = raster_native.error_buffer()
    if raster_native.library().metrabs_gif_lzw(f['lzw'], len(f['lzw']), f['min_code_size'],
                                               index.ctypes.data, index.size, err,
                                               raster_native.ERR_LEN):
        raise ValueError(f'{name}: corrupt GIF image data ({err.value.decode()})')
    index = index.reshape(f['height'], f['width'])
    if f['interlace']:
        rows = np.concatenate([np.arange(start, f['height'], step)
                               for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))])
        deinterlaced = np.empty_like(index)
        deinterlaced[rows] = index
        index = deinterlaced
    opaque = np.ones(index.shape, bool) if f['transparent'] is None else index != f['transparent']
    if (index[opaque] >= size).any():
        raise ValueError(f'{name}: a GIF colour index past its colour tables')
    canvas = np.zeros((sh, sw, 3), np.uint8)
    if len(g):
        canvas[:] = g[info['background']]
    region = canvas[f['top']:f['top'] + f['height'], f['left']:f['left'] + f['width']]
    region[opaque] = table[index[opaque]]
    return raster_native.gray15(canvas) if gray else canvas
