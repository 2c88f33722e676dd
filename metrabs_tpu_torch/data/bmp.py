"""BMP decoding on the host, equal to `cv2.imread` (OpenCV 5.0's own BMP
reader) bit for bit, in colour and in gray.

The header is read here as BmpDecoder::readHeader reads it:
BITMAPCOREHEADER (OS/2, 12 bytes: a palette of 3-byte entries) and every
longer header (INFO, V2-V5, OS/2 2.x: 4-byte entries, `biClrUsed` of them or
2^bits); 1, 4, 8, 24 and 32 bits uncompressed, 16 bits uncompressed (555)
or with BI_BITFIELDS masks of 555 or 565 (read after the header, where
OpenCV reads them), 32 bits with BI_BITFIELDS (B, G, R, A; where a V3-V5
header sets all three colour masks they must be the 8-bit ones, and OpenCV
5.0 then truncates its gray), RLE8 at 8 bits and RLE4 at 4 (whose escapes
skip no rows in OpenCV 5.0: end of bitmap ends the row, delta moves on dx). Rows are bottom-up for a positive
height and top-down for a negative one. `csrc/raster_decode.cpp` decodes
the pixels (see data/raster_native.py). Alpha is dropped; gray is OpenCV's
icvCvt_BGR2Gray. Where cv2.imread returns None (other bit depths and
compressions, other 16-bit masks, a palette of more than 256 entries, a
zero size, truncated data, an RLE run past the end of a row) `decode`
raises ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

from metrabs_tpu_torch.data import raster_native

SIGNATURE = b'BM'
_RGB, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3


def is_bmp(data: bytes) -> bool:
    return data[:2] == SIGNATURE


def parse(data: bytes, name: str = '<bytes>') -> dict:
    """The fields of the header and the palette (256 B, G, R, A entries,
    zero past those the file holds), as BmpDecoder::readHeader reads them."""
    try:
        offset, size = struct.unpack_from('<iI', data, 10)
        if size == 0 or size >= 2 ** 31:
            raise ValueError(f'{name}: bad BMP header size {size}')
        palette = np.zeros((256, 4), np.uint8)
        if size >= 36:
            width, height, bpp, rle = struct.unpack_from('<iiIi', data, 18)
            bpp >>= 16
            if not 0 <= rle <= _BITFIELDS:
                raise ValueError(f'{name}: BMP compression {rle}')
            clrused = struct.unpack_from('<i', data, 46)[0]
            pos = 14 + size
            masks = struct.unpack_from('<III', data, 54) if size >= 56 else (0, 0, 0)
            ok = width > 0 and height != 0 and (
                bpp in (1, 4, 8, 24, 32) and rle == _RGB
                or bpp in (16, 32) and rle in (_RGB, _BITFIELDS)
                or bpp == 4 and rle == _RLE4 or bpp == 8 and rle == _RLE8)
            if not ok:
                raise ValueError(f'{name}: {bpp}-bit BMP with compression {rle} (cv2.imread '
                                 f'reads none)')
            if bpp <= 8:
                if not 0 <= clrused <= 256:
                    raise ValueError(f'{name}: a BMP palette of {clrused} entries')
                n = clrused or 1 << bpp
                if pos + 4 * n > len(data):
                    raise ValueError(f'{name}: truncated BMP palette')
                palette[:n] = np.frombuffer(data, np.uint8, 4 * n, pos).reshape(n, 4)
            elif bpp == 16 and rle == _BITFIELDS:
                red, green, blue = struct.unpack_from('<III', data, pos)
                if (blue, green, red) == (0x1f, 0x3e0, 0x7c00):
                    bpp = 15
                elif (blue, green, red) != (0x1f, 0x7e0, 0xf800):
                    raise ValueError(f'{name}: 16-bit BMP masks {red:#x}, {green:#x}, '
                                     f'{blue:#x} (cv2.imread reads 555 and 565)')
            elif bpp == 16:
                bpp = 15
        elif size == 12:
            masks = (0, 0, 0)
            width, height, bpp = struct.unpack_from('<HHI', data, 18)
            bpp >>= 16
            rle = _RGB
            if width == 0 or height == 0 or bpp not in (1, 4, 8, 24, 32):
                raise ValueError(f'{name}: {bpp}-bit OS/2 BMP (cv2.imread reads none)')
            if bpp <= 8:
                n = 1 << bpp
                if 26 + 3 * n > len(data):
                    raise ValueError(f'{name}: truncated BMP palette')
                palette[:n, :3] = np.frombuffer(data, np.uint8, 3 * n, 26).reshape(n, 3)
        else:
            raise ValueError(f'{name}: BMP header size {size} (cv2.imread reads none)')
    except struct.error:
        raise ValueError(f'{name}: truncated BMP header') from None
    if offset < 0:
        raise ValueError(f'{name}: bad BMP pixel data offset {offset}')
    # OpenCV 5.0 reads the colour masks inside a V3-V5 header of a 32-bit
    # BI_BITFIELDS file when all three are set.
    masked = size >= 56 and bpp == 32 and rle == _BITFIELDS and all(masks)
    if masked and masks != (0xff0000, 0xff00, 0xff):
        raise NotImplementedError(f'{name}: 32-bit BMP colour masks {[hex(m) for m in masks]} '
                                  f'(8-bit B, G, R masks are read)')
    return dict(offset=offset, width=width, height=abs(height), top_down=height < 0, bpp=bpp,
                rle=rle, palette=palette, masked=masked)


def header(data: bytes, name: str = '<bytes>'):
    """(width, height) from the header, as PIL's size."""
    info = parse(data, name)
    return info['width'], info['height']


def decode(data: bytes, name: str = '<bytes>', gray: bool = False) -> np.ndarray:
    """RGB uint8 [H, W, 3] of a BMP file as `cv2.imread(path, IMREAD_COLOR)`
    gives it (in RGB order), or with `gray` uint8 [H, W] as
    `IMREAD_GRAYSCALE` gives it."""
    info = parse(data, name)
    width, height = info['width'], info['height']
    if width > 1 << 20 or height > 1 << 20 or width * height > 1 << 30:
        raise ValueError(f'{name}: BMP of {width}x{height} pixels (cv2.imread refuses it)')
    channels = 1 if gray else 3
    if info['masked']:
        # The masked path: B, G, R bytes, and gray as OpenCV 5.0 computes it
        # there: r * 0.299f + g * 0.587f + b * 0.114f in float, truncated.
        end = info['offset'] + 4 * width * height
        if end > len(data):
            raise ValueError(f'{name}: truncated BMP pixel data')
        bgra = np.frombuffer(data, np.uint8, 4 * width * height, info['offset'])
        bgra = bgra.reshape(height, width, 4)
        if not info['top_down']:
            bgra = bgra[::-1]
        if gray:
            f = bgra.astype(np.float32)
            y = (f[..., 2] * np.float32(0.299) + f[..., 1] * np.float32(0.587)
                 + f[..., 0] * np.float32(0.114))
            return y.astype(np.uint8)
        return np.ascontiguousarray(bgra[..., 2::-1])
    out = np.zeros((height, width, channels), np.uint8)
    err = raster_native.error_buffer()
    if raster_native.library().metrabs_bmp_decode(
            data, len(data), info['offset'], width, height, int(info['top_down']), info['bpp'],
            {_RLE8: 1, _RLE4: 2}.get(info['rle'], 0), info['palette'].tobytes(), out.ctypes.data, channels, err,
            raster_native.ERR_LEN):
        raise ValueError(f'{name}: corrupt BMP ({err.value.decode()})')
    return out[..., 0] if gray else out
