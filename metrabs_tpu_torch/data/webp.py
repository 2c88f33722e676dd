"""WebP decoding on the host, equal to `cv2.imread` (OpenCV 5.0 on libwebp)
bit for bit, in colour and in gray.

The RIFF container is parsed here: the simple formats (`VP8 ` and `VP8L`)
and the extended one (`VP8X` with `ALPH`, `ICCP`, `EXIF`, `XMP `, and
`ANIM`/`ANMF`, of which the first frame counts, as cv2 reads it: decoded
into a black canvas at its offset). `csrc/webp_decode.cpp` (built with the
host C++ compiler at first use by `ops/cuda_build.py::build_host_library`,
called through `ctypes`, which releases the GIL) decodes the VP8L and VP8
bitstreams to RGB as libwebp's WebPDecodeBGRInto does. Alpha is dropped,
as IMREAD_COLOR drops it; gray is `cv2.cvtColor(bgr, COLOR_BGR2GRAY)` of
that. The `EXIF` chunk of a file whose VP8X flags announce one gives the
orientation, applied as cv2 applies it.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np

from metrabs_tpu_torch.data import exif, raster_native
from metrabs_tpu_torch.data.jpeg import apply_exif_orientation
from metrabs_tpu_torch.ops import cuda_build

_ERR_LEN = 256
_FLAG_ANIMATION, _FLAG_EXIF = 0x02, 0x08
_LOCK = threading.Lock()
_LIB = None


def is_webp(data: bytes) -> bool:
    return len(data) >= 12 and data[:4] == b'RIFF' and data[8:12] == b'WEBP'


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = cuda_build.build_host_library('webp_decode')
            lib = ctypes.CDLL(str(path))
            lib.metrabs_webp_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            lib.metrabs_webp_decode.restype = ctypes.c_int
            lib.metrabs_webp_vp8_tools.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                                   ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            lib.metrabs_webp_vp8_tools.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _chunks(data: bytes, start: int, end: int, name: str):
    """(fourcc, payload) of the chunks in data[start:end]."""
    pos = start
    while pos + 8 <= end:
        fourcc, size = data[pos:pos + 4], struct.unpack_from('<I', data, pos + 4)[0]
        if pos + 8 + size > end:
            raise ValueError(f'{name}: truncated WebP ({fourcc!r} chunk)')
        yield fourcc, data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)


def _u24(b: bytes, at: int) -> int:
    return b[at] | b[at + 1] << 8 | b[at + 2] << 16


def bitstream_size(fourcc: bytes, payload: bytes, name: str = '<bytes>'):
    """(width, height) from a VP8 frame header or a VP8L header."""
    if fourcc == b'VP8 ':
        if len(payload) < 10 or payload[3:6] != b'\x9d\x01\x2a':
            raise ValueError(f'{name}: bad VP8 frame header')
        return (struct.unpack_from('<H', payload, 6)[0] & 0x3fff,
                struct.unpack_from('<H', payload, 8)[0] & 0x3fff)
    if len(payload) < 5 or payload[0] != 0x2f:
        raise ValueError(f'{name}: bad VP8L header')
    bits = struct.unpack_from('<I', payload, 1)[0]
    return (bits & 0x3fff) + 1, ((bits >> 14) & 0x3fff) + 1


def parse(data: bytes, name: str = '<bytes>') -> dict:
    """The canvas size, the bitstream of the image (or of the first frame,
    with its offset), and the EXIF orientation of a WebP file."""
    if not is_webp(data):
        raise ValueError(f'{name}: not a WebP file')
    riff_size = struct.unpack_from('<I', data, 4)[0]
    if riff_size < 12 or riff_size + 8 > len(data):
        raise ValueError(f'{name}: truncated WebP (RIFF size {riff_size}, {len(data)} bytes)')
    chunks = list(_chunks(data, 12, riff_size + 8, name))
    if not chunks:
        raise ValueError(f'{name}: empty WebP')
    info = dict(orientation=1, x=0, y=0)
    first, payload = chunks[0]
    if first in (b'VP8 ', b'VP8L'):  # the simple formats
        info.update(fourcc=first, payload=payload)
        info['width'], info['height'] = info['frame_size'] = bitstream_size(first, payload, name)
        return info
    if first != b'VP8X' or len(payload) < 10:
        raise ValueError(f'{name}: WebP starts with {first!r}')
    flags = struct.unpack_from('<I', payload, 0)[0]
    info['width'], info['height'] = _u24(payload, 4) + 1, _u24(payload, 7) + 1
    if flags & _FLAG_EXIF:
        block = next((p for k, p in chunks if k == b'EXIF'), None)
        if block is not None:
            info['orientation'] = exif.orientation(block)
    if flags & _FLAG_ANIMATION:
        frame = next((p for k, p in chunks if k == b'ANMF'), None)
        if frame is None or len(frame) < 16:
            raise ValueError(f'{name}: an animated WebP without frames')
        info['x'], info['y'] = 2 * _u24(frame, 0), 2 * _u24(frame, 3)
        size = _u24(frame, 6) + 1, _u24(frame, 9) + 1
        sub = list(_chunks(frame, 16, len(frame), name))
    else:
        size, sub = (info['width'], info['height']), chunks[1:]
    bitstream = next(((k, p) for k, p in sub if k in (b'VP8 ', b'VP8L')), None)
    if bitstream is None:
        raise ValueError(f'{name}: no VP8 or VP8L bitstream')
    info['fourcc'], info['payload'] = bitstream
    info['frame_size'] = bitstream_size(*bitstream, name)
    if (info['frame_size'] != size or info['x'] + size[0] > info['width']
            or info['y'] + size[1] > info['height']):
        raise ValueError(f'{name}: frame {info["frame_size"]} at ({info["x"]}, {info["y"]}) does '
                         f'not fit its {size} or the canvas {info["width"]}x{info["height"]}')
    return info


def header(data: bytes, name: str = '<bytes>'):
    """(width, height) of the canvas, before any EXIF orientation (PIL's
    size)."""
    info = parse(data, name)
    return info['width'], info['height']


def decode(data: bytes, name: str = '<bytes>', gray: bool = False) -> np.ndarray:
    """RGB uint8 [H, W, 3] of a WebP file as `cv2.imread(path,
    IMREAD_COLOR)` gives it (in RGB order), or with `gray` uint8 [H, W] as
    `IMREAD_GRAYSCALE` gives it, EXIF orientation applied. Raises
    ValueError for a corrupt or truncated file and NotImplementedError for a
    bitstream tool the decoder does not read."""
    info = parse(data, name)
    fw, fh = info['frame_size']
    frame = np.empty((fh, fw, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    payload = info['payload']
    rc = _library().metrabs_webp_decode(payload, len(payload), int(info['fourcc'] == b'VP8L'),
                                        fw, fh, frame.ctypes.data, err, _ERR_LEN)
    if rc == 2:
        raise NotImplementedError(f'{name}: {err.value.decode()} is not supported by the WebP '
                                  f'decoder')
    if rc != 0:
        raise ValueError(f'{name}: corrupt WebP ({err.value.decode()})')
    if (fw, fh) != (info['width'], info['height']):
        canvas = np.zeros((info['height'], info['width'], 3), np.uint8)
        canvas[info['y']:info['y'] + fh, info['x']:info['x'] + fw] = frame
        frame = canvas
    if gray:
        frame = raster_native.gray15(frame)[..., None]
    out = apply_exif_orientation(frame, info['orientation'])
    return out[..., 0] if gray else out


VP8_TOOLS = ('filter_type', 'filter_level', 'sharpness', 'partitions', 'segmentation',
             'segment_map', 'filter_deltas', 'skip_probability')


def vp8_tools(data: bytes, name: str = '<bytes>') -> dict:
    """The coding tools of a lossy WebP's VP8 frame header (filter type 0
    none, 1 simple, 2 normal; level; sharpness; token partitions; flags), or
    None for a lossless file."""
    info = parse(data, name)
    if info['fourcc'] != b'VP8 ':
        return None
    out = (ctypes.c_int * len(VP8_TOOLS))()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _library().metrabs_webp_vp8_tools(info['payload'], len(info['payload']), out, err,
                                          _ERR_LEN) != 0:
        raise ValueError(f'{name}: corrupt VP8 frame header ({err.value.decode()})')
    return dict(zip(VP8_TOOLS, list(out)))
