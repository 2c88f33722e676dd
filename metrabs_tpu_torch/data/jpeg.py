"""JPEG decoding on the host, equal to `cv2.imread(path, cv2.IMREAD_COLOR)`
(converted to RGB) bit for bit: `csrc/jpeg_decode.cpp` follows libjpeg-turbo
3.1's default decode (ISLOW IDCT, fancy upsampling, its YCbCr tables), and
the EXIF orientation is applied as OpenCV applies it.

The library is built with the host C++ compiler at first use
(`ops/cuda_build.py::build_host_library`) and called through `ctypes.CDLL`,
which releases the GIL for the call: threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from metrabs_tpu_torch.ops import cuda_build

_LOCK = threading.Lock()
_LIB = None
_ERR_LEN = 256


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = cuda_build.build_host_library('jpeg_decode')
            lib = ctypes.CDLL(str(path))
            int_p = ctypes.POINTER(ctypes.c_int)
            lib.metrabs_jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_size_t, int_p, int_p,
                                                int_p, ctypes.c_char_p, ctypes.c_int]
            lib.metrabs_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                                ctypes.c_void_p, ctypes.c_size_t,
                                                ctypes.c_char_p, ctypes.c_int]
            lib.metrabs_jpeg_header.restype = lib.metrabs_jpeg_decode.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _check(rc: int, err, name: str) -> None:
    if rc == 1:
        raise ValueError(f'{name}: corrupt or truncated JPEG ({err.value.decode()})')
    if rc == 2:
        raise NotImplementedError(f'{name}: {err.value.decode()} is not supported by the '
                                  f'JPEG decoder (baseline and progressive Huffman, 8-bit, '
                                  f'gray or YCbCr)')
    if rc != 0:
        raise RuntimeError(f'{name}: the JPEG decoder returned {rc}')


def header(data: bytes, name: str = '<bytes>'):
    """(height, width, EXIF orientation) of the encoded frame, before the
    orientation is applied."""
    lib = _library()
    h, w, o = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(lib.metrabs_jpeg_header(data, len(data), ctypes.byref(h), ctypes.byref(w),
                                   ctypes.byref(o), err, _ERR_LEN), err, name)
    return h.value, w.value, o.value


def decode(data: bytes, name: str = '<bytes>') -> np.ndarray:
    """RGB uint8 [H, W, 3] of an encoded JPEG, EXIF orientation applied (gray
    files give three equal channels). Raises ValueError naming `name` for a
    corrupt or truncated file and NotImplementedError for arithmetic coding,
    12-bit, lossless, hierarchical, CMYK/YCCK and RGB-coded files."""
    height, width, orientation = header(data, name)
    out = np.empty((height, width, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_library().metrabs_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes, err,
                                          _ERR_LEN), err, name)
    return apply_exif_orientation(out, orientation)


def apply_exif_orientation(im: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's `ApplyExifOrientation`: values 2-8 flip and transpose, any
    other value leaves the image as it is."""
    if orientation in (5, 6, 7, 8):
        im = im.transpose(1, 0, 2)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    if flips:
        im = np.flip(im, axis=flips)
    return np.ascontiguousarray(im)
