"""The host library of the simple raster formats (`csrc/raster_decode.cpp`:
BMP, PNM's ASCII numbers, GIF's LZW and Radiance scanlines), built with the
host C++ compiler at first use by `ops/cuda_build.py::build_host_library`
and called through `ctypes` (which releases the GIL), and the conversions
to 8 bits and to gray that OpenCV's readers apply to what it decodes."""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from metrabs_tpu_torch.ops import cuda_build

ERR_LEN = 256
_LOCK = threading.Lock()
_LIB = None


def library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = cuda_build.build_host_library('raster_decode')
            lib = ctypes.CDLL(str(path))
            c = ctypes
            lib.metrabs_bmp_decode.argtypes = [
                c.c_char_p, c.c_size_t, c.c_size_t, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
                c.c_char_p, c.c_void_p, c.c_int, c.c_char_p, c.c_int]
            lib.metrabs_pnm_numbers.argtypes = [
                c.c_char_p, c.c_size_t, c.POINTER(c.c_size_t), c.c_long, c.c_int, c.c_void_p,
                c.c_char_p, c.c_int]
            lib.metrabs_gif_lzw.argtypes = [c.c_char_p, c.c_size_t, c.c_int, c.c_void_p, c.c_long,
                                            c.c_char_p, c.c_int]
            lib.metrabs_hdr_scanlines.argtypes = [c.c_char_p, c.c_size_t, c.c_int, c.c_int,
                                                  c.c_void_p, c.c_char_p, c.c_int]
            for f in (lib.metrabs_bmp_decode, lib.metrabs_pnm_numbers, lib.metrabs_gif_lzw,
                      lib.metrabs_hdr_scanlines):
                f.restype = c.c_int
            _LIB = lib
        return _LIB


def error_buffer():
    return ctypes.create_string_buffer(ERR_LEN)


def gray14(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's icvCvt_BGR2Gray_8u_C3C1R of RGB uint8 [..., 3]: 0.299, 0.587
    and 0.114 in 14-bit fixed point, rounded."""
    x = rgb.astype(np.int32)
    return ((x[..., 0] * 4899 + x[..., 1] * 9617 + x[..., 2] * 1868 + 8192) >> 14).astype(np.uint8)


def gray15(rgb: np.ndarray) -> np.ndarray:
    """OpenCV 5.0's 8-bit cvtColor(COLOR_BGR2GRAY) of RGB uint8 [..., 3]:
    0.299, 0.587 and 0.114 in 15-bit fixed point, rounded."""
    x = rgb.astype(np.int32)
    return ((x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + 16384) >> 15).astype(np.uint8)


def saturate_u8(x: np.ndarray) -> np.ndarray:
    """float32 -> uint8 as OpenCV's convertTo: rounded half to even, then
    clamped to [0, 255]; NaN and values beyond the int range (which the
    rounding instruction turns into INT_MIN) give 0."""
    r = np.rint(np.asarray(x, np.float32).astype(np.float64))
    r[~(np.abs(r) < 2.0 ** 31)] = -(2.0 ** 31)
    return np.clip(r, 0, 255).astype(np.uint8)
