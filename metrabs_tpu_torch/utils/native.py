"""ctypes bindings of the port's native host image ops (`csrc/improc.cpp`,
the port's copy of the JAX package's `native/improc.cc`).

The library is built with the host C++ compiler at first use
(`ops/cuda_build.py::build_host_library`, into `metrabs_tpu_torch/_build/`)
and called through ctypes. A failed build raises, naming the compiler's
error: no function falls back to numpy. `bilinear_warp` is an independent
oracle for the crop warp: the warp kernel and its plain torch version are
held against it on the box-downsampled level image with the level-adjusted
intrinsics.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from metrabs_tpu_torch.ops import cuda_build

_LOCK = threading.Lock()
_LIB = None


def _load_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = cuda_build.build_host_library('improc')
            lib = ctypes.CDLL(str(path))
            f32p = ctypes.POINTER(ctypes.c_float)
            f64p = ctypes.POINTER(ctypes.c_double)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.gamma_decode_u8.argtypes = [u8p, f32p, ctypes.c_int64, ctypes.c_float]
            lib.gamma_encode_f32.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_float]
            lib.paste_over.argtypes = [f32p, f32p, f32p] + [ctypes.c_int] * 5 + \
                [ctypes.c_float] * 2
            lib.box_downsample_2x2.argtypes = [f32p, f32p] + [ctypes.c_int] * 3
            lib.bilinear_warp.argtypes = [f32p] + [ctypes.c_int] * 3 + \
                [f64p, f64p, f64p, f32p, ctypes.c_int, ctypes.c_int]
            _LIB = lib
        return _LIB


def native_available() -> bool:
    """Whether the library builds (or was built) and loads. A build that
    fails returns False here; the functions raise its error."""
    try:
        _load_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def gamma_decode_u8(image_u8: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """uint8 -> linear float32 via a table; the loader's linearisation op."""
    lib = _load_lib()
    image_u8 = np.ascontiguousarray(image_u8, np.uint8)
    out = np.empty(image_u8.shape, np.float32)
    lib.gamma_decode_u8(
        image_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _f32p(out),
        image_u8.size, ctypes.c_float(gamma))
    return out


def gamma_encode_f32(image_f32: np.ndarray, gamma: float) -> np.ndarray:
    lib = _load_lib()
    image_f32 = np.ascontiguousarray(image_f32, np.float32)
    out = np.empty(image_f32.shape, np.float32)
    lib.gamma_encode_f32(_f32p(image_f32), _f32p(out), image_f32.size,
                         ctypes.c_float(gamma))
    return out


def paste_over(src: np.ndarray, alpha: np.ndarray, dst: np.ndarray,
               center) -> np.ndarray:
    """Alpha composite; modifies and returns dst (float32 arrays). The
    numpy version is `data/augment/occlusion.py::paste_over`."""
    lib = _load_lib()
    src = np.ascontiguousarray(src, np.float32)
    alpha = np.ascontiguousarray(alpha, np.float32)
    if not dst.flags['C_CONTIGUOUS'] or dst.dtype != np.float32:
        raise ValueError('dst must be contiguous float32')
    hs, ws = src.shape[:2]
    hd, wd = dst.shape[:2]
    c = dst.shape[2]
    lib.paste_over(_f32p(src), _f32p(alpha), _f32p(dst),
                   hs, ws, hd, wd, c,
                   ctypes.c_float(center[0]), ctypes.c_float(center[1]))
    return dst


def box_downsample_2x2(image: np.ndarray) -> np.ndarray:
    lib = _load_lib()
    image = np.ascontiguousarray(image, np.float32)
    h, w, c = image.shape
    out = np.empty((h // 2, w // 2, c), np.float32)
    lib.box_downsample_2x2(_f32p(image), _f32p(out), h, w, c)
    return out


def bilinear_warp(image: np.ndarray, invprojmat: np.ndarray,
                  intrinsics: np.ndarray, distortion_coeffs: np.ndarray,
                  output_shape) -> np.ndarray:
    """Dense homography + distortion warp with a zero border: output pixel p
    samples K @ distort(project(invprojmat @ p)) of `image` [H, W, C]."""
    lib = _load_lib()
    image = np.ascontiguousarray(image, np.float32)
    d = np.zeros(12, np.float64)
    d[:len(distortion_coeffs)] = np.asarray(distortion_coeffs, np.float64)
    oh, ow = output_shape
    out = np.empty((oh, ow, image.shape[2]), np.float32)
    m = np.ascontiguousarray(invprojmat, np.float64)
    k = np.ascontiguousarray(intrinsics, np.float64)
    lib.bilinear_warp(_f32p(image), image.shape[0], image.shape[1],
                      image.shape[2], _f64p(m), _f64p(k), _f64p(d),
                      _f32p(out), oh, ow)
    return out



def warp_params_oracle(flat, params, geom, output_shape, crops=None) -> np.ndarray:
    """`bilinear_warp` of each crop (or of those in `crops`) from the crop
    warp's own inputs (`ops/warp.py::pyramid_warp_params`): the crop's level
    image cut from `flat` at its `geom` (offset, padded height and width;
    the zero ring dropped), with its `params` (new_invprojmat, the
    level-adjusted intrinsics, 12 coefficients). float32 [n, oh, ow, C]:
    what the warp kernel and its plain version must give, from independent
    C++."""
    flat_np = flat.detach().float().cpu().numpy()
    p = params.detach().cpu().double().numpy()
    g = geom.detach().cpu().numpy()
    out = []
    for i in (range(len(g)) if crops is None else crops):
        offset, hp, wp = (int(v) for v in g[i])
        level = flat_np[offset:offset + hp * wp].reshape(hp, wp, -1)[1:-1, 1:-1]
        k = np.concatenate([p[i, 9:15].reshape(2, 3), [[0.0, 0.0, 1.0]]])
        out.append(bilinear_warp(level, p[i, :9].reshape(3, 3), k, p[i, 15:], output_shape))
    return np.stack(out)

