"""JPEG decoding and encoding on the host, equal to OpenCV's bit for bit.

`decode` equals `cv2.imread(path, cv2.IMREAD_COLOR)` (converted to RGB):
`csrc/jpeg_decode.cpp` follows libjpeg-turbo 3.1's default decode (ISLOW
IDCT, fancy upsampling, its YCbCr tables), and the EXIF orientation is
applied as OpenCV applies it. `encode` equals `cv2.imencode('.jpg', bgr)`
at OpenCV's defaults: `csrc/jpeg_encode.cpp` follows libjpeg-turbo 3.1's
default compression (quality 95, 4:2:0, ISLOW FDCT, the standard Huffman
tables, a JFIF header).

Each library is built with the host C++ compiler at first use
(`ops/cuda_build.py::build_host_library`) and called through `ctypes.CDLL`,
which releases the GIL for the call: threads decode and encode in parallel.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from metrabs_tpu_torch.ops import cuda_build

_LOCK = threading.Lock()
_LIB = None
_ENCODER = None
_ERR_LEN = 256
DEFAULT_QUALITY = 95  # cv2.IMWRITE_JPEG_QUALITY's default


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
                                                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                                                ctypes.c_char_p, ctypes.c_int]
            lib.metrabs_jpeg_decode_tiff.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                                     ctypes.c_void_p, ctypes.c_size_t,
                                                     ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            lib.metrabs_jpeg_header.restype = lib.metrabs_jpeg_decode.restype = ctypes.c_int
            lib.metrabs_jpeg_decode_tiff.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _check(rc: int, err, name: str) -> None:
    if rc == 1:
        raise ValueError(f'{name}: corrupt or truncated JPEG ({err.value.decode()})')
    if rc == 2:
        raise NotImplementedError(f'{name}: {err.value.decode()} is not supported by the '
                                  f'JPEG decoder (baseline and progressive Huffman, 8-bit, '
                                  f'gray, YCbCr, RGB, CMYK or YCCK)')
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


def decode(data: bytes, name: str = '<bytes>', gray: bool = False) -> np.ndarray:
    """RGB uint8 [H, W, 3] of an encoded JPEG, EXIF orientation applied (gray
    files give three equal channels); with `gray`, uint8 [H, W], the luma
    plane, equal to `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` (libjpeg's
    grayscale output: the Y component, not a conversion of the RGB; for RGB,
    CMYK and YCCK files the conversions of libjpeg and OpenCV). CMYK and
    YCCK files are read as Adobe's inverted CMYK, as OpenCV reads them.
    Raises ValueError naming `name` for a corrupt or truncated file and
    NotImplementedError for arithmetic coding, 12-bit, lossless and
    hierarchical files."""
    height, width, orientation = header(data, name)
    channels = 1 if gray else 3
    out = np.empty((height, width, channels), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_library().metrabs_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes,
                                          channels, err, _ERR_LEN), err, name)
    out = apply_exif_orientation(out, orientation)
    return out[..., 0] if gray else out


def decode_tiff_chunk(data: bytes, components: int, ycbcr: bool,
                      name: str = '<bytes>') -> np.ndarray:
    """uint8 [H, W, C] of one strip or tile of a JPEG-compressed TIFF (its
    JPEGTables already joined to it), as libtiff's JPEG codec gives it to
    TIFFRGBAImage: with `ycbcr`, RGB (C = 3) whatever the markers say;
    otherwise the `components` coded components as they are (C =
    components), none of them subsampled. Raises ValueError as `decode`."""
    height, width, _ = header(data, name)
    channels = 3 if ycbcr else components
    out = np.empty((height, width, channels), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_library().metrabs_jpeg_decode_tiff(data, len(data), out.ctypes.data, out.nbytes,
                                               int(ycbcr), err, _ERR_LEN), err, name)
    return out


def apply_exif_orientation(im: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's `ApplyExifOrientation`: values 2-8 flip and transpose, any
    other value leaves the image as it is."""
    if orientation in (5, 6, 7, 8):
        im = im.transpose(1, 0, 2)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    if flips:
        im = np.flip(im, axis=flips)
    return np.ascontiguousarray(im)


def _encoder() -> ctypes.CDLL:
    global _ENCODER
    with _LOCK:
        if _ENCODER is None:
            path, _ = cuda_build.build_host_library('jpeg_encode')
            lib = ctypes.CDLL(str(path))
            lib.metrabs_jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_int, ctypes.c_int,
                                                ctypes.POINTER(ctypes.c_size_t),
                                                ctypes.c_char_p, ctypes.c_int]
            lib.metrabs_jpeg_encode.restype = ctypes.c_void_p
            lib.metrabs_jpeg_free.argtypes = [ctypes.c_void_p]
            lib.metrabs_jpeg_free.restype = None
            _ENCODER = lib
        return _ENCODER


def encode(image: np.ndarray, quality: int = DEFAULT_QUALITY) -> bytes:
    """JPEG file bytes of an RGB uint8 [H, W, 3] image (or gray [H, W] or
    [H, W, 1]), equal to `cv2.imencode('.jpg', bgr, [cv2.IMWRITE_JPEG_QUALITY,
    quality])` of the same pixels in BGR order: baseline, 4:2:0 for colour,
    the standard Huffman tables, no restart interval, a JFIF APP0 header."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f'expected uint8 pixels, got {image.dtype}')
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    channels = 1 if image.ndim == 2 else image.shape[2]
    if image.ndim not in (2, 3) or channels not in (1, 3):
        raise ValueError(f'expected an [H, W, 3] or [H, W] image, got {image.shape}')
    size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR_LEN)
    lib = _encoder()
    buf = lib.metrabs_jpeg_encode(image.ctypes.data, image.shape[0], image.shape[1], channels,
                                  int(quality), ctypes.byref(size), err, _ERR_LEN)
    if not buf:
        raise ValueError(f'JPEG encoding failed: {err.value.decode()}')
    try:
        return ctypes.string_at(buf, size.value)
    finally:
        lib.metrabs_jpeg_free(buf)
