"""CPU image helpers of the data pipeline (`metrabs_tpu/data/improc.py`)
without OpenCV: images are read from JPEG (through `data.jpeg`, equal to
cv2's decode), PNG (through `data.cvfree`) and `.npy` files, and the colour
and resize helpers give OpenCV's numbers.

Video decoding waits for a decoder on the card's machine, which has none
(ROADMAP.md lists it); `imread` refuses video frames.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

from metrabs_tpu_torch.data import cvfree, jpeg

_UNDECODED = ('video decoding is not ported: the GPU machine has no decoder '
              '(ROADMAP.md, "Video decoding"); extract the frames to JPEG, PNG or .npy')
_JPEG_SIGNATURE = b'\xff\xd8\xff'
_PNG_SIGNATURE = b'\x89PNG'


def imread(path: str) -> np.ndarray:
    """RGB uint8 [H, W, 3] image. The format is the file's signature, as cv2
    reads it: JPEG (`FF D8 FF`; equal to `cv2.imread(path, IMREAD_COLOR)`,
    EXIF orientation applied) or PNG (`89 50 4E 47`; gray is repeated over
    the three channels and alpha dropped, as IMREAD_COLOR does); a `.npy`
    file holds such an array. Raises FileNotFoundError for a missing file,
    ValueError for a corrupt or truncated JPEG, and NotImplementedError for
    video frames (`video.ext#frame=N`) and any other format."""
    path = str(path)
    if '#frame=' in path:
        raise NotImplementedError(f'{path}: {_UNDECODED}')
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    if os.path.splitext(path)[1].lower() == '.npy':
        im = np.load(path)
        if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f'{path}: expected a uint8 [H, W, 3] array, got {im.dtype} '
                             f'{im.shape}')
        return im
    with open(path, 'rb') as f:
        data = f.read()
    if data.startswith(_JPEG_SIGNATURE):
        return jpeg.decode(data, path)
    if not data.startswith(_PNG_SIGNATURE):
        raise NotImplementedError(f'{path}: neither JPEG nor PNG (the formats imread decodes)')
    im = cvfree.read_png(path)
    if im.ndim == 2:
        return np.repeat(im[..., None], 3, axis=2)
    return np.ascontiguousarray(im[..., :3])


def normalize01(im: np.ndarray) -> np.ndarray:
    """uint8-range values -> [0, 1] float32: /255 and clip for every input
    dtype."""
    return np.clip(im.astype(np.float32) / np.float32(255), 0.0, 1.0)


def adjust_gamma(im: np.ndarray, gamma: float, inplace: bool = False) -> np.ndarray:
    """LUT-based gamma adjustment."""
    if np.issubdtype(im.dtype, np.integer):
        lut = (np.clip(np.linspace(0, 1, 256) ** gamma, 0, 1) * 255).astype(im.dtype)
        out = lut[im]
    else:
        out = np.clip(im, 0, 1) ** gamma
    if inplace:
        im[:] = out
        return im
    return out


def white_balance(im: np.ndarray, a: Optional[float] = None,
                  b: Optional[float] = None) -> np.ndarray:
    """LAB-space, luminance-weighted white balance: shifts the a/b chroma
    channels toward neutral (128) in proportion to each pixel's luminance,
    with gain 1.1. `a`/`b` override the measured channel means (the 3DHP fix
    passes 110/145, Panoptic 120/138). Input must be RGB uint8; the chroma
    update is written back into the uint8 LAB array by numpy's truncating
    cast, as in the JAX package."""
    if im.dtype != np.uint8:
        raise ValueError(f'white_balance expects uint8 RGB, got {im.dtype}')
    lab = cvfree.rgb_to_lab(im)
    avg_a = np.mean(lab[..., 1]) if a is None else a
    avg_b = np.mean(lab[..., 2]) if b is None else b
    lum = lab[..., 0] / 255.0
    lab[..., 1] = lab[..., 1] - (avg_a - 128) * lum * 1.1
    lab[..., 2] = lab[..., 2] - (avg_b - 128) * lum * 1.1
    return cvfree.lab_to_rgb(lab)


def resize_by_factor(im: np.ndarray, factor: float) -> np.ndarray:
    new_size = (max(1, int(round(im.shape[1] * factor))),
                max(1, int(round(im.shape[0] * factor))))
    interp = cvfree.INTER_LINEAR if factor > 1 else cvfree.INTER_AREA
    return cvfree.resize(im, new_size, interpolation=interp)


def blend_image(im1: np.ndarray, im2: np.ndarray,
                im2_weight: np.ndarray) -> np.ndarray:
    """Per-pixel lerp `im1*(1-w) + im2*w` with a broadcastable weight map,
    returned in im1's dtype."""
    w = np.asarray(im2_weight, np.float32)
    if w.ndim == im1.ndim - 1:
        w = w[..., np.newaxis]
    out = im1.astype(np.float32) * (1 - w) + im2.astype(np.float32) * w
    if np.issubdtype(im1.dtype, np.integer):
        out = np.clip(np.round(out), 0, 255)
    return out.astype(im1.dtype)


def is_image_readable(path: str) -> bool:
    """True iff `imread` succeeds."""
    try:
        imread(path)
        return True
    except Exception:
        return False


def rounded_int_tuple(p) -> tuple:
    """Rounded int tuple of a float point, for drawing calls."""
    return tuple(np.round(np.asarray(p)).astype(int))


def image_extents(filepath: str) -> np.ndarray:
    """Image (width, height) without decoding pixel data: from a `.npy`
    file's header, a PNG's, or a JPEG's frame header (before its EXIF
    orientation, as the JAX package reads it); other formats raise
    NotImplementedError."""
    filepath = str(filepath)
    if os.path.splitext(filepath)[1].lower() == '.npy':
        shape = np.load(filepath, mmap_mode='r').shape
        return np.asarray([shape[1], shape[0]])
    with open(filepath, 'rb') as f:
        data = f.read(24)
        if data.startswith(_JPEG_SIGNATURE):
            # The frame header follows segments of any length (EXIF, tables).
            height, width, _ = jpeg.header(data + f.read(), filepath)
            return np.asarray([width, height])
    if data[:8] != b'\x89PNG\r\n\x1a\n' or data[12:16] != b'IHDR':
        raise NotImplementedError(f'{filepath}: neither JPEG nor PNG')
    return np.asarray(struct.unpack('>II', data[16:24]))
