"""Color augmentation (`metrabs_tpu/data/augment/color.py`, with the HSV
conversions of `data.cvfree`): order-randomized brightness/contrast/hue/
saturation jitter.

All four ops mutate a float32 image buffer in place and draw exactly one
uniform sample each, applied in shuffled order. The RNG-draw sequence, the
per-op float32 rounding order, and the lazy RGB<->HSV conversion protocol
are part of the pinned contract, so each transform is expressed as in-place
ufunc calls in the reference's op order (ranges: brightness +-0.125,
contrast 0.5-1.5 about mid-gray, hue +-72 deg, saturation 0.5-1.5)."""

from __future__ import annotations

import numpy as np

from metrabs_tpu_torch.data import cvfree

_BRIGHTNESS_MAX_DELTA = 0.125
_CONTRAST_RANGE = (0.5, 1.5)
_HUE_MAX_DELTA_DEG = 72.0
_SATURATION_RANGE = (0.5, 1.5)


def _ensure_rgb(im: np.ndarray, colorspace: str) -> str:
    """Converts the buffer to RGB in place if it is currently HSV."""
    if colorspace != 'rgb':
        im[:] = cvfree.hsv_to_rgb(im)
    return 'rgb'


def _ensure_hsv(im: np.ndarray, colorspace: str) -> str:
    """Converts the buffer to HSV in place if it is currently RGB (clipping
    first: the float RGB to HSV conversion assumes [0, 1] input)."""
    if colorspace != 'hsv':
        np.clip(im, 0.0, 1.0, out=im)
        im[:] = cvfree.rgb_to_hsv(im)
    return 'hsv'


def augment_brightness(im, in_colorspace, rng):
    colorspace = _ensure_rgb(im, in_colorspace)
    np.add(im, rng.uniform(-_BRIGHTNESS_MAX_DELTA, _BRIGHTNESS_MAX_DELTA),
           out=im)
    return colorspace


def augment_contrast(im, in_colorspace, rng):
    colorspace = _ensure_rgb(im, in_colorspace)
    # Scale about mid-gray as three in-place ufuncs, preserving the
    # reference's per-op rounding order (subtract, then scale, then add).
    np.subtract(im, 0.5, out=im)
    np.multiply(im, rng.uniform(*_CONTRAST_RANGE), out=im)
    np.add(im, 0.5, out=im)
    return colorspace


def augment_hue(im, in_colorspace, rng):
    colorspace = _ensure_hsv(im, in_colorspace)
    hue = im[..., 0]
    np.add(hue, rng.uniform(-_HUE_MAX_DELTA_DEG, _HUE_MAX_DELTA_DEG), out=hue)
    # Wrap once into [0, 360]; strict comparisons (exactly 360.0 stays put)
    # match the reference's masked add/subtract.
    np.add(hue, 360.0, out=hue, where=hue < 0.0)
    np.subtract(hue, 360.0, out=hue, where=hue > 360.0)
    return colorspace


def augment_saturation(im, in_colorspace, rng):
    colorspace = _ensure_hsv(im, in_colorspace)
    sat = im[..., 1]
    np.multiply(sat, rng.uniform(*_SATURATION_RANGE), out=sat)
    np.copyto(sat, 1.0, where=sat > 1.0)
    return colorspace


def augment_color(im: np.ndarray, rng: np.random.Generator,
                  out_dtype=None) -> np.ndarray:
    if out_dtype is None:
        out_dtype = im.dtype
    if im.dtype == np.uint8:
        im = im.astype(np.float32) / 255.0

    fns = [augment_brightness, augment_contrast, augment_hue,
           augment_saturation]
    rng.shuffle(fns)
    colorspace = 'rgb'
    for fn in fns:
        colorspace = fn(im, colorspace, rng)
    colorspace = _ensure_rgb(im, colorspace)
    np.clip(im, 0, 1, out=im)

    if out_dtype == np.uint8:
        return (im * 255).astype(np.uint8)
    return im.astype(out_dtype)
