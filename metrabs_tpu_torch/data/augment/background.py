"""Background replacement augmentation
(`metrabs_tpu/data/augment/background.py`, with `data.cvfree` and the port's
`imread`: the pool's .jpg, .jpeg and .png files are read as cv2 reads them,
whatever their encoding: JPEG, PNG, WebP, TIFF, BMP, PNM/PAM/PFM, GIF, Sun
raster or Radiance HDR).

Replaces the image background (outside the person's foreground mask) with a
randomly zoomed/shifted crop of a distractor image. The reference uses the
INRIA Holidays non-person photos; the image pool directory is a configurable
asset, with a procedural texture fallback so training runs without the
download."""

from __future__ import annotations

import functools
import glob
import os
from typing import List, Optional

import numpy as np

from metrabs_tpu_torch.data import cvfree
from metrabs_tpu_torch.data.boxes import random_uniform_disc
from metrabs_tpu_torch.data.camera import Camera, reproject_image
from metrabs_tpu_torch.data.improc import imread


@functools.lru_cache()
def get_background_paths(background_dir: Optional[str] = None) -> tuple:
    if background_dir and os.path.isdir(background_dir):
        paths = sorted(
            p for ext in ('jpg', 'jpeg', 'png')
            for p in glob.glob(os.path.join(background_dir, f'*.{ext}')))
        return tuple(paths)
    return ()


def _synthetic_background(rng: np.random.Generator, shape) -> np.ndarray:
    """Smooth random gradient texture fallback."""
    small = rng.uniform(0, 1, size=(8, 8, 3)).astype(np.float32)
    return cvfree.resize(small, (shape[1], shape[0]), interpolation=cvfree.INTER_CUBIC)


def blend_image(im_background: np.ndarray, im_foreground: np.ndarray,
                fgmask: np.ndarray) -> np.ndarray:
    if fgmask.ndim == 2:
        fgmask = fgmask[..., None]
    fg = im_foreground.astype(np.float32)
    bg = im_background.astype(np.float32)
    out = fg * fgmask + bg * (1 - fgmask)
    return out.astype(im_foreground.dtype)


def augment_background(
        im: np.ndarray, fgmask: np.ndarray, rng: np.random.Generator,
        background_dir: Optional[str] = None,
        antialias_factor: int = 1, interp=cvfree.INTER_LINEAR) -> np.ndarray:
    paths = get_background_paths(background_dir)
    if paths:
        path = paths[int(rng.integers(len(paths)))]
        background_im = imread(path)
        if np.issubdtype(im.dtype, np.floating):
            background_im = background_im.astype(np.float32) / 255.0
    else:
        background_im = _synthetic_background(rng, im.shape)
        if np.issubdtype(im.dtype, np.integer):
            background_im = (background_im * 255).astype(im.dtype)

    cam = Camera(intrinsic_matrix=np.array(
        [[1, 0, background_im.shape[1] / 2],
         [0, 1, background_im.shape[0] / 2], [0, 0, 1]], np.float32))
    cam_new = cam.copy()
    zoom_aug_factor = rng.uniform(1.2, 1.5)
    cam_new.zoom(zoom_aug_factor
                 * np.max(np.asarray(im.shape[:2])
                          / np.asarray(background_im.shape[:2])))
    cam_new.center_principal_point(im.shape)
    cam_new.shift_image(random_uniform_disc(rng) * im.shape[0] * 0.1)

    warped_bg = reproject_image(
        background_im, cam, cam_new, im.shape[:2], interp=interp,
        antialias_factor=antialias_factor)
    return blend_image(warped_bg, im, fgmask)
