"""Occlusion augmentation (`metrabs_tpu/data/augment/occlusion.py`, with the
polygon fills of `data.cvfree`): object pasting and random erasing.

The object-occlusion variant pastes alpha-masked occluder cutouts (PASCAL-VOC
segments in the reference, `voc_loader.py`); the asset directory is
configurable and the loader falls back to procedurally generated occluder
blobs when no VOC assets are present, so training runs without the dataset
download. Random erasing follows Zhong et al. (arXiv:1708.04896) with the
reference's area/aspect ranges.
"""

from __future__ import annotations

import functools
import glob
import os
import pickle
from typing import List, Optional, Tuple

import numpy as np

from metrabs_tpu_torch.data import cvfree
from metrabs_tpu_torch.data.augment import color as coloraug
from metrabs_tpu_torch.data.improc import resize_by_factor


def random_erase(im: np.ndarray, rng: np.random.Generator,
                 area_factor_low: float = 0.0, area_factor_high: float = 1 / 3,
                 aspect_low: float = 0.3, aspect_high: float = 1.0 / 0.3,
                 occlude_aug_scale: float = 1.0, inplace: bool = True) -> np.ndarray:
    """Fills a random rectangle with uniform noise (`appearance.py:62-78`)."""
    side = im.shape[0]
    image_area = side ** 2
    while True:
        occluder_area = (rng.uniform(area_factor_low, area_factor_high)
                         * image_area * occlude_aug_scale)
        aspect_ratio = rng.uniform(aspect_low, aspect_high)
        height = (occluder_area * aspect_ratio) ** 0.5
        width = (occluder_area / aspect_ratio) ** 0.5
        pt1 = rng.uniform(0, side, size=2)
        pt2 = pt1 + np.array([width, height])
        if np.all(pt2 < side):
            pt1, pt2 = pt1.astype(int), pt2.astype(int)
            if not inplace:
                im = im.copy()
            if np.issubdtype(im.dtype, np.integer):
                noise = rng.integers(0, 255, size=(pt2[1] - pt1[1], pt2[0] - pt1[0], 3),
                                     dtype=im.dtype)
            else:
                noise = rng.uniform(0, 1, size=(pt2[1] - pt1[1], pt2[0] - pt1[0], 3)
                                    ).astype(im.dtype)
            im[pt1[1]:pt2[1], pt1[0]:pt2[0]] = noise
            return im


def paste_over(im_src: np.ndarray, im_dst: np.ndarray, alpha: np.ndarray,
               center: np.ndarray, inplace: bool = True) -> np.ndarray:
    """Alpha-composites im_src onto im_dst centered at `center`
    (`improc.py:157-207` semantics, plain numpy instead of numba)."""
    if not inplace:
        im_dst = im_dst.copy()
    width_height_src = np.array([im_src.shape[1], im_src.shape[0]])
    width_height_dst = np.array([im_dst.shape[1], im_dst.shape[0]])
    center = np.round(np.asarray(center)).astype(np.int32)
    raw_start_dst = center - width_height_src // 2
    raw_end_dst = raw_start_dst + width_height_src
    start_dst = np.clip(raw_start_dst, 0, width_height_dst)
    end_dst = np.clip(raw_end_dst, 0, width_height_dst)
    start_src = start_dst - raw_start_dst
    end_src = start_src + (end_dst - start_dst)
    if np.any(end_dst - start_dst <= 0):
        return im_dst
    region_src = im_src[start_src[1]:end_src[1], start_src[0]:end_src[0]]
    region_alpha = alpha[start_src[1]:end_src[1], start_src[0]:end_src[0]]
    if region_alpha.ndim == 2:
        region_alpha = region_alpha[..., None]
    region_dst = im_dst[start_dst[1]:end_dst[1], start_dst[0]:end_dst[0]]
    blended = (region_src.astype(np.float32) * region_alpha
               + region_dst.astype(np.float32) * (1 - region_alpha))
    im_dst[start_dst[1]:end_dst[1], start_dst[0]:end_dst[0]] = \
        blended.astype(im_dst.dtype)
    return im_dst


def _make_synthetic_occluder(rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural fallback occluder: a random polygonal color blob."""
    side = int(rng.integers(40, 120))
    img = np.zeros((side, side, 3), np.float32)
    mask = np.zeros((side, side), np.float32)
    n_pts = int(rng.integers(4, 9))
    pts = rng.uniform(side * 0.1, side * 0.9, size=(n_pts, 2)).astype(np.int32)
    hull = cvfree.convex_hull(pts)
    colors = rng.uniform(0, 1, size=3)
    cvfree.fill_convex_poly(img, hull, colors.astype(np.float32))
    cvfree.fill_convex_poly(mask, hull, 1.0)
    noise = rng.uniform(0.7, 1.3, size=(side, side, 1)).astype(np.float32)
    return np.clip(img * noise, 0, 1), mask


@functools.lru_cache()
def load_occluders(occluder_dir: Optional[str] = None):
    """Loads VOC occluder cutouts (pickled (image, alpha) pairs as produced by
    the reference's `voc_loader.py`), or builds synthetic ones."""
    if occluder_dir and os.path.isdir(occluder_dir):
        paths = sorted(glob.glob(os.path.join(occluder_dir, '*.pkl')))
        if paths:
            occluders = []
            for p in paths:
                with open(p, 'rb') as f:
                    occluders.extend(pickle.load(f))
            return occluders
    rng = np.random.default_rng(12345)
    return [_make_synthetic_occluder(rng) for _ in range(200)]


def object_occlude(im: np.ndarray, rng: np.random.Generator,
                   occlude_aug_scale: float = 1.0,
                   occluder_dir: Optional[str] = None,
                   inplace: bool = True) -> np.ndarray:
    """Pastes 1-6 occluders (`appearance.py:40-59`; Sarandi et al.
    arXiv:1808.09316)."""
    factor = im.shape[0] / 256
    count = int(rng.integers(1, 7))
    occluders = load_occluders(occluder_dir)
    for _ in range(count):
        occluder, occ_mask = occluders[int(rng.integers(len(occluders)))]
        rescale = rng.uniform(0.2, 1.0) * factor * occlude_aug_scale
        occ_mask_r = resize_by_factor(occ_mask, rescale)
        occluder_r = resize_by_factor(occluder, rescale)
        if np.issubdtype(im.dtype, np.integer) and occluder_r.dtype != im.dtype:
            occluder_r = (np.clip(occluder_r, 0, 1) * 255).astype(im.dtype)
        center = rng.uniform(0, im.shape[0], size=2)
        im = paste_over(occluder_r, im, alpha=occ_mask_r, center=center,
                        inplace=inplace)
    return im


def augment_appearance(
        im: np.ndarray, is_train: bool, occlude_prob: float,
        rng: np.random.Generator, *, color_aug: bool = True,
        occlude_aug_scale: float = 1.0,
        occluder_dir: Optional[str] = None) -> np.ndarray:
    """Combined occlusion+color augmentation with the reference's ordering
    rules (`appearance.py:10-37`): object occlusion goes BEFORE color jitter
    (so the occluder blends in), random erasing AFTER (to keep the erased
    block uniform)."""
    occlusion_rng = np.random.default_rng(rng.integers(np.iinfo(np.int64).max))
    color_rng = np.random.default_rng(rng.integers(np.iinfo(np.int64).max))
    if not is_train:
        return im
    occlude_type = (str(occlusion_rng.choice(['objects', 'random-erase']))
                    if occlude_prob > 0 else None)
    if occlude_type == 'objects':
        if occlusion_rng.uniform(0.0, 1.0) < occlude_prob:
            im = object_occlude(im, occlusion_rng,
                                occlude_aug_scale=occlude_aug_scale,
                                occluder_dir=occluder_dir, inplace=True)
        if color_aug:
            im = coloraug.augment_color(im, color_rng)
    elif occlude_type == 'random-erase':
        if color_aug:
            im = coloraug.augment_color(im, color_rng)
        if occlusion_rng.uniform(0.0, 1.0) < occlude_prob:
            im = random_erase(im, occlusion_rng,
                              occlude_aug_scale=occlude_aug_scale, inplace=True)
    elif color_aug:
        im = coloraug.augment_color(im, color_rng)
    return im
