"""Binary-mask utilities of `metrabs_tpu/data/masks.py`: morphology,
connected components, rasterisation, RLE resizing and mask IoU, numpy only
(OpenCV's operations through `data.cvfree`, with its numbers).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from metrabs_tpu_torch.data import cvfree
from metrabs_tpu_torch.utils import rlemask


def get_structuring_element(shape: int, ksize, anchor=None) -> np.ndarray:
    """The elliptic structuring element (`cv2.MORPH_ELLIPSE`) of int-or-tuple
    kernel size, anchored at its centre; other shapes and anchors raise."""
    if shape != cvfree.MORPH_ELLIPSE or anchor is not None:
        raise NotImplementedError('only centred elliptic structuring elements')
    return cvfree.ellipse_kernel(ksize)


def erode(mask: np.ndarray, kernel_size, iterations: int = 1) -> np.ndarray:
    """Elliptical-kernel erosion; bool masks round-trip through uint8."""
    if mask.dtype == bool:
        return erode(mask.astype(np.uint8), kernel_size, iterations) > 0
    return cvfree.erode(mask, cvfree.ellipse_kernel(kernel_size), iterations)


def dilate(mask: np.ndarray, kernel_size, iterations: int = 1) -> np.ndarray:
    """Elliptical-kernel dilation; bool masks round-trip through uint8."""
    if mask.dtype == bool:
        return dilate(mask.astype(np.uint8), kernel_size, iterations) > 0
    return cvfree.dilate(mask, cvfree.ellipse_kernel(kernel_size), iterations)


def outline(mask: np.ndarray, d1: int = 1, d2: int = 3) -> np.ndarray:
    """Ring just OUTSIDE the mask: dilate(d2) - dilate(d1); bool masks
    round-trip through uint8."""
    if mask.dtype == bool:
        return outline(mask.astype(np.uint8), d1, d2).astype(bool)
    return dilate(mask, d2) - dilate(mask, d1)


def get_inline(mask: np.ndarray, d1: int = 1, d2: int = 3) -> np.ndarray:
    """Ring just INSIDE the mask: erode(d1) - erode(d2); bool masks
    round-trip through uint8."""
    if mask.dtype == bool:
        return get_inline(mask.astype(np.uint8), d1, d2).astype(bool)
    return erode(mask, d1) - erode(mask, d2)


def largest_connected_component(
        mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(largest-component mask, its [x, y, w, h] box); all-empty input
    returns (input, zero box). 8-connected: the JAX package passes 4 and
    CV_32S to `cv2.connectedComponentsWithStats` positionally, where they
    fill its output slots, so OpenCV runs at its default connectivity, 8."""
    mask = mask.astype(np.uint8)
    _, labels, stats, _ = cvfree.connected_components_with_stats(mask, 8)
    areas = stats[1:, -1]  # row 0 is background
    if len(areas) < 1:
        return mask, np.array([0, 0, 0, 0])
    largest = 1 + int(np.argmax(areas))
    return np.uint8(labels == largest), np.array(stats[largest, :4])


def masks_to_label_map(masks: Sequence[np.ndarray],
                       imshape=None) -> np.ndarray:
    """Stack of [N, h, w] binary masks -> single [h, w] uint8 label map with
    instance ids 1..N, later instances overwriting earlier ones. An empty
    sequence needs `imshape` (h, w)."""
    masks = np.asarray(masks)
    if masks.size == 0 and masks.ndim != 3:
        if imshape is None:
            raise ValueError(
                'masks_to_label_map with zero masks needs imshape=(h, w)')
        return np.zeros(tuple(imshape[:2]), np.uint8)
    label_map = np.zeros(masks.shape[1:3], np.uint8)
    for i, mask in enumerate(masks):
        label_map[mask > 0.5] = i + 1
    return label_map


def fill_polygon(img: np.ndarray, pts: np.ndarray, color) -> None:
    """In-place filled polygon from float vertex coords."""
    pts = np.round(np.asarray(pts).reshape((-1, 1, 2))).astype(np.int32)
    cvfree.fill_poly(img, [pts], color)


def mask_iou(mask1: np.ndarray, mask2: np.ndarray) -> float:
    """IoU of two binary masks; an empty union gives 0, not NaN."""
    m1 = np.asarray(mask1).astype(bool)
    m2 = np.asarray(mask2).astype(bool)
    union = np.count_nonzero(m1 | m2)
    if union == 0:
        return 0.0
    return float(np.count_nonzero(m1 & m2) / union)


def resize_mask(mask_encoded, new_imshape) -> dict:
    """RLE-encoded mask resized to a new image shape, re-encoded: decode ->
    x255 -> bilinear resize -> >127 threshold -> encode."""
    mask = rlemask.decode(mask_encoded) * 255
    mask = cvfree.resize(mask, (new_imshape[1], new_imshape[0]))
    return rlemask.encode((mask > 127).astype(np.uint8))


def draw_mask(img: np.ndarray, mask: np.ndarray, mask_color,
              draw_outline: bool = True) -> None:
    """In-place 30% color overlay of `mask` onto `img`, optionally with a
    solid inner outline."""
    mask_color = np.asarray(mask_color, np.float64)
    region = mask > 0
    img[region] = np.clip(
        mask_color * 0.3 + img[region].astype(np.float64) * 0.7,
        0, 255).astype(np.uint8)
    if draw_outline:
        ring = get_inline(region, 1, 5)
        img[ring.astype(bool)] = mask_color.astype(np.uint8)
