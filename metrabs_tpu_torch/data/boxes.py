"""Bounding-box utilities (`metrabs_tpu/data/boxes.py`, copied). Boxes are
(x, y, w, h) numpy arrays in pixels."""

from __future__ import annotations

import numpy as np


def center(box):
    box = np.asarray(box, np.float32)
    return box[:2] + box[2:4] / 2


def expand_to_square(box):
    box = np.asarray(box, np.float32)
    c = center(box)
    side = np.max(box[2:4])
    return np.array([c[0] - side / 2, c[1] - side / 2, side, side], np.float32)


def intersection(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    start = np.maximum(a[:2], b[:2])
    end = np.minimum(a[:2] + a[2:4], b[:2] + b[2:4])
    wh = np.maximum(end - start, 0)
    return np.concatenate([start, wh])


def area(box):
    return float(box[2] * box[3])


def full_box(imshape):
    return np.array([0, 0, imshape[1], imshape[0]], np.float32)


def random_uniform_disc(rng: np.random.Generator) -> np.ndarray:
    """Uniform sample from the unit disc (shift augmentation direction)."""
    angle = rng.uniform(-np.pi, np.pi)
    radius = np.sqrt(rng.uniform(0, 1))
    return radius * np.array([np.cos(angle), np.sin(angle)])


def random_partial_subbox(box, rng: np.random.Generator):
    """Random sub-box covering 45-75% of the side length, as used for
    partial-visibility augmentation (boxlib semantics via
    `data_loading.py:53-57`)."""
    box = np.asarray(box, np.float32)
    scale = rng.uniform(0.45, 0.75)
    new_side = box[2:4] * scale
    offset = rng.uniform(0, 1, size=2) * (box[2:4] - new_side)
    return np.concatenate([box[:2] + offset, new_side]).astype(np.float32)
