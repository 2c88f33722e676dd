"""Shared full-pipeline prediction loop of the per-benchmark drivers
(`metrabs_tpu/apps/predict_common.py`): frames are read in batches on a
thread pool (the JPEG decoder releases the GIL, so the threads decode in
parallel), `estimate_poses_batched` runs with one ground-truth box per frame
and the example's camera, and the world-space poses are collected on the
host.

A batch whose frames differ in size is split into one-frame sub-batches, as
in JAX. The estimator's outputs are CUDA tensors on the card: they are
copied to the host before they are concatenated.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

from metrabs_tpu_torch.data.improc import imread
from metrabs_tpu_torch.data.loading import Example3D


def to_host(x) -> np.ndarray:
    """A numpy copy of an estimator output, a CUDA or CPU tensor or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def predict_examples(
        estimator, examples: Sequence[Example3D], *, skeleton: str = '',
        num_aug: int = 1, antialias_factor: int = 2, batch_size: int = 16,
        internal_batch_size: int = 64, world_up=(0, -1, 0),
        n_io_threads: int = 8, progress: bool = True) -> np.ndarray:
    """Runs the full pipeline over examples with their ground-truth boxes;
    returns world-space poses [N, J_skeleton, 3]."""
    pool = ThreadPoolExecutor(n_io_threads)
    out: List[np.ndarray] = []
    n = len(examples)
    for start in range(0, n, batch_size):
        chunk = examples[start:start + batch_size]
        images = list(pool.map(lambda ex: imread(ex.image_path), chunk))
        shape0 = images[0].shape
        if any(im.shape != shape0 for im in images):
            for ex, im in zip(chunk, images):
                out.append(_predict_uniform(
                    estimator, [ex], [im], skeleton, num_aug,
                    antialias_factor, internal_batch_size, world_up))
        else:
            out.append(_predict_uniform(
                estimator, list(chunk), images, skeleton, num_aug,
                antialias_factor, internal_batch_size, world_up))
        if progress:
            print(f'\r{min(start + batch_size, n)}/{n}', end='', flush=True)
    if progress:
        print()
    pool.shutdown()
    return np.concatenate(out, axis=0)


def _predict_uniform(estimator, chunk, images, skeleton, num_aug,
                     antialias_factor, internal_batch_size, world_up):
    images_np = np.stack(images)
    boxes = np.stack([ex.bbox for ex in chunk])[:, None, :]  # [B, 1, 4]
    intr = np.stack([ex.camera.intrinsic_matrix for ex in chunk])
    ext = np.stack([ex.camera.extrinsic_matrix for ex in chunk])
    dist = np.stack([
        np.pad(np.asarray(ex.camera.distortion_coeffs, np.float32).reshape(-1),
               (0, 12))[:12] for ex in chunk])
    pred = estimator.estimate_poses_batched(
        images_np, boxes, intrinsic_matrix=intr, distortion_coeffs=dist,
        extrinsic_matrix=ext, world_up_vector=world_up, num_aug=num_aug,
        antialias_factor=antialias_factor,
        internal_batch_size=internal_batch_size, skeleton=skeleton)
    return to_host(pred['poses3d'])[:, 0]  # squeeze the single box
