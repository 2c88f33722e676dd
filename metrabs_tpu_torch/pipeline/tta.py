"""Test-time augmentation parameter schedules (`metrabs_tpu/pipeline/tta.py`,
copied so that the port imports nothing of the JAX package).

Reproduces the reference's TTA setup exactly, including the `tfu.linspace`
midpoint quirk: with num=1 and endpoint=True the result is the midpoint of
the range, so num_aug=1 means gamma=0.8, angle=0, scale=1.05, no flip, NOT
"no augmentation". Plain numpy on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from metrabs_tpu_torch.config import AugConfig


def linspace_midpoint(start: float, stop: float, num: int, endpoint: bool = True) -> np.ndarray:
    """`tfu.linspace` semantics."""
    if endpoint:
        if num == 1:
            return np.array([(start + stop) / 2], np.float32)
        return np.linspace(start, stop, num, dtype=np.float32)
    if num > 1:
        step = (stop - start) / num
        return np.linspace(start, stop - step, num, dtype=np.float32)
    return np.linspace(start, stop, num, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class TTAParams:
    gammas: np.ndarray        # [num_aug] brightness gammas in [0.6, 1.0]
    angles: np.ndarray        # [num_aug] in-plane rotation angles (radians)
    scales: np.ndarray        # [num_aug] zoom factors
    should_flip: np.ndarray   # [num_aug] bool
    rotflip_mats: np.ndarray  # [num_aug, 3, 3] flip(+/-x) @ Rz(-angle)

    @property
    def num_aug(self) -> int:
        return len(self.gammas)


def make_tta_params(num_aug: int, aug_cfg: AugConfig = AugConfig()) -> TTAParams:
    gammas = linspace_midpoint(0.6, 1.0, num_aug)

    if aug_cfg.rot_aug_360_half:
        num_normal = num_aug // 2
        rng_normal = np.float32(np.deg2rad(aug_cfg.rot_aug_degrees))
        angles_normal = linspace_midpoint(-rng_normal, rng_normal, num_normal)
        num_360 = num_aug - num_normal
        rng_360 = np.float32(np.pi) * (1 - 1 / np.float32(num_360))
        angles_360 = linspace_midpoint(-rng_360, rng_360, num_360)
        angles = np.sort(np.concatenate([angles_normal, angles_360]))
    elif aug_cfg.rot_aug_360:
        rng_360 = np.float32(np.pi) * (1 - 1 / np.float32(num_aug))
        angles = linspace_midpoint(-rng_360, rng_360, num_aug)
    else:
        rng = np.float32(np.deg2rad(aug_cfg.rot_aug_degrees))
        angles = linspace_midpoint(-rng, rng, num_aug)

    scales = np.concatenate([
        linspace_midpoint(0.8, 1.0, num_aug // 2, endpoint=False),
        linspace_midpoint(1.0, 1.1, num_aug - num_aug // 2)]).astype(np.float32)

    should_flip = (np.arange(num_aug) - num_aug // 2) % 2 != 0

    flipmat = np.array([[-1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    maybe_flip = np.where(should_flip[:, None, None], flipmat, np.eye(3, dtype=np.float32))
    # Rz(-angle) with the reference's row-vector sign convention.
    sin, cos = np.sin(-angles), np.cos(-angles)
    _0, _1 = np.zeros_like(sin), np.ones_like(sin)
    rotmat = np.stack([
        np.stack([cos, -sin, _0], axis=-1),
        np.stack([sin, cos, _0], axis=-1),
        np.stack([_0, _0, _1], axis=-1)], axis=-2).astype(np.float32)
    rotflip = maybe_flip @ rotmat

    return TTAParams(
        gammas=gammas.astype(np.float32), angles=angles.astype(np.float32),
        scales=scales, should_flip=should_flip, rotflip_mats=rotflip.astype(np.float32))
