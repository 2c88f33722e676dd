"""Adaptive temporal pose subsampling for dataset preparation.

Video datasets repeat near-identical poses frame after frame; these samplers
keep a frame only when the pose moved by at least `thresh` (mm) since the
last KEPT frame, so training sets stay diverse without fixed-rate dropping.
Equivalents of `metrabs_tf/util3d.py:46-155` (AdaptivePoseSampler,
AdaptivePoseSampler2, RingBufferArray).
"""

from __future__ import annotations

import warnings

import numpy as np


def are_joints_valid(coords: np.ndarray) -> np.ndarray:
    """Per-joint validity: finite in every coordinate (`util3d.py:172-173`)."""
    return np.logical_not(np.any(np.isnan(coords), axis=-1))


class AdaptivePoseSampler:
    """Keeps a pose when any joint moved >= thresh vs the last kept pose
    (`util3d.py:46-86`).

    check_validity: a joint turning newly-valid always keeps the frame.
    assume_nan_unchanged: NaN joints inherit the last kept value instead of
    counting as movement (useful for partially-tracked sequences).
    """

    def __init__(self, thresh: float, check_validity: bool = False,
                 assume_nan_unchanged: bool = False):
        self.thresh = thresh
        self.check_validity = check_validity
        self.assume_nan_unchanged = assume_nan_unchanged
        self.prev_pose = None

    def should_skip(self, pose) -> bool:
        pose = np.asarray(pose, np.float32)
        if self.prev_pose is None:
            self.prev_pose = pose.copy()
            return not np.any(are_joints_valid(pose))

        sel = slice(None)
        if self.check_validity:
            valid_now = are_joints_valid(pose)
            if np.any(valid_now & ~are_joints_valid(self.prev_pose)):
                self._update(pose)
                return False
            sel = valid_now

        change = np.linalg.norm(pose[sel] - self.prev_pose[sel], axis=-1)
        if self.assume_nan_unchanged:
            moved = np.any(change >= self.thresh)  # NaN compares False: skip
        else:
            moved = not np.all(change < self.thresh)  # NaN -> moved
        if moved:
            self._update(pose)
            return False
        return True

    def _update(self, pose):
        if self.assume_nan_unchanged:
            keep = np.isnan(pose)
            self.prev_pose[~keep] = pose[~keep]
        else:
            self.prev_pose[:] = pose


class RingBufferArray:
    """Fixed-capacity FIFO of arrays, NaN-padded until full
    (`util3d.py:132-155`). With copy_last_if_nan, NaN entries of a new item
    inherit the previous item's values."""

    def __init__(self, buffer_size: int, copy_last_if_nan: bool = False):
        self.buffer_size = buffer_size
        self.copy_last_if_nan = copy_last_if_nan
        self.array = None
        self.i_buf = 0

    def add(self, item: np.ndarray):
        if self.array is None:
            self.array = np.full((self.buffer_size, *item.shape), np.nan,
                                 np.float32)
        if self.copy_last_if_nan:
            self.array[self.i_buf] = self.last_item()
            finite = ~np.isnan(item)
            self.array[self.i_buf][finite] = item[finite]
        else:
            self.array[self.i_buf] = item
        self.i_buf = (self.i_buf + 1) % self.buffer_size

    def last_item(self) -> np.ndarray:
        return self.array[(self.i_buf - 1) % self.buffer_size]


class AdaptivePoseSampler2:
    """Ring-buffer variant (`util3d.py:89-129`): a frame is kept only when it
    moved >= thresh vs EVERY buffered kept pose (movement = the joint that
    moved most; buffer distance = the buffered pose it moved least from).
    buffer_size=1 approximates AdaptivePoseSampler with NaN-robust
    reductions."""

    def __init__(self, thresh: float, check_validity: bool = False,
                 assume_nan_unchanged: bool = False, buffer_size: int = 1):
        self.thresh = thresh
        self.check_validity = check_validity
        self.assume_nan_unchanged = assume_nan_unchanged
        self.prev_poses = RingBufferArray(
            buffer_size, copy_last_if_nan=assume_nan_unchanged)

    def should_skip(self, pose) -> bool:
        pose = np.asarray(pose, np.float32)
        if self.prev_poses.array is None:
            self.prev_poses.add(pose)
            return not np.any(are_joints_valid(pose))

        sel = slice(None)
        if self.check_validity:
            valid_now = are_joints_valid(pose)
            if np.any(valid_now & ~are_joints_valid(self.prev_poses.last_item())):
                self.prev_poses.add(pose)
                return False
            sel = valid_now

        change = np.linalg.norm(
            pose[sel] - self.prev_poses.array[:, sel], axis=-1)  # [buf, J']
        if self.assume_nan_unchanged:
            if change.size == 0:
                moved = False
            else:
                with np.errstate(invalid='ignore'), warnings.catch_warnings():
                    warnings.filterwarnings(
                        'ignore', 'All-NaN slice encountered')
                    moved = bool(
                        np.nanmin(np.nanmax(change, axis=1), axis=0)
                        >= self.thresh)
        else:
            moved = not np.any(np.all(change < self.thresh, axis=1), axis=0)
        if moved:
            self.prev_poses.add(pose)
            return False
        return True
