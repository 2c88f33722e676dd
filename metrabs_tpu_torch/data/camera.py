"""Host-side camera model of the data pipeline (`metrabs_tpu/data/camera.py`,
copied; its image warp goes through `data.cvfree` instead of OpenCV, with
OpenCV's numbers). Device-side geometry lives in `metrabs_tpu_torch.ops`.

Conventions: world/camera points are row vectors in millimeters; R maps
world to camera (camera = (world - t) @ R.T); intrinsics are 3x3 with pixel
units; distortion follows OpenCV coefficient ordering.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import numpy as np

from metrabs_tpu_torch.data import cvfree


def _unit(v):
    return v / np.linalg.norm(v)


class Camera:
    def __init__(self, optical_center=None, rot_world_to_cam=None,
                 intrinsic_matrix=np.eye(3), distortion_coeffs=None,
                 world_up=(0, 0, 1), extrinsic_matrix=None):
        if optical_center is not None and extrinsic_matrix is not None:
            raise ValueError('Give either optical_center or extrinsic_matrix')
        if extrinsic_matrix is not None:
            self.R = np.asarray(extrinsic_matrix, np.float32)[:3, :3].copy()
            self.t = (-self.R.T @ np.asarray(
                extrinsic_matrix, np.float32)[:3, 3]).copy()
        else:
            self.R = (np.asarray(rot_world_to_cam, np.float32).copy()
                      if rot_world_to_cam is not None else np.eye(3, dtype=np.float32))
            self.t = (np.asarray(optical_center, np.float32).copy()
                      if optical_center is not None else np.zeros(3, np.float32))
        self.intrinsic_matrix = np.asarray(intrinsic_matrix, np.float32).copy()
        self.distortion_coeffs = (
            np.asarray(distortion_coeffs, np.float32).copy()
            if distortion_coeffs is not None else np.zeros(5, np.float32))
        self.world_up = np.asarray(world_up, np.float32)

    # --- factory ---
    @staticmethod
    def from_fov(fov_degrees: float, imshape: Tuple[int, int],
                 world_up=(0, -1, 0)) -> 'Camera':
        f = max(imshape) / (np.tan(np.deg2rad(fov_degrees) / 2) * 2)
        intr = np.array([[f, 0, imshape[1] / 2],
                         [0, f, imshape[0] / 2],
                         [0, 0, 1]], np.float32)
        return Camera(intrinsic_matrix=intr, world_up=world_up)

    def copy(self) -> 'Camera':
        return copy.deepcopy(self)

    @property
    def extrinsic_matrix(self) -> np.ndarray:
        ext = np.eye(4, dtype=np.float32)
        ext[:3, :3] = self.R
        ext[:3, 3] = -self.R @ self.t
        return ext

    def has_distortion(self) -> bool:
        return bool(np.any(self.distortion_coeffs != 0))

    # --- point transforms ---
    def world_to_camera(self, points) -> np.ndarray:
        points = np.asarray(points, np.float32)
        return (points - self.t) @ self.R.T

    def camera_to_world(self, points) -> np.ndarray:
        points = np.asarray(points, np.float32)
        return points @ self.R + self.t

    def camera_to_image(self, points) -> np.ndarray:
        points = np.asarray(points, np.float32)
        projected = points[..., :2] / points[..., 2:]
        if self.has_distortion():
            projected = distort_points_np(projected, self.distortion_coeffs)
        return (projected @ self.intrinsic_matrix[:2, :2].T
                + self.intrinsic_matrix[:2, 2])

    def image_to_camera(self, points, depth=1.0) -> np.ndarray:
        points = np.asarray(points, np.float32)
        normalized = ((points - self.intrinsic_matrix[:2, 2])
                      @ np.linalg.inv(self.intrinsic_matrix[:2, :2]).T)
        if self.has_distortion():
            normalized = undistort_points_np(normalized, self.distortion_coeffs)
        return np.concatenate(
            [normalized, np.ones_like(normalized[..., :1])], axis=-1) * depth

    def world_to_image(self, points) -> np.ndarray:
        return self.camera_to_image(self.world_to_camera(points))

    def image_to_world(self, points, camera_depth=1.0) -> np.ndarray:
        return self.camera_to_world(self.image_to_camera(points, camera_depth))

    # --- in-place camera adjustments (cameralib API) ---
    def shift_image(self, offset):
        self.intrinsic_matrix[:2, 2] += np.asarray(offset, np.float32)

    def scale_output(self, factor):
        self.intrinsic_matrix[:2] *= factor

    def zoom(self, factor):
        """Scales focal length, keeping the principal point."""
        self.intrinsic_matrix[:2, :2] *= factor

    def square_pixels(self):
        fx, fy = self.intrinsic_matrix[0, 0], self.intrinsic_matrix[1, 1]
        f = (fx + fy) / 2
        mult = np.diag([f / fx, f / fy, 1.0]).astype(np.float32)
        self.intrinsic_matrix = mult @ self.intrinsic_matrix

    def center_principal_point(self, imshape):
        self.intrinsic_matrix[:2, 2] = [imshape[1] / 2, imshape[0] / 2]

    def undistort(self):
        self.distortion_coeffs = np.zeros(5, np.float32)

    def horizontal_flip(self):
        self.R[0] *= -1

    def turn_towards(self, target_image_point=None, target_world_point=None):
        """Rotates the camera so the optical axis passes through the target
        (the perspective-correct crop construction, `data_loading.py:79-86`)."""
        if target_world_point is None:
            target_world_point = self.image_to_world(target_image_point)
        new_z = _unit(target_world_point - self.t)
        new_x = _unit(np.cross(new_z, self.world_up))
        new_y = np.cross(new_z, new_x)
        self.R = np.stack([new_x, new_y, new_z]).astype(np.float32)

    def rotate(self, yaw=0.0, pitch=0.0, roll=0.0):
        """Rotates the camera about its own axes (roll = about the optical
        axis). Matches cameralib's `rotate` (euler2mat(-yaw, -pitch, -roll,
        'ryxz').T = Rz(roll) @ Rx(pitch) @ Ry(yaw) with standard ACTIVE
        rotation matrices for every axis — a transposed yaw/pitch matrix
        would pan/tilt in the opposite direction from roll)."""
        def rot(angle, axis):
            c, s = np.cos(angle), np.sin(angle)
            if axis == 'z':
                return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            if axis == 'y':
                return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        cam_rot = rot(roll, 'z') @ rot(pitch, 'x') @ rot(yaw, 'y')
        self.R = cam_rot @ self.R

    def shift_to_center(self, desired_center_image_point, imshape):
        self.intrinsic_matrix[:2, 2] += (
            np.array([imshape[1] / 2, imshape[0] / 2], np.float32)
            - np.asarray(desired_center_image_point, np.float32))

    def get_projection_matrix(self) -> np.ndarray:
        return self.intrinsic_matrix @ self.extrinsic_matrix[:3]

    def allclose(self, other: 'Camera') -> bool:
        return (np.allclose(self.intrinsic_matrix, other.intrinsic_matrix)
                and np.allclose(self.R, other.R) and np.allclose(self.t, other.t)
                and np.allclose(self.distortion_coeffs, other.distortion_coeffs))


def distort_points_np(points, d):
    d = np.pad(np.asarray(d, np.float32), (0, max(0, 12 - len(d))))[:12]
    x, y = points[..., 0], points[..., 1]
    r2 = x * x + y * y
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = d
    radial = ((1 + k1 * r2 + k2 * r2**2 + k3 * r2**3)
              / (1 + k4 * r2 + k5 * r2**2 + k6 * r2**3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x) + s1 * r2 + s2 * r2**2
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y + s3 * r2 + s4 * r2**2
    return np.stack([xd, yd], axis=-1)


def undistort_points_np(points, d, num_iters=5):
    undist = points
    for _ in range(num_iters):
        # fixed-point iteration matching the device-side inverse
        dist = distort_points_np(undist, d)
        undist = undist - (dist - points)
    return undist


def reproject_image_points(points, old_camera: Camera,
                           new_camera: Camera) -> np.ndarray:
    """Maps image points from one camera's pixels to another's (same optical
    center)."""
    points = np.asarray(points, np.float32)
    single = points.ndim == 1
    if single:
        points = points[None]
    rays_old = old_camera.image_to_camera(points)
    rays_new = (rays_old @ old_camera.R) @ new_camera.R.T
    out = new_camera.camera_to_image(rays_new)
    return out[0] if single else out


def reproject_image(
        image: np.ndarray, old_camera: Camera, new_camera: Camera,
        output_imshape: Tuple[int, int], border_mode=cvfree.BORDER_CONSTANT,
        border_value=0, interp=cvfree.INTER_LINEAR,
        antialias_factor: int = 1) -> np.ndarray:
    """Warps `image` from old_camera's view to new_camera's view (both share
    the optical center) — the CPU analogue of the device warp used by the
    training data pipeline and background augmentation. Only the constant
    border is supported."""
    if border_mode != cvfree.BORDER_CONSTANT:
        raise NotImplementedError(f'border mode {border_mode}')
    if antialias_factor > 1:
        new_camera = new_camera.copy()
        new_camera.scale_output(antialias_factor)
        output_imshape = (output_imshape[0] * antialias_factor,
                          output_imshape[1] * antialias_factor)
    out_h, out_w = output_imshape
    xs, ys = np.meshgrid(
        np.arange(out_w, dtype=np.float32), np.arange(out_h, dtype=np.float32))
    grid = np.stack([xs, ys], axis=-1).reshape(-1, 2)
    # New image pixel -> camera ray (new) -> rotate into old cam -> project.
    rays_new = new_camera.image_to_camera(grid)
    rays_world = rays_new @ new_camera.R
    rays_old = rays_world @ old_camera.R.T
    coords_old = old_camera.camera_to_image(rays_old)
    map_x = coords_old[:, 0].reshape(out_h, out_w)
    map_y = coords_old[:, 1].reshape(out_h, out_w)
    warped = cvfree.remap(image, map_x, map_y, interp, border_value=border_value)
    if antialias_factor > 1:
        warped = cvfree.resize(
            warped, (out_w // antialias_factor, out_h // antialias_factor),
            interpolation=cvfree.INTER_AREA)
    return warped
