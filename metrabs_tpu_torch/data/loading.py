"""Per-example training data preparation (`metrabs_tpu/data/loading.py`,
ported without OpenCV: the image warps, resizes and colour conversions go
through `data.cvfree`, with OpenCV's numbers; the geometry is the same numpy).

Each example goes through the geometry-aware crop construction: the camera is
turned towards the box center, undistorted, made square-pixeled, zoomed so
the reprojected box fills the crop, principal-point centered — then geometric
augmentation (shift/scale/rotation/flip), image reprojection, and
appearance augmentation. Outputs are numpy dicts that batch directly into the
train step's expected fields. Entirely host-side CPU work, run in the worker
pool of `pipeline.ParallelBatchLoader`.

`load_examples` reads the example pickles that the JAX package writes (lists
of its `Example3D` / `Example2D`, with its `Camera`) into this module's
classes, without the JAX package.
"""

from __future__ import annotations

import dataclasses
import pickle
import re
from typing import Dict, Optional

import numpy as np

from metrabs_tpu_torch.config import ModelConfig
from metrabs_tpu_torch.data import boxes as boxlib
from metrabs_tpu_torch.data import cvfree, improc
from metrabs_tpu_torch.data.augment import background as bgaug
from metrabs_tpu_torch.data.augment.occlusion import augment_appearance
from metrabs_tpu_torch.data.camera import Camera, reproject_image, reproject_image_points
from metrabs_tpu_torch.utils.joint_info import JointInfo


@dataclasses.dataclass
class Example3D:
    """A 3D-labeled example (posepile Pose3DExample equivalent)."""
    image_path: str
    camera: Camera
    bbox: np.ndarray                    # (x, y, w, h)
    world_coords: np.ndarray            # [J, 3] mm, NaN where unlabeled
    image: Optional[np.ndarray] = None  # preloaded RGB, else read from path
    mask: Optional[np.ndarray] = None   # foreground mask [H, W] in [0,1]
    univ_coords: Optional[np.ndarray] = None


@dataclasses.dataclass
class Example2D:
    image_path: str
    bbox: np.ndarray
    coords: np.ndarray                  # [J2, 2] image px, NaN where unlabeled
    image: Optional[np.ndarray] = None
    camera: Optional[Camera] = None
    mask: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """Augmentation hyperparameters (reference FLAGS defaults,
    `init.py:127-153`)."""
    geom_aug: bool = True
    test_aug: bool = False
    rot_aug_degrees: float = 20.0
    scale_aug_up: float = 25.0
    scale_aug_down: float = 25.0
    shift_aug: float = 10.0
    partial_visibility_prob: float = 0.0
    occlude_aug_prob: float = 0.5
    occlude_aug_prob_2d: float = 0.7
    occlude_aug_scale: float = 1.0
    background_aug_prob: float = 0.7
    color_aug: bool = True
    full_rot_aug_prob: float = 0.0
    antialias_train: int = 1
    antialias_test: int = 1
    # Separate train/test interpolation (`init.py:152-153`
    # image-interpolation-train/-test; 'nearest' can be faster for training).
    interpolation: int = cvfree.INTER_LINEAR
    interpolation_test: int = cvfree.INTER_LINEAR
    universal_skeleton: bool = False
    occluder_dir: Optional[str] = None
    background_dir: Optional[str] = None


def _new_rng(rng: np.random.Generator) -> np.random.Generator:
    return np.random.default_rng(rng.integers(np.iinfo(np.int64).max))


def _box_sidepoints(box: np.ndarray, center_point: np.ndarray) -> np.ndarray:
    """Midpoints of the box's short sides (`data_loading.py:66-77`)."""
    if box[2] < box[3]:
        delta = np.array([0, box[3] / 2])
    else:
        delta = np.array([box[2] / 2, 0])
    return center_point + np.stack([-delta, delta])


def load_and_transform3d(
        ex: Example3D, joint_info: JointInfo, is_train: bool,
        rng: np.random.Generator, cfg: ModelConfig,
        lcfg: LoadConfig = LoadConfig()) -> Dict[str, np.ndarray]:
    appearance_rng = _new_rng(rng)
    background_rng = _new_rng(rng)
    geom_rng = _new_rng(rng)
    partial_visi_rng = _new_rng(rng)

    output_side = cfg.proc_side
    output_imshape = (output_side, output_side)
    world_coords = ex.world_coords
    box = np.asarray(ex.bbox, np.float32)

    camera = ex.camera
    if 'sailvos' in ex.image_path.lower():
        # SAILVOS world coordinates reach kilometers; recenter on the camera
        # to keep float32 precision (`data_loading.py:32-39`).
        world_coords = world_coords - camera.t
        camera = camera.copy()
        camera.t[:] = 0

    # Partial visibility augmentation (`data_loading.py:53-57`).
    if ((is_train or lcfg.test_aug)
            and partial_visi_rng.random() < lcfg.partial_visibility_prob):
        box = boxlib.random_partial_subbox(
            boxlib.expand_to_square(box), partial_visi_rng)

    crop_side = np.max(box[2:4])
    center_point = boxlib.center(box)
    do_geom_aug = lcfg.geom_aug and (is_train or lcfg.test_aug)
    if do_geom_aug:
        center_point = center_point + (
            boxlib.random_uniform_disc(geom_rng) * lcfg.shift_aug / 100 * crop_side)

    sidepoints = _box_sidepoints(box, center_point)

    cam = camera.copy()
    cam.turn_towards(target_image_point=center_point)
    cam.undistort()
    cam.square_pixels()
    cam_sidepoints = reproject_image_points(sidepoints, camera, cam)
    crop_side = np.linalg.norm(cam_sidepoints[0] - cam_sidepoints[1])
    cam.zoom(output_side / crop_side)
    cam.center_principal_point(output_imshape)

    if do_geom_aug:
        s1 = lcfg.scale_aug_down / 100
        s2 = lcfg.scale_aug_up / 100
        cam.zoom(geom_rng.uniform(1 - s1, 1 + s2))
        r = (np.pi if lcfg.full_rot_aug_prob
             and geom_rng.random() < lcfg.full_rot_aug_prob
             else np.deg2rad(lcfg.rot_aug_degrees))
        cam.rotate(roll=geom_rng.uniform(-r, r))

    metric_world_coords = world_coords
    if lcfg.universal_skeleton and ex.univ_coords is not None:
        world_coords = ex.univ_coords

    if lcfg.geom_aug and is_train and geom_rng.random() < 0.5:
        cam.horizontal_flip()
        camcoords = cam.world_to_camera(world_coords)[joint_info.mirror_mapping]
        metric_world_coords = metric_world_coords[joint_info.mirror_mapping]
    else:
        camcoords = cam.world_to_camera(world_coords)
    imcoords = cam.world_to_image(metric_world_coords)

    origsize_im = ex.image if ex.image is not None else improc.imread(ex.image_path)
    antialias = lcfg.antialias_train if is_train else lcfg.antialias_test
    interp = lcfg.interpolation if is_train else lcfg.interpolation_test
    im = reproject_image(
        origsize_im, camera, cam, output_imshape,
        antialias_factor=antialias, interp=interp)

    # Dataset-specific color fixes (`data_loading.py:124-130`).
    path_l = ex.image_path.lower()
    if re.match('.*mupots/ts[1-5]/.+', path_l):
        im = improc.adjust_gamma(im, 0.67, inplace=True)
    elif '3dhp' in path_l and re.match('.+/(ts[1-4])/', path_l):
        im = improc.adjust_gamma(im, 0.67, inplace=True)
        im = improc.white_balance(im, 110, 145)
    elif 'panoptic' in path_l:
        im = improc.white_balance(im, 120, 138)

    # Background augmentation by foreground mask (`data_loading.py:132-143`).
    if ex.mask is not None and lcfg.background_aug_prob:
        has_realistic_bg = any(x in path_l for x in
                               ['sailvos', 'agora', 'spec-syn', 'hspace'])
        bg_prob = 0.2 if has_realistic_bg else lcfg.background_aug_prob
        if (is_train or lcfg.test_aug) and background_rng.random() < bg_prob:
            fgmask = reproject_image(
                ex.mask.astype(np.float32), camera, cam, output_imshape,
                antialias_factor=antialias, interp=interp)
            im = bgaug.augment_background(
                im, fgmask, background_rng, background_dir=lcfg.background_dir,
                antialias_factor=antialias, interp=interp)

    im = augment_appearance(
        im, is_train or lcfg.test_aug, lcfg.occlude_aug_prob, appearance_rng,
        color_aug=lcfg.color_aug, occlude_aug_scale=lcfg.occlude_aug_scale,
        occluder_dir=lcfg.occluder_dir)
    im = improc.normalize01(im)

    with np.errstate(invalid='ignore'):
        is_joint_in_fov = ~np.any(
            [np.any(imcoords < 0, axis=-1),
             np.any(imcoords >= cfg.proc_side, axis=-1)], axis=0)
    joint_validity_mask = ~np.any(np.isnan(camcoords), axis=-1)

    rot_to_orig_cam = camera.R @ cam.R.T
    rot_to_world = cam.R.T
    if not np.all(np.isfinite(cam.intrinsic_matrix)):
        # A non-finite bbox/camera silently poisons gradients steps later;
        # fail fast at the data boundary (the analogue of the reference's
        # in-graph assert_all_finite, `models/metrabs.py:163`).
        raise ValueError(
            f'Non-finite crop intrinsics for {ex.image_path} '
            f'(bbox={np.asarray(ex.bbox)})')
    return dict(
        image=im.astype(np.float32),
        intrinsics=np.float32(cam.intrinsic_matrix),
        coords3d_true=np.nan_to_num(camcoords).astype(np.float32),
        coords2d_true=np.nan_to_num(imcoords).astype(np.float32),
        rot_to_orig_cam=rot_to_orig_cam.astype(np.float32),
        rot_to_world=rot_to_world.astype(np.float32),
        cam_loc=cam.t.astype(np.float32),
        joint_validity_mask=joint_validity_mask,
        is_joint_in_fov=np.float32(is_joint_in_fov))


def load_and_transform2d(
        ex: Example2D, joint_info: JointInfo, is_train: bool,
        rng: np.random.Generator, cfg: ModelConfig,
        lcfg: LoadConfig = LoadConfig()) -> Dict[str, np.ndarray]:
    appearance_rng = _new_rng(rng)
    geom_rng = _new_rng(rng)
    partial_visi_rng = _new_rng(rng)
    background_rng = _new_rng(rng)

    im_from_file = ex.image if ex.image is not None else improc.imread(ex.image_path)
    bbox = np.asarray(ex.bbox, np.float32)
    if is_train and partial_visi_rng.random() < lcfg.partial_visibility_prob:
        bbox = boxlib.random_partial_subbox(
            boxlib.expand_to_square(bbox), partial_visi_rng)

    crop_side = np.max(bbox[2:4])
    center_point = boxlib.center(bbox)
    if lcfg.geom_aug:
        center_point = center_point + (
            boxlib.random_uniform_disc(geom_rng) * lcfg.shift_aug / 100 * crop_side)

    has_3d_camera = ex.camera is not None
    orig_cam = (ex.camera if has_3d_camera
                else Camera.from_fov(8, im_from_file.shape[:2]))
    cam = orig_cam.copy()

    if has_3d_camera:
        sidepoints = _box_sidepoints(bbox, center_point)
        cam.turn_towards(target_image_point=center_point)
        cam.undistort()
        cam.square_pixels()
        cam_sidepoints = reproject_image_points(sidepoints, ex.camera, cam)
        crop_side = np.linalg.norm(cam_sidepoints[0] - cam_sidepoints[1])

    cam.zoom(cfg.proc_side / crop_side)

    if lcfg.geom_aug:
        s1 = lcfg.scale_aug_down / 100
        s2 = lcfg.scale_aug_up / 100
        cam.zoom(geom_rng.uniform(1 - s1, 1 + s2))
        r = (np.pi if lcfg.full_rot_aug_prob
             and geom_rng.random() < lcfg.full_rot_aug_prob
             else np.deg2rad(lcfg.rot_aug_degrees))
        cam.rotate(roll=geom_rng.uniform(-r, r))

    if lcfg.geom_aug and is_train and geom_rng.random() < 0.5:
        cam.horizontal_flip()
        imcoords = ex.coords[joint_info.mirror_mapping].copy()
    else:
        imcoords = ex.coords.copy()

    if has_3d_camera:
        cam.center_principal_point((cfg.proc_side, cfg.proc_side))
    else:
        new_center_point = reproject_image_points(center_point, orig_cam, cam)
        cam.shift_to_center(new_center_point, (cfg.proc_side, cfg.proc_side))

    # Annotations hugging the image bottom are usually truncation artifacts
    # (`data_loading.py:241-242`).
    is_annotation_invalid = (
        np.nan_to_num(imcoords[:, 1]) > im_from_file.shape[0] * 0.95)
    imcoords[is_annotation_invalid] = np.nan
    imcoords = reproject_image_points(imcoords, orig_cam, cam)

    antialias = lcfg.antialias_train if is_train else lcfg.antialias_test
    interp = lcfg.interpolation if is_train else lcfg.interpolation_test
    im = reproject_image(
        im_from_file, orig_cam, cam, (cfg.proc_side, cfg.proc_side),
        antialias_factor=antialias, interp=interp)

    if (ex.mask is not None and lcfg.background_aug_prob
            and (is_train or lcfg.test_aug)
            and background_rng.random() < lcfg.background_aug_prob):
        fgmask = reproject_image(
            ex.mask.astype(np.float32), orig_cam, cam,
            (cfg.proc_side, cfg.proc_side), antialias_factor=antialias,
            interp=interp)
        im = bgaug.augment_background(
            im, fgmask, background_rng, background_dir=lcfg.background_dir,
            antialias_factor=antialias, interp=interp)

    im = augment_appearance(
        im, is_train or lcfg.test_aug, lcfg.occlude_aug_prob_2d, appearance_rng,
        color_aug=lcfg.color_aug, occlude_aug_scale=lcfg.occlude_aug_scale,
        occluder_dir=lcfg.occluder_dir)
    im = improc.normalize01(im)

    joint_validity_mask = ~np.any(np.isnan(imcoords), axis=1)
    imcoords = np.nan_to_num(imcoords)
    with np.errstate(invalid='ignore'):
        is_joint_in_fov = ~np.logical_or(
            np.any(imcoords < 0, axis=-1),
            np.any(imcoords >= cfg.proc_side, axis=-1))

    return dict(
        image=np.float32(im),
        intrinsics=np.float32(cam.intrinsic_matrix),
        coords2d_true=np.float32(imcoords),
        joint_validity_mask=joint_validity_mask,
        is_joint_in_fov=is_joint_in_fov)


# The JAX package's classes an example pickle may hold, by module.
_JAX_CLASSES = {'metrabs_tpu.data.loading': ('Example3D', 'Example2D', 'LoadConfig'),
                'metrabs_tpu.data.camera': ('Camera',)}


class _ExampleUnpickler(pickle.Unpickler):
    """Maps the JAX package's example and camera classes to this package's;
    any other class of the JAX package is refused."""

    def find_class(self, module: str, name: str):
        if module == 'metrabs_tpu' or module.startswith('metrabs_tpu.'):
            if name not in _JAX_CLASSES.get(module, ()):
                raise pickle.UnpicklingError(
                    f'{module}.{name} has no counterpart in metrabs_tpu_torch')
            module = 'metrabs_tpu_torch' + module[len('metrabs_tpu'):]
        return super().find_class(module, name)


def load_examples(path: str):
    """The examples of an example pickle (a list of `Example3D` or
    `Example2D`), written by this package or by the JAX package. Like any
    pickle it can run code: load only files you trust."""
    with open(path, 'rb') as f:
        return _ExampleUnpickler(f).load()
