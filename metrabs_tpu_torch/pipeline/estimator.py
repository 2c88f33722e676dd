"""Multi-person absolute 3D pose estimation (`metrabs_tpu/pipeline/
estimator.py`): `detect_poses*` (person detector, then estimation and the
plausibility filter) and `estimate_poses*` (given boxes).

The JAX pipeline is one jitted program with `lax.cond` skips and a
`lax.map` over equal chunks. Here it runs eagerly: the skips become host
checks on `box_valid` (a host array; after the detector, its `valid` is
read to the host once per call), so a batch with no valid box builds no
pyramid and a chunk with no valid box runs no warp or crop model; the last
chunk is simply shorter instead of zero-padded. Per image batch: FOV
intrinsics, camera-space up, stable valid-first compaction, look-at
rotation and zoom per box, one pyramid build, then per chunk of boxes (all
TTA augmentations of each) the warp kernel, the per-aug gamma re-encode, the
crop model, the mirror unswap and the rotation back; then un-compaction, the
optional joint transform, 2D projection with distortion, the plausibility
filter and pose NMS (detections only, on camera-space poses with the aug
axis, as JAX), the world transform, the skeleton gather and the aug average.

The stream entry points (`estimate_poses_stream`, `detect_poses_stream`:
JAX's one `lax.map` program over K frame batches) run one batched call per
frame batch, building each batch's pyramid in turn; `detect_poses_pipelined`
keeps batches dispatched ahead of their readback, which overlaps nothing
while the detect path waits for the device within a call.

The crop warp always goes through `ops.warp_cuda.warp_pyramid`: the CUDA
kernel on a CUDA device, its plain version on the CPU. `cfg.warp_backend`
(a JAX/TPU choice) is not consulted.

With a `mesh` (`parallel.mesh`), every rank is called with the same global
frame batch, as a multi-process `jit` is, and returns the whole result.
The frame batch must divide the mesh's 'data' extent (else ValueError, as
JAX's shardings raise). The detector runs on each rank's frames and the
boxes are all-gathered over 'data'; every rank then computes the same
valid-first compaction and the same chunks of boxes (JAX's chunking, which
`ops.reconstruct` pools its scale over); the non-empty chunks are dealt
round-robin to the 'data' ranks and their poses all-gathered; the filter
and the pose NMS run after the gather, alike on every rank. Each rank
builds the pyramid of every frame. With `crop_state_shardings`
(`parallel.mesh.tp_shardings` of the crop model) the crop model is also
tensor-parallel over 'model' (`parallel.mesh.shard_module`); the detector
stays replicated.
"""

from __future__ import annotations

import collections
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from metrabs_tpu_torch.config import AugConfig, ModelConfig
from metrabs_tpu_torch.ops import camera as camera_ops
from metrabs_tpu_torch.ops import distortion as distortion_ops
from metrabs_tpu_torch.ops import rotation as rotation_ops
from metrabs_tpu_torch.ops import warp as warp_ops
from metrabs_tpu_torch.ops import warp_cuda
from metrabs_tpu_torch.parallel import mesh as mesh_mod
from metrabs_tpu_torch.pipeline import bone_priors, plausibility
from metrabs_tpu_torch.pipeline import tta as tta_mod
from metrabs_tpu_torch.pipeline.skeletons import SkeletonRegistry
from metrabs_tpu_torch.utils.joint_info import JointInfo

N_PYRAMID_LEVELS = 3


def checked_device(device) -> torch.device:
    """`device` as a `torch.device`. A CUDA device on a machine without CUDA
    raises: the entry points default to the card and never fall back to the
    CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} needs CUDA, which is not available; "
                           "pass device='cpu' to run on the CPU")
    return device


def _array(x, host: bool = False):
    """`x` as a tensor if it is one (copied to the host if `host`), else as
    a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu() if host else x
    return np.asarray(x)


def _stack(results) -> Dict[str, torch.Tensor]:
    """Per-batch result dicts -> one dict with a leading batch-stream axis."""
    return {k: torch.stack([r[k] for r in results]) for k in results[0]}


def _to_host(result) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in result.items()}


def _get_new_rotation_and_scale(intrinsic_matrix, distortion_coeffs, camspace_up, boxes,
                                box_valid, proc_side: int):
    """Per-box look-at rotation R_noaug [N, 3, 3] and zoom factor [N]; boxes
    that are invalid or degenerate get scale 1 (their outputs are masked)."""
    x, y, w, h = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    pts = torch.stack([
        torch.stack([x + w / 2, y + h / 2], dim=1),
        torch.stack([x + w / 2, y], dim=1),
        torch.stack([x + w, y + h / 2], dim=1),
        torch.stack([x + w / 2, y + h], dim=1),
        torch.stack([x, y + h / 2], dim=1)], dim=1)  # [N, 5, 2]
    inv_k = torch.linalg.inv(intrinsic_matrix)
    pts_cam = torch.einsum('bpc,bCc->bpC', camera_ops.to_homogeneous(pts), inv_k)
    pts_cam = camera_ops.to_homogeneous(distortion_ops.undistort_points(
        pts_cam[:, :, :2], distortion_coeffs[:, None, :]))
    R_noaug = rotation_ops.lookat_rotation_matrix(pts_cam[:, 0], camspace_up)
    side_new = camera_ops.project(torch.einsum(
        'bpc,bCc->bpC', pts_cam[:, 1:5], intrinsic_matrix @ R_noaug))
    vertical = torch.linalg.norm(side_new[:, 0] - side_new[:, 2], dim=-1)
    horizontal = torch.linalg.norm(side_new[:, 1] - side_new[:, 3], dim=-1)
    box_size_new = torch.maximum(vertical, horizontal)
    box_ok = box_valid & (box_size_new > 0)
    ones = torch.ones_like(box_size_new)
    box_scales = torch.where(box_ok, proc_side / torch.where(box_ok, box_size_new, ones),
                             ones)
    return R_noaug, box_scales


def _bone_priors(joint_info: JointInfo, bone_mean_lengths) -> np.ndarray:
    """The given priors, else the built-in asset for an exactly matching
    skeleton, else a flat 300 mm; the fallbacks warn as in JAX."""
    if bone_mean_lengths is not None:
        return np.asarray(bone_mean_lengths, np.float32)
    asset = bone_priors.priors_for_joint_info(joint_info)
    if asset is not None:
        warnings.warn(
            'PoseEstimator: no bone_mean_lengths provided; the plausibility filter will '
            'use the built-in APPROXIMATE anthropometric priors asset '
            '(metrabs_tpu_torch/assets/bone_priors.json), not dataset-derived means. Ship '
            'dataset-derived priors (apps/train.py accumulates them automatically, or '
            'pipeline.plausibility.compute_bone_mean_lengths).', stacklevel=3)
        return np.asarray(asset, np.float32)
    warnings.warn(
        'PoseEstimator: no bone_mean_lengths provided for a joint set matching no '
        'built-in skeleton; the plausibility filter falls back to a FLAT 300mm prior '
        'for every bone, which makes detect_poses(suppress_implausible_poses=True) '
        'unreliable. Provide dataset-derived means (apps/train.py accumulates them '
        'automatically, or pipeline.plausibility.compute_bone_mean_lengths).',
        stacklevel=3)
    return np.full(len(joint_info.edges), 300.0, np.float32)


class PoseEstimator:
    """`detect_poses*` / `estimate_poses*` of the JAX package, on `device`.
    The crop model (and the detector's model) must already be on `device`,
    in eval mode; `crop_model(crops [N, S, S, 3], intrinsics [N, 3, 3],
    sample_valid [N])` returns absolute camera-space poses [N, J, 3] in
    millimeters. `detector`: a `detect.yolov4.PersonDetector` or None.
    `bone_mean_lengths` [n_edges] (mm): the plausibility filter's priors.
    `device` defaults to the card and raises where CUDA is not available.
    `mesh` and `crop_state_shardings`: serving over several ranks (module
    docstring); the crop model is sharded in place."""

    def __init__(self, crop_model: torch.nn.Module, joint_info: JointInfo,
                 cfg: ModelConfig, aug_cfg: AugConfig = AugConfig(),
                 skeleton_registry: Optional[SkeletonRegistry] = None,
                 joint_transform_matrix: Optional[np.ndarray] = None,
                 detector=None, bone_mean_lengths: Optional[np.ndarray] = None,
                 device='cuda', mesh=None, crop_state_shardings=None):
        self.device = checked_device(device)
        self.mesh = mesh
        if crop_state_shardings is not None:
            if mesh is None:
                raise ValueError('crop_state_shardings needs a mesh')
            mesh_mod.shard_module(crop_model, mesh, crop_state_shardings)
        self.crop_model = crop_model
        self.cfg = cfg
        self._aug_cfg = aug_cfg
        self.detector = detector
        self.joint_info = joint_info
        self.skeletons = skeleton_registry or SkeletonRegistry(joint_info)
        self.per_skeleton_joint_names = self.skeletons.per_skeleton_joint_names
        self.per_skeleton_joint_edges = self.skeletons.per_skeleton_joint_edges
        self.per_skeleton_edges = self.per_skeleton_joint_edges
        self._mirror = torch.as_tensor(joint_info.mirror_mapping, dtype=torch.long,
                                       device=self.device)
        self._joint_transform = (
            None if joint_transform_matrix is None
            else torch.as_tensor(joint_transform_matrix, dtype=torch.float32,
                                 device=self.device))
        self._joint2bone = torch.as_tensor(joint_info.joint2bone_matrix(), device=self.device)
        self._mean_bones = torch.as_tensor(_bone_priors(joint_info, bone_mean_lengths),
                                           device=self.device)

    def estimate_poses_batched(
            self, images, boxes, box_valid=None, intrinsic_matrix=None,
            distortion_coeffs=None, extrinsic_matrix=None, world_up_vector=(0, -1, 0),
            default_fov_degrees=55.0, internal_batch_size=64, antialias_factor=1,
            num_aug=5, average_aug=True, skeleton='') -> Dict[str, torch.Tensor]:
        """images: [B, H, W, 3] uint8; boxes: [B, max_boxes, 4] (x, y, w, h).

        Returns tensors on the estimator's device: boxes [B, max, 5] (the
        given boxes with confidence 1), poses3d [B, max, (A,) J, 3],
        poses2d [B, max, (A,) J, 2] and valid [B, max]; the aug axis A is
        present iff average_aug is False."""
        boxes5, box_valid = self._boxes5_from(boxes, box_valid)
        self._data_rows(boxes5)  # raises where the batch does not divide 'data'
        images = torch.as_tensor(images, device=self.device)
        camera = self._prepare_camera_args(images.shape[0], intrinsic_matrix,
                                           distortion_coeffs, extrinsic_matrix,
                                           world_up_vector)
        with torch.inference_mode():
            return self._estimate(
                images, boxes5, box_valid, *camera, float(default_fov_degrees),
                num_aug=int(num_aug), average_aug=bool(average_aug),
                antialias_factor=int(antialias_factor),
                internal_batch_size=int(internal_batch_size),
                skeleton_indices=self.skeletons.indices(skeleton), suppress=False)

    def estimate_poses_stream(
            self, images, boxes, box_valid=None, intrinsic_matrix=None,
            distortion_coeffs=None, extrinsic_matrix=None, world_up_vector=(0, -1, 0),
            default_fov_degrees=55.0, internal_batch_size=64, antialias_factor=1,
            num_aug=5, average_aug=True, skeleton='') -> Dict[str, torch.Tensor]:
        """`estimate_poses_batched` over a stream of K frame batches: images
        [K, B, H, W, 3] uint8, boxes [K, B, max_boxes, 4], box_valid [K, B,
        max_boxes] or None (all valid). Camera arguments are per frame slot
        [B, ...], shared over K. Returns the batched call's tensors stacked
        on a leading K axis; each batch runs as its own batched call (its own
        pyramid), so the result is that of K batched calls."""
        images = _array(images)
        if images.ndim != 5:
            raise ValueError(f'images must be [K, B, H, W, 3], got shape {tuple(images.shape)}')
        boxes = _array(boxes)
        box_valid = None if box_valid is None else _array(box_valid)
        return _stack([self.estimate_poses_batched(
            images[k], boxes[k], None if box_valid is None else box_valid[k],
            intrinsic_matrix=intrinsic_matrix, distortion_coeffs=distortion_coeffs,
            extrinsic_matrix=extrinsic_matrix, world_up_vector=world_up_vector,
            default_fov_degrees=default_fov_degrees, internal_batch_size=internal_batch_size,
            antialias_factor=antialias_factor, num_aug=num_aug, average_aug=average_aug,
            skeleton=skeleton) for k in range(images.shape[0])])

    def estimate_poses(self, image, boxes, **kwargs) -> Dict[str, np.ndarray]:
        """Single image; returns host numpy arrays restricted to valid rows."""
        images = torch.as_tensor(image)[None]
        result = self.estimate_poses_batched(
            images, np.asarray(boxes, np.float32)[None], **kwargs)
        return self._squeeze_single(result)

    def detect_poses_batched(
            self, images, intrinsic_matrix=None, distortion_coeffs=None,
            extrinsic_matrix=None, world_up_vector=(0, -1, 0), default_fov_degrees=55.0,
            internal_batch_size=64, antialias_factor=1, num_aug=5, average_aug=True,
            skeleton='', detector_threshold=0.3, detector_nms_iou_threshold=0.7,
            max_detections=16, detector_flip_aug=False, suppress_implausible_poses=True,
            fused=True) -> Dict[str, torch.Tensor]:
        """Detection, then estimation: images [B, H, W, 3] uint8.

        Returns tensors on the estimator's device: boxes [B, max_detections,
        5] (x, y, w, h, score), poses3d, poses2d and valid as in
        `estimate_poses_batched`; with `suppress_implausible_poses`, valid
        also drops implausible and duplicate poses.

        `fused` is accepted and gives the same result either way: in JAX it
        chooses between one compiled program for detector and estimator and
        two, while here both run eagerly, so there is no separate program to
        fuse."""
        del fused
        if self.detector is None:
            raise ValueError('No detector attached to this estimator.')
        if max_detections <= 0:
            raise ValueError(
                "max_detections must be a positive static capacity (the reference's "
                '-1/unlimited has no fixed-shape equivalent; use a generous cap, e.g. '
                '150 = the pose-NMS maximum)')
        flip_vertical = detector_flip_aug and self._aug_cfg.detector_flip_vertical_too
        images = torch.as_tensor(images, device=self.device)
        camera = self._prepare_camera_args(images.shape[0], intrinsic_matrix,
                                           distortion_coeffs, extrinsic_matrix,
                                           world_up_vector)
        with torch.inference_mode():
            boxes5, valid = self.detector.detect_batched(
                self._data_rows(images), threshold=float(detector_threshold),
                nms_iou_threshold=float(detector_nms_iou_threshold),
                max_detections=int(max_detections), flip_aug=bool(detector_flip_aug),
                flip_vertical=bool(flip_vertical))
            boxes5, valid = self._gather_data(boxes5), self._gather_data(valid)
            return self._estimate(
                images, boxes5, valid.cpu().numpy(), *camera, float(default_fov_degrees),
                num_aug=int(num_aug), average_aug=bool(average_aug),
                antialias_factor=int(antialias_factor),
                internal_batch_size=int(internal_batch_size),
                skeleton_indices=self.skeletons.indices(skeleton),
                suppress=bool(suppress_implausible_poses))

    def detect_poses_stream(
            self, images, intrinsic_matrix=None, distortion_coeffs=None,
            extrinsic_matrix=None, world_up_vector=(0, -1, 0), default_fov_degrees=55.0,
            internal_batch_size=64, antialias_factor=1, num_aug=5, average_aug=True,
            skeleton='', detector_threshold=0.3, detector_nms_iou_threshold=0.7,
            max_detections=16, detector_flip_aug=False,
            suppress_implausible_poses=True) -> Dict[str, torch.Tensor]:
        """`detect_poses_batched` over a stream of K frame batches: images
        [K, B, H, W, 3] uint8; camera arguments per frame slot [B, ...],
        shared over K. Returns the batched call's tensors stacked on a
        leading K axis, the result of K batched calls (whose errors it
        raises)."""
        images = _array(images)
        if images.ndim != 5:
            raise ValueError(f'images must be [K, B, H, W, 3], got shape {tuple(images.shape)}')
        return _stack([self.detect_poses_batched(
            images[k], intrinsic_matrix=intrinsic_matrix, distortion_coeffs=distortion_coeffs,
            extrinsic_matrix=extrinsic_matrix, world_up_vector=world_up_vector,
            default_fov_degrees=default_fov_degrees, internal_batch_size=internal_batch_size,
            antialias_factor=antialias_factor, num_aug=num_aug, average_aug=average_aug,
            skeleton=skeleton, detector_threshold=detector_threshold,
            detector_nms_iou_threshold=detector_nms_iou_threshold,
            max_detections=max_detections, detector_flip_aug=detector_flip_aug,
            suppress_implausible_poses=suppress_implausible_poses)
            for k in range(images.shape[0])])

    def detect_poses_pipelined(self, image_batches, *, in_flight=2, fused=False, **kwargs):
        """`detect_poses_batched` over an iterable of [B, H, W, 3] frame
        batches, keeping `in_flight` batches dispatched ahead of their copy
        to the host: a generator of per-batch dicts of host numpy arrays, in
        order. `kwargs` (camera arguments included) are shared by every
        batch; `fused` is accepted as `detect_poses_batched` accepts it.

        The detect path reads the detector's mask to the host and inverts
        matrices with `torch.linalg.inv`, both of which wait for the device,
        so a batch's dispatch overlaps nothing yet; the results are those of
        one batched call per batch."""
        if self.detector is None:
            raise ValueError('No detector attached to this estimator.')
        if in_flight < 1:
            raise ValueError('in_flight must be >= 1')
        pending = collections.deque()
        for images in image_batches:
            pending.append(self.detect_poses_batched(images, fused=fused, **kwargs))
            if len(pending) > in_flight:
                yield _to_host(pending.popleft())
        while pending:
            yield _to_host(pending.popleft())

    def detect_poses(self, image, **kwargs) -> Dict[str, np.ndarray]:
        """Single image; returns host numpy arrays restricted to valid rows."""
        result = self.detect_poses_batched(torch.as_tensor(image)[None], **kwargs)
        return self._squeeze_single(result)

    def _data_extent(self) -> int:
        return 1 if self.mesh is None else mesh_mod.axis_size(self.mesh, mesh_mod.DATA_AXIS)

    def _data_rows(self, x):
        """This rank's frames of a frame batch (all of them without a
        mesh); raises where the batch does not divide 'data'."""
        return x if self.mesh is None else mesh_mod.shard_batch(self.mesh, x)

    def _gather_data(self, x: torch.Tensor) -> torch.Tensor:
        """The 'data' ranks' frame rows of `x` concatenated in rank order."""
        n = self._data_extent()
        if n == 1:
            return x
        group = mesh_mod.axis_group(self.mesh, mesh_mod.DATA_AXIS)
        if x.dtype == torch.bool:
            return mesh_mod.all_gather_rows(x.to(torch.uint8), group, n).bool()
        return mesh_mod.all_gather_rows(x, group, n)

    def _deal_chunks(self, chunks, nonempty, chunk_rows, row_shape):
        """Under several 'data' ranks, `chunks` holds the poses of this
        rank's share of the non-empty chunks (`nonempty`, dealt round-robin)
        and None for the others': fills those in from one all-gather, each
        rank's rows padded to the longest share. `chunk_rows`: each chunk's
        box count; `row_shape`: a box's poses' shape."""
        n = self._data_extent()
        if n == 1:
            return chunks
        index = mesh_mod.axis_index(self.mesh, mesh_mod.DATA_AXIS)
        share = [nonempty[r::n] for r in range(n)]
        width = max(sum(chunk_rows[i] for i in s) for s in share)
        local = torch.zeros((width,) + row_shape, device=self.device)
        offset = 0
        for i in share[index]:
            local[offset:offset + chunk_rows[i]] = chunks[i]
            offset += chunk_rows[i]
        gathered = mesh_mod.all_gather_rows(
            local, mesh_mod.axis_group(self.mesh, mesh_mod.DATA_AXIS), n)
        for r in range(n):
            offset = r * width
            for i in share[r]:
                chunks[i] = gathered[offset:offset + chunk_rows[i]]
                offset += chunk_rows[i]
        return chunks

    @staticmethod
    def _squeeze_single(result) -> Dict[str, np.ndarray]:
        out = {k: v[0] for k, v in _to_host(result).items()}
        valid = out.pop('valid').astype(bool)
        return {k: v[valid] for k, v in out.items()}

    @staticmethod
    def _boxes5_from(boxes, box_valid):
        """[..., 4] user boxes (array-likes or tensors on any device) -> ([...,
        5] with confidence 1, validity), both on the host."""
        boxes = np.asarray(_array(boxes, host=True), np.float32)
        box_valid = (np.ones(boxes.shape[:-1], bool) if box_valid is None
                     else np.asarray(_array(box_valid, host=True), bool))
        boxes5 = np.concatenate([boxes, np.ones_like(boxes[..., :1])], axis=-1)
        return boxes5, box_valid

    def _prepare_camera_args(self, n_images, intrinsic_matrix, distortion_coeffs,
                             extrinsic_matrix, world_up_vector):
        if intrinsic_matrix is None:
            intrinsic_matrix = np.tile(-np.ones((1, 3, 3), np.float32), (n_images, 1, 1))
        else:
            intrinsic_matrix = np.broadcast_to(
                np.asarray(intrinsic_matrix, np.float32).reshape(-1, 3, 3),
                (n_images, 3, 3))
        if distortion_coeffs is None:
            distortion_coeffs = np.zeros((n_images, 12), np.float32)
        else:
            d = np.asarray(distortion_coeffs, np.float32)
            d = d.reshape(1, -1) if d.ndim == 1 else d
            d = np.pad(d, ((0, 0), (0, 12 - d.shape[1])))
            distortion_coeffs = np.broadcast_to(d, (n_images, 12))
        if extrinsic_matrix is None:
            extrinsic_matrix = np.broadcast_to(np.eye(4, dtype=np.float32),
                                               (n_images, 4, 4))
        else:
            extrinsic_matrix = np.broadcast_to(
                np.asarray(extrinsic_matrix, np.float32).reshape(-1, 4, 4),
                (n_images, 4, 4))
        return tuple(torch.tensor(np.asarray(a, np.float32), device=self.device)
                     for a in (intrinsic_matrix, distortion_coeffs, extrinsic_matrix,
                               world_up_vector))

    def _estimate(self, images, boxes5, box_valid, intrinsic_matrix, distortion_coeffs,
                  extrinsic_matrix, world_up_vector, default_fov_degrees, *,
                  num_aug: int, average_aug: bool, antialias_factor: int,
                  internal_batch_size: int, skeleton_indices: np.ndarray, suppress: bool):
        dev = self.device
        n_images, img_h, img_w = images.shape[:3]
        max_boxes = boxes5.shape[1]
        n_total = n_images * max_boxes

        fov_k = camera_ops.intrinsics_from_fov(default_fov_degrees, (img_h, img_w),
                                               device=dev)
        unknown = torch.all(intrinsic_matrix == -1, dim=-1).all(dim=-1)[:, None, None]
        intrinsic_matrix = torch.where(unknown, fov_k, intrinsic_matrix)
        camspace_up = torch.einsum('c,bCc->bC', world_up_vector,
                                   extrinsic_matrix[:, :3, :3])

        boxes_t = torch.as_tensor(boxes5, device=dev)
        valid_flat = box_valid.reshape(n_total)
        k_flat = intrinsic_matrix.repeat_interleave(max_boxes, dim=0)
        dist_flat = distortion_coeffs.repeat_interleave(max_boxes, dim=0)

        # Valid boxes first (stable), so that padding gathers in the trailing
        # chunks, which are skipped. Only the poses need un-compacting.
        order = torch.argsort(torch.from_numpy(~valid_flat).to(torch.uint8), stable=True)
        valid_c = valid_flat[order.numpy()]
        order_d = order.to(dev)
        inv_order = torch.argsort(order_d)
        image_ids_c = torch.arange(n_images, device=dev).repeat_interleave(max_boxes)[order_d]
        k_c = k_flat[order_d]
        dist_c = dist_flat[order_d]
        boxes_c = boxes_t.reshape(n_total, boxes_t.shape[-1])[order_d]
        up_c = camspace_up.repeat_interleave(max_boxes, dim=0)[order_d]
        valid_c_d = torch.as_tensor(valid_c, device=dev)

        R_noaug, box_scales = _get_new_rotation_and_scale(
            k_c, dist_c, up_c, boxes_c, valid_c_d, self.cfg.proc_side)

        pyramid = None
        if valid_flat.any():
            images_lin = (images.float() / 255.0) ** 2.2
            pyramid = warp_ops.build_flat_pyramid(images_lin, N_PYRAMID_LEVELS)
            del images_lin

        tta = tta_mod.make_tta_params(num_aug, self._aug_cfg)
        n_joints = self.joint_info.n_joints
        boxes_per_chunk = internal_batch_size // max(num_aug, 1) or max(n_total, 1)
        slices = [slice(start, min(start + boxes_per_chunk, n_total))
                  for start in range(0, n_total, boxes_per_chunk)]
        nonempty = [i for i, sl in enumerate(slices) if valid_c[sl].any()]
        n_data = self._data_extent()
        mine = set(nonempty if n_data == 1 else nonempty[
            mesh_mod.axis_index(self.mesh, mesh_mod.DATA_AXIS)::n_data])
        chunks = []
        for i, sl in enumerate(slices):
            if i not in mine:
                chunks.append(None if i in nonempty else torch.tensor(
                    [0.0, 0.0, 1000.0], device=dev).expand(sl.stop - sl.start, num_aug,
                                                            n_joints, 3))
                continue
            chunks.append(self._predict_chunk(
                pyramid, tta, k_c[sl], dist_c[sl], R_noaug[sl], box_scales[sl],
                image_ids_c[sl], valid_c_d[sl], antialias_factor))
        chunks = self._deal_chunks(chunks, nonempty, [sl.stop - sl.start for sl in slices],
                                   (num_aug, n_joints, 3))
        poses3d_flat = (torch.cat(chunks)[inv_order] if chunks  # [N, A, J, 3]
                        else torch.zeros((0, num_aug, n_joints, 3), device=dev))

        if self._joint_transform is not None:
            poses3d_flat = torch.einsum('bank,nN->baNk', poses3d_flat,
                                        self._joint_transform)
        n_out = poses3d_flat.shape[2]

        poses2d_normalized = camera_ops.to_homogeneous(distortion_ops.distort_points(
            camera_ops.project(poses3d_flat), dist_flat[:, None, None, :]))
        poses2d_flat = torch.einsum('bank,bjk->banj', poses2d_normalized,
                                    k_flat[:, :2, :])
        poses3d = poses3d_flat.reshape(n_images, max_boxes, num_aug, n_out, 3)
        poses2d = poses2d_flat.reshape(n_images, max_boxes, num_aug, n_out, 2)
        valid = torch.as_tensor(box_valid, device=dev)
        if suppress:
            valid = valid & plausibility.suppress_implausible_poses(
                poses3d, poses2d, boxes_t, valid, self._joint2bone, self._mean_bones)

        inv_ext = torch.linalg.inv(extrinsic_matrix)
        poses3d = torch.einsum('bmank,bjk->bmanj', camera_ops.to_homogeneous(poses3d),
                               inv_ext[:, :3, :])

        sel = torch.as_tensor(skeleton_indices, dtype=torch.long, device=dev)
        poses3d = poses3d[..., sel, :]
        poses2d = poses2d[..., sel, :]
        if average_aug:
            poses3d = poses3d.mean(dim=-3)
            poses2d = poses2d.mean(dim=-3)
        return dict(boxes=boxes_t, poses3d=poses3d, poses2d=poses2d, valid=valid)

    def _predict_chunk(self, pyramid, tta, k_c, dist_c, r_noaug_c, scales_c, ids_c,
                       valid_c, antialias_factor: int):
        """Warp + crop model for all augmentations of a chunk of boxes;
        returns poses [n_box, A, J, 3] in the original camera frame."""
        dev = self.device
        res = self.cfg.proc_side
        num_aug = tta.num_aug
        n_box = k_c.shape[0]
        aug_scales = torch.as_tensor(tta.scales, device=dev)
        rotflip = torch.as_tensor(tta.rotflip_mats, device=dev)
        crop_scales = aug_scales[:, None] * scales_c[None, :]  # [A, n]

        # New intrinsics: focal scaled, principal point centered.
        topleft = k_c[None, :, :2, :2] * crop_scales[:, :, None, None]
        pp = torch.full((num_aug, n_box, 2, 1), res / 2.0, device=dev)
        row3 = torch.cat([torch.zeros((num_aug, n_box, 1, 2), device=dev),
                          torch.ones((num_aug, n_box, 1, 1), device=dev)], dim=3)
        new_k = torch.cat([torch.cat([topleft, pp], dim=3), row3], dim=2)  # [A, n, 3, 3]
        R = torch.einsum('aij,njk->anik', rotflip, r_noaug_c)
        new_invprojmat = torch.linalg.inv(new_k @ R)
        if antialias_factor > 1:
            new_invprojmat = new_invprojmat @ camera_ops.corner_aligned_scale_mat(
                1.0 / antialias_factor, device=dev)

        flat, level_info, per_image_len = pyramid
        params, geom = warp_ops.pyramid_warp_params(
            k_c.repeat(num_aug, 1, 1), new_invprojmat.reshape(-1, 3, 3),
            dist_c.repeat(num_aug, 1), crop_scales.reshape(-1) * antialias_factor,
            ids_c.repeat(num_aug), level_info, per_image_len)
        out_side = res * antialias_factor
        crops = warp_cuda.warp_pyramid(flat, params, geom, (out_side, out_side),
                                       precision=self.cfg.warp_precision)
        if antialias_factor > 1:
            crops = warp_ops.avg_pool_nxn(crops, antialias_factor)
        # Per-aug gamma re-encode; cancels the 2.2 decode of the pyramid.
        gammas = torch.as_tensor(tta.gammas, device=dev)
        crops = crops ** (gammas / 2.2).repeat_interleave(n_box)[:, None, None, None]

        poses_flat = self.crop_model(crops.to(getattr(torch, self.cfg.dtype)),
                                     new_k.reshape(-1, 3, 3), valid_c.repeat(num_aug))
        poses = poses_flat.reshape(num_aug, n_box, -1, 3)
        # Undo the horizontal flip's left/right swap; R undoes the mirror.
        should_flip = torch.as_tensor(tta.should_flip, device=dev)
        poses = torch.where(should_flip[:, None, None, None], poses[:, :, self._mirror],
                            poses)
        poses_orig_cam = torch.einsum('anjc,anck->anjk', poses, R)
        return poses_orig_cam.transpose(0, 1)
