"""Writes and loads pose-estimator package directories
(`metrabs_tpu/io/packaging.py`).

Same package format as the JAX package (`manifest.json`,
`crop_model.msgpack`, optionally `detector.msgpack` and
`joint_transform.npy`) and the same serving defaults: a scanned-layout
backbone (and YOLOv4 detector) is unrolled to the flat layout, and
BatchNorm is folded into the convs for foldable families, the YOLOv4
detector included (darknet eps 1e-5) under the same `bn_fold` switch. File
reading is split from the rest (`crop_model_from_variables`,
`pose_estimator_from_variables`) so that a caller holding variables in
memory builds exactly the estimator that `load_pose_estimator` builds.
Every loader puts its result on the card unless `device` says otherwise,
and raises where CUDA is not available and no device was named.

`backbone_builder` (default `models.backbones.builder.build_backbone`, same
arguments) builds the crop model's backbone, e.g.
`functools.partial(build_backbone, fuse_mbconv='on')` for the fused MBConv
kernel, which needs `cfg_overrides={'bn_fold': False}`.

Every crop-model class and latent mode of the JAX package loads: the
manifest's `model_class` ('metrabs', 'metro' or 'model25d'), `latent_mode`,
`n_latents` and Model25D's `bones_25d` and `bone_lengths_ideal` pick the
model (`models.metrabs.build_crop_model`), on any backbone family, with a
detector of the YOLOv4 or YOLOv8 family. Metro predicts root-relative poses
only: `load_crop_model` builds it, the estimator loaders refuse it, as JAX's
do.

`save_pose_estimator_package` writes a crop model of any class (e.g. a
model the port trained or imported with `io.weights_import`) in the same
format, which both packages load, with a detector of any family in the flat
layout (e.g. imported with `detect.yolov4.load_darknet_weights`);
`add_detector_to_package` adds one to a package afterwards.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from metrabs_tpu_torch.config import AugConfig, ModelConfig
from metrabs_tpu_torch.detect.yolov4 import PersonDetector, build_detector_model
from metrabs_tpu_torch.io import weights
from metrabs_tpu_torch.io.checkpoints import export_model_msgpack, load_model_msgpack
from metrabs_tpu_torch.models.backbones.builder import backbone_supports_bn_fold
from metrabs_tpu_torch.models.metrabs import build_crop_model
from metrabs_tpu_torch.parallel.mesh import tp_shardings
from metrabs_tpu_torch.pipeline.estimator import PoseEstimator, checked_device
from metrabs_tpu_torch.pipeline.skeletons import SkeletonInfo, SkeletonRegistry
from metrabs_tpu_torch.utils.joint_info import JointInfo

# ModelConfig fields that define the trained model and may not be overridden.
_PROTECTED_FIELDS = {'proc_side', 'depth', 'n_joints', 'backbone', 'stride_train',
                     'stride_test'}


def save_pose_estimator_package(
        directory: str, *, cfg: ModelConfig, aug_cfg: AugConfig,
        crop_model_variables: Dict, joint_info: JointInfo,
        detector_variables: Optional[Dict] = None, detector_scan_repeats: bool = False,
        detector_type: str = 'yolov4', detector_dtype: str = 'bfloat16',
        detector_input_size: Optional[int] = None,
        skeleton_registry: Optional[SkeletonRegistry] = None,
        bone_mean_lengths: Optional[np.ndarray] = None,
        joint_transform_matrix: Optional[np.ndarray] = None,
        latent_mode: str = '', n_latents: int = 0, model_class: str = 'metrabs',
        bones_25d=None, bone_lengths_ideal=None) -> None:
    """A package of a crop model, with a person detector if
    `detector_variables` is given: `crop_model_variables` is the crop
    model's flat-layout JAX-style tree of numpy arrays
    (`io.weights.flax_variables_from_state_dict` of its state dict, BN
    unfolded), `cfg` its config with `backbone_scan_blocks=False`;
    `detector_variables` the detector's flat-layout, unfolded tree (e.g. from
    `detect.yolov4.load_darknet_weights` or `detect.yolov8.
    import_yolov8_from_torch`) of `detector_type` ('yolov4', 'yolov4-tiny' or
    'yolov8{n,s,m,l,x}'), served in `detector_dtype` at `detector_input_size`
    (None: the family's default, 416 or 640). The port writes the flat
    detector layout only (`detector_scan_repeats=False`). `model_class`
    ('metrabs', 'metro' or 'model25d'), Metrabs' `latent_mode` and
    `n_latents`, and Model25D's `bones_25d` [B, 2] and `bone_lengths_ideal`
    [B] mm (which it needs) as in JAX. The manifest is the JAX package's."""
    if cfg.backbone_scan_blocks or cfg.bn_fold:
        raise ValueError('The port writes the flat, unfolded layout: '
                         'backbone_scan_blocks and bn_fold must be False')
    if model_class == 'model25d' and (bones_25d is None or bone_lengths_ideal is None):
        raise ValueError('model25d packages need bones_25d and bone_lengths_ideal')
    os.makedirs(directory, exist_ok=True)
    export_model_msgpack(os.path.join(directory, 'crop_model.msgpack'), crop_model_variables)
    if detector_variables is not None:
        _write_detector(directory, detector_variables, detector_scan_repeats)
    if joint_transform_matrix is not None:
        np.save(os.path.join(directory, 'joint_transform.npy'), joint_transform_matrix)
    skeletons = {}
    if skeleton_registry is not None:
        for name in skeleton_registry.skeleton_names:
            skeletons[name] = dict(
                indices=[int(i) for i in skeleton_registry.indices(name)],
                names=list(skeleton_registry.joint_names(name)),
                edges=[list(map(int, e)) for e in skeleton_registry.joint_edges(name)])
    manifest = dict(
        format_version=1, model_config=dataclasses.asdict(cfg),
        aug_config=dataclasses.asdict(aug_cfg), joint_names=list(joint_info.names),
        joint_edges=[list(map(int, e)) for e in joint_info.edges],
        has_detector=detector_variables is not None,
        detector_scan_repeats=detector_scan_repeats, detector_type=detector_type,
        detector_dtype=detector_dtype, detector_input_size=detector_input_size,
        has_joint_transform=joint_transform_matrix is not None,
        latent_mode=latent_mode, n_latents=n_latents, model_class=model_class,
        bones_25d=None if bones_25d is None else [list(map(int, b)) for b in bones_25d],
        bone_lengths_ideal=(None if bone_lengths_ideal is None
                            else [float(x) for x in bone_lengths_ideal]),
        bone_mean_lengths=(None if bone_mean_lengths is None
                           else [float(x) for x in bone_mean_lengths]),
        skeletons=skeletons)
    with open(os.path.join(directory, 'manifest.json'), 'w') as f:
        json.dump(manifest, f, indent=2)


def add_detector_to_package(
        directory: str, detector_variables: Dict, *, detector_type: str = 'yolov4',
        detector_dtype: str = 'bfloat16', detector_input_size: Optional[int] = None,
        detector_scan_repeats: bool = False) -> None:
    """Adds (or replaces) the detector of an existing package
    (`metrabs_tpu/io/packaging.py::add_detector_to_package`), so that a crop
    model and a detector made apart can be joined: arguments as in
    `save_pose_estimator_package`."""
    manifest_path = os.path.join(directory, 'manifest.json')
    with open(manifest_path) as f:
        manifest = json.load(f)
    _write_detector(directory, detector_variables, detector_scan_repeats)
    manifest.update(has_detector=True, detector_type=detector_type,
                    detector_dtype=detector_dtype, detector_input_size=detector_input_size,
                    detector_scan_repeats=detector_scan_repeats)
    with open(manifest_path, 'w') as f:
        json.dump(manifest, f, indent=2)


def _write_detector(directory: str, variables: Dict, scan_repeats: bool) -> None:
    if scan_repeats or any(k.startswith('res_scan_') for k in variables.get('params', {})):
        raise ValueError('The port writes the flat detector layout: detector_scan_repeats '
                         'must be False and the tree must have no res_scan_ groups')
    export_model_msgpack(os.path.join(directory, 'detector.msgpack'), variables)


def crop_model_kwargs(manifest: dict) -> dict:
    """`build_crop_model`'s model arguments from a package manifest."""
    return dict(model_class=manifest.get('model_class', 'metrabs'),
                latent_mode=manifest.get('latent_mode', ''),
                n_latents=manifest.get('n_latents', 0),
                bones=tuple(tuple(b) for b in manifest.get('bones_25d') or ()),
                bone_lengths_ideal=tuple(manifest.get('bone_lengths_ideal') or ()))


def crop_model_from_variables(
        variables: Dict, manifest: dict, *, scan_blocks: Optional[bool] = None,
        bn_fold: bool = False, device='cuda',
        backbone_builder=None) -> Tuple[torch.nn.Module, ModelConfig]:
    """The crop model of a package (its `model_class`) from its variable
    tree (numpy leaves, as stored) and manifest, in eval mode on `device`,
    its submodules in `cfg.dtype` (the latent modes' constants stay
    float32).

    `scan_blocks=False` unrolls a scanned-layout tree; `bn_fold` folds BN;
    `backbone_builder` builds the backbone (module docstring)."""
    device = checked_device(device)
    cfg = ModelConfig(**manifest['model_config'])
    if scan_blocks is not None and scan_blocks != cfg.backbone_scan_blocks:
        if scan_blocks:
            raise ValueError('Re-stacking a flat-layout package into the scanned '
                             'layout is not supported')
        variables = weights.scanned_to_flat(variables)
        cfg = dataclasses.replace(cfg, backbone_scan_blocks=False)
    if cfg.backbone_scan_blocks:
        raise ValueError('The port runs the flat layout only; load with '
                         'scan_blocks=False to unroll a scanned package')
    if bn_fold:
        variables = weights.fold_bn_variables(
            variables, epsilon=weights.bn_epsilon_for(cfg.backbone))
        cfg = dataclasses.replace(cfg, bn_fold=True)
    kwargs = crop_model_kwargs(manifest)
    state = weights.crop_model_state_dict_from_flax(variables, cfg, **kwargs)
    with torch.device('meta'):
        model = build_crop_model(cfg, backbone_builder, **kwargs)
    model.load_state_dict(state, assign=True)
    model = model.to(device=device).eval()
    for child in model.children():
        child.to(getattr(torch, cfg.dtype))
    model.requires_grad_(False)
    return model, cfg


def load_crop_model(directory: str, *, scan_blocks: Optional[bool] = None,
                    bn_fold: bool = False, device='cuda', backbone_builder=None):
    """Returns (model, cfg, joint_info, manifest) of a package directory."""
    device = checked_device(device)
    manifest = _read_manifest(directory)
    variables = load_model_msgpack(os.path.join(directory, 'crop_model.msgpack'))['variables']
    model, cfg = crop_model_from_variables(variables, manifest, scan_blocks=scan_blocks,
                                           bn_fold=bn_fold, device=device,
                                           backbone_builder=backbone_builder)
    return model, cfg, _joint_info(manifest), manifest


def detector_from_variables(variables: Dict, manifest: dict, *, bn_fold: bool,
                            device='cuda') -> PersonDetector:
    """The package's person detector from its variable tree (numpy leaves, as
    stored) and manifest, in eval mode on `device` in `detector_dtype`. A
    scanned YOLOv4 tree is unrolled; BN is folded (eps 1e-5) iff `bn_fold`
    and the detector is of the YOLOv4 family."""
    device = checked_device(device)
    det_type = manifest.get('detector_type', 'yolov4')
    det_fold = bn_fold and det_type.startswith('yolov4')
    with torch.device('meta'):
        model = build_detector_model(det_type, bn_fold=det_fold)
    if manifest.get('detector_scan_repeats', True):
        variables = weights.yolo_scanned_to_flat(variables)
    if det_fold:
        variables = weights.fold_bn_variables(variables, epsilon=1e-5)
    model.load_state_dict(weights.detector_state_dict_from_flax(variables, model), assign=True)
    dtype = getattr(torch, manifest.get('detector_dtype', 'float32'))
    model = model.to(device=device, dtype=dtype).eval()
    model.requires_grad_(False)
    return PersonDetector(model, input_size=manifest.get('detector_input_size'))


def pose_estimator_from_variables(
        crop_variables: Dict, manifest: dict, *, device='cuda',
        cfg_overrides: Optional[dict] = None,
        joint_transform_matrix: Optional[np.ndarray] = None,
        detector_variables: Optional[Dict] = None,
        backbone_builder=None, mesh=None, tp_min_size: Optional[int] = None) -> PoseEstimator:
    """Everything `load_pose_estimator` does after reading the files. A
    Metro package raises ValueError, as in JAX.

    `cfg_overrides`: serving-only ModelConfig fields to replace; the fields
    that define the trained model cannot be overridden. Defaults: a scanned
    backbone is unrolled, and BN is folded for foldable families (opt out
    with `{'bn_fold': False}`), in the crop model and in a YOLOv4 detector.
    `detector_variables`: the detector's tree (the manifest's `detector_*`
    fields describe it), or None for an estimator without a detector;
    `backbone_builder`: module docstring. `mesh`: serving over its ranks
    (`pipeline.estimator`), every rank loading the package alike; with
    `tp_min_size` the crop model is also tensor-parallel over the mesh's
    'model' axis (`parallel.mesh.tp_shardings(mesh, crop_model,
    tp_min_size)`)."""
    device = checked_device(device)
    if manifest.get('model_class', 'metrabs') == 'metro':
        raise ValueError(
            'Metro predicts root-relative poses only (no intrinsics input, '
            'metro.py:24-27) and cannot drive the absolute multi-person '
            'estimator; use load_crop_model() for the bare model')
    cfg_overrides = dict(cfg_overrides or {})
    if cfg_overrides.pop('backbone_scan_blocks', False):
        raise ValueError('The port runs the flat backbone layout only')
    bn_fold = cfg_overrides.pop('bn_fold', None)
    if bn_fold is None:
        bn_fold = backbone_supports_bn_fold(
            manifest['model_config'].get('backbone', ModelConfig.backbone))
    bad = _PROTECTED_FIELDS & set(cfg_overrides)
    if bad:
        raise ValueError(f'cfg_overrides may not change trained-model fields: {bad}')
    model, cfg = crop_model_from_variables(crop_variables, manifest, scan_blocks=False,
                                           bn_fold=bn_fold, device=device,
                                           backbone_builder=backbone_builder)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)

    joint_info = _joint_info(manifest)
    skeleton_registry = None
    if manifest.get('skeletons'):
        infos = {k: SkeletonInfo(indices=tuple(v['indices']), names=tuple(v['names']),
                                 edges=tuple(tuple(e) for e in v['edges']))
                 for k, v in manifest['skeletons'].items()}
        skeleton_registry = SkeletonRegistry(joint_info, infos)
    detector = None
    if detector_variables is not None:
        detector = detector_from_variables(detector_variables, manifest, bn_fold=bn_fold,
                                           device=device)
    bone_means = (np.asarray(manifest['bone_mean_lengths'], np.float32)
                  if manifest.get('bone_mean_lengths') else None)
    shardings = None
    if tp_min_size is not None:
        if mesh is None:
            raise ValueError('tp_min_size needs a mesh')
        shardings = tp_shardings(mesh, model, tp_min_size)
    return PoseEstimator(
        model, joint_info, cfg, aug_cfg=AugConfig(**manifest['aug_config']),
        skeleton_registry=skeleton_registry,
        joint_transform_matrix=joint_transform_matrix,
        detector=detector, bone_mean_lengths=bone_means, device=device, mesh=mesh,
        crop_state_shardings=shardings)


def load_pose_estimator(directory: str, device='cuda',
                        cfg_overrides: Optional[dict] = None,
                        backbone_builder=None, mesh=None,
                        tp_min_size: Optional[int] = None) -> PoseEstimator:
    """A `PoseEstimator` from a package directory, on `device`, with the
    package's detector when it has one (`detect_poses_batched`); `mesh`
    and `tp_min_size`: `pose_estimator_from_variables`'s."""
    device = checked_device(device)
    manifest = _read_manifest(directory)
    variables = load_model_msgpack(os.path.join(directory, 'crop_model.msgpack'))['variables']
    detector_variables = None
    if manifest.get('has_detector'):
        detector_variables = load_model_msgpack(
            os.path.join(directory, 'detector.msgpack'))['variables']
    joint_transform = None
    if manifest.get('has_joint_transform'):
        jt_path = os.path.join(directory, 'joint_transform.npy')
        if not os.path.exists(jt_path):
            raise FileNotFoundError(f'manifest declares a joint transform but {jt_path} '
                                    f'is missing; the package is incomplete')
        joint_transform = np.load(jt_path)
    return pose_estimator_from_variables(
        variables, manifest, device=device, cfg_overrides=cfg_overrides,
        joint_transform_matrix=joint_transform, detector_variables=detector_variables,
        backbone_builder=backbone_builder, mesh=mesh, tp_min_size=tp_min_size)


def _read_manifest(directory: str) -> dict:
    with open(os.path.join(directory, 'manifest.json')) as f:
        return json.load(f)


def _joint_info(manifest: dict) -> JointInfo:
    return JointInfo(names=tuple(manifest['joint_names']),
                     edges=tuple(tuple(e) for e in manifest['joint_edges']))
