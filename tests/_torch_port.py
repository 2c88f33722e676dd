"""Shared fixtures for the parity tests of `metrabs_tpu_torch` against
`metrabs_tpu` (tests/test_torch_*.py).

`make_package` writes a small JAX pose-estimator package: EffNetV2-S at
proc_side 64 (a multiple of 32, so the tiled warp runs in interpret mode),
float32, 17 joints, with weights minted from a numpy seed, and optionally a
person detector (YOLOv4 or YOLOv4-tiny, scanned layout as packaged by
default). Kernels are He fan-in normal scaled by 0.8 and BatchNorm gets
non-trivial random scale, bias, mean and variance: flat-scale random nets
ignore their input (PARITY.md, methodology note), so each parity test also
checks that two inputs give clearly different outputs.
`make_family_package` writes the same kind of package for any backbone
family, crop-model class and latent mode, with any detector.
"""

from __future__ import annotations

import functools

import numpy as np

PROC_SIDE = 64
DEPTH = 8  # ModelConfig.depth


def crop_cfg(scan_blocks: bool, **kwargs):
    from metrabs_tpu.config import ModelConfig
    return ModelConfig(proc_side=PROC_SIDE, n_joints=17, dtype='float32',
                       backbone='efficientnetv2-s', warp_backend='gather',
                       backbone_scan_blocks=scan_blocks, **kwargs)


def mint_variables(shapes, rng: np.random.Generator):
    """Random variables with the structure of `shapes` (a tree of
    ShapeDtypeStructs): 0.8x He kernels, random BN affine and statistics."""
    import flax

    flat = {}
    for key, s in flax.traverse_util.flatten_dict(shapes).items():
        leaf = key[-1]
        if leaf == 'kernel':
            fan_in = int(np.prod(s.shape[-4:-1]))
            v = rng.normal(0.0, 0.8 * np.sqrt(2.0 / fan_in), s.shape)
        elif leaf == 'scale':
            v = rng.uniform(0.7, 1.3, s.shape)
        elif leaf in ('bias', 'mean'):
            v = rng.normal(0.0, 0.1, s.shape)
        elif leaf == 'var':
            v = rng.uniform(0.6, 1.4, s.shape)
        elif leaf in ('recombination_weights', 'encoder_weights'):
            # Affine combinations: each output point's weights sum to 1.
            v = rng.uniform(0.0, 1.0, s.shape)
            v /= v.sum(axis=0, keepdims=True)
        else:
            raise ValueError(f'unexpected variable {key}')
        flat[key] = v.astype(np.float32)
    # Make the 3D head agree with the 2D head, as in a trained model: the 3D
    # logits of joint j are its 2D logits plus a little depth noise. Then the
    # reconstruction places every joint metres in front of the camera, where
    # the 2D projection is well-conditioned (a random 2D/3D pair can put
    # joints at z ~ 0, whose projection amplifies f32 rounding without bound).
    if ('params', 'heatmap_heads', 'conv_final', 'kernel') not in flat:
        return flax.traverse_util.unflatten_dict(flat)  # not a crop model
    for leaf in ('kernel', 'bias'):
        key = ('params', 'heatmap_heads', 'conv_final', leaf)
        v = flat[key]
        n_joints = v.shape[-1] // (1 + DEPTH)
        v2d = v[..., :n_joints]
        v[..., n_joints:] = (np.tile(v2d, DEPTH)
                             + 0.05 * rng.normal(size=v2d.shape[:-1] + (DEPTH * n_joints,)))
    return flax.traverse_util.unflatten_dict(flat)


def scanned_variables(seed: int = 0):
    """(cfg, variables) of the scanned-layout crop model, minted from `seed`."""
    import jax
    import jax.numpy as jnp
    from metrabs_tpu.models.backbones.builder import build_backbone
    from metrabs_tpu.models.metrabs import Metrabs

    cfg = crop_cfg(scan_blocks=True)
    model = Metrabs(cfg=cfg, backbone=build_backbone(
        cfg.backbone, dtype=jnp.float32, scan_blocks=True))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, PROC_SIDE, PROC_SIDE, 3)), jnp.eye(3)[None])
    return cfg, mint_variables(shapes, np.random.default_rng(seed))


def detector_variables(kind: str = 'yolov4', scan_repeats: bool = True, seed: int = 1,
                       size: int = 96):
    """Variables of a JAX detector (`detect.yolov4.build_detector_model`),
    minted from `seed` like the crop model's."""
    import jax
    import jax.numpy as jnp
    from metrabs_tpu.detect.yolov4 import build_detector_model

    model = build_detector_model(kind, dtype=jnp.float32, scan_repeats=scan_repeats)
    shapes = jax.eval_shape(functools.partial(model.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    return mint_variables(shapes, np.random.default_rng(seed))


def make_package(directory: str, scanned: bool, seed: int = 0, detector: str = '',
                 detector_input_size: int = 96, bone_mean_lengths=None) -> str:
    """Writes a JAX package (scanned or flat backbone layout, same weights),
    with a float32 `detector` ('yolov4' or 'yolov4-tiny', scanned layout) if
    one is named, and the plausibility filter's `bone_mean_lengths` if given."""
    import dataclasses

    from metrabs_tpu.config import AugConfig
    from metrabs_tpu.io.packaging import save_pose_estimator_package
    from metrabs_tpu.io.scan_convert import scanned_to_flat
    from metrabs_tpu.pipeline.skeletons import H36M_17

    cfg, variables = scanned_variables(seed)
    if not scanned:
        variables = scanned_to_flat(variables)
        cfg = dataclasses.replace(cfg, backbone_scan_blocks=False)
    det = {}
    if detector:
        det = dict(detector_variables=detector_variables(detector, seed=seed + 1),
                   detector_type=detector, detector_dtype='float32',
                   detector_input_size=detector_input_size)
    save_pose_estimator_package(directory, cfg=cfg, aug_cfg=AugConfig(),
                                crop_model_variables=variables, joint_info=H36M_17,
                                bone_mean_lengths=bone_mean_lengths, **det)
    return directory


def family_cfg(backbone: str, **kwargs):
    """A flat-layout float32 crop-model config at 64 px for `backbone`."""
    from metrabs_tpu.config import ModelConfig
    return ModelConfig(proc_side=PROC_SIDE, n_joints=17, dtype='float32', backbone=backbone,
                       warp_backend='gather', backbone_scan_blocks=False, **kwargs)


def bones_25d():
    """(bones, ideal lengths in mm) for Model25D on H36M-17."""
    from metrabs_tpu.pipeline.skeletons import H36M_17
    lengths = np.random.default_rng(7).uniform(150.0, 450.0, len(H36M_17.edges))
    return tuple(tuple(map(int, e)) for e in H36M_17.edges), tuple(float(x) for x in lengths)


def family_model(cfg, model_class: str = 'metrabs', latent_mode: str = '',
                 n_latents: int = 0):
    """The JAX crop model of `model_class` on `cfg.backbone` (flat, unfolded)."""
    import jax.numpy as jnp
    from metrabs_tpu.models.backbones.builder import build_backbone
    backbone = build_backbone(cfg.backbone, dtype=jnp.float32, scan_blocks=False,
                              stride_test=(cfg.stride_test if cfg.stride_test != cfg.stride_train
                                           else None))
    if model_class == 'metro':
        from metrabs_tpu.models.metro import Metro
        return Metro(cfg=cfg, backbone=backbone)
    if model_class == 'model25d':
        from metrabs_tpu.models.model25d import Model25D
        bones, lengths = bones_25d()
        return Model25D(cfg=cfg, backbone=backbone, bones=bones, bone_lengths_ideal=lengths)
    from metrabs_tpu.models.metrabs import Metrabs
    return Metrabs(cfg=cfg, backbone=backbone, latent_mode=latent_mode, n_latents=n_latents)


def family_variables(model, model_class: str = 'metrabs', seed: int = 0):
    """Variables of a JAX crop model from `family_model`, minted from `seed`."""
    import jax
    import jax.numpy as jnp
    x = jnp.zeros((1, PROC_SIDE, PROC_SIDE, 3))
    args = (x,) if model_class == 'metro' else (x, jnp.eye(3)[None])
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    return mint_variables(shapes, np.random.default_rng(seed))


def make_family_package(directory: str, backbone: str, model_class: str = 'metrabs',
                        latent_mode: str = '', n_latents: int = 0, detector: str = '',
                        detector_input_size: int = 96, seed: int = 0,
                        bone_mean_lengths=None) -> str:
    """Writes a JAX package of any crop-model class on any backbone family
    (flat layout, float32, 64 px), with a float32 `detector` if one is named."""
    from metrabs_tpu.config import AugConfig
    from metrabs_tpu.io.packaging import save_pose_estimator_package
    from metrabs_tpu.pipeline.skeletons import H36M_17

    cfg = family_cfg(backbone)
    model = family_model(cfg, model_class, latent_mode, n_latents)
    extra = {}
    if model_class == 'model25d':
        extra = dict(zip(('bones_25d', 'bone_lengths_ideal'), bones_25d()))
    if detector:
        extra.update(detector_variables=detector_variables(detector, seed=seed + 1),
                     detector_type=detector, detector_dtype='float32',
                     detector_input_size=detector_input_size)
    save_pose_estimator_package(
        directory, cfg=cfg, aug_cfg=AugConfig(), joint_info=H36M_17,
        crop_model_variables=family_variables(model, model_class, seed),
        bone_mean_lengths=bone_mean_lengths, latent_mode=latent_mode, n_latents=n_latents,
        model_class=model_class, **extra)
    return directory


def camera(h: int, w: int, f: float = 300.0) -> np.ndarray:
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


# Warp cases of tests/test_warp_pallas.py, as numpy.

def random_case(rng, n_img=2, n_crops=5, h=200, w=260, out=(64, 128),
                scale_range=(0.3, 1.4), distort=False):
    """The geometry of tests/test_warp_pallas.py::_random_case, as numpy."""
    images = rng.uniform(size=(n_img, h, w, 3)).astype(np.float32)
    scales = rng.uniform(*scale_range, size=n_crops).astype(np.float32)
    angles = rng.uniform(-0.6, 0.6, size=n_crops).astype(np.float32)
    cx = rng.uniform(0, w, size=n_crops).astype(np.float32)
    cy = rng.uniform(0, h, size=n_crops).astype(np.float32)
    image_ids = rng.integers(0, n_img, size=n_crops).astype(np.int32)
    k_old = np.tile(np.array([[300.0, 0, w / 2], [0, 300.0, h / 2], [0, 0, 1]], np.float32),
                    (n_crops, 1, 1))
    invproj = np.zeros((n_crops, 3, 3), np.float32)
    for i in range(n_crops):
        c, s = np.cos(angles[i]), np.sin(angles[i])
        a = np.array([[c, -s], [s, c]], np.float32) / scales[i]
        t = np.array([cx[i], cy[i]]) - a @ np.array([out[1] / 2, out[0] / 2])
        m = np.eye(3, dtype=np.float32)
        m[:2, :2] = a
        m[:2, 2] = t
        invproj[i] = np.linalg.inv(k_old[i]) @ m
    dist = np.zeros((n_crops, 12), np.float32)
    if distort:
        dist[:, 0] = rng.uniform(-0.2, 0.2, size=n_crops)
        dist[:, 1] = rng.uniform(-0.05, 0.05, size=n_crops)
        dist[:, 2:4] = rng.uniform(-0.01, 0.01, size=(n_crops, 2))
    return dict(images=images, intrinsic_matrix=k_old, new_invprojmat=invproj,
                distortion_coeffs=dist, crop_scales=scales, image_ids=image_ids,
                output_shape=out)


def worst_case_footprints(rng):
    """In-level scale just above 0.5 with rotations sweeping the span maximum."""
    n_crops, h, w, out = 12, 300, 400, (64, 64)
    angles = np.deg2rad([0, 14, 26, 45, 76, 90] * 2).astype(np.float32)
    scales = np.full(n_crops, 0.505, np.float32)
    k_old = np.tile(np.array([[300.0, 0, w / 2], [0, 300.0, h / 2], [0, 0, 1]], np.float32),
                    (n_crops, 1, 1))
    invproj = np.zeros((n_crops, 3, 3), np.float32)
    for i in range(n_crops):
        c, s = np.cos(angles[i]), np.sin(angles[i])
        a = np.array([[c, -s], [s, c]], np.float32) / scales[i]
        m = np.eye(3, dtype=np.float32)
        m[:2, :2] = a
        m[:2, 2] = np.array([w / 2, h / 2]) - a @ np.array([out[1] / 2, out[0] / 2])
        invproj[i] = np.linalg.inv(k_old[i]) @ m
    return dict(images=rng.uniform(size=(1, h, w, 3)).astype(np.float32),
                intrinsic_matrix=k_old, new_invprojmat=invproj,
                distortion_coeffs=np.zeros((n_crops, 12), np.float32),
                crop_scales=scales, image_ids=np.zeros(n_crops, np.int32), output_shape=out)


def make_case(name, rng):
    if name == 'basic':
        return random_case(rng)
    if name == 'distorted':
        return random_case(rng, distort=True)
    if name == 'zoom_in':
        return random_case(rng, scale_range=(1.5, 3.0))
    if name == 'heavy_minification':
        return random_case(rng, scale_range=(0.15, 0.3))
    if name == 'zero_border':
        case = random_case(rng)
        case['new_invprojmat'][:, :2, 2] += 10.0  # ~3000 px away: all zero border
        return case
    if name == 'crop_256':
        return random_case(rng, n_img=1, n_crops=2, h=400, w=640, out=(256, 256),
                           scale_range=(0.5, 1.2))
    return worst_case_footprints(rng)


CASES = ['basic', 'distorted', 'zoom_in', 'heavy_minification', 'zero_border', 'crop_256',
         'worst_case_footprints']
