"""Minted inputs and weights of the port's smoke run and its measuring
scripts, made from a seed with torch alone (no download):

- `synthetic_frames`, `synthetic_boxes`: N_FRAMES 1080p frames with smooth
  random structure, and person-like boxes (some invalid);
- `mint_state`, `mint_crop_variables`, `mint_detector_variables`,
  `firing_detector_variables`: weights at 0.8x He fan-in with random
  BatchNorm statistics, as JAX-layout variable trees that
  `io.packaging.pose_estimator_from_variables` loads;
- `manifest_for`, `detect_manifest_for`: the package manifests that go with
  them.

`chip_smoke.py` and `scripts/*_torch.py` import these; the same seed mints
the same bytes in both.
"""

import math

import numpy as np
import torch

SEED = 0
PROC_SIDE = 256
N_FRAMES, FRAME_H, FRAME_W = 8, 1080, 1920
BOXES_PER_FRAME = 16
DETECTOR_SIZE = 416


def synthetic_frames(gen: torch.Generator, dev) -> torch.Tensor:
    """[N, 1080, 1920, 3] uint8: smooth random structure plus pixel noise."""
    coarse = torch.rand((N_FRAMES, 3, 34, 60), generator=gen, device=dev)
    img = torch.nn.functional.interpolate(coarse, size=(FRAME_H, FRAME_W), mode='bicubic',
                                          align_corners=False)
    img = img * 235 + torch.rand(img.shape, generator=gen, device=dev) * 20
    return img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def mint_state(shapes, gen: torch.Generator):
    """A state dict for the meta tensors `shapes`: 0.8x He fan-in kernels,
    random BN statistics and affine, small random biases."""
    state = {}
    for name, meta in shapes.items():
        shape = tuple(meta.shape)
        if name.endswith('weight') and len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            v = torch.randn(shape, generator=gen) * (0.8 * math.sqrt(2.0 / fan_in))
        elif name.endswith('running_var'):
            v = torch.rand(shape, generator=gen) * 0.8 + 0.6
        elif name.endswith('weight'):
            v = torch.rand(shape, generator=gen) * 0.6 + 0.7
        else:
            v = torch.randn(shape, generator=gen) * 0.1
        state[name] = v
    return state


def mint_crop_variables(cfg, gen: torch.Generator, **crop_model_kwargs):
    """Flat, unfolded JAX-layout variables for `cfg` and the crop model of
    `crop_model_kwargs` (`build_crop_model`'s model class and latent mode),
    minted by `mint_state`, with a Metrabs 3D head that agrees with the 2D
    head (so the reconstruction places joints in front of the camera) and
    latent recombinations that are affine (each point's weights sum to 1)."""
    from metrabs_tpu_torch.io.weights import flax_variables_from_state_dict
    from metrabs_tpu_torch.models.metrabs import build_crop_model

    with torch.device('meta'):
        shapes = build_crop_model(cfg, **crop_model_kwargs).state_dict()
    state = mint_state(shapes, gen)
    for name in ('heatmap_heads.conv_final.weight', 'heatmap_heads.conv_final.bias'):
        if name in state:
            v = state[name]
            j = v.shape[0] // (1 + cfg.depth)
            v[j:] = v[:j].repeat((cfg.depth,) + (1,) * (v.ndim - 1)) + 0.05 * torch.randn(
                v[j:].shape, generator=gen)
    for name in ('recombination_weights', 'encoder_weights'):
        if name in state:
            v = torch.rand(state[name].shape, generator=gen)
            state[name] = v / v.sum(dim=0, keepdim=True)
    return flax_variables_from_state_dict(state)


# The H36M 17-joint skeleton.
JOINT_NAMES = ['pelv', 'rhip', 'rkne', 'rank', 'lhip', 'lkne', 'lank', 'spin', 'neck',
               'head', 'htop', 'lsho', 'lelb', 'lwri', 'rsho', 'relb', 'rwri']
JOINT_EDGES = [[0, 1], [1, 2], [2, 3], [0, 4], [4, 5], [5, 6], [0, 7], [7, 8], [8, 9],
               [9, 10], [8, 11], [11, 12], [12, 13], [8, 14], [14, 15], [15, 16]]


def manifest_for(dtype: str, backbone: str = 'efficientnetv2-s',
                 proc_side: int = PROC_SIDE) -> dict:
    """A package manifest for the minted crop model (H36M-17 joints)."""
    return dict(
        format_version=1,
        model_config=dict(proc_side=proc_side, backbone=backbone, n_joints=17,
                          dtype=dtype, backbone_scan_blocks=False),
        aug_config={}, joint_names=JOINT_NAMES, joint_edges=JOINT_EDGES,
        has_detector=False)


def synthetic_boxes():
    """[8, 16, 4] person-like boxes inside the frames and their validity; 3
    per frame invalid, one of them the degenerate [0, 0, 0, 0]."""
    g = np.random.default_rng(SEED + 1)
    h = g.uniform(150, 1000, (N_FRAMES, BOXES_PER_FRAME))
    w = h * g.uniform(0.35, 0.6, h.shape)
    x = g.uniform(0, 1, h.shape) * (FRAME_W - w)
    y = g.uniform(0, 1, h.shape) * (FRAME_H - h)
    boxes = np.stack([x, y, w, h], axis=-1).astype(np.float32)
    valid = np.ones(h.shape, bool)
    valid[:, [3, 9, 15]] = False
    boxes[:, 15] = 0.0
    return boxes, valid


def detect_manifest_for(dtype: str, **crop_model: str) -> dict:
    """The manifest with a YOLOv4-416 detector in `dtype` (flat layout);
    `crop_model`: `manifest_for`'s backbone and proc_side."""
    return dict(manifest_for(dtype, **crop_model), has_detector=True, detector_type='yolov4',
                detector_dtype=dtype, detector_input_size=DETECTOR_SIZE,
                detector_scan_repeats=False)


def mint_detector_variables(gen: torch.Generator, kind: str = 'yolov4'):
    """Flat, unfolded JAX-layout variables of a detector of `kind`, minted by
    `mint_state`."""
    from metrabs_tpu_torch.detect.yolov4 import build_detector_model
    from metrabs_tpu_torch.io.weights import flax_variables_from_state_dict

    with torch.device('meta'):
        shapes = build_detector_model(kind).state_dict()
    return flax_variables_from_state_dict(mint_state(shapes, gen))


# Added to the objectness and person-class logits of every YOLOv4 head of a
# minted detector, so that its scores pass a driver's fixed threshold (0.2
# in predict_3dpw and predict_mupots): a random head's scores sit near
# sigmoid(0)^2 = 0.25 with a wide spread, and many frames would have no box.
DETECTOR_FIRE_BIAS = 3.0


def firing_detector_variables(gen: torch.Generator, kind: str = 'yolov4'):
    """`mint_detector_variables` with DETECTOR_FIRE_BIAS added to each head's
    objectness and person logits (channels 4 and 5 of each anchor's 85)."""
    variables = mint_detector_variables(gen, kind)
    for layer in variables['params'].values():
        conv_bias = layer.get('conv', {}).get('bias') if isinstance(layer, dict) else None
        if conv_bias is not None and conv_bias.shape == (3 * 85,):
            conv_bias = np.array(conv_bias, copy=True)
            conv_bias.reshape(3, 85)[:, 4:6] += np.float32(DETECTOR_FIRE_BIAS)
            layer['conv']['bias'] = conv_bias
    return variables


def minted_crop_model(backbone: str, proc_side: int, device, dtype: str = 'bfloat16',
                      bn_fold=None, fuse_mbconv: str = 'off', seed: int = SEED):
    """(the eval-mode Metrabs crop model of `backbone` at `proc_side` with
    weights minted from `seed`, loaded as a package loads it, on `device`;
    its ModelConfig). `bn_fold` None folds where the family folds, unless
    `fuse_mbconv` is 'on' (K2 runs on unfolded BN only)."""
    import functools

    from metrabs_tpu_torch.config import ModelConfig
    from metrabs_tpu_torch.io.packaging import crop_model_from_variables
    from metrabs_tpu_torch.models.backbones.builder import (
        backbone_supports_bn_fold, build_backbone)

    manifest = manifest_for(dtype, backbone, proc_side)
    variables = mint_crop_variables(ModelConfig(**manifest['model_config']),
                                    torch.Generator().manual_seed(seed))
    if bn_fold is None:
        bn_fold = backbone_supports_bn_fold(backbone) and fuse_mbconv == 'off'
    builder = None if fuse_mbconv == 'off' else functools.partial(build_backbone,
                                                                  fuse_mbconv=fuse_mbconv)
    return crop_model_from_variables(variables, manifest, scan_blocks=False, bn_fold=bn_fold,
                                     device=device, backbone_builder=builder)


def minted_estimator(device, backbone: str = 'efficientnetv2-s', proc_side: int = PROC_SIDE,
                     dtype: str = 'bfloat16', detector: bool = False, k2: bool = False,
                     seed: int = SEED, detector_dtype: str = ''):
    """A PoseEstimator of a minted crop model (and with `detector` a minted
    YOLOv4-416 in `detector_dtype`, default `dtype`), as `load_pose_estimator`
    builds it: BN folded, or
    with `k2` unfolded with `fuse_mbconv='on'`. The crop weights, then the
    detector's, come from one generator seeded with `seed`, as chip_smoke's
    main and detect cells mint theirs."""
    import functools

    from metrabs_tpu_torch.config import ModelConfig
    from metrabs_tpu_torch.io.packaging import pose_estimator_from_variables
    from metrabs_tpu_torch.models.backbones.builder import build_backbone

    gen = torch.Generator().manual_seed(seed)
    manifest = (detect_manifest_for(dtype, backbone=backbone, proc_side=proc_side) if detector
                else manifest_for(dtype, backbone, proc_side))
    if detector and detector_dtype:
        manifest['detector_dtype'] = detector_dtype
    variables = mint_crop_variables(ModelConfig(**manifest['model_config']), gen)
    kwargs = dict(cfg_overrides={'bn_fold': False},
                  backbone_builder=functools.partial(build_backbone, fuse_mbconv='on')) \
        if k2 else {}
    return pose_estimator_from_variables(
        variables, manifest, device=device,
        detector_variables=mint_detector_variables(gen) if detector else None, **kwargs)


def minted_trainer(backbone: str, proc_side: int, device, dtype: str = 'bfloat16',
                   remat: bool = True, remat_until_block: int = 10_000,
                   bn_bf16_stats: bool = False, mu_dtype: str = '', seed: int = SEED,
                   model_config=None, **train_config):
    """(train state on `device`, train step, ModelConfig, TrainConfig) of
    Metrabs on `backbone` at `proc_side` (H36M-17 3D and LSP-14 2D joints,
    depth 8 unless `model_config` gives other fields), weights minted from
    `seed`, AdamW + EMA of TrainConfig (its defaults, `training_steps`
    400000, updated by `train_config`), blocks rematerialised below
    `remat_until_block` where `remat`, BN batch statistics in bf16 where
    `bn_bf16_stats` (EfficientNetV2), the first moment in `mu_dtype`."""
    import functools

    from metrabs_tpu_torch.config import ModelConfig, TrainConfig
    from metrabs_tpu_torch.io.weights import crop_model_state_dict_from_flax
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    from metrabs_tpu_torch.models.metrabs import build_crop_model
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17, LSP_14
    from metrabs_tpu_torch.train import loop, optim

    cfg = ModelConfig(**dict(dict(proc_side=proc_side, backbone=backbone, n_joints=17, depth=8,
                                  dtype=dtype, backbone_remat=remat,
                                  backbone_scan_blocks=False), **(model_config or {})))
    tcfg = TrainConfig(**dict(dict(training_steps=400_000, optimizer_mu_dtype=mu_dtype),
                              **train_config))
    builder = functools.partial(build_backbone, bn_bf16_stats=True) if bn_bf16_stats else None
    model = build_crop_model(cfg, builder)
    model.backbone.remat_until_block = remat_until_block  # read at each forward
    variables = mint_crop_variables(cfg, torch.Generator().manual_seed(seed))
    model.load_state_dict(crop_model_state_dict_from_flax(variables, cfg))
    optimizer = optim.Optimizer(tcfg)
    state = loop.create_train_state(model, optimizer, device=device)
    return state, loop.make_train_step(model, optimizer, H36M_17, LSP_14, cfg, tcfg), cfg, tcfg


def random_train_batches(n: int, side: int, rng: np.random.Generator, device):
    """The JAX profiling scripts' (3D, 2D) batches of `n` examples each
    (`scripts/profile_trace_train.py`): uniform images, a 250 px focal
    length, 17 joints ~200 mm around a root 3 m away, 14 2D joints inside
    the crop, every joint valid; tensors on `device`."""
    k = np.array([[250.0, 0, side / 2], [0, 250.0, side / 2], [0, 0, 1]], np.float32)
    t = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    batch3d = dict(
        image=t(rng.uniform(size=(n, side, side, 3))), intrinsics=t(np.tile(k, (n, 1, 1))),
        coords3d_true=t(rng.normal(size=(n, 17, 3)) * 200 + np.array([0, 0, 3000])),
        joint_validity_mask=t(np.ones((n, 17), bool), torch.bool))
    batch2d = dict(
        image=t(rng.uniform(size=(n, side, side, 3))), intrinsics=t(np.tile(k, (n, 1, 1))),
        coords2d_true=t(rng.uniform(10, side - 10, size=(n, 14, 2))),
        joint_validity_mask=t(np.ones((n, 14), bool), torch.bool))
    return batch3d, batch2d
