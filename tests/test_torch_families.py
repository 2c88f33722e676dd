"""Every model family end to end: packages written by the JAX package's
`save_pose_estimator_package` give the same poses through JAX's
`load_pose_estimator` and the port's (on the CPU), and a package the port
writes loads in JAX.

Packages (64 px crops, float32, weights minted from numpy seeds,
`_torch_port.make_family_package`): MobileNetV3-Small (BN folded by both
loaders' default), ResNet-50 V1.5-GroupNorm (unfoldable), Model25D and both
latent modes of Metrabs on MobileNetV3-Small-mini, and a YOLOv8-n at 96 px
with the MobileNetV3-Small-mini crop model for `detect_poses_batched`.
Metro is held as a bare crop model (`load_crop_model`); both estimator
loaders refuse it. Inputs and tolerances as tests/test_torch_estimator.py
and tests/test_torch_detect_poses.py: poses3d atol 1 mm + rtol 1e-3,
poses2d 0.1 px (detect path: of joints at least 200 mm in front of the
camera), detected boxes within 1e-3 px, masks identical. Each case also
checks that other frames move the poses ten times further than the port is
from JAX.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from metrabs_tpu.io import packaging as jax_packaging
from metrabs_tpu_torch.config import AugConfig, ModelConfig
from metrabs_tpu_torch.io import packaging, weights
from metrabs_tpu_torch.models.backbones.builder import backbone_supports_bn_fold
from metrabs_tpu_torch.models.metro import Metro
from metrabs_tpu_torch.pipeline.skeletons import H36M_17
from tests import _torch_port
from tests.test_torch_detect_poses import BOXES_PX, MIN_DEPTH_MM
from tests.test_torch_estimator import compare, frames_and_boxes
from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SMALL = 'mobilenetv3-small-mini'
BONE_MEANS = np.full(16, 700.0, np.float32)
CASES = {
    'mobilenetv3_small': dict(backbone='mobilenetv3-small'),
    'resnet50v1_5_groupnorm': dict(backbone='resnet50v1-5-groupnorm'),
    'model25d': dict(backbone=SMALL, model_class='model25d'),
    'latent_transform_coords': dict(backbone=SMALL, latent_mode='transform_coords',
                                    n_latents=24),
    'latent_predict_all_and_latents': dict(backbone=SMALL,
                                           latent_mode='predict_all_and_latents',
                                           n_latents=24),
}


@functools.lru_cache(maxsize=None)
def package(root, name):
    kwargs = dict(detector='yolov8n', backbone=SMALL) if name == 'yolov8' else CASES.get(
        name, dict(backbone=SMALL, model_class='metro'))
    return _torch_port.make_family_package(f'{root}/{name}', bone_mean_lengths=BONE_MEANS,
                                           **kwargs)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp('families'))


def sensitivity(est, got, want, boxes, valid, **kwargs):
    other = est.estimate_poses_batched(frames_and_boxes(seed=1)[0], boxes, valid, **kwargs)
    moved = np.abs(other['poses3d'].numpy() - got['poses3d'].numpy())[valid].max()
    assert moved > 10 * np.abs(got['poses3d'].numpy() - np.asarray(want['poses3d']))[valid].max()


@pytest.mark.parametrize('name', sorted(CASES))
def test_estimate_poses_batched_matches_jax(root, name):
    pkg = package(root, name)
    jest = jax_packaging.load_pose_estimator(pkg)
    est = packaging.load_pose_estimator(pkg, device='cpu')
    folded = backbone_supports_bn_fold(CASES[name]['backbone'])
    assert est.cfg.bn_fold == jest.cfg.bn_fold == folded
    frames, boxes, valid = frames_and_boxes()
    kwargs = dict(num_aug=2, average_aug=False)
    want = jest.estimate_poses_batched(frames, boxes, valid, **kwargs)
    got = est.estimate_poses_batched(frames, boxes, valid, **kwargs)
    compare(got, want, valid)
    sensitivity(est, got, want, boxes, valid, **kwargs)


def test_detect_poses_batched_with_yolov8_matches_jax(root):
    pkg = package(root, 'yolov8')
    jest = jax_packaging.load_pose_estimator(pkg)
    est = packaging.load_pose_estimator(pkg, device='cpu')
    assert type(est.detector.model).__name__ == 'YOLOv8' and est.detector.input_size == 96
    frames = frames_and_boxes()[0]
    boxes5, _ = est.detector.detect_batched(torch.as_tensor(frames), threshold=0.0,
                                            max_detections=6)
    # Halfway across the widest gap between frame 0's 2nd to 6th scores: a
    # mixed mask, no score near the threshold (the random detector's person
    # scores lie within ~1e-3 of each other; the two sides agree to ~1e-7).
    s = boxes5[0, :, 4].numpy()
    i = 1 + int(np.argmax(s[1:5] - s[2:6]))
    assert s[i] - s[i + 1] > 1e-5
    kwargs = dict(num_aug=2, max_detections=6, detector_threshold=float(s[i] + s[i + 1]) / 2,
                  suppress_implausible_poses=False)
    want = jest.detect_poses_batched(frames, **kwargs)
    got = est.detect_poses_batched(frames, **kwargs)
    valid = np.asarray(want['valid'])
    compare(got, want, valid, boxes_tol=BOXES_PX, min_depth_2d=MIN_DEPTH_MM)
    assert 0 < valid.sum() < valid.size


def test_metro_loads_as_a_crop_model_only(root):
    pkg = package(root, 'metro')
    jmodel, jvars, _, _, _ = jax_packaging.load_crop_model(pkg)
    model, cfg, _, manifest = packaging.load_crop_model(pkg, device='cpu')
    assert isinstance(model, Metro) and manifest['model_class'] == 'metro'
    x = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(jvars, x, train=False))
    with torch.no_grad():
        got = model(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    for load in (jax_packaging.load_pose_estimator,
                 functools.partial(packaging.load_pose_estimator, device='cpu')):
        with pytest.raises(ValueError, match='Metro predicts root-relative poses only'):
            load(pkg)


@pytest.mark.parametrize('name', ['model25d', 'latent_transform_coords', 'metro'])
def test_port_written_package_loads_in_jax(root, tmp_path, name):
    """The port's `save_pose_estimator_package` writes the class, the latent
    mode and the 2.5D bones; JAX's loader builds the same model from it."""
    src = package(root, name)
    model, cfg, _, manifest = packaging.load_crop_model(src, device='cpu')
    kwargs = packaging.crop_model_kwargs(manifest)
    out = str(tmp_path / 'out')
    packaging.save_pose_estimator_package(
        out, cfg=cfg, aug_cfg=AugConfig(), joint_info=H36M_17,
        crop_model_variables=weights.flax_variables_from_state_dict(model.state_dict()),
        latent_mode=kwargs['latent_mode'], n_latents=kwargs['n_latents'],
        model_class=kwargs['model_class'],
        bones_25d=kwargs['bones'] or None, bone_lengths_ideal=kwargs['bone_lengths_ideal'] or None)
    jmodel, jvars, jcfg, _, jmanifest = jax_packaging.load_crop_model(out)
    for key in ('model_class', 'latent_mode', 'n_latents', 'bones_25d', 'bone_lengths_ideal'):
        assert jmanifest[key] == manifest[key], key
    assert type(jmodel).__name__ == type(model).__name__
    x = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    k = np.stack([_torch_port.camera(64, 64, 80.0)] * 2)
    args = (x,) if name == 'metro' else (x, k)
    want = np.asarray(jmodel.apply(jvars, *args, train=False))
    with torch.no_grad():
        got = model(*(torch.tensor(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, atol=1.0, rtol=1e-3)


def test_model25d_package_needs_its_bones(tmp_path):
    cfg = ModelConfig(backbone=SMALL, backbone_scan_blocks=False)
    with pytest.raises(ValueError, match='bones_25d'):
        packaging.save_pose_estimator_package(
            str(tmp_path / 'p'), cfg=cfg, aug_cfg=AugConfig(), crop_model_variables={},
            joint_info=H36M_17, model_class='model25d')
    with pytest.raises(ValueError, match='model_class'):
        packaging.crop_model_from_variables(
            {}, dict(model_config=dataclasses.asdict(cfg), model_class='metro3d'),
            device='cpu')
