"""The slice end to end: `load_pose_estimator(pkg).estimate_poses_batched`
of `metrabs_tpu_torch` (on the CPU) against that of
`metrabs_tpu`, on a JAX-written package (EffNetV2-S at 64 px, scanned
layout, so both loaders unroll it and fold its BatchNorm). The detect path,
with a YOLOv4 inside the package, is in tests/test_torch_detect_poses.py.

Inputs: 2 frames of 240x320 uint8 with 3 boxes each, one of them a
degenerate [0, 0, 0, 0] box with box_valid False. Tolerances on valid boxes:
poses3d atol 1 mm + rtol 1e-3 (README's bound for the TF oracle), poses2d
atol 0.1 px, valid identical. The JAX side runs its gather warp,
and in one case the TPU kernel's code path (warp_backend='tiled-interpret');
the fused-MBConv case runs the TPU kernel K2 in interpret mode.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from metrabs_tpu.io.packaging import load_pose_estimator as jax_load_pose_estimator
from metrabs_tpu.models.backbones.builder import build_backbone as jax_build_backbone
from metrabs_tpu_torch.io.packaging import load_pose_estimator
from metrabs_tpu_torch.models.backbones.builder import build_backbone
from metrabs_tpu_torch.ops import mbconv, mbconv_cuda, warp_cuda
from tests import _torch_port
from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

# One intra-op thread: under the suite's parallel workers more threads
# oversubscribe the cores.
pytestmark = pytest.mark.usefixtures('one_torch_thread')

POSES3D = dict(atol=1.0, rtol=1e-3)
POSES2D = dict(atol=0.1, rtol=0)


@pytest.fixture(scope='module')
def package(tmp_path_factory):
    return _torch_port.make_package(str(tmp_path_factory.mktemp('pkg') / 'p'), scanned=True)


@pytest.fixture(scope='module')
def estimators(package):
    with pytest.warns(UserWarning, match='bone_mean_lengths'):
        jax_gather = jax_load_pose_estimator(package)
        jax_tiled = jax_load_pose_estimator(
            package, cfg_overrides={'warp_backend': 'tiled-interpret'})
    return dict(gather=jax_gather, tiled=jax_tiled,
                torch=load_pose_estimator(package, device='cpu'))


def frames_and_boxes(seed=0):
    """Frames with smooth random structure plus pixel noise: unlike pure
    noise, two seeds give genuinely different scenes."""
    rng = np.random.default_rng(seed)
    coarse = torch.tensor(rng.uniform(0, 255, size=(2, 3, 6, 8)), dtype=torch.float32)
    smooth = torch.nn.functional.interpolate(coarse, size=(240, 320), mode='bilinear',
                                             align_corners=False)
    noisy = smooth.permute(0, 2, 3, 1).numpy() + rng.normal(0, 10, size=(2, 240, 320, 3))
    frames = np.clip(noisy, 0, 255).astype(np.uint8)
    boxes = np.array([[[40, 30, 90, 170], [150, 50, 100, 160], [0, 0, 0, 0]],
                      [[100, 20, 80, 200], [0, 0, 0, 0], [10, 100, 120, 120]]], np.float32)
    valid = np.array([[True, True, False], [True, False, True]])
    return frames, boxes, valid


def tilted_extrinsics():
    a = 0.3
    ext = np.eye(4, dtype=np.float32)
    ext[1:3, 1:3] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    ext[:3, 3] = [100.0, -200.0, 500.0]
    return ext


K = _torch_port.camera(240, 320, 280.0)
# Each distinct num_aug/average_aug/chunking/antialias/skeleton combination
# compiles the JAX pipeline anew (~5 s here), so the cases share them where
# they can: camera arguments are traced, not compiled in.
CASES = {
    'aug1': dict(num_aug=1),
    'aug5_per_aug': dict(num_aug=5, average_aug=False),
    'distortion': dict(num_aug=2, intrinsic_matrix=K,
                       distortion_coeffs=np.array([-0.15, 0.04, 0.003, -0.002, 0.01],
                                                  np.float32)),
    'tilted_world': dict(num_aug=2, extrinsic_matrix=tilted_extrinsics(),
                         world_up_vector=(0, -1, 0)),
    # 2 boxes per chunk: the trailing chunk holds only invalid boxes and is
    # skipped (filled with [0, 0, 1000]) after the valid-first compaction.
    'chunked_antialias_skeleton': dict(num_aug=2, internal_batch_size=4,
                                       antialias_factor=2, skeleton='lsp_14'),
}


def compare(got, want, valid, boxes_tol=None, min_depth_2d=None):
    """`boxes_tol` None: the boxes are the caller's and pass through exactly;
    detected boxes are compared within `boxes_tol`. `min_depth_2d` (mm):
    poses2d only of joints at least that far in front of the camera (camera
    and world coincide); nearer, the projection scales the 3D difference by
    f / z without bound."""
    assert set(got) == set(want)
    np.testing.assert_array_equal(got['valid'].numpy(), np.asarray(want['valid']))
    if boxes_tol is None:
        np.testing.assert_array_equal(got['boxes'].numpy(), np.asarray(want['boxes']))
    else:
        np.testing.assert_allclose(got['boxes'].numpy(), np.asarray(want['boxes']), **boxes_tol)
    for key, tol in (('poses3d', POSES3D), ('poses2d', POSES2D)):
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        mask = valid
        if key == 'poses2d' and min_depth_2d is not None:
            depth = np.asarray(want['poses3d'])[..., 2]
            mask = valid.reshape(valid.shape + (1,) * (depth.ndim - valid.ndim)) & (
                depth > min_depth_2d)
        np.testing.assert_allclose(g[mask], w[mask], **tol)
        assert np.isfinite(g[mask]).all()


@pytest.fixture(scope='module')
def jax_results(estimators):
    """JAX's `estimate_poses_batched` of each case on the default frames,
    run once and shared by the tests that hold the port against it."""
    frames, boxes, valid = frames_and_boxes()
    cache = {}

    def result(name):
        if name not in cache:
            cache[name] = estimators['gather'].estimate_poses_batched(frames, boxes, valid,
                                                                      **CASES[name])
        return cache[name]
    return result


@pytest.mark.parametrize('name', sorted(CASES))
def test_estimate_poses_batched_matches_jax(estimators, jax_results, name):
    frames, boxes, valid = frames_and_boxes()
    kwargs = CASES[name]
    want = jax_results(name)
    got = estimators['torch'].estimate_poses_batched(frames, boxes, valid, **kwargs)
    compare(got, want, valid)
    # Input sensitivity: another frame moves the poses far beyond the tolerance.
    other = estimators['torch'].estimate_poses_batched(
        frames_and_boxes(seed=1)[0], boxes, valid, **kwargs)
    assert np.abs(other['poses3d'].numpy() - got['poses3d'].numpy())[valid].max() > 50


def test_aug_average_matches_jax(estimators, jax_results):
    """average_aug=True is the mean over the aug axis of the per-aug result."""
    frames, boxes, valid = frames_and_boxes()
    want = jax_results('aug5_per_aug')
    want = {k: (np.asarray(v).mean(axis=-3) if k.startswith('poses') else v)
            for k, v in want.items()}
    got = estimators['torch'].estimate_poses_batched(frames, boxes, valid, num_aug=5)
    compare(got, want, valid)


def test_matches_jax_tpu_kernel_path(estimators):
    """The JAX side runs the Pallas warp (interpret mode), the TPU kernel's code."""
    frames, boxes, valid = frames_and_boxes(seed=2)
    kwargs = dict(num_aug=2, average_aug=False)
    want = estimators['tiled'].estimate_poses_batched(frames, boxes, valid, **kwargs)
    got = estimators['torch'].estimate_poses_batched(frames, boxes, valid, **kwargs)
    compare(got, want, valid)


def test_estimate_poses_single_image(estimators):
    frames, boxes, _ = frames_and_boxes(seed=3)
    want = estimators['gather'].estimate_poses(frames[0], boxes[0, :2], num_aug=2)
    got = estimators['torch'].estimate_poses(frames[0], boxes[0, :2], num_aug=2)
    assert set(got) == set(want) and got['poses3d'].shape == (2, 17, 3)
    np.testing.assert_allclose(got['poses3d'], want['poses3d'], **POSES3D)
    np.testing.assert_allclose(got['poses2d'], want['poses2d'], **POSES2D)
    np.testing.assert_array_equal(got['boxes'], want['boxes'])


def test_no_valid_box(estimators):
    frames, boxes, _ = frames_and_boxes()
    valid = np.zeros((2, 3), bool)
    want = estimators['gather'].estimate_poses_batched(frames, boxes, valid, num_aug=2)
    got = estimators['torch'].estimate_poses_batched(frames, boxes, valid, num_aug=2)
    assert not got['valid'].any()
    for key in want:
        assert tuple(got[key].shape) == np.asarray(want[key]).shape


@pytest.mark.parametrize('average_aug', [True, False])
def test_zero_boxes_give_empty_shapes_as_in_jax(estimators, average_aug):
    """F2: no box at all gives JAX's empty-shaped outputs, batched and
    single-image."""
    frames = frames_and_boxes()[0]
    kwargs = dict(num_aug=2, average_aug=average_aug)
    want = estimators['gather'].estimate_poses_batched(frames, np.zeros((2, 0, 4)), **kwargs)
    got = estimators['torch'].estimate_poses_batched(frames, np.zeros((2, 0, 4)), **kwargs)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: np.asarray(v).shape for k, v in want.items()}
    assert got['poses3d'].shape[1:] == ((0, 17, 3) if average_aug else (0, 2, 17, 3))
    want = estimators['gather'].estimate_poses(frames[0], np.zeros((0, 4)), **kwargs)
    got = estimators['torch'].estimate_poses(frames[0], np.zeros((0, 4)), **kwargs)
    assert {k: v.shape for k, v in got.items()} == {k: np.asarray(v).shape
                                                     for k, v in want.items()}
    assert got['boxes'].shape == (0, 5)


def test_serving_defaults_and_overrides(package):
    est = load_pose_estimator(package, device='cpu', cfg_overrides={'warp_precision': 'bf16'})
    assert est.cfg.bn_fold and not est.cfg.backbone_scan_blocks
    assert est.cfg.warp_precision == 'bf16'
    unfolded = load_pose_estimator(package, device='cpu', cfg_overrides={'bn_fold': False})
    assert not unfolded.cfg.bn_fold
    with pytest.raises(ValueError, match='trained-model fields'):
        load_pose_estimator(package, device='cpu', cfg_overrides={'proc_side': 128})
    with pytest.raises(ValueError, match='flat'):
        load_pose_estimator(package, device='cpu',
                            cfg_overrides={'backbone_scan_blocks': True})


def test_cpu_run_launches_no_kernel(estimators):
    frames, boxes, valid = frames_and_boxes()
    before = warp_cuda.warp_pyramid.launches
    estimators['torch'].estimate_poses_batched(frames, boxes, valid, num_aug=1)
    assert warp_cuda.warp_pyramid.launches == before


def test_fused_mbconv_estimator_matches_jax(package, monkeypatch):
    """The unfolded crop model with `fuse_mbconv='on'` (plain K2 on the CPU)
    against JAX's with the TPU kernel K2 in interpret mode."""
    def jax_builder(name, **kwargs):
        return jax_build_backbone(name, **kwargs).clone(fuse_mbconv='interpret')

    calls = []
    plain = mbconv.fused_mbconv_inner
    monkeypatch.setattr(mbconv, 'fused_mbconv_inner',
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    overrides = {'bn_fold': False}
    with pytest.warns(UserWarning, match='bone_mean_lengths'):
        jax_est = jax_load_pose_estimator(package, backbone_builder=jax_builder,
                                          cfg_overrides=overrides)
    est = load_pose_estimator(package, device='cpu', cfg_overrides=overrides,
                              backbone_builder=functools.partial(build_backbone,
                                                                 fuse_mbconv='on'))
    frames, boxes, valid = frames_and_boxes(seed=4)
    kwargs = dict(num_aug=2, average_aug=False)
    want = jax_est.estimate_poses_batched(frames, boxes, valid, **kwargs)
    before = mbconv_cuda.fused_mbconv_inner.launches
    got = est.estimate_poses_batched(frames, boxes, valid, **kwargs)
    compare(got, want, valid)
    assert len(calls) == 28  # one chunk: every qualifying block once
    assert mbconv_cuda.fused_mbconv_inner.launches == before


_NO_JAX_SCRIPT = """
import importlib, pkgutil, sys
import numpy as np
import metrabs_tpu_torch
from metrabs_tpu_torch.io.packaging import load_pose_estimator
for mod in pkgutil.walk_packages(metrabs_tpu_torch.__path__, 'metrabs_tpu_torch.'):
    importlib.import_module(mod.name)
est = load_pose_estimator(sys.argv[1], device='cpu')
frames = np.random.default_rng(0).integers(0, 256, (1, 120, 160, 3), dtype=np.uint8)
out = est.estimate_poses_batched(frames, [[[20, 10, 60, 100]]], num_aug=1)
assert tuple(out['poses3d'].shape) == (1, 1, 17, 3), out['poses3d'].shape
assert bool(out['poses3d'].isfinite().all())
leaked = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'metrabs_tpu'))
assert not leaked, leaked
print('NO_JAX_OK')
"""


def test_port_never_imports_jax(package):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, '-c', _NO_JAX_SCRIPT, package], cwd=repo,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'NO_JAX_OK' in proc.stdout
