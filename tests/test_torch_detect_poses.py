"""The detect path end to end: `load_pose_estimator(pkg).detect_poses_batched`
of `metrabs_tpu_torch` (on the CPU) against that of `metrabs_tpu`, on one
JAX-written package with a float32 YOLOv4 at 96 px inside (scanned as
packaged; both loaders unroll the crop model and fold BatchNorm in it and in
the detector).

Inputs: 2 frames of 240x320 uint8 (tests/test_torch_estimator.py). The
detector threshold lies halfway between two scores, so its mask is mixed.
Tolerances on valid rows: detected boxes within 1e-3 px (float32 rounding of
the detector's convolutions), valid masks identical, poses as in
tests/test_torch_estimator.py (atol 1 mm + rtol 1e-3; 0.1 px for joints at
least 200 mm in front of the camera).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from metrabs_tpu.io.packaging import load_pose_estimator as jax_load_pose_estimator
from metrabs_tpu_torch.io.packaging import load_pose_estimator
from tests import _torch_port
from tests.test_torch_estimator import compare, frames_and_boxes
from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

BOXES_PX = dict(atol=1e-3, rtol=0)
# Random poses of boxes at the frame's edge put some joints near or behind
# the camera plane; their 2D projections are compared from 200 mm on.
MIN_DEPTH_MM = 200.0


# A flat 700 mm bone prior, so that the plausibility filter keeps some of the
# random model's poses and drops others (with the built-in H36M asset it
# drops them all).
BONE_MEANS = np.full(16, 700.0, np.float32)


@pytest.fixture(scope='module')
def detect_estimators(tmp_path_factory):
    pkg = _torch_port.make_package(str(tmp_path_factory.mktemp('pkg') / 'd'), scanned=True,
                                   detector='yolov4', bone_mean_lengths=BONE_MEANS)
    return dict(jax=jax_load_pose_estimator(pkg), torch=load_pose_estimator(pkg, device='cpu'),
                package=pkg)


DETECT_CASES = {
    'aug1': dict(num_aug=1),
    'aug2_per_aug_unsuppressed': dict(num_aug=2, average_aug=False,
                                      suppress_implausible_poses=False),
    'aug2_per_aug': dict(num_aug=2, average_aug=False),
}
MAX_DETECTIONS = 6


def detector_threshold(est, frames):
    """Halfway between the 4th and 5th best detections of frame 0, so that
    the detector's own mask is mixed and no score lies near the threshold."""
    boxes5, _ = est.detector.detect_batched(torch.as_tensor(frames), threshold=0.0,
                                            max_detections=MAX_DETECTIONS)
    s = boxes5[0, :, 4].numpy()
    assert s[3] - s[4] > 1e-4
    return float(s[3] + s[4]) / 2


@pytest.mark.parametrize('name', sorted(DETECT_CASES))
def test_detect_poses_batched_matches_jax(detect_estimators, name):
    frames = frames_and_boxes()[0]
    kwargs = dict(DETECT_CASES[name], max_detections=MAX_DETECTIONS,
                  detector_threshold=detector_threshold(detect_estimators['torch'], frames))
    want = detect_estimators['jax'].detect_poses_batched(frames, **kwargs)
    got = detect_estimators['torch'].detect_poses_batched(frames, **kwargs)
    valid = np.asarray(want['valid'])
    compare(got, want, valid, boxes_tol=BOXES_PX, min_depth_2d=MIN_DEPTH_MM)
    detected = np.asarray(want['boxes'])[..., 4] > 0
    assert 0 < detected.sum() < detected.size
    if kwargs.get('suppress_implausible_poses', True):
        assert valid.sum() < detected.sum()  # the filter drops some
        if kwargs['num_aug'] == 1:  # and keeps some (two random augs always disagree)
            assert valid.any()
    else:
        np.testing.assert_array_equal(valid, detected)


def test_detect_poses_single_image_and_validation(detect_estimators, tmp_path):
    est = detect_estimators['torch']
    frames = frames_and_boxes()[0]
    kwargs = dict(num_aug=1, max_detections=MAX_DETECTIONS, suppress_implausible_poses=False,
                  detector_threshold=detector_threshold(est, frames))
    batched = est.detect_poses_batched(frames[:1], **kwargs)
    single = est.detect_poses(frames[0], **kwargs)
    valid = batched['valid'][0].numpy()
    for key in ('boxes', 'poses3d', 'poses2d'):
        np.testing.assert_array_equal(single[key], batched[key][0].numpy()[valid])
    unfused = est.detect_poses_batched(frames[:1], fused=False, **kwargs)
    assert all(torch.equal(unfused[k], batched[k]) for k in batched)
    with pytest.raises(ValueError, match='max_detections'):
        est.detect_poses_batched(frames, max_detections=0)
    with pytest.raises(ValueError, match='No detector'):
        no_detector = _torch_port.make_package(str(tmp_path / 'p'), scanned=False)
        load_pose_estimator(no_detector, device='cpu').detect_poses_batched(frames)


_NO_JAX_SCRIPT = """
import functools, sys
import numpy as np
from metrabs_tpu_torch.io.packaging import load_pose_estimator
from metrabs_tpu_torch.models.backbones.builder import build_backbone
est = load_pose_estimator(sys.argv[1], device='cpu', cfg_overrides={'bn_fold': False},
                          backbone_builder=functools.partial(build_backbone, fuse_mbconv='on'))
frames = np.random.default_rng(0).integers(0, 256, (1, 120, 160, 3), dtype=np.uint8)
out = est.detect_poses_batched(frames, num_aug=2, max_detections=3, detector_threshold=0.0,
                               suppress_implausible_poses=True)
assert tuple(out['poses3d'].shape) == (1, 3, 17, 3), out['poses3d'].shape
assert bool(out['poses3d'].isfinite().all())
leaked = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'metrabs_tpu'))
assert not leaked, leaked
print('NO_JAX_OK')
"""


def test_detect_path_never_imports_jax(detect_estimators):
    """Detection, the fused MBConv crop model and the plausibility filter in
    a process that never imports jax."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, '-c', _NO_JAX_SCRIPT, detect_estimators['package']],
                          cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'NO_JAX_OK' in proc.stdout
