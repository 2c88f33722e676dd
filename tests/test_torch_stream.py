"""The streaming entry points of the port's `PoseEstimator`
(`estimate_poses_stream`, `detect_poses_stream`, `detect_poses_pipelined`)
and its package writer with a detector, on the CPU.

One package, written by the port's `save_pose_estimator_package` with a
float32 YOLOv4-tiny at 96 px in the flat layout, serves both packages: each
stream equals K batched calls of the port exactly (the same code per
batch), matches JAX's stream on the same package within
tests/test_torch_detect_poses.py's tolerances, and JAX detects on the
port's package as the port does. `add_detector_to_package` joins a crop
model and a detector into the package both writers would write in one go.
"""

import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from metrabs_tpu.io import packaging as jax_packaging
from metrabs_tpu_torch.config import AugConfig, ModelConfig
from metrabs_tpu_torch.io import packaging
from metrabs_tpu_torch.io.weights import scanned_to_flat
from metrabs_tpu_torch.pipeline.skeletons import H36M_17
from tests import _torch_port
from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)
from tests.test_torch_detect_poses import BONE_MEANS, BOXES_PX, MIN_DEPTH_MM, detector_threshold
from tests.test_torch_estimator import compare, frames_and_boxes

# One intra-op thread: under the suite's parallel workers more threads
# oversubscribe the cores (the pipelined threads wait on spinning ones).
pytestmark = pytest.mark.usefixtures('one_torch_thread')

MAX_DETECTIONS = 6


@pytest.fixture(scope='module')
def parts():
    """(the package's crop-model arguments, the flat detector tree)."""
    jcfg, crop = _torch_port.scanned_variables(seed=0)
    cfg = ModelConfig(**dict(dataclasses.asdict(jcfg), backbone_scan_blocks=False))
    detector = _torch_port.detector_variables('yolov4-tiny', scan_repeats=False, seed=1)
    return dict(cfg=cfg, aug_cfg=AugConfig(), crop_model_variables=scanned_to_flat(crop),
                joint_info=H36M_17, bone_mean_lengths=BONE_MEANS), detector


DETECTOR_ARGS = dict(detector_type='yolov4-tiny', detector_dtype='float32',
                     detector_input_size=96)


@pytest.fixture(scope='module')
def estimators(tmp_path_factory, parts):
    crop, detector = parts
    pkg = str(tmp_path_factory.mktemp('pkg') / 'port')
    packaging.save_pose_estimator_package(pkg, detector_variables=detector, **DETECTOR_ARGS,
                                          **crop)
    return dict(torch=packaging.load_pose_estimator(pkg, device='cpu'),
                jax=jax_packaging.load_pose_estimator(pkg), package=pkg)


def stream_frames():
    """[K=2, B=2, 240, 320, 3]: two frame batches that differ."""
    return np.stack([frames_and_boxes(seed=0)[0], frames_and_boxes(seed=1)[0]])


def assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def detect_kwargs(est):
    return dict(num_aug=2, average_aug=False, max_detections=MAX_DETECTIONS,
                detector_threshold=detector_threshold(est, frames_and_boxes()[0]))


@pytest.fixture(scope='module')
def port_detect_kwargs(estimators):
    """`detect_kwargs` of the port's estimator, worked out once (it runs the
    detector)."""
    return detect_kwargs(estimators['torch'])


@pytest.fixture(scope='module')
def pipelined_batches():
    """Three frame batches of 1-2 frames and a store for their batched
    detections, which the first `detect_poses_pipelined` case makes (on the
    test's one thread) for every case."""
    return [frames_and_boxes(seed=s)[0][:1 + s % 2] for s in range(3)], {}


def test_estimate_poses_stream_matches_batched_and_jax(estimators):
    frames_k = stream_frames()
    _, boxes, valid = frames_and_boxes()
    boxes_k = np.stack([boxes, boxes[::-1]])
    valid_k = np.stack([valid, valid[::-1]])
    kwargs = dict(num_aug=2, average_aug=False, internal_batch_size=4)
    est = estimators['torch']
    got = est.estimate_poses_stream(frames_k, boxes_k, valid_k, **kwargs)
    assert tuple(got['poses3d'].shape) == (2, 2, 3, 2, 17, 3)
    for k in range(2):
        assert_equal({key: v[k] for key, v in got.items()},
                      est.estimate_poses_batched(frames_k[k], boxes_k[k], valid_k[k], **kwargs))
    want = estimators['jax'].estimate_poses_stream(frames_k, boxes_k, valid_k, **kwargs)
    for k in range(2):
        compare({key: v[k] for key, v in got.items()},
                {key: np.asarray(v)[k] for key, v in want.items()}, valid_k[k])
    # All valid when box_valid is None; boxes as tensors.
    all_valid = est.estimate_poses_stream(torch.as_tensor(frames_k), torch.as_tensor(boxes_k),
                                          num_aug=1)
    assert bool(all_valid['valid'].all())


def test_detect_poses_stream_matches_batched_and_jax(estimators, port_detect_kwargs):
    """Detections of the port's package by the port and by JAX."""
    est = estimators['torch']
    frames_k = stream_frames()
    kwargs = port_detect_kwargs
    got = est.detect_poses_stream(frames_k, **kwargs)
    assert tuple(got['boxes'].shape) == (2, 2, MAX_DETECTIONS, 5)
    for k in range(2):
        assert_equal({key: v[k] for key, v in got.items()},
                     est.detect_poses_batched(frames_k[k], **kwargs))
    want = estimators['jax'].detect_poses_stream(frames_k, **kwargs)
    for k in range(2):
        want_k = {key: np.asarray(v)[k] for key, v in want.items()}
        compare({key: v[k] for key, v in got.items()}, want_k, want_k['valid'],
                boxes_tol=BOXES_PX, min_depth_2d=MIN_DEPTH_MM)
    detected = np.asarray(want['boxes'])[..., 4] > 0
    assert 0 < detected.sum() < detected.size


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('in_flight', [1, 2])
def test_detect_poses_pipelined_matches_batched(estimators, port_detect_kwargs,
                                                pipelined_batches, in_flight, fused):
    est = estimators['torch']
    batches, store = pipelined_batches
    if 'wants' not in store:
        store['wants'] = [est.detect_poses_batched(images, **port_detect_kwargs)
                          for images in batches]
    wants = store['wants']
    got = list(est.detect_poses_pipelined(iter(batches), in_flight=in_flight, fused=fused,
                                          **port_detect_kwargs))
    assert len(got) == len(batches)
    for g, want in zip(got, wants):
        assert g.keys() == want.keys()
        for k in want:
            assert isinstance(g[k], np.ndarray)
            np.testing.assert_array_equal(g[k], want[k].numpy(), err_msg=k)


def test_stream_errors(estimators, parts, tmp_path):
    est = estimators['torch']
    frames, boxes, _ = frames_and_boxes()
    with pytest.raises(ValueError, match=r'\[K, B, H, W, 3\]'):
        est.estimate_poses_stream(frames, boxes)
    with pytest.raises(ValueError, match=r'\[K, B, H, W, 3\]'):
        est.detect_poses_stream(frames)
    with pytest.raises(ValueError, match='max_detections'):
        est.detect_poses_stream(stream_frames(), max_detections=0)
    with pytest.raises(ValueError, match='in_flight'):
        list(est.detect_poses_pipelined([frames], in_flight=0))
    crop, _ = parts
    packaging.save_pose_estimator_package(str(tmp_path / 'p'), **crop)
    no_detector = packaging.load_pose_estimator(str(tmp_path / 'p'), device='cpu')
    with pytest.raises(ValueError, match='No detector'):
        no_detector.detect_poses_stream(stream_frames())
    with pytest.raises(ValueError, match='No detector'):
        list(no_detector.detect_poses_pipelined([frames]))


def test_writer_refuses_the_scanned_detector_layout(parts, tmp_path):
    crop, detector = parts
    with pytest.raises(ValueError, match='flat detector layout'):
        packaging.save_pose_estimator_package(str(tmp_path / 'a'), detector_variables=detector,
                                              detector_scan_repeats=True, **crop)
    scanned = {'params': dict(detector['params'], res_scan_5_2={})}  # YOLOv4's scanned group
    with pytest.raises(ValueError, match='flat detector layout'):
        packaging.save_pose_estimator_package(str(tmp_path / 'b'), detector_variables=scanned,
                                              **crop)


def test_add_detector_to_package_matches_writing_it_at_once(estimators, parts, tmp_path,
                                                            port_detect_kwargs):
    """The port's package with its detector added later equals, file for
    file, the package written at once; JAX's `add_detector_to_package` on
    the same crop-model package writes the same manifest."""
    crop, detector = parts
    ours, theirs = str(tmp_path / 'ours'), str(tmp_path / 'theirs')
    for directory in (ours, theirs):
        packaging.save_pose_estimator_package(directory, **crop)
    packaging.add_detector_to_package(ours, detector, **DETECTOR_ARGS)
    jax_packaging.add_detector_to_package(theirs, detector, detector_scan_repeats=False,
                                          **DETECTOR_ARGS)
    at_once = estimators['package']
    names = sorted(os.listdir(at_once))
    assert sorted(os.listdir(ours)) == names == ['crop_model.msgpack', 'detector.msgpack',
                                                 'manifest.json']
    _, mismatch, errors = filecmp.cmpfiles(at_once, ours, names, shallow=False)
    assert not mismatch and not errors
    load = lambda d: json.load(open(os.path.join(d, 'manifest.json')))
    assert load(theirs) == load(ours)
    est = packaging.load_pose_estimator(ours, device='cpu')
    frames = frames_and_boxes()[0]
    kwargs = port_detect_kwargs  # the same detector: the same threshold
    assert_equal(est.detect_poses_batched(frames, **kwargs),
                 estimators['torch'].detect_poses_batched(frames, **kwargs))
