"""The estimator's repaired faults on the card: F3, the port's own CUDA
outputs go back in as boxes, and F2, zero boxes give empty shapes; and the
stream entry points on CUDA tensors. A float32 EffNetV2-S crop model at
64 px and a YOLOv4-tiny at 96 px, weights minted with torch from a seed
(chip_smoke.py's helpers).

These tests need an NVIDIA GPU with the CUDA toolkit and skip elsewhere. The
file imports neither jax nor the test conftest's jax setup:

    python -m pytest --noconftest -m cuda tests/test_torch_estimator_cuda.py

Tolerance: poses from CUDA boxes and from the same boxes on the host within
1e-3 mm (the same computation twice; cuDNN may pick another algorithm).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from metrabs_tpu_torch.config import ModelConfig
from metrabs_tpu_torch.io.packaging import pose_estimator_from_variables

pytestmark = pytest.mark.cuda
POSES = dict(atol=1e-3, rtol=0)


@pytest.fixture(scope='module')
def est():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: python -m pytest --noconftest -m cuda '
                    'tests/test_torch_estimator_cuda.py on a GPU machine')
    manifest = chip_smoke.detect_manifest_for('float32')
    manifest['model_config']['proc_side'] = 64
    manifest.update(detector_type='yolov4-tiny', detector_input_size=96)
    gen = torch.Generator().manual_seed(0)
    variables = chip_smoke.mint_crop_variables(ModelConfig(**manifest['model_config']), gen)
    detector = chip_smoke.mint_detector_variables(gen, 'yolov4-tiny')
    return pose_estimator_from_variables(variables, manifest, device='cuda',
                                         detector_variables=detector)


def frames(k=None):
    g = torch.Generator().manual_seed(1)
    shape = (2, 120, 160, 3) if k is None else (k, 2, 120, 160, 3)
    return torch.randint(0, 256, shape, generator=g, dtype=torch.uint8).cuda()


def test_f3_detected_cuda_boxes_go_back_in(est):
    images = frames()
    det = est.detect_poses_batched(images, num_aug=1, max_detections=3, detector_threshold=0.0,
                                   suppress_implausible_poses=False)
    boxes, valid = det['boxes'][..., :4], det['valid']
    assert boxes.is_cuda and valid.is_cuda and bool(valid.any())
    got = est.estimate_poses_batched(images, boxes, valid, num_aug=1)
    want = est.estimate_poses_batched(images, boxes.cpu().numpy(), valid.cpu().numpy(),
                                      num_aug=1)
    assert torch.equal(got['boxes'], want['boxes']) and torch.equal(got['valid'], valid)
    torch.testing.assert_close(got['poses3d'], want['poses3d'], **POSES)
    torch.testing.assert_close(got['poses3d'][valid], det['poses3d'][valid], **POSES)


@pytest.mark.parametrize('average_aug', [True, False])
def test_f2_zero_boxes_give_empty_shapes(est, average_aug):
    out = est.estimate_poses_batched(frames(), np.zeros((2, 0, 4)), num_aug=2,
                                     average_aug=average_aug)
    aug = () if average_aug else (2,)
    assert {k: tuple(v.shape) for k, v in out.items()} == dict(
        boxes=(2, 0, 5), poses3d=(2, 0, *aug, 17, 3), poses2d=(2, 0, *aug, 17, 2),
        valid=(2, 0))
    single = est.estimate_poses(frames()[0], np.zeros((0, 4)), num_aug=2)
    assert single['boxes'].shape == (0, 5) and single['poses3d'].shape == (0, 17, 3)


def test_streams_on_cuda_tensors_match_batched(est):
    images = frames(k=2)
    kwargs = dict(num_aug=1, max_detections=3, detector_threshold=0.0)
    det = est.detect_poses_stream(images, **kwargs)
    est_out = est.estimate_poses_stream(images, det['boxes'][..., :4], det['valid'], num_aug=1)
    for k in range(2):
        batched = est.detect_poses_batched(images[k], **kwargs)
        assert torch.equal(det['valid'][k], batched['valid'])
        torch.testing.assert_close(det['poses3d'][k], batched['poses3d'], **POSES)
        again = est.estimate_poses_batched(images[k], det['boxes'][k, ..., :4], det['valid'][k],
                                           num_aug=1)
        torch.testing.assert_close(est_out['poses3d'][k], again['poses3d'], **POSES)
    pipelined = list(est.detect_poses_pipelined(iter(images), in_flight=2, **kwargs))
    for k, out in enumerate(pipelined):
        np.testing.assert_array_equal(out['valid'], det['valid'][k].cpu().numpy())
