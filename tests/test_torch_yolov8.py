"""The port's YOLOv8 detector (`metrabs_tpu_torch/detect/yolov8.py`) and its
`PersonDetector` branch against `metrabs_tpu/detect/yolov8.py` and JAX's
`PersonDetector`.

Weights are minted from a numpy seed on the JAX side and carried across by
the port's loader (`io.packaging.detector_from_variables`). Tolerances as
tests/test_torch_detector.py: the heads rtol 1e-3 and atol 1e-3 of their
scale (summation order of the convolutions), the decode 1e-4 px, detections
with identical valid masks and boxes within 1e-3 px.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.detect import yolov4 as jax_yolo
from metrabs_tpu.detect import yolov8 as jax_yolov8
from metrabs_tpu_torch.detect import yolov4 as yolo
from metrabs_tpu_torch.detect import yolov8
from metrabs_tpu_torch.io import weights
from metrabs_tpu_torch.io.packaging import detector_from_variables
from tests import _torch_port

SIZE = 96
BOXES_PX = dict(atol=1e-3, rtol=0)
# tests/test_yolov8.py's published ultralytics totals (n, s, m), less the
# 16-element DFL kernel that the decode computes instead.
PUBLISHED = {'n': 3_157_200, 's': 11_166_560, 'm': 25_902_640}


@pytest.mark.parametrize('size', list('nsmlx'))
def test_parameter_counts_match_jax_and_ultralytics(size):
    with torch.device('meta'):
        n = sum(p.numel() for p in yolo.build_detector_model(f'yolov8{size}').parameters())
    shapes = jax.eval_shape(lambda: jax_yolov8.YOLOv8(size=size).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes['params']))
    if size in PUBLISHED:
        assert n == PUBLISHED[size] - yolov8.REG_MAX


@functools.lru_cache(maxsize=None)
def tree():
    return _torch_port.detector_variables('yolov8n', seed=3, size=SIZE)


def manifest():
    # JAX packages record detector_scan_repeats=True for YOLOv8 as well.
    return dict(detector_type='yolov8n', detector_dtype='float32', detector_input_size=SIZE,
                detector_scan_repeats=True)


def test_forward_and_decode_match_jax(rng):
    model = jax_yolov8.YOLOv8(size='n', dtype=jnp.float32)
    x = rng.uniform(size=(2, SIZE, 128, 3)).astype(np.float32)
    heads = jax.jit(functools.partial(model.apply, train=False))(tree(), jnp.asarray(x))
    want = [[np.asarray(a) for a in pair] for pair in heads]
    want_merged = np.asarray(jax_yolov8.decode_heads(heads))
    det = detector_from_variables(tree(), manifest(), bn_fold=True, device='cpu')
    assert isinstance(det.model, yolov8.YOLOv8) and det.input_size == SIZE
    assert not det.model.training
    with torch.no_grad():
        got = [[a.numpy() for a in pair] for pair in det.model(torch.tensor(x))]
        other = det.model(torch.tensor(rng.uniform(size=x.shape), dtype=torch.float32))
    for g_pair, w_pair, o_pair in zip(got, want, other):
        for g, w, o in zip(g_pair, w_pair, o_pair):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * np.abs(w).max())
            assert np.abs(o.numpy() - g).max() > 10 * np.abs(g - w).max()
    merged = yolov8.decode_heads([tuple(torch.tensor(a) for a in pair) for pair in want])
    np.testing.assert_allclose(merged.numpy(), want_merged, rtol=1e-6, atol=1e-4)


def test_dfl_decode_golden():
    """tests/test_yolov8.py::test_dfl_decode_golden: a one-hot spike at bin k
    decodes to k cells from the cell center, scaled by the stride."""
    reg = yolov8.REG_MAX
    box = np.full((1, 2, 2, 4, reg), -1e9, np.float32)
    for side, k in enumerate([2, 1, 4, 3]):
        box[0, 0, 0, side, k] = 1e9
    box[0, 0, 1, :, 0] = box[0, 1, 0, :, 0] = box[0, 1, 1, :, 0] = 1e9
    trivial = (torch.full((1, 1, 1, 4 * reg), -1e9), torch.zeros((1, 1, 1, 80)))
    merged = yolov8.decode_heads([(torch.tensor(box.reshape(1, 2, 2, -1)),
                                   torch.zeros((1, 2, 2, 80))), trivial, trivial])
    np.testing.assert_allclose(merged[0, 0, :4].numpy(), [1.5 * 8, 1.5 * 8, 6 * 8, 4 * 8],
                               atol=1e-3)


def test_scanned_to_flat_and_state_dict_round_trip():
    """`yolo_scanned_to_flat` leaves a YOLOv8 tree as it is, and the nested
    module names (`l2/m0/cv1/conv`, `l22/cv2_0_2`) map both ways."""
    flat = weights.flatten_dict(weights.yolo_scanned_to_flat(tree()))
    want = flax.traverse_util.flatten_dict(tree())
    assert flat.keys() == want.keys()
    assert ('params', 'l2', 'm0', 'cv1', 'conv', 'kernel') in want
    assert ('params', 'l22', 'cv2_0_2', 'bias') in want
    with torch.device('meta'):
        model = yolo.build_detector_model('yolov8n')
    state = weights.detector_state_dict_from_flax(tree(), model)
    assert 'l2.m0.cv1.conv.weight' in state and 'l22.cv3_2_2.bias' in state
    back = weights.flatten_dict(weights.flax_variables_from_state_dict(state))
    assert back.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(back[key], want[key])
    with pytest.raises(ValueError, match='bn_fold is not wired'):
        yolo.build_detector_model('yolov8n', bn_fold=True)


@pytest.mark.parametrize('flip', [False, True], ids=['plain', 'flip_aug'])
def test_detect_batched_matches_jax(rng, flip):
    jdet = jax_yolo.PersonDetector(jax_yolo.build_detector_model('yolov8n', dtype=jnp.float32),
                                   tree(), input_size=SIZE)
    det = detector_from_variables(tree(), manifest(), bn_fold=False, device='cpu')
    images = rng.integers(0, 256, size=(2, 120, 160, 3), dtype=np.uint8)
    kwargs = dict(max_detections=8, flip_aug=flip)
    # A threshold halfway between two kept scores: a mixed mask, no score
    # near it.
    scores = np.asarray(jdet.detect_batched(images, threshold=0.0, **kwargs)[0])[0, :, 4]
    kwargs['threshold'] = float(scores[3] + scores[4]) / 2
    want_boxes, want_valid = (np.asarray(a) for a in jdet.detect_batched(images, **kwargs))
    with torch.no_grad():
        got_boxes, got_valid = det.detect_batched(torch.tensor(images), **kwargs)
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)
    assert 0 < want_valid.sum() < want_valid.size
    np.testing.assert_allclose(got_boxes.numpy(), want_boxes, **BOXES_PX)


def test_input_size_defaults_by_family():
    assert yolo.PersonDetector(yolov8.YOLOv8('n')).input_size == 640
    assert yolo.PersonDetector(yolo.YOLOv4Tiny()).input_size == 416
