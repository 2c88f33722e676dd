"""The port's person detector (`metrabs_tpu_torch/detect/yolov4.py`,
`metrabs_tpu_torch/ops/resize.py`) against `metrabs_tpu/detect/yolov4.py` and
`jax.image.resize`.

Weights are minted from a numpy seed in the JAX package's scanned layout (as
packaged) and carried across by the port's loader (`io.weights`). Inputs come
from numpy seeds. Tolerances: decode and IoU float32 rounding (1e-4 px,
1e-6); the resize 1e-5 in float32 and one bf16 ulp near 1 (8e-3) in
bfloat16 (the two frameworks round the weight matrices and the intermediate
after the first contraction alike but accumulate in other orders); the heads
of the 110-conv network rtol 1e-3 and atol 1e-3 of their scale (summation
order of the convolutions); detections: identical valid masks, boxes within
1e-3 px (the ROADMAP M5 gate).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.detect import yolov4 as jax_yolo
from metrabs_tpu.io.bn_fold import fold_bn_variables as jax_fold_bn
from metrabs_tpu_torch.detect import yolov4 as yolo
from metrabs_tpu_torch.io import weights
from metrabs_tpu_torch.io.packaging import detector_from_variables
from metrabs_tpu_torch.ops import resize
from tests import _torch_port
from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SIZE = 96
BOXES_PX = dict(atol=1e-3, rtol=0)


def test_mish_matches_jax():
    x = np.concatenate([np.linspace(-30, 30, 601), [-100.0, 50.0, 100.0]]).astype(np.float32)
    np.testing.assert_allclose(yolo.mish(torch.tensor(x)).numpy(),
                               np.asarray(jax_yolo.mish(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('tiny', [False, True], ids=['yolov4', 'tiny'])
@pytest.mark.parametrize('input_size', [96, 416])
def test_decode_head_matches_jax(rng, tiny, input_size):
    tables = yolo.YOLOv4Tiny.decode_tables if tiny else yolo.YOLOv4.decode_tables
    jax_tables = ((jax_yolo.ANCHORS_TINY, jax_yolo.STRIDES_TINY, jax_yolo.XYSCALE_TINY)
                  if tiny else (jax_yolo.ANCHORS, jax_yolo.STRIDES, jax_yolo.XYSCALE))
    for i in range(len(tables[1])):
        g = input_size // tables[1][i]
        raw = (rng.normal(size=(2, g, g, 3 * 85)) * 4).astype(np.float32)
        raw[0, 0, 0, 2:4] = [30.0, -40.0]  # beyond the [-20, 8] clip
        want = np.asarray(jax_yolo.decode_head(jnp.asarray(raw), i, input_size, *jax_tables))
        got = yolo.decode_head(torch.tensor(raw), i, input_size, *tables).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_box_iou_matches_jax(rng):
    a = np.concatenate([rng.uniform(0, 100, (7, 2)), rng.uniform(1, 40, (7, 2))], -1)
    b = np.concatenate([rng.uniform(0, 100, (9, 2)), rng.uniform(1, 40, (9, 2))], -1)
    a, b = a.astype(np.float32), b.astype(np.float32)
    want = np.asarray(jax_yolo.box_iou_xywh(jnp.asarray(a), jnp.asarray(b)))
    got = yolo.box_iou_xywh(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (want > 0).any() and (want == 0).any()


@pytest.mark.parametrize('name', ['suppression', 'max_output', 'ties', 'invalid'])
def test_box_nms_matches_jax(rng, name):
    boxes = np.array([[10, 10, 20, 20], [11, 10, 20, 20], [100, 100, 20, 20],
                      [102, 101, 20, 20], [300, 10, 20, 20], [12, 11, 20, 20]], np.float32)
    scores = np.array([0.9, 0.8, 0.7, 0.75, 0.5, 0.85], np.float32)
    valid = np.ones(6, bool)
    max_output = 10
    if name == 'max_output':
        max_output = 2
    elif name == 'ties':
        scores[:] = 0.5  # visited in index order on both sides
    elif name == 'invalid':
        valid[[0, 3]] = False  # never kept, never suppress
    want = np.asarray(jax_yolo.box_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                       jnp.asarray(valid), 0.5, max_output))
    got = yolo.box_nms(torch.tensor(boxes), torch.tensor(scores), torch.tensor(valid),
                       0.5, max_output).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < 6


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('src,dst', [((1080, 1920), (234, 416)), ((120, 160), (72, 96)),
                                     ((300, 400), (312, 416))],
                         ids=['1080p_to_416', '160x120_to_96', 'upsample'])
def test_resize_matches_jax(rng, src, dst, dtype):
    x = rng.uniform(size=(2,) + src + (3,)).astype(np.float32)
    antialias = dst[0] < src[0]
    want = np.asarray(jax.image.resize(jnp.asarray(x, dtype), (2,) + dst + (3,),
                                       method='linear', antialias=antialias).astype(jnp.float32))
    got = resize.resize_linear(torch.tensor(x).to(getattr(torch, dtype)), dst,
                               antialias=antialias)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == 'float32' else 8e-3
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_upsample_nearest_matches_jax(rng):
    x = rng.normal(size=(2, 5, 3, 4)).astype(np.float32)  # NCHW
    want = np.asarray(jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)), (2, 6, 8, 5),
                                       method='nearest'))
    got = resize.upsample_nearest_2x(torch.tensor(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=None)
def scanned_tree(kind):
    return _torch_port.detector_variables(kind, scan_repeats=True, seed=3, size=SIZE)


def test_yolo_scanned_to_flat_inverts_jax():
    """Unrolling is the inverse of `yolo_flat_to_scanned`."""
    import flax
    flat = _torch_port.detector_variables('yolov4', scan_repeats=False, seed=4, size=SIZE)
    stacked = jax_yolo.yolo_flat_to_scanned(flat, scanned_tree('yolov4'))
    got = weights.flatten_dict(weights.yolo_scanned_to_flat(
        jax.tree_util.tree_map(np.asarray, stacked)))
    want = flax.traverse_util.flatten_dict(flat)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def manifest(kind):
    return dict(detector_type=kind, detector_dtype='float32', detector_input_size=SIZE,
                detector_scan_repeats=True)


def jax_detector(kind, fold):
    variables = scanned_tree(kind)
    if fold:
        variables = jax_fold_bn(variables, epsilon=1e-5)
    model = jax_yolo.build_detector_model(kind, dtype=jnp.float32, bn_fold=fold)
    return model, variables


@pytest.mark.parametrize('fold', [False, True], ids=['unfolded', 'folded'])
@pytest.mark.parametrize('kind', ['yolov4', 'yolov4-tiny'])
def test_forward_matches_jax(rng, kind, fold):
    model, variables = jax_detector(kind, fold)
    x = rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    want = [np.asarray(h) for h in jax.jit(functools.partial(model.apply, train=False))(
        variables, jnp.asarray(x))]
    det = detector_from_variables(scanned_tree(kind), manifest(kind), bn_fold=fold,
                                  device='cpu')
    assert det.model.bn_fold == fold and not det.model.training
    with torch.no_grad():
        got = [h.numpy() for h in det.model(torch.tensor(x))]
        other = [h.numpy() for h in det.model(torch.tensor(rng.uniform(size=x.shape),
                                                            dtype=torch.float32))]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w, o in zip(got, want, other):
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * scale)
        # The heads see their input: another input moves them ten times
        # further than the port is from JAX.
        assert np.abs(o - g).max() > 10 * np.abs(g - w).max()


@pytest.mark.parametrize('flip', [False, True], ids=['plain', 'flip_aug'])
def test_detect_batched_matches_jax(rng, flip):
    model, variables = jax_detector('yolov4', False)
    jdet = jax_yolo.PersonDetector(model, variables, input_size=SIZE)
    det = detector_from_variables(scanned_tree('yolov4'), manifest('yolov4'), bn_fold=False,
                                  device='cpu')
    images = rng.integers(0, 256, size=(2, 120, 160, 3), dtype=np.uint8)
    kwargs = dict(max_detections=8, flip_aug=flip, flip_vertical=flip)
    # A threshold halfway between two kept scores, so that some slots are
    # valid and some not, and no score lies near it.
    scores = np.asarray(jdet.detect_batched(images, threshold=0.0, **kwargs)[0])[0, :, 4]
    kwargs['threshold'] = float(scores[3] + scores[4]) / 2
    want_boxes, want_valid = (np.asarray(a) for a in jdet.detect_batched(images, **kwargs))
    with torch.no_grad():
        got_boxes, got_valid = det.detect_batched(torch.tensor(images), **kwargs)
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)
    assert 0 < want_valid.sum() < want_valid.size
    np.testing.assert_allclose(got_boxes.numpy(), want_boxes, **BOXES_PX)


def test_unscale_uses_per_axis_factors():
    """orig 80x100 at input 96: target (76, 96), so the short axis stretches by
    80/76 (tests/test_detector.py::test_unscale_uses_per_axis_factors)."""
    det = yolo.PersonDetector(yolo.YOLOv4Tiny(), input_size=96)
    fake = torch.zeros((1, 4, 4)), torch.zeros((1, 4))
    fake[0][0, 0] = torch.tensor([48.0, 48.0, 20.0, 30.0])
    fake[1][0, 0] = 1.0
    det._person_preds = lambda images_resized: fake
    boxes5, valid = det.detect_batched(torch.zeros((1, 80, 100, 3), dtype=torch.uint8),
                                       threshold=0.5, max_detections=2)
    assert valid.tolist() == [[True, False]]
    x_factor, y_factor = 100 / 96, 80 / 76
    np.testing.assert_allclose(boxes5[0, 0].numpy(),
                               [(48 - 10) * x_factor, (48 - 15 - 10) * y_factor,
                                20 * x_factor, 30 * y_factor, 1.0], rtol=1e-6)
    assert not boxes5[0, 1].any()


def test_yolov8_is_not_ported():
    """YOLOv8 is ported now (held against JAX in tests/test_torch_yolov8.py):
    every ultralytics scale builds, and a kind JAX does not know raises."""
    with torch.device('meta'):
        for size in 'nsmlx':
            assert type(yolo.build_detector_model(f'yolov8{size}')).__name__ == 'YOLOv8'
    for kind in ('yolov3', 'yolov8q', 'yolov8mm'):
        with pytest.raises(ValueError, match='Unknown'):
            yolo.build_detector_model(kind)
