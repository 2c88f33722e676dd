"""The port's detector trainer (`metrabs_tpu_torch/detect/train.py`, with
`train.optim.Adam` and `cosine_decay_schedule`) against
`metrabs_tpu/detect/train.py` and optax, on the CPU.

Tolerances: `build_targets` is the same numpy code: equal. The loss and its
gradient with respect to the heads are float32 elementwise math in another
order: LOSS_RTOL and GRAD_TOL (of the largest gradient). One YOLOv4-tiny
train step from JAX's parameters (carried across with the port's detector
converter) against JAX's jitted step: the loss within LOSS_RTOL, each
parameter's gradient within GRAD_TOL of its largest (float32 convolutions
in another order: ~2e-6 measured), and the updated parameters within
PARAM_ATOL where JAX's gradient is above GRAD_NOISE of its tensor's
largest; below that, Adam's first step (about lr * sign(g)) can flip with
the sign of a gradient that is rounding noise, so there they differ by at
most 2 lr.
"""

import numpy as np
import pytest
import torch

from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from metrabs_tpu.detect import train as jax_train
from metrabs_tpu.detect import yolov4 as jax_yolov4
from metrabs_tpu_torch.detect import train
from metrabs_tpu_torch.detect import yolov4
from metrabs_tpu_torch.io.weights import detector_state_dict_from_flax
from metrabs_tpu_torch.train import optim

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
GRAD_NOISE = 1e-4
PARAM_ATOL = 1e-6
INPUT = 64

TABLES = {'tiny': (yolov4.ANCHORS_TINY, yolov4.STRIDES_TINY, yolov4.XYSCALE_TINY),
          'full': (yolov4.ANCHORS, yolov4.STRIDES, yolov4.XYSCALE)}
BOX_CASES = {
    'one_exact_anchor': ([[[100.5 - 67.5, 50.25 - 84.5, 135.0, 169.0]]], 416),
    'edge_clip': ([[[415, 415, 2, 2]], [[0, 0, 1, 1]]], 416),
    'empty_image': ([[[10, 10, 20, 30]], []], INPUT),
    'all_empty': ([[], []], INPUT),
    'several_with_classes': ([[[3, 4, 20, 40], [30, 10, 30, 50], [50, 50, 13, 13]],
                              [[0, 0, 64, 64]]], INPUT),
    'degenerate': ([[[20, 20, 0, 0], [10, 10, 1e-4, 5]]], INPUT),
}


def targets_for(case, table):
    boxes, size = BOX_CASES[case]
    boxes = [np.asarray(b, np.float32).reshape(-1, 4) for b in boxes]
    classes = ([np.arange(len(b)) % 3 for b in boxes] if case == 'several_with_classes'
               else None)
    anchors, strides, _ = TABLES[table]
    kwargs = dict(class_ids_per_image=classes, anchors=anchors, strides=strides)
    return (train.build_targets(boxes, size, **kwargs),
            jax_train.build_targets(boxes, size, **kwargs), size)


@pytest.mark.parametrize('table', sorted(TABLES))
@pytest.mark.parametrize('case', sorted(BOX_CASES))
def test_build_targets_equal_jax(case, table):
    ours, theirs, size = targets_for(case, table)
    assert len(ours[0]) == len(theirs[0]) == len(TABLES[table][1])
    for got, want in zip(ours[0] + ours[1] + [ours[2], ours[3]],
                         theirs[0] + theirs[1] + [theirs[2], theirs[3]]):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if case == 'edge_clip':
        s = 0 if ours[1][0][0].any() else 1
        g = size // TABLES[table][1][s]
        ys, xs, _ = np.nonzero(ours[1][s][0])
        assert xs[0] == g - 1 and ys[0] == g - 1


def random_heads(case, table, rng):
    """Raw heads for `case`'s targets: random, with each positive's neighbour
    anchor decoding onto its ground-truth box (an ignore zone) and log-sizes
    beyond the decode's clip bounds (-20, 8) in some cells."""
    (targets, masks, _, _), _, _ = targets_for(case, table)
    anchors, _, xyscale = TABLES[table]
    heads = []
    for s, (tgt, mask) in enumerate(zip(targets, masks)):
        n, g = tgt.shape[:2]
        raw = rng.normal(0, 1.5, (n, g, g, 3, 85)).astype(np.float32)
        raw[..., 2:4][rng.random((n, g, g, 3, 2)) < 0.1] = -25.0
        raw[..., 2:4][rng.random((n, g, g, 3, 2)) < 0.1] = 9.0
        for i, gy, gx, a in zip(*np.nonzero(mask)):
            b = (a + 1) % 3
            sc = xyscale[s]
            frac = (tgt[i, gy, gx, a, :2] + 0.5 * (sc - 1)) / sc
            raw[i, gy, gx, b, :2] = np.log(frac / (1 - frac))
            raw[i, gy, gx, b, 2:4] = tgt[i, gy, gx, a, 2:4] + np.log(anchors[s][a] / anchors[s][b])
        heads.append(raw.reshape(n, g, g, 3 * 85))
    return heads


@pytest.mark.parametrize('table', sorted(TABLES))
@pytest.mark.parametrize('case', ['several_with_classes', 'empty_image', 'all_empty',
                                  'degenerate'])
def test_detection_loss_and_head_gradients_equal_jax(case, table):
    import jax
    import jax.numpy as jnp
    heads = random_heads(case, table, np.random.default_rng(0))
    (targets, masks, gtb, gtv), _, size = targets_for(case, table)
    anchors, strides, xyscale = TABLES[table]
    kwargs = dict(input_size=size, anchors=anchors, strides=strides, xyscale=xyscale)
    want_loss, want_grads = jax.jit(jax.value_and_grad(lambda h: jax_train.detection_loss(
        h, [jnp.asarray(t) for t in targets], [jnp.asarray(m) for m in masks],
        jnp.asarray(gtb), jnp.asarray(gtv), **kwargs)))([jnp.asarray(h) for h in heads])
    leaves = [torch.tensor(h, requires_grad=True) for h in heads]
    loss = train.detection_loss(leaves, targets, masks, gtb, gtv, **kwargs)
    loss.backward()
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    for leaf, want in zip(leaves, want_grads):
        want = np.asarray(want)
        np.testing.assert_allclose(leaf.grad.numpy(), want,
                                   atol=GRAD_TOL * np.abs(want).max(), rtol=0)


@pytest.fixture(scope='module')
def tiny_start():
    """JAX's YOLOv4-tiny at INPUT px, initialised as its test initialises it,
    and a batch of 2 images with one box each."""
    import jax
    import jax.numpy as jnp
    import optax
    model = jax_yolov4.YOLOv4Tiny(dtype=jnp.float32)
    state = jax_train.create_detector_train_state(model, optax.adam(1e-3),
                                                  jax.random.PRNGKey(0), INPUT)
    rng = np.random.default_rng(1)
    images = rng.uniform(0, 1, (2, INPUT, INPUT, 3)).astype(np.float32)
    boxes = [np.array([[8, 8, 24, 36]], np.float32), np.array([[30, 20, 20, 28]], np.float32)]
    return model, state, images, jax_train.build_targets(boxes, INPUT)


def port_tiny(state):
    model = yolov4.YOLOv4Tiny()
    variables = {'params': state.params, 'batch_stats': state.batch_stats}
    model.load_state_dict(detector_state_dict_from_flax(variables, model))
    return model


def test_one_train_step_matches_jax(tiny_start, one_torch_thread):
    """One step with optax.adam(cosine_decay_schedule(1e-3, 10, alpha=0.05))
    on both sides, from the same parameters."""
    import jax
    import jax.numpy as jnp
    import optax
    model, state, images, targets = tiny_start
    tx = optax.adam(optax.cosine_decay_schedule(1e-3, 10, alpha=0.05))
    state = jax_train.DetectorTrainState(state.params, state.batch_stats,
                                         tx.init(state.params), 0)
    args = (jnp.asarray(images), [jnp.asarray(t) for t in targets[0]],
            [jnp.asarray(m) for m in targets[1]], jnp.asarray(targets[2]),
            jnp.asarray(targets[3]))
    new_state, want_loss = jax.jit(jax_train.make_detector_train_step(
        model, tx, input_size=INPUT))(state, *args)

    def jax_loss(params):
        heads = model.apply({'params': params, 'batch_stats': state.batch_stats}, args[0],
                            train=True)
        return jax_train.detection_loss(heads, *args[1:], input_size=INPUT)
    jax_grads = jax.jit(jax.grad(jax_loss))(state.params)

    ours = port_tiny(state)
    ptx = optim.Adam(optim.cosine_decay_schedule(1e-3, 10, alpha=0.05))
    pstate = train.create_detector_train_state(ours, ptx, device='cpu')
    p0 = {n: p.detach().clone() for n, p in ours.named_parameters()}
    captured = {}
    real_step = ptx.step
    ptx.step = lambda params, grads, st: (captured.update(grads), real_step(params, grads, st))
    pstate, loss = train.make_detector_train_step(ours, ptx, input_size=INPUT)(
        pstate, images, *targets)
    assert pstate.step == 1 and pstate.opt_state.count == 1
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)

    want_grad = detector_state_dict_from_flax(
        {'params': jax.tree.map(np.asarray, jax_grads), 'batch_stats': state.batch_stats}, ours)
    want_params = detector_state_dict_from_flax(
        {'params': jax.tree.map(np.asarray, new_state.params),
         'batch_stats': state.batch_stats}, ours)
    lr = optim.cosine_decay_schedule(1e-3, 10, alpha=0.05)(0)
    for name, param in ours.named_parameters():
        g, wg = captured[name], want_grad[name]
        scale = wg.abs().max().item()
        np.testing.assert_allclose(g.numpy(), wg.numpy(), atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=name)
        noise = wg.abs() < GRAD_NOISE * scale
        diff = (param.detach() - want_params[name]).abs()
        assert diff[~noise].max().item() <= PARAM_ATOL, name
        assert diff.max().item() <= 2 * lr + PARAM_ATOL, name
        assert (param.detach() - p0[name]).abs().max().item() > 0, name
    for name, buf in ours.named_buffers():  # frozen BN statistics
        np.testing.assert_array_equal(buf.numpy(), want_params[name].numpy(), err_msg=name)


def test_training_reduces_loss(tiny_start, one_torch_thread):
    """JAX's own test (tests/test_detector_train.py) on the port: 12 steps of
    Adam at 2e-3 on one batch cut the loss below 0.7x."""
    _, state, images, targets = tiny_start
    model = port_tiny(state)
    tx = optim.Adam(2e-3)
    pstate = train.create_detector_train_state(model, tx, device='cpu')
    step = train.make_detector_train_step(model, tx, input_size=INPUT)
    losses = []
    for _ in range(12):
        pstate, loss = step(pstate, images, *targets)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses
    assert pstate.step == 12


def test_full_yolov4_trains_with_its_tables(one_torch_thread):
    """Full YOLOv4 (three heads, its own anchors) through the step at 64 px:
    targets built with its decode tables, a finite loss that falls."""
    torch.manual_seed(0)
    model = yolov4.YOLOv4()
    anchors, strides, _ = model.decode_tables
    rng = np.random.default_rng(2)
    images = rng.uniform(0, 1, (2, INPUT, INPUT, 3)).astype(np.float32)
    boxes = [np.array([[8, 8, 24, 36], [40, 30, 10, 12]], np.float32),
             np.array([[30, 20, 20, 28]], np.float32)]
    targets = train.build_targets(boxes, INPUT, anchors=anchors, strides=strides)
    assert len(targets[0]) == 3
    tx = optim.Adam(1e-3)
    state = train.create_detector_train_state(model, tx, device='cpu')
    step = train.make_detector_train_step(model, tx, input_size=INPUT)
    losses = [float(step(state, images, *targets)[1]) for _ in range(2)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_train_state_refusals():
    with pytest.raises(ValueError, match='inference-only'):
        train.create_detector_train_state(yolov4.YOLOv4Tiny(bn_fold=True), optim.Adam(1e-3),
                                          device='cpu')
    with pytest.raises(NotImplementedError, match='float32'):
        train.create_detector_train_state(yolov4.YOLOv4Tiny().bfloat16(), optim.Adam(1e-3),
                                          device='cpu')
    model = yolov4.YOLOv4Tiny()
    tx = optim.Adam(1e-3)
    state = train.create_detector_train_state(yolov4.YOLOv4Tiny(), tx, device='cpu')
    with pytest.raises(ValueError, match='another model'):
        train.make_detector_train_step(model, tx, input_size=INPUT)(state, None, [], [], [], [])


@pytest.mark.parametrize('schedule', ['constant', 'cosine'])
def test_adam_and_cosine_schedule_match_optax(schedule):
    """Ten steps on random parameters and gradients (float32 parameters of
    three shapes), against optax's updates; the LR schedule over and past
    its decay steps."""
    import jax.numpy as jnp
    import optax
    rng = np.random.default_rng(3)
    params = {n: rng.normal(size=s).astype(np.float32)
              for n, s in (('a', (3, 4)), ('b', (5,)), ('c', (2, 3, 3, 2)))}
    if schedule == 'cosine':
        lr, want_lr = optim.cosine_decay_schedule(1e-3, 6, 0.05), optax.cosine_decay_schedule(
            1e-3, 6, alpha=0.05)
        for count in range(10):
            assert lr(count) == pytest.approx(float(want_lr(jnp.int32(count))), rel=1e-6)
    else:
        lr, want_lr = 2e-3, 2e-3
    tx, want_tx = optim.Adam(lr), optax.adam(want_lr)
    ours = {n: torch.tensor(v) for n, v in params.items()}
    theirs = {n: jnp.asarray(v) for n, v in params.items()}
    state, want_state = tx.init(ours), want_tx.init(theirs)
    for _ in range(10):
        grads = {n: rng.normal(size=v.shape).astype(np.float32) * 10 ** rng.uniform(-6, 1)
                 for n, v in params.items()}
        tx.step(ours, {n: torch.tensor(g) for n, g in grads.items()}, state)
        updates, want_state = want_tx.update({n: jnp.asarray(g) for n, g in grads.items()},
                                             want_state, theirs)
        theirs = optax.apply_updates(theirs, updates)
    for n in params:
        np.testing.assert_allclose(ours[n].numpy(), np.asarray(theirs[n]), rtol=1e-6, atol=1e-7)
    assert state.count == 10
