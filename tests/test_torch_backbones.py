"""The port's MobileNetV3 and ResNet backbones, builder and shared blocks
(`metrabs_tpu_torch/models/backbones/`) against the JAX package's.

Weights are minted from a numpy seed on the JAX side (`_torch_port.
mint_variables`: 0.8x He kernels, random BN statistics) and carried across
with `io.weights`; inputs are seeded uniform [0, 1] crops of 64 px (96 px
at test stride 8, batch 2, float32 on both sides. Tolerances: features
rtol 1e-3 and atol 1e-3 of the features' largest magnitude (the caffe
preprocessing of ResNet V1 gives activations in the thousands, EfficientNet
and MobileNet of order 1; the two sides sum convolutions in other orders);
updated BN statistics the same against their own scale. Every forward case
also checks that a second input moves the features ten times further than
the port is from JAX (random nets of flat scale barely see their input).
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.io.bn_fold import fold_bn_variables as jax_fold_bn
from metrabs_tpu.models.backbones import common as jax_common
from metrabs_tpu.models.backbones import resnet as jax_resnet
from metrabs_tpu.models.backbones.builder import build_backbone as jax_build_backbone
from metrabs_tpu_torch.io import weights
from metrabs_tpu_torch.models.backbones import common, resnet
from metrabs_tpu_torch.models.backbones.builder import backbone_supports_bn_fold, build_backbone
from tests import _torch_port

SIZE = 64

# name, stride_test
FORWARD_CASES = [
    ('mobilenetv3-small', None), ('mobilenetv3-large', None), ('mobilenetv3-small-mini', None),
    ('resnet18', None), ('resnet50', None), ('resnet50v1-5', None), ('resnet50v2', None),
    ('resnet50v1-5-groupnorm', None), ('resnet50-stride16', None), ('resnet50-stride16', 8)]
FOLDABLE = ['mobilenetv3-small', 'mobilenetv3-large', 'resnet18', 'resnet50', 'resnet50v1-5']
TRAIN_CASES = ['mobilenetv3-small', 'resnet18', 'resnet50', 'resnet50v2',
               'resnet50v1-5-groupnorm']


def inputs(seed, size=SIZE):
    return np.random.default_rng(seed).uniform(size=(2, size, size, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_backbone(name, stride_test=None, seed=1):
    """(JAX module, minted variables) of `name`."""
    model = jax_build_backbone(name, dtype=jnp.float32, scan_blocks=False,
                               stride_test=stride_test)
    shapes = jax.eval_shape(functools.partial(model.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    return model, _torch_port.mint_variables(shapes, np.random.default_rng(seed))


def port_backbone(name, variables, stride_test=None, bn_fold=False):
    model = build_backbone(name, dtype=torch.float32, stride_test=stride_test, bn_fold=bn_fold)
    model.load_state_dict(weights.torch_state_dict_from_flax(variables))
    return model.eval()


def run_port(model, x):
    with torch.no_grad():
        return model(torch.tensor(x)).permute(0, 2, 3, 1).numpy()


def assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize('name,stride_test', FORWARD_CASES)
def test_features_match_jax(name, stride_test):
    jmodel, variables = jax_backbone(name, stride_test)
    size = SIZE if stride_test is None else 96
    x = inputs(0, size)
    want = np.asarray(jax.jit(functools.partial(jmodel.apply, train=False))(variables, x))
    model = port_backbone(name, variables, stride_test)
    got = run_port(model, x)
    assert got.shape == want.shape
    assert_close(got, want)
    other = run_port(model, inputs(1, size))
    assert np.abs(other - got).max() > 10 * np.abs(got - want).max()


@pytest.mark.parametrize('name', FOLDABLE)
def test_folded_matches_unfolded_and_jax_folded(name):
    """The folded layout (`io.weights.fold_bn_variables`) against the port's
    unfolded model and JAX's folded one (tests/test_bn_fold.py)."""
    jmodel, variables = jax_backbone(name)
    eps = weights.bn_epsilon_for(name)
    folded = weights.fold_bn_variables(variables, epsilon=eps)
    jfolded = jax_fold_bn(variables, epsilon=eps)
    jmodel_f = jax_build_backbone(name, dtype=jnp.float32, bn_fold=True)
    x = inputs(2)
    want = np.asarray(jax.jit(functools.partial(jmodel_f.apply, train=False))(jfolded, x))
    got = run_port(port_backbone(name, folded, bn_fold=True), x)
    unfolded = run_port(port_backbone(name, variables), x)
    assert_close(got, want)
    assert_close(got, unfolded)
    assert not any('bn' in k or 'running' in k
                   for k in port_backbone(name, folded, bn_fold=True).state_dict())


@pytest.mark.parametrize('name', TRAIN_CASES)
def test_train_mode_forward_matches_jax(name):
    """One train-mode forward: batch-statistics normalisation and the
    running statistics it updates (momentum 0.999 for MobileNetV3, 0.997
    for ResNet), in two ghost splits of one crop each. Both sides compute in
    float64 from the float32 weights, as tests/test_torch_train_effnet.py
    does: batch statistics over the 2x2 maps of the last stage cancel
    float32 rounding of activations in the thousands (ResNet V1's caffe
    input) to ~1% of the result."""
    _, variables = jax_backbone(name)
    x = inputs(3)
    with jax.enable_x64(True):
        jmodel = jax_build_backbone(name, dtype=jnp.float64, ghost_splits=2)
        want, updated = jax.jit(functools.partial(jmodel.apply, train=True,
                                                  mutable=['batch_stats']))(variables, x)
        want, updated = np.asarray(want), jax.tree_util.tree_map(np.asarray, dict(updated))
    model = build_backbone(name, dtype=torch.float64, ghost_splits=2)
    model.load_state_dict(weights.torch_state_dict_from_flax(variables))
    model.train()
    got = model(torch.tensor(x)).detach().permute(0, 2, 3, 1).numpy()
    assert_close(got, want)
    if 'groupnorm' in name:
        assert 'batch_stats' not in variables and not list(model.buffers())
        return
    stats = weights.flatten_dict(updated)
    state = model.state_dict()
    moved = 0
    for key, value in stats.items():
        t = state[weights._torch_key(key)].numpy()
        np.testing.assert_allclose(t, value, rtol=1e-3, atol=1e-3 * np.abs(value).max() + 1e-6)
        before = weights.flatten_dict(variables)[key]
        moved += not np.allclose(value, before)
    assert moved == len(stats)


def _jax_param_count(name):
    model = jax_build_backbone(name, dtype=jnp.float32)
    shapes = jax.eval_shape(functools.partial(model.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    return sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes['params']))


@pytest.mark.parametrize('name,bounds', [
    ('mobilenetv3-small', (1.2e6, 2.2e6)), ('mobilenetv3-large', None),
    ('mobilenetv3-large-mini', None), ('resnet18', None), ('resnet34', None),
    ('resnet50', (22e6, 26e6)), ('resnet101', None), ('resnet152', None),
    ('resnet50v2', None), ('resnet101v1-5-groupnorm', None)])
def test_parameter_counts_match_jax(name, bounds):
    """Every parameter of the full-width network, as JAX counts it, within
    tests/test_backbones.py's published ranges where it gives one."""
    with torch.device('meta'):
        n = sum(p.numel() for p in build_backbone(name).parameters())
    assert n == _jax_param_count(name)
    if bounds:
        assert bounds[0] < n < bounds[1]


@pytest.mark.parametrize('output_stride', [4, 8, 16, 32])
@pytest.mark.parametrize('centered', [True, False])
def test_stride_plans_match_jax(output_stride, centered):
    assert (resnet.get_strides_and_dilations(output_stride, centered)
            == jax_resnet.get_strides_and_dilations(output_stride, centered))


@pytest.mark.parametrize('name,kwargs,error', [
    ('resnet50v2', dict(bn_fold=True), 'bn_fold is not supported'),
    ('resnet50-groupnorm', dict(bn_fold=True), 'bn_fold is not supported'),
    ('tiny', dict(bn_fold=True), 'bn_fold is not supported'),
    ('resnet50v2-groupnorm', {}, 'groupnorm is not supported for ResNet V2'),
    ('resnet50x', {}, 'Cannot parse ResNet'),
    ('mobilenetv3-medium', {}, 'Cannot parse MobileNet'),
    ('mobilenetv3-small', dict(stride_test=16), 'only supported for resnet/efficientnetv2'),
    ('tiny', dict(stride_test=16), 'only supported for resnet/efficientnetv2'),
    ('vgg16', {}, 'No backbone builder'),
    ('resnet50', dict(fuse_mbconv='on'), 'EfficientNetV2 options'),
])
def test_builder_errors_match_jax(name, kwargs, error):
    jax_kwargs = {k: v for k, v in kwargs.items() if k != 'fuse_mbconv'}
    with pytest.raises(ValueError, match=error):
        build_backbone(name, **kwargs)
    if jax_kwargs or 'fuse_mbconv' not in kwargs:
        with pytest.raises(ValueError):
            jax_build_backbone(name, **jax_kwargs)


def test_fold_is_inference_only():
    model = build_backbone('resnet18', bn_fold=True).train()
    with pytest.raises(ValueError, match='inference-only'):
        model(torch.zeros(1, SIZE, SIZE, 3))


def test_activations_and_preprocessing_match_jax():
    x = np.linspace(-8, 8, 161, dtype=np.float32)
    for name in ('relu', 'silu', 'swish', 'hard_swish', 'gelu'):
        np.testing.assert_allclose(common.ACTIVATIONS[name](torch.tensor(x)).numpy(),
                                   np.asarray(jax_common.ACTIVATIONS[name](x)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(common.hard_sigmoid(torch.tensor(x)).numpy(),
                               np.asarray(jax_common.hard_sigmoid(x)), atol=1e-7)
    img = inputs(4)
    for name in ('tf_preproc', 'torch_preproc', 'caffe_preproc', 'mobilenet_preproc'):
        np.testing.assert_allclose(getattr(common, name)(torch.tensor(img)).numpy(),
                                   np.asarray(getattr(jax_common, name)(jnp.asarray(img))),
                                   rtol=1e-6, atol=1e-5, err_msg=name)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_group_norm_matches_flax(dtype):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 6, 5, 64)) * 3 + 1).astype(np.float32)
    gn = jax_common.GroupNormCompat(dtype=jnp.dtype(dtype))
    variables = _torch_port.mint_variables(
        jax.eval_shape(gn.init, jax.random.PRNGKey(0), jnp.zeros((1, 6, 5, 64))), rng)
    want = np.asarray(gn.apply(variables, jnp.asarray(x, dtype)).astype(jnp.float32))
    module = common.GroupNormCompat(64)
    module.load_state_dict(weights.torch_state_dict_from_flax(variables))
    with torch.no_grad():
        got = module(torch.tensor(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == 'float32' else 2e-2
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize('name', ['mobilenetv3-small', 'resnet50v1-5-groupnorm', 'resnet50v2',
                                  'resnet18'])
def test_state_dict_round_trips_through_the_jax_layout(name):
    """`flax_variables_from_state_dict` inverts the mapping for every norm
    layout (wrapped BN, GroupNorm's `gn`, folded)."""
    _, variables = jax_backbone(name)
    for fold in (False, True) if backbone_supports_bn_fold(name) else (False,):
        tree = (weights.fold_bn_variables(variables, weights.bn_epsilon_for(name)) if fold
                else variables)
        state = port_backbone(name, tree, bn_fold=fold).state_dict()
        back = weights.flatten_dict(weights.flax_variables_from_state_dict(state))
        want = flax.traverse_util.flatten_dict(tree)
        assert back.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(back[key], np.asarray(want[key]))
