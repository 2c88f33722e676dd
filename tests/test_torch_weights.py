"""The port's package reading and weight transforms against the JAX package's.

The msgpack reader must reproduce `flax.serialization.msgpack_restore`
exactly; the numpy `scanned_to_flat` and `fold_bn_variables` must equal the
JAX package's own (both slice, or compute in float64 and round once to
float32, so the results are bit-identical).
"""

import os

import numpy as np
import pytest
import torch
from flax import serialization

from metrabs_tpu.io import bn_fold as jax_bn_fold
from metrabs_tpu.io import scan_convert as jax_scan_convert
from metrabs_tpu.io.checkpoints import load_model_msgpack as jax_load_msgpack
from metrabs_tpu_torch.io import checkpoints, weights
from metrabs_tpu_torch.models.backbones.builder import backbone_supports_bn_fold
from metrabs_tpu_torch.models.metrabs import build_crop_model
from tests import _torch_port


@pytest.fixture(scope='module')
def package(tmp_path_factory):
    return _torch_port.make_package(str(tmp_path_factory.mktemp('pkg')), scanned=True)


def assert_trees_equal(got, want):
    assert isinstance(got, type(want)) or (isinstance(want, np.generic)
                                          and isinstance(got, np.generic)), (got, want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            assert_trees_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_trees_equal(g, w)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_msgpack_reader_matches_flax_on_package(package):
    path = os.path.join(package, 'crop_model.msgpack')
    assert_trees_equal(checkpoints.load_model_msgpack(path), jax_load_msgpack(path))


def test_msgpack_reader_matches_flax_on_all_types(rng):
    tree = {
        'ints': [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1, -1, -32, -33,
                 -128, -129, -32768, -32769, -2**31 - 1, -2**63],
        'floats': [0.0, -1.5, 1e300, float('inf')],
        'flags': [True, False, None],
        'text': ['', 'a' * 31, 'b' * 32, 'c' * 300, 'd' * 70000, 'ünï'],
        'blob': [b'', b'x' * 300, b'y' * 70000],
        'scalars': [np.float32(1.5), np.int64(-7), np.bool_(True)],
        'arrays': {f'a{i}': a for i, a in enumerate([
            rng.normal(size=(3, 4)).astype(np.float32), np.arange(5, dtype=np.int32),
            np.zeros((0, 2), np.float64), np.ones((2, 2, 2), np.uint8),
            np.array(3.0, np.float16)])},
        'wide_map': {str(i): i for i in range(40)},
        'long_list': list(range(20)),
    }
    data = serialization.msgpack_serialize(tree)
    assert_trees_equal(checkpoints.loads(data), serialization.msgpack_restore(data))


def test_msgpack_reader_reads_bfloat16():
    import jax.numpy as jnp
    x = np.asarray(jnp.asarray([1.0, -2.5, 3.140625], jnp.bfloat16))
    got = checkpoints.loads(serialization.msgpack_serialize({'x': x}))['x']
    np.testing.assert_array_equal(got, x.astype(np.float32))


def test_msgpack_reader_rejects_chunked_arrays(monkeypatch):
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 16)
    data = serialization.msgpack_serialize({'w': np.zeros(64, np.float32)})
    with pytest.raises(ValueError, match='chunked'):
        checkpoints.loads(data)


def test_msgpack_reader_rejects_other_ext_types():
    data = serialization.msgpack_serialize({'z': complex(1, 2)})
    with pytest.raises(ValueError, match='ext type 2'):
        checkpoints.loads(data)


def test_msgpack_reader_rejects_truncated_data():
    data = serialization.msgpack_serialize({'w': np.zeros(8, np.float32)})
    with pytest.raises(ValueError):
        checkpoints.loads(data[:-3])


def test_scanned_to_flat_matches_jax(package):
    variables = jax_load_msgpack(os.path.join(package, 'crop_model.msgpack'))['variables']
    assert_trees_equal(weights.scanned_to_flat(variables),
                       jax_scan_convert.scanned_to_flat(variables))


@pytest.mark.parametrize('layout', ['flat', 'scanned'])
def test_fold_bn_variables_matches_jax(package, layout):
    variables = jax_load_msgpack(os.path.join(package, 'crop_model.msgpack'))['variables']
    if layout == 'flat':
        variables = jax_scan_convert.scanned_to_flat(variables)
    want = jax_bn_fold.fold_bn_variables(variables, epsilon=1e-3)
    got = weights.fold_bn_variables(variables, epsilon=1e-3)
    assert 'batch_stats' not in got
    assert_trees_equal(got, want)


def test_fold_bn_variables_rejects_bn_without_conv():
    variables = {'params': {'block': {'norm9': {'bn': {
        'scale': np.ones(2, np.float32), 'bias': np.zeros(2, np.float32)}}}},
        'batch_stats': {'block': {'norm9': {'bn': {
            'mean': np.zeros(2, np.float32), 'var': np.ones(2, np.float32)}}}}}
    with pytest.raises(ValueError, match='no conv sibling'):
        weights.fold_bn_variables(variables, epsilon=1e-3)


@pytest.mark.parametrize('name', ['efficientnetv2-s', 'efficientnetv2-l-stride16',
                                  'mobilenetv3-small', 'resnet50', 'resnet50v1-5',
                                  'resnet50v2', 'resnet50-groupnorm', 'tiny'])
def test_bn_fold_support_matches_jax(name):
    assert (backbone_supports_bn_fold(name)
            == jax_bn_fold.backbone_supports_bn_fold(name))
    if backbone_supports_bn_fold(name):
        assert weights.bn_epsilon_for(name) == jax_bn_fold.bn_epsilon_for(name)


def _flat_variables(package, fold):
    variables = weights.scanned_to_flat(
        checkpoints.load_model_msgpack(os.path.join(package, 'crop_model.msgpack'))['variables'])
    return weights.fold_bn_variables(variables, 1e-3) if fold else variables


@pytest.mark.parametrize('fold', [False, True])
def test_state_dict_conversion_layouts(package, fold):
    cfg = _torch_port.crop_cfg(scan_blocks=False, bn_fold=fold)
    variables = _flat_variables(package, fold)
    state = weights.crop_model_state_dict_from_flax(variables, cfg)
    flat = weights.flatten_dict(variables)
    # HWIO -> OIHW for a dense and a depthwise conv; BN names.
    stem = flat[('params', 'backbone', 'stem_conv', 'kernel')]
    np.testing.assert_array_equal(state['backbone.stem_conv.weight'].numpy(),
                                  stem.transpose(3, 2, 0, 1))
    dw = flat[('params', 'backbone', 'blocks_20', 'depthwise_conv', 'kernel')]
    assert dw.shape[2] == 1
    assert tuple(state['backbone.blocks.20.depthwise_conv.weight'].shape) == (
        dw.shape[3], 1, 3, 3)
    if not fold:
        np.testing.assert_array_equal(
            state['backbone.blocks.20.norm2.running_var'].numpy(),
            flat[('batch_stats', 'backbone', 'blocks_20', 'norm2', 'bn', 'var')])
    # The inverse mapping restores the tree exactly (key order aside).
    back = weights.flatten_dict(weights.flax_variables_from_state_dict(state))
    assert sorted(back) == sorted(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value)


@pytest.mark.parametrize('fault', ['missing', 'leftover', 'shape', 'collection'])
def test_state_dict_conversion_rejects_mismatch(package, fault):
    cfg = _torch_port.crop_cfg(scan_blocks=False, bn_fold=True)
    variables = _flat_variables(package, fold=True)
    head = variables['params']['heatmap_heads']['conv_final']
    if fault == 'missing':
        del head['bias']
    elif fault == 'leftover':
        variables['params']['backbone']['extra_conv'] = {'kernel': np.zeros((1, 1, 2, 2))}
    elif fault == 'shape':
        head['bias'] = head['bias'][:-1]
    else:
        variables['constants'] = {'recombination_weights': np.zeros((2, 17))}
    with pytest.raises(ValueError):
        weights.crop_model_state_dict_from_flax(variables, cfg)


def test_state_dict_conversion_needs_matching_bn_layout(package):
    cfg = _torch_port.crop_cfg(scan_blocks=False, bn_fold=True)
    with pytest.raises(ValueError, match='missing'):
        weights.crop_model_state_dict_from_flax(_flat_variables(package, fold=False), cfg)


def test_converted_state_loads_strictly(package):
    cfg = _torch_port.crop_cfg(scan_blocks=False, bn_fold=False)
    model = build_crop_model(cfg)
    model.load_state_dict(weights.crop_model_state_dict_from_flax(
        _flat_variables(package, fold=False), cfg), strict=True)
    assert not torch.isnan(model.backbone.head_conv.weight).any()
