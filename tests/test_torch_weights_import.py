"""The port's weight importers (`metrabs_tpu_torch/io/weights_import.py`)
against the JAX package's (`metrabs_tpu/io/weights_import.py`), on the same
files and the same state dicts.

The JAX templates come from `jax.eval_shape` of `init` (no weights are
computed); the port's from its own modules' state dicts, built on the meta
device and materialised as zeros, through `io.weights.
flax_variables_from_state_dict`. Each importer must give JAX's tree, leaf
for leaf and bit for bit (the same paths, dtypes and values). The weights
are minted in the JAX package's layout (0.8x He kernels, random BN) and
written in the released formats: a TF TensorBundle under the reference
fork's names, a torchvision-layout state dict. Last, a package of imported
weights, written by the port, is served by both packages on the CPU
(tolerances of tests/test_torch_estimator.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.io import tf_checkpoint as jax_tc
from metrabs_tpu.io import weights_import as jax_wi
from metrabs_tpu.io.packaging import load_pose_estimator as jax_load_pose_estimator
from metrabs_tpu.models.backbones.builder import build_backbone as jax_build_backbone
from metrabs_tpu_torch.config import AugConfig, ModelConfig
from metrabs_tpu_torch.io import tf_checkpoint as tc
from metrabs_tpu_torch.io import weights_import as wi
from metrabs_tpu_torch.io.packaging import load_pose_estimator, save_pose_estimator_package
from metrabs_tpu_torch.io.weights import (crop_model_state_dict_from_flax,
                                          flatten_dict, flax_variables_from_state_dict)
from metrabs_tpu_torch.models.backbones.builder import build_backbone
from metrabs_tpu_torch.models.metrabs import build_crop_model
from metrabs_tpu_torch.models.registry import NAMED_MODELS
from metrabs_tpu_torch.pipeline.skeletons import H36M_17
from tests import _torch_port
from tests.test_torch_estimator import compare, frames_and_boxes
from tests.test_weights_import import build_synthetic_torch_sd
from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

BACKBONES = sorted({m.backbone for m in NAMED_MODELS.values()}
                   | {'resnet50v2', 'resnet18-groupnorm'})


def zeros_tree(module) -> dict:
    """The port's variable tree of `module` (built on the meta device),
    zero-filled."""
    return flax_variables_from_state_dict(
        {k: torch.zeros(v.shape) for k, v in module.state_dict().items()})


def port_backbone_tree(name):
    with torch.device('meta'):
        backbone = build_backbone(name)
    return zeros_tree(torch.nn.ModuleDict({'backbone': backbone}))


def jax_backbone_shapes(name):
    bb = jax_build_backbone(name, dtype=jnp.float32, scan_blocks=False)
    shapes = jax.eval_shape(functools.partial(bb.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    return {c: {'backbone': shapes[c]} for c in shapes}


def port_crop_tree(cfg: ModelConfig, **kwargs):
    with torch.device('meta'):
        model = build_crop_model(cfg, **kwargs)
    return zeros_tree(model)


def jax_template(shapes):
    """Zero leaves of the shapes of a JAX tree (the importers cast to the
    template's dtypes)."""
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def assert_trees_equal(got, want):
    got, want = flatten_dict(got), flatten_dict(_numpy_tree(want))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg='/'.join(key))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_dw_transform_is_its_own_inverse():
    """The TF checkpoints below are written by applying each pair's
    transform to the tree's value: that inverts it only because `_dw`
    swaps two axes."""
    x = np.arange(3 * 3 * 5).reshape(3, 3, 5, 1)
    np.testing.assert_array_equal(wi._dw(wi._dw(x)), x)


@pytest.mark.parametrize('name', BACKBONES)
def test_collection_mode_pairs_match_jax(name):
    """Path, TF name and transform of every pair, for the backbone of every
    named model and two more variants."""
    ours = wi.import_backbone_from_tf(None, port_backbone_tree(name), name)
    theirs = jax_wi.import_backbone_from_tf(None, jax_backbone_shapes(name), name)
    assert [p[:2] for p in ours] == [p[:2] for p in theirs]
    x = np.arange(3 * 3 * 5, dtype=np.float32).reshape(3, 3, 5, 1)
    for (path, _, ours_t), (_, _, theirs_t) in zip(ours, theirs):
        assert (ours_t is None) == (theirs_t is None), path
        if ours_t is not None:
            np.testing.assert_array_equal(ours_t(x), theirs_t(x), err_msg=path)
    # Coverage: the pairs map every leaf of the port's backbone.
    assert sorted(p[0] for p in ours) == sorted(
        '/'.join(k) for k in flatten_dict(port_backbone_tree(name)))


def released_tf_checkpoint(prefix, backbone, seed=0):
    """Writes the TF checkpoint of a minted crop model of `backbone` (the
    port's writer, the reference fork's names); returns (the port's cfg, the
    minted JAX tree, the port's template tree, the JAX model)."""
    jcfg = _torch_port.family_cfg(backbone)
    model = _torch_port.family_model(jcfg)
    minted = _torch_port.family_variables(model, seed=seed)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    template = port_crop_tree(cfg)
    pairs = (wi.import_backbone_from_tf(None, template, backbone)
             + wi.import_metrabs_head_from_tf(None, template))
    flat = {'/'.join(k): v for k, v in flatten_dict(minted).items()}
    tc.write_tf_checkpoint(prefix, {tf_name: (t or np.asarray)(flat[path])
                                    for path, tf_name, t in pairs})
    return cfg, minted, template, model


@pytest.mark.parametrize('backbone', ['resnet18', 'mobilenetv3-small', 'efficientnetv2-s'])
def test_tf_import_matches_jax(tmp_path, backbone):
    """The same TensorBundle read and imported by each package: the port's
    tree equals JAX's and the minted one, and loads into the port's model."""
    prefix = str(tmp_path / 'variables' / 'variables')
    cfg, minted, template, model = released_tf_checkpoint(prefix, backbone)
    tf_vars = tc.load_tf_checkpoint(prefix)
    ours = wi.import_metrabs_head_from_tf(
        tf_vars, wi.import_backbone_from_tf(tf_vars, template, backbone))
    jax_vars = jax_tc.load_tf_checkpoint(prefix)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.eye(3)[None])
    theirs = jax_wi.import_metrabs_head_from_tf(jax_vars, jax_wi.import_backbone_from_tf(
        jax_vars, jax_template(shapes), backbone))
    assert_trees_equal(ours, theirs)
    assert_trees_equal(ours, minted)
    crop_model_state_dict_from_flax(ours, cfg)


def test_tf_import_errors_match_jax(tmp_path):
    prefix = str(tmp_path / 'ckpt')
    _, _, template, _ = released_tf_checkpoint(prefix, 'resnet18')
    tf_vars = tc.load_tf_checkpoint(prefix)
    missing = {k: v for k, v in tf_vars.items() if k != 'conv1_conv/kernel'}
    with pytest.raises(KeyError, match='conv1_conv/kernel'):
        wi.import_backbone_from_tf(missing, template, 'resnet18')
    with pytest.raises(KeyError, match='conv1_conv/kernel'):
        jax_wi.import_backbone_from_tf(missing, template, 'resnet18')
    bad = dict(tf_vars, **{'conv1_conv/kernel': np.zeros((3, 3, 3, 64), np.float32)})
    with pytest.raises(ValueError, match='Shape mismatch'):
        wi.import_backbone_from_tf(bad, template, 'resnet18')
    with pytest.raises(ValueError, match='No TF import mapping'):
        wi.import_backbone_from_tf(tf_vars, template, 'tiny')


def test_torchvision_layout_import_matches_jax():
    """A torchvision-style EffNetV2-S state dict and a head conv, as torch
    tensors into the port and as numpy arrays into JAX."""
    jcfg = _torch_port.family_cfg('efficientnetv2-s')
    shapes = jax.eval_shape(_torch_port.family_model(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.eye(3)[None])
    template = jax_template(shapes)
    rng = np.random.default_rng(0)
    sd = build_synthetic_torch_sd(template, rng)
    kernel = template['params']['heatmap_heads']['conv_final']['kernel']
    sd['heatmap_heads.conv_final.weight'] = rng.normal(
        size=kernel.shape[::-1]).astype(np.float32)
    sd['heatmap_heads.conv_final.bias'] = rng.normal(size=kernel.shape[-1:]).astype(np.float32)
    theirs = jax_wi.import_metrabs_head_from_torch(
        sd, jax_wi.import_effnetv2_from_torch(sd, template))
    sd_t = {k: torch.tensor(v) for k, v in sd.items()}
    template = port_crop_tree(ModelConfig(**dataclasses.asdict(jcfg)))
    ours = wi.import_metrabs_head_from_torch(sd_t, wi.import_effnetv2_from_torch(sd_t, template))
    assert_trees_equal(ours, theirs)
    with pytest.raises(ValueError, match='Shape mismatch'):
        wi.import_effnetv2_from_torch(
            dict(sd_t, **{'features.0.0.weight': torch.zeros(24, 3, 5, 5)}), template)


LATENT = dict(latent_mode='transform_coords', n_latents=8)


@pytest.fixture(scope='module')
def latent_templates():
    jcfg = _torch_port.family_cfg('tiny')
    shapes = jax.eval_shape(_torch_port.family_model(jcfg, **LATENT).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.eye(3)[None])
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return dict(jax=jax_template(shapes), port=port_crop_tree(cfg, **LATENT),
                jax_plain=jax_template(jax.eval_shape(
                    _torch_port.family_model(jcfg).init, jax.random.PRNGKey(0),
                    jnp.zeros((1, 64, 64, 3)), jnp.eye(3)[None])),
                port_plain=port_crop_tree(cfg))


def test_load_affine_weights_matches_jax(latent_templates, tmp_path):
    rng = np.random.default_rng(1)
    w = dict(w1=rng.normal(size=(17, 8)).astype(np.float32),
             w2=rng.normal(size=(8, 17)).astype(np.float32))
    path = str(tmp_path / 'acae.npz')
    np.savez(path, **w)
    for source in (path, w):
        ours = wi.load_affine_weights(source, latent_templates['port'])
        theirs = jax_wi.load_affine_weights(source, latent_templates['jax'])
        for name, key in (('encoder_weights', 'w1'), ('recombination_weights', 'w2')):
            np.testing.assert_array_equal(ours['constants'][name], w[key])
            np.testing.assert_array_equal(ours['constants'][name],
                                          np.asarray(theirs['constants'][name]))


@pytest.mark.parametrize('case', ['not_transposed', 'wrong_size', 'no_latents'])
def test_load_affine_weights_errors_match_jax(latent_templates, case):
    rng = np.random.default_rng(2)
    w1, w2 = rng.normal(size=(17, 8)), rng.normal(size=(8, 17))
    source, suffix, error = {
        'not_transposed': (dict(w1=w1[:5], w2=w2), '', ValueError),
        'wrong_size': (dict(w1=w1[:, :4], w2=w2[:4]), '', ValueError),
        'no_latents': (dict(w1=w1, w2=w2), '_plain', KeyError)}[case]
    messages = []
    for fn, side in ((wi.load_affine_weights, 'port'), (jax_wi.load_affine_weights, 'jax')):
        with pytest.raises(error) as info:
            fn(source, latent_templates[side + suffix])
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_imported_package_serves_as_in_jax(tmp_path):
    """EffNetV2-S weights through the released TF format, imported by the
    port, packaged by the port, served by both packages on the CPU."""
    prefix = str(tmp_path / 'variables' / 'variables')
    cfg, _, template, _ = released_tf_checkpoint(prefix, 'efficientnetv2-s', seed=3)
    tf_vars = tc.load_tf_checkpoint(prefix)
    variables = wi.import_metrabs_head_from_tf(
        tf_vars, wi.import_backbone_from_tf(tf_vars, template, 'efficientnetv2-s'))
    pkg = str(tmp_path / 'pkg')
    save_pose_estimator_package(pkg, cfg=cfg, aug_cfg=AugConfig(), crop_model_variables=variables,
                                joint_info=H36M_17,
                                bone_mean_lengths=np.full(16, 300.0, np.float32))
    frames, boxes, valid = frames_and_boxes(seed=5)
    kwargs = dict(num_aug=2, average_aug=False)
    want = jax_load_pose_estimator(pkg).estimate_poses_batched(frames, boxes, valid, **kwargs)
    est = load_pose_estimator(pkg, device='cpu')
    got = est.estimate_poses_batched(frames, boxes, valid, **kwargs)
    compare(got, want, valid)
    other = est.estimate_poses_batched(frames_and_boxes(seed=1)[0], boxes, valid, **kwargs)
    assert np.abs(other['poses3d'].numpy() - got['poses3d'].numpy())[valid].max() > 50
