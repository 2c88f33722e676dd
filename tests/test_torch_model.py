"""The port's crop model against `Metrabs.apply(train=False)` of the JAX package.

EffNetV2-S at 64 px, batch 2, float32 on both sides, from one minted package
in the flat and the scanned layout, with BatchNorm folded and unfolded.
Tolerances: backbone features rtol 1e-3 (atol 1e-3 on activations of order
1; the two sides sum the convolutions in different orders through ~40
blocks), absolute poses atol 1 mm + rtol 1e-3 (README's bound for the TF
oracle). Every case also checks that a second input moves the poses by far
more than the tolerance, so that agreement is not that of an input-blind
network.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.io.packaging import load_crop_model as jax_load_crop_model
from metrabs_tpu.models.backbones import efficientnet_v2 as jax_effnet
from metrabs_tpu.models.backbones.builder import build_backbone as jax_build_backbone
from metrabs_tpu.models.metrabs import Metrabs as JaxMetrabs
from metrabs_tpu_torch.io.packaging import load_crop_model
from metrabs_tpu_torch.models.backbones import efficientnet_v2 as effnet
from metrabs_tpu_torch.models.backbones.builder import build_backbone
from metrabs_tpu_torch.models.metrabs import build_crop_model
from tests import _torch_port
from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

FEATURES = dict(atol=1e-3, rtol=1e-3)
POSES = dict(atol=1.0, rtol=1e-3)


@pytest.fixture(scope='module')
def packages(tmp_path_factory):
    root = tmp_path_factory.mktemp('pkgs')
    return {layout: _torch_port.make_package(str(root / layout), scanned=layout == 'scanned')
            for layout in ('flat', 'scanned')}


@pytest.fixture(scope='module')
def jax_outputs(packages):
    """JAX features and poses per BN layout. Both packages unroll to the same
    variables (checked in test_torch_weights.py), so the flat one serves."""
    out = {}
    for fold in (True, False):
        model, variables, _, _, _ = jax_load_crop_model(packages['flat'], bn_fold=fold)
        out[fold] = run_jax(model, variables, *inputs(0))
    return out


def inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    k = np.stack([_torch_port.camera(64, 64, 70.0), _torch_port.camera(64, 64, 90.0)])
    return x, k


def run_jax(model, variables, x, k):
    def fn(v, x, k):
        feats, _, _ = model.apply(v, x, train=False, method=model.backbone_and_head)
        return feats, model.apply(v, x, k, train=False)
    return [np.asarray(a) for a in jax.jit(fn)(variables, x, k)]


def run_torch(model, x, k):
    with torch.no_grad():
        feats, _, _ = model.backbone_and_head(torch.tensor(x))
        poses = model(torch.tensor(x), torch.tensor(k))
    return feats.permute(0, 2, 3, 1).numpy(), poses.numpy()


@pytest.mark.parametrize('fold', [True, False], ids=['folded', 'unfolded'])
@pytest.mark.parametrize('layout', ['flat', 'scanned'])
def test_crop_model_matches_jax(packages, jax_outputs, layout, fold):
    model, cfg, _, _ = load_crop_model(packages[layout], scan_blocks=False, bn_fold=fold,
                                       device='cpu')
    assert cfg.bn_fold == fold and not cfg.backbone_scan_blocks
    assert not model.training
    x, k = inputs(0)
    j_feats, j_poses = jax_outputs[fold]
    t_feats, t_poses = run_torch(model, x, k)
    np.testing.assert_allclose(t_feats, j_feats, **FEATURES)
    np.testing.assert_allclose(t_poses, j_poses, **POSES)
    _, t_poses2 = run_torch(model, inputs(1)[0], k)
    assert np.abs(t_poses2 - t_poses).max() > 50 * POSES['atol']


def test_stride16_test_plan_matches_jax(packages):
    """stride_test 16: the dilated -stride16 plan with the same weights."""
    jmodel, jvars, jcfg, _, _ = jax_load_crop_model(packages['flat'], bn_fold=True)
    jcfg = dataclasses.replace(jcfg, stride_test=16)
    jmodel = JaxMetrabs(cfg=jcfg, backbone=jax_build_backbone(
        jcfg.backbone, dtype=jnp.float32, scan_blocks=False, stride_test=16, bn_fold=True))
    model = build_crop_model(jcfg)
    template, _, _, _ = load_crop_model(packages['flat'], bn_fold=True, device='cpu')
    model.load_state_dict(template.state_dict())
    model.eval()
    x, k = inputs(2)
    j_feats, j_poses = run_jax(jmodel, jvars, x, k)
    t_feats, t_poses = run_torch(model, x, k)
    assert t_feats.shape == (2, 4, 4, 1280)
    np.testing.assert_allclose(t_feats, j_feats, **FEATURES)
    np.testing.assert_allclose(t_poses, j_poses, **POSES)


@pytest.mark.parametrize('name', sorted(jax_effnet.EFFNETV2_PARAMS))
def test_block_plans_match_jax(name):
    got = [dataclasses.asdict(b) for b in effnet.expand_blocks(name)]
    want = [dataclasses.asdict(b) for b in jax_effnet.expand_blocks(name)]
    assert got == want


@pytest.mark.parametrize('name', ['efficientnetv2-m', 'efficientnetv2-l',
                                  'efficientnetv2-xl'])
def test_wider_plans_build_at_full_width(name):
    with torch.device('meta'):
        backbone = build_backbone(name, bn_fold=True)
    blocks = effnet.expand_blocks(name)
    assert len(backbone.blocks) == len(blocks)
    assert backbone.head_conv.weight.shape[1] == blocks[-1].output_filters


@pytest.mark.parametrize('name', ['resnet50', 'mobilenetv3-small', 'mobilenetv3-large'])
def test_other_backbones_are_not_ported(name):
    """These families are ported now (held against JAX in
    tests/test_torch_backbones.py): they build at full width, and a variant
    JAX's grammar does not know raises as in JAX."""
    with torch.device('meta'):
        backbone = build_backbone(name, bn_fold=True)
    assert backbone.out_channels == {'resnet50': 2048, 'mobilenetv3-small': 1024,
                                     'mobilenetv3-large': 1280}[name]
    with pytest.raises(ValueError, match='Cannot parse'):
        build_backbone(name + '-huge')


def test_unknown_stride_variant_raises():
    with pytest.raises(ValueError, match='stride'):
        build_backbone('efficientnetv2-m', stride_test=16)
