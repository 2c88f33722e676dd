"""What the port's trainer needs to start from and export to a package,
against the JAX package's functions on the same inputs:

 - `train.loop.load_affine_weights` reads the autoencoder npz as JAX's does;
 - `models.metrabs.set_last_point_weights` on a JAX-style tree equals JAX's
   leaf for leaf, and `set_last_point_weights_` on the port's head gives the
   same head in the port's layout;
 - `apps.train.warm_start_backbone` from a package the port wrote: the
   backbone (parameters and BatchNorm statistics) equal to the source's, the
   head's last slots equal to the source head and the others untouched, the
   EMA reset to the parameters, the same tree as JAX's warm start of the
   same package, and SystemExit on a backbone of another shape;
 - `pipeline.plausibility.BoneLengthStats` and `compute_bone_mean_lengths`
   equal to JAX's, invalid joints, non-finite lengths and unobserved edges
   included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.models import metrabs as jax_metrabs
from metrabs_tpu.pipeline import plausibility as jax_plausibility
from metrabs_tpu.train import loop as jax_loop
from metrabs_tpu_torch.apps.train import warm_start_backbone
from metrabs_tpu_torch.config import AugConfig, ModelConfig, TrainConfig
from metrabs_tpu_torch.io import weights
from metrabs_tpu_torch.io.packaging import save_pose_estimator_package
from metrabs_tpu_torch.models import metrabs
from metrabs_tpu_torch.models.backbones.tiny import TinyBackbone
from metrabs_tpu_torch.pipeline import plausibility, skeletons
from metrabs_tpu_torch.train import loop, optim
from tests import _torch_port

DEPTH = _torch_port.DEPTH
CFG = dict(proc_side=64, depth=DEPTH, n_joints=17, dtype='float32', backbone='tiny',
           backbone_scan_blocks=False)


def test_load_affine_weights_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / 'ae.npz')
    np.savez(path, w1=rng.normal(size=(17, 8)), w2=rng.normal(size=(8, 17)))
    got, want = loop.load_affine_weights(path), jax_loop.load_affine_weights(path)
    assert got.keys() == want.keys() == {'encoder_weights', 'recombination_weights'}
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


def head_tree(rng, n_points, in_channels=16):
    n_out = (1 + DEPTH) * n_points
    return {'kernel': rng.normal(size=(1, 1, in_channels, n_out)).astype(np.float32),
            'bias': rng.normal(size=(n_out,)).astype(np.float32)}


@pytest.mark.parametrize('n_points,n_other', [(25, 17), (17, 17), (17, 5)])
def test_set_last_point_weights_matches_jax(n_points, n_other):
    rng = np.random.default_rng(n_points + n_other)
    params = {'heatmap_heads': {'conv_final': head_tree(rng, n_points)},
              'backbone': {'conv0': {'kernel': rng.normal(size=(3, 3, 3, 16))}}}
    other = head_tree(rng, n_other)
    want = jax_metrabs.set_last_point_weights(params, other['kernel'], other['bias'],
                                              depth=DEPTH, n_points=n_points)
    got = metrabs.set_last_point_weights(params, other['kernel'], other['bias'],
                                         depth=DEPTH, n_points=n_points)
    flat_got, flat_want = weights.flatten_dict(got), weights.flatten_dict(want)
    assert flat_got.keys() == flat_want.keys()
    for k, w in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_got[k]), np.asarray(w), err_msg=str(k))
    # The input tree is left as it was.
    assert not np.array_equal(params['heatmap_heads']['conv_final']['bias'],
                              got['heatmap_heads']['conv_final']['bias'])

    # The in-place form on the port's head, in its [out, in, 1, 1] layout.
    heads = metrabs.MetrabsHeads(ModelConfig(**CFG), n_points, in_channels=16)
    heads.load_state_dict(weights.torch_state_dict_from_flax({'params': params['heatmap_heads']}))
    other_t = weights.torch_state_dict_from_flax({'params': {'conv_final': other}})
    metrabs.set_last_point_weights_(heads, other_t['conv_final.weight'],
                                    other_t['conv_final.bias'])
    want_t = weights.torch_state_dict_from_flax({'params': want['heatmap_heads']})
    for k, v in heads.state_dict().items():
        assert torch.equal(v, want_t[k]), k


def tiny_metrabs(width=16, latent_mode='', n_latents=0, seed=0):
    torch.manual_seed(seed)
    model = metrabs.Metrabs(ModelConfig(**CFG), TinyBackbone(width=width, use_bn=True),
                            latent_mode, n_latents)
    with torch.no_grad():  # BN statistics away from their initial values
        for name, b in model.named_buffers():
            if name.endswith(('running_mean', 'running_var')):
                b.uniform_(0.5, 1.5)
    return model


def write_package(directory, model):
    save_pose_estimator_package(
        str(directory), cfg=ModelConfig(**CFG), aug_cfg=AugConfig(),
        crop_model_variables=weights.flax_variables_from_state_dict(model.state_dict()),
        joint_info=skeletons.H36M_17)


@pytest.mark.parametrize('latent_mode,n_latents', [('', 0), ('predict_all_and_latents', 8)],
                         ids=['plain', 'all_and_latents'])
def test_warm_start_backbone_grafts_backbone_and_head(tmp_path, latent_mode, n_latents):
    source = tiny_metrabs(seed=1)
    write_package(tmp_path, source)
    optimizer = optim.Optimizer(TrainConfig())
    state = loop.create_train_state(tiny_metrabs(latent_mode=latent_mode, n_latents=n_latents,
                                                 seed=2), optimizer, device='cpu')
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert warm_start_backbone(state, str(tmp_path), ModelConfig(**CFG), True) is state
    after, src = state.model.state_dict(), source.state_dict()
    grafted = [k for k in after if k.startswith('backbone.')]
    assert len(grafted) == 25  # 5 convs, 5 BNs of 4 tensors each
    for k in grafted:
        assert torch.equal(after[k], src[k]), k
    n_points = 17 + n_latents
    for name in ('weight', 'bias'):
        got = after[f'heatmap_heads.conv_final.{name}']
        key = f'heatmap_heads.conv_final.{name}'
        want, old = src[key], before[key]
        slots = torch.zeros(got.shape[0], dtype=bool)
        slots[n_points - 17:n_points] = True
        slots[n_points:].view(DEPTH, n_points)[:, n_points - 17:] = True
        assert torch.equal(got[slots], want)
        assert torch.equal(got[~slots], old[~slots])
    for k, p in state.model.named_parameters():
        assert torch.equal(state.ema_params[k], p), k


def test_warm_start_backbone_matches_jax(tmp_path):
    """The plain model's state after the port's warm start equals JAX's warm
    start of the same package into the same fresh state."""
    from flax import serialization
    from metrabs_tpu.apps.train import warm_start_backbone as jax_warm_start
    from metrabs_tpu.config import ModelConfig as JaxModelConfig
    from metrabs_tpu.models.backbones.tiny import TinyBackbone as JaxTiny
    from metrabs_tpu.train import optim as jax_optim

    write_package(tmp_path, tiny_metrabs(seed=1))
    jcfg = JaxModelConfig(**CFG)
    jmodel = jax_metrabs.Metrabs(cfg=jcfg, backbone=JaxTiny(width=16, dtype=jnp.float32,
                                                            use_bn=True))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.eye(3)[None])
    variables = _torch_port.mint_variables(shapes, np.random.default_rng(3))
    tx = jax_optim.build_optimizer(TrainConfig())
    jstate = jax_loop.TrainState(step=jnp.int32(0), params=variables['params'],
                                 batch_stats=variables['batch_stats'],
                                 opt_state=tx.init(variables['params']),
                                 ema_params=variables['params'])
    want = jax_warm_start(jstate, str(tmp_path), jcfg, apply_head_surgery=True)

    optimizer = optim.Optimizer(TrainConfig())
    state = loop.create_train_state(tiny_metrabs(seed=4), optimizer, device='cpu')
    weights.load_flax_train_state(state, jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(jstate)))
    warm_start_backbone(state, str(tmp_path), ModelConfig(**CFG), True)
    want_sd = weights.torch_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, {'params': want.params,
                                            'batch_stats': want.batch_stats}))
    got_sd = state.model.state_dict()
    assert got_sd.keys() == want_sd.keys()
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    want_ema = weights.torch_state_dict_from_flax(
        {'params': jax.tree_util.tree_map(np.asarray, want.ema_params)})
    for k, v in want_ema.items():
        assert torch.equal(state.ema_params[k], v), k


def test_warm_start_backbone_refuses_another_backbone(tmp_path):
    write_package(tmp_path, tiny_metrabs(width=8))
    state = loop.create_train_state(tiny_metrabs(), optim.Optimizer(TrainConfig()),
                                    device='cpu')
    with pytest.raises(SystemExit, match='does not match the configured backbone'):
        warm_start_backbone(state, str(tmp_path / 'crop_model.msgpack'), ModelConfig(**CFG),
                            True)


def test_bone_length_stats_match_jax():
    rng = np.random.default_rng(8)
    edges = list(skeletons.H36M_17.edges) + [(3, 16)]
    ours, theirs = plausibility.BoneLengthStats(edges), jax_plausibility.BoneLengthStats(edges)
    for _ in range(3):
        coords = rng.normal(0, 300, (6, 17, 3)) + [0, 0, 4000]
        valid = rng.random((6, 17)) < 0.8
        valid[:, 16] = False  # edge (3, 16) is never observed
        coords[0, 2] = np.inf
        ours.update(coords, valid)
        theirs.update(coords, valid)
    got, want = ours.mean_lengths(), theirs.mean_lengths()
    assert got.dtype == np.float32 and np.isnan(got[-1])
    np.testing.assert_array_equal(got, want)
    assert ours.n_samples == theirs.n_samples == 0 and ours.edges == theirs.edges
    np.testing.assert_array_equal(
        plausibility.compute_bone_mean_lengths(coords, valid, edges[:-1]),
        jax_plausibility.compute_bone_mean_lengths(coords, valid, edges[:-1]))
