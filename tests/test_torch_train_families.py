"""The port's train steps of every crop-model family against the JAX
package's, from the same minted state, seeded batches, mix and autoencoder
weights (tests/_torch_train.py has the fixtures and tolerances: losses rtol
1e-4, gradients 1e-4 of their tensor's largest, state rtol 1e-4), with
`TinyBackbone(use_bn=True)` at 64 px, which has no drop-connect (the
EffNetV2 steps, with drop-connect forced to keep, are in
tests/test_torch_train_effnet.py). The Metrabs head's 2D biases get a
gradient that is zero in exact arithmetic (a softmax ignores a constant
shift of its logits), so Adam's first step moves them by rounding noise
over its epsilon: they are held apart (`check_step`'s `exact_zero`), each
within 0.2 lr of JAX's, and the share of parameters moved alike is counted
over the others.

 - Metro and Model25D (`make_train_step_metro`, `make_train_step_model25d`;
   Model25D's 3D batch carries `coords2d_true`), and Model25D in inference
   mode (`bn_inference`);
 - Metrabs in `transform_coords`, `predict_all_and_latents` (the teacher
   gate off at step 0 and on past `teacher_start_step`, with
   `stop_gradient_latent` both ways) and `regularize_to_manifold`;
 - the ValueErrors of mismatched latent modes and missing autoencoder
   weights, with JAX's messages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.pipeline.skeletons import H36M_17, LSP_14
from metrabs_tpu.train import loop as jax_loop
from metrabs_tpu.train import optim as jax_optim
from metrabs_tpu_torch.models.metrabs import Metrabs
from metrabs_tpu_torch.models.metro import Metro
from metrabs_tpu_torch.models.model25d import Model25D
from metrabs_tpu_torch.pipeline import skeletons
from metrabs_tpu_torch.train import loop, optim
from tests import _torch_port
from tests import _torch_train as tt
from tests.test_torch_train_step import check_step

from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

N_LATENTS = 8
TEACHER_ON = 5001  # TrainConfig.teacher_start_step + 1: the gate is `step > start`


def affine_weights(seed: int = 3):
    """Affine autoencoder weights (each output point's weights sum to 1)."""
    rng = np.random.default_rng(seed)
    w1, w2 = rng.uniform(size=(17, N_LATENTS)), rng.uniform(size=(N_LATENTS, 17))
    return {'encoder_weights': (w1 / w1.sum(0)).astype(np.float32),
            'recombination_weights': (w2 / w2.sum(0)).astype(np.float32)}


def jax_model(cfg, model_class, latent_mode):
    from metrabs_tpu.models.metrabs import Metrabs as JaxMetrabs
    from metrabs_tpu.models.metro import Metro as JaxMetro
    from metrabs_tpu.models.model25d import Model25D as JaxModel25D
    backbone = tt.jax_backbone('tiny')
    if model_class == 'metro':
        return JaxMetro(cfg=cfg, backbone=backbone)
    if model_class == 'model25d':
        bones, lengths = _torch_port.bones_25d()
        return JaxModel25D(cfg=cfg, backbone=backbone, bones=bones, bone_lengths_ideal=lengths)
    return JaxMetrabs(cfg=cfg, backbone=backbone, latent_mode=latent_mode,
                      n_latents=N_LATENTS if latent_mode else 0)


def port_model(pcfg, model_class, latent_mode):
    backbone = tt.port_backbone('tiny')
    if model_class == 'metro':
        return Metro(pcfg, backbone)
    if model_class == 'model25d':
        return Model25D(pcfg, backbone, *_torch_port.bones_25d())
    model = Metrabs(pcfg, backbone, latent_mode, N_LATENTS if latent_mode else 0)
    if latent_mode:
        with torch.no_grad():
            for name, value in affine_weights().items():
                getattr(model, name).copy_(torch.tensor(value))
    return model


def make_steps(model_class, latent_mode, tcfg_kwargs, bn_inference=False, start_step=0):
    """(JAX state, jitted JAX step, port state, port step, tcfg) of one family
    from the same minted variables at `start_step`."""
    from flax import serialization
    from metrabs_tpu_torch.io.weights import load_flax_train_state

    cfg, tcfg = tt.cfgs('tiny')
    tcfg = dataclasses.replace(tcfg, **tcfg_kwargs)
    model = jax_model(cfg, model_class, latent_mode)
    x = jnp.zeros((1, tt.PROC_SIDE, tt.PROC_SIDE, 3))
    args = (x,) if model_class == 'metro' else (x, jnp.eye(3)[None])
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    variables = _torch_port.mint_variables(shapes, np.random.default_rng(0))
    tx = jax_optim.build_optimizer(tcfg)
    params = variables['params']
    state = jax_loop.TrainState(step=jnp.int32(start_step), params=params,
                                batch_stats=variables.get('batch_stats', {}),
                                opt_state=tx.init(params), ema_params=params)
    needs_ae = bool(latent_mode) or tcfg.regularize_to_manifold
    kwargs = dict(bn_inference=bn_inference)
    maker = dict(metro=jax_loop.make_train_step_metro,
                 model25d=jax_loop.make_train_step_model25d).get(model_class)
    port_maker = dict(metro=loop.make_train_step_metro,
                      model25d=loop.make_train_step_model25d).get(model_class)
    if maker is None:
        maker, port_maker = jax_loop.make_train_step, loop.make_train_step
        kwargs['affine_weights'] = affine_weights() if needs_ae else None
    jax_step = jax.jit(maker(model, tx, H36M_17, LSP_14, cfg, tcfg, **kwargs))

    pcfg, ptcfg = tt.port_cfgs(cfg, tcfg)
    optimizer = optim.Optimizer(ptcfg)
    pstate = loop.create_train_state(port_model(pcfg, model_class, latent_mode), optimizer,
                                     device='cpu')
    load_flax_train_state(pstate, tt.to_numpy(serialization.to_state_dict(state)))
    port_step = port_maker(pstate.model, optimizer, skeletons.H36M_17, skeletons.LSP_14, pcfg,
                           ptcfg, **kwargs)
    return state, jax_step, pstate, port_step, tcfg


def run_family(model_class, latent_mode='', bn_inference=False, start_step=0, seed=0,
               **tcfg_kwargs):
    state, jax_step, pstate, port_step, tcfg = make_steps(
        model_class, latent_mode, tcfg_kwargs, bn_inference, start_step)
    rng = np.random.default_rng(seed + 1)
    b3, b2 = tt.make_batches(rng)
    if model_class == 'model25d':
        # 2D targets of the 3D batch away from every prediction, as make_batches'.
        c = rng.uniform(2, 14, size=(len(b3['image']), 17, 2))
        b3['coords2d_true'] = np.where(rng.random(c.shape) < 0.5, tt.PROC_SIDE - c,
                                       c).astype(np.float32)
    key = jax.random.PRNGKey(100)
    new_state, jax_losses = jax_step(state, b3, b2, key)
    kwargs = {} if model_class in ('metro', 'model25d') else dict(
        mix=torch.tensor(tt.jax_mix(key, len(b3['image']) + len(b2['image']))))
    port_losses = {k: v.numpy() for k, v in port_step(pstate, b3, b2, **kwargs).items()}
    grads = {n: p.grad.numpy().copy() for n, p in pstate.params().items()}
    exact_zero = None
    if model_class == 'metrabs':
        bias = np.zeros(grads['heatmap_heads.conv_final.bias'].shape, bool)
        bias[:pstate.model.heatmap_heads.n_points] = True
        exact_zero = {'heatmap_heads.conv_final.bias': bias}
    check_step([state, new_state], [tt.to_numpy(jax_losses)], pstate, [port_losses], grads,
               tcfg, exact_zero=exact_zero)
    return port_losses


@pytest.mark.parametrize('model_class,bn_inference',
                         [('metro', False), ('model25d', False), ('model25d', True)],
                         ids=['metro', 'model25d', 'model25d_bn_inference'])
def test_metro_and_model25d_steps_match_jax(model_class, bn_inference):
    losses = run_family(model_class, bn_inference=bn_inference)
    want = {'metro': {'loss3d', 'loss2d', 'loss'},
            'model25d': {'loss23d', 'loss_z', 'loss3d', 'loss2d', 'loss'}}[model_class]
    assert set(losses) == want


def test_transform_coords_step_matches_jax():
    run_family('metrabs', 'transform_coords', transform_coords=True)


@pytest.mark.parametrize('stop_gradient_latent', [True, False], ids=['sg', 'no_sg'])
@pytest.mark.parametrize('start_step', [0, TEACHER_ON], ids=['teacher_off', 'teacher_on'])
def test_predict_all_and_latents_step_matches_jax(start_step, stop_gradient_latent):
    losses = run_family('metrabs', 'predict_all_and_latents', start_step=start_step,
                        predict_all_and_latents=True, stop_gradient_latent=stop_gradient_latent)
    assert len(losses) == 13
    teacher = losses['loss_3dbatch'] - (
        losses['loss_allhead_vs_gt'] + losses['loss_latentheadreconstruction_vs_gt']
        + losses['loss_allhead_ae_vs_gt'] + losses['loss_allhead_vs_reconstr'])
    want = losses['loss_latenthead_vs_latents_from_allhead'] if start_step else 0.0
    np.testing.assert_allclose(teacher, want, rtol=1e-4, atol=1e-6)


def test_regularize_to_manifold_step_matches_jax():
    losses = run_family('metrabs', regularize_to_manifold=True)
    assert {'loss_pred_vs_reconstr', 'loss_pred_vs_reconstr_2dbatch'} <= set(losses)


@pytest.mark.parametrize('latent_mode,tcfg_kwargs,affine', [
    ('', dict(predict_all_and_latents=True), True),
    ('', dict(transform_coords=True), True),
    ('predict_all_and_latents', dict(transform_coords=True), True),
    ('transform_coords', dict(transform_coords=True), False),
    ('', dict(regularize_to_manifold=True), False)],
    ids=['all_and_latents_on_plain', 'transform_on_plain', 'transform_on_all_and_latents',
         'latent_without_weights', 'manifold_without_weights'])
def test_mismatched_modes_and_missing_weights_raise_as_jax(latent_mode, tcfg_kwargs, affine):
    cfg, tcfg = tt.cfgs('tiny')
    tcfg = dataclasses.replace(tcfg, **tcfg_kwargs)
    weights = affine_weights() if affine else None
    with pytest.raises(ValueError) as want:
        jax_loop.make_train_step(jax_model(cfg, 'metrabs', latent_mode), None, H36M_17, LSP_14,
                                 cfg, tcfg, affine_weights=weights)
    pcfg, ptcfg = tt.port_cfgs(cfg, tcfg)
    with pytest.raises(ValueError) as got:
        loop.make_train_step(port_model(pcfg, 'metrabs', latent_mode), None,
                             skeletons.H36M_17, skeletons.LSP_14, pcfg, ptcfg,
                             affine_weights=weights)
    assert str(got.value) == str(want.value)


def test_family_steps_refuse_other_models():
    pcfg, ptcfg = tt.port_cfgs(*tt.cfgs('tiny'))
    metrabs = port_model(pcfg, 'metrabs', '')
    for maker in (loop.make_train_step_metro, loop.make_train_step_model25d):
        with pytest.raises(ValueError, match='trains'):
            maker(metrabs, None, skeletons.H36M_17, skeletons.LSP_14, pcfg, ptcfg)
    optimizer = optim.Optimizer(ptcfg)
    state = loop.create_train_state(port_model(pcfg, 'metro', ''), optimizer, device='cpu')
    step = loop.make_train_step_metro(port_model(pcfg, 'metro', ''), optimizer,
                                      skeletons.H36M_17, skeletons.LSP_14, pcfg, ptcfg)
    with pytest.raises(ValueError, match='another model'):
        step(state, *tt.make_batches(np.random.default_rng(0)))
