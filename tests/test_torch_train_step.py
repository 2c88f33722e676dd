"""The port's train step against the JAX package's, from the same state,
batches and mix (tests/_torch_train.py has the fixtures and tolerances),
with `TinyBackbone(use_bn=True)`: a step in train mode and in inference mode
(`bn_inference`), and three micro-steps with gradient accumulation. The
EffNetV2 cases are in tests/test_torch_train_effnet.py.
"""

import jax
import numpy as np
import pytest
import torch

from metrabs_tpu.pipeline.skeletons import H36M_17, LSP_14
from metrabs_tpu.train import loop as jax_loop
from metrabs_tpu.train import optim as jax_optim
from metrabs_tpu_torch.pipeline import skeletons
from metrabs_tpu_torch.train import loop
from tests import _torch_train as tt

from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def run_both(backbone: str, *, ghost_splits=1, bn_inference=False, n_steps=1, seed=0,
             backbone_dtypes=(None, None), batch=(4, 4), **tcfg_kwargs):
    """Runs `n_steps` steps on both sides (the JAX and the port backbone
    computing in `backbone_dtypes`, default float32) on batches of
    `batch` = (3D, 2D) examples; returns (jax states, jax losses, port
    state, port losses, port gradients of the first step, tcfg)."""
    import dataclasses
    cfg, tcfg = tt.cfgs(backbone)
    tcfg = dataclasses.replace(tcfg, **tcfg_kwargs)
    model, tx, state = tt.jax_train_state(
        cfg, tcfg, tt.jax_backbone(backbone, ghost_splits, backbone_dtypes[0]), seed)
    optimizer, pstate = tt.port_train_state(
        cfg, tcfg, tt.port_backbone(backbone, ghost_splits, dtype=backbone_dtypes[1]), state)
    jax_step = jax.jit(jax_loop.make_train_step(model, tx, H36M_17, LSP_14, cfg, tcfg,
                                                bn_inference=bn_inference))
    pcfg, ptcfg = tt.port_cfgs(cfg, tcfg)
    port_step = loop.make_train_step(pstate.model, optimizer, skeletons.H36M_17,
                                     skeletons.LSP_14, pcfg, ptcfg, bn_inference=bn_inference)
    rng = np.random.default_rng(seed + 1)
    jax_states, jax_losses, port_losses = [state], [], []
    first_grads = None
    for i in range(n_steps):
        b3, b2 = tt.make_batches(rng, *batch)
        key = jax.random.PRNGKey(100 + i)
        state, losses = jax_step(state, b3, b2, key)
        jax_states.append(state)
        jax_losses.append(tt.to_numpy(losses))
        mix = torch.tensor(tt.jax_mix(key, sum(batch)))
        port_losses.append({k: v.numpy() for k, v in port_step(pstate, b3, b2, mix=mix).items()})
        if i == 0:
            first_grads = {n: p.grad.numpy().copy() for n, p in pstate.params().items()}
    return jax_states, jax_losses, pstate, port_losses, first_grads, tcfg


def adam_state(opt_state):
    """The ScaleByAdamState inside adamw (or MultiSteps' inner adamw)."""
    inner = getattr(opt_state, 'inner_opt_state', opt_state)
    return inner[0]


def check_step(jax_states, jax_losses, pstate, port_losses, first_grads, tcfg,
               exact_zero=None):
    """`exact_zero`: `tt.assert_params_moved_alike`'s."""
    for want, got in zip(jax_losses, port_losses):
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=tt.LOSS_RTOL, err_msg=k)
    mu1 = tt.flat_jax_params(adam_state(jax_states[1].opt_state).mu)
    if tcfg.grad_accum_steps == 1:
        tt.assert_grads_close(first_grads, {k: v / np.float32(0.1) for k, v in mu1.items()})
    final = jax_states[-1]
    adam = pstate.opt_state.groups['all']
    jax_adam = adam_state(final.opt_state)
    assert adam.count == int(jax_adam.count)
    tt.assert_trees_close(tt.flat_port(adam.mu), tt.flat_jax_params(jax_adam.mu), 'mu')
    tt.assert_trees_close(tt.flat_port(adam.nu), tt.flat_jax_params(jax_adam.nu), 'nu')
    buffers = {k: v.numpy() for k, v in pstate.model.state_dict().items()
               if k.endswith(('running_mean', 'running_var'))}
    from metrabs_tpu_torch.io.weights import torch_state_dict_from_flax
    jax_stats = {k: v.numpy() for k, v in torch_state_dict_from_flax(
        {'batch_stats': tt.to_numpy(final.batch_stats)}).items()}
    tt.assert_trees_close(buffers, jax_stats, 'batch_stats')
    lr = float(jax_optim.lr_schedule(tcfg)(0))
    port_params, jax_params = tt.flat_port(pstate.params()), tt.flat_jax_params(final.params)
    tt.assert_ema_close(tt.flat_port(pstate.ema_params), tt.flat_jax_params(final.ema_params),
                        port_params, jax_params, tcfg.ema_momentum)
    tt.assert_params_moved_alike(port_params, jax_params, lr, exact_zero)
    assert pstate.step == int(final.step)


@pytest.mark.parametrize('bn_inference', [False, True], ids=['train', 'bn_inference'])
def test_tiny_train_step_matches_jax(bn_inference):
    out = run_both('tiny', bn_inference=bn_inference)
    check_step(*out)
    stats_moved = any(
        not np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(out[0][0].batch_stats),
            jax.tree_util.tree_leaves(out[0][1].batch_stats)))
    assert stats_moved != bn_inference


def test_tiny_train_steps_with_accumulation_match_jax():
    """Three micro-steps, an update every second (optax.MultiSteps), the EMA
    blended on the applied one only; the accumulated gradient and the
    counters of the last micro-step too (a gradient: the gradient
    tolerance)."""
    jax_states, *rest = out = run_both('tiny', n_steps=3, grad_accum_steps=2)
    check_step(*out)
    final, pstate = jax_states[-1].opt_state, rest[1]
    assert (pstate.opt_state.mini_step, pstate.opt_state.gradient_step) == (
        int(final.mini_step), int(final.gradient_step)) == (1, 1)
    tt.assert_grads_close(tt.flat_port(pstate.opt_state.acc_grads),
                          tt.flat_jax_params(final.acc_grads))
