"""The port's optimizer (`metrabs_tpu_torch.train.optim` and the step's tail
`train.loop.apply_gradients`) against the JAX package's optax chain
(`metrabs_tpu.train.optim.build_optimizer` and `train.loop._apply_gradients`)
on the same parameters and gradients, made from a numpy seed: the learning
rate schedules around their phase switches, and 1 and 5 steps of AdamW with
a bfloat16 first moment, dual learning rates, the kernel-norm projection and
`MultiSteps` accumulation over 3 micro-steps with the EMA blended on the
applied ones only. Tolerance: rtol 1e-6 (float32 on both sides).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from metrabs_tpu.config import TrainConfig as JaxTrainConfig
from metrabs_tpu.train import loop as jax_loop
from metrabs_tpu.train import optim as jax_optim
from metrabs_tpu_torch.config import TrainConfig
from metrabs_tpu_torch.io.weights import torch_state_dict_from_flax
from metrabs_tpu_torch.train import loop, optim

from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

RTOL = 1e-6
TRAINING_STEPS = 1000


def jax_tcfg(**kwargs):
    return JaxTrainConfig(training_steps=TRAINING_STEPS, **kwargs)


def port_tcfg(tcfg):
    return TrainConfig(**dataclasses.asdict(tcfg))


@pytest.mark.parametrize('name', ['lr_schedule', 'lr_schedule_finetune_high',
                                  'lr_schedule_finetune_low'])
def test_schedules_match_jax(name):
    tcfg = jax_tcfg()
    theirs = getattr(jax_optim, name)(tcfg)
    ours = getattr(optim, name)(port_tcfg(tcfg))
    for step in (0, 1, 499, 500, 501, 919, 920, 921, 1000):
        want = np.float32(theirs(step))
        assert np.float32(ours(step)) == pytest.approx(want, rel=RTOL), step
    # The phase switches: a jump down by a factor of ~10.
    assert ours(920) < 0.2 * ours(919) if name == 'lr_schedule' else True
    assert ours(500) < 0.2 * ours(499) if name == 'lr_schedule_finetune_high' else True


def jax_params(rng):
    """A backbone with a conv, a depthwise conv and a BN scale, and a head
    with a conv and a bias, float32; kernels with per-channel norms on both
    sides of 1."""
    def kernel(shape):
        k = rng.normal(size=shape) / np.sqrt(np.prod(shape[:3]))
        return (k * rng.uniform(0.3, 2.0, shape[-1])).astype(np.float32)
    return {'backbone': {'conv': {'kernel': kernel((3, 3, 4, 8))},
                         'depthwise': {'kernel': kernel((3, 3, 1, 8))},
                         'norm': {'bn': {'scale': rng.uniform(0.5, 1.5, 8).astype(np.float32)}}},
            'heatmap_heads': {'conv_final': {'kernel': kernel((1, 1, 8, 6)),
                                             'bias': rng.normal(size=6).astype(np.float32)}}}


def to_port(tree):
    """{torch name: tensor} (OIHW kernels) of a JAX params tree; optax's
    MaskedNode leaves (another group's parameters) are dropped."""
    flat = {k: np.asarray(v, np.float32) for k, v in flatten_dict(tree).items()
            if not isinstance(v, optax.MaskedNode)}
    return torch_state_dict_from_flax({'params': unflatten_dict(flat)})


def as_numpy(named):
    return {k: v.detach().float().numpy() for k, v in named.items()}


def assert_close(got, want, what):
    assert got.keys() == want.keys(), what
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=0,
                                   err_msg=f'{what} {name}')


def adam_states(opt_state, tcfg):
    """{group: optax ScaleByAdamState} of the chain."""
    inner = opt_state.inner_opt_state if tcfg.grad_accum_steps > 1 else opt_state
    if tcfg.dual_finetune_lr:
        return {g: s.inner_state[0] for g, s in inner.inner_states.items()}
    return {'all': inner[0]}


CASES = {
    'adamw': {},
    'mu_bf16': dict(optimizer_mu_dtype='bfloat16'),
    'dual_lr': dict(dual_finetune_lr=True),
    'kernel_norm': dict(constrain_kernel_norm=1.0),
    'accum3': dict(grad_accum_steps=3),
}


@pytest.mark.parametrize('n_steps', [1, 5])
@pytest.mark.parametrize('case', list(CASES))
def test_optimizer_steps_match_optax(case, n_steps):
    tcfg = jax_tcfg(ema_momentum=0.9, **CASES[case])
    ptcfg = port_tcfg(tcfg)
    rng = np.random.default_rng(0)
    params = jax_params(rng)
    tx = jax_optim.build_optimizer(tcfg)
    state = jax_loop.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                                opt_state=tx.init(params), ema_params=params)
    apply = jax.jit(lambda s, g: jax_loop._apply_gradients(
        s, lambda p: (sum(jnp.vdot(a, b) for a, b in zip(jax.tree_util.tree_leaves(p),
                                                          jax.tree_util.tree_leaves(g))),
                      ({}, {})), tx, tcfg)[0])

    optimizer = optim.Optimizer(ptcfg)
    ours = to_port(params)
    opt_state = optimizer.init(ours)
    ema = {k: v.clone() for k, v in ours.items()}
    applied = []
    for _ in range(n_steps):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        state = apply(state, grads)
        applied.append(loop.apply_gradients(optimizer, ptcfg, ours, to_port(grads), opt_state,
                                            ema))

    assert_close(as_numpy(ours), as_numpy(to_port(state.params)), 'params')
    assert_close(as_numpy(ema), as_numpy(to_port(state.ema_params)), 'ema')
    jax_adams = adam_states(state.opt_state, tcfg)
    assert opt_state.groups.keys() == jax_adams.keys()
    for group, adam in opt_state.groups.items():
        want = jax_adams[group]
        assert adam.count == int(want.count)
        assert all(m.dtype == (torch.bfloat16 if case == 'mu_bf16' else torch.float32)
                   for m in adam.mu.values())
        assert_close(as_numpy(adam.mu), as_numpy(to_port(want.mu)), f'mu {group}')
        assert_close(as_numpy(adam.nu), as_numpy(to_port(want.nu)), f'nu {group}')
    if case == 'accum3':
        assert applied == [i % 3 == 2 for i in range(n_steps)]
        assert (opt_state.mini_step, opt_state.gradient_step) == (
            int(state.opt_state.mini_step), int(state.opt_state.gradient_step))
        assert_close(as_numpy(opt_state.acc_grads),
                     as_numpy(to_port(state.opt_state.acc_grads)), 'acc_grads')
    if case == 'dual_lr':
        assert sorted(adam_states(state.opt_state, tcfg)) == ['backbone', 'heads']
        assert set(opt_state.groups['backbone'].mu) == {n for n in ours
                                                        if n.startswith('backbone.')}
    if case == 'kernel_norm':
        norms = {n: v.flatten(1).norm(dim=1) for n, v in ours.items() if v.ndim == 4}
        assert max(norms['backbone.conv.weight'].max(),
                   norms['backbone.depthwise.weight'].max()) <= 1.0 + 1e-6
        assert norms['heatmap_heads.conv_final.weight'].max() > 1.0  # not the backbone's


def test_ema_update_and_projection_alone():
    rng = np.random.default_rng(1)
    params = jax_params(rng)
    new = jax.tree_util.tree_map(lambda p: p + rng.normal(size=p.shape).astype(np.float32),
                                 params)
    ema, ours = to_port(params), to_port(new)
    optim.ema_update(ema, ours, 0.75)
    assert_close(as_numpy(ema), as_numpy(to_port(jax_optim.ema_update(params, new, 0.75))),
                 'ema')
    optim.project_kernel_norms(ours, 0.5)
    assert_close(as_numpy(ours), as_numpy(to_port(jax_optim.project_kernel_norms(new, 0.5))),
                 'projected')
