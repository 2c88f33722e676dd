"""Shared fixtures of the training parity tests (tests/test_torch_train_*.py):
the same seeded batches, minted weights and 2D/3D mixing factor go through a
JAX train step (`metrabs_tpu.train.loop.make_train_step`) and the port's
(`metrabs_tpu_torch.train.loop.make_train_step`), the JAX state carried
across with `metrabs_tpu_torch.io.weights.load_flax_train_state`.

Tolerances of a compared step: losses rtol 1e-4; each gradient within
1e-4 of its tensor's largest |g| (JAX's gradient read from the first step's
first moment, mu / (1 - b1)); mu, nu, batch_stats and EMA rtol 1e-4, atol
1e-7; updated parameters within 1e-2 lr on at least 99.9% of elements and
within 2 lr everywhere, as Adam's first step moves every element by about
lr, in a direction that flips where |g| is near 0. The EMA blends the
updated parameters in, so it is held to the state tolerance plus the share
of their difference that it carries (`assert_ema_close`).

A tensor whose gradient is zero in exact arithmetic holds only rounding
noise on either side: the bias of a block's last BatchNorm, whose shift
every later train-mode BatchNorm cancels (JAX in float64 gives ~1e-17).
Where JAX's largest |g| of a tensor is below 1e-6 of the model's largest,
the port's must stay below 1e-4 of the model's largest instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from tests import _torch_port

PROC_SIDE = 64
LOSS_RTOL = 1e-4
GRAD_REL = 1e-4
STATE = dict(rtol=1e-4, atol=1e-7)


@pytest.fixture
def one_torch_thread():
    """The test on one intra-op thread: at these sizes more threads do not
    speed torch up, and the suite's parallel workers share the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(backbone: str):
    from metrabs_tpu.config import ModelConfig, TrainConfig
    cfg = ModelConfig(proc_side=PROC_SIDE, depth=8, n_joints=17, dtype='float32',
                      backbone=backbone, backbone_scan_blocks=False)
    tcfg = TrainConfig(training_steps=1000, batch_size=4, batch_size_2d=4, ema_momentum=0.99)
    return cfg, tcfg


def port_cfgs(cfg, tcfg):
    from metrabs_tpu_torch import config
    return (config.ModelConfig(**dataclasses.asdict(cfg)),
            config.TrainConfig(**dataclasses.asdict(tcfg)))


def make_batches(rng, n3: int = 4, n2: int = 4, side: int = PROC_SIDE):
    """A 3D and a 2D batch with some joints marked invalid, and targets far
    from any prediction the 2x2 heatmaps can decode (root-relative x, y
    beyond +-900 mm and z beyond +-1300 mm; 2D targets outside the FOV band
    the predictions are kept to), so that no L1 term sits near its kink,
    where float rounding would flip the sign of its gradient."""
    k = _torch_port.camera(side, side, 60.0)
    sign = lambda shape: rng.choice([-1.0, 1.0], size=shape)
    offsets = np.concatenate([sign((n3, 17, 2)) * rng.uniform(900, 1100, (n3, 17, 2)),
                              sign((n3, 17, 1)) * rng.uniform(1300, 1500, (n3, 17, 1))], -1)
    batch3d = dict(
        image=rng.uniform(size=(n3, side, side, 3)).astype(np.float32),
        intrinsics=np.tile(k, (n3, 1, 1)),
        coords3d_true=(offsets + np.array([0, 0, 3000])).astype(np.float32),
        joint_validity_mask=np.ones((n3, 17), bool))
    coords2d = rng.uniform(2, 14, size=(n2, 14, 2))
    batch2d = dict(
        image=rng.uniform(size=(n2, side, side, 3)).astype(np.float32),
        intrinsics=np.tile(k, (n2, 1, 1)),
        coords2d_true=np.where(sign(coords2d.shape) > 0, side - coords2d,
                               coords2d).astype(np.float32),
        joint_validity_mask=np.ones((n2, 14), bool))
    batch3d['joint_validity_mask'][0, [2, 5]] = False
    batch2d['joint_validity_mask'][1, [0, 13]] = False
    return batch3d, batch2d


def jax_backbone(name: str, ghost_splits: int = 1, dtype=None):
    import jax.numpy as jnp
    from metrabs_tpu.models.backbones.builder import build_backbone
    from metrabs_tpu.models.backbones.tiny import TinyBackbone
    dtype = dtype or jnp.float32
    if name == 'tiny':
        return TinyBackbone(width=16, dtype=dtype, use_bn=True)
    return build_backbone(name, dtype=dtype, scan_blocks=False, ghost_splits=ghost_splits)


def port_backbone(name: str, ghost_splits: int = 1, remat: bool = False, dtype=None):
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    from metrabs_tpu_torch.models.backbones.tiny import TinyBackbone
    if name == 'tiny':
        return TinyBackbone(width=16, use_bn=True, dtype=dtype)
    return build_backbone(name, ghost_splits=ghost_splits, remat=remat, dtype=dtype)


def jax_train_state(cfg, tcfg, backbone, seed: int = 0):
    """(model, tx, state) with minted weights (random BN statistics)."""
    import jax
    import jax.numpy as jnp
    from metrabs_tpu.models.metrabs import Metrabs
    from metrabs_tpu.train import loop, optim

    model = Metrabs(cfg=cfg, backbone=backbone)
    tx = optim.build_optimizer(tcfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, PROC_SIDE, PROC_SIDE, 3)), jnp.eye(3)[None])
    variables = _torch_port.mint_variables(shapes, np.random.default_rng(seed))
    params = variables['params']
    state = loop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            batch_stats=variables.get('batch_stats', {}),
                            opt_state=tx.init(params), ema_params=params)
    return model, tx, state


def port_train_state(cfg, tcfg, backbone, jax_state):
    """The port's state (CPU) holding `jax_state`."""
    from flax import serialization
    from metrabs_tpu_torch.io.weights import load_flax_train_state
    from metrabs_tpu_torch.models.metrabs import Metrabs
    from metrabs_tpu_torch.train import loop, optim

    pcfg, ptcfg = port_cfgs(cfg, tcfg)
    optimizer = optim.Optimizer(ptcfg)
    state = loop.create_train_state(Metrabs(pcfg, backbone), optimizer, device='cpu')
    load_flax_train_state(state, to_numpy(serialization.to_state_dict(jax_state)))
    return optimizer, state


def to_numpy(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_mix(rng_key, n: int):
    """The mix JAX's train step draws from `rng_key`, as float32."""
    import jax
    rng_mix, _ = jax.random.split(rng_key)
    return np.asarray(jax.random.uniform(rng_mix, (n, 1, 1)), np.float32)


def flat_port(named):
    """{torch name: numpy} of port tensors."""
    return {k: v.detach().float().numpy() for k, v in named.items()}


def flat_jax_params(tree):
    """{torch name: numpy, torch layout} of a JAX params tree."""
    import torch
    from metrabs_tpu_torch.io.weights import torch_state_dict_from_flax
    return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in torch_state_dict_from_flax({'params': to_numpy(tree)}).items()}


def assert_grads_close(port_grads, jax_grads):
    assert port_grads.keys() == jax_grads.keys()
    largest = max(np.abs(g).max() for g in jax_grads.values())
    for name, want in jax_grads.items():
        scale = np.abs(want).max()
        if scale < 1e-6 * largest:  # zero in exact arithmetic (module docstring)
            assert np.abs(port_grads[name]).max() <= GRAD_REL * largest, name
        else:
            err = np.abs(port_grads[name] - want).max()
            assert err <= GRAD_REL * scale, (name, err, scale)


def assert_params_moved_alike(port_params, jax_params, lr: float, exact_zero=None):
    """`exact_zero` {name: bool mask}: elements whose gradient is zero in
    exact arithmetic, which Adam moves by rounding noise over its epsilon
    (at most ~0.1 lr); they must stay within 0.2 lr of JAX's and are left
    out of the share moved alike."""
    exact_zero = exact_zero or {}
    near = total = 0
    for name, want in jax_params.items():
        diff = np.abs(port_params[name] - want)
        assert diff.max() <= 2 * lr, (name, diff.max(), lr)
        if name in exact_zero:
            assert diff[exact_zero[name]].max() <= 0.2 * lr, (name, diff.max(), lr)
            diff = diff[~exact_zero[name]]
        near += int((diff <= 1e-2 * lr).sum())
        total += diff.size
    assert near >= 0.999 * total, (near, total)


def assert_trees_close(port_named, jax_named, what: str):
    assert port_named.keys() == jax_named.keys(), what
    for name, want in jax_named.items():
        np.testing.assert_allclose(port_named[name], want, **STATE, err_msg=f'{what} {name}')


def assert_ema_close(port_ema, jax_ema, port_params, jax_params, momentum: float):
    """The EMA within the state tolerance plus the share of the updated
    parameters' difference that it blends in: (1 - momentum), or all of it
    at momentum 1."""
    assert port_ema.keys() == jax_ema.keys()
    carried = 1.0 if momentum >= 1.0 else 1.0 - momentum
    for name, want in jax_ema.items():
        err = np.abs(port_ema[name] - want)
        limit = carried * np.abs(port_params[name] - jax_params[name]) + STATE['atol'] + (
            STATE['rtol'] * np.abs(want))
        assert np.all(err <= limit), (name, (err - limit).max())
