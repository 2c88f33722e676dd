"""What the port's training writes and reads:

 - a package of a crop model the port trained (`save_pose_estimator_package`
   of its EMA weights) loads in the JAX package's `load_pose_estimator` and
   in the port's, and both give the same poses (the tolerances of
   tests/test_torch_estimator.py); its msgpack file is the bytes flax's
   `msgpack_serialize` writes;
 - a JAX `TrainState` (plain AdamW; `MultiSteps` with dual learning rates
   and a bfloat16 first moment) carried into the port with `load_flax_train_state` and back with
   `flax_train_state_dict` is the state it was;
 - a train-state checkpoint saved and restored in the port resumes to the
   same next step, with the JAX package's keep-2 policy and restore
   precedence.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from metrabs_tpu.io.packaging import load_pose_estimator as jax_load_pose_estimator
from metrabs_tpu_torch import config
from metrabs_tpu_torch.io import checkpoints, weights
from metrabs_tpu_torch.io.packaging import load_pose_estimator, save_pose_estimator_package
from metrabs_tpu_torch.models.metrabs import build_crop_model
from metrabs_tpu_torch.pipeline import skeletons
from metrabs_tpu_torch.train import loop, optim
from tests import _torch_train as tt
from tests.test_torch_estimator import compare, frames_and_boxes

import chip_smoke

from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def port_step_fn(model, cfg, tcfg, optimizer):
    return loop.make_train_step(model, optimizer, skeletons.H36M_17, skeletons.LSP_14, cfg,
                                tcfg)


def trained_state(seed=0, n_steps=1):
    """An EffNetV2-S@64 float32 crop model with minted weights (3D head
    agreeing with the 2D head), after `n_steps` port train steps."""
    cfg = config.ModelConfig(proc_side=tt.PROC_SIDE, backbone='efficientnetv2-s', n_joints=17,
                             dtype='float32', backbone_scan_blocks=False)
    tcfg = config.TrainConfig(training_steps=1000, ema_momentum=0.9)
    model = build_crop_model(cfg)
    variables = chip_smoke.mint_crop_variables(cfg, torch.Generator().manual_seed(seed))
    model.load_state_dict(weights.crop_model_state_dict_from_flax(variables, cfg))
    optimizer = optim.Optimizer(tcfg)
    state = loop.create_train_state(model, optimizer, device='cpu')
    step = port_step_fn(model, cfg, tcfg, optimizer)
    rng = np.random.default_rng(seed)
    for i in range(n_steps):
        step(state, *tt.make_batches(rng, 2, 2), generator=torch.Generator().manual_seed(i))
    return cfg, state


def test_trained_package_loads_in_both_packages(tmp_path):
    cfg, state = trained_state()
    variables = weights.flax_variables_from_state_dict(state.ema_state_dict())
    save_pose_estimator_package(str(tmp_path), cfg=cfg, aug_cfg=config.AugConfig(),
                                crop_model_variables=variables, joint_info=skeletons.H36M_17)
    raw = (tmp_path / 'crop_model.msgpack').read_bytes()
    assert raw == serialization.msgpack_serialize({'variables': variables})
    with pytest.warns(UserWarning, match='bone_mean_lengths'):
        theirs = jax_load_pose_estimator(str(tmp_path))
    ours = load_pose_estimator(str(tmp_path), device='cpu')
    frames, boxes, valid = frames_and_boxes()
    want = theirs.estimate_poses_batched(frames, boxes, valid, num_aug=2)
    got = ours.estimate_poses_batched(frames, boxes, valid, num_aug=2)
    compare(got, want, valid)
    # The EMA moved away from the minted weights, and the package holds it.
    minted = chip_smoke.mint_crop_variables(cfg, torch.Generator().manual_seed(0))
    stem = lambda v: v['params']['backbone']['stem_conv']['kernel']
    assert not np.array_equal(stem(variables), stem(minted))


@pytest.mark.parametrize('case', [{}, dict(dual_finetune_lr=True, grad_accum_steps=3,
                                           optimizer_mu_dtype='bfloat16')],
                         ids=['adamw', 'multisteps_dual_lr_mu_bf16'])
def test_jax_train_state_round_trip(case):
    """JAX -> port -> JAX, after one JAX step (nonzero moments and counts):
    plain AdamW, and `MultiSteps` around `multi_transform` of two AdamWs
    with a bfloat16 first moment (every optimizer-state branch at once)."""
    from metrabs_tpu.pipeline.skeletons import H36M_17, LSP_14
    from metrabs_tpu.train import loop as jax_loop
    cfg, tcfg = tt.cfgs('tiny')
    tcfg = dataclasses.replace(tcfg, **case)
    model, tx, state = tt.jax_train_state(cfg, tcfg, tt.jax_backbone('tiny'))
    jax_step = jax.jit(jax_loop.make_train_step(model, tx, H36M_17, LSP_14, cfg, tcfg))
    state, _ = jax_step(state, *tt.make_batches(np.random.default_rng(0)),
                        jax.random.PRNGKey(0))
    _, pstate = tt.port_train_state(cfg, tcfg, tt.port_backbone('tiny'), state)
    assert pstate.step == 1
    back = serialization.from_state_dict(state, weights.flax_train_state_dict(pstate))
    want, got = jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(back)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, np.float32), np.asarray(w, np.float32))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(state)


def tiny_state(seed):
    cfg, tcfg = tt.port_cfgs(*tt.cfgs('tiny'))
    torch.manual_seed(seed)
    model = build_crop_model(dataclasses.replace(cfg, backbone='tiny'))
    optimizer = optim.Optimizer(tcfg)
    return cfg, tcfg, optimizer, loop.create_train_state(model, optimizer, device='cpu')


def test_checkpoint_resumes_to_the_same_next_step(tmp_path):
    cfg, tcfg, optimizer, state = tiny_state(0)
    step = port_step_fn(state.model, cfg, tcfg, optimizer)
    rng = np.random.default_rng(0)
    manager = checkpoints.CheckpointManager(str(tmp_path / 'ckpt'), save_interval_steps=2)
    saved = []
    for i in range(4):
        step(state, *tt.make_batches(rng, 2, 2), generator=torch.Generator().manual_seed(i))
        saved.append(manager.save(state.step, state))
    assert saved == [False, True, False, True]
    batches = tt.make_batches(rng, 2, 2)
    want = step(state, *batches, generator=torch.Generator().manual_seed(9))

    _, _, optimizer2, fresh = tiny_state(1)
    restored, at = checkpoints.restore_train_state(str(tmp_path / 'ckpt'), fresh)
    assert restored is fresh and at == 4 == fresh.step
    got = port_step_fn(fresh.model, cfg, tcfg, optimizer2)(
        fresh, *batches, generator=torch.Generator().manual_seed(9))
    assert all(torch.equal(got[k], want[k]) for k in want)
    for (n, p), (_, q) in zip(state.model.state_dict().items(), fresh.model.state_dict().items()):
        assert torch.equal(p, q), n
    assert all(torch.equal(state.ema_params[n], fresh.ema_params[n]) for n in state.ema_params)


def test_checkpoint_policy_and_restore_precedence(tmp_path):
    _, _, _, state = tiny_state(0)
    manager = checkpoints.CheckpointManager(str(tmp_path / 'run'))  # keep 2, every 2000
    for s in (2000, 3000, 4000, 6000, 4000):
        state.step = s
        manager.save(s, state)
    assert manager.all_steps() == [4000, 6000]
    other = checkpoints.CheckpointManager(str(tmp_path / 'other'), save_interval_steps=1)
    state.step = 7
    other.save(7, state)
    state.step = 11
    other.save(11, state)
    init = other.path(7)
    _, _, _, fresh = tiny_state(1)
    assert checkpoints.restore_train_state(manager, fresh, load_path=other.path(11),
                                           init_path=init)[1] == -1 and fresh.step == 11
    assert checkpoints.restore_train_state(manager, fresh, init_path=init)[1] == 6000
    empty = str(tmp_path / 'empty')
    assert checkpoints.restore_train_state(empty, fresh, init_path=init)[1] == 0
    assert fresh.step == 7
    assert checkpoints.restore_train_state(empty, fresh) == (None, 0)
