"""The port's training losses (`metrabs_tpu_torch.train.losses`) against the
JAX package's (`metrabs_tpu.train.losses`) on the same predictions and
batches, made from a numpy seed: the train-mode absolute reconstruction of
the concatenated 3D + 2D batch with a per-sample mix, then every loss, at
the steps around the weak-perspective warm-up (0, 499, 500) and around
`absloss_start_step` (4999, 5000, 5001), with invalid joints, ground truth
closer than 300 mm and joints outside the field of view. Tolerances: losses
rtol 1e-5, atol 1e-6; reconstructed joints rtol 1e-5, atol 1e-3 mm; the
gradients of the loss with respect to both heads within 1e-4 of their
largest |g|, and finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu import config as jax_config
from metrabs_tpu.pipeline import skeletons as jax_skeletons
from metrabs_tpu.train import losses as jax_losses
from metrabs_tpu_torch import config
from metrabs_tpu_torch.ops import reconstruct
from metrabs_tpu_torch.pipeline import skeletons
from metrabs_tpu_torch.train import losses

from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

LOSSES = dict(rtol=1e-5, atol=1e-6)
COORDS = dict(rtol=1e-5, atol=1e-3)
GRAD_REL = 1e-4
N3, N2 = 5, 4
STEPS = [0, 499, 500, 4999, 5000, 5001]


def inputs(seed=0, mask_3d=True):
    """Head outputs of the concatenated batch, the per-sample mix, and the
    3D and 2D batches (numpy)."""
    rng = np.random.default_rng(seed)
    n = N3 + N2
    head2d = rng.uniform(-20, 276, (n, 17, 2)).astype(np.float32)
    head2d[1] = rng.uniform(-200, -50, (17, 2))  # a crop with every joint outside the FOV
    head3d = np.concatenate([rng.normal(0, 300, (n, 17, 2)), rng.normal(0, 200, (n, 17, 1))],
                            -1).astype(np.float32)
    f = rng.uniform(300, 600, n)
    k = np.zeros((n, 3, 3), np.float32)
    k[:, 0, 0], k[:, 1, 1], k[:, 2, 2] = f, f * rng.uniform(0.95, 1.05, n), 1
    k[:, :2, 2] = rng.uniform(110, 146, (n, 2))
    coords3d = np.concatenate([rng.normal(0, 400, (N3, 17, 2)),
                               rng.uniform(1500, 7000, (N3, 17, 1))], -1)
    coords3d[2, :4, 2] = rng.uniform(50, 250, 4)  # closer than 300 mm
    coords3d[3, :, 2] += 12000  # far: z down-weighted
    mask3d = rng.uniform(size=(N3, 17)) > 0.2
    coords2d = rng.uniform(-80, 330, (N2, 14, 2))
    mask2d = rng.uniform(size=(N2, 14)) > 0.2
    batch3d = dict(intrinsics=k[:N3], coords3d_true=coords3d.astype(np.float32))
    if mask_3d:
        batch3d['joint_validity_mask'] = mask3d
    batch2d = dict(intrinsics=k[N3:], coords2d_true=coords2d.astype(np.float32),
                   joint_validity_mask=mask2d)
    mix = rng.uniform(size=(n, 1, 1)).astype(np.float32)
    return head2d, head3d, k, mix, batch3d, batch2d


def run_jax(head2d, head3d, k, mix, batch3d, batch2d, step, cfg, tcfg):
    groups = jax_losses.get_2d_joint_index_groups(jax_skeletons.H36M_17, jax_skeletons.LSP_14)

    def loss_fn(h2, h3):
        coords = jax_losses.reconstruct_absolute_trainmode(h2, h3, k, mix, jnp.int32(step),
                                                           cfg=cfg)
        out = jax_losses.compute_losses(coords[:N3], coords[N3:], batch3d, batch2d, groups,
                                        cfg=cfg, tcfg=tcfg, step=jnp.int32(step))
        return out['loss'], (coords, out)

    (_, (coords, out)), grads = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(head2d), jnp.asarray(head3d))
    return (np.asarray(coords), {k: np.asarray(v) for k, v in out.items()},
            [np.asarray(g) for g in grads])


def run_port(head2d, head3d, k, mix, batch3d, batch2d, step, cfg, tcfg):
    groups = losses.get_2d_joint_index_groups(skeletons.H36M_17, skeletons.LSP_14)
    h2 = torch.tensor(head2d, requires_grad=True)
    h3 = torch.tensor(head3d, requires_grad=True)
    t = lambda batch: {key: torch.as_tensor(v) for key, v in batch.items()}
    coords = losses.reconstruct_absolute_trainmode(h2, h3, torch.tensor(k), torch.tensor(mix),
                                                   step, cfg=cfg)
    out = losses.compute_losses(coords[:N3], coords[N3:], t(batch3d), t(batch2d), groups,
                                cfg=cfg, tcfg=tcfg, step=step)
    out['loss'].backward()
    return (coords.detach().numpy(), {key: v.detach().numpy() for key, v in out.items()},
            [h2.grad.numpy(), h3.grad.numpy()])


@pytest.mark.parametrize('mean_relative', [True, False], ids=['mean_rel', 'root_rel'])
@pytest.mark.parametrize('step', STEPS)
def test_losses_match_jax(step, mean_relative):
    jcfg, jtcfg = jax_config.ModelConfig(), jax_config.TrainConfig(mean_relative=mean_relative)
    cfg, tcfg = config.ModelConfig(), config.TrainConfig(mean_relative=mean_relative)
    args = inputs(seed=step, mask_3d=mean_relative)
    want_coords, want, want_grads = run_jax(*args, step, jcfg, jtcfg)
    got_coords, got, got_grads = run_port(*args, step, cfg, tcfg)
    np.testing.assert_allclose(got_coords, want_coords, **COORDS)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **LOSSES, err_msg=key)
    for g, w in zip(got_grads, want_grads):
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max()


def test_absolute_loss_gate_and_weak_perspective_warmup():
    """The absolute term enters only after absloss_start_step, and the
    reconstruction switches from weak to full perspective at step 500."""
    cfg, tcfg = config.ModelConfig(), config.TrainConfig()
    args = inputs(seed=1)
    at = {step: run_port(*args, step, cfg, tcfg) for step in (499, 500, 5000, 5001)}
    assert not np.allclose(at[499][0], at[500][0])
    np.testing.assert_array_equal(at[500][0], at[5001][0])
    assert at[5001][1]['loss_3dbatch'] > at[5000][1]['loss_3dbatch']
    np.testing.assert_array_equal(at[5000][1]['loss_2dbatch'], at[5001][1]['loss_2dbatch'])


def test_helpers_match_jax():
    rng = np.random.default_rng(3)
    coords = rng.normal(0, 500, (3, 17, 3)).astype(np.float32)
    mask = rng.uniform(size=(3, 17)) > 0.3
    for center_is_mean, m in ((True, mask), (True, None), (False, None)):
        want = jax_losses.center_relative_pose(coords, m, center_is_mean)
        got = losses.center_relative_pose(torch.tensor(coords),
                                          None if m is None else torch.tensor(m), center_is_mean)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    groups = losses.get_2d_joint_index_groups(skeletons.H36M_17, skeletons.LSP_14)
    assert groups == jax_losses.get_2d_joint_index_groups(jax_skeletons.H36M_17,
                                                          jax_skeletons.LSP_14)
    np.testing.assert_allclose(losses.get_2dlike_joints(torch.tensor(coords), groups).numpy(),
                               jax_losses.get_2dlike_joints(coords, groups), rtol=1e-6)
    with pytest.raises(ValueError, match='match no 3D joint'):
        losses.get_2d_joint_index_groups(skeletons.H36M_17,
                                         skeletons.make_joint_info(['nose'], []))
    from metrabs_tpu.ops import reconstruct as jax_reconstruct
    k = np.tile(np.array([[500, 0, 128], [0, 500, 128], [0, 0, 1]], np.float32), (3, 1, 1))
    coords[0, 0, 2] = 0.2  # clamped to 1 mm
    np.testing.assert_allclose(
        reconstruct.project_pose(torch.tensor(coords), torch.tensor(k)).numpy(),
        jax_reconstruct.project_pose(coords, k), rtol=1e-5)


@pytest.mark.parametrize('weak', [False, True], ids=['full', 'weak'])
def test_reconstruction_gradients_finite_without_valid_joints(weak):
    """A crop with no joint inside the FOV (every weight 1e-4 in the solve,
    no joint in the weak-perspective means) still gives finite gradients."""
    head2d, head3d, k, mix, *_ = inputs(seed=2)
    head2d[:] = -500.0
    h2 = torch.tensor(head2d, requires_grad=True)
    h3 = torch.tensor(head3d, requires_grad=True)
    out = reconstruct.reconstruct_absolute(
        h2, h3, torch.tensor(k), proc_side=256, stride=32, mix_3d_inside_fov=torch.tensor(mix),
        weak_perspective=weak)
    out.square().sum().backward()
    assert torch.isfinite(out).all()
    assert torch.isfinite(h2.grad).all() and torch.isfinite(h3.grad).all()
    assert h3.grad.abs().max() > 0
