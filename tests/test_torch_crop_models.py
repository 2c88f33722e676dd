"""The port's other crop models and their parts against the JAX package's:
`Head3D` and `Head25D` (`models/heads.py`), `heatmap_to_25d`, the
Levenberg-Marquardt bone solve (`ops/lm_solver.py`), `Metro`, `Model25D`
and the two latent modes of `Metrabs`.

Models run on MobileNetV3-Small-mini at 64 px, batch 4, float32 on both
sides, with weights minted from a numpy seed on the JAX side
(`_torch_port.family_variables`, the latent modes' affine constants
included) and carried across by `io.weights`. Tolerances: head and
root-relative outputs rtol 1e-3 and atol 1e-3 of their scale, absolute
poses atol 1 mm + rtol 1e-3 (tests/test_torch_model.py), the bone solve
alone rtol 1e-5 (float32 rounding in ten iterations). Each model case also
checks that another input moves the output ten times further than the port
is from JAX.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.models import heads as jax_heads
from metrabs_tpu.models import metrabs as jax_metrabs
from metrabs_tpu.ops import heatmap as jax_heatmap
from metrabs_tpu.ops import lm_solver as jax_lm
from metrabs_tpu_torch.config import ModelConfig, TrainConfig
from metrabs_tpu_torch.io import weights
from metrabs_tpu_torch.models import heads, metrabs
from metrabs_tpu_torch.ops import heatmap, lm_solver
from metrabs_tpu_torch.pipeline.skeletons import H36M_17, LSP_14
from metrabs_tpu_torch.train import loop, optim
from tests import _torch_port

BACKBONE = 'mobilenetv3-small-mini'
POSES = dict(atol=1.0, rtol=1e-3)
N_LATENTS = 24


def crop_inputs(seed, n=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 64, 64, 3)).astype(np.float32)
    k = np.stack([_torch_port.camera(64, 64, f) for f in rng.uniform(60, 100, n)])
    return x, k.astype(np.float32)


def assert_scaled_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize('kind', ['Head3D', 'Head25D'])
@pytest.mark.parametrize('train', [False, True], ids=['stride_test', 'stride_train'])
def test_heads_match_jax(kind, train):
    jcfg = _torch_port.family_cfg(BACKBONE, depth=6, stride_test=16)
    cfg = ModelConfig(**{f: getattr(jcfg, f) for f in ModelConfig.__dataclass_fields__})
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(3, 4, 4, 40)).astype(np.float32)
    jhead = getattr(jax_heads, kind)(cfg=jcfg, n_points=17, dtype=jnp.float32)
    variables = _torch_port.mint_variables(
        jax.eval_shape(jhead.init, jax.random.PRNGKey(0), feats), rng)
    want = np.asarray(jhead.apply(variables, feats, train=train))
    head = getattr(heads, kind)(cfg, 17, in_channels=40)
    head.load_state_dict(weights.torch_state_dict_from_flax(variables))
    with torch.no_grad():
        got = head(torch.tensor(feats).permute(0, 3, 1, 2), train=train).numpy()
    assert got.shape == want.shape == (3, 17, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_heatmap_to_25d_matches_jax():
    coords = np.random.default_rng(1).uniform(size=(2, 17, 3)).astype(np.float32)
    kwargs = dict(proc_side=256, stride=32, box_size_mm=2200.0)
    for centered in (True, False):
        np.testing.assert_allclose(
            heatmap.heatmap_to_25d(torch.tensor(coords), centered_stride=centered, **kwargs),
            np.asarray(jax_heatmap.heatmap_to_25d(coords, centered_stride=centered, **kwargs)),
            rtol=1e-6)


def bone_problem(seed):
    """Seeded 2D-normalized joints of persons 2-6 m away, their relative
    depths, the H36M bones with each person's own lengths (the cost is 0 at
    the true depth, which pins the float32 optimum; lengths off by a few
    percent leave a flat minimum that float32 cost comparisons resolve only
    to ~1e-4, in JAX with and without jit alike), 20% of the bones weighted
    out as the FOV test does, and a guess 0.5-2x the depth. Returns the
    solver's arguments and each person's true depth."""
    rng = np.random.default_rng(seed)
    bones, _ = _torch_port.bones_25d()
    depth = rng.uniform(2000, 6000, (5, 1, 1))
    cam = rng.normal(0, 300, (5, 17, 3)) + np.concatenate(
        [rng.normal(0, 300, (5, 1, 2)), depth], -1)
    normalized = (cam[..., :2] / cam[..., 2:]).astype(np.float32)
    delta_z = (cam[..., 2] - cam[..., 2].mean(-1, keepdims=True)).astype(np.float32)
    idx = np.asarray(bones)
    lengths = np.linalg.norm(cam[:, idx[:, 0]] - cam[:, idx[:, 1]], axis=-1).astype(np.float32)
    weights_ = (rng.uniform(size=(5, len(bones))) > 0.2).astype(np.float32) + 1e-8
    truth = cam[..., 2].mean(-1)
    guess = (truth * np.array([0.5, 0.7, 1.4, 1.8, 2.0])).astype(np.float32)
    return (normalized, delta_z, lengths, bones, weights_, guess), truth


def test_optimize_z_offset_by_bones_matches_jax():
    args, truth = bone_problem(2)
    want = np.asarray(jax_lm.optimize_z_offset_by_bones(*args))
    got = lm_solver.optimize_z_offset_by_bones(
        *(torch.tensor(a) for a in args[:3]), args[3], torch.tensor(args[4]),
        torch.tensor(args[5])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # From guesses 0.5-2x off, the solve finds each person's depth.
    np.testing.assert_allclose(got, truth, rtol=1e-4)


def test_inv3x3_matches_numpy():
    m = np.random.default_rng(3).normal(size=(6, 3, 3)) + 3 * np.eye(3)
    np.testing.assert_allclose(lm_solver.inv3x3(torch.tensor(m)).numpy(), np.linalg.inv(m),
                               rtol=1e-10, atol=1e-12)


@functools.lru_cache(maxsize=None)
def models(model_class, latent_mode=''):
    """(JAX model, minted variables, port model in eval mode)."""
    jcfg = _torch_port.family_cfg(BACKBONE)
    n_latents = N_LATENTS if latent_mode else 0
    jmodel = _torch_port.family_model(jcfg, model_class, latent_mode, n_latents)
    variables = _torch_port.family_variables(jmodel, model_class, seed=4)
    manifest = dict(model_config=dataclasses.asdict(jcfg), model_class=model_class,
                    latent_mode=latent_mode, n_latents=n_latents)
    if model_class == 'model25d':
        manifest.update(zip(('bones_25d', 'bone_lengths_ideal'), _torch_port.bones_25d()))
    from metrabs_tpu_torch.io.packaging import crop_model_from_variables
    model, _ = crop_model_from_variables(variables, manifest, device='cpu')
    return jmodel, variables, model


def test_metro_matches_jax():
    jmodel, variables, model = models('metro')
    x, _ = crop_inputs(5)
    want = np.asarray(jax.jit(functools.partial(jmodel.apply, train=False))(variables, x))
    with torch.no_grad():
        got = model(torch.tensor(x)).numpy()
        other = model(torch.tensor(crop_inputs(6)[0])).numpy()
    assert got.shape == (4, 17, 3)
    assert_scaled_close(got, want)
    assert np.abs(other - got).max() > 10 * np.abs(got - want).max()


def test_model25d_matches_jax_with_invalid_samples():
    """The 2.5D head, the neutral pose in invalid slots and the LM bone solve."""
    jmodel, variables, model = models('model25d')
    x, k = crop_inputs(7)
    valid = np.array([True, False, True, True])
    fn = jax.jit(lambda v, x, k, s: (
        jmodel.apply(v, x, train=False, method=jmodel.forward_25d),
        jmodel.apply(v, x, k, train=False, sample_valid=s)))
    want25, want = (np.asarray(a) for a in fn(variables, x, k, valid))
    with torch.no_grad():
        got25 = model.forward_25d(torch.tensor(x)).numpy()
        got = model(torch.tensor(x), torch.tensor(k), torch.tensor(valid)).numpy()
        other = model(torch.tensor(crop_inputs(8)[0]), torch.tensor(k),
                      torch.tensor(valid)).numpy()
    assert_scaled_close(got25, want25)
    assert np.isfinite(got).all() and got.shape == (4, 17, 3)
    np.testing.assert_allclose(got, want, **POSES)
    assert np.abs(other - got)[valid].max() > 10 * np.abs(got - want).max()
    # The neutral pose gives the invalid slot the same reconstruction on
    # both inputs.
    np.testing.assert_allclose(other[~valid], got[~valid], rtol=1e-6)


@pytest.mark.parametrize('latent_mode', ['transform_coords', 'predict_all_and_latents'])
def test_latent_modes_match_jax(latent_mode):
    jmodel, variables, model = models('metrabs', latent_mode)
    assert model.n_raw_points == (N_LATENTS if latent_mode == 'transform_coords'
                                  else N_LATENTS + 17)
    assert model.recombination_weights.dtype == torch.float32
    x, k = crop_inputs(9)
    fn = jax.jit(lambda v, x, k: jmodel.apply(v, x, k, train=False))
    want = np.asarray(fn(variables, x, k))
    with torch.no_grad():
        got = model(torch.tensor(x), torch.tensor(k)).numpy()
        other = model(torch.tensor(crop_inputs(10)[0]), torch.tensor(k)).numpy()
    assert got.shape == (4, 17, 3)
    np.testing.assert_allclose(got, want, **POSES)
    assert np.abs(other - got).max() > 10 * np.abs(got - want).max()
    # The recombinations alone, on the same points.
    pts = np.random.default_rng(11).normal(0, 500, (3, 17, 3)).astype(np.float32)
    latents = np.random.default_rng(12).normal(0, 500, (3, N_LATENTS, 3)).astype(np.float32)
    for method, arg in (('latent_points_to_joints', latents), ('joints_to_latent_points', pts),
                        ('joints_to_joints', pts)):
        want_m = np.asarray(jmodel.apply(variables, arg, method=getattr(jmodel, method)))
        got_m = getattr(model, method)(torch.tensor(arg)).numpy()
        np.testing.assert_allclose(got_m, want_m, rtol=1e-5, atol=1e-3, err_msg=method)


def test_linear_combine_points_matches_jax():
    rng = np.random.default_rng(13)
    coords, w = rng.normal(size=(2, 5, 7, 3)), rng.normal(size=(7, 4))
    np.testing.assert_allclose(
        metrabs.linear_combine_points(torch.tensor(coords), torch.tensor(w)).numpy(),
        np.asarray(jax_metrabs.linear_combine_points(coords.astype(np.float32),
                                                     w.astype(np.float32))), rtol=1e-5)


@pytest.mark.parametrize('model_class,latent_mode', [('metro', ''), ('model25d', ''),
                                                      ('metrabs', 'transform_coords')])
def test_train_step_refuses_other_crop_models(model_class, latent_mode):
    """The Metrabs step refuses Metro and Model25D (they have steps of their
    own) and a latent model without the autoencoder's weights, as JAX's
    does, rather than running them wrongly."""
    _, _, model = models(model_class, latent_mode)
    tcfg = TrainConfig()
    optimizer = optim.Optimizer(tcfg)
    match = 'autoencoder weights' if latent_mode else 'make_train_step_' + model_class
    with pytest.raises(ValueError, match=match):
        loop.make_train_step(model, optimizer, H36M_17, LSP_14, model.cfg, tcfg)
