"""Train-mode pieces of the port on their own (EffNetV2-S at 64 px unless
said otherwise), and the parts of them that have a JAX counterpart against
it:

 - `GhostBatchNorm` in train mode (1 and 2 ghost splits) against the JAX
   package's: output, input gradient and running statistics (the biased
   batch variance), rtol 1e-5;
 - rematerialised blocks give bit-equal gradients and running statistics;
 - drop-connect keeps a sample with the block's survival probability and
   scales the kept residual by 1 / p;
 - F1: in train mode no block runs the fused MBConv chain, so
   `fuse_mbconv='on'` equals `'off'` and every backbone parameter gets a
   gradient; in eval mode with gradients the fused chain raises;
 - the head decodes at `stride_train` in train mode (against JAX's head)
   and a `model_name_test` backbone trains its training plan;
 - `bn_fold` has no train mode.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.config import ModelConfig as JaxModelConfig
from metrabs_tpu.models import heads as jax_heads
from metrabs_tpu.models.backbones import common as jax_common
from metrabs_tpu_torch.config import ModelConfig
from metrabs_tpu_torch.models import heads
from metrabs_tpu_torch.models.backbones import common
from metrabs_tpu_torch.models.backbones.builder import build_backbone

from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SIDE = 64


def images(n=4, seed=0):
    return torch.tensor(np.random.default_rng(seed).uniform(size=(n, SIDE, SIDE, 3)),
                        dtype=torch.float32)


def minted(backbone, seed=0):
    """Random BN affine and statistics, so that BN is not the identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in backbone.state_dict().items():
            if name.endswith('running_var') or (name.endswith('weight') and t.ndim == 1):
                t.copy_(torch.rand(t.shape, generator=gen) * 0.6 + 0.7)
            elif name.endswith(('running_mean', 'bias')):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    return backbone


@pytest.mark.parametrize('splits', [1, 2])
def test_ghost_batch_norm_matches_jax(splits):
    rng = np.random.default_rng(splits)
    x = (rng.normal(size=(8, 5, 6, 7)) * 2 + 1).astype(np.float32)  # NHWC
    cotangent = rng.normal(size=x.shape).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 7), rng.normal(size=7)
    mean0, var0 = rng.normal(size=7), rng.uniform(0.5, 1.5, 7)
    module = jax_common.GhostBatchNorm(momentum=0.9, epsilon=1e-3, splits=splits,
                                       dtype=jnp.float32)
    variables = {'params': {'bn': {'scale': jnp.asarray(scale, jnp.float32),
                                   'bias': jnp.asarray(bias, jnp.float32)}},
                 'batch_stats': {'bn': {'mean': jnp.asarray(mean0, jnp.float32),
                                        'var': jnp.asarray(var0, jnp.float32)}}}

    def f(xx):
        y, mutated = module.apply(variables, xx, train=True, mutable=['batch_stats'])
        return jnp.sum(y * cotangent), (y, mutated['batch_stats']['bn'])

    (_, (want_y, want_stats)), want_dx = jax.value_and_grad(f, has_aux=True)(x)

    bn = common.GhostBatchNorm(7, 1e-3, 0.9, splits)
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean0),
                     (bn.running_var, var0)):
            t.copy_(torch.tensor(v))
    xt = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn.train()(xt)
    (y * torch.tensor(cotangent).permute(0, 3, 1, 2)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), want_y, **tol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), want_dx, **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), want_stats['mean'], **tol)
    np.testing.assert_allclose(bn.running_var.numpy(), want_stats['var'], **tol)


def test_ghost_batch_norm_bf16_stats_keep_float32_running_stats():
    bn = common.GhostBatchNorm(6, 1e-3, 0.9, bf16_stats=True).train()
    x = torch.randn(4, 6, 5, 5, generator=torch.Generator().manual_seed(0)).bfloat16() * 3
    y = bn(x)
    assert y.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32
    want = 0.9 + 0.1 * x.float().var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, want, rtol=2e-2, atol=2e-2)


def grads_and_stats(backbone, x, seed):
    backbone.zero_grad(set_to_none=True)
    out = backbone(x, generator=torch.Generator().manual_seed(seed))
    out.square().mean().backward()
    grads = {n: p.grad.clone() for n, p in backbone.named_parameters()}
    stats = {n: b.clone() for n, b in backbone.named_buffers()
             if n.endswith(('running_mean', 'running_var'))}
    return out.detach(), grads, stats


def test_remat_gives_bit_equal_gradients_and_running_stats():
    plain = minted(build_backbone('efficientnetv2-s')).train()
    remat = copy.deepcopy(plain)
    remat.remat = True
    x = images()
    want = grads_and_stats(plain, x, seed=5)
    got = grads_and_stats(remat, x, seed=5)
    assert torch.equal(got[0], want[0])
    # Equal running statistics: the recompute left them alone.
    for g, w in zip(got[1:], want[1:]):
        assert g.keys() == w.keys()
        assert all(torch.equal(g[k], w[k]) for k in w)


def test_drop_connect_keep_rate_and_scaling():
    n, p = 20000, 0.7
    gen = torch.Generator().manual_seed(0)
    keep = common.drop_mask(n, p, gen, 'cpu')
    x = torch.randn(n, 3, 2, 2, generator=gen)
    residual = torch.randn(n, 3, 2, 2, generator=gen)
    out = common.stochastic_depth(x, residual, p, keep)
    assert abs(keep.float().mean().item() - p) < 0.01
    torch.testing.assert_close(out[keep], x[keep] + residual[keep] / p)
    assert torch.equal(out[~keep], x[~keep])
    assert torch.equal(common.stochastic_depth(x, residual, p), x + residual)


def test_drop_connect_follows_the_generator_and_the_survival_schedule(monkeypatch):
    from metrabs_tpu_torch.models.backbones import efficientnet_v2 as effnet
    backbone = minted(build_backbone('efficientnetv2-s')).train()
    x = images(n=2)
    a = backbone(x, generator=torch.Generator().manual_seed(1))
    b = backbone(x, generator=torch.Generator().manual_seed(1))
    c = backbone(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    survivals = []
    monkeypatch.setattr(common, 'drop_mask',
                        lambda n, p, g, d: survivals.append(p) or torch.ones(n, dtype=bool))
    backbone(x)
    n_blocks = len(backbone.blocks)
    residual = [i for i, blk in enumerate(backbone.blocks) if blk.has_residual()]
    assert survivals == pytest.approx(
        [1 - (1 - effnet.SURVIVAL_PROB) * i / n_blocks for i in residual])


def test_f1_train_mode_runs_no_fused_chain_and_every_parameter_learns(monkeypatch):
    from metrabs_tpu_torch.ops import mbconv, mbconv_cuda
    off = minted(build_backbone('efficientnetv2-s', fuse_mbconv='off')).train()
    on = build_backbone('efficientnetv2-s', fuse_mbconv='on').train()
    on.load_state_dict(off.state_dict())
    assert sum(getattr(b, 'fusable', False) for b in on.blocks) == 28

    def forbidden(*args):
        raise AssertionError('the fused MBConv chain ran in train mode')
    monkeypatch.setattr(mbconv_cuda, 'fused_mbconv_inner', forbidden)
    monkeypatch.setattr(mbconv, 'fused_mbconv_inner', forbidden)
    x = images()
    want = grads_and_stats(off, x, seed=3)
    got = grads_and_stats(on, x, seed=3)
    assert torch.equal(got[0], want[0])
    for name, g in got[1].items():
        assert torch.equal(g, want[1][name]), name
        assert g.abs().max() > 0, f'{name} gets no gradient'


def test_f1_eval_mode_with_gradients_refuses_the_fused_chain():
    backbone = minted(build_backbone('efficientnetv2-s', fuse_mbconv='on')).eval()
    with pytest.raises(RuntimeError, match='no backward'):
        backbone(images(n=2))
    with torch.no_grad():
        fused = backbone(images(n=2))
    plain = build_backbone('efficientnetv2-s').eval()
    plain.load_state_dict(backbone.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(fused, plain(images(n=2)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
def test_head_decodes_at_the_mode_stride_as_jax(train):
    kwargs = dict(proc_side=SIDE, stride_train=32, stride_test=16, depth=4, n_joints=5,
                  dtype='float32')
    rng = np.random.default_rng(0)
    features = rng.normal(size=(2, 4, 4, 12)).astype(np.float32)  # NHWC
    head = jax_heads.MetrabsHeads(JaxModelConfig(**kwargs), 5, dtype=jnp.float32)
    variables = head.init(jax.random.PRNGKey(0), features)
    want = head.apply(variables, features, train=train)
    ours = heads.MetrabsHeads(ModelConfig(**kwargs), 5, in_channels=12)
    conv = variables['params']['conv_final']
    with torch.no_grad():
        ours.conv_final.weight.copy_(torch.tensor(np.asarray(conv['kernel'])).permute(3, 2, 0, 1))
        ours.conv_final.bias.copy_(torch.tensor(np.asarray(conv['bias'])))
    got = ours(torch.tensor(features).permute(0, 3, 1, 2), train=train)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-5, atol=1e-4)


def test_model_name_test_trains_the_training_plan():
    backbone = minted(build_backbone('efficientnetv2-s', stride_test=16))
    assert backbone.train()(images(n=2)).shape[-1] == SIDE // 32
    with torch.no_grad():
        assert backbone.eval()(images(n=2)).shape[-1] == SIDE // 16


def test_bn_fold_has_no_train_mode():
    with pytest.raises(ValueError, match='inference-only'):
        build_backbone('efficientnetv2-s', bn_fold=True).train()(images(n=2))
