"""The fused MBConv inner chain of the port (`metrabs_tpu_torch/ops/mbconv.py`,
the plain version of the CUDA kernel K2) against the TPU kernel
`metrabs_tpu/ops/mbconv_pallas.py::fused_mbconv_inner` run in interpret mode,
and the port's EfficientNetV2 with `fuse_mbconv` against the JAX backbone.

Same inputs from a numpy seed on both sides (NHWC for JAX, NCHW for the
port). Tolerances are those of tests/test_mbconv_pallas.py: float32 atol and
rtol 1e-5; bfloat16 7e-2 / 5e-2 on v (a few elements land one bf16 ulp
apart where the two frameworks round silu differently) and 1e-2 on the SE
mean; the fused backbone against JAX's unfused one 2e-4 (the fused branch
applies BN as a folded scale and bias).
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.io.packaging import load_crop_model as jax_load_crop_model
from metrabs_tpu.models.backbones.builder import build_backbone as jax_build_backbone
from metrabs_tpu.ops import mbconv_pallas
from metrabs_tpu_torch.io.packaging import load_crop_model
from metrabs_tpu_torch.models.backbones import efficientnet_v2 as effnet
from metrabs_tpu_torch.models.backbones.builder import build_backbone
from metrabs_tpu_torch.ops import cuda_build, mbconv, mbconv_cuda
from tests import _torch_port
from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

F32 = dict(atol=1e-5, rtol=1e-5)
BF16_V = dict(atol=7e-2, rtol=5e-2)
BF16_MEAN = dict(atol=1e-2, rtol=1e-2)
BACKBONE = dict(atol=2e-4, rtol=2e-4)


def case(rng, n=2, h=12, w=10, e=16):
    """(u [N, H, W, E], dw [3, 3, 1, E], scale0, bias0, scale1, bias1) as in
    tests/test_mbconv_pallas.py::_case, float32 numpy."""
    return (rng.normal(size=(n, h, w, e)).astype(np.float32) * 2,
            (rng.normal(size=(3, 3, 1, e)) * 0.3).astype(np.float32),
            rng.uniform(0.5, 1.5, size=e).astype(np.float32),
            (rng.normal(size=e) * 0.2).astype(np.float32),
            rng.uniform(0.5, 1.5, size=e).astype(np.float32),
            (rng.normal(size=e) * 0.2).astype(np.float32))


def run_jax(u, dw, *consts, dtype):
    v, mean = mbconv_pallas.fused_mbconv_inner(
        jnp.asarray(u, dtype), jnp.asarray(dw), *map(jnp.asarray, consts), interpret=True)
    return np.asarray(v.astype(jnp.float32)), np.asarray(mean)


def run_port(fn, u, dw, *consts, dtype):
    """NCHW in, NHWC float32 out."""
    ut = torch.tensor(u).permute(0, 3, 1, 2).contiguous().to(dtype)
    dwt = torch.tensor(dw).permute(3, 2, 0, 1).contiguous()  # [E, 1, 3, 3]
    v, mean = fn(ut, *mbconv.inner_constants(dwt, *map(torch.tensor, consts)))
    assert v.dtype == dtype and mean.dtype == torch.float32
    return v.float().permute(0, 2, 3, 1).numpy(), mean.numpy()


@pytest.mark.parametrize('h,w', [(12, 10), (24, 24), (7, 9)])
def test_plain_matches_tpu_kernel_f32(rng, h, w):
    c = case(rng, h=h, w=w)
    want_v, want_mean = run_jax(*c, dtype=jnp.float32)
    got_v, got_mean = run_port(mbconv.fused_mbconv_inner, *c, dtype=torch.float32)
    np.testing.assert_allclose(got_v, want_v, **F32)
    np.testing.assert_allclose(got_mean, want_mean, **F32)


def test_plain_matches_tpu_kernel_bf16(rng):
    c = case(rng, n=1, h=8, w=8, e=32)
    want_v, want_mean = run_jax(*c, dtype=jnp.bfloat16)
    got_v, got_mean = run_port(mbconv.fused_mbconv_inner, *c, dtype=torch.bfloat16)
    np.testing.assert_allclose(got_v, want_v, **BF16_V)
    np.testing.assert_allclose(got_mean, want_mean, **BF16_MEAN)


def test_zero_border(rng):
    """A one-hot corner input and all-ones taps: taps outside the image
    contribute 0, also after the activation of the padding would not be 0."""
    e = 8
    u = np.zeros((1, 6, 6, e), np.float32)
    u[0, 0, 0, :] = 1.0
    ones, zeros = np.ones(e, np.float32), np.zeros(e, np.float32)
    c = (u, np.ones((3, 3, 1, e), np.float32), ones, zeros + 0.5, ones, zeros)
    want_v, want_mean = run_jax(*c, dtype=jnp.float32)
    got_v, got_mean = run_port(mbconv.fused_mbconv_inner, *c, dtype=torch.float32)
    np.testing.assert_allclose(got_v, want_v, atol=1e-6)
    np.testing.assert_allclose(got_mean, want_mean, atol=1e-6)


def test_wrapper_runs_plain_on_cpu(rng):
    c = case(rng)
    before = mbconv_cuda.fused_mbconv_inner.launches
    got = run_port(mbconv_cuda.fused_mbconv_inner, *c, dtype=torch.float32)
    want = run_port(mbconv.fused_mbconv_inner, *c, dtype=torch.float32)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert mbconv_cuda.fused_mbconv_inner.launches == before


def test_fold_bn_matches_jax_fold(rng):
    """`fold_bn` is `GhostBatchNorm(fold=True)`'s gamma*rsqrt(var+eps), beta-mean*scale."""
    gamma, beta, mean = (rng.normal(size=(3, 7)) + [[1], [0], [0]]).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 7).astype(np.float32)
    scale, bias = mbconv.fold_bn(*map(torch.tensor, (gamma, beta, mean, var)), 1e-3)
    want_scale = jnp.asarray(gamma) * jnp.asarray(1.0 / np.sqrt(var + 1e-3), jnp.float32)
    np.testing.assert_allclose(scale.numpy(), np.asarray(want_scale), rtol=1e-6)
    np.testing.assert_allclose(bias.numpy(), beta - mean * scale.numpy(), rtol=1e-6, atol=1e-7)


def test_fusable_blocks_of_effnetv2_s():
    """28 MBConv blocks of EffNetV2-S qualify (stage 4 minus its stride-2
    first block, stage 5, stage 6 minus its first); none with folded BN."""
    with torch.device('meta'):
        unfolded = effnet.EfficientNetV2(fuse_mbconv='on')
        folded = effnet.EfficientNetV2(fuse_mbconv='on', bn_fold=True)
    assert sum(getattr(b, 'fusable', False) for b in unfolded.blocks) == 28
    assert not any(getattr(b, 'fusable', False) for b in folded.blocks)
    with pytest.raises(ValueError, match='fuse_mbconv'):
        effnet.EfficientNetV2(fuse_mbconv='sometimes')


@pytest.fixture(scope='module')
def package(tmp_path_factory):
    return _torch_port.make_package(str(tmp_path_factory.mktemp('pkg') / 'p'), scanned=False)


@pytest.fixture(scope='module')
def jax_features(package):
    """Features of JAX's unfused backbone (fuse_mbconv 'off', BN unfolded)."""
    from tests.test_torch_model import inputs, run_jax
    model, variables, _, _, _ = jax_load_crop_model(package, bn_fold=False)
    return run_jax(model, variables, *inputs(0))


@pytest.mark.parametrize('mode', ['on', 'interpret', 'auto'])
def test_fused_backbone_matches_jax(package, jax_features, mode):
    """EffNetV2-S at 64 px, float32: the port with the fused inner chain
    ('on' and 'interpret' run the plain version on the CPU; 'auto' stays
    unfused there) against JAX's unfused backbone, with the same state dict
    as the unfused port."""
    from tests.test_torch_model import inputs, run_torch
    builder = functools.partial(build_backbone, fuse_mbconv=mode)
    model, cfg, _, _ = load_crop_model(package, bn_fold=False, device='cpu',
                                       backbone_builder=builder)
    plain, _, _, _ = load_crop_model(package, bn_fold=False, device='cpu')
    assert model.state_dict().keys() == plain.state_dict().keys()
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  plain.state_dict().values()))
    calls = []
    for block in model.backbone.blocks:
        if isinstance(block, effnet.MBConv):
            block.register_forward_hook(lambda m, i, o: calls.append(m._use_fused(i[0])))
    j_feats, j_poses = jax_features
    t_feats, t_poses = run_torch(model, *inputs(0))
    assert sum(calls) == (0 if mode == 'auto' else 2 * 28)  # run_torch runs it twice
    np.testing.assert_allclose(t_feats, j_feats, **BACKBONE)
    np.testing.assert_allclose(t_poses, j_poses, atol=1.0, rtol=1e-3)


def test_inner_constants_layout(rng):
    """taps [E, 9] row-major from the [E, 1, 3, 3] weight; sb rows scale0,
    bias0, scale1, bias1; float32 and contiguous."""
    dw = torch.tensor(rng.normal(size=(5, 1, 3, 3)), dtype=torch.float64)
    consts = [torch.tensor(rng.normal(size=5), dtype=torch.float32) for _ in range(4)]
    taps, sb = mbconv.inner_constants(dw, *consts)
    assert taps.dtype == sb.dtype == torch.float32 and taps.is_contiguous() and sb.is_contiguous()
    torch.testing.assert_close(taps[:, 3 * 1 + 2], dw[:, 0, 1, 2].float(), rtol=0, atol=0)
    torch.testing.assert_close(sb, torch.stack(consts), rtol=0, atol=0)


def test_kernel_probes_are_switches_of_the_source():
    """Each K2 probe of scripts/torch_kernel_ab.py is an `#ifdef` of
    csrc/mbconv.cu, and the source has no other."""
    path = Path(__file__).resolve().parent.parent / 'scripts' / 'torch_kernel_ab.py'
    spec = importlib.util.spec_from_file_location('torch_kernel_ab', path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    src = cuda_build.source_path('mbconv').read_text()
    switches = re.findall(r'#ifdef MBCONV_PROBE_(\w+)', src)
    assert sorted(switches) == sorted(p.upper() for p in script.PROBES)


@pytest.fixture(scope='module')
def jax_interpret_outputs(package):
    """JAX's unfolded crop model with the TPU kernel K2 in interpret mode."""
    from tests.test_torch_model import inputs, run_jax

    def builder(name, **kwargs):
        return jax_build_backbone(name, **kwargs).clone(fuse_mbconv='interpret')
    model, variables, _, _, _ = jax_load_crop_model(package, backbone_builder=builder,
                                                    bn_fold=False)
    return run_jax(model, variables, *inputs(0))


def test_fused_crop_model_keeps_constants(package, jax_interpret_outputs, monkeypatch):
    """The fused blocks make their constants at the first eval-mode call and
    reuse them; the second call gives the first's result exactly, both agree
    with JAX's fused model in interpret mode, the state dict does not hold
    the constants, and `eval()` drops them."""
    from tests.test_torch_model import inputs, run_torch
    builder = functools.partial(build_backbone, fuse_mbconv='on')
    model, _, _, _ = load_crop_model(package, bn_fold=False, device='cpu',
                                     backbone_builder=builder)
    fused = [b for b in model.backbone.blocks if getattr(b, 'fusable', False)]
    assert len(fused) == 28 and all(b.inner_taps is None for b in fused)
    assert not any('inner_' in k for k in model.state_dict())
    made = []
    make = mbconv.inner_constants
    monkeypatch.setattr(mbconv, 'inner_constants', lambda *a: made.append(1) or make(*a))
    first = run_torch(model, *inputs(0))
    assert len(made) == 28  # run_torch calls the model twice; made once per block
    for b in fused:
        want = make(b.depthwise_conv.weight, *b.norm0.folded(), *b.norm1.folded())
        torch.testing.assert_close((b.inner_taps, b.inner_sb), want, rtol=0, atol=0)
    second = run_torch(model, *inputs(0))
    assert len(made) == 28
    for got, want in zip(second, first):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(first[0], jax_interpret_outputs[0], **BACKBONE)
    np.testing.assert_allclose(first[1], jax_interpret_outputs[1], atol=1.0, rtol=1e-3)
    model.eval()
    assert all(b.inner_taps is None and b.inner_sb is None for b in fused)


def test_fused_constants_follow_load_state_dict(package):
    """Weights loaded after a fused eval-mode call replace the kept
    constants: the model then gives exactly what a model built with those
    weights from the start gives, and not its earlier result."""
    from tests.test_torch_model import inputs, run_torch
    builder = functools.partial(build_backbone, fuse_mbconv='on')
    load = lambda: load_crop_model(package, bn_fold=False, device='cpu',
                                   backbone_builder=builder)[0]
    model = load()
    x, k = inputs(0)
    before = run_torch(model, x, k)
    gen = torch.Generator().manual_seed(0)
    state = {name: (t * (1 + 0.2 * torch.rand(t.shape, generator=gen))
                    if '.depthwise_conv.' in name or '.norm0.' in name or '.norm1.' in name
                    else t)
             for name, t in model.state_dict().items()}
    model.load_state_dict(state)
    assert all(b.inner_taps is None for b in model.backbone.blocks
               if getattr(b, 'fusable', False))
    fresh = load()
    fresh.load_state_dict(state)
    after, want = run_torch(model, x, k), run_torch(fresh, x, k)
    for got, expected in zip(after, want):
        np.testing.assert_array_equal(got, expected)
    assert np.abs(after[1] - before[1]).max() > 1.0
