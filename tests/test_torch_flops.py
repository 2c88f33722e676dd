"""`scripts/_flops_torch.py`: the model-FLOP count (2 x multiply-adds of
every convolution and matrix product in one eval forward) is exact on
hand-counted layers, and on the crop models it sits below XLA's cost
analysis of the JAX package's forward by the elementwise work XLA also
counts.

Tolerances: at 64 px (EfficientNetV2-S, ResNet-18, MobileNetV3-small) XLA's
count is 1.0-1.10 x the port's; at full width the port's count is at most
BENCH_r05.json's XLA count and within 2% (EffNetV2-L@384, ResNet-152@384) or
6% (MobileNetV3-L@256: hard-swish and SE make more of its work elementwise)
below it (`scripts/_flops_torch.py` prints the ratios). XLA's counts come
from lowering the JAX forward for the CPU without compiling, as `bench.py`
does; FLOPs depend on shapes only, so the lowering takes abstract weights
(`jax.eval_shape`)."""

import pytest
import torch

from scripts import _flops_torch as flops
from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

# BENCH_r05.json's `gflops_per_crop` (XLA cost analysis of the JAX forward,
# batch 128): counts of the model, not TPU times. Hard-coded, not read.
BENCH_R05_GFLOP = {'efficientnetv2-l@384': 72.83, 'resnet152@384': 66.88,
                   'mobilenetv3-large@256': 0.78}
FULL_WIDTH_TOL = {'efficientnetv2-l@384': 0.02, 'resnet152@384': 0.02,
                  'mobilenetv3-large@256': 0.06}
TINY_XLA_OVER_PORT = (1.0, 1.10)


def test_conv_and_linear_counts_are_exact(one_torch_thread):  # noqa: F811
    x = torch.zeros(2, 3, 16, 16)
    assert flops.forward_flops(torch.nn.Conv2d(3, 8, 3, padding=1), (x,)) == \
        2 * (2 * 8 * 16 * 16) * (3 * 3 * 3)
    strided = torch.nn.Conv2d(3, 8, 3, stride=2, padding=1)  # out 8x8
    assert flops.forward_flops(strided, (x,)) == 2 * (2 * 8 * 8 * 8) * 27
    depthwise = torch.nn.Conv2d(8, 8, 3, padding=1, groups=8)
    assert flops.forward_flops(depthwise, (torch.zeros(2, 8, 16, 16),)) == \
        2 * (2 * 8 * 16 * 16) * 9
    assert flops.forward_flops(torch.nn.Linear(16, 4), (torch.zeros(5, 16),)) == 2 * 5 * 16 * 4
    with torch.device('meta'):
        big = torch.nn.Linear(4096, 4096)
        inputs = (torch.zeros(64, 4096),)
    assert flops.forward_flops(big, inputs) == 2 * 64 * 4096 * 4096


def test_meta_count_equals_a_real_forward(one_torch_thread):  # noqa: F811
    meta = flops.gflop_per_crop('efficientnetv2-s', 64, batch=2)
    assert flops.gflop_per_crop('efficientnetv2-s', 64, batch=2, device='cpu') == meta


def xla_gflop_per_crop(backbone: str, side: int, batch: int = 2) -> float:
    import jax
    import jax.numpy as jnp
    from metrabs_tpu.config import ModelConfig
    from metrabs_tpu.models.backbones.builder import build_backbone
    from metrabs_tpu.models.metrabs import Metrabs

    cfg = ModelConfig(proc_side=side, depth=8, n_joints=17, dtype='bfloat16', backbone=backbone)
    kwargs = {} if backbone.startswith('mobilenet') else dict(scan_blocks=False)
    model = Metrabs(cfg=cfg, backbone=build_backbone(backbone, dtype=jnp.bfloat16, **kwargs))
    params = jax.eval_shape(lambda: model.init(
        {'params': jax.random.PRNGKey(0)}, jnp.zeros((1, side, side, 3), jnp.bfloat16),
        jnp.eye(3)[None]))
    lowered = jax.jit(lambda p, i, k: model.apply(p, i, k, train=False), backend='cpu').lower(
        params, jax.ShapeDtypeStruct((batch, side, side, 3), jnp.bfloat16),
        jax.ShapeDtypeStruct((batch, 3, 3), jnp.float32))
    costs = lowered.cost_analysis()
    costs = costs[0] if isinstance(costs, (list, tuple)) else costs
    return float(costs['flops']) / batch / 1e9


@pytest.mark.parametrize('backbone', ['efficientnetv2-s', 'resnet18', 'mobilenetv3-small'])
def test_tiny_counts_against_xla(backbone, one_torch_thread):  # noqa: F811
    port = flops.gflop_per_crop(backbone, 64, batch=2)
    ratio = xla_gflop_per_crop(backbone, 64) / port
    assert TINY_XLA_OVER_PORT[0] <= ratio <= TINY_XLA_OVER_PORT[1], ratio


@pytest.mark.parametrize('model', sorted(BENCH_R05_GFLOP))
def test_full_width_counts_against_bench_r05(model, one_torch_thread):  # noqa: F811
    port = flops.gflop_per_crop(*flops.parse_model(model))
    xla = BENCH_R05_GFLOP[model]
    assert xla * (1 - FULL_WIDTH_TOL[model]) <= port <= xla, (port, xla)
    assert flops.XLA_GFLOP_PER_CROP[model] == xla
