"""The port's train step against the JAX package's with EffNetV2-S at 64 px
(tests/_torch_train.py has the fixtures and tolerances): a step in train
mode with ghost splits 2, and one in inference mode (`bn_inference`).

Drop-connect is off in both packages (SURVIVAL_PROB 1.0: every mask keeps).
In train mode both backbones compute in float64 from float32 parameters
(flax's `dtype=float64, param_dtype=float32`; the port's
`dtype=torch.float64`), on batches of 2 + 2: forty train-mode BatchNorms at
2x2 to 32x32 amplify float32 rounding to ~1.5e-4 of a tensor's largest
gradient between two float32 implementations, more than the first moment's
elementwise tolerance (XLA's float64 convolutions on the CPU are ~25x
slower than its float32 ones, hence the small batch). In inference mode
the BatchNorms use their running statistics and float32 suffices. The
head, the losses and the optimizer run in float32 on both sides.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from metrabs_tpu.models.backbones import efficientnet_v2 as jax_effnet
from metrabs_tpu_torch.models.backbones import efficientnet_v2 as effnet
from tests.test_torch_train_step import check_step, run_both

from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures('one_torch_thread')


@pytest.fixture
def all_keep(monkeypatch):
    monkeypatch.setattr(jax_effnet, 'SURVIVAL_PROB', 1.0)
    monkeypatch.setattr(effnet, 'SURVIVAL_PROB', 1.0)


def test_effnet_train_step_matches_jax(all_keep):
    """Train mode with 2 ghost splits: every BatchNorm normalises each split
    by its own statistics and updates the running ones twice (one split
    alone is `GhostBatchNorm`'s other path, held against JAX in
    tests/test_torch_train_port.py and through TinyBackbone's steps)."""
    with jax.enable_x64(True):
        out = run_both('efficientnetv2-s', ghost_splits=2,
                       backbone_dtypes=(jnp.float64, torch.float64), batch=(2, 2))
    check_step(*out)


def test_effnet_bn_inference_step_matches_jax(all_keep):
    check_step(*run_both('efficientnetv2-s', bn_inference=True))
