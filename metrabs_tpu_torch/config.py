"""Static configuration of the crop model, the test-time augmentation and
training (`metrabs_tpu/config.py`'s `ModelConfig`, `AugConfig` and
`TrainConfig`, same fields and defaults).

The port keeps its own copy so that it imports nothing of the JAX package.
A package manifest written by either package holds these fields, so the
two classes must keep the JAX package's field names and defaults
(tests/test_torch_standalone.py checks that). Fields that only choose
between JAX/TPU code paths (`backbone_scan_blocks`, `backbone_remat`,
`warp_backend`) are kept so that every manifest loads; the port reads them
as its module docstrings say.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters of the single-person crop model: 256 px crops, a
    stride-32 backbone with centered striding, 8 depth voxels, a 2200 mm
    metric bounding cube and a 0.5 blend between the 2D- and 3D-based
    absolute reconstructions inside the field of view."""

    proc_side: int = 256
    stride_train: int = 32
    stride_test: int = 32
    centered_stride: bool = True
    depth: int = 8
    box_size_mm: float = 2200.0
    mix_3d_inside_fov: float = 0.5
    weak_perspective: bool = False
    backbone: str = 'mobilenetv3-small'
    # Scan-stacked repeated backbone blocks in the JAX package; the port runs
    # the flat `blocks.{i}` layout only and unrolls a scanned package at load.
    backbone_scan_blocks: bool = True
    # Rematerialise the backbone's blocks in the backward pass
    # (`torch.utils.checkpoint` per block); no effect on inference.
    backbone_remat: bool = False
    model_class: str = 'Metrabs'
    n_joints: int = 17
    # Compute dtype of the backbone; the decode and reconstruction always run
    # in float32.
    dtype: str = 'bfloat16'
    # The JAX package's crop-resample backend choice; the port always calls
    # `ops.warp_cuda.warp_pyramid` and does not read it.
    warp_backend: str = 'auto'
    # Precision name of the warp ('highest'/'f32', 'high'/'bf16x3', 'bf16x2',
    # 'default'/'bf16'); the port's kernel computes in float32 under each.
    warp_precision: str = 'high'
    # Serving-only folded-BN layout: BatchNorm folded into the conv weights at
    # load time.
    bn_fold: bool = False


@dataclasses.dataclass(frozen=True)
class AugConfig:
    """Test-time augmentation setup, defaulting to the released models'
    values."""

    rot_aug_degrees: float = 25.0
    rot_aug_360: bool = False
    rot_aug_360_half: bool = False
    detector_flip_vertical_too: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the reference's defaults)."""

    batch_size: int = 32
    batch_size_2d: int = 32
    batch_size_test: int = 150
    training_steps: int = 400_000
    base_learning_rate: float = 2.121e-4
    weight_decay: float = 3e-3
    ema_momentum: float = 1.0
    grad_accum_steps: int = 1
    # Max-norm projection of the backbone's conv kernels after every update;
    # inf is off.
    constrain_kernel_norm: float = float('inf')
    dual_finetune_lr: bool = False
    # Dtype of Adam's first moment ('' keeps float32).
    optimizer_mu_dtype: str = ''
    loss2d_factor: float = 0.2
    absloss_factor: float = 0.1
    absloss_start_step: int = 5000
    mean_relative: bool = True
    ghost_bn_splits: Tuple[int, ...] = ()
    seed: int = 1
    # The last N steps run the model in inference mode (BatchNorm on its
    # running statistics, no drop-connect); 0 disables.
    finetune_in_inference_mode: int = 0
    # Latent-joint and manifold modes (`train.loop.make_train_step`).
    transform_coords: bool = False
    predict_all_and_latents: bool = False
    regularize_to_manifold: bool = False
    loss_manif_factor: float = 1.0
    loss_manif_factor2d: float = 1.0
    teacher_loss_factor: float = 1.0
    teacher_start_step: int = 5000
    allhead_aegt_loss_factor: float = 1.0
    stop_gradient_latent: bool = True
