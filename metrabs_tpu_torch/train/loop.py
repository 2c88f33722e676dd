"""Training state and the train step, plain Metrabs mode
(`metrabs_tpu/train/loop.py`: `TrainState`, `create_train_state`,
`make_train_step`).

One step: the 3D- and 2D-labelled batches are concatenated and run through
`backbone_and_head` together, a per-sample 2D/3D mixing factor is drawn
from the step's generator, the absolute reconstruction and the MeTRAbs
losses follow, then backward, the optimizer update, the kernel-norm
projection and the EMA (under gradient accumulation, only on the
micro-steps that apply an update). The state is updated in place.

The step counts micro-steps; the loss gates read it unscaled, as in JAX.
With `bn_inference` the model runs in eval mode (BatchNorm on its running
statistics, which stay as they are; no drop-connect; the head decodes at
`stride_test`) while gradients still flow: the `finetune_in_inference_mode`
phase.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from metrabs_tpu_torch.config import ModelConfig, TrainConfig
from metrabs_tpu_torch.models.metrabs import Metrabs
from metrabs_tpu_torch.pipeline.estimator import checked_device
from metrabs_tpu_torch.train import losses as losses_mod
from metrabs_tpu_torch.train import optim
from metrabs_tpu_torch.utils.joint_info import JointInfo


@dataclasses.dataclass
class TrainState:
    """The micro-step count, the model (parameters and BatchNorm running
    statistics), the optimizer state and the EMA of the parameters."""
    step: int
    model: nn.Module
    opt_state: optim.OptState
    ema_params: Dict[str, torch.Tensor]

    def params(self) -> Dict[str, nn.Parameter]:
        return dict(self.model.named_parameters())

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with the EMA parameters in place of the
        parameters (what is exported for serving)."""
        return {**self.model.state_dict(), **self.ema_params}


def create_train_state(model: nn.Module, optimizer: optim.Optimizer,
                       device='cuda') -> TrainState:
    """Moves `model` (its weights already made or loaded) to `device` and
    starts training it: step 0, a fresh optimizer state, the EMA at the
    parameters."""
    model.to(checked_device(device))
    params = dict(model.named_parameters())
    return TrainState(step=0, model=model, opt_state=optimizer.init(params),
                      ema_params={n: p.detach().clone() for n, p in params.items()})


def make_train_step(optimizer: optim.Optimizer, joint_info3d: JointInfo,
                    joint_info2d: JointInfo, cfg: ModelConfig, tcfg: TrainConfig,
                    bn_inference: bool = False):
    """The step `train_step(state, batch3d, batch2d, generator=None,
    mix=None) -> losses` for a plain `Metrabs` model (another crop model
    raises NotImplementedError).

    batch3d: image [n, S, S, 3], intrinsics [n, 3, 3], coords3d_true
    [n, J, 3], joint_validity_mask [n, J]; batch2d: image [m, S, S, 3],
    intrinsics [m, 3, 3], coords2d_true [m, J2, 2], joint_validity_mask
    [m, J2], as tensors or arrays (moved to the model's device).
    `generator` draws `mix` [n + m, 1, 1] (uniform in [0, 1)) unless it is
    given, then the drop-connect masks. Returns the losses, detached; the
    gradients stay in the parameters' `.grad`."""
    if tcfg.transform_coords or tcfg.predict_all_and_latents or tcfg.regularize_to_manifold:
        raise NotImplementedError('The latent and manifold training modes are not yet '
                                  'ported to metrabs_tpu_torch')
    index_groups = losses_mod.get_2d_joint_index_groups(joint_info3d, joint_info2d)
    dtype = getattr(torch, cfg.dtype)

    def train_step(state: TrainState, batch3d: Dict, batch2d: Dict,
                   generator: Optional[torch.Generator] = None,
                   mix: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        model = state.model
        if not isinstance(model, Metrabs) or model.latent_mode:
            raise NotImplementedError('The Metro, Model25D and latent-mode train steps are '
                                      'not yet ported to metrabs_tpu_torch; the plain '
                                      'Metrabs step is')
        device = next(model.parameters()).device
        to_dev = lambda batch: {k: torch.as_tensor(v).to(device, non_blocking=True)
                                for k, v in batch.items()}
        batch3d, batch2d = to_dev(batch3d), to_dev(batch2d)
        n3 = batch3d['image'].shape[0]
        image = torch.cat([batch3d['image'], batch2d['image']]).to(dtype)
        intrinsics = torch.cat([batch3d['intrinsics'], batch2d['intrinsics']])
        if mix is None:
            mix = torch.rand((image.shape[0], 1, 1), generator=generator, device=device)
        model.train(not bn_inference)
        _, head2d, head3d = model.backbone_and_head(image, train=not bn_inference,
                                                    generator=generator)
        coords_abs = losses_mod.reconstruct_absolute_trainmode(
            head2d, head3d, intrinsics, mix.to(device, torch.float32), state.step, cfg=cfg)
        losses = losses_mod.compute_losses(coords_abs[:n3], coords_abs[n3:], batch3d, batch2d,
                                           index_groups, cfg=cfg, tcfg=tcfg, step=state.step)
        params = state.params()
        for p in params.values():
            p.grad = None
        losses['loss'].backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in params.items()}
        apply_gradients(optimizer, tcfg, params, grads, state.opt_state, state.ema_params)
        state.step += 1
        return {k: v.detach() for k, v in losses.items()}

    return train_step


def apply_gradients(optimizer: optim.Optimizer, tcfg: TrainConfig,
                    params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                    opt_state: optim.OptState, ema_params: Dict[str, torch.Tensor]) -> bool:
    """The optimizer tail of a step, in place (JAX's `_apply_gradients`): the
    update, the kernel-norm projection after it (as Keras applies kernel
    constraints), and the EMA, which under accumulation blends only on the
    micro-steps that apply an update. Returns whether one was applied."""
    applied = optimizer.step(params, grads, opt_state)
    if tcfg.constrain_kernel_norm != float('inf'):
        optim.project_kernel_norms(params, tcfg.constrain_kernel_norm)
    if applied or tcfg.ema_momentum >= 1.0:
        optim.ema_update(ema_params, params, tcfg.ema_momentum)
    return applied
