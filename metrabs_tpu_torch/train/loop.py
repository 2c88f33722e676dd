"""Training state and the train steps of every crop-model family
(`metrabs_tpu/train/loop.py`: `TrainState`, `create_train_state`,
`load_affine_weights`, `make_train_step`, `make_train_step_metro`,
`make_train_step_model25d`).

One step: the 3D- and 2D-labelled batches are concatenated and run through
the model together, the family's losses follow, then backward, the optimizer
update, the kernel-norm projection and the EMA (under gradient
accumulation, only on the micro-steps that apply an update). The state is
updated in place.

The Metrabs step draws a per-sample 2D/3D mixing factor from the step's
generator before the forward (Metro and Model25D draw none), then the
absolute reconstruction of each head; its latent and manifold modes need
the affine-combining autoencoder's weights (`affine_weights`, e.g. from
`load_affine_weights`):
  - `transform_coords`: the head predicts the latent points, decoded to
    joints after the reconstruction;
  - `predict_all_and_latents`: the latent slots (first) and the all-joint
    slots reconstruct apart and train with the hybrid student-teacher
    losses;
  - `regularize_to_manifold`: a plain head plus the distance of its joints
    to their autoencoder reconstruction.
The weights are the step's float32 constants; the model's own
`recombination_weights` and `encoder_weights` buffers (what a package
exports) are the caller's to set.

The step counts micro-steps; the loss gates read it unscaled, as in JAX.
With `bn_inference` the model runs in eval mode (BatchNorm on its running
statistics, which stay as they are; no drop-connect; the head decodes at
`stride_test`) while gradients still flow: the `finetune_in_inference_mode`
phase.

`make_sharded_train_step` runs any of these steps over a mesh
(`parallel.mesh`): data-parallel over 'data', and with `state_shardings`
tensor-parallel over 'model' (`shard_train_state`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from metrabs_tpu_torch.config import ModelConfig, TrainConfig
from metrabs_tpu_torch.models.metrabs import Metrabs, linear_combine_points
from metrabs_tpu_torch.models.metro import Metro, compute_metro_losses
from metrabs_tpu_torch.models.model25d import Model25D, compute_model25d_losses
from metrabs_tpu_torch.parallel import mesh as mesh_mod
from metrabs_tpu_torch.pipeline.estimator import checked_device
from metrabs_tpu_torch.train import losses as losses_mod
from metrabs_tpu_torch.train import optim
from metrabs_tpu_torch.utils.joint_info import JointInfo


@dataclasses.dataclass
class TrainState:
    """The micro-step count, the model (parameters and BatchNorm running
    statistics), the optimizer state and the EMA of the parameters; under
    tensor parallelism (`shard_train_state`) also its mesh and the names of
    its parameters that hold this rank's 'model' slice."""
    step: int
    model: nn.Module
    opt_state: optim.OptState
    ema_params: Dict[str, torch.Tensor]
    mesh: Optional[object] = None
    sharded: List[str] = dataclasses.field(default_factory=list)

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


def load_affine_weights(path: str) -> Dict[str, np.ndarray]:
    """Affine-combining autoencoder weights from an npz with w1 [n_joints,
    n_latents] (encoder) and w2 [n_latents, n_joints] (decoder), keyed as
    the latent Metrabs model's constants, float32."""
    ws = np.load(path)
    return {'encoder_weights': np.asarray(ws['w1'], np.float32),
            'recombination_weights': np.asarray(ws['w2'], np.float32)}


def _make_step(model: nn.Module, optimizer: optim.Optimizer, cfg: ModelConfig,
               tcfg: TrainConfig, bn_inference: bool, loss_fn: Callable):
    """The step shared by every family: `loss_fn(model, image, intrinsics,
    batch3d, batch2d, step, generator, **kwargs)` gives the losses of the
    concatenated batch (image in `cfg.dtype`); the step's keyword arguments
    go to it."""
    dtype = getattr(torch, cfg.dtype)

    def train_step(state: TrainState, batch3d: Dict, batch2d: Dict,
                   generator: Optional[torch.Generator] = None,
                   **kwargs) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError('The train step was made for another model than the state\'s')
        device = next(model.parameters()).device
        to_dev = lambda batch: {k: torch.as_tensor(v).to(device, non_blocking=True)
                                for k, v in batch.items()}
        batch3d, batch2d = to_dev(batch3d), to_dev(batch2d)
        image = torch.cat([batch3d['image'], batch2d['image']]).to(dtype)
        intrinsics = torch.cat([batch3d['intrinsics'], batch2d['intrinsics']])
        model.train(not bn_inference)
        losses = loss_fn(model, image, intrinsics, batch3d, batch2d, state.step, generator,
                         **kwargs)
        params = state.params()
        for p in params.values():
            p.grad = None
        losses['loss'].backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in params.items()}
        layout = mesh_mod.active_layout()
        if layout is not None:
            layout.reduce_gradients(grads)
        apply_gradients(optimizer, tcfg, params, grads, state.opt_state, state.ema_params)
        state.step += 1
        return {k: v.detach() for k, v in losses.items()}

    return train_step


def make_train_step(model: Metrabs, optimizer: optim.Optimizer, joint_info3d: JointInfo,
                    joint_info2d: JointInfo, cfg: ModelConfig, tcfg: TrainConfig,
                    bn_inference: bool = False,
                    affine_weights: Optional[Dict] = None):
    """The step `train_step(state, batch3d, batch2d, generator=None,
    mix=None) -> losses` of the `Metrabs` `model` (whose state it takes), in
    its latent mode and TrainConfig's modes (module docstring);
    `affine_weights` = {'encoder_weights': [J, L], 'recombination_weights':
    [L, J]} for the latent and manifold modes, kept on the model's device at
    this call. Raises ValueError where the model's latent mode and `tcfg`
    disagree or the weights are missing.

    batch3d: image [n, S, S, 3], intrinsics [n, 3, 3], coords3d_true
    [n, J, 3], joint_validity_mask [n, J]; batch2d: image [m, S, S, 3],
    intrinsics [m, 3, 3], coords2d_true [m, J2, 2], joint_validity_mask
    [m, J2], as tensors or arrays (moved to the model's device).
    `generator` draws `mix` [n + m, 1, 1] (uniform in [0, 1)) unless it is
    given, then the drop-connect masks. Returns the losses, detached; the
    gradients stay in the parameters' `.grad`."""
    if not isinstance(model, Metrabs):
        raise ValueError(f'make_train_step trains Metrabs models; a {type(model).__name__} '
                         f'trains with make_train_step_metro or make_train_step_model25d')
    latent_mode = model.latent_mode
    if tcfg.predict_all_and_latents and latent_mode != 'predict_all_and_latents':
        raise ValueError(f'TrainConfig.predict_all_and_latents requires a model built with '
                         f"latent_mode='predict_all_and_latents', got {latent_mode!r}")
    if tcfg.transform_coords and latent_mode != 'transform_coords':
        raise ValueError(f'TrainConfig.transform_coords requires a model built with '
                         f"latent_mode='transform_coords', got {latent_mode!r}")
    w_dec = w_enc = w_rec = None
    if latent_mode or tcfg.regularize_to_manifold:
        if affine_weights is None:
            raise ValueError('latent/manifold training modes need the autoencoder weights: '
                             "pass affine_weights={'encoder_weights': [J, L], "
                             "'recombination_weights': [L, J]}")
        # On the model's device once: a copy to the card per step would wait.
        device = next(model.parameters()).device
        w_dec, w_enc = (torch.as_tensor(affine_weights[k], dtype=torch.float32, device=device)
                        for k in ('recombination_weights', 'encoder_weights'))
        w_rec = torch.matmul(w_enc, w_dec)
    index_groups = losses_mod.get_2d_joint_index_groups(joint_info3d, joint_info2d)

    def loss_fn(model, image, intrinsics, batch3d, batch2d, step, generator, mix=None):
        n3 = batch3d['image'].shape[0]
        if mix is None:
            mix = mesh_mod.batch_rand(image.shape[0], generator, image.device, (1, 1))
        mix = mix.to(image.device, torch.float32)
        _, head2d, head3d = model.backbone_and_head(image, train=model.training,
                                                    generator=generator)

        def reconstruct(head2d, head3d):
            return losses_mod.reconstruct_absolute_trainmode(head2d, head3d, intrinsics, mix,
                                                             step, cfg=cfg)

        if latent_mode == 'predict_all_and_latents':
            n_lat = model.n_latents
            abs_lat = reconstruct(head2d[:, :n_lat], head3d[:, :n_lat])
            abs_all = reconstruct(head2d[:, n_lat:], head3d[:, n_lat:])
            return losses_mod.compute_losses_latents_and_all(
                abs_all[:n3], abs_lat[:n3], abs_all[n3:], abs_lat[n3:], batch3d, batch2d,
                index_groups, cfg=cfg, tcfg=tcfg, step=step, recombination_weights=w_dec,
                encoder_weights=w_enc)
        coords_abs = reconstruct(head2d, head3d)
        if latent_mode == 'transform_coords':
            coords_abs = linear_combine_points(coords_abs, w_dec)
        return losses_mod.compute_losses(
            coords_abs[:n3], coords_abs[n3:], batch3d, batch2d, index_groups, cfg=cfg,
            tcfg=tcfg, step=step,
            reconstruction_weights=w_rec if tcfg.regularize_to_manifold else None)

    return _make_step(model, optimizer, cfg, tcfg, bn_inference, loss_fn)


def make_train_step_metro(model: Metro, optimizer: optim.Optimizer, joint_info3d: JointInfo,
                          joint_info2d: JointInfo, cfg: ModelConfig, tcfg: TrainConfig,
                          bn_inference: bool = False):
    """The step `train_step(state, batch3d, batch2d, generator=None) ->
    losses` of the Metro `model`: the root-relative L1 on the 3D batch and
    the aligned weak 2D loss on the 2D batch (`models.metro.
    compute_metro_losses`). Batches as `make_train_step`'s; `generator`
    draws the drop-connect masks."""
    if not isinstance(model, Metro):
        raise ValueError(f'make_train_step_metro trains Metro models, not '
                         f'{type(model).__name__}')
    index_groups = losses_mod.get_2d_joint_index_groups(joint_info3d, joint_info2d)

    def loss_fn(model, image, intrinsics, batch3d, batch2d, step, generator):
        n3 = batch3d['image'].shape[0]
        coords = model(image, generator=generator)
        return compute_metro_losses(coords[:n3], coords[n3:], batch3d, batch2d, index_groups,
                                    cfg=cfg, tcfg=tcfg)

    return _make_step(model, optimizer, cfg, tcfg, bn_inference, loss_fn)


def make_train_step_model25d(model: Model25D, optimizer: optim.Optimizer,
                             joint_info3d: JointInfo, joint_info2d: JointInfo,
                             cfg: ModelConfig, tcfg: TrainConfig,
                             bn_inference: bool = False):
    """The step `train_step(state, batch3d, batch2d, generator=None) ->
    losses` of the Model25D `model`, supervising its raw 2.5D head
    (`models.model25d.compute_model25d_losses`); the 3D batch also carries
    `coords2d_true` [n, J, 2]. `generator` draws the drop-connect masks."""
    if not isinstance(model, Model25D):
        raise ValueError(f'make_train_step_model25d trains Model25D models, not '
                         f'{type(model).__name__}')
    index_groups = losses_mod.get_2d_joint_index_groups(joint_info3d, joint_info2d)

    def loss_fn(model, image, intrinsics, batch3d, batch2d, step, generator):
        n3 = batch3d['image'].shape[0]
        coords25d = model.forward_25d(image, generator=generator)
        return compute_model25d_losses(coords25d[:n3], coords25d[n3:], batch3d, batch2d,
                                       index_groups, cfg=cfg, tcfg=tcfg)

    return _make_step(model, optimizer, cfg, tcfg, bn_inference, loss_fn)


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


def shard_train_state(state: TrainState, mesh, shardings: Dict) -> TrainState:
    """Makes `state` tensor-parallel over `mesh`'s 'model' axis, in place:
    every parameter that `shardings` (`parallel.mesh.tp_shardings`) shards
    keeps this rank's out-channel slice, and so do its Adam moments, its
    accumulated gradient and its EMA (`parallel.mesh.shard_module`). A
    state already sharded stays as it is. Returns `state`."""
    if state.sharded:
        return state
    names = mesh_mod.shard_module(state.model, mesh, shardings)
    opt = state.opt_state
    trees = [state.ema_params] + [t for g in opt.groups.values() for t in (g.mu, g.nu)]
    if opt.acc_grads is not None:
        trees.append(opt.acc_grads)
    for tree in trees:
        for name in names:
            if name in tree:
                tree[name] = mesh_mod.slice_leaf(tree[name], mesh)
    state.mesh, state.sharded = mesh, names
    return state


def full_train_state_dict(state: TrainState) -> dict:
    """The contents of a train-state checkpoint (`io.checkpoints.
    train_state_dict`) with every tensor-parallel leaf gathered to its full
    shape: a collective under tensor parallelism (every rank calls it)."""
    from metrabs_tpu_torch.io.checkpoints import train_state_dict
    d = train_state_dict(state)
    if not state.sharded:
        return d
    gather = lambda tree: (None if tree is None
                           else mesh_mod.gather_named(tree, state.sharded, state.mesh))
    d['model'] = gather(d['model'])
    d['ema_params'] = gather(d['ema_params'])
    opt = d['opt_state']
    for g in opt['groups'].values():
        g['mu'], g['nu'] = gather(g['mu']), gather(g['nu'])
    opt['acc_grads'] = gather(opt['acc_grads'])
    return d


def full_ema_state_dict(state: TrainState) -> Dict[str, torch.Tensor]:
    """`state.ema_state_dict()` with the tensor-parallel leaves gathered (a
    collective under tensor parallelism)."""
    sd = state.ema_state_dict()
    return mesh_mod.gather_named(sd, state.sharded, state.mesh) if state.sharded else sd


def full_model_state_dict(state: TrainState) -> Dict[str, torch.Tensor]:
    """`state.model.state_dict()` with the tensor-parallel leaves gathered
    (a collective under tensor parallelism)."""
    sd = state.model.state_dict()
    return mesh_mod.gather_named(sd, state.sharded, state.mesh) if state.sharded else sd


def make_sharded_train_step(train_step, mesh, donate_state=None, state_shardings=None):
    """`train_step` (any step of this module) over `mesh`: the step
    `sharded_step(state, batch3d, batch2d, generator=None, **kwargs) ->
    losses` that every rank calls alike. It takes this rank's rows of each
    batch (`parallel.mesh.shard_batch`; a `LocalRows` batch already holds
    them), runs the step with the train-mode BatchNorms, the losses' batch
    means and the random draws over the global batch
    (`parallel.mesh.data_parallel`; a given `mix` is the global batch's),
    sums the gradients over 'data' before the update, and returns the
    global batch's losses. A W-rank step thus equals the one-rank step on
    the global batch, up to the order of the sums.

    `state_shardings` ({parameter name: placements}, e.g. from
    `parallel.mesh.tp_shardings(mesh, state)`) opts into tensor
    parallelism: the state is sharded in place at the first call
    (`shard_train_state`) and stays so. Default None: the state is
    replicated, each rank holding all of it.

    `donate_state` is accepted for JAX's signature: the port's steps update
    the state in place, which is what donation buys JAX."""
    del donate_state

    def sharded_step(state: TrainState, batch3d: Dict, batch2d: Dict,
                     generator: Optional[torch.Generator] = None, **kwargs):
        if state_shardings is not None:
            shard_train_state(state, mesh, state_shardings)
        b3, b2 = mesh_mod.shard_batch(mesh, batch3d), mesh_mod.shard_batch(mesh, batch2d)
        layout = mesh_mod.BatchLayout(mesh, (len(b3['image']), len(b2['image'])))
        if kwargs.get('mix') is not None:
            kwargs['mix'] = layout.take(torch.as_tensor(kwargs['mix']))
        with mesh_mod.data_parallel(layout):
            return train_step(state, b3, b2, generator=generator, **kwargs)

    return sharded_step
