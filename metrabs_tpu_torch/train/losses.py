"""MeTRAbs training losses (`metrabs_tpu/train/losses.py`).

A 3D-labelled batch and a 2D-labelled batch run through the network
together; the 3D batch gets root-relative, absolute (after
`absloss_start_step`) and in-FOV projection losses, the 2D batch weak 2D
supervision through name-prefix joint matching. Reductions are
validity-masked, millimetres become metres (/1000) inside the losses.
Every mean over the batch is `ops.masked.batch_mean(_masked)`: in a
data-parallel step, the global batch's.

The step gates take the step as a host integer: JAX computes both
reconstructions and selects with `where`; here the one the step selects is
computed.

The latent and manifold modes add the affine-combining autoencoder's
weights (decoder `w_dec` [L, J], encoder `w_enc` [J, L]): `compute_losses`
with `reconstruction_weights` (`w_enc @ w_dec`) for `regularize_to_manifold`,
and `compute_losses_latents_and_all` for `predict_all_and_latents`. Their
point recombinations run in float32 (`models.metrabs.linear_combine_points`),
as JAX's `precision='highest'` einsums; on the card that needs TF32 off for
float32 matmuls, torch's default.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from metrabs_tpu_torch.config import ModelConfig, TrainConfig
from metrabs_tpu_torch.models.metrabs import linear_combine_points
from metrabs_tpu_torch.ops import masked, reconstruct
from metrabs_tpu_torch.utils.joint_info import JointInfo

WEAK_PERSPECTIVE_STEPS = 500


def center_relative_pose(coords3d: torch.Tensor, joint_validity_mask: Optional[torch.Tensor],
                         center_is_mean: bool) -> torch.Tensor:
    """Root-relative (last joint) or mean-relative pose."""
    if not center_is_mean:
        center = coords3d[:, -1:]
    elif joint_validity_mask is None:
        center = torch.mean(coords3d, dim=1, keepdim=True)
    else:
        center = masked.reduce_mean_masked(coords3d, joint_validity_mask, axis=1,
                                           keepdim=True)
    return coords3d - center


def _is_within_fov(coords2d: torch.Tensor, cfg: ModelConfig,
                   border_factor: float = 0.75) -> torch.Tensor:
    return reconstruct.is_within_fov(coords2d, proc_side=cfg.proc_side, stride=cfg.stride_train,
                                     centered_stride=cfg.centered_stride,
                                     border_factor=border_factor)


def compute_loss_with_3d_gt(coords3d_pred_abs: torch.Tensor, coords3d_true: torch.Tensor,
                            intrinsics: torch.Tensor,
                            joint_validity_mask: Optional[torch.Tensor], *,
                            cfg: ModelConfig, tcfg: TrainConfig, step: int) -> torch.Tensor:
    """Root-relative + gated absolute + in-FOV projection loss."""
    diff = coords3d_true - coords3d_pred_abs
    true_rootrel = center_relative_pose(coords3d_true, joint_validity_mask, tcfg.mean_relative)
    pred_rootrel = center_relative_pose(coords3d_pred_abs, joint_validity_mask,
                                        tcfg.mean_relative)
    loss3d = masked.batch_mean_masked(torch.abs(true_rootrel - pred_rootrel) / 1000.0,
                                      joint_validity_mask)

    is_valid_and_far = coords3d_true[..., 2] > 300.0
    if joint_validity_mask is not None:
        is_valid_and_far = joint_validity_mask & is_valid_and_far

    # z is downweighted for far subjects (10000 / |z|, at most 1); xy 2:1 to z.
    absdiff = torch.abs(diff)
    scale_for_far = torch.clamp(10000.0 / torch.abs(coords3d_true[..., 2:]), max=1.0)
    absdiff_scaled = (absdiff[..., :2] * 2 + absdiff[..., 2:] * scale_for_far) / 3
    loss3d_abs = masked.batch_mean_masked(absdiff_scaled, is_valid_and_far) / 1000.0

    coords2d_pred = reconstruct.project_pose(coords3d_pred_abs, intrinsics)
    coords2d_true = reconstruct.project_pose(coords3d_true, intrinsics)
    scale_2d = 1.0 / cfg.proc_side * cfg.box_size_mm / 1000.0
    in_fov_pred = _is_within_fov(coords2d_pred, cfg) & (coords3d_pred_abs[..., 2] > 1)
    near_fov_true = (_is_within_fov(coords2d_true, cfg, border_factor=-20)
                     & (coords3d_true[..., 2] > 1))
    loss2d = masked.batch_mean_masked(
        torch.abs((coords2d_true - coords2d_pred) * scale_2d),
        is_valid_and_far & in_fov_pred & near_fov_true)

    absloss_factor = tcfg.absloss_factor if step > tcfg.absloss_start_step else 0.0
    return loss3d + loss2d + absloss_factor * loss3d_abs


def get_2d_joint_index_groups(joint_info3d: JointInfo,
                              joint_info2d: JointInfo) -> List[List[int]]:
    """For each 2D joint name, the 3D joints whose names start with it.
    Raises on a 2D joint that matches no 3D joint."""
    groups = [[joint_info3d.ids[n3] for n3 in joint_info3d.names if n3.startswith(n2)]
              for n2 in joint_info2d.names]
    empty = [n2 for n2, g in zip(joint_info2d.names, groups) if not g]
    if empty:
        raise ValueError(f'2D joints {empty} match no 3D joint by name-prefix; check the '
                         f'joint naming conventions of the 2D and 3D joint sets')
    return groups


def get_2dlike_joints(coords: torch.Tensor,
                      index_groups: Sequence[Sequence[int]]) -> torch.Tensor:
    """The mean xy of each group of matched 3D joints."""
    return torch.stack([torch.mean(coords[:, list(ids), :2], dim=1) for ids in index_groups],
                       dim=1)


def compute_loss_with_2d_gt(coords3d_pred_abs: torch.Tensor, coords2d_true: torch.Tensor,
                            intrinsics: torch.Tensor, joint_validity_mask: torch.Tensor,
                            index_groups: Sequence[Sequence[int]], *,
                            cfg: ModelConfig) -> torch.Tensor:
    """Weak 2D supervision of the 2D-labelled stream."""
    scale_2d = 1.0 / cfg.proc_side * cfg.box_size_mm / 1000.0
    coords2d_pred_2dlike = get_2dlike_joints(
        reconstruct.project_pose(coords3d_pred_abs, intrinsics), index_groups)
    in_fov_pred = _is_within_fov(coords2d_pred_2dlike, cfg)
    near_fov_true = _is_within_fov(coords2d_true, cfg, border_factor=-20)
    return masked.batch_mean_masked(
        torch.abs((coords2d_true - coords2d_pred_2dlike) * scale_2d),
        joint_validity_mask & in_fov_pred & near_fov_true)


def reconstruct_absolute_trainmode(head2d: torch.Tensor, head3d: torch.Tensor,
                                   intrinsics: torch.Tensor, mix_3d_inside_fov: torch.Tensor,
                                   step: int, *, cfg: ModelConfig) -> torch.Tensor:
    """Weak-perspective reconstruction for the first 500 steps, full
    perspective afterwards; only the one `step` selects is computed."""
    return reconstruct.reconstruct_absolute(
        head2d, head3d, intrinsics, proc_side=cfg.proc_side, stride=cfg.stride_train,
        centered_stride=cfg.centered_stride, mix_3d_inside_fov=mix_3d_inside_fov,
        weak_perspective=step < WEAK_PERSPECTIVE_STEPS)


def compute_losses_latents_and_all(
        preds_abs: torch.Tensor, preds_abs_latent: torch.Tensor, preds_abs_2d: torch.Tensor,
        preds_abs_2d_latent: torch.Tensor, batch3d: Dict, batch2d: Dict,
        index_groups: Sequence[Sequence[int]], *, cfg: ModelConfig, tcfg: TrainConfig,
        step: int, recombination_weights: torch.Tensor,
        encoder_weights: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The hybrid student-teacher losses of `predict_all_and_latents`: the
    all-joints head (`preds_abs*`) teaches the latent head (`*_latent`) once
    `step > teacher_start_step`; both heads are tied to the ground truth
    directly and through the autoencoder. The 2D batch's manifold and
    teacher terms count half. With `stop_gradient_latent` the teacher's
    latents are detached."""
    w_dec, w_enc = recombination_weights, encoder_weights
    w_rec = torch.matmul(w_enc.float(), w_dec.float())
    sg = (lambda x: x.detach()) if tcfg.stop_gradient_latent else (lambda x: x)
    losses = {}

    def loss3d(pred, true, intrinsics, mask=None):
        return compute_loss_with_3d_gt(pred, true, intrinsics, mask, cfg=cfg, tcfg=tcfg,
                                       step=step)

    def loss_vs_reconstr(pred):
        return masked.batch_mean(torch.abs(pred - linear_combine_points(pred, w_rec))) / 1000.0

    true3d, intr3d, mask3d = (batch3d['coords3d_true'], batch3d['intrinsics'],
                              batch3d.get('joint_validity_mask'))
    losses['loss_allhead_vs_gt'] = loss3d(preds_abs, true3d, intr3d, mask3d)
    losses['loss_latentheadreconstruction_vs_gt'] = loss3d(
        linear_combine_points(preds_abs_latent, w_dec), true3d, intr3d, mask3d)
    losses['loss_allhead_vs_reconstr'] = loss_vs_reconstr(preds_abs)
    losses['loss_allhead_ae_vs_gt'] = loss3d(linear_combine_points(preds_abs, w_rec), true3d,
                                             intr3d, mask3d)
    losses['loss_latenthead_vs_latents_from_allhead'] = loss3d(
        preds_abs_latent, linear_combine_points(sg(preds_abs), w_enc), intr3d)

    teacher_factor = tcfg.teacher_loss_factor if step > tcfg.teacher_start_step else 0.0
    losses['loss_3dbatch'] = (
        losses['loss_allhead_vs_gt']
        + losses['loss_latentheadreconstruction_vs_gt']
        + tcfg.allhead_aegt_loss_factor * losses['loss_allhead_ae_vs_gt']
        + tcfg.loss_manif_factor * losses['loss_allhead_vs_reconstr']
        + teacher_factor * losses['loss_latenthead_vs_latents_from_allhead'])

    def loss2d(pred):
        return compute_loss_with_2d_gt(pred, batch2d['coords2d_true'], batch2d['intrinsics'],
                                       batch2d['joint_validity_mask'], index_groups, cfg=cfg)

    losses['loss_allhead_vs_gt_2dbatch'] = loss2d(preds_abs_2d)
    losses['loss_latentheadreconstruction_vs_gt_2dbatch'] = loss2d(
        linear_combine_points(preds_abs_2d_latent, w_dec))
    losses['loss_allhead_vs_reconstr_2dbatch'] = loss_vs_reconstr(preds_abs_2d)
    losses['loss_allhead_ae_vs_gt_2dbatch'] = loss2d(linear_combine_points(preds_abs_2d, w_rec))
    losses['loss_latenthead_vs_latents_from_allhead_2dbatch'] = loss3d(
        preds_abs_2d_latent, linear_combine_points(sg(preds_abs_2d), w_enc),
        batch2d['intrinsics'])

    losses['loss_2dbatch'] = (
        losses['loss_allhead_vs_gt_2dbatch']
        + losses['loss_latentheadreconstruction_vs_gt_2dbatch']
        + tcfg.allhead_aegt_loss_factor * losses['loss_allhead_ae_vs_gt_2dbatch']
        + 0.5 * (tcfg.loss_manif_factor * tcfg.loss_manif_factor2d
                 * losses['loss_allhead_vs_reconstr_2dbatch'])
        + 0.5 * teacher_factor * losses['loss_latenthead_vs_latents_from_allhead_2dbatch'])
    losses['loss'] = losses['loss_3dbatch'] + tcfg.loss2d_factor * losses['loss_2dbatch']
    return losses


def compute_losses(preds_abs: torch.Tensor, preds_abs_2d: torch.Tensor, batch3d: Dict,
                   batch2d: Dict, index_groups: Sequence[Sequence[int]], *,
                   cfg: ModelConfig, tcfg: TrainConfig, step: int,
                   reconstruction_weights: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """loss_3dbatch, loss_2dbatch and loss = loss_3dbatch + loss2d_factor *
    loss_2dbatch. With `regularize_to_manifold`, also each batch's distance
    to its autoencoder reconstruction through `reconstruction_weights`
    [J, J] (`w_enc @ w_dec`), weighted by `loss_manif_factor` (and
    `loss_manif_factor2d` on the 2D batch)."""
    losses = {}
    losses['loss_3dbatch'] = compute_loss_with_3d_gt(
        preds_abs, batch3d['coords3d_true'], batch3d['intrinsics'],
        batch3d.get('joint_validity_mask'), cfg=cfg, tcfg=tcfg, step=step)
    losses['loss_2dbatch'] = compute_loss_with_2d_gt(
        preds_abs_2d, batch2d['coords2d_true'], batch2d['intrinsics'],
        batch2d['joint_validity_mask'], index_groups, cfg=cfg)
    losses['loss'] = losses['loss_3dbatch'] + tcfg.loss2d_factor * losses['loss_2dbatch']
    if tcfg.regularize_to_manifold:
        if reconstruction_weights is None:
            raise ValueError('regularize_to_manifold requires autoencoder weights')
        for key, pred in (('loss_pred_vs_reconstr', preds_abs),
                          ('loss_pred_vs_reconstr_2dbatch', preds_abs_2d)):
            losses[key] = masked.batch_mean(torch.abs(
                pred - linear_combine_points(pred, reconstruction_weights))) / 1000.0
        losses['loss'] = (
            losses['loss_3dbatch'] + tcfg.loss_manif_factor * losses['loss_pred_vs_reconstr']
            + tcfg.loss2d_factor * losses['loss_2dbatch']
            + (tcfg.loss2d_factor * tcfg.loss_manif_factor * tcfg.loss_manif_factor2d
               * losses['loss_pred_vs_reconstr_2dbatch']))
    return losses
