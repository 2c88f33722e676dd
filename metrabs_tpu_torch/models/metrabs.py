"""The MeTRAbs crop model (`metrabs_tpu/models/metrabs.py`): backbone +
dual-heatmap head + absolute reconstruction, in plain mode or one of the
two latent-joint modes:

  - `latent_mode='transform_coords'`: the head predicts `n_latents` points,
    decoded to joints after the absolute reconstruction;
  - `latent_mode='predict_all_and_latents'`: the head predicts `n_latents`
    + `n_joints` points; the forward uses the latent part, decoded to
    joints.

The encoder and recombination weights are JAX's `constants` collection,
here float32 buffers of the top-level module (`recombination_weights`
[n_latents, n_joints], `encoder_weights` [n_joints, n_latents]); the
loader casts only the submodules to `cfg.dtype`, so they stay float32.

The backbone and the head's conv compute in `cfg.dtype` (float32 master
weights train in bfloat16); the head decode, the reconstruction and the
latent recombination run in float32. `build_crop_model` builds any crop
model class of a package (Metrabs, Metro, Model25D).

`set_last_point_weights` (on a JAX-style variable tree) and
`set_last_point_weights_` (on the port's head, in place) are the head
surgery of fine-tuning: a smaller head's points go into the last slots of
this head. The head's channels are [2D | 3D interleaved by depth], channel
d * n_points + j of the 3D part; they run along flax's kernel's last axis
[1, 1, in, out] and along dim 0 of the port's weight [out, in, 1, 1].
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from metrabs_tpu_torch.config import ModelConfig
from metrabs_tpu_torch.models.backbones.builder import build_backbone
from metrabs_tpu_torch.models.heads import MetrabsHeads
from metrabs_tpu_torch.ops import reconstruct

LATENT_MODES = ('', 'transform_coords', 'predict_all_and_latents')


def linear_combine_points(coords: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Affine recombination of points in float32: [..., j, c] x [j, J] ->
    [..., J, c]."""
    return torch.einsum('...jc,jJ->...Jc', coords.float(), weights.float())


class Metrabs(nn.Module):
    def __init__(self, cfg: ModelConfig, backbone: nn.Module, latent_mode: str = '',
                 n_latents: int = 0):
        super().__init__()
        if latent_mode not in LATENT_MODES:
            raise ValueError(f'Unknown latent_mode {latent_mode!r}; one of {LATENT_MODES}')
        self.cfg = cfg
        self.backbone = backbone
        self.latent_mode = latent_mode
        self.n_latents = n_latents
        self.heatmap_heads = MetrabsHeads(cfg, self.n_raw_points, backbone.out_channels)
        if latent_mode:
            self.register_buffer('recombination_weights',
                                 torch.zeros(n_latents, cfg.n_joints, dtype=torch.float32))
            self.register_buffer('encoder_weights',
                                 torch.zeros(cfg.n_joints, n_latents, dtype=torch.float32))

    @property
    def n_raw_points(self) -> int:
        if self.latent_mode == 'transform_coords':
            return self.n_latents
        if self.latent_mode == 'predict_all_and_latents':
            return self.n_latents + self.cfg.n_joints
        return self.cfg.n_joints

    def backbone_and_head(self, image: torch.Tensor, train: bool = False,
                          generator: Optional[torch.Generator] = None):
        """(features NCHW, coords2d [N, P, 2] px, coords3d_rel [N, P, 3] mm)
        of the head's `n_raw_points` points. `train` is JAX's flag and must
        be the module's mode (`.train()`: batch-statistics BN and
        drop-connect from `generator`; the head decodes at `stride_train`)."""
        if train != self.training:
            raise ValueError(f'train={train} but the module is in '
                             f'{"train" if self.training else "eval"} mode')
        features = self.backbone(image, generator=generator)
        coords2d, coords3d = self.heatmap_heads(features, train=train)
        return features, coords2d, coords3d

    def forward(self, image: torch.Tensor, intrinsics: torch.Tensor,
                sample_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[N, S, S, 3] NHWC crops + [N, 3, 3] intrinsics -> [N, J, 3] absolute
        camera-space joints in millimeters. `sample_valid` masks padding crops
        out of the reconstruction's pooled RMS normalization. In train mode
        the head decodes at `stride_train`, as JAX's `train=True`."""
        _, coords2d, coords3d = self.backbone_and_head(image, train=self.training)
        if self.latent_mode == 'predict_all_and_latents':
            coords2d = coords2d[:, :self.n_latents]
            coords3d = coords3d[:, :self.n_latents]
        # The FOV trust border always uses stride_train, as the reference.
        coords3d_abs = reconstruct.reconstruct_absolute(
            coords2d, coords3d, intrinsics.float(),
            proc_side=self.cfg.proc_side, stride=self.cfg.stride_train,
            centered_stride=self.cfg.centered_stride,
            mix_3d_inside_fov=self.cfg.mix_3d_inside_fov,
            weak_perspective=self.cfg.weak_perspective,
            sample_valid=sample_valid)
        if self.latent_mode:
            coords3d_abs = self.latent_points_to_joints(coords3d_abs)
        return coords3d_abs

    def latent_points_to_joints(self, points: torch.Tensor) -> torch.Tensor:
        return linear_combine_points(points, self.recombination_weights)

    def joints_to_latent_points(self, points: torch.Tensor) -> torch.Tensor:
        return linear_combine_points(points, self.encoder_weights)

    def joints_to_joints(self, points: torch.Tensor) -> torch.Tensor:
        return linear_combine_points(points, self.encoder_weights @ self.recombination_weights)


@torch.no_grad()
def _write_last_points(dst: torch.Tensor, src: torch.Tensor, depth: int,
                       n_points: int) -> None:
    """Writes the channels of `src` ((1 + depth) * n_other along dim 0) into
    the last n_other points of `dst` ((1 + depth) * n_points along dim 0),
    in place."""
    n_other = src.shape[0] // (1 + depth)
    dst[n_points - n_other:n_points] = src[:n_other]
    dst[n_points:].unflatten(0, (depth, n_points))[:, n_points - n_other:] = (
        src[n_other:].unflatten(0, (depth, n_other)))


def set_last_point_weights_(heads: MetrabsHeads, other_weight: torch.Tensor,
                            other_bias: torch.Tensor) -> None:
    """Writes a smaller Metrabs head's `conv_final` weight [O, in, 1, 1] and
    bias [O] (O = (1 + depth) * n_other) into the last n_other points of
    `heads`, in place."""
    conv, depth = heads.conv_final, heads.cfg.depth
    _write_last_points(conv.weight, other_weight.to(conv.weight), depth, heads.n_points)
    _write_last_points(conv.bias, other_bias.to(conv.bias), depth, heads.n_points)


def set_last_point_weights(params: Dict, other_kernel: np.ndarray, other_bias: np.ndarray,
                           depth: int, n_points: int,
                           head_path=('heatmap_heads', 'conv_final')) -> Dict:
    """The head surgery on a JAX-style params tree (`metrabs_tpu/models/
    metrabs.py::set_last_point_weights`): returns a copy of `params` whose
    head at `head_path` (kernel [1, 1, in, (1 + depth) * n_points]) holds
    `other_kernel` and `other_bias` in its last points."""
    params = dict(params)
    node = params
    for key in head_path[:-1]:
        node[key] = dict(node[key])
        node = node[key]
    conv = dict(node[head_path[-1]])
    node[head_path[-1]] = conv
    kernel = np.array(conv['kernel'], np.float32)
    bias = np.array(conv['bias'], np.float32)
    _write_last_points(torch.from_numpy(kernel).movedim(-1, 0),
                       torch.from_numpy(np.asarray(other_kernel, np.float32)).movedim(-1, 0),
                       depth, n_points)
    _write_last_points(torch.from_numpy(bias), torch.from_numpy(
        np.asarray(other_bias, np.float32)), depth, n_points)
    conv['kernel'], conv['bias'] = kernel, bias
    return params


def build_crop_model(cfg: ModelConfig, backbone_builder=None, *, model_class: str = 'metrabs',
                     latent_mode: str = '', n_latents: int = 0,
                     bones: Sequence[Tuple[int, int]] = (),
                     bone_lengths_ideal: Sequence[float] = ()) -> nn.Module:
    """An uninitialized crop model of `model_class` ('metrabs', 'metro' or
    'model25d', a package manifest's field) for `cfg`: flat layout, BN
    folded iff `cfg.bn_fold`, computing in `cfg.dtype`, blocks
    rematerialised in the backward pass iff `cfg.backbone_remat`.
    `backbone_builder` (default `build_backbone`) takes the same arguments as
    `build_backbone`. `latent_mode` and `n_latents` are Metrabs', `bones`
    and `bone_lengths_ideal` Model25D's."""
    backbone = (backbone_builder or build_backbone)(
        cfg.backbone, centered_stride=cfg.centered_stride,
        stride_test=cfg.stride_test if cfg.stride_test != cfg.stride_train else None,
        bn_fold=cfg.bn_fold, dtype=getattr(torch, cfg.dtype), remat=cfg.backbone_remat)
    if model_class == 'metrabs':
        return Metrabs(cfg, backbone, latent_mode, n_latents)
    if model_class == 'metro':
        from metrabs_tpu_torch.models.metro import Metro
        return Metro(cfg, backbone)
    if model_class == 'model25d':
        from metrabs_tpu_torch.models.model25d import Model25D
        return Model25D(cfg, backbone, bones, bone_lengths_ideal)
    raise ValueError(f'Unknown model_class {model_class!r}')
