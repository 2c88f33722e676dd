"""Detector training for the YOLOv4 family (`metrabs_tpu/detect/train.py`).

The reference never trains its person detector (it consumes an external
SavedModel); the JAX package added this so that the train -> package ->
`detect_poses` loop can run on freshly minted weights, and the port keeps
it: a classic anchor-based single-stage objective (best-anchor assignment,
decoded-offset + log-size box regression, objectness BCE with
prediction-IoU ignore zones, per-class BCE) over the same raw head outputs
`decode_head` consumes at serving time, so a net trained here serves
through `PersonDetector` unchanged.

Assignment runs on the host per batch (numpy -> dense per-scale target
arrays: `build_targets`, the JAX function's copy). The loss and the step
follow JAX's in torch:

- BatchNorm stays frozen while training, as in JAX, whose `ConvBlock`
  normalises with the running statistics even with `train=True`: the
  port's `FrozenBatchNorm2d` learns its scale and shift and never updates
  its statistics. A detector built with `bn_fold` cannot be trained.
- The heads are `[N, gh, gw, 3 * (5 + C)]` and reshape to
  `[..., 3, 5 + C]`: anchor-major, channels last, as JAX's.
- The ignore zones are a step function of the decoded boxes (computed
  without gradients: none flows through a comparison in JAX either).
- BCE in optax's log-sigmoid form; the loss is normalised by
  `max(n_pos, 1)`.
- The optimizer is `train.optim.Adam` (`optax.adam`), with a constant LR or
  `train.optim.cosine_decay_schedule`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from metrabs_tpu_torch.detect.yolov4 import (
    ANCHORS_TINY, STRIDES_TINY, XYSCALE_TINY, decode_head)
from metrabs_tpu_torch.pipeline.estimator import checked_device
from metrabs_tpu_torch.train import optim


def _wh_iou(wh_a: np.ndarray, wh_b: np.ndarray) -> np.ndarray:
    """IoU of width/height pairs as if concentric: [n,2] x [m,2] -> [n,m]."""
    inter = (np.minimum(wh_a[:, None, 0], wh_b[None, :, 0])
             * np.minimum(wh_a[:, None, 1], wh_b[None, :, 1]))
    union = (wh_a[:, 0] * wh_a[:, 1])[:, None] \
        + (wh_b[:, 0] * wh_b[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def build_targets(
        boxes_per_image: Sequence[np.ndarray], input_size: int,
        num_classes: int = 80,
        class_ids_per_image: Optional[Sequence[np.ndarray]] = None,
        anchors: np.ndarray = ANCHORS_TINY,
        strides: Sequence[int] = STRIDES_TINY):
    """Dense training targets for a batch (the JAX function, host numpy).

    boxes_per_image: per image an [m_i, 4] float array of (x, y, w, h)
    TOP-LEFT-format boxes in detector-input pixels (the format
    `PersonDetector.detect_batched` emits). Each ground-truth box is assigned
    to the single best wh-IoU anchor across all scales, at the grid cell
    containing its center. The default tables are YOLOv4-tiny's: pass a
    full YOLOv4's `decode_tables` anchors and strides for it.

    Returns (targets, obj_masks, gt_boxes_padded, gt_valid):
      targets[s]: [N, gh, gw, 3, 5] = (ox, oy, tw, th, class_id) where
        (ox, oy) is the in-cell center offset in [0, 1), (tw, th) the raw
        log-size regression target, class_id the integer class;
      obj_masks[s]: [N, gh, gw, 3] bool positive-assignment mask;
      gt_boxes_padded: [N, max_m, 4] CENTER-format boxes (for the ignore
        zones computed against decoded predictions inside the loss);
      gt_valid: [N, max_m] bool.
    """
    n = len(boxes_per_image)
    grids = [input_size // s for s in strides]
    anchors = np.asarray(anchors, np.float32) * (input_size / 416.0)
    flat_anchors = anchors.reshape(-1, 2)

    targets = [np.zeros((n, g, g, 3, 5), np.float32) for g in grids]
    obj_masks = [np.zeros((n, g, g, 3), bool) for g in grids]
    max_m = max((len(b) for b in boxes_per_image), default=1) or 1
    gt_boxes = np.zeros((n, max_m, 4), np.float32)
    gt_valid = np.zeros((n, max_m), bool)

    for i, boxes in enumerate(boxes_per_image):
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        cls = (np.asarray(class_ids_per_image[i], np.int64)
               if class_ids_per_image is not None
               else np.zeros(len(boxes), np.int64))
        for m, (x, y, w, h) in enumerate(boxes):
            cx, cy = x + w / 2, y + h / 2
            gt_boxes[i, m] = (cx, cy, w, h)
            gt_valid[i, m] = True
            best = int(np.argmax(_wh_iou(
                np.array([[w, h]], np.float32), flat_anchors)[0]))
            s, a = divmod(best, anchors.shape[1])
            g = grids[s]
            gx = min(int(cx / strides[s]), g - 1)
            gy = min(int(cy / strides[s]), g - 1)
            ox = cx / strides[s] - gx
            oy = cy / strides[s] - gy
            tw = np.log(max(w, 1e-3) / anchors[s, a, 0])
            th = np.log(max(h, 1e-3) / anchors[s, a, 1])
            targets[s][i, gy, gx, a] = (ox, oy, tw, th, float(cls[m]))
            obj_masks[s][i, gy, gx, a] = True
    return targets, obj_masks, gt_boxes, gt_valid


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """`optax.sigmoid_binary_cross_entropy`: -z log σ(x) - (1 - z) log σ(-x)."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def detection_loss(
        heads: Sequence[torch.Tensor], targets, obj_masks, gt_boxes, gt_valid,
        *, input_size: int, num_classes: int = 80,
        anchors: np.ndarray = ANCHORS_TINY,
        strides: Sequence[int] = STRIDES_TINY,
        xyscale: Sequence[float] = XYSCALE_TINY,
        ignore_iou: float = 0.5, box_weight: float = 5.0,
        obj_weight: float = 1.0, cls_weight: float = 1.0) -> torch.Tensor:
    """Total detection loss over all head scales (scalar, batch-mean).
    `heads` are the raw outputs `[N, gh, gw, 3 * (5 + C)]`, computed on in
    float32 (float64 heads in float64); the targets are `build_targets'`
    (numpy or tensors), moved to the heads' device."""
    device = heads[0].device
    as_f32 = lambda x: torch.as_tensor(x, device=device).float()
    gt_boxes = as_f32(gt_boxes)
    gt_valid = torch.as_tensor(gt_valid, device=device).bool()
    total = torch.zeros((), device=device)
    n_pos_total = torch.zeros((), device=device)
    for s, raw in enumerate(heads):
        raw = raw.to(torch.promote_types(raw.dtype, torch.float32))  # float64 stays float64
        n, gh, gw, _ = raw.shape
        raw = raw.reshape(n, gh, gw, 3, 5 + num_classes)
        tgt = as_f32(targets[s])
        pos = as_f32(obj_masks[s])
        n_pos_total = n_pos_total + pos.sum()

        # Box regression at positives: decoded in-cell offset (the exact
        # decode_head xy transform) vs target offset, raw log-size vs target.
        sc = xyscale[s]
        xy_pred = torch.sigmoid(raw[..., 0:2]) * sc - 0.5 * (sc - 1)
        xy_loss = torch.sum(torch.square(xy_pred - tgt[..., 0:2]), dim=-1)
        wh_loss = torch.sum(torch.square(raw[..., 2:4] - tgt[..., 2:4]), dim=-1)
        total = total + box_weight * torch.sum(pos * (xy_loss + wh_loss))

        # Objectness: positives -> 1; negatives -> 0 except ignore zones
        # where the decoded prediction already overlaps a GT box well.
        with torch.no_grad():
            pb = decode_head(raw.reshape(n, gh, gw, -1), s, input_size, np.asarray(anchors),
                             tuple(strides), tuple(xyscale))[..., :4]
            a_min = pb[..., None, :2] - pb[..., None, 2:4] / 2
            a_max = pb[..., None, :2] + pb[..., None, 2:4] / 2
            b_min = gt_boxes[:, None, :, :2] - gt_boxes[:, None, :, 2:4] / 2
            b_max = gt_boxes[:, None, :, :2] + gt_boxes[:, None, :, 2:4] / 2
            inter = torch.prod(torch.clamp_min(
                torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min), 0.0), dim=-1)
            area_a = torch.prod(pb[..., 2:4], dim=-1)[..., None]
            area_b = torch.prod(gt_boxes[:, None, :, 2:4], dim=-1)
            iou = inter / torch.clamp_min(area_a + area_b - inter, 1e-9)
            iou = torch.where(gt_valid[:, None, :], iou, 0.0)
            best_iou = torch.amax(iou, dim=-1).reshape(n, gh, gw, 3)
            ignore = (best_iou > ignore_iou).float() * (1.0 - pos)

        obj_loss = _bce(raw[..., 4], pos)
        total = total + obj_weight * torch.sum(obj_loss * (1.0 - ignore))

        cls_labels = F.one_hot(tgt[..., 4].long(), num_classes).float()
        cls_loss = torch.sum(_bce(raw[..., 5:], cls_labels), dim=-1)
        total = total + cls_weight * torch.sum(pos * cls_loss)
    return total / torch.clamp_min(n_pos_total, 1.0)


@dataclasses.dataclass
class DetectorTrainState:
    """The detector module (its parameters: conv kernels and biases, BN scale
    and shift; its frozen BN statistics as buffers), the Adam state and the
    step count."""
    model: nn.Module
    opt_state: optim.AdamState
    step: int = 0

    def params(self):
        return dict(self.model.named_parameters())


def create_detector_train_state(model: nn.Module, tx: optim.Adam,
                                device='cuda') -> DetectorTrainState:
    """Moves `model` (a YOLOv4 or YOLOv4-tiny of `detect.yolov4`, its weights
    made or loaded, float32, or float64 for a reference run) to `device` and
    starts training it: every parameter requires gradients, a fresh Adam
    state, step 0."""
    if getattr(model, 'bn_fold', False):
        raise ValueError('bn_fold is an inference-only layout')
    if model.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f'detector training in {model.dtype}: the port trains '
                                  f'float32 detectors (float64 for reference runs)')
    model.to(checked_device(device)).requires_grad_(True)
    return DetectorTrainState(model=model, opt_state=tx.init(dict(model.named_parameters())))


def make_detector_train_step(model: nn.Module, tx: optim.Adam, *, input_size: int,
                             num_classes: int = 80,
                             loss_kwargs: Optional[dict] = None):
    """Returns step(state, images_f [N, S, S, 3] in [0, 1], targets, obj_masks,
    gt_boxes, gt_valid) -> (state, loss), updating the state in place;
    targets come from `build_targets` (numpy or tensors), the images as
    numpy or a tensor, each moved to the model's device."""
    anchors, strides, xyscale = model.decode_tables
    kwargs = dict(loss_kwargs or {})

    def step(state: DetectorTrainState, images, targets, obj_masks, gt_boxes, gt_valid):
        if state.model is not model:
            raise ValueError("The train step was made for another model than the state's")
        device = next(model.parameters()).device
        images = torch.as_tensor(images).to(device)
        heads = model(images)
        loss = detection_loss(
            heads, targets, obj_masks, gt_boxes, gt_valid,
            input_size=input_size, num_classes=num_classes,
            anchors=anchors, strides=strides, xyscale=xyscale, **kwargs)
        params = state.params()
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        tx.step(params, grads, state.opt_state)
        state.step += 1
        return state, loss.detach()

    return step
