"""YOLOv4 and YOLOv4-tiny person detectors, inference only
(`metrabs_tpu/detect/yolov4.py`), and the `PersonDetector` of every
detector family (YOLOv8 is in `detect.yolov8`).

Same networks as the JAX module, in darknet cfg order with the flat
`conv_<i>` naming (the scanned `res_scan_<start>_<n>` groups are unrolled by
`io.weights.yolo_scanned_to_flat`): `ConvBlock` (darknet's top-left (1, 0)
zero pad before a stride-2 conv, SAME otherwise; BN eps 1e-5, folded or
not; mish, leaky 0.1 or linear), CSPDarknet53 + SPP (max pools 13/9/5 with
SAME padding, padded with -inf) + PANet with three heads, and the two-head
tiny variant with its channel-half route. Internally NCHW; the public input
is NHWC in [0, 1] and the heads come out NHWC, as in JAX.

Each architecture is written once, as a function of a small set of
operations (`_Build` counts channels and registers the convs, `_Run`
applies them), so that the module's layers and its forward cannot drift
apart.

`PersonDetector` is the batched detection contract: gamma-correct resize of
the longer side to `input_size` in the detector's compute dtype (`ops.resize`,
`jax.image.resize`'s kernel), gray 0.5 pad to a multiple of 32, optional
horizontal (and vertical) flip augmentation, float32 decode, exact top-k of
`top_candidates` (`approx_max_k` is not ported), per-image greedy box NMS
batched over images, the top `max_detections` and the per-axis unscale to
original pixels.

`load_darknet_weights` reads a released darknet `.weights` file onto the
flat-layout variable tree (`io.weights.detector_state_dict_from_flax` puts
it into the module); `write_darknet_weights` is its inverse.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from metrabs_tpu_torch.detect.yolov8 import YOLOv8, decode_heads
from metrabs_tpu_torch.models.backbones.common import FrozenBatchNorm2d
from metrabs_tpu_torch.ops import resize
from metrabs_tpu_torch.ops.nms import greedy_nms

# COCO-trained YOLOv4 anchors (pixels at 416 input) and decode scales.
ANCHORS = np.array(
    [[(12, 16), (19, 36), (40, 28)],
     [(36, 75), (76, 55), (72, 146)],
     [(142, 110), (192, 243), (459, 401)]], np.float32)
STRIDES = (8, 16, 32)
XYSCALE = (1.2, 1.1, 1.05)
NUM_CLASSES = 80
PERSON_CLASS = 0

# YOLOv4-tiny: stride 16 uses anchor mask (1, 2, 3), stride 32 (3, 4, 5).
ANCHORS_TINY = np.array(
    [[(23, 27), (37, 58), (81, 82)],
     [(81, 82), (135, 169), (344, 319)]], np.float32)
STRIDES_TINY = (16, 32)
XYSCALE_TINY = (1.05, 1.05)

BN_EPSILON = 1e-5


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)), with softplus as `jax.nn.softplus`
    (logaddexp(x, 0)) rather than `F.softplus`'s linear cut-off above 20."""
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


class ConvBlock(nn.Module):
    """darknet 'convolutional' section: conv + optional BN + activation."""

    def __init__(self, cin: int, filters: int, kernel: int, stride: int = 1,
                 activation: str = 'leaky', use_bn: bool = True, bn_fold: bool = False):
        super().__init__()
        if activation not in ('mish', 'leaky', 'linear'):
            raise ValueError(f'Unknown activation {activation!r}')
        self.stride = stride
        self.activation = activation
        # Stride 2: darknet's top-left zero pad (1, 0) and a VALID conv;
        # otherwise SAME, symmetric for the odd kernels used here.
        self.conv = nn.Conv2d(cin, filters, kernel, stride=stride,
                              padding=0 if stride == 2 else kernel // 2,
                              bias=(not use_bn) or bn_fold)
        self.bn = FrozenBatchNorm2d(filters, BN_EPSILON) if use_bn and not bn_fold else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            x = F.pad(x, (1, 0, 1, 0))
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.activation == 'mish':
            return mish(x)
        if self.activation == 'leaky':
            return F.leaky_relu(x, 0.1)
        return x


class _Build:
    """Architecture operations on channel counts: registers `conv_<i>`."""

    def __init__(self, module: nn.Module, bn_fold: bool):
        self.module = module
        self.bn_fold = bn_fold
        self.count = 0

    def conv(self, x: int, filters: int, kernel: int, stride: int = 1,
             act: str = 'leaky', bn: bool = True) -> int:
        self.module.add_module(f'conv_{self.count}', ConvBlock(
            x, filters, kernel, stride, act, bn, self.bn_fold))
        self.count += 1
        return filters

    @staticmethod
    def add(x: int, y: int) -> int:
        return x

    @staticmethod
    def cat(xs: Sequence[int]) -> int:
        return sum(xs)

    @staticmethod
    def spp(x: int) -> int:
        return 4 * x

    @staticmethod
    def upsample(x: int) -> int:
        return x

    @staticmethod
    def pool2(x: int) -> int:
        return x

    @staticmethod
    def second_half(x: int) -> int:
        return x - x // 2


class _Run:
    """The same operations on NCHW tensors, applying the registered convs."""

    def __init__(self, module: nn.Module):
        self.module = module
        self.count = 0

    def conv(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        block = getattr(self.module, f'conv_{self.count}')
        self.count += 1
        return block(x)

    @staticmethod
    def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return x + y

    @staticmethod
    def cat(xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(xs), dim=1)

    @staticmethod
    def spp(x: torch.Tensor) -> torch.Tensor:
        pools = [F.max_pool2d(x, k, stride=1, padding=k // 2) for k in (13, 9, 5)]
        return torch.cat(pools + [x], dim=1)

    @staticmethod
    def upsample(x: torch.Tensor) -> torch.Tensor:
        return resize.upsample_nearest_2x(x)

    @staticmethod
    def pool2(x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, 2, stride=2)

    @staticmethod
    def second_half(x: torch.Tensor) -> torch.Tensor:
        return x[:, x.shape[1] // 2:]


def _yolov4_graph(x, ops, num_classes: int):
    """CSPDarknet53 + SPP + PANet (`metrabs_tpu/detect/yolov4.py:132-252`)."""
    conv = ops.conv

    def res_block(x, f1, f2):
        y = conv(x, f1, 1, act='mish')
        return ops.add(x, conv(y, f2, 3, act='mish'))

    def csp_stage(x, down_filters, n_blocks, res_f1, res_f2, out_filters, split_filters):
        x = conv(x, down_filters, 3, stride=2, act='mish')
        route = conv(x, split_filters, 1, act='mish')
        x = conv(x, split_filters, 1, act='mish')
        for _ in range(n_blocks):
            x = res_block(x, res_f1, res_f2)
        x = conv(x, split_filters, 1, act='mish')
        return conv(ops.cat([x, route]), out_filters, 1, act='mish')

    x = conv(x, 32, 3, act='mish')
    x = conv(x, 64, 3, stride=2, act='mish')
    route = conv(x, 64, 1, act='mish')
    x = conv(x, 64, 1, act='mish')
    x = res_block(x, 32, 64)
    x = conv(x, 64, 1, act='mish')
    x = conv(ops.cat([x, route]), 64, 1, act='mish')
    x = csp_stage(x, 128, 2, 64, 64, 128, 64)
    route_1 = x = csp_stage(x, 256, 8, 128, 128, 256, 128)  # stride 8
    route_2 = x = csp_stage(x, 512, 8, 256, 256, 512, 256)  # stride 16
    x = csp_stage(x, 1024, 4, 512, 512, 1024, 512)

    for f, k in [(512, 1), (1024, 3), (512, 1)]:
        x = conv(x, f, k)
    x = ops.spp(x)
    for f, k in [(512, 1), (1024, 3), (512, 1)]:
        x = conv(x, f, k)
    route_3 = x  # stride 32

    x = ops.upsample(conv(route_3, 256, 1))
    x = ops.cat([conv(route_2, 256, 1), x])
    for f, k in [(256, 1), (512, 3), (256, 1), (512, 3), (256, 1)]:
        x = conv(x, f, k)
    route_16 = x
    x = ops.upsample(conv(x, 128, 1))
    x = ops.cat([conv(route_1, 128, 1), x])
    for f, k in [(128, 1), (256, 3), (128, 1), (256, 3), (128, 1)]:
        x = conv(x, f, k)
    route_8 = x

    n_out = 3 * (5 + num_classes)
    sbbox = conv(conv(route_8, 256, 3), n_out, 1, act='linear', bn=False)  # conv_93
    x = ops.cat([conv(route_8, 256, 3, stride=2), route_16])
    for f, k in [(256, 1), (512, 3), (256, 1), (512, 3), (256, 1)]:
        x = conv(x, f, k)
    route_16b = x
    mbbox = conv(conv(x, 512, 3), n_out, 1, act='linear', bn=False)  # conv_101
    x = ops.cat([conv(route_16b, 512, 3, stride=2), route_3])
    for f, k in [(512, 1), (1024, 3), (512, 1), (1024, 3), (512, 1)]:
        x = conv(x, f, k)
    lbbox = conv(conv(x, 1024, 3), n_out, 1, act='linear', bn=False)  # conv_109
    return sbbox, mbbox, lbbox


def _yolov4_tiny_graph(x, ops, num_classes: int):
    """CSPOSANet + two heads (`metrabs_tpu/detect/yolov4.py:276-321`)."""
    conv = ops.conv

    def csp_osa_block(x, f):
        full = conv(x, f, 3)
        a = conv(ops.second_half(full), f // 2, 3)
        b = conv(a, f // 2, 3)
        feat = conv(ops.cat([b, a]), f, 1)
        return ops.pool2(ops.cat([full, feat])), feat

    x = conv(x, 32, 3, stride=2)
    x = conv(x, 64, 3, stride=2)
    x, _ = csp_osa_block(x, 64)
    x, _ = csp_osa_block(x, 128)
    x, feat16 = csp_osa_block(x, 256)
    n_out = 3 * (5 + num_classes)
    x = conv(x, 512, 3)
    r = conv(x, 256, 1)
    lbbox = conv(conv(r, 512, 3), n_out, 1, act='linear', bn=False)  # conv_17
    x = ops.cat([ops.upsample(conv(r, 128, 1)), feat16])
    mbbox = conv(conv(x, 256, 3), n_out, 1, act='linear', bn=False)  # conv_20
    return mbbox, lbbox


class _Darknet(nn.Module):
    graph = None
    decode_tables: Tuple

    def __init__(self, num_classes: int = NUM_CLASSES, bn_fold: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.bn_fold = bn_fold
        type(self).graph(3, _Build(self, bn_fold), num_classes)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_0.conv.weight.dtype

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[N, S, S, 3] NHWC in [0, 1] -> raw heads, each [N, gh, gw, 3*(5+C)]."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        heads = type(self).graph(x, _Run(self), self.num_classes)
        return [h.permute(0, 2, 3, 1) for h in heads]


class YOLOv4(_Darknet):
    """Full YOLOv4: 110 conv sections, output convs conv_93/101/109 at
    strides 8/16/32."""
    graph = staticmethod(_yolov4_graph)
    decode_tables = (ANCHORS, STRIDES, XYSCALE)


class YOLOv4Tiny(_Darknet):
    """YOLOv4-tiny: 21 conv sections, heads (conv_20 stride 16, conv_17
    stride 32) in the STRIDES_TINY order."""
    graph = staticmethod(_yolov4_tiny_graph)
    decode_tables = (ANCHORS_TINY, STRIDES_TINY, XYSCALE_TINY)


def build_detector_model(kind: str, bn_fold: bool = False) -> nn.Module:
    """The detector module for a package's `detector_type`: 'yolov4',
    'yolov4-tiny' or 'yolov8{n,s,m,l,x}' (`detect.yolov8`, no BN fold)."""
    if kind == 'yolov4':
        return YOLOv4(bn_fold=bn_fold)
    if kind == 'yolov4-tiny':
        return YOLOv4Tiny(bn_fold=bn_fold)
    if kind.startswith('yolov8') and kind[-1] in 'nsmlx' and len(kind) == 7:
        if bn_fold:
            raise ValueError('bn_fold is not wired for YOLOv8 yet')
        return YOLOv8(size=kind[-1])
    raise ValueError(f'Unknown detector kind {kind!r}')


# The header of a released darknet `.weights` file: major 0, minor 2,
# revision 5, then the int64 count of images seen in training (here 0).
DARKNET_HEADER = np.array([0, 2, 5, 0, 0], np.int32)


def _darknet_sections(flat):
    """Per conv section in cfg order: (its name, whether it has a BN, the
    kernel's HWIO shape), from a flat-layout tree's flattened keys."""
    n_convs = 1 + max(int(k[1].split('_')[1]) for k in flat if k[1].startswith('conv_'))
    return [(f'conv_{i}', ('params', f'conv_{i}', 'bn', 'scale') in flat,
             np.shape(flat[('params', f'conv_{i}', 'conv', 'kernel')]))
            for i in range(n_convs)]


def load_darknet_weights(variables: dict, path: str) -> dict:
    """Imports a darknet `.weights` release file (`yolov4.weights`,
    `yolov4-tiny.weights`; `metrabs_tpu/detect/yolov4.py::
    load_darknet_weights`) into `variables`, the flat-layout, unfolded
    variable tree of the detector (numpy leaves, e.g. `io.weights.
    flax_variables_from_state_dict` of an unfolded `build_detector_model`'s
    state dict). Returns the updated tree.

    darknet layout: 5 int32 header, then per conv section in cfg order:
    [bn: beta, gamma, mean, var][conv: OIHW] or [bias][conv: OIHW] for the
    output convs. The module names conv_<i> follow cfg order, so the import
    is a linear scan. A file that is not consumed exactly raises
    ValueError."""
    from metrabs_tpu_torch.io.weights import flatten_dict, unflatten_dict

    with open(path, 'rb') as f:
        raw = f.read()
    body = len(raw) - 4 * len(DARKNET_HEADER)
    if body < 0 or body % 4:
        raise ValueError(f'{path}: {len(raw)} bytes is not a darknet header and float32s')
    data = np.frombuffer(raw, np.float32, offset=4 * len(DARKNET_HEADER))
    flat = flatten_dict(variables)
    offset = 0

    def take(n):
        nonlocal offset
        if offset + n > len(data):
            raise ValueError(f'Weight file size mismatch: {len(data)} floats end before '
                             f'{offset + n} are read')
        offset += n
        return data[offset - n:offset].copy()

    for name, has_bn, (kh, kw, cin, cout) in _darknet_sections(flat):
        if has_bn:
            flat[('params', name, 'bn', 'bias')] = take(cout)
            flat[('params', name, 'bn', 'scale')] = take(cout)
            flat[('batch_stats', name, 'bn', 'mean')] = take(cout)
            flat[('batch_stats', name, 'bn', 'var')] = take(cout)
        else:
            flat[('params', name, 'conv', 'bias')] = take(cout)
        w = take(cout * cin * kh * kw).reshape(cout, cin, kh, kw)
        flat[('params', name, 'conv', 'kernel')] = np.transpose(w, (2, 3, 1, 0))
    if offset != len(data):
        raise ValueError(f'Weight file size mismatch: consumed {offset} of {len(data)} floats')
    return unflatten_dict(flat)


def write_darknet_weights(variables: dict, path: str) -> None:
    """Writes a flat-layout, unfolded detector tree as a darknet `.weights`
    file, the inverse of `load_darknet_weights`."""
    from metrabs_tpu_torch.io.weights import flatten_dict

    flat = flatten_dict(variables)
    with open(path, 'wb') as f:
        f.write(DARKNET_HEADER.tobytes())
        for name, has_bn, _ in _darknet_sections(flat):
            parts = ([('params', name, 'bn', 'bias'), ('params', name, 'bn', 'scale'),
                      ('batch_stats', name, 'bn', 'mean'), ('batch_stats', name, 'bn', 'var')]
                     if has_bn else [('params', name, 'conv', 'bias')])
            for key in parts:
                f.write(np.asarray(flat[key], np.float32).tobytes())
            kernel = np.asarray(flat[('params', name, 'conv', 'kernel')], np.float32)
            f.write(np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1))).tobytes())


def decode_head(raw: torch.Tensor, scale_idx: int, input_size: int,
                anchors: np.ndarray = ANCHORS, strides: Sequence[int] = STRIDES,
                xyscale: Sequence[float] = XYSCALE) -> torch.Tensor:
    """One head's raw output [N, gh, gw, 3*(5+C)] -> [N, gh*gw*3, 4+1+C]:
    (cx, cy, w, h) in input pixels, objectness, class probabilities. Always
    float32: bf16 would quantize box centers to pixels."""
    raw = raw.float()
    n, gh, gw, _ = raw.shape
    raw = raw.reshape(n, gh, gw, 3, -1)
    txy = raw[..., 0:2]
    twh = raw[..., 2:4]
    conf = torch.sigmoid(raw[..., 4:5])
    probs = torch.sigmoid(raw[..., 5:])
    grid_y, grid_x = torch.meshgrid(torch.arange(gh, dtype=torch.float32, device=raw.device),
                                    torch.arange(gw, dtype=torch.float32, device=raw.device),
                                    indexing='ij')
    grid = torch.stack([grid_x, grid_y], dim=-1)[None, :, :, None, :]
    s = xyscale[scale_idx]
    xy = (torch.sigmoid(txy) * s - 0.5 * (s - 1) + grid) * strides[scale_idx]
    anchor = torch.as_tensor(anchors[scale_idx], device=raw.device) * (input_size / 416.0)
    wh = torch.exp(torch.clamp(twh, -20.0, 8.0)) * anchor
    out = torch.cat([xy, wh, conf, probs], dim=-1)
    return out.reshape(n, gh * gw * 3, -1)


def box_iou_xywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of center-format boxes: a [..., n, 4], b [..., m, 4] -> [..., n, m]."""
    a = a.unsqueeze(-2)
    b = b.unsqueeze(-3)
    a_min, a_max = a[..., :2] - a[..., 2:4] / 2, a[..., :2] + a[..., 2:4] / 2
    b_min, b_max = b[..., :2] - b[..., 2:4] / 2, b[..., :2] + b[..., 2:4] / 2
    inter = torch.prod(torch.clamp_min(torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min),
                                       0.0), dim=-1)
    area_a = torch.prod(a[..., 2:4], dim=-1)
    area_b = torch.prod(b[..., 2:4], dim=-1)
    return inter / (area_a + area_b - inter + 1e-9)


def box_nms(boxes_xywh: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
            iou_threshold: float, max_output: int) -> torch.Tensor:
    """Greedy IoU NMS over [..., n] fixed-shape candidates; the keep mask."""
    return greedy_nms(box_iou_xywh(boxes_xywh, boxes_xywh), scores, valid,
                      iou_threshold, max_output)


class PersonDetector:
    """Batched person detection (`metrabs_tpu/detect/yolov4.py::PersonDetector`).

    `model` is a detector module (`build_detector_model`) in eval mode on its
    device, in its compute dtype. `detect_batched` returns padded (boxes5
    [B, max_det, 5], valid [B, max_det]) in original image pixels, on the
    model's device."""

    def __init__(self, model: nn.Module, input_size: Optional[int] = None,
                 top_candidates: int = 256):
        """`input_size` None: 640 for YOLOv8 (ultralytics' imgsz), else 416."""
        self.model = model
        self.input_size = input_size or (640 if isinstance(model, YOLOv8) else 416)
        self.top_candidates = top_candidates

    def _person_preds(self, images_resized: torch.Tensor):
        """(center-format boxes [N, A, 4] in resized pixels, person scores
        [N, A]): YOLOv4's objectness times the person class probability, or
        YOLOv8's anchor-free sigmoid person probability."""
        if isinstance(self.model, YOLOv8):
            merged = decode_heads(self.model(images_resized))
            return merged[..., :4], merged[..., 4 + PERSON_CLASS]
        anchors, strides, xyscale = self.model.decode_tables
        preds = torch.cat([decode_head(h, i, self.input_size, anchors, strides, xyscale)
                           for i, h in enumerate(self.model(images_resized))], dim=1)
        return preds[..., :4], preds[..., 4] * preds[..., 5 + PERSON_CLASS]

    def detect_batched(self, images: torch.Tensor, threshold: float = 0.3,
                       nms_iou_threshold: float = 0.7, max_detections: int = 16,
                       flip_aug: bool = False, flip_vertical: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [B, H, W, 3] uint8 on the model's device."""
        n, orig_h, orig_w = images.shape[:3]
        size = self.input_size
        factor = size / max(orig_h, orig_w)
        target_h = int(factor * orig_h)
        target_w = int(factor * orig_w)

        # Gamma-correct resize in the detector's compute dtype.
        lin = (images.to(self.model.dtype) / 255.0) ** 2.2
        lin = resize.resize_linear(lin, (target_h, target_w), antialias=factor < 1)
        resized = lin ** (1 / 2.2)
        pad_h = -target_h % 32
        pad_w = -target_w % 32
        hp, wp = pad_h // 2, pad_w // 2
        resized = F.pad(resized, (0, 0, wp, pad_w - wp, hp, pad_h - hp), value=0.5)

        boxes, scores = self._person_preds(resized)
        if flip_aug:
            fboxes, fscores = self._person_preds(torch.flip(resized, dims=[2]))
            fboxes[..., 0] = resized.shape[2] - fboxes[..., 0]
            boxes = torch.cat([boxes, fboxes], dim=1)
            scores = torch.cat([scores, fscores], dim=1)
            if flip_vertical:
                vboxes, vscores = self._person_preds(torch.flip(resized, dims=[1]))
                vboxes[..., 1] = resized.shape[1] - vboxes[..., 1]
                boxes = torch.cat([boxes, vboxes], dim=1)
                scores = torch.cat([scores, vscores], dim=1)

        # Per image: exact top candidates by score, NMS, top max_detections.
        k = min(self.top_candidates, scores.shape[1])
        top_scores, top_idx = torch.topk(scores, k, dim=1)
        top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
        keep = box_nms(top_boxes, top_scores, top_scores >= threshold, nms_iou_threshold,
                       max_detections)
        masked = torch.where(keep, top_scores, torch.full_like(top_scores, float('-inf')))
        sel_scores, sel = torch.topk(masked, max_detections, dim=1)
        sel_boxes = torch.gather(top_boxes, 1, sel[..., None].expand(-1, -1, 4))
        ok = torch.isfinite(sel_scores)
        # Center format -> top-left (x, y, w, h), unpadded and unscaled per
        # axis (target_h/w are truncated, so the two factors differ).
        x_factor = orig_w / target_w
        y_factor = orig_h / target_h
        x = (sel_boxes[..., 0] - sel_boxes[..., 2] / 2 - wp) * x_factor
        y = (sel_boxes[..., 1] - sel_boxes[..., 3] / 2 - hp) * y_factor
        w = sel_boxes[..., 2] * x_factor
        h = sel_boxes[..., 3] * y_factor
        out = torch.stack([x, y, w, h, torch.where(ok, sel_scores, 0.0)], dim=-1)
        return torch.where(ok[..., None], out, 0.0), ok
