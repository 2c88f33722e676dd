"""YOLOv8 person detector, inference only (`metrabs_tpu/detect/yolov8.py`):
anchor-free, C2f blocks, SPPF, a PAN neck and decoupled box/class heads
with distribution-focal-loss box regression, at the ultralytics scales
n/s/m/l/x.

Same network as the JAX module, with its module names (`l0`..`l22`, C2f's
`cv1`/`cv2`/`m<i>`, the head's `cv2_<level>_<j>` and `cv3_<level>_<j>`).
Convolutions are flax 'SAME' (at stride 2 an even side pads (0, 1), not
ultralytics' symmetric 1), BN eps 1e-3 (never folded: JAX wires no fold for
YOLOv8), SPPF's max pools pad with -inf and the neck upsamples by exactly
2x nearest. Internally NCHW; the public input is NHWC in [0, 1] (sides
multiples of 32) and the heads come out NHWC, as in JAX.

`import_yolov8_from_torch` reads a released ultralytics state dict
(yolov8{n,s,m,l,x}.pt's `model.<idx>...` keys) onto the JAX-layout variable
tree, which `io.weights.detector_state_dict_from_flax` puts into the module;
`export_torch_style_state_dict` is its inverse.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from metrabs_tpu_torch.models.backbones.common import Conv2d, FrozenBatchNorm2d, pad_same
from metrabs_tpu_torch.ops import resize

REG_MAX = 16
STRIDES = (8, 16, 32)

# depth multiple, width multiple, max channels (ultralytics yolov8 scales).
SCALES = {
    'n': (1 / 3, 0.25, 1024),
    's': (1 / 3, 0.50, 1024),
    'm': (2 / 3, 0.75, 768),
    'l': (1.0, 1.0, 512),
    'x': (1.0, 1.25, 512),
}


def _make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def _chan(base: int, width: float, max_channels: int) -> int:
    return _make_divisible(min(base, max_channels) * width)


def _depth(n: int, depth: float) -> int:
    return max(round(n * depth), 1)


class ConvBnSilu(nn.Module):
    """Conv (k, s, flax 'SAME', no bias) + BN + SiLU: ultralytics' Conv."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.conv = Conv2d(cin, cout, kernel, stride=stride, bias=False)
        self.bn = FrozenBatchNorm2d(cout, 1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(pad_same(x, self.kernel, self.stride))))


class Bottleneck(nn.Module):
    """Two 3x3 convs with an optional residual."""

    def __init__(self, c: int, shortcut: bool):
        super().__init__()
        self.shortcut = shortcut
        self.cv1 = ConvBnSilu(c, c, 3)
        self.cv2 = ConvBnSilu(c, c, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.cv2(self.cv1(x))
        return x + h if self.shortcut else h


class C2f(nn.Module):
    """Split, chain `n` bottlenecks on one half, concatenate everything and
    fuse with a 1x1."""

    def __init__(self, cin: int, cout: int, n: int, shortcut: bool):
        super().__init__()
        c = cout // 2
        self.n = n
        self.cv1 = ConvBnSilu(cin, 2 * c, 1)
        for i in range(n):
            self.add_module(f'm{i}', Bottleneck(c, shortcut))
        self.cv2 = ConvBnSilu((2 + n) * c, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = list(self.cv1(x).chunk(2, dim=1))
        for i in range(self.n):
            outs.append(getattr(self, f'm{i}')(outs[-1]))
        return self.cv2(torch.cat(outs, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): three chained 5x5 max pools."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cv1 = ConvBnSilu(cin, cin // 2, 1)
        self.cv2 = ConvBnSilu(4 * (cin // 2), cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pad_same(pools[-1], 5, 1, float('-inf')), 5, stride=1))
        return self.cv2(torch.cat(pools, dim=1))


class DetectHead(nn.Module):
    """Per level: cv2 -> 4 * REG_MAX box-bin logits, cv3 -> class logits."""

    def __init__(self, num_classes: int, level_channels: Sequence[int]):
        super().__init__()
        self.n_levels = len(level_channels)
        c2 = max(16, level_channels[0] // 4, REG_MAX * 4)
        c3 = max(level_channels[0], min(num_classes, 100))
        for i, c in enumerate(level_channels):
            for branch, width, n_out in (('cv2', c2, 4 * REG_MAX), ('cv3', c3, num_classes)):
                self.add_module(f'{branch}_{i}_0', ConvBnSilu(c, width, 3))
                self.add_module(f'{branch}_{i}_1', ConvBnSilu(width, width, 3))
                self.add_module(f'{branch}_{i}_2', Conv2d(width, n_out, 1))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        outs = []
        for i, f in enumerate(feats):
            pair = []
            for branch in ('cv2', 'cv3'):
                h = f
                for j in range(3):
                    h = getattr(self, f'{branch}_{i}_{j}')(h)
                pair.append(h.permute(0, 2, 3, 1))
            outs.append(tuple(pair))
        return outs


class YOLOv8(nn.Module):
    """[N, H, W, 3] NHWC in [0, 1] -> per level (stride 8, 16, 32) the pair
    (box-bin logits [N, h, w, 64], class logits [N, h, w, num_classes])."""

    def __init__(self, size: str = 'm', num_classes: int = 80):
        super().__init__()
        d, w, mc = SCALES[size]
        ch = lambda base: _chan(base, w, mc)
        self.size, self.num_classes = size, num_classes
        # Backbone (yolov8.yaml indices).
        self.l0 = ConvBnSilu(3, ch(64), 3, 2)
        self.l1 = ConvBnSilu(ch(64), ch(128), 3, 2)
        self.l2 = C2f(ch(128), ch(128), _depth(3, d), True)
        self.l3 = ConvBnSilu(ch(128), ch(256), 3, 2)
        self.l4 = C2f(ch(256), ch(256), _depth(6, d), True)
        self.l5 = ConvBnSilu(ch(256), ch(512), 3, 2)
        self.l6 = C2f(ch(512), ch(512), _depth(6, d), True)
        self.l7 = ConvBnSilu(ch(512), ch(1024), 3, 2)
        self.l8 = C2f(ch(1024), ch(1024), _depth(3, d), True)
        self.l9 = SPPF(ch(1024), ch(1024))
        # PAN neck.
        self.l12 = C2f(ch(1024) + ch(512), ch(512), _depth(3, d), False)
        self.l15 = C2f(ch(512) + ch(256), ch(256), _depth(3, d), False)
        self.l16 = ConvBnSilu(ch(256), ch(256), 3, 2)
        self.l18 = C2f(ch(256) + ch(512), ch(512), _depth(3, d), False)
        self.l19 = ConvBnSilu(ch(512), ch(512), 3, 2)
        self.l21 = C2f(ch(512) + ch(1024), ch(1024), _depth(3, d), False)
        self.l22 = DetectHead(num_classes, (ch(256), ch(512), ch(1024)))

    @property
    def dtype(self) -> torch.dtype:
        return self.l0.conv.weight.dtype

    def forward(self, x: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        x = self.l1(self.l0(x.to(self.dtype).permute(0, 3, 1, 2)))
        p3 = self.l4(self.l3(self.l2(x)))
        p4 = self.l6(self.l5(p3))
        p5 = self.l9(self.l8(self.l7(p4)))
        up = resize.upsample_nearest_2x
        n4 = self.l12(torch.cat([up(p5), p4], dim=1))
        out3 = self.l15(torch.cat([up(n4), p3], dim=1))
        n4b = self.l18(torch.cat([self.l16(out3), n4], dim=1))
        out5 = self.l21(torch.cat([self.l19(n4b), p5], dim=1))
        return self.l22([out3, n4b, out5])


def decode_heads(level_outputs) -> torch.Tensor:
    """Per-level (box_bins, cls_logits) -> [N, anchors, 4 + nc] in float32:
    center-format boxes in input pixels and sigmoid class probabilities.
    DFL: softmax over the REG_MAX bins of each side, whose expectation is the
    left/top/right/bottom distance from the cell center in cells, scaled by
    the level's stride."""
    outs = []
    for (box_bins, cls_logits), stride in zip(level_outputs, STRIDES):
        n, gh, gw, _ = box_bins.shape
        dev = box_bins.device
        bins = box_bins.float().reshape(n, gh, gw, 4, REG_MAX)
        dist = torch.sum(torch.softmax(bins, dim=-1)
                         * torch.arange(REG_MAX, dtype=torch.float32, device=dev), dim=-1)
        cx = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5)[None, None, :]
        cy = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
        x1, y1 = cx - dist[..., 0], cy - dist[..., 1]
        x2, y2 = cx + dist[..., 2], cy + dist[..., 3]
        boxes = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1) * stride
        probs = torch.sigmoid(cls_logits.float())
        outs.append(torch.cat([boxes, probs], dim=-1).reshape(n, gh * gw, -1))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Ultralytics state_dict import, onto the JAX-layout variable tree

_CONV_IDXS = (0, 1, 3, 5, 7, 16, 19)
_C2F_IDXS = (2, 4, 6, 8, 12, 15, 18, 21)


def import_yolov8_from_torch(state_dict: Dict[str, Any], flax_variables: Dict) -> Dict:
    """Fills a YOLOv8 variable tree (JAX layout, numpy leaves, e.g. `io.
    weights.flax_variables_from_state_dict` of a `YOLOv8`'s state dict) from
    an ultralytics DetectionModel state_dict (keys `model.<idx>.<sub>.conv.
    weight` etc.; `metrabs_tpu/detect/yolov8.py::import_yolov8_from_torch`).
    Returns the updated tree. Unknown torch keys raise; missing expected keys
    raise; a shape that differs from the tree's raises (the wrong size
    variant): the import is all-or-nothing.

    Layout: Conv block `conv.weight` [O,I,H,W] -> HWIO, `bn.{weight,bias,
    running_mean,running_var}` -> BN scale/bias/mean/var; C2f `cv1`, `cv2`,
    bottlenecks `m.<i>.cv1/cv2`; Detect (idx 22) `cv2.<lvl>.<0|1>` Conv blocks
    + `cv2.<lvl>.2` plain Conv2d (weight+bias), same for cv3;
    `dfl.conv.weight` is the constant arange(REG_MAX) expectation kernel,
    which `decode_heads` computes directly, so it is skipped."""
    from metrabs_tpu_torch.io.weights import flatten_dict, unflatten_dict

    variables = unflatten_dict({k: np.asarray(v) for k, v in
                                flatten_dict(flax_variables).items()})
    params = variables['params']
    stats = variables['batch_stats']
    consumed = set()

    def get(key):
        if key not in state_dict:
            raise KeyError(f'ultralytics state_dict missing {key!r}')
        consumed.add(key)
        value = state_dict[key]
        return (value.detach().cpu().numpy() if isinstance(value, torch.Tensor)
                else np.asarray(value))

    def assign(node, leaf_key, value, src_key):
        old = node[leaf_key]
        if tuple(old.shape) != tuple(value.shape):
            raise ValueError(
                f'shape mismatch importing {src_key!r}: checkpoint {value.shape} vs model '
                f'{old.shape} — wrong size variant?')
        node[leaf_key] = value

    def put_convbn(p, s, prefix):
        assign(p['conv'], 'kernel', np.transpose(get(f'{prefix}.conv.weight'), (2, 3, 1, 0)),
               f'{prefix}.conv.weight')
        for node, leaf, src in ((p['bn'], 'scale', 'weight'), (p['bn'], 'bias', 'bias'),
                                (s['bn'], 'mean', 'running_mean'),
                                (s['bn'], 'var', 'running_var')):
            assign(node, leaf, get(f'{prefix}.bn.{src}'), f'{prefix}.bn.{src}')

    def put_c2f(p, s, prefix):
        put_convbn(p['cv1'], s['cv1'], f'{prefix}.cv1')
        put_convbn(p['cv2'], s['cv2'], f'{prefix}.cv2')
        i = 0
        while f'm{i}' in p:
            for cv in ('cv1', 'cv2'):
                put_convbn(p[f'm{i}'][cv], s[f'm{i}'][cv], f'{prefix}.m.{i}.{cv}')
            i += 1

    for i in _CONV_IDXS:
        put_convbn(params[f'l{i}'], stats[f'l{i}'], f'model.{i}')
    for i in _C2F_IDXS:
        put_c2f(params[f'l{i}'], stats[f'l{i}'], f'model.{i}')
    for cv in ('cv1', 'cv2'):
        put_convbn(params['l9'][cv], stats['l9'][cv], f'model.9.{cv}')
    det_p, det_s = params['l22'], stats['l22']
    for branch in ('cv2', 'cv3'):
        for lvl in range(3):
            for j in (0, 1):
                put_convbn(det_p[f'{branch}_{lvl}_{j}'], det_s[f'{branch}_{lvl}_{j}'],
                           f'model.22.{branch}.{lvl}.{j}')
            final = det_p[f'{branch}_{lvl}_2']
            src = f'model.22.{branch}.{lvl}.2'
            assign(final, 'kernel', np.transpose(get(f'{src}.weight'), (2, 3, 1, 0)),
                   f'{src}.weight')
            assign(final, 'bias', get(f'{src}.bias'), f'{src}.bias')

    consumed.add('model.22.dfl.conv.weight')  # a constant, not a parameter
    leftovers = {k for k in state_dict if k not in consumed and 'num_batches_tracked' not in k}
    if leftovers:
        raise KeyError(f'{len(leftovers)} unconsumed ultralytics keys, e.g. '
                       f'{sorted(leftovers)[:4]} — architecture/size mismatch?')
    return variables


def export_torch_style_state_dict(variables: Dict) -> Dict[str, np.ndarray]:
    """Inverse of `import_yolov8_from_torch`: an ultralytics-layout
    state_dict (numpy arrays) from a YOLOv8 variable tree."""
    out: Dict[str, np.ndarray] = {}
    params = variables['params']
    stats = variables['batch_stats']

    def dump_convbn(p, s, prefix):
        out[f'{prefix}.conv.weight'] = np.transpose(np.asarray(p['conv']['kernel']),
                                                    (3, 2, 0, 1))
        out[f'{prefix}.bn.weight'] = np.asarray(p['bn']['scale'])
        out[f'{prefix}.bn.bias'] = np.asarray(p['bn']['bias'])
        out[f'{prefix}.bn.running_mean'] = np.asarray(s['bn']['mean'])
        out[f'{prefix}.bn.running_var'] = np.asarray(s['bn']['var'])

    def dump_c2f(p, s, prefix):
        dump_convbn(p['cv1'], s['cv1'], f'{prefix}.cv1')
        dump_convbn(p['cv2'], s['cv2'], f'{prefix}.cv2')
        i = 0
        while f'm{i}' in p:
            for cv in ('cv1', 'cv2'):
                dump_convbn(p[f'm{i}'][cv], s[f'm{i}'][cv], f'{prefix}.m.{i}.{cv}')
            i += 1

    for i in _CONV_IDXS:
        dump_convbn(params[f'l{i}'], stats[f'l{i}'], f'model.{i}')
    for i in _C2F_IDXS:
        dump_c2f(params[f'l{i}'], stats[f'l{i}'], f'model.{i}')
    for cv in ('cv1', 'cv2'):
        dump_convbn(params['l9'][cv], stats['l9'][cv], f'model.9.{cv}')
    for branch in ('cv2', 'cv3'):
        for lvl in range(3):
            for j in (0, 1):
                dump_convbn(params['l22'][f'{branch}_{lvl}_{j}'],
                            stats['l22'][f'{branch}_{lvl}_{j}'], f'model.22.{branch}.{lvl}.{j}')
            p2 = params['l22'][f'{branch}_{lvl}_2']
            out[f'model.22.{branch}.{lvl}.2.weight'] = np.transpose(np.asarray(p2['kernel']),
                                                                   (3, 2, 0, 1))
            out[f'model.22.{branch}.{lvl}.2.bias'] = np.asarray(p2['bias'])
    out['model.22.dfl.conv.weight'] = np.arange(REG_MAX, dtype=np.float32).reshape(
        1, REG_MAX, 1, 1)
    return out
