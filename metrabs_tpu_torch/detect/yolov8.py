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
multiples of 32) and the heads come out NHWC, as in JAX. The ultralytics
state-dict importer is not ported.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

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
