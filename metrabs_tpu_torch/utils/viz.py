"""Pose visualisation without OpenCV or matplotlib (`metrabs_tpu/utils/viz.py`).

`draw_poses_2d` draws skeleton overlays through `data.cvfree.line` and
`cvfree.circle`, equal to JAX's cv2 drawing bit for bit.

`plot_poses_3d` draws the scene JAX draws with matplotlib's mplot3d, with the
port's own rasteriser: the same figure size at 110 dpi, the same subplot
layout, mplot3d's perspective projection at its defaults (elev 30, azim -60,
focal length 1, `set_box_aspect((1, 1, 1))`, limits autoscaled with mplot3d's
margins), the same world-up mapping, colours, line width and point size; the
three back panes with their edges, ticks, tick labels and axis labels in a
5x7 bitmap font written below. A joint lands on the pixel where matplotlib's
transform puts it (within a pixel); the strokes, fonts and anti-aliasing are
not matplotlib's. The saved image is cropped to its content plus 0.1 inch, as
`bbox_inches='tight'` crops.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from metrabs_tpu_torch.data import cvfree

_COLORS = [(0, 200, 80), (230, 80, 0), (0, 120, 230), (200, 0, 180),
           (220, 180, 0), (0, 200, 200)]

DPI = 110
# matplotlib's defaults: figure.subplot.{left,right,bottom,top,wspace}.
_SUBPLOT = dict(left=0.125, right=0.9, bottom=0.11, top=0.88, wspace=0.2)
# mplot3d: the view, the camera distance, the 2D view box (`set_top_view`),
# `set_box_aspect`'s scale, the data margins and the view margin.
_ELEV, _AZIM, _DIST = 30.0, -60.0, 10.0
_VIEW_LIM = (-0.95 / _DIST, 0.9 / _DIST)
_BOX_SCALE = 1.8294640721620434 * 25 / 24
_XY_MARGIN, _Z_MARGIN_SCATTER, _VIEW_MARGIN = 0.05, 0.05, 1 / 48
_LINE_PX = 3  # linewidth 2 pt at 110 dpi
_POINT_RADIUS = 2  # scatter s=8 (pt^2): a disc of 4.3 px
_PANE_COLORS = ((248, 248, 248), (242, 242, 242), (245, 245, 245))  # x, y, z, alpha 0.5
_INK = (38, 38, 38)
_PAD_PX = int(round(0.1 * DPI))  # bbox_inches='tight' pads 0.1 inch


def draw_poses_2d(image: np.ndarray, poses2d: np.ndarray,
                  edges: Sequence[Tuple[int, int]],
                  valid: Optional[np.ndarray] = None,
                  thickness: int = 2) -> np.ndarray:
    """Skeleton overlay: [P, J, 2] image-space poses onto an RGB uint8 image
    (a copy): each pose in its colour, edges with a non-finite end skipped,
    white discs of radius thickness + 1 on the finite joints."""
    out = np.ascontiguousarray(image).copy()
    for p, pose in enumerate(np.asarray(poses2d)):
        if valid is not None and not valid[p]:
            continue
        color = _COLORS[p % len(_COLORS)]
        for i, j in edges:
            if np.any(~np.isfinite(pose[[i, j]])):
                continue
            cvfree.line(out, tuple(np.round(pose[i]).astype(int)),
                        tuple(np.round(pose[j]).astype(int)), color, thickness)
        for pt in pose:
            if np.all(np.isfinite(pt)):
                cvfree.circle(out, tuple(np.round(pt).astype(int)), thickness + 1,
                              (255, 255, 255), -1)
    return out


def plot_poses_3d(poses3d: np.ndarray, edges: Sequence[Tuple[int, int]],
                  out_path: Optional[str] = None,
                  valid: Optional[np.ndarray] = None,
                  world_up: Sequence[float] = (0, -1, 0),
                  image: Optional[np.ndarray] = None,
                  poses2d: Optional[np.ndarray] = None):
    """Static 3D scene of [P, J, 3] millimetre poses (or one [J, 3] pose);
    with `image`, a side panel with the image and the `poses2d` overlay.
    With `out_path` the figure is written there (`.jpg`, `.jpeg` or `.png`,
    through `improc.imwrite`) and None is returned. Without it the figure is
    returned as an RGB uint8 array, cropped as it would be saved: the port
    has no figure object to return, where JAX returns matplotlib's."""
    scene = Scene3D(poses3d, edges, valid=valid, world_up=world_up,
                    with_image=image is not None)
    canvas = scene.render(image, poses2d)
    out = crop_to_content(canvas)
    if out_path:
        from metrabs_tpu_torch.data import improc
        improc.imwrite(str(out_path), out)
        return None
    return out


def crop_to_content(canvas: np.ndarray) -> np.ndarray:
    """The canvas cut to its non-white pixels plus 0.1 inch on each side."""
    ink = np.any(canvas != 255, axis=2)
    if not ink.any():
        return canvas
    rows, cols = np.nonzero(ink.any(1))[0], np.nonzero(ink.any(0))[0]
    y0, y1 = max(rows[0] - _PAD_PX, 0), min(rows[-1] + 1 + _PAD_PX, canvas.shape[0])
    x0, x1 = max(cols[0] - _PAD_PX, 0), min(cols[-1] + 1 + _PAD_PX, canvas.shape[1])
    return np.ascontiguousarray(canvas[y0:y1, x0:x1])


def _subplot_box(n_cols: int, col: int) -> Tuple[float, float, float, float]:
    """(x0, y0, width, height) in figure fractions of subplot (1, n_cols,
    col + 1), as matplotlib's GridSpec places it."""
    s = _SUBPLOT
    cell = (s['right'] - s['left']) / (n_cols + s['wspace'] * (n_cols - 1))
    return (s['left'] + col * cell * (1 + s['wspace']), s['bottom'], cell,
            s['top'] - s['bottom'])


def _shrunk_centred(box, box_aspect: float, fig_aspect: float):
    """Bbox.shrunk_to_aspect, then anchored at the centre of the box."""
    x0, y0, w, h = box
    height = w * box_aspect / fig_aspect
    if height <= h:
        width = w
    else:
        width, height = h * fig_aspect / box_aspect, h
    return x0 + (w - width) / 2, y0 + (h - height) / 2, width, height


def _nonsingular(v0: float, v1: float, expander: float = 0.05, tiny: float = 1e-15):
    """matplotlib.transforms.nonsingular."""
    if not (np.isfinite(v0) and np.isfinite(v1)):
        return -expander, expander
    swapped = v1 < v0
    if swapped:
        v0, v1 = v1, v0
    maxabs = max(abs(v0), abs(v1))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        v0, v1 = -expander, expander
    elif v1 - v0 <= maxabs * tiny:
        if v1 == 0 and v0 == 0:
            v0, v1 = -expander, expander
        else:
            v0 -= expander * abs(v0)
            v1 += expander * abs(v1)
    return (v1, v0) if swapped else (v0, v1)


class Scene3D:
    """The figure of `plot_poses_3d`: its layout, the 3D axes' limits and
    projection, and its rasterisation into a white canvas of
    figsize * 110 px."""

    def __init__(self, poses3d, edges, valid=None, world_up=(0, -1, 0), with_image=False):
        poses3d = np.asarray(poses3d, np.float64)
        if poses3d.ndim == 2:
            poses3d = poses3d[None]
        self.edges = [tuple(e) for e in edges]
        up = np.asarray(world_up, np.float32)
        # matplotlib's z is up: world y is negated where world up is -y.
        self.poses = [(p, np.stack([pose[:, 0], pose[:, 2],
                                    -pose[:, 1] if up[1] < 0 else pose[:, 1]], -1))
                      for p, pose in enumerate(poses3d) if valid is None or valid[p]]
        self.width_px, self.height_px = (12 * DPI, 6 * DPI) if with_image else (6 * DPI, 6 * DPI)
        fig_aspect = self.height_px / self.width_px
        n_cols = 2 if with_image else 1
        self.box3d = _shrunk_centred(_subplot_box(n_cols, n_cols - 1), 1.0, fig_aspect)
        self.image_box = _subplot_box(2, 0) if with_image else None
        self.lims = self._limits()
        self.M = self._projection()

    def _limits(self):
        """mplot3d's autoscale: the finite plotted points' range (the
        default box before any data), the margins (x, y 0.05; z 0.05 once a
        scatter is drawn, else 0), then the view margin of 1/48."""
        points = [xyz[np.all(np.isfinite(xyz), 1)] for _, xyz in self.poses]
        points = np.concatenate(points) if points else np.zeros((0, 3))
        if len(points):
            lo, hi = points.min(0), points.max(0)
            margins = (_XY_MARGIN, _XY_MARGIN, _Z_MARGIN_SCATTER)
        else:
            m = 0.05 * 10 / 11
            lo, hi = np.array([m, m, 0.0]), np.array([1 - m, 1 - m, 1.0])
            margins = (_XY_MARGIN, _XY_MARGIN, 0.0)
        lims = []
        for a in range(3):
            v0, v1 = _nonsingular(float(lo[a]), float(hi[a]))
            d = (v1 - v0) * margins[a]
            v0, v1 = v0 - d, v1 + d
            d = (v1 - v0) * _VIEW_MARGIN
            lims.append((v0 - d, v1 + d))
        return lims

    def _projection(self) -> np.ndarray:
        """Axes3D.get_proj at the defaults: world box -> eye -> perspective."""
        aspect = np.ones(3) * _BOX_SCALE / math.sqrt(3)
        world = np.eye(4)
        for a, (v0, v1) in enumerate(self.lims):
            d = (v1 - v0) / aspect[a]
            world[a, a], world[a, 3] = 1 / d, -v0 / d
        centre = 0.5 * aspect
        elev, azim = np.deg2rad(_ELEV), np.deg2rad(_AZIM)
        ps = np.array([np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim), np.sin(elev)])
        eye = centre + _DIST * ps
        w = (eye - centre) / np.linalg.norm(eye - centre)
        u = np.cross([0.0, 0.0, 1.0], w)
        u /= np.linalg.norm(u)
        v = np.cross(w, u)
        rot, shift = np.eye(4), np.eye(4)
        rot[:3, :3] = np.stack([u, v, w])
        shift[:3, 3] = -eye
        zf, zb = -_DIST, _DIST
        persp = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                          [0, 0, (zf + zb) / (zf - zb), -2 * zf * zb / (zf - zb)],
                          [0, 0, -1, 0]], np.float64)
        self.eye_world = eye
        return persp @ rot @ shift @ world

    def project(self, xyz: np.ndarray) -> np.ndarray:
        """[N, 3] plot coordinates (x, depth, up) -> [N, 2] canvas pixels
        (x right, y down, pixel centres at integers + 0.5 of matplotlib's
        display coordinates)."""
        xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
        h = np.concatenate([xyz, np.ones((len(xyz), 1))], 1) @ self.M.T
        ndc = h[:, :2] / h[:, 3:]
        x0, y0, bw, bh = self.box3d
        lo, hi = _VIEW_LIM
        fx = x0 + (ndc[:, 0] - lo) / (hi - lo) * bw
        fy = y0 + (ndc[:, 1] - lo) / (hi - lo) * bh
        return np.stack([fx * self.width_px, (1 - fy) * self.height_px], -1)

    def pose_pixels(self):
        """[(pose index, [J, 2] canvas pixels)] of the plotted poses."""
        return [(p, self.project(xyz)) for p, xyz in self.poses]

    # ----------------------------------------------------------------------
    # Rasterisation

    def render(self, image=None, poses2d=None) -> np.ndarray:
        canvas = np.full((self.height_px, self.width_px, 3), 255, np.uint8)
        if self.image_box is not None and image is not None:
            shown = image if poses2d is None else draw_poses_2d(image, poses2d, self.edges)
            self._draw_image(canvas, shown)
        self._draw_axes(canvas)
        for p, xyz in self.poses:
            color = _COLORS[p % len(_COLORS)]
            px = self.project(xyz)
            for i, j in self.edges:
                if np.all(np.isfinite(xyz[[i, j]])):
                    cvfree.line(canvas, _pt(px[i]), _pt(px[j]), color, _LINE_PX)
            for k in range(len(xyz)):
                if np.all(np.isfinite(xyz[k])):
                    cvfree.circle(canvas, _pt(px[k]), _POINT_RADIUS, color, -1)
        return canvas

    def _draw_image(self, canvas: np.ndarray, rgb: np.ndarray) -> None:
        """imshow in the left subplot: aspect equal, the box shrunk to the
        image's aspect and centred, axis off."""
        h, w = rgb.shape[:2]
        x0, y0, bw, bh = _shrunk_centred(self.image_box, h / w, self.height_px / self.width_px)
        left, right = int(round(x0 * self.width_px)), int(round((x0 + bw) * self.width_px))
        top = int(round((1 - y0 - bh) * self.height_px))
        bottom = int(round((1 - y0) * self.height_px))
        size = (max(right - left, 1), max(bottom - top, 1))
        interp = cvfree.INTER_AREA if size[0] < w else cvfree.INTER_LINEAR
        canvas[top:top + size[1], left:left + size[0]] = cvfree.resize(
            np.ascontiguousarray(rgb), size, interpolation=interp)

    def _corner(self, a: int, b: int, c: int) -> np.ndarray:
        """A corner of the box by limit index (0 low, 1 high) on x, y, z."""
        return np.array([self.lims[0][a], self.lims[1][b], self.lims[2][c]])

    def _draw_axes(self, canvas: np.ndarray) -> None:
        # The back panes: each axis' plane on the side away from the eye
        # (the eye in the normalised box, as mplot3d picks them).
        far = [0 if e > 0.5 * _BOX_SCALE / math.sqrt(3) else 1 for e in self.eye_world]
        for a in range(3):
            corners = []
            for s, t in ((0, 0), (0, 1), (1, 1), (1, 0)):
                idx = [0, 0, 0]
                idx[a] = far[a]
                others = [k for k in range(3) if k != a]
                idx[others[0]], idx[others[1]] = s, t
                corners.append(self.project(self._corner(*idx))[0])
            pts = np.round(np.array(corners)).astype(int)
            cvfree.fill_convex_poly(canvas, pts, _PANE_COLORS[a])
            for k in range(4):
                cvfree.line(canvas, tuple(pts[k]), tuple(pts[(k + 1) % 4]), _INK, 1)
        # Axis lines with ticks: x along the front floor edge, y along the
        # side floor edge, z up the leftmost vertical edge in front.
        front = [1 - f for f in far]
        labels = ('x (mm)', 'depth (mm)', 'up (mm)')
        vertical = min(((a, b) for a in (0, 1) for b in (0, 1) if (a, b) != (far[0], far[1])),
                       key=lambda ab: self.project(self._corner(ab[0], ab[1], 0))[0, 0])
        edges = {0: (None, front[1], far[2]), 1: (front[0], None, far[2]),
                 2: (vertical[0], vertical[1], None)}
        centre = self.project(np.array([np.mean(l) for l in self.lims]))[0]
        for a, fixed in edges.items():
            ends = []
            for end in (0, 1):
                idx = [end if f is None else f for f in fixed]
                ends.append(self._corner(*idx))
            p0, p1 = self.project(np.stack(ends))
            cvfree.line(canvas, _pt(p0), _pt(p1), _INK, 1)
            outward = (p0 + p1) / 2 - centre
            outward /= max(np.linalg.norm(outward), 1e-9)
            v0, v1 = self.lims[a]
            for tick in _ticks(v0, v1):
                t = (tick - ends[0][a]) / (ends[1][a] - ends[0][a])
                q = p0 + t * (p1 - p0)
                cvfree.line(canvas, _pt(q), _pt(q + 5 * outward), _INK, 1)
                draw_text(canvas, _format_tick(tick), q + 22 * outward, _INK)
            draw_text(canvas, labels[a], (p0 + p1) / 2 + 48 * outward, _INK)


def _pt(xy) -> Tuple[int, int]:
    return int(np.floor(xy[0])), int(np.floor(xy[1]))


def _ticks(v0: float, v1: float, target: int = 6):
    """Round tick values inside [v0, v1]: steps of 1, 2, 2.5 or 5 times a
    power of ten, about `target` of them (matplotlib's MaxNLocator steps)."""
    span = v1 - v0
    if not span > 0 or not np.isfinite(span):
        return []
    raw = span / target
    base = 10 ** math.floor(math.log10(raw))
    step = next(m * base for m in (1, 2, 2.5, 5, 10) if m * base >= raw)
    first = math.ceil(v0 / step) * step
    return [first + k * step for k in range(int((v1 - first) / step) + 1)]


def _format_tick(value: float) -> str:
    if abs(value - round(value)) < 1e-9:
        return str(int(round(value)))
    return f'{value:.1f}'


# A 5x7 bitmap font: each glyph is 7 rows of 5 bits, the high bit leftmost.
_GLYPHS = {
    '0': (0x0E, 0x11, 0x13, 0x15, 0x19, 0x11, 0x0E), '1': (0x04, 0x0C, 0x04, 0x04, 0x04, 0x04, 0x0E),
    '2': (0x0E, 0x11, 0x01, 0x02, 0x04, 0x08, 0x1F), '3': (0x1F, 0x02, 0x04, 0x02, 0x01, 0x11, 0x0E),
    '4': (0x02, 0x06, 0x0A, 0x12, 0x1F, 0x02, 0x02), '5': (0x1F, 0x10, 0x1E, 0x01, 0x01, 0x11, 0x0E),
    '6': (0x06, 0x08, 0x10, 0x1E, 0x11, 0x11, 0x0E), '7': (0x1F, 0x01, 0x02, 0x04, 0x08, 0x08, 0x08),
    '8': (0x0E, 0x11, 0x11, 0x0E, 0x11, 0x11, 0x0E), '9': (0x0E, 0x11, 0x11, 0x0F, 0x01, 0x02, 0x0C),
    '-': (0, 0, 0, 0x1F, 0, 0, 0), '.': (0, 0, 0, 0, 0, 0x0C, 0x0C),
    '(': (0x02, 0x04, 0x08, 0x08, 0x08, 0x04, 0x02), ')': (0x08, 0x04, 0x02, 0x02, 0x02, 0x04, 0x08),
    ' ': (0, 0, 0, 0, 0, 0, 0), 'x': (0, 0, 0x11, 0x0A, 0x04, 0x0A, 0x11),
    'm': (0, 0, 0x1A, 0x15, 0x15, 0x11, 0x11), 'd': (0x01, 0x01, 0x0D, 0x13, 0x11, 0x11, 0x0F),
    'e': (0, 0, 0x0E, 0x11, 0x1F, 0x10, 0x0E), 'p': (0, 0, 0x1E, 0x11, 0x1E, 0x10, 0x10),
    't': (0x08, 0x08, 0x1C, 0x08, 0x08, 0x09, 0x06), 'h': (0x10, 0x10, 0x16, 0x19, 0x11, 0x11, 0x11),
    'u': (0, 0, 0x11, 0x11, 0x11, 0x13, 0x0D),
}
_FONT_SCALE = 2  # 10x14 px glyphs: matplotlib's 10 pt text is ~15 px at 110 dpi


def draw_text(canvas: np.ndarray, text: str, centre, color) -> None:
    """`text` in the bitmap font, centred on `centre` (x, y), clipped to the
    canvas; characters without a glyph are drawn as spaces."""
    s = _FONT_SCALE
    advance = 6 * s
    width, height = advance * len(text) - s, 7 * s
    x0 = int(round(centre[0] - width / 2))
    y0 = int(round(centre[1] - height / 2))
    h, w = canvas.shape[:2]
    for k, ch in enumerate(text):
        rows = _GLYPHS.get(ch, _GLYPHS[' '])
        for r, bits in enumerate(rows):
            for c in range(5):
                if bits & (0x10 >> c):
                    y, x = y0 + r * s, x0 + k * advance + c * s
                    ys, xs = slice(max(y, 0), min(y + s, h)), slice(max(x, 0), min(x + s, w))
                    canvas[ys, xs] = color
