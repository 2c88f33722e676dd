"""The OpenCV calls of the data layer without OpenCV, in numpy.

Each function names the `cv2` call it stands for and gives what OpenCV 5.0
gives, bit for bit where the tests say so (`tests/test_torch_data.py` holds
every function against cv2): the card's machine has no cv2 and nothing else
there decodes or warps images. Only the arguments the port's callers use are
supported; anything else raises.

Integer constants keep cv2's values, so that a `LoadConfig.interpolation`
means the same in both packages.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib
from typing import Sequence, Tuple

import numpy as np

INTER_NEAREST = 0
INTER_LINEAR = 1
INTER_CUBIC = 2
INTER_AREA = 3
BORDER_CONSTANT = 0
MORPH_ELLIPSE = 2

_F32 = np.float32


def _fma(a, b, c):
    """float32 a * b + c rounded once, as a fused multiply-add does (the
    float64 product of two float32 values is exact)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _saturate(values: np.ndarray, dtype) -> np.ndarray:
    """cv2's `saturate_cast` from float32: round half to even, then clip."""
    if dtype == np.uint8:
        return np.clip(np.rint(values), 0, 255).astype(np.uint8)
    return values.astype(dtype)


def _check_image(image: np.ndarray) -> np.ndarray:
    image = np.asarray(image)
    if image.dtype not in (np.uint8, np.float32):
        raise NotImplementedError(f'only uint8 and float32 images are supported, got {image.dtype}')
    if image.ndim not in (2, 3):
        raise ValueError(f'an image is [H, W] or [H, W, C], got shape {image.shape}')
    return image


# --- cv2.remap -------------------------------------------------------------

def remap(image: np.ndarray, map_x: np.ndarray, map_y: np.ndarray, interpolation: int,
          border_value: float = 0) -> np.ndarray:
    """`cv2.remap(image, map_x, map_y, interpolation,
    borderMode=cv2.BORDER_CONSTANT, borderValue=border_value)` with float32
    maps: output pixel (i, j) samples `image` at (map_x[i, j], map_y[i, j]).

    INTER_NEAREST takes the coordinate rounded half to even. INTER_LINEAR
    blends the 4 taps in float32 as OpenCV's SIMD code does, with fused
    multiply-adds (along x on both rows, then along y; a uint8 result is
    rounded half to even). Taps outside the image read `border_value`."""
    image = _check_image(image)
    if interpolation not in (INTER_NEAREST, INTER_LINEAR):
        raise NotImplementedError(f'remap interpolation {interpolation}')
    map_x = np.asarray(map_x, _F32)
    map_y = np.asarray(map_y, _F32)
    h, w = image.shape[:2]
    squeeze = image.ndim == 2
    src = image[..., None] if squeeze else image
    # A one-pixel frame of the border value: every tap outside the image
    # clips onto it.
    framed = np.full((h + 2, w + 2, src.shape[2]), border_value, src.dtype)
    framed[1:-1, 1:-1] = src
    flat = framed.reshape(-1, src.shape[2])

    def tap(y, x):
        return np.take(flat, np.clip(y + 1, 0, h + 1) * (w + 2) + np.clip(x + 1, 0, w + 1),
                       axis=0)

    if interpolation == INTER_NEAREST:
        out = tap(_to_index(np.rint(map_y)), _to_index(np.rint(map_x)))
    else:
        x0f, y0f = np.floor(map_x), np.floor(map_y)
        fx = (map_x - x0f)[..., None].astype(np.float64)
        fy = (map_y - y0f)[..., None].astype(np.float64)
        x0, y0 = _to_index(x0f), _to_index(y0f)

        def lerp(a, b, t):
            """float32 a + t * (b - a) with one rounding after the multiply-add
            (b - a rounded to float32 first)."""
            d = (b - a).astype(np.float64)
            d *= t
            d += a
            return d.astype(_F32)

        top = lerp(tap(y0, x0).astype(_F32), tap(y0, x0 + 1).astype(_F32), fx)
        bottom = lerp(tap(y0 + 1, x0).astype(_F32), tap(y0 + 1, x0 + 1).astype(_F32), fx)
        out = _saturate(lerp(top, bottom, fy), image.dtype)
    return out[..., 0] if squeeze else out


def _to_index(values: np.ndarray) -> np.ndarray:
    """Integer pixel indices of float coordinates; far-off and non-finite
    ones land outside any image."""
    values = np.clip(values, -2.0 ** 30, 2.0 ** 30)
    values[np.isnan(values)] = -2.0 ** 30
    return values.astype(np.int64)


# --- cv2.resize ------------------------------------------------------------

_COEF_BITS = 11  # INTER_RESIZE_COEF_BITS: uint8 resizes weigh taps in 1/2048
_COEF_SCALE = 1 << _COEF_BITS


def resize(image: np.ndarray, size: Tuple[int, int], interpolation: int = INTER_LINEAR
           ) -> np.ndarray:
    """`cv2.resize(image, size, interpolation=interpolation)`, `size` =
    (width, height): INTER_LINEAR or INTER_AREA on uint8 or float32 images
    of 1 or 3 channels, INTER_CUBIC on float32 ones (the synthetic
    background's upsampling). A resize to the same size is a copy;
    INTER_LINEAR at exactly half the size in both axes is INTER_AREA's, as
    in OpenCV; INTER_AREA enlarging an axis is OpenCV's linear resize with
    INTER_AREA's tap weights."""
    image = _check_image(image)
    out_w, out_h = int(size[0]), int(size[1])
    h, w = image.shape[:2]
    if out_w <= 0 or out_h <= 0:
        raise ValueError(f'resize to {size}')
    if (out_w, out_h) == (w, h):
        return image.copy()
    if interpolation not in (INTER_LINEAR, INTER_CUBIC, INTER_AREA):
        raise NotImplementedError(f'resize interpolation {interpolation}')
    squeeze = image.ndim == 2
    src = image[..., None] if squeeze else image
    scale_x, scale_y = 1.0 / (out_w / w), 1.0 / (out_h / h)
    int_x, int_y = round(scale_x), round(scale_y)
    area_fast = abs(scale_x - int_x) < 2.2e-16 and abs(scale_y - int_y) < 2.2e-16
    if interpolation == INTER_LINEAR and area_fast and int_x == int_y == 2:
        interpolation = INTER_AREA
    if interpolation == INTER_AREA and scale_x >= 1 and scale_y >= 1:
        out = (_resize_area_fast(src, int_x, int_y, out_w, out_h) if area_fast
               else _resize_area(src, scale_x, scale_y, out_w, out_h))
    else:
        out = _resize_separable(src, scale_x, scale_y, out_w, out_h, interpolation)
    return out[..., 0] if squeeze else out


def _cubic_coeffs(f: np.ndarray) -> np.ndarray:
    """OpenCV's `interpolateCubic` (A = -0.75), [n, 4], in f's precision."""
    a = -0.75
    x, y = f + 1, 1 - f
    c0 = ((a * x - 5 * a) * x + 8 * a) * x - 4 * a
    c1 = ((a + 2) * f - (a + 3)) * f * f + 1
    c2 = ((a + 2) * y - (a + 3)) * y * y + 1
    return np.stack([c0, c1, c2, 1 - c0 - c1 - c2], axis=-1)


def _axis_taps(n_src: int, n_dst: int, scale: float, interpolation: int, horizontal: bool,
               fixed_point: bool):
    """(first tap index [n_dst], float32 tap weights [n_dst, k]) of one axis
    as OpenCV's resize sets them up: the source coordinate in float32 for
    the fixed-point (uint8) resize, in float64 for float32 images; on the
    horizontal axis a linear tap left of the first or right of the last
    pixel takes that pixel whole."""
    k = 4 if interpolation == INTER_CUBIC else 2
    if interpolation == INTER_AREA:
        # OpenCV's area mode of its linear resize (an axis enlarged).
        d = np.arange(n_dst)
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * (n_dst / n_src)).astype(_F32)
        f = np.where(f <= 0, _F32(0), f - np.floor(f)).astype(_F32)
    else:
        f = (np.arange(n_dst) + 0.5) * scale - 0.5
        if fixed_point:
            f = f.astype(_F32)
        s = np.floor(f).astype(np.int64)
        f = (f - s).astype(f.dtype)
    if interpolation in (INTER_LINEAR, INTER_AREA):
        f = f.astype(_F32)
        if horizontal:
            low, high = s < 0, s >= n_src - 1
            f = np.where(low | high, _F32(0), f)
            s = np.where(low, 0, np.where(high, n_src - 1, s))
        weights = np.stack([_F32(1) - f, f], axis=-1)
    else:
        weights = _cubic_coeffs(f)
    return s - (k // 2 - 1), weights.astype(_F32)


def _resize_separable(src: np.ndarray, scale_x: float, scale_y: float, out_w: int, out_h: int,
                      interpolation: int) -> np.ndarray:
    """INTER_LINEAR and INTER_CUBIC: a horizontal pass over the source rows,
    then a vertical one; taps past an edge read the edge pixel. uint8 runs
    in OpenCV's fixed point (weights rounded to 1/2048, integer sums, the
    vertical pass as its SIMD code rounds; INTER_LINEAR only), equal to
    OpenCV; float32 in float32, within an ulp of it (its summation order is
    not reproduced)."""
    h, w, _ = src.shape
    fixed_point = src.dtype == np.uint8
    if fixed_point and interpolation == INTER_CUBIC:
        raise NotImplementedError('INTER_CUBIC on uint8 images')
    x0, wx = _axis_taps(w, out_w, scale_x, interpolation, True, fixed_point)
    y0, wy = _axis_taps(h, out_h, scale_y, interpolation, False, fixed_point)
    k = wx.shape[1]
    xs = np.clip(x0[:, None] + np.arange(k), 0, w - 1)
    ys = np.clip(y0[:, None] + np.arange(k), 0, h - 1)
    if fixed_point:
        iwx = np.rint(wx * _F32(_COEF_SCALE)).astype(np.int64)
        iwy = np.rint(wy * _F32(_COEF_SCALE)).astype(np.int64)
        if interpolation in (INTER_LINEAR, INTER_AREA):
            edge = (x0 + (k // 2 - 1) < 0) | (x0 + (k // 2 - 1) >= w - 1)
            iwx[edge] = [_COEF_SCALE, 0]
        rows = src.astype(np.int64)
        horiz = sum(rows[:, xs[:, j]] * iwx[:, j, None] for j in range(k))  # [h, out_w, c]
        taps = [horiz[ys[:, j]] for j in range(k)]
        # ((s >> 4) * b >> 16) per row, then a rounding shift by 2.
        acc = sum(((t >> 4) * iwy[:, j, None, None]) >> 16 for j, t in enumerate(taps))
        return np.clip((acc + 2) >> 2, 0, 255).astype(np.uint8)
    rows = src.astype(_F32)
    horiz = rows[:, xs[:, 0]] * wx[:, 0, None]
    for j in range(1, k):
        horiz = horiz + rows[:, xs[:, j]] * wx[:, j, None]
    out = horiz[ys[:, 0]] * wy[:, 0, None, None]
    for j in range(1, k):
        out = out + horiz[ys[:, j]] * wy[:, j, None, None]
    return out.astype(_F32)


def _resize_area_fast(src: np.ndarray, sx: int, sy: int, out_w: int, out_h: int) -> np.ndarray:
    """INTER_AREA by whole factors: the mean of each sx x sy block, summed
    in OpenCV's order (rows of the block, then columns, four at a time).
    uint8 at factor 2 rounds half up ((sum + 2) >> 2), at other factors the
    float32 mean is rounded half to even."""
    c = src.shape[2]
    blocks = [src[i:out_h * sy:sy, j:out_w * sx:sx] for i in range(sy) for j in range(sx)]
    if src.dtype == np.uint8:
        total = sum(b.astype(np.int64) for b in blocks)
        if sx == sy == 2:
            return ((total + 2) >> 2).astype(np.uint8)
        return _saturate(total.astype(_F32) * _F32(1.0 / (sx * sy)), np.uint8)
    total = np.zeros(blocks[0].shape, _F32)
    for start in range(0, len(blocks) - len(blocks) % 4, 4):
        a, b, cc, d = blocks[start:start + 4]
        total = total + (((a + b) + cc) + d)
    for b in blocks[len(blocks) - len(blocks) % 4:]:
        total = total + b
    out = (total * _F32(1.0 / (sx * sy))).astype(_F32)
    if sx == sy == 2 and c in (1, 4):
        # OpenCV's 4-lane vector loop sums the 2 x 2 block in pairs; on one
        # channel the last out_w % 4 columns are left to the scalar code.
        a, b, cc, d = blocks
        paired = ((a + b) + (cc + d)) * _F32(0.25)
        vector_cols = out_w if c == 4 else out_w - out_w % 4
        out[:, :vector_cols] = paired[:, :vector_cols]
    return out


def _area_tab(n_src: int, n_dst: int, scale: float):
    """OpenCV's `computeResizeAreaTab`: (destination index, source index,
    float32 weight) triples of one axis, in its order."""
    tab = []
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            tab.append((d, s1 - 1, _F32((s1 - f1) / cell)))
        for s in range(s1, s2):
            tab.append((d, s, _F32(1.0 / cell)))
        if f2 - s2 > 1e-3:
            tab.append((d, s2, _F32(min(min(f2 - s2, 1.0), cell) / cell)))
    return tab


def _resize_area(src: np.ndarray, scale_x: float, scale_y: float, out_w: int, out_h: int
                 ) -> np.ndarray:
    """INTER_AREA by fractional factors: each source pixel weighted by the
    share of it a destination cell covers, accumulated in float32 in
    OpenCV's order (a row's cells left to right, then the rows of a cell top
    to bottom), rounded half to even for uint8."""
    h, w, c = src.shape
    rows = src.astype(_F32)
    horiz = np.zeros((h, out_w, c), _F32)
    for d, s, alpha in _area_tab(w, out_w, scale_x):
        horiz[:, d] = horiz[:, d] + rows[:, s] * alpha
    out = np.zeros((out_h, out_w, c), _F32)
    started = np.zeros(out_h, bool)
    for d, s, beta in _area_tab(h, out_h, scale_y):
        term = beta * horiz[s]
        out[d] = out[d] + term if started[d] else term
        started[d] = True
    return _saturate(out, src.dtype)


# --- cv2.cvtColor ----------------------------------------------------------

_FLT_EPSILON = _F32(1.1920929e-07)


def rgb_to_hsv(image: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(image, cv2.COLOR_RGB2HSV)` on a float32 [H, W, 3] RGB
    image in [0, 1]: hue in degrees [0, 360), saturation and value in [0, 1].
    The hue is x * (60 / chroma) + offset as one fused multiply-add, with 360
    in the offset where the red sector's hue is negative; in the scalar tail
    of OpenCV's 8-pixel vector loop (the last W % 8 pixels of each row) the
    red sector's product is rounded before 360 is added."""
    image = np.asarray(image)
    if image.dtype != np.float32 or image.ndim != 3 or image.shape[-1] != 3:
        raise NotImplementedError('RGB to HSV of float32 [H, W, 3] images')
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    s = diff / (np.abs(v) + _FLT_EPSILON)
    diff = (_F32(60) / (diff + _FLT_EPSILON)).astype(_F32)
    x = np.where(v == r, g - b, np.where(v == g, b - r, r - g))
    offset = np.where(v == r, _F32(0), np.where(v == g, _F32(120), _F32(240)))
    product = x * diff
    fused = _fma(x, diff, np.where((v == r) & (product < 0), _F32(360), offset))
    tail = np.arange(image.shape[1]) >= image.shape[1] - image.shape[1] % 8
    red_tail = tail & (v == r)
    h = np.where(red_tail, np.where(product < 0, product + _F32(360), product), fused)
    return np.stack([h, s, v], axis=-1).astype(_F32)


def hsv_to_rgb(image: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(image, cv2.COLOR_HSV2RGB)` on float32 HSV (hue in
    degrees), with OpenCV's fused 1 - s * h."""
    image = np.asarray(image)
    if image.dtype != np.float32 or image.shape[-1] != 3:
        raise NotImplementedError('HSV to RGB of float32 [..., 3] images')
    h, s, v = image[..., 0], image[..., 1], image[..., 2]
    h = np.fmod(h * _F32(6.0 / 360.0), _F32(6))
    h = np.where(h < 0, h + _F32(6), h)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(_F32)
    wrap = (sector < 0) | (sector >= 6)
    sector = np.where(wrap, 0, sector)
    h = np.where(wrap, _F32(0), h)
    one = _F32(1)
    tab = np.stack([v, v * (one - s), v * _fma(-s, h, one), v * _fma(-s, one - h, one)], axis=-1)
    # (r, g, b) columns of tab per sector
    order = np.array([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0], [3, 1, 0], [0, 1, 2]])
    rgb = np.take_along_axis(tab, order[sector], axis=-1)
    gray = (s == 0)[..., None]
    return np.where(gray, v[..., None], rgb).astype(_F32)


# OpenCV's bit-exact 8-bit Lab (D65, sRGB): integer arithmetic over tables.
_SRGB_TO_XYZ = np.array([[0.412453, 0.357580, 0.180423],
                         [0.212671, 0.715160, 0.072169],
                         [0.019334, 0.119193, 0.950227]])
_XYZ_TO_SRGB = np.array([[3.240479, -1.53715, -0.498535],
                         [-0.969256, 1.875991, 0.041556],
                         [0.055648, -0.204043, 1.057311]])
_D65 = np.array([0.950456, 1.0, 1.088754])
_LAB_BASE = 1 << 14
_MIN_AB = -8145


def _descale(v, n: int):
    return (v + (1 << (n - 1))) >> n


class _LabTables:
    """OpenCV's `initLabTabs` for 8 bits: the sRGB gamma table (8x oversampled
    linear values), the cube-root table (float32 like its softfloat code),
    the fixed-point matrices, the L to (y, f(y)) table, the f to x/z table
    and the inverse gamma table."""

    def __init__(self):
        x = np.arange(256) / 255
        self.gamma = np.rint(255 * 8 * np.where(
            x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)).astype(np.int64)
        x = (np.arange(256 * 3 // 2 * 8, dtype=_F32) * (_F32(1) / _F32(255 * 8))).astype(_F32)
        f = np.where(x < _F32(216) / _F32(24389),
                     (x * (_F32(841) / _F32(108)) + _F32(16) / _F32(116)).astype(_F32),
                     np.cbrt(x).astype(_F32))
        self.cbrt = np.rint((_F32(1 << 15) * f).astype(_F32)).astype(np.int64)
        self.to_xyz = np.rint((1 << 12) * _SRGB_TO_XYZ / _D65[:, None]).astype(np.int64)
        self.to_rgb = np.rint((1 << 12) * _XYZ_TO_SRGB * _D65[None, :]).astype(np.int64)
        yf = []
        for i in range(256):
            if i <= 20:
                yf.append((round(i * _LAB_BASE * 20 * 9 / (17 * 29 * 29 * 29)),
                           round(_LAB_BASE * (16 / 116 + i * 5 / (3 * 17 * 29)))))
            else:
                fy = i * 100 * _LAB_BASE / (255 * 116) + 16 * _LAB_BASE / 116
                yf.append((round(fy * fy * fy / (_LAB_BASE * _LAB_BASE)), round(fy)))
        self.l_to_yf = np.array(yf, np.int64)
        i = np.arange(_MIN_AB, _LAB_BASE * 9 // 4 + _MIN_AB, dtype=np.int64)
        linear = np.trunc(i * 108 / 841).astype(np.int64) - _LAB_BASE * 16 // 116 * 108 // 841
        self.f_to_xz = np.where(i <= 3390, linear, (i * i // _LAB_BASE) * i // _LAB_BASE)
        x = np.arange(4096) / 4096
        self.inv_gamma = np.rint(255 * np.where(
            x <= 0.0031308, x * 12.92, 1.055 * x ** (1 / 2.4) - 0.055)).astype(np.int64)


@functools.lru_cache(maxsize=1)
def _lab() -> _LabTables:
    return _LabTables()


def rgb_to_lab(image: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(image, cv2.COLOR_RGB2LAB)` on uint8 RGB: L scaled by
    255/100, a and b offset by 128 (equal to cv2 on all 2^24 colours)."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.shape[-1] != 3:
        raise NotImplementedError('RGB to Lab of uint8 [..., 3] images')
    t = _lab()
    linear = t.gamma[image]
    fx, fy, fz = (t.cbrt[_descale(linear @ t.to_xyz[i], 12)] for i in range(3))
    lum = _descale(((116 * 255 + 50) // 100) * fy - (16 * 255 * (1 << 15) + 50) // 100, 15)
    a = _descale(500 * (fx - fy) + (128 << 15), 15)
    b = _descale(200 * (fy - fz) + (128 << 15), 15)
    return np.clip(np.stack([lum, a, b], axis=-1), 0, 255).astype(np.uint8)


def lab_to_rgb(image: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(image, cv2.COLOR_LAB2RGB)` on uint8 Lab (equal to cv2 on
    all 2^24 values)."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.shape[-1] != 3:
        raise NotImplementedError('Lab to RGB of uint8 [..., 3] images')
    t = _lab()
    lab = image.astype(np.int64)
    y, fy = t.l_to_yf[lab[..., 0], 0], t.l_to_yf[lab[..., 0], 1]
    a_div = ((5 * lab[..., 1] * 53687 + (1 << 7)) >> 13) - 128 * _LAB_BASE // 500
    b_div = ((lab[..., 2] * 41943 + (1 << 4)) >> 9) - 128 * _LAB_BASE // 200 + 1
    x = t.f_to_xz[fy + a_div - _MIN_AB]
    z = t.f_to_xz[fy - b_div - _MIN_AB]
    rgb = _descale(np.stack([x, y, z], axis=-1) @ t.to_rgb.T, 14)
    return t.inv_gamma[np.clip(rgb, 0, 4095)].astype(np.uint8)


# --- drawing: cv2.line, cv2.fillConvexPoly, cv2.fillPoly, cv2.convexHull ----
# Ports of OpenCV's drawing.cpp for 8-connected lines (the default line type):
# integer and 16.16 fixed-point arithmetic, C's truncating division.

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _put(img: np.ndarray, pixels, color) -> None:
    h, w = img.shape[:2]
    for x, y in pixels:
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def _clip_line(width: int, height: int, x1, y1, x2, y2):
    """OpenCV's `clipLine`: the segment clipped to [0, width) x [0,
    height), or None where it misses."""
    if width <= 0 or height <= 0:
        return None
    right, bottom = width - 1, height - 1
    code = lambda x, y: (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (x1, y1, x2, y2) if (c1 | c2) == 0 else None


def _line_pixels(width: int, height: int, p1, p2):
    """The pixels of OpenCV's 8-connected `LineIterator` from p1 to p2 (left
    to right), clipped to the image."""
    x1, y1 = p1
    x2, y2 = p2
    if not (0 <= x1 < width and 0 <= x2 < width and 0 <= y1 < height and 0 <= y2 < height):
        clipped = _clip_line(width, height, x1, y1, x2, y2)
        if clipped is None:
            return []
        x1, y1, x2, y2 = clipped
    step_x = step_y = 1
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    if dy < 0:
        dy, step_y = -dy, -1
    vertical = dy > dx
    if vertical:
        dx, dy = dy, dx
    err = dx - 2 * dy
    pixels = []
    x, y = x1, y1
    for _ in range(dx + 1):
        pixels.append((x, y))
        diagonal = err < 0
        err += -2 * dy + (2 * dx if diagonal else 0)
        if vertical:
            y += step_y
            x += step_x if diagonal else 0
        else:
            x += step_x
            y += step_y if diagonal else 0
    return pixels


def _line_fixed(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's `Line2`: an 8-connected line between 16.16 fixed-point
    points."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, *p1, *p2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _XY_ONE, _cdiv(dy << _XY_SHIFT, ax | 1)
        count = (x2 - x1) >> _XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _cdiv(dx << _XY_SHIFT, ay | 1), _XY_ONE
        count = (y2 - y1) >> _XY_SHIFT
    x1 += _XY_ONE >> 1
    y1 += _XY_ONE >> 1
    half = _XY_ONE >> 1
    pixels = [((x2 + half) >> _XY_SHIFT, (y2 + half) >> _XY_SHIFT)]
    if ax > ay:
        x1 >>= _XY_SHIFT
        for _ in range(count + 1):
            pixels.append((x1, y1 >> _XY_SHIFT))
            x1 += 1
            y1 += y_step
    else:
        y1 >>= _XY_SHIFT
        for _ in range(count + 1):
            pixels.append((x1 >> _XY_SHIFT, y1))
            x1 += x_step
            y1 += 1
    _put(img, pixels, color)


def _fill_convex(img: np.ndarray, pts, color, shift: int) -> None:
    """OpenCV's `FillConvexPoly` for 8-connected edges, vertices in fixed
    point with `shift` fractional bits: the outline (each edge an integer
    line between its rounded ends, as OpenCV 5 draws it), then the spans
    between the left and right edges, row by row."""
    h, w = img.shape[:2]
    n = len(pts)
    delta = (1 << shift) >> 1
    half = _XY_ONE >> 1
    x_min = x_max = pts[0][0]
    y_min = y_max = pts[0][1]
    i_min = 0
    prev = (pts[-1][0] << (_XY_SHIFT - shift), pts[-1][1] << (_XY_SHIFT - shift))
    for i, (x, y) in enumerate(pts):
        if y < y_min:
            y_min, i_min = y, i
        y_max, x_max, x_min = max(y_max, y), max(x_max, x), min(x_min, x)
        p = (x << (_XY_SHIFT - shift), y << (_XY_SHIFT - shift))
        if shift == 0:
            _put(img, _line_pixels(w, h, (prev[0] >> _XY_SHIFT, prev[1] >> _XY_SHIFT),
                                   (p[0] >> _XY_SHIFT, p[1] >> _XY_SHIFT)), color)
        else:
            _line_fixed(img, prev, p, color)
        prev = p
    x_min, x_max = (x_min + delta) >> shift, (x_max + delta) >> shift
    y_min, y_max = (y_min + delta) >> shift, (y_max + delta) >> shift
    if n < 3 or x_max < 0 or y_max < 0 or x_min >= w or y_min >= h:
        return
    y_max = min(y_max, h - 1)
    edges = [dict(idx=i_min, di=1, x=-_XY_ONE, dx=0, ye=y_min),
             dict(idx=i_min, di=n - 1, x=-_XY_ONE, dx=0, ye=y_min)]
    remaining = n
    y = y_min
    while True:
        for e in edges:
            if y >= e['ye']:
                idx0 = e['idx']
                idx = (idx0 + e['di']) % n
                while remaining > 0:
                    remaining -= 1
                    ty = (pts[idx][1] + delta) >> shift
                    if ty > y:
                        xs = pts[idx0][0] << (_XY_SHIFT - shift)
                        xe = pts[idx][0] << (_XY_SHIFT - shift)
                        e.update(ye=ty, x=xs, idx=idx,
                                 dx=_cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y)))
                        break
                    idx0 = idx
                    idx = (idx + e['di']) % n
                else:
                    remaining -= 1
        if remaining < 0:
            break
        if y >= 0:
            left, right = sorted(edges, key=lambda e: e['x'])
            x1 = (left['x'] + half) >> _XY_SHIFT
            x2 = (right['x'] + half) >> _XY_SHIFT
            if x2 >= 0 and x1 < w:
                _hline(img, y, max(x1, 0), min(x2, w - 1), color)
        for e in edges:
            e['x'] += e['dx']
        y += 1
        if y > y_max:
            break


def fill_convex_poly(img: np.ndarray, points, color) -> np.ndarray:
    """`cv2.fillConvexPoly(img, points, color)` (8-connected, no shift), in
    place; `points` are integer (x, y) vertices."""
    pts = [(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)]
    _fill_convex(img, pts, color, 0)
    return img


def _circle_filled(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    """OpenCV's `Circle` with fill: spans of the midpoint circle."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, x1, x2 in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= y < h and x1 < w and x2 >= 0:
                _hline(img, y, max(x1, 0), min(x2, w - 1), color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def circle(img: np.ndarray, center, radius: int, color, thickness: int = 1) -> np.ndarray:
    """`cv2.circle(img, center, radius, color, thickness)` for a filled
    circle (thickness < 0; 8-connected, integer center, no shift), in place.
    Outlines are not ported and raise."""
    if thickness >= 0:
        raise NotImplementedError('circle outlines (thickness >= 0); only filled circles')
    cx, cy = (int(v) for v in center)
    _circle_filled(img, cx, cy, int(radius), color)
    return img


def line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """`cv2.line(img, p1, p2, color, thickness)` (8-connected, integer
    points), in place: a thick line is OpenCV's quad of half-width
    thickness / 2 around the segment (clipped to the image grown by the
    thickness), filled, with a filled circle of radius (thickness + 1) // 2
    at each end."""
    x1, y1 = (int(v) for v in p1)
    x2, y2 = (int(v) for v in p2)
    h, w = img.shape[:2]
    if thickness < 1:
        raise NotImplementedError('line thickness below 1 (filled shapes)')
    if thickness == 1:
        _put(img, _line_pixels(w, h, (x1, y1), (x2, y2)), color)
        return img
    # OpenCV 5 first clips the segment to the image grown by the thickness.
    m = thickness
    clipped = _clip_line(w + 2 * m, h + 2 * m, x1 + m, y1 + m, x2 + m, y2 + m)
    if clipped is None:
        return img
    x1, y1, x2, y2 = (v - m for v in clipped)
    p0 = (x1 << _XY_SHIFT, y1 << _XY_SHIFT)
    q0 = (x2 << _XY_SHIFT, y2 << _XY_SHIFT)
    dx, dy = (p0[0] - q0[0]) / _XY_ONE, (q0[1] - p0[1]) / _XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half_t = thickness << (_XY_SHIFT - 1)
    if abs(r) > 2.220446049250313e-16:
        r = (half_t + odd * _XY_ONE * 0.5) / math.sqrt(r)
        ex, ey = round(dy * r), round(dx * r)
        quad = [(p0[0] + ex, p0[1] + ey), (p0[0] - ex, p0[1] - ey),
                (q0[0] - ex, q0[1] - ey), (q0[0] + ex, q0[1] + ey)]
        _fill_convex(img, quad, color, _XY_SHIFT)
    radius = (half_t + (_XY_ONE >> 1)) >> _XY_SHIFT
    for x, y in ((x1, y1), (x2, y2)):
        _circle_filled(img, x, y, radius, color)
    return img


class _Edge:
    __slots__ = ('y0', 'y1', 'x', 'dx', 'next')

    def __init__(self, y0=0, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def _collect_edges(img: np.ndarray, pts, color, shift: int, edges: list) -> None:
    """OpenCV's `CollectPolyEdges` (8-connected): draws each edge as an
    integer line and records it for the scanline fill."""
    h, w = img.shape[:2]
    delta = (1 << shift) >> 1
    half = _XY_ONE >> 1
    x0, y0 = pts[-1]
    x0, y0 = x0 << (_XY_SHIFT - shift), (y0 + delta) >> shift
    for x1, y1 in pts:
        x1, y1 = x1 << (_XY_SHIFT - shift), (y1 + delta) >> shift
        t0 = ((x0 + half) >> _XY_SHIFT, y0)
        t1 = ((x1 + half) >> _XY_SHIFT, y1)
        _put(img, _line_pixels(w, h, t0, t1), color)
        c0, c1 = [x0, y0], [x1, y1]
        if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h and 0 <= t1[1] < h):
            clipped = _clip_line(w, h, *t0, *t1)
            if clipped is not None and clipped[1] != clipped[3]:
                c0 = [clipped[0] << _XY_SHIFT, clipped[1]]
                c1 = [clipped[2] << _XY_SHIFT, clipped[3]]
        c0[0] += half
        c1[0] += half
        if y0 != y1:
            dx = (c1[0] - c0[0]) // (c1[1] - c0[1])
            if y0 < y1:
                edges.append(_Edge(y0, y1, c0[0] + (y0 - c0[1]) * dx, dx))
            else:
                edges.append(_Edge(y1, y0, c1[0] + (y1 - c1[1]) * dx, dx))
        x0, y0 = x1, y1


def _fill_edges(img: np.ndarray, edges: list, color) -> None:
    """OpenCV's `FillEdgeCollection`: the even-odd scanline fill of the
    collected edges, with its active list and bubble sort."""
    h, w = img.shape[:2]
    if len(edges) < 2:
        return
    y_max, y_min = -(1 << 31), 1 << 31
    x_max, x_min = -(1 << 63), (1 << 63) - 1
    for e in edges:
        x1 = e.x + (e.y1 - e.y0) * e.dx
        y_min, y_max = min(y_min, e.y0), max(y_max, e.y1)
        x_min, x_max = min(x_min, e.x, x1), max(x_max, e.x, x1)
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << _XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e.y0, e.x, e.dx))
    total = len(edges)
    edges.append(_Edge(y0=1 << 31))
    head = _Edge()
    i = 0
    e = edges[0]
    y_max = min(y_max, h)
    for y in range(e.y0, y_max):
        draw = False
        prelast, last = head, head.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                prelast.next = last.next
                last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:
                prelast.next = e
                e.next = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if y >= 0:
                    left, right = sorted((keep_prelast.x, prelast.x))
                    x1, x2 = left >> _XY_SHIFT, (right - 1) >> _XY_SHIFT
                    if x1 < w and x2 >= 0:
                        _hline(img, y, max(x1, 0), min(x2, w - 1), color)
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw = not draw
        # Bubble-sort the active list by x.
        keep_prelast = None
        while True:
            prelast, last = head, head.next
            last_exchange = None
            while last is not keep_prelast and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next = te
                    last.next = te.next
                    te.next = last
                    prelast = te
                    last_exchange = prelast
                else:
                    prelast, last = last, te
            if last_exchange is None:
                break
            keep_prelast = last_exchange
            if keep_prelast is head.next or keep_prelast is head:
                break


def fill_poly(img: np.ndarray, polygons: Sequence, color) -> np.ndarray:
    """`cv2.fillPoly(img, polygons, color)` (8-connected, integer vertices,
    no shift), in place."""
    edges = []
    for pts in polygons:
        pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
        _collect_edges(img, pts, color, 0, edges)
    _fill_edges(img, edges, color)
    return img


def convex_hull(points: np.ndarray) -> np.ndarray:
    """The vertices of `cv2.convexHull(points)` for integer points [n, 2] (or
    [n, 1, 2]), as [m, 1, 2] int32 without collinear points. The starting
    vertex and direction may differ from cv2's; the polygon is the same."""
    pts = sorted({(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)})
    if len(pts) < 3:
        return np.array(pts, np.int32).reshape(-1, 1, 2)
    cross = lambda o, a, b: (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])
    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.array(lower[:-1] + upper[:-1], np.int32).reshape(-1, 1, 2)


# --- morphology and connected components -----------------------------------

def ellipse_kernel(ksize) -> np.ndarray:
    """`cv2.getStructuringElement(cv2.MORPH_ELLIPSE, ksize)`, ksize = (width,
    height) or an int."""
    width, height = (ksize, ksize) if np.isscalar(ksize) else ksize
    if (width, height) == (1, 1):
        return np.ones((1, 1), np.uint8)
    r, c = height // 2, width // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    out = np.zeros((height, width), np.uint8)
    for i in range(height):
        dy = i - r
        if abs(dy) <= r:
            dx = int(round(c * math.sqrt((r * r - dy * dy) * inv_r2)))
            out[i, max(c - dx, 0):min(c + dx + 1, width)] = 1
    return out


def _morph(mask: np.ndarray, kernel: np.ndarray, iterations: int, reduce) -> np.ndarray:
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise NotImplementedError('morphology of [H, W] masks')
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    taps = [(i - ay, j - ax) for i in range(kh) for j in range(kw) if kernel[i, j]]
    h, w = mask.shape
    out = mask
    for _ in range(iterations):
        # The border never wins: the image's own pixels decide at the edges.
        fill = np.iinfo(mask.dtype).max if reduce is np.minimum else 0
        padded = np.full((h + kh, w + kw), fill, mask.dtype)
        padded[ay:ay + h, ax:ax + w] = out
        result = None
        for dy, dx in taps:
            view = padded[ay + dy:ay + dy + h, ax + dx:ax + dx + w]
            result = view.copy() if result is None else reduce(result, view)
        out = result
    return out


def erode(mask: np.ndarray, kernel: np.ndarray, iterations: int = 1) -> np.ndarray:
    """`cv2.morphologyEx(mask, cv2.MORPH_ERODE, kernel, iterations=...)` on a
    uint8 [H, W] mask: the minimum over the kernel's taps (anchor at its
    centre), outside pixels ignored."""
    return _morph(mask, kernel, iterations, np.minimum)


def dilate(mask: np.ndarray, kernel: np.ndarray, iterations: int = 1) -> np.ndarray:
    """`cv2.morphologyEx(mask, cv2.MORPH_DILATE, kernel, iterations=...)`:
    the maximum over the kernel's taps."""
    return _morph(mask, kernel, iterations, np.maximum)


def connected_components_with_stats(mask: np.ndarray, connectivity: int = 8):
    """`cv2.connectedComponentsWithStats(mask, connectivity=connectivity)`:
    (count, int32 labels [H, W], int32 stats [count, 5] of (left, top,
    width, height, area), float64 centroids [count, 2]) of the nonzero
    pixels' 4- or 8-connected components, labelled in raster order of their
    first pixel (8-connected: of their first 2 x 2 block); label 0 is the
    background."""
    import scipy.ndimage
    if connectivity not in (4, 8):
        raise ValueError(f'connectivity must be 4 or 8, got {connectivity}')
    mask = np.asarray(mask) != 0
    structure = np.ones((3, 3), int) if connectivity == 8 else [[0, 1, 0], [1, 1, 1], [0, 1, 0]]
    labels, n = scipy.ndimage.label(mask, structure=structure)
    if connectivity == 8 and n > 1:
        # OpenCV labels 8-connected components block by block (2 x 2
        # blocks in raster order; one block never holds two components).
        ys, xs = np.nonzero(labels)
        block = (ys // 2) * ((mask.shape[1] + 1) // 2) + xs // 2
        first = np.full(n + 1, np.iinfo(np.int64).max)
        np.minimum.at(first, labels[ys, xs], block)
        relabel = np.zeros(n + 1, np.int64)
        relabel[1 + np.argsort(first[1:], kind='stable')] = np.arange(1, n + 1)
        labels = relabel[labels]
    labels = labels.astype(np.int32)
    # OpenCV's values for a component without pixels (only the background
    # can be one).
    stats = np.tile(np.array([-1, np.iinfo(np.int32).max, 0, 0, 0], np.int32), (n + 1, 1))
    centroids = np.full((n + 1, 2), np.nan)
    for k in range(n + 1):
        ys, xs = np.nonzero(labels == k)
        if len(xs):
            stats[k] = (xs.min(), ys.min(), xs.max() - xs.min() + 1, ys.max() - ys.min() + 1,
                        len(xs))
            centroids[k] = xs.mean(), ys.mean()
    return n + 1, labels, stats, centroids


# --- PNG: cv2.imread / cv2.imwrite -----------------------------------------

_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))


def write_png(path: str, image: np.ndarray, compression: int = 6) -> None:
    """Writes a uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA)
    image as an 8-bit PNG: every row with the Sub filter, zlib at
    `compression`. (cv2.imwrite takes BGR; this takes the channels in PNG's
    own order.)"""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise NotImplementedError(f'PNG of {image.dtype} images')
    channels = 1 if image.ndim == 2 else image.shape[2]
    color_type = {1: 0, 3: 2, 4: 6}.get(channels)
    if color_type is None or image.ndim not in (2, 3):
        raise NotImplementedError(f'PNG of shape {image.shape}')
    h, w = image.shape[:2]
    rows = image.reshape(h, w * channels)
    sub = rows.copy()
    sub[:, channels:] = rows[:, channels:] - rows[:, :-channels]  # uint8 wraps mod 256
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)
    with open(path, 'wb') as f:
        f.write(_PNG_SIGNATURE
                + _png_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color_type, 0, 0, 0))
                + _png_chunk(b'IDAT', zlib.compress(raw.tobytes(), compression))
                + _png_chunk(b'IEND', b''))


def read_png(path: str) -> np.ndarray:
    """An 8-bit PNG without a palette (gray, gray with alpha, RGB or RGBA) as
    uint8 [H, W] or [H, W, C] in PNG's channel order, alpha kept: the stored
    samples, through `data.png` (any filter, interlaced or not). Other kinds
    raise NotImplementedError; `improc.imread` reads every PNG as cv2 does."""
    from metrabs_tpu_torch.data import png
    with open(path, 'rb') as f:
        return png.decode_stored(f.read(), path)
