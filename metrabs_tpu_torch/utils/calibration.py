"""Checkerboard calibration without OpenCV: the three operations of
`metrabs_tpu/apps/calibrate_camera.py`, `cv2.findChessboardCorners`,
`cv2.cornerSubPix` and `cv2.calibrateCamera`, answering as OpenCV 5.0 does,
plus `render_checkerboard`, which draws a board seen through a lens.

The per-pixel work runs as torch ops on the chosen device: the detector's
filtering and ring tests, the refinement's windowed gradient sums (batched
over the corners) and the Levenberg-Marquardt step's residuals, Jacobian and
normal equations (float64). The grid assembly stays on the host.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metrabs_tpu_torch.ops import distortion

TERM_CRITERIA_MAX_ITER = 1  # cv2.TERM_CRITERIA_MAX_ITER (= COUNT)
TERM_CRITERIA_EPS = 2  # cv2.TERM_CRITERIA_EPS
_SUBPIX_MAX_ITERS = 100  # cornerSubPix's own cap on the iteration count


def _tensor_image(gray: np.ndarray, device) -> torch.Tensor:
    """A uint8 [H, W] image as a float32 tensor on `device`."""
    gray = np.asarray(gray)
    if gray.dtype != np.uint8 or gray.ndim != 2:
        raise ValueError(f'expected a uint8 [H, W] image, got {gray.dtype} {gray.shape}')
    return torch.from_numpy(np.ascontiguousarray(gray)).to(device).to(torch.float32)


# --------------------------------------------------------------------------
# cv2.cornerSubPix

def _rect_subpix(img: torch.Tensor, centers: torch.Tensor, size: int) -> torch.Tensor:
    """`cv2.getRectSubPix(img, (size, size), center, patchType=CV_32F)` of a
    uint8 image (held as float32) for each of `centers` [N, 2] (float32):
    [N, size, size] float32, OpenCV's arithmetic in float32. A window inside
    the image takes `getRectSubPix_8u32f`'s running form (each value the
    previous tap's share times (1 - a) / a plus the next); one that crosses
    the border the generic bilinear form on replicated pixels."""
    h, w = img.shape
    n, dev = centers.shape[0], img.device
    # center -= (size - 1) * 0.5f; ip = cvFloor(center); a, b its fractions.
    origin = centers - torch.tensor((size - 1) * 0.5, dtype=torch.float32, device=dev)
    ip = torch.floor(origin)
    frac = origin - ip
    ipi = ip.to(torch.int64)
    a, b = frac[:, 0], frac[:, 1]
    one = torch.ones((), dtype=torch.float32, device=dev)
    jj = torch.arange(size + 1, device=dev)
    xs = ipi[:, :1] + jj  # [N, size + 1] source columns
    ys = ipi[:, 1:] + jj
    inside = ((ipi[:, 0] >= 0) & (ipi[:, 0] + size < w)
              & (ipi[:, 1] >= 0) & (ipi[:, 1] + size < h))
    xc, yc = xs.clamp(0, w - 1), ys.clamp(0, h - 1)
    # src[r, c] for r in rows 0..size, c in cols 0..size: [N, size + 1, size + 1]
    src = img[yc[:, :, None], xc[:, None, :]]
    s_top, s_bot = src[:, :-1], src[:, 1:]  # rows i and i + 1

    # Inside: a = max(a, 1e-4); prev = (1 - a) * (b1 * s[0] + b2 * s[step]);
    # t_j = a12 * s[j+1] + a22 * s[j+1+step]; dst_j = prev + t_j; prev =
    # (float)(t_j * s) with s = (1 - a) / a in double.
    a_in = torch.clamp(a, min=1e-4)
    b1, b2 = one - b, b
    a12, a22 = a_in * (one - b), a_in * b
    t = a12[:, None, None] * s_top[:, :, 1:] + a22[:, None, None] * s_bot[:, :, 1:]
    prev0 = (one - a_in)[:, None] * (b1[:, None] * s_top[:, :, 0] + b2[:, None] * s_bot[:, :, 0])
    ratio = ((1.0 - a_in.double()) / a_in.double())[:, None, None]
    prev = torch.cat([prev0[:, :, None], (t[:, :, :-1].double() * ratio).float()], dim=2)
    run = prev + t

    # Border: clamped pixels; where both taps of a row fall on one column,
    # the value is b1 * top + b2 * bottom of that column.
    a11, a12g = (one - a) * (one - b), a * (one - b)
    a21, a22g = (one - a) * b, a * b
    gen = (s_top[:, :, :-1] * a11[:, None, None] + s_top[:, :, 1:] * a12g[:, None, None]
           + s_bot[:, :, :-1] * a21[:, None, None] + s_bot[:, :, 1:] * a22g[:, None, None])
    same_col = (xc[:, :-1] == xc[:, 1:])[:, None, :]
    vert = s_top[:, :, :-1] * b1[:, None, None] + s_bot[:, :, :-1] * b2[:, None, None]
    gen = torch.where(same_col, vert, gen)
    return torch.where(inside[:, None, None], run, gen)


def corner_subpix(gray, corners, win: Tuple[int, int], zero_zone: Tuple[int, int] = (-1, -1),
                  criteria: Tuple[int, int, float] = (TERM_CRITERIA_EPS + TERM_CRITERIA_MAX_ITER,
                                                      30, 1e-3),
                  device='cuda') -> np.ndarray:
    """`cv2.cornerSubPix(gray, corners, win, zero_zone, criteria)`: each
    corner moved to where the image gradients in its window are orthogonal
    to the vectors from it, iterated. `gray` is uint8 [H, W], `corners`
    [N, 1, 2] or [N, 2]; returns float32 [N, 1, 2].

    As OpenCV computes it: the window of (2 win + 3) pixels a side is
    resampled about the corner by `getRectSubPix` (bilinear, the border
    replicated); central differences weighted by exp(-x^2 - y^2), x and y
    in window half-widths (zero inside `zero_zone` if given); the 2x2 system
    summed in float64, the corner kept in float32; the iteration stops after
    criteria's count (at most 100) or once the squared move is at most
    eps^2, or when the corner leaves the image; a corner that ends more than
    `win` from its start keeps its start. All corners iterate at once, each
    frozen where its own iteration stops. Runs on `device`."""
    from metrabs_tpu_torch.pipeline.estimator import checked_device

    dev = checked_device(device)
    img = _tensor_image(gray, dev)
    h, w = img.shape
    pts0 = np.asarray(corners, np.float32).reshape(-1, 2)
    n = len(pts0)
    if n == 0:
        return pts0.reshape(0, 1, 2)
    wx, wy = int(win[0]), int(win[1])
    if wx <= 0 or wy <= 0 or wx != wy:
        raise ValueError(f'win must be a positive square half-window, got {win}')
    if w < wx * 2 + 5 or h < wy * 2 + 5:
        raise ValueError(f'image {w}x{h} too small for the window {win}')
    kind, max_count, eps = criteria
    max_iters = (min(max(int(max_count), 1), _SUBPIX_MAX_ITERS)
                 if kind & TERM_CRITERIA_MAX_ITER else _SUBPIX_MAX_ITERS)
    eps2 = max(float(eps), 0.0) ** 2 if kind & TERM_CRITERIA_EPS else 0.0
    if ((pts0[:, 0] < 0) | (pts0[:, 0] >= w) | (pts0[:, 1] < 0) | (pts0[:, 1] >= h)).any():
        raise ValueError('a corner lies outside the image')

    side = 2 * wx + 1
    offs = (torch.arange(side, device=dev, dtype=torch.float32) - wx) / wx
    g1 = torch.exp(-offs * offs)
    mask = (g1[:, None] * g1[None, :]).double()
    zx, zy = zero_zone
    if zx >= 0 and zy >= 0 and zx * 2 + 1 < side and zy * 2 + 1 < side:
        mask[wy - zy:wy + zy + 1, wx - zx:wx + zx + 1] = 0
    grid = (torch.arange(side, device=dev, dtype=torch.float64) - wx)
    px, py = grid[None, None, :], grid[None, :, None]

    start = torch.from_numpy(pts0).to(dev)
    cur = start.clone()
    active = torch.ones(n, dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        buf = _rect_subpix(img, cur, side + 2)
        gx = (buf[:, 1:-1, 2:] - buf[:, 1:-1, :-2]).double()
        gy = (buf[:, 2:, 1:-1] - buf[:, :-2, 1:-1]).double()
        gxx, gxy, gyy = gx * gx * mask, gx * gy * mask, gy * gy * mask
        sa, sb, sc = gxx.sum((1, 2)), gxy.sum((1, 2)), gyy.sum((1, 2))
        bb1 = (gxx * px + gxy * py).sum((1, 2))
        bb2 = (gxy * px + gyy * py).sum((1, 2))
        det = sa * sc - sb * sb
        solvable = det.abs() > np.finfo(np.float64).eps ** 2
        scale = 1.0 / torch.where(solvable, det, torch.ones_like(det))
        cd = cur.double()
        nxt = torch.stack([cd[:, 0] + sc * scale * bb1 - sb * scale * bb2,
                           cd[:, 1] - sb * scale * bb1 + sa * scale * bb2], 1).float()
        step = nxt - cur
        err = step[:, 0] * step[:, 0] + step[:, 1] * step[:, 1]
        moved = active & solvable
        cur = torch.where(moved[:, None], nxt, cur)
        left = (nxt[:, 0] < 0) | (nxt[:, 0] >= w) | (nxt[:, 1] < 0) | (nxt[:, 1] >= h)
        active = moved & (err.double() > eps2) & ~left
    far = ((cur[:, 0] - start[:, 0]).abs() > wx) | ((cur[:, 1] - start[:, 1]).abs() > wy)
    cur = torch.where(far[:, None], start, cur)
    return cur.cpu().numpy().reshape(n, 1, 2)


# --------------------------------------------------------------------------
# cv2.findChessboardCorners

_RING_SAMPLES = 32
_BORDER = 8  # findChessboardCorners' margin: a corner within it fails the board


def _gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    r = max(1, int(math.ceil(3 * sigma)))
    x = torch.arange(-r, r + 1, device=img.device, dtype=torch.float32)
    k = torch.exp(-x * x / (2 * sigma * sigma))
    k = k / k.sum()
    t = F.pad(img[None, None], (r, r, r, r), mode='replicate')
    t = F.conv2d(t, k.view(1, 1, 1, -1))
    return F.conv2d(t, k.view(1, 1, -1, 1))[0, 0]


def _sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of `img` [H, W] at float points `xy` [..., 2], the
    border replicated."""
    h, w = img.shape
    x = xy[..., 0].clamp(0, w - 1)
    y = xy[..., 1].clamp(0, h - 1)
    x0 = x.floor().clamp(max=w - 2)
    y0 = y.floor().clamp(max=h - 2)
    fx, fy = x - x0, y - y0
    xi, yi = x0.long(), y0.long()
    v00, v01 = img[yi, xi], img[yi, xi + 1]
    v10, v11 = img[yi + 1, xi], img[yi + 1, xi + 1]
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def _x_corner_candidates(img: torch.Tensor, max_candidates: int = 4000):
    """Saddle points of the blurred image that pass the ring test: (points
    [M, 2] float64 on the host, their ring contrast [M]). The saddle
    response is fxy^2 - fxx fyy of the image blurred at sigma 1.5, kept
    where it is the maximum of its 5x5 neighbourhood and above 2% of the
    image's largest. The ring test samples a circle about the point, of a
    third of the distance to the nearest other saddle: an X-junction of a
    board (two dark and two bright sectors) has a second circular harmonic
    at least twice its first, an L-corner at the board's rim (one dark
    sector) does not."""
    blur = _gaussian_blur(img, 1.5)
    p = F.pad(blur[None, None], (1, 1, 1, 1), mode='replicate')[0, 0]
    fxx = p[1:-1, 2:] - 2 * p[1:-1, 1:-1] + p[1:-1, :-2]
    fyy = p[2:, 1:-1] - 2 * p[1:-1, 1:-1] + p[:-2, 1:-1]
    fxy = (p[2:, 2:] - p[2:, :-2] - p[:-2, 2:] + p[:-2, :-2]) / 4
    resp = (fxy * fxy - fxx * fyy).clamp(min=0)
    peak = F.max_pool2d(resp[None, None], 5, stride=1, padding=2)[0, 0]
    keep = (resp == peak) & (resp > 0.02 * resp.max())
    keep[:3], keep[-3:], keep[:, :3], keep[:, -3:] = False, False, False, False
    ys, xs = torch.nonzero(keep, as_tuple=True)
    strength = resp[ys, xs]
    if len(xs) > max_candidates:
        top = torch.topk(strength, max_candidates).indices
        xs, ys, strength = xs[top], ys[top], strength[top]
    if len(xs) < 4:
        return np.zeros((0, 2)), np.zeros(0), np.zeros((0, _RING_SAMPLES))
    # Sub-pixel peak: a parabola through the response along x and y.
    def offset(m, c, q):
        den = m - 2 * c + q
        return torch.where(den < 0, 0.5 * (m - q) / den, torch.zeros_like(den)).clamp(-0.5, 0.5)
    rp = F.pad(resp[None, None], (1, 1, 1, 1))[0, 0]
    c = rp[ys + 1, xs + 1]
    dx = offset(rp[ys + 1, xs], c, rp[ys + 1, xs + 2])
    dy = offset(rp[ys, xs + 1], c, rp[ys + 2, xs + 1])
    pts = torch.stack([xs + dx, ys + dy], 1)
    d2 = torch.cdist(pts, pts)
    d2.fill_diagonal_(math.inf)
    nearest = d2.min(1).values
    radius = (nearest / 3).clamp(1.5, 20)[:, None]
    ang = torch.arange(_RING_SAMPLES, device=img.device) * (2 * math.pi / _RING_SAMPLES)
    ring = pts[:, None, :] + radius[:, :, None] * torch.stack([ang.cos(), ang.sin()], 1)
    vals = _sample(blur, ring)
    vals = vals - vals.mean(1, keepdim=True)
    h1 = torch.stack([(vals * ang.cos()).sum(1), (vals * ang.sin()).sum(1)], 1).norm(dim=1)
    h2 = torch.stack([(vals * (2 * ang).cos()).sum(1), (vals * (2 * ang).sin()).sum(1)],
                     1).norm(dim=1)
    contrast = h2 * (2.0 / _RING_SAMPLES)
    sign_changes = ((vals > 0) != torch.roll(vals > 0, 1, 1)).sum(1)
    ok = (h2 > 2 * h1) & (sign_changes == 4) & (contrast > 10.0)
    return (pts[ok].double().cpu().numpy(), contrast[ok].double().cpu().numpy(),
            vals[ok].double().cpu().numpy())


def _edge_directions(ring: np.ndarray) -> Optional[np.ndarray]:
    """The two edge lines through an X-junction, as unit vectors [2, 2],
    from the four zero crossings of its mean-free ring profile (opposite
    crossings averaged)."""
    n = len(ring)
    pos = ring > 0
    cross = []
    for i in range(n):
        a, b = ring[i - 1], ring[i]
        if pos[i - 1] != pos[i]:
            cross.append((i - 1 + a / (a - b)) * 2 * math.pi / n)
    if len(cross) != 4:
        return None
    cross.sort()
    dirs = []
    for k in range(2):
        a, b = cross[k], cross[k + 2] - math.pi
        ang = math.atan2(math.sin(a) + math.sin(b), math.cos(a) + math.cos(b))
        dirs.append((math.cos(ang), math.sin(ang)))
    return np.array(dirs)


def _grow_grid(pts: np.ndarray, seed: int, used: np.ndarray, edges: np.ndarray):
    """The lattice of candidate points reachable from `seed` by steps to a
    point within 30% of a step of where the lattice predicts it: a dict
    (i, j) -> point index, or None when the seed has no neighbour along
    each of its two edge lines `edges` [2, 2]."""
    p0 = pts[seed]
    vec = pts - p0
    d = np.linalg.norm(vec, axis=1)
    d[seed] = np.inf
    d[used] = np.inf
    basis = []
    for e in edges:
        cos = np.abs(vec @ e) / np.maximum(d, 1e-9)
        along = np.where(cos > math.cos(math.radians(15)), d, np.inf)
        k = int(np.argmin(along))
        if not np.isfinite(along[k]):
            return None
        basis.append(vec[k])
    u, v = basis
    grid = {(0, 0): seed}
    taken = used.copy()
    taken[seed] = True
    queue = [(0, 0)]
    steps = {(1, 0): u, (0, 1): v}
    while queue:
        i, j = queue.pop(0)
        p = pts[grid[(i, j)]]
        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            q = (i + di, j + dj)
            if q in grid:
                continue
            back = (i - di, j - dj)
            if back in grid:
                step = p - pts[grid[back]]
            else:
                # The step along this axis at the nearest lattice edge.
                axis = (abs(di), abs(dj))
                step = None
                for (a, b), k in grid.items():
                    nb = (a + axis[0], b + axis[1])
                    if nb in grid and abs(a - i) + abs(b - j) <= 2:
                        step = (pts[grid[nb]] - pts[k]) * (di + dj)
                        break
                if step is None:
                    step = steps[axis] * (di + dj)
            pred = p + step
            tol = 0.3 * np.linalg.norm(step)
            dist = np.linalg.norm(pts - pred, axis=1)
            dist[taken] = np.inf
            k = int(np.argmin(dist))
            if dist[k] <= tol:
                grid[q] = k
                taken[k] = True
                queue.append(q)
    return grid


def _square_is_dark(blur: torch.Tensor, quad: np.ndarray, ref: np.ndarray) -> bool:
    """Whether the square with corners `quad` [4, 2] is darker than the
    neighbouring square `ref` [4, 2] (each sampled at its centre)."""
    c = torch.tensor(np.stack([quad.mean(0), ref.mean(0)]), dtype=torch.float32,
                     device=blur.device)
    v = _sample(blur, c)
    return bool(v[0] < v[1])


def _order_grid(g: np.ndarray, blur: torch.Tensor, cols: int, rows: int) -> Optional[np.ndarray]:
    """`g` [n_i, n_j, 2] in OpenCV's order [rows, cols, 2], or None."""
    cands = []
    for t in (g, g.transpose(1, 0, 2)):
        if t.shape[:2] != (rows, cols):
            continue
        for fr in (False, True):
            for fc in (False, True):
                o = t[::-1] if fr else t
                o = o[:, ::-1] if fc else o
                cands.append(np.ascontiguousarray(o))
    keep = []
    for o in cands:
        p0, p1, p2 = o[0, 0], o[0, cols - 1], o[1, 0]
        if (p1[0] - p0[0]) * (p2[1] - p1[1]) - (p1[1] - p0[1]) * (p2[0] - p1[0]) < 0:
            continue  # OpenCV's order is right-handed in the image
        # The board's corner square beyond the first corner has the colour
        # of the first inner square (same parity); OpenCV starts at a dark one.
        inner = np.stack([o[0, 0], o[0, 1], o[1, 1], o[1, 0]])
        beside = np.stack([o[0, 1], o[0, 2], o[1, 2], o[1, 1]])
        if _square_is_dark(blur, inner, beside):
            keep.append(o)
    if rows % 2 == 0 and cols % 2 == 0:
        keep = [o for o in keep if o[-1, 0, 1] - o[0, 0, 1] >= 0]
    if not keep:
        return None
    if rows % 2 and cols % 2:
        # Odd x odd boards have two dark corners 180 degrees apart: OpenCV's
        # order follows its walk over the dark squares (_opencv_walk).
        return _opencv_walk(g, keep[0][0, 0], cols, rows)
    # OpenCV's first row runs rightwards on the other boards.
    keep.sort(key=lambda o: (o[0, -1, 0] - o[0, 0, 0] <= 0, o[0, 0, 1]))
    return keep[0]


_TOP_TIE_PX = 1.0  # a square's vertices this close to its top one in y tie for it


def _opencv_walk(g: np.ndarray, dark_corner: np.ndarray, cols: int, rows: int) -> np.ndarray:
    """The order in which OpenCV's checkQuadGroup reads an odd x odd board
    (pinned down against cv2 5.0 with boards of 3x3 to 9x9 inner corners at
    every 5 degrees in the image plane). The dark squares are its quads,
    each with its vertices clockwise on the screen from the top one (the
    leftmost of those within _TOP_TIE_PX of the top) and its neighbours by
    shared vertex; the group is gathered depth first from the quad whose
    top vertex comes first in raster order; the corners are listed as the
    group's quads reach them. The walk starts at the first listed corner of
    a corner quad, runs its first row towards the first corner linked to it
    (a quad edge), and is then transposed to `cols` per row and turned
    right-handed as in `find_chessboard_corners`. `g` [n_i, n_j, 2] holds the
    inner corners in lattice order; `dark_corner` is one that touches a dark
    corner square."""
    n_i, n_j = g.shape[:2]

    def point(i: int, j: int) -> np.ndarray:  # a lattice point, extrapolated beyond the corners
        ii, jj = min(max(i, 0), n_i - 1), min(max(j, 0), n_j - 1)
        p = g[ii, jj].copy()
        if i != ii:
            p += (i - ii) * (g[ii, jj] - g[ii - 1 if ii else 1, jj]) * (1 if ii else -1)
        if j != jj:
            p += (j - jj) * (g[ii, jj] - g[ii, jj - 1 if jj else 1]) * (1 if jj else -1)
        return p

    ci, cj = np.unravel_index(np.argmin(np.linalg.norm(g - dark_corner, axis=2)), (n_i, n_j))
    parity = ((-1 if ci == 0 else n_i - 1) + (-1 if cj == 0 else n_j - 1)) % 2
    squares = [(a, b) for a in range(-1, n_i) for b in range(-1, n_j) if (a + b) % 2 == parity]
    q0 = [point(*v) for v in ((0, 0), (0, 1), (1, 1), (1, 0))]
    clockwise = sum(q0[k][0] * q0[k - 3][1] - q0[k - 3][0] * q0[k][1] for k in range(4)) > 0

    def vertices(a: int, b: int):
        lat = [(a, b), (a, b + 1), (a + 1, b + 1), (a + 1, b)]
        if not clockwise:
            lat = [lat[0], lat[3], lat[2], lat[1]]
        xy = [point(*v) for v in lat]
        top = min(v[1] for v in xy)
        s = min((k for k in range(4) if xy[k][1] <= top + _TOP_TIE_PX), key=lambda k: xy[k][0])
        return lat[s:] + lat[:s], xy[s]

    inner = lambda v: 0 <= v[0] < n_i and 0 <= v[1] < n_j  # noqa: E731
    corners, tops = {}, {}
    for sq in squares:
        corners[sq], tops[sq] = vertices(*sq)
    owners = {}
    for sq in squares:
        for v in corners[sq]:
            if inner(v):
                owners.setdefault(v, []).append(sq)
    neighbours = {sq: [next((o for o in owners[v] if o != sq), None) if inner(v) else None
                       for v in corners[sq]] for sq in squares}
    count = {sq: sum(n is not None for n in neighbours[sq]) for sq in squares}
    seed = min((sq for sq in squares if count[sq]), key=lambda sq: (tops[sq][1], tops[sq][0]))
    group, stack, seen = [seed], [seed], {seed}
    while stack:
        for n in neighbours[stack.pop()]:
            if n is not None and n not in seen:
                seen.add(n)
                stack.append(n)
                group.append(n)
    listed, of_corner_quad, links = [], set(), {}
    for sq in group:
        for k in range(4):
            if neighbours[sq][k] is None:
                continue
            a, b = corners[sq][k], corners[sq][(k + 1) & 3]
            if a not in listed:
                listed.append(a)
            if count[sq] == 1:
                of_corner_quad.add(a)
            if neighbours[sq][(k + 1) & 3] is not None:
                links.setdefault(a, []).append(b)
                links.setdefault(b, []).append(a)
    first = next(v for v in listed if len(links.get(v, ())) == 2 and v in of_corner_quad)
    (i0, j0), right, below = first, links[first][0], links[first][1]
    di, dj = right[0] - i0, right[1] - j0
    bi, bj = below[0] - i0, below[1] - j0
    width, height = (n_j, n_i) if di == 0 else (n_i, n_j)
    out = np.array([[g[i0 + a * bi + b * di, j0 + a * bj + b * dj] for b in range(width)]
                    for a in range(height)])
    if width != cols:
        out = out.transpose(1, 0, 2)
    p0, p1, p2 = out[0, 0], out[0, cols - 1], out[1, 0]
    if (p1[0] - p0[0]) * (p2[1] - p1[1]) - (p1[1] - p0[1]) * (p2[0] - p1[0]) < 0:
        out = out[::-1]  # odd rows: OpenCV flips the columns' order
    return np.ascontiguousarray(out)


def find_chessboard_corners(gray, pattern_size: Tuple[int, int], device='cuda'
                            ) -> Tuple[bool, Optional[np.ndarray]]:
    """`cv2.findChessboardCorners(gray, (cols, rows))` with its default flags:
    (found, float32 [rows * cols, 1, 2] corners or None).

    The port finds the board its own way: saddle points of the blurred
    image that pass a ring test (an X-junction of two dark and two bright
    squares), grown into a lattice from the strongest, which must hold
    exactly rows x cols points. The order is OpenCV's, pinned down against
    cv2 5.0: row by row of `cols` points, the first corner the one whose
    outer corner square is dark (OpenCV links the dark squares and starts at
    a dark corner square), the rows running so that the grid is
    right-handed in the image (OpenCV reverses the rows or the columns of a
    left-handed one); for boards of even rows and columns the last row
    below the first; for odd rows and columns OpenCV's walk over its dark
    quads (`_opencv_walk`, whose first corner may touch a light square). The
    port's found flag differs from OpenCV's where OpenCV's image
    normalisation (its default CALIB_CB_NORMALIZE_IMAGE, a histogram
    equalisation) merges a small board's squares so that its quads no
    longer link: cv2 then finds no board where the port finds one
    (tests/torch_fixtures/calib's a/calib_4.png). As OpenCV does, a board
    with a corner within 8 pixels of the image border is not found, and the
    corners are refined by `corner_subpix` with a half window of 2, at most
    15 iterations and eps 0.1."""
    from metrabs_tpu_torch.pipeline.estimator import checked_device

    dev = checked_device(device)
    cols, rows = int(pattern_size[0]), int(pattern_size[1])
    if cols < 2 or rows < 2:
        raise ValueError(f'pattern_size must be at least (2, 2), got {pattern_size}')
    img = _tensor_image(gray, dev)
    h, w = img.shape
    pts, strength, rings = _x_corner_candidates(img)
    if len(pts) < rows * cols:
        return False, None
    blur = _gaussian_blur(img, 1.0)
    used = np.zeros(len(pts), bool)
    for seed in np.argsort(-strength):
        if used[seed]:
            continue
        edges = _edge_directions(rings[seed])
        grid = None if edges is None else _grow_grid(pts, int(seed), used, edges)
        if grid is None:
            used[seed] = True
            continue
        used[list(grid.values())] = True
        ij = np.array(list(grid.keys()))
        lo, hi = ij.min(0), ij.max(0)
        n_i, n_j = hi - lo + 1
        if len(grid) != n_i * n_j or sorted((n_i, n_j)) != sorted((rows, cols)):
            continue
        g = np.zeros((n_i, n_j, 2))
        for (i, j), k in grid.items():
            g[i - lo[0], j - lo[1]] = pts[k]
        ordered = _order_grid(g, blur, cols, rows)
        if ordered is None:
            continue
        corners = ordered.reshape(-1, 2)
        if ((corners[:, 0] <= _BORDER) | (corners[:, 0] > w - _BORDER)
                | (corners[:, 1] <= _BORDER) | (corners[:, 1] > h - _BORDER)).any():
            return False, None
        refined = corner_subpix(gray, corners.astype(np.float32), (2, 2),
                                (-1, -1), (TERM_CRITERIA_EPS + TERM_CRITERIA_MAX_ITER, 15, 0.1),
                                device=dev)
        return True, refined
    return False, None


# --------------------------------------------------------------------------
# A board seen through a lens

def rotation_from_quaternion(q: Sequence[float]) -> np.ndarray:
    """The rotation matrix of the quaternion (w, x, y, z), normalised: float64
    [3, 3] from +, *, / and one square root, so the same on every machine."""
    w, x, y, z = (float(v) for v in q)
    n = math.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def _inverse3(m) -> list:
    """The inverse of a 3x3 matrix by its adjugate, in Python floats."""
    (a, b, c), (d, e, f), (g, h, i) = [[float(v) for v in row] for row in m]
    co = [[e * i - f * h, -(d * i - f * g), d * h - e * g],
          [-(b * i - c * h), a * i - c * g, -(a * h - b * g)],
          [b * f - c * e, -(a * f - c * d), a * e - b * d]]
    det = a * co[0][0] + b * co[0][1] + c * co[0][2]
    return [[co[k][r] / det for k in range(3)] for r in range(3)]


_BOARD_COLORS = ((32, 30, 36), (236, 230, 214), (104, 118, 126))  # dark, paper, background
_RENDER_UNDISTORT_ITERS = 20  # inverse lens steps: a 3e-14 residual at b/'s frame corners


def render_checkerboard(image_size: Tuple[int, int], intrinsic_matrix, distortion_coeffs,
                        quaternion: Sequence[float], translation: Sequence[float],
                        pattern_size: Tuple[int, int] = (9, 6), square: float = 40.0,
                        margin: float = 30.0, supersample: int = 3) -> np.ndarray:
    """uint8 [H, W, 3] RGB view of a checkerboard of `pattern_size` (cols,
    rows) inner corners, squares of `square` (mm) on a sheet with a `margin`
    beyond the outer squares, through a camera with `intrinsic_matrix` and
    OpenCV's `distortion_coeffs` (up to 12). The board's inner corner (c, r)
    lies at (c * square, r * square, 0) in board coordinates (as
    calibrate_camera's object points), the square beyond corner (0, 0) is
    dark, and a board point X maps to the camera as R X + t, R from the
    quaternion (w, x, y, z). The squares are near black on cream paper over
    a grey background whose brightness falls off radially.

    Each pixel averages `supersample`^2 samples; each sample's ray comes
    from `ops.distortion.undistort_points` (20 fixed-point steps) and
    meets the board's plane through the inverse homography; then
    a [1, 2, 1] / 4 blur runs along each axis. Only IEEE-exact operations
    touch the pixels (no matrix products, no transcendental functions), so a
    view renders to the same bytes on every machine."""
    h, w = image_size
    k = np.asarray(intrinsic_matrix, np.float64)
    fx, fy, cx, cy, skew = k[0, 0], k[1, 1], k[0, 2], k[1, 2], k[0, 1]
    d = torch.tensor(np.asarray(distortion_coeffs, np.float64).ravel(), dtype=torch.float64)
    rot = rotation_from_quaternion(quaternion)
    hom = [[rot[0, 0], rot[0, 1], translation[0]], [rot[1, 0], rot[1, 1], translation[1]],
           [rot[2, 0], rot[2, 1], translation[2]]]
    hi = _inverse3(hom)
    cols, rows = pattern_size
    dark, paper, background = (np.asarray(c, np.float64) for c in _BOARD_COLORS)
    v, u = np.mgrid[:h, :w].astype(np.float64)
    radial = 1.0 - 0.25 * (((u - w / 2) / w) ** 2 + ((v - h / 2) / h) ** 2)
    acc = np.zeros((h, w, 3))
    offs = [(i + 0.5) / supersample - 0.5 for i in range(supersample)]
    for oy in offs:
        for ox in offs:
            yd = (v + oy - cy) / fy
            xd = (u + ox - cx - skew * yd) / fx
            und = distortion.undistort_points(torch.from_numpy(np.stack([xd, yd], -1)), d,
                                              num_iters=_RENDER_UNDISTORT_ITERS).numpy()
            xu, yu = und[..., 0], und[..., 1]
            den = hi[2][0] * xu + hi[2][1] * yu + hi[2][2]
            bx = (hi[0][0] * xu + hi[0][1] * yu + hi[0][2]) / den
            by = (hi[1][0] * xu + hi[1][1] * yu + hi[1][2]) / den
            on_sheet = ((bx >= -square - margin) & (bx < cols * square + margin)
                        & (by >= -square - margin) & (by < rows * square + margin) & (den > 0))
            sx, sy = np.floor(bx / square), np.floor(by / square)
            on_squares = (sx >= -1) & (sx < cols) & (sy >= -1) & (sy < rows)
            is_dark = on_sheet & on_squares & ((sx + sy) % 2 == 0)
            sample = np.where(on_sheet[..., None], paper, background * radial[..., None])
            acc += np.where(is_dark[..., None], dark, sample)
    img = acc / (supersample * supersample)
    img = (np.concatenate([img[:1], img[:-1]]) + 2 * img + np.concatenate([img[1:], img[-1:]])) / 4
    img = (np.concatenate([img[:, :1], img[:, :-1]], 1) + 2 * img
           + np.concatenate([img[:, 1:], img[:, -1:]], 1)) / 4
    return np.floor(img + 0.5).clip(0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# cv2.calibrateCamera

_N_INTRINSIC = 9  # fx, fy, cx, cy, k1, k2, p1, p2, k3


def _homography(obj_xy: np.ndarray, img_xy: np.ndarray) -> np.ndarray:
    """The plane-to-image homography by the normalised DLT (float64)."""
    def normaliser(p):
        c = p.mean(0)
        s = np.sqrt(2) / np.mean(np.linalg.norm(p - c, axis=1))
        return np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
    ta, tb = normaliser(obj_xy), normaliser(img_xy)
    a = (np.c_[obj_xy, np.ones(len(obj_xy))] @ ta.T)
    b = (np.c_[img_xy, np.ones(len(img_xy))] @ tb.T)
    rows = []
    for (x, y, _), (u, v, _) in zip(a, b):
        rows.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        rows.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    h = np.linalg.svd(np.asarray(rows))[2][-1].reshape(3, 3)
    h = np.linalg.inv(tb) @ h @ ta
    return h / h[2, 2]


def init_intrinsic_params_2d(object_points, image_points, image_size) -> np.ndarray:
    """`cv2.initCameraMatrix2D` as `calibrateCamera` calls it (aspect ratio
    free): the principal point at ((w - 1) / 2, (h - 1) / 2) and fx, fy from
    the vanishing points of each view's homography, solved together in least
    squares."""
    w, h = image_size
    cx, cy = (w - 1) * 0.5, (h - 1) * 0.5
    rows_a, rows_b = [], []
    for obj, img in zip(object_points, image_points):
        hm = _homography(np.asarray(obj, np.float64)[:, :2], np.asarray(img, np.float64))
        hm = hm.copy()
        hm[0] -= hm[2] * cx
        hm[1] -= hm[2] * cy
        hv, vv = hm[:, 0], hm[:, 1]
        d1, d2 = (hv + vv) * 0.5, (hv - vv) * 0.5
        hv, vv = hv / np.linalg.norm(hv), vv / np.linalg.norm(vv)
        d1, d2 = d1 / np.linalg.norm(d1), d2 / np.linalg.norm(d2)
        rows_a += [[hv[0] * vv[0], hv[1] * vv[1]], [d1[0] * d2[0], d1[1] * d2[1]]]
        rows_b += [-hv[2] * vv[2], -d1[2] * d2[2]]
    f = np.linalg.lstsq(np.asarray(rows_a), np.asarray(rows_b), rcond=None)[0]
    return np.array([[math.sqrt(abs(1 / f[0])), 0, cx], [0, math.sqrt(abs(1 / f[1])), cy],
                     [0, 0, 1]])


def _rodrigues(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] of rotation vectors [..., 3] (smooth at
    zero: the small-angle series below 1e-6 rad)."""
    theta2 = (r * r).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2.clamp(min=1e-24))
    small = theta2 < 1e-12
    a = torch.where(small, 1 - theta2 / 6, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24, (1 - torch.cos(theta)) / theta2.clamp(min=1e-24))
    zero = torch.zeros_like(r[..., 0])
    kx = torch.stack([torch.stack([zero, -r[..., 2], r[..., 1]], -1),
                      torch.stack([r[..., 2], zero, -r[..., 0]], -1),
                      torch.stack([-r[..., 1], r[..., 0], zero], -1)], -2)
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand_as(kx)
    return eye + a * kx + b * (kx @ kx)


def _rotation_vector(rot: np.ndarray) -> np.ndarray:
    """`cv2.Rodrigues` of a rotation matrix (float64 [3])."""
    u, _, vt = np.linalg.svd(rot)
    rot = u @ vt
    cos = np.clip((np.trace(rot) - 1) / 2, -1, 1)
    theta = math.acos(cos)
    axis = np.array([rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0], rot[1, 0] - rot[0, 1]])
    if theta < 1e-8:
        return axis / 2
    if math.pi - theta < 1e-6:
        axis = np.sqrt(np.clip((np.diag(rot) + 1) / 2, 0, None))
        return axis * theta
    return axis * theta / (2 * math.sin(theta))


def project_points(obj: torch.Tensor, rvec: torch.Tensor, tvec: torch.Tensor,
                   intrinsics: torch.Tensor, dist5: torch.Tensor) -> torch.Tensor:
    """`cv2.projectPoints`: board points [V, N, 3] through per-view rotation
    vectors and translations [V, 3] and the camera (fx, fy, cx, cy) with the
    five coefficients, the lens through `ops.distortion.distort_points` (12
    coefficients, the last seven zero). [V, N, 2] pixels."""
    cam = obj @ _rodrigues(rvec).transpose(-1, -2) + tvec[:, None, :]
    xy = cam[..., :2] / cam[..., 2:]
    d = distortion.pad_distortion_coeffs(dist5)
    xy = distortion.distort_points(xy, d)
    return torch.stack([intrinsics[0] * xy[..., 0] + intrinsics[2],
                        intrinsics[1] * xy[..., 1] + intrinsics[3]], -1)


_LM_MAX_ITERS = 30  # cv2.calibrateCamera's default criteria: 30 iterations or
_LM_EPS = np.finfo(np.float64).eps  # a relative parameter change below DBL_EPSILON


def calibrate_camera(object_points, image_points, image_size: Tuple[int, int],
                     device='cuda'):
    """`cv2.calibrateCamera(object_points, image_points, image_size, None,
    None)` with flags 0: (rms, K [3, 3], distortion [1, 5] (k1 k2 p1 p2 k3),
    rvecs, tvecs), each view's as a float64 [3, 1] array; rms is
    sqrt(sum of squared reprojection errors / number of points). The board
    must be planar (z = 0), as OpenCV requires without an intrinsic guess.

    As OpenCV 5.0 solves it: K from `init_intrinsic_params_2d`, each view's
    pose from its homography through that K (no distortion), then
    Levenberg-Marquardt over all 9 + 6 V parameters in float64, the damped
    normal equations (J^T J + lambda diag(J^T J)) solved by SVD, lambda from
    1e-3 divided by 10 after a step that lowers the error and multiplied by
    10 until one does, stopping after 30 iterations or once the parameters
    move by less than DBL_EPSILON relative (cv2's default criteria). The
    residuals, the Jacobian (forward mode through `project_points`) and the
    normal equations are torch ops on `device`."""
    from metrabs_tpu_torch.pipeline.estimator import checked_device

    dev = checked_device(device)
    objs = [np.asarray(o, np.float64).reshape(-1, 3) for o in object_points]
    imgs = [np.asarray(i, np.float64).reshape(-1, 2) for i in image_points]
    if len(objs) != len(imgs) or not objs:
        raise ValueError('object_points and image_points must hold the same views')
    if any(len(o) != len(i) or len(o) < 4 for o, i in zip(objs, imgs)):
        raise ValueError('each view needs at least 4 points, as many in both lists')
    if any(np.abs(o[:, 2]).max() > 1e-5 for o in objs):
        raise ValueError('the board must be planar (z = 0) without an intrinsic guess')
    n_pts = [len(o) for o in objs]
    if len(set(n_pts)) != 1:
        raise ValueError('every view must hold the same number of points')
    k0 = init_intrinsic_params_2d(objs, imgs, image_size)
    k_inv = np.linalg.inv(k0)
    poses = []
    for o, i in zip(objs, imgs):
        hm = k_inv @ _homography(o[:, :2], i)
        scale = 1 / np.linalg.norm(hm[:, 0])
        if hm[2, 2] * scale < 0:
            scale = -scale  # the board in front of the camera
        r1, r2 = hm[:, 0] * scale, hm[:, 1] * scale
        rot = np.stack([r1, r2, np.cross(r1, r2)], 1)
        poses.append(np.r_[_rotation_vector(rot), hm[:, 2] * scale])
    x = np.r_[k0[0, 0], k0[1, 1], k0[0, 2], k0[1, 2], np.zeros(5), np.concatenate(poses)]

    f64 = dict(dtype=torch.float64, device=dev)
    obj_t = torch.tensor(np.stack(objs), **f64)
    img_t = torch.tensor(np.stack(imgs), **f64)
    n_views = len(objs)

    def residuals(p):
        pose = p[_N_INTRINSIC:].reshape(n_views, 6)
        proj = project_points(obj_t, pose[:, :3], pose[:, 3:], p[:4], p[4:9])
        return (proj - img_t).reshape(-1)

    jacobian = torch.func.jacfwd(residuals)
    params = torch.tensor(x, **f64)
    err = residuals(params)
    cost = float(err @ err)
    lam = 1e-3
    for _ in range(_LM_MAX_ITERS):
        jac = jacobian(params)
        jtj, jte = jac.T @ jac, jac.T @ err
        while True:
            damped = jtj + lam * torch.diag(torch.diagonal(jtj))
            step = torch.linalg.lstsq(damped.cpu(), jte.cpu()[:, None],
                                      driver='gelsd').solution[:, 0].to(dev)
            trial = params - step
            trial_err = residuals(trial)
            trial_cost = float(trial_err @ trial_err)
            if trial_cost <= cost or lam > 1e16:
                break
            lam *= 10
        if trial_cost > cost:
            break
        moved = float(torch.linalg.norm(trial - params) / torch.linalg.norm(params))
        params, err, cost = trial, trial_err, trial_cost
        lam = max(lam / 10, 1e-16)
        if moved < _LM_EPS:
            break
    p = params.cpu().numpy()
    k = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1]])
    pose = p[_N_INTRINSIC:].reshape(n_views, 6)
    rms = math.sqrt(cost / sum(n_pts))
    return (rms, k, p[4:9].reshape(1, 5), [v[:3].reshape(3, 1) for v in pose],
            [v[3:].reshape(3, 1) for v in pose])
