"""Perspective-correct crop warp with lens distortion and pyramid antialias:
the plain PyTorch versions (`metrabs_tpu/ops/warp.py`).

These are the semantic reference of the CUDA kernel in `ops/warp_cuda.py`
(and what that wrapper runs on CPU tensors). Semantics as in the JAX gather
backend:
 - always-distort formulation (zero coefficients are the identity);
 - zero border from a 1 px zero ring plus replicate-clamped lookups, as
   tfa.interpolate_bilinear on the padded image (not grid_sample's
   conventions);
 - 3-level box-filter pyramid, level floor(-log2(crop_scale)) clamped to
   [0, 2], intrinsics adjusted by the corner-aligned scale matrix.

The pyramid is flattened pixel-major, [n_images * per_image_len, C], so that
one bilinear tap reads the C channels of a pixel from adjacent addresses.
The coordinate arithmetic is written out term by term in the order the
kernel evaluates it, so that the two round identically.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from metrabs_tpu_torch.ops import distortion as distortion_ops
from metrabs_tpu_torch.ops.camera import corner_aligned_scale_mat

# Per-crop kernel parameters: new_invprojmat (9, row-major), rows 0-1 of the
# level-adjusted intrinsics (6), distortion coefficients (12).
N_PARAMS = 27
# Per-crop geometry: pixel offset of the crop's image level in the flat
# pyramid, padded level height, padded level width.
N_GEOM = 3

LevelInfo = List[Tuple[int, int, int]]


def avg_pool_nxn(images: torch.Tensor, n_pool: int) -> torch.Tensor:
    """nxn box filter with stride n and VALID padding on NHWC images."""
    n, h, w, c = images.shape
    h2, w2 = h // n_pool, w // n_pool
    x = images[:, :h2 * n_pool, :w2 * n_pool, :]
    return x.reshape(n, h2, n_pool, w2, n_pool, c).mean(dim=(2, 4))


def select_pyramid_level(crop_scales: torch.Tensor, intrinsic_matrix: torch.Tensor,
                         n_pyramid_levels: int):
    """Per-crop level floor(-log(scale) / log(2)) clipped to the pyramid, and
    the level-adjusted intrinsics S(1/2^l) @ K. Returns (i_levels [N] int64,
    k_sel [N, 3, 3])."""
    log2 = torch.log(torch.tensor(2.0, dtype=torch.float32, device=crop_scales.device))
    i_levels = torch.floor(-torch.log(crop_scales) / log2)
    i_levels = torch.clamp(i_levels, 0, n_pyramid_levels - 1).long()
    k_levels = torch.stack([
        corner_aligned_scale_mat(1.0 / 2 ** level, device=intrinsic_matrix.device)
        @ intrinsic_matrix
        for level in range(n_pyramid_levels)])  # [L, N, 3, 3]
    k_sel = k_levels[i_levels, torch.arange(len(i_levels), device=i_levels.device)]
    return i_levels, k_sel


def warp_coords(new_invprojmat: torch.Tensor, intrinsic_matrix: torch.Tensor,
                distortion_coeffs: torch.Tensor,
                output_shape: Tuple[int, int]) -> torch.Tensor:
    """Source-image pixel coordinates [N, oh, ow, 2] of every output pixel:
    ray = new_invprojmat @ (x, y, 1); src = K @ homog(distort(project(ray)))."""
    oh, ow = output_shape
    dev = new_invprojmat.device
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev),
                            indexing='ij')
    m = new_invprojmat.float()[:, :, :, None, None]  # [N, 3, 3, 1, 1]
    rx = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]
    ry = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    rz = m[:, 2, 0] * xs + m[:, 2, 1] * ys + m[:, 2, 2]
    projected = torch.stack([rx / rz, ry / rz], dim=-1)
    distorted = distortion_ops.distort_points(
        projected, distortion_coeffs[:, None, None, :])
    xd, yd = distorted[..., 0], distorted[..., 1]
    k = intrinsic_matrix.float()[:, :, :, None, None]
    xi = k[:, 0, 0] * xd + k[:, 0, 1] * yd + k[:, 0, 2]
    yi = k[:, 1, 0] * xd + k[:, 1, 1] * yd + k[:, 1, 2]
    return torch.stack([xi, yi], dim=-1)


def build_flat_pyramid(images: torch.Tensor, n_levels: int):
    """Box-filter pyramid of NHWC float images with 1 px zero borders,
    flattened pixel-major into one [n_images * per_image_len, C] buffer.
    Returns (flat, level_info [(offset, padded_h, padded_w)], per_image_len)."""
    n, h, w, c = images.shape
    flats = []
    level_info = []
    offset = 0
    cur = images
    for level in range(n_levels):
        if level > 0:
            cur = avg_pool_nxn(cur, 2)
        padded = F.pad(cur, (0, 0, 1, 1, 1, 1))
        hp, wp = padded.shape[1], padded.shape[2]
        level_info.append((offset, hp, wp))
        flats.append(padded.reshape(n, hp * wp, c))
        offset += hp * wp
    flat = torch.cat(flats, dim=1).reshape(n * offset, c)
    return flat, level_info, offset


def bilinear_corners(base_offset: torch.Tensor, hp: torch.Tensor, wp: torch.Tensor,
                     coords_xy: torch.Tensor):
    """Flat pyramid index of the top-left tap [N, oh, ow] and the bilinear
    fractions fx, fy [N, oh, ow, 1] at `coords_xy` [N, oh, ow, 2] (unpadded
    source pixels) within each crop's padded level region (base_offset, hp,
    wp: [N]). The other taps are +1, +wp and +wp+1. Zero border via the zero
    ring; beyond it lookups replicate-clamp. A NaN coordinate samples the
    region's corner (a zero-ring pixel), as the kernel's fmaxf/fminf do."""
    wp_f = wp[:, None, None].float()
    hp_f = hp[:, None, None].float()
    clip = lambda v, hi: torch.minimum(torch.clamp(v, min=0.0), hi)
    x = clip(torch.nan_to_num(coords_xy[..., 0] + 1.0, nan=0.0), wp_f - 1.0)
    y = clip(torch.nan_to_num(coords_xy[..., 1] + 1.0, nan=0.0), hp_f - 1.0)
    x0 = clip(torch.floor(x), wp_f - 2.0)
    y0 = clip(torch.floor(y), hp_f - 2.0)
    idx00 = base_offset[:, None, None] + y0.long() * wp[:, None, None] + x0.long()
    return idx00, (x - x0)[..., None], (y - y0)[..., None]


def bilinear_gather_flat(flat: torch.Tensor, base_offset: torch.Tensor,
                         hp: torch.Tensor, wp: torch.Tensor,
                         coords_xy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples [N, oh, ow, C] of the flat pyramid [T, C] at
    `coords_xy`, with the taps and fractions of `bilinear_corners`."""
    idx00, fx, fy = bilinear_corners(base_offset, hp, wp, coords_xy)
    idx10 = idx00 + wp[:, None, None]
    top = flat[idx00] * (1 - fx) + flat[idx00 + 1] * fx
    bottom = flat[idx10] * (1 - fx) + flat[idx10 + 1] * fx
    return top * (1 - fy) + bottom * fy


def pyramid_warp_params(intrinsic_matrix: torch.Tensor, new_invprojmat: torch.Tensor,
                        distortion_coeffs: torch.Tensor, crop_scales: torch.Tensor,
                        image_ids: torch.Tensor, level_info: LevelInfo,
                        per_image_len: int):
    """Per-crop kernel inputs: params [N, 27] float32 and geom [N, 3] int64
    (see N_PARAMS, N_GEOM)."""
    i_levels, k_sel = select_pyramid_level(crop_scales, intrinsic_matrix,
                                           len(level_info))
    n = new_invprojmat.shape[0]
    params = torch.cat([
        new_invprojmat.reshape(n, 9).float(), k_sel[:, :2, :].reshape(n, 6).float(),
        distortion_ops.pad_distortion_coeffs(distortion_coeffs.float())], dim=1)
    info = torch.tensor(level_info, dtype=torch.int64, device=new_invprojmat.device)
    geom = info[i_levels]  # (offset, hp, wp) of the crop's level
    geom[:, 0] += image_ids.long() * per_image_len
    return params.contiguous(), geom.contiguous()


def warp_pyramid_coords(params: torch.Tensor, output_shape: Tuple[int, int]) -> torch.Tensor:
    """Source pixel coordinates [N, oh, ow, 2] of each output pixel from the
    per-crop `params` of `pyramid_warp_params`."""
    n = params.shape[0]
    invproj = params[:, :9].reshape(n, 3, 3)
    k = torch.cat([params[:, 9:15].reshape(n, 2, 3),
                   torch.tensor([0.0, 0.0, 1.0], device=params.device).expand(n, 1, 3)],
                  dim=1)
    return warp_coords(invproj, k, params[:, 15:], output_shape)


def warp_pyramid(flat: torch.Tensor, params: torch.Tensor, geom: torch.Tensor,
                 output_shape: Tuple[int, int]) -> torch.Tensor:
    """Plain version of the kernel: [N, oh, ow, C] crops from the flat
    pyramid, per-crop `params` and `geom` of `pyramid_warp_params`."""
    coords = warp_pyramid_coords(params, output_shape)
    return bilinear_gather_flat(flat, geom[:, 0], geom[:, 1], geom[:, 2], coords)


def warp_images_with_pyramid(
        images: torch.Tensor, intrinsic_matrix: torch.Tensor,
        new_invprojmat: torch.Tensor, distortion_coeffs: torch.Tensor,
        crop_scales: torch.Tensor, image_ids: torch.Tensor,
        output_shape: Tuple[int, int], n_pyramid_levels: int = 3) -> torch.Tensor:
    """Antialiased batched warp [N, oh, ow, C] with per-crop pyramid level,
    in plain PyTorch. `intrinsic_matrix` is each crop's original camera
    matrix [N, 3, 3]; `images` are float NHWC."""
    flat, level_info, per_image_len = build_flat_pyramid(images.float(), n_pyramid_levels)
    params, geom = pyramid_warp_params(intrinsic_matrix, new_invprojmat, distortion_coeffs,
                                       crop_scales, image_ids, level_info, per_image_len)
    return warp_pyramid(flat, params, geom, output_shape)
