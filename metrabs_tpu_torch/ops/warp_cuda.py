"""The crop-warp kernel (`csrc/warp.cu`) and its wrapper: the Hopper port of
the TPU kernel `metrabs_tpu/ops/warp_pallas.py::_warp_tile_kernel`.

`warp_pyramid` is the wrapper: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs the plain version `ops.warp.warp_pyramid`.
It never falls back from one to the other. `warp_pyramid.launches` counts
kernel launches.

The kernel is built at first use from `csrc/warp.cu` by `ops.cuda_build`
(nvcc into `metrabs_tpu_torch/_build/`, a plain C entry point loaded with
ctypes, keyed by a hash of the source and flags).

Precision: the four names of the TPU kernel are accepted ('highest'/'f32',
'high'/'bf16x3', 'bf16x2', 'default'/'bf16'); all of them compute in float32
here. The TPU's modes only trade MXU passes of its hat-weight matmul, which a
gather kernel does not have, so the bf16 names are more exact here than in
JAX (whose single-pass bf16 mode errs by up to ~8e-3).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from metrabs_tpu_torch.ops import cuda_build
from metrabs_tpu_torch.ops import warp as warp_ops

_MAX_CROPS = 65535  # grid.z limit

PRECISIONS = frozenset({'highest', 'f32', 'high', 'bf16x3', 'bf16x2', 'default', 'bf16'})


@functools.lru_cache(maxsize=None)
def _library(csrc_dir: Path = cuda_build.CSRC_DIR) -> ctypes.CDLL:
    path, _ = cuda_build.build_library('warp', csrc_dir)
    lib = ctypes.CDLL(str(path))
    fn = lib.metrabs_warp_pyramid_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int, last: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise ValueError(f'{name} must be {dtype}, got {t.dtype}')
    if t.ndim != ndim or t.shape[-1] != last:
        raise ValueError(f'{name} must be [..., {last}] of rank {ndim}, got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def warp_pyramid(flat: torch.Tensor, params: torch.Tensor, geom: torch.Tensor,
                 output_shape: Tuple[int, int], precision: str = 'highest') -> torch.Tensor:
    """Crops [N, oh, ow, 3] float32 from the flat pixel-major pyramid
    `flat` [T, 3] with the per-crop `params` [N, 27] and `geom` [N, 3] of
    `ops.warp.pyramid_warp_params`."""
    if precision not in PRECISIONS:
        raise ValueError(f'unknown warp precision {precision!r}; expected one of '
                         f"'highest'/'f32', 'high'/'bf16x3', 'bf16x2', 'default'/'bf16'")
    oh, ow = (int(s) for s in output_shape)
    if flat.device.type == 'cpu':
        return warp_ops.warp_pyramid(flat, params, geom, (oh, ow))
    if flat.device.type != 'cuda':
        raise ValueError(f'warp_pyramid runs on CPU or CUDA tensors, got {flat.device}')
    _check(flat, 'flat', torch.float32, 2, 3, flat.device)
    _check(params, 'params', torch.float32, 2, warp_ops.N_PARAMS, flat.device)
    _check(geom, 'geom', torch.int64, 2, warp_ops.N_GEOM, flat.device)
    n = params.shape[0]
    if geom.shape[0] != n:
        raise ValueError(f'params has {n} crops, geom {geom.shape[0]}')
    if n > _MAX_CROPS or oh <= 0 or ow <= 0:
        raise ValueError(f'unsupported warp shape: {n} crops of {oh}x{ow}')
    out = torch.empty((n, oh, ow, 3), dtype=torch.float32, device=flat.device)
    if n == 0:
        return out
    fn = _library().metrabs_warp_pyramid_f32
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = fn(flat.data_ptr(), flat.shape[0], params.data_ptr(), geom.data_ptr(),
                 out.data_ptr(), n, oh, ow, stream)
    if err != 0:
        raise RuntimeError(f'warp kernel launch failed with CUDA error {err}')
    warp_pyramid.launches += 1
    return out


warp_pyramid.launches = 0

