"""The fused MBConv kernel (`csrc/mbconv.cu`) and its wrapper: the Hopper port
of the TPU kernel `metrabs_tpu/ops/mbconv_pallas.py::_kernel`.

`fused_mbconv_inner` is the wrapper: on CUDA tensors it launches the kernel
(or raises), on CPU tensors it runs the plain version
`ops.mbconv.fused_mbconv_inner`. It never falls back from one to the other.
`fused_mbconv_inner.launches` counts kernel launches, and
`fused_mbconv_inner.launches_by_shape` counts them per input shape and dtype.

The kernel is built at first use from `csrc/mbconv.cu` by `ops.cuda_build`.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from metrabs_tpu_torch.ops import cuda_build
from metrabs_tpu_torch.ops import mbconv as mbconv_ops

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library(csrc_dir: Path = cuda_build.CSRC_DIR, defines: Tuple[str, ...] = ()
             ) -> ctypes.CDLL:
    path, _ = cuda_build.build_library('mbconv', csrc_dir, defines)
    lib = ctypes.CDLL(str(path))
    fn = lib.metrabs_mbconv_inner
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fused_mbconv_inner(u: torch.Tensor, taps: torch.Tensor, sb: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """silu(BN1(dw3x3(silu(BN0(u))))) and its spatial mean, in one pass; the
    arguments (u, and the constants of `ops.mbconv.inner_constants`) and
    results of `ops.mbconv.fused_mbconv_inner`."""
    if u.device.type == 'cpu':
        return mbconv_ops.fused_mbconv_inner(u, taps, sb)
    if u.device.type != 'cuda':
        raise ValueError(f'fused_mbconv_inner runs on CPU or CUDA tensors, got {u.device}')
    if u.dtype not in _DTYPE_CODES:
        raise ValueError(f'u must be float32 or bfloat16, got {u.dtype}')
    if u.ndim != 4 or not u.is_contiguous() or u.data_ptr() % 16:
        raise ValueError(f'u must be a contiguous, 16-byte aligned [N, E, H, W] tensor, got '
                         f'{tuple(u.shape)}')
    n, e, h, w = u.shape
    for name, t, shape in (('taps', taps, (e, 9)), ('sb', sb, (4, e))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f'{name} must be a contiguous float32 {list(shape)} tensor, got '
                             f'{t.dtype} {tuple(t.shape)}')
        if t.device != u.device:
            raise ValueError(f'all arguments must be on {u.device}, {name} is on {t.device}')
    v = torch.empty_like(u)
    se_mean = torch.empty((n, e), dtype=torch.float32, device=u.device)
    if u.numel() == 0:
        return v, se_mean
    fn = _library().metrabs_mbconv_inner
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(_DTYPE_CODES[u.dtype], u.data_ptr(), taps.data_ptr(), sb.data_ptr(),
                 v.data_ptr(), se_mean.data_ptr(), n, e, h, w, stream)
    if err != 0:
        raise RuntimeError(f'mbconv kernel launch failed with CUDA error {err} '
                           f'(shape {tuple(u.shape)}, {u.dtype})')
    fused_mbconv_inner.launches += 1
    key = (n, e, h, w, str(u.dtype).removeprefix('torch.'))
    counts = fused_mbconv_inner.launches_by_shape
    counts[key] = counts.get(key, 0) + 1
    return v, se_mean


fused_mbconv_inner.launches = 0
fused_mbconv_inner.launches_by_shape = {}  # (N, E, H, W, dtype name) -> launches
