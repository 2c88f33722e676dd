"""The fused MBConv kernel (`csrc/mbconv.cu`) and its wrapper: the Hopper port
of the TPU kernel `metrabs_tpu/ops/mbconv_pallas.py::_kernel`.

`fused_mbconv_inner` is the wrapper: on CUDA tensors it launches the kernel
(or raises), on CPU tensors it runs the plain version
`ops.mbconv.fused_mbconv_inner`. It never falls back from one to the other.
`fused_mbconv_inner.launches` counts kernel launches.

The kernel is built at first use from `csrc/mbconv.cu` by `ops.cuda_build`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from metrabs_tpu_torch.ops import cuda_build
from metrabs_tpu_torch.ops import mbconv as mbconv_ops

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path, _ = cuda_build.build_library('mbconv')
    lib = ctypes.CDLL(str(path))
    fn = lib.metrabs_mbconv_inner
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fused_mbconv_inner(u: torch.Tensor, dw_weight: torch.Tensor,
                       scale0: torch.Tensor, bias0: torch.Tensor,
                       scale1: torch.Tensor, bias1: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """silu(BN1(dw3x3(silu(BN0(u))))) and its spatial mean, in one pass; the
    arguments and results of `ops.mbconv.fused_mbconv_inner`."""
    if u.device.type == 'cpu':
        return mbconv_ops.fused_mbconv_inner(u, dw_weight, scale0, bias0, scale1, bias1)
    if u.device.type != 'cuda':
        raise ValueError(f'fused_mbconv_inner runs on CPU or CUDA tensors, got {u.device}')
    if u.dtype not in _DTYPE_CODES:
        raise ValueError(f'u must be float32 or bfloat16, got {u.dtype}')
    if u.ndim != 4 or not u.is_contiguous():
        raise ValueError(f'u must be a contiguous [N, E, H, W] tensor, got {tuple(u.shape)}')
    n, e, h, w = u.shape
    if tuple(dw_weight.shape) != (e, 1, 3, 3):
        raise ValueError(f'dw_weight must be [{e}, 1, 3, 3], got {tuple(dw_weight.shape)}')
    consts = (scale0, bias0, scale1, bias1)
    if any(c.shape != (e,) for c in consts):
        raise ValueError(f'BN constants must be [{e}], got {[tuple(c.shape) for c in consts]}')
    tensors = (dw_weight,) + consts
    if any(t.device != u.device for t in tensors):
        raise ValueError(f'all arguments must be on {u.device}')
    taps = dw_weight.float().reshape(e, 9).contiguous()
    sb = torch.stack(consts).float().contiguous()
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
    return v, se_mean


fused_mbconv_inner.launches = 0
