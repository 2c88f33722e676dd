"""The device mesh and the collectives of multi-GPU training and serving
(`metrabs_tpu/parallel/mesh.py`, over `torch.distributed` instead of a
`jax.sharding.Mesh`).

The model of execution is SPMD over processes: one process per GPU, rank
`r` driving `cuda:LOCAL_RANK`, every rank running the same program. The
mesh is a `DeviceMesh` of shape (n_data, n_model) named ('data', 'model'),
in `make_mesh`'s `reshape(n_data, n_model)` order: rank = d * n_model + m.

JAX's GSPMD inserts the collectives of a sharded program; here they are
written where they fall:

 - data parallelism (`BatchLayout`, active inside `data_parallel`): every
   rank holds its rows of the global batch, the train-mode BatchNorms
   all-reduce their per-group sums over 'data' (`all_reduce_sum`: its
   backward all-reduces too, as each rank's rows feed the statistics),
   the losses' batch means reduce their sums over 'data'
   (`all_reduce_replicated`: its backward is the identity, as every rank
   computes the whole loss from the reduced sums), random draws are made
   for the global batch and sliced (`BatchLayout.rand`), and the
   parameters' gradients are summed over 'data' before the update, which
   every rank then applies alike;
 - tensor parallelism (`shard_module`): a convolution whose weight
   `tp_shardings` shards keeps the out-channel slice of its rank on
   'model' and runs column-parallel (`column_parallel_conv2d`): its input
   is replicated over 'model' (`TensorParallel.copy_in`: identity forward,
   all-reduce backward), its output all-gathered along channels
   (`TensorParallel.gather`: its backward takes the rank's own slice, since
   the loss is replicated over 'model'; an all-gather's own backward would
   sum the n_model equal copies), and its weight gradient stays local. A depthwise convolution takes its input's
   channel slice. Adam's moments and the EMA keep the same slices
   (`train.loop.shard_train_state`).

The backend: NCCL where every rank has a card of its own, gloo on the CPU,
and gloo on CUDA tensors where ranks share one card. A backend that fails
to start raises; nothing switches to another one.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor.placement_types import Replicate, Shard

DATA_AXIS = 'data'
MODEL_AXIS = 'model'
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)
_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')


def default_backend(device) -> str:
    """'nccl' for a CUDA device, 'gloo' for the CPU."""
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def init_distributed(backend: Optional[str] = None, device=None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Tuple[int, int, int]:
    """Joins the process group from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), the counterpart of
    `jax.distributed.initialize()`. `device` defaults to `cuda:LOCAL_RANK`
    where CUDA is available, else the CPU; `backend` to
    `default_backend(device)`. With NCCL the rank's card becomes the current
    device. Prints the backend; raises where the environment is incomplete
    or the backend is not available. Returns (rank, world size, local
    rank)."""
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f'--distributed needs the environment torchrun sets; {missing} '
                           f'missing (run under torchrun --nproc-per-node N)')
    rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    local_rank = int(os.environ['LOCAL_RANK'])
    if device is None:
        device = f'cuda:{local_rank}' if torch.cuda.is_available() else 'cpu'
    backend = backend or default_backend(device)
    init_process_group(backend, f'tcp://{os.environ["MASTER_ADDR"]}:{os.environ["MASTER_PORT"]}',
                       rank, world, device=device, timeout=timeout)
    return rank, world, local_rank


def init_process_group(backend: str, init_method: str, rank: int, world_size: int,
                       device=None, timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """`dist.init_process_group` with the backend checked first: NCCL
    where this torch has none raises (no switch to gloo). With NCCL the
    rank's card (`device`) becomes the current device."""
    if backend == 'nccl':
        if not (dist.is_nccl_available() and torch.cuda.is_available()):
            raise RuntimeError('the NCCL backend is not available in this torch build or '
                               'without CUDA; pass backend=\'gloo\' to use gloo')
        torch.cuda.set_device(torch.device(device if device is not None else 'cuda'))
    elif backend == 'gloo' and not dist.is_gloo_available():
        raise RuntimeError('the gloo backend is not available in this torch build')
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    print(f'rank {rank} of {world_size}: torch.distributed backend {backend}', flush=True)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> DeviceMesh:
    """The ('data', 'model') mesh over every rank of the process group
    (`init_distributed` or `init_process_group` first). Raises where
    n_data * n_model is not the world size."""
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs a process group: call init_distributed() (under '
                           'torchrun) or init_process_group() first')
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_data * n_model != world:
        raise ValueError(f'a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks; the '
                         f'process group has {world}')
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return DeviceMesh(device_type, torch.arange(world).reshape(n_data, n_model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


# Placements, per mesh dim ('data', 'model'), as DTensor writes them.

def batch_sharding(mesh: DeviceMesh):
    """Leading (batch) axis sharded over 'data'."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh):
    return (Replicate(), Replicate())


def stream_batch_sharding(mesh: DeviceMesh):
    """[K, B, ...] stream layout: K replicated, the frame batch sharded
    over 'data'."""
    return (Shard(1), Replicate())


def tp_sharding(mesh: DeviceMesh):
    """A leaf's out-channel dim (dim 0 in torch's layouts) over 'model'."""
    return (Replicate(), Shard(0))


class LocalRows(dict):
    """A batch (dict of arrays or tensors) that already holds this rank's
    rows of the global batch, as `data.pipeline.device_prefetch` yields it
    under several processes (JAX's `make_array_from_process_local_data`):
    `shard_batch` leaves it as it is."""


def _rows(x, n_data: int, index: int, dim: int):
    n = x.shape[dim]
    if n % n_data:
        spec = ('data',) if dim == 0 else (None, 'data')
        raise ValueError(
            f'One of the arguments was given the sharding {spec}, which implies that the '
            f'global size of its dimension {dim} should be divisible by {n_data}, but it is '
            f'equal to {n} (full shape: {tuple(x.shape)})')
    local = n // n_data
    index_ = (slice(None),) * dim + (slice(index * local, (index + 1) * local),)
    return x[index_]


def shard_batch(mesh: DeviceMesh, tree, placements=None):
    """This rank's rows of every array or tensor in `tree` (a dict, list or
    tuple of them, or one): the leading dim (the frame batch dim of a
    stream with `stream_batch_sharding`) split in n_data equal blocks.
    A dim that n_data does not divide raises ValueError, as JAX's
    `device_put` does. `LocalRows` pass unchanged."""
    if isinstance(tree, LocalRows):
        return tree
    dim = (placements or batch_sharding(mesh))[0].dim
    n_data, index = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)
    return _map(lambda x: _rows(x, n_data, index, dim), tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def replicate(mesh: DeviceMesh, tree):
    """`tree`'s tensors replaced in place by rank 0's (broadcast over every
    rank of the mesh); returns `tree`."""
    def bcast(t):
        if isinstance(t, torch.Tensor):
            host = t.detach().to('cpu', copy=True) if _via_host(t, None) else t
            dist.broadcast(host, src=int(mesh.mesh.flatten()[0]))
            if host is not t:
                t.copy_(host)
        return t
    with torch.no_grad():
        _map(bcast, tree)
    return tree


def tp_shardings(mesh: DeviceMesh, tree, min_size: int = 2 ** 16):
    """Tensor-parallel placements: an array or tensor leaf with ndim >= 2, at least
    `min_size` elements and an out-channel dim divisible by the mesh's
    'model' extent is sharded over 'model' on that dim (dim 0: a conv
    weight is [O, I, kh, kw], a linear one [out, in]; JAX's rule reads
    shape[-1] of HWIO and [in, out]); every other leaf is replicated.

    `tree`: a module or a `train.loop.TrainState` (-> {parameter name:
    placements}; Adam's moments and the EMA mirror the parameters, so the
    same placements hold for the whole train state), or a dict, list or
    tuple of arrays or tensors (-> the same structure of placements)."""
    n_model = axis_size(mesh, MODEL_AXIS)

    def sh(x):
        if (n_model > 1 and hasattr(x, 'ndim') and x.ndim >= 2
                and int(np.prod(x.shape)) >= min_size and x.shape[0] % n_model == 0):
            return tp_sharding(mesh)
        return replicated(mesh)

    model = getattr(tree, 'model', tree)
    if isinstance(model, nn.Module):
        return {n: sh(p) for n, p in model.named_parameters()}
    return _map(sh, tree)


def sharded_names(shardings: Dict) -> list:
    """The names whose placements shard over 'model'."""
    return [n for n, p in shardings.items() if isinstance(p[1], Shard)]


def is_sharded(t: torch.Tensor) -> bool:
    """Whether `t` is a model-sharded parameter of `shard_module`."""
    return getattr(t, '_tp_full_shape', None) is not None


# The collectives. Every one goes through `all_reduce_tensor` or
# `all_gather_tensors`; gloo on CUDA tensors (ranks sharing one card) goes
# through host copies.

def _via_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == 'gloo'


def all_reduce_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: `x` summed over `group` (no gradient)."""
    if _via_host(x, group):
        out = x.detach().to('cpu', copy=True)
        dist.all_reduce(out, group=group)
        return out.to(x.device)
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather_tensors(x: torch.Tensor, group, n: int) -> list:
    """The `n` ranks' equal-shaped `x` in rank order (no gradient)."""
    device, host = x.device, _via_host(x, group)
    x = (x.detach().to('cpu', copy=True) if host else x.detach()).contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return [p.to(device) for p in parts] if host else parts


class _AllReduceSum(torch.autograd.Function):
    """Sum over `group`; the backward sums the gradients over `group` too
    (each rank's inputs feed every rank's use of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_tensor(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_tensor(grad, ctx.group), None


class _AllReduceReplicated(torch.autograd.Function):
    """Sum over `group` whose consumer runs alike on every rank: the
    backward passes the gradient through."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_tensor(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the partial input gradients of
    the 'model' ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_tensor(grad, ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along `dim` over the 'model' ranks (rank order); the
    backward takes this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, dim, n, index):
        ctx.dim, ctx.n, ctx.index = dim, n, index
        return torch.cat(all_gather_tensors(x, group, n), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, dim=ctx.dim)[ctx.index].contiguous(), None, None, None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def all_reduce_replicated(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceReplicated.apply(x, group)


def all_gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ranks' equal-shaped `x` concatenated on dim 0, in rank order (no
    gradient)."""
    return torch.cat(all_gather_tensors(x, group, n))


class TensorParallel:
    """The 'model' group of a sharded module: its size and this rank's
    index in it."""

    def __init__(self, group, n: int, index: int):
        self.group, self.n, self.index = group, n, index

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self.group) if torch.is_grad_enabled() else x

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherFromModel.apply(x, self.group, dim, self.n, self.index)

    def local_slice(self, full: int) -> slice:
        k = full // self.n
        return slice(self.index * k, (self.index + 1) * k)


def column_parallel_conv2d(conv, x: torch.Tensor, stride, dilation) -> torch.Tensor:
    """`common.Conv2d.forward` of a module whose weight holds this rank's
    out-channel slice (`shard_module`): the slice's conv (a depthwise conv
    on its input's channel slice), the outputs all-gathered along channels,
    then the bias."""
    tp = conv.tp
    full_out = conv.weight._tp_full_shape[0]
    sl = tp.local_slice(full_out)
    x = tp.copy_in(x)
    groups = conv.groups
    if groups != 1:
        if groups != full_out or conv.in_channels != full_out:
            raise NotImplementedError('tensor parallelism shards dense and depthwise '
                                      'convolutions only')
        x = x[:, sl]
        groups = sl.stop - sl.start
    y = tp.gather(F.conv2d(x, conv.weight.to(x.dtype), None, stride or conv.stride,
                           conv.padding, dilation or conv.dilation, groups), 1)
    # The bias is replicated: added to the gathered output, every rank's
    # bias gets the whole gradient.
    return y if conv.bias is None else y + conv.bias.to(y.dtype).reshape(1, -1, 1, 1)


def shard_module(module: nn.Module, mesh: DeviceMesh, shardings: Dict) -> list:
    """Makes `module` tensor-parallel over `mesh`'s 'model' axis, in place:
    each parameter that `shardings` ({name: placements}, from
    `tp_shardings`) shards on dim 0 is replaced by this rank's slice (its
    full shape kept as `_tp_full_shape`), and its convolution runs
    column-parallel (`column_parallel_conv2d`). Only the weights of
    `common.Conv2d` modules shard; another sharded parameter raises.
    Returns the names of the sharded parameters."""
    from metrabs_tpu_torch.models.backbones.common import Conv2d
    names = sharded_names(shardings)
    if not names:
        return []
    tp = TensorParallel(axis_group(mesh, MODEL_AXIS), axis_size(mesh, MODEL_AXIS),
                        axis_index(mesh, MODEL_AXIS))
    modules = dict(module.named_modules())
    for name in names:
        owner_name, _, leaf = name.rpartition('.')
        owner = modules[owner_name]
        if not isinstance(owner, Conv2d) or leaf != 'weight':
            raise NotImplementedError(f'{name}: only convolution weights shard over '
                                      f'{MODEL_AXIS!r}')
        p = getattr(owner, leaf)
        if is_sharded(p):
            continue
        new = nn.Parameter(p.detach()[tp.local_slice(p.shape[0])].clone(),
                           requires_grad=p.requires_grad)
        new._tp_full_shape = tuple(p.shape)
        setattr(owner, leaf, new)
        owner.tp = tp
    return names


def gather_leaf(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The full tensor of a model-sharded leaf (all-gathered over
    'model' on dim 0); a collective: every rank of the group calls it."""
    return all_gather_rows(t.detach(), axis_group(mesh, MODEL_AXIS),
                           axis_size(mesh, MODEL_AXIS))


def gather_named(tree: Dict[str, torch.Tensor], sharded: Iterable[str],
                 mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """`tree` with its `sharded` entries gathered (`gather_leaf`), in the
    order of `sharded` on every rank."""
    sharded = set(sharded)
    return {k: gather_leaf(v, mesh) if k in sharded else v for k, v in tree.items()}


def slice_leaf(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's 'model' slice of a full leaf on dim 0."""
    n, index = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
    k = t.shape[0] // n
    return t[index * k:(index + 1) * k].clone()


# Data parallelism: the layout of the global batch over the 'data' ranks.

class BatchLayout:
    """How the global batch of a data-parallel step lies over the 'data'
    ranks: the global batch is the concatenation of `parts` (e.g. the 3D
    and the 2D batch, `global_sizes`), each split in n_data equal blocks,
    and this rank holds block `index` of each, concatenated in part
    order. `rows` are the global indices of this rank's rows."""

    def __init__(self, mesh: DeviceMesh, local_sizes: Sequence[int]):
        self.mesh = mesh
        self.n_data = axis_size(mesh, DATA_AXIS)
        self.index = axis_index(mesh, DATA_AXIS)
        self.group = axis_group(mesh, DATA_AXIS)
        self.local_sizes = tuple(int(n) for n in local_sizes)
        self.global_sizes = tuple(n * self.n_data for n in self.local_sizes)
        self.n_local, self.n_global = sum(self.local_sizes), sum(self.global_sizes)
        offsets = np.cumsum((0,) + self.global_sizes[:-1])
        self.rows = torch.as_tensor(np.concatenate([
            np.arange(off + self.index * n, off + (self.index + 1) * n)
            for off, n in zip(offsets, self.local_sizes)]), dtype=torch.long)

    @property
    def distributed(self) -> bool:
        """Whether the statistics need collectives (more than one 'data'
        rank)."""
        return self.n_data > 1

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor over the global batch."""
        if x.shape[0] != self.n_global:
            raise ValueError(f'expected {self.n_global} global rows, got {x.shape[0]}')
        return x[self.rows.to(x.device)]

    def rand(self, generator: Optional[torch.Generator], device,
             trailing: Tuple[int, ...] = ()) -> torch.Tensor:
        """This rank's rows of `torch.rand((n_global, *trailing))` drawn
        from `generator`: every rank draws alike and keeps its own."""
        return self.take(torch.rand((self.n_global,) + tuple(trailing), generator=generator,
                                    device=device))

    def reduce_gradients(self, grads: Dict[str, torch.Tensor]) -> None:
        """Sums the gradients over 'data' in place (one flat all-reduce per
        dtype)."""
        by_dtype = {}
        for g in grads.values():
            by_dtype.setdefault(g.dtype, []).append(g)
        for tensors in by_dtype.values():
            flat = all_reduce_tensor(torch.cat([t.reshape(-1) for t in tensors]), self.group)
            offset = 0
            for t in tensors:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


_ACTIVE: Optional[BatchLayout] = None


def active_layout() -> Optional[BatchLayout]:
    """The layout of the data-parallel step running, or None."""
    return _ACTIVE


@contextlib.contextmanager
def data_parallel(layout: BatchLayout):
    """Within: the train-mode BatchNorms, the losses' batch means and the
    batch's random draws follow `layout`."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, layout
    try:
        yield layout
    finally:
        _ACTIVE = saved


def batch_rand(n: int, generator: Optional[torch.Generator], device,
               trailing: Tuple[int, ...] = ()) -> torch.Tensor:
    """`torch.rand((n, *trailing), generator)` over this rank's `n` rows of
    the batch: under a data-parallel layout the draw of the global batch,
    sliced (`BatchLayout.rand`)."""
    layout = _ACTIVE
    if layout is not None and layout.distributed and n == layout.n_local:
        return layout.rand(generator, device, trailing)
    return torch.rand((n,) + tuple(trailing), generator=generator, device=device)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` (a sum over this rank's rows) summed over the 'data' ranks of
    the active layout, for a consumer that every rank computes alike (the
    losses); `x` itself without one."""
    layout = _ACTIVE
    if layout is None or not layout.distributed:
        return x
    return all_reduce_replicated(x, layout.group)
