"""Tracing / profiling utilities (`metrabs_tpu/utils/profiling.py`), on
torch:

- `trace(logdir, record_shapes=False)`: context manager around
  `torch.profiler` writing a TensorBoard-loadable (Chrome trace) file of
  the host and, where there is a card, device execution (with each op's
  input shapes and strides where `record_shapes`);
- `StageTimer`: lightweight named-stage wall timing that fences the
  device's asynchronous work: the tensors a stage registers are waited for
  with CUDA synchronisation at its exit, where JAX calls
  `block_until_ready`;
- `annotate`: a `torch.profiler.record_function` range, so that pipeline
  stages show up named in profiler timelines.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


@contextlib.contextmanager
def trace(logdir: str, record_shapes: bool = False):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities, record_shapes=record_shapes,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    """Named region for profiler timelines (no-op cost when not tracing)."""
    return torch.profiler.record_function(name)


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of the tensors in `x` (a tensor or nested
    lists, tuples and dicts of them)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    return out


def block_until_ready(x):
    """Waits until the device work producing the tensors in `x` has
    finished (synchronising each CUDA device they live on); returns `x`."""
    for device in _cuda_devices(x, set()):
        torch.cuda.synchronize(device)
    return x


class _StageHandle:
    """Collects the tensors a timed block produces, to fence at block exit."""

    def __init__(self):
        self._fences = []

    def fence(self, x):
        """Registers `x` (a tensor or nested containers of them) to be waited
        for at stage exit and returns it unchanged: wrap the block's
        outputs."""
        self._fences.append(x)
        return x


class StageTimer:
    """Accumulates wall time per named stage, fencing asynchronous CUDA work.

    A CUDA call returns before the device finishes, so a stage must register
    its OUTPUTS for fencing: timing the launches alone reports ~nothing.
    Usage:

        timer = StageTimer()
        with timer.stage('warp') as s:
            crops = s.fence(warp(...))   # fenced at block exit
        ...
        print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        handle = _StageHandle()
        start = time.perf_counter()
        try:
            yield handle
        finally:
            for x in handle._fences:
                block_until_ready(x)
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f'{name}: {total * 1000:.2f} ms total, '
                         f'{total / n * 1000:.3f} ms/call ({n} calls)')
        return '\n'.join(lines)
