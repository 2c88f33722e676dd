"""The port's profiling utilities (`metrabs_tpu_torch/utils/profiling.py`)
against `metrabs_tpu/utils/profiling.py`: `StageTimer` gives JAX's report
on the same stages and clock, fences the tensors a stage registers (CUDA
synchronisation per device, where JAX calls `block_until_ready`),
`annotate` names a range in the profiler's events and `trace` writes a
trace file."""

import itertools

import numpy as np
import pytest
import torch

from metrabs_tpu.utils import profiling as jax_profiling
from metrabs_tpu_torch.utils import profiling


def timed(module, monkeypatch):
    """A StageTimer of `module` over fixed stages, on a clock that ticks
    0.7 ms per read, in the same sequence for both packages."""
    ticks = itertools.count()
    monkeypatch.setattr(module.time, 'perf_counter', lambda: next(ticks) * 7e-4)
    timer = module.StageTimer()
    for name in ('warp', 'crop_model', 'warp', 'nms', 'warp'):
        with timer.stage(name) as s:
            out = s.fence({'x': [np.zeros(2)]})
            assert isinstance(out, dict)
    return timer


def test_stage_timer_reports_as_jax(monkeypatch):
    ours, theirs = timed(profiling, monkeypatch), timed(jax_profiling, monkeypatch)
    assert dict(ours.counts) == dict(theirs.counts) == {'warp': 3, 'crop_model': 1, 'nms': 1}
    assert ours.report() == theirs.report()
    assert ours.report().splitlines()[0].startswith('warp: ')


def test_stage_timer_counts_a_stage_that_raises():
    timer = profiling.StageTimer()
    with pytest.raises(ZeroDivisionError):
        with timer.stage('bad'):
            1 / 0
    assert timer.counts['bad'] == 1 and timer.totals['bad'] >= 0


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, for the fence's bookkeeping."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device('cuda', self._index)


def on_card(index: int) -> torch.Tensor:
    t = torch.Tensor._make_subclass(_OnCard, torch.zeros(2))
    t._index = index
    return t


def test_fence_synchronises_each_cuda_device_once(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda device=None: synced.append(device))
    timer = profiling.StageTimer()
    with timer.stage('s') as s:
        tree = {'a': [on_card(0), on_card(1)], 'b': (on_card(0), torch.ones(3)), 'c': 5}
        assert s.fence(tree) is tree
    assert sorted(d.index for d in synced) == [0, 1]
    synced.clear()
    with timer.stage('cpu') as s:
        s.fence(torch.ones(3))
    assert synced == [] and timer.counts == {'s': 1, 'cpu': 1}


def test_annotate_and_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate('metrabs_stage'):
            torch.ones(8).sum()
    traces = list(tmp_path.glob('*.json'))
    assert len(traces) == 1 and 'metrabs_stage' in traces[0].read_text()
    with torch.profiler.profile() as prof:
        with profiling.annotate('named_range'):
            torch.ones(4) * 2
    assert 'named_range' in {e.key for e in prof.key_averages()}
