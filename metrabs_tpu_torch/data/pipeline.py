"""Host-side data pipeline (`metrabs_tpu/data/pipeline.py`): round-robin
dataset mixing, batching, a worker-pool batch loader, the reference's
section-size tables, and `device_prefetch`, which feeds batches to the card
ahead of the step.

Everything but `device_prefetch` is a copy of the JAX package's
framework-free code (tests/test_torch_standalone.py and
tests/test_torch_parallel.py hold it against the originals), the
multi-process `shard_example_stream` included.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, Sequence

import numpy as np
import torch

from metrabs_tpu_torch.parallel.mesh import LocalRows
from metrabs_tpu_torch.pipeline.estimator import checked_device


def roundrobin_iterate(
        example_lists: Sequence[Sequence], section_sizes: Sequence[int],
        rng: np.random.Generator) -> Iterator:
    """Yields examples so every consecutive `sum(section_sizes)` block draws
    `section_sizes[i]` items from dataset i (shuffled, looping forever) —
    the reference's round-robin batch composition (`main.py:308-363`)."""
    for i, lst in enumerate(example_lists):
        if len(lst) == 0 and i < len(section_sizes) and section_sizes[i] > 0:
            # An empty cycle would busy-loop forever at the first draw.
            raise ValueError(
                f'round-robin section {i} is empty but must contribute '
                f'{section_sizes[i]} examples per block')

    def shuffled_cycle(examples, seed):
        local_rng = np.random.default_rng(seed)
        while True:
            order = local_rng.permutation(len(examples))
            for i in order:
                yield examples[i]

    iters = [shuffled_cycle(lst, rng.integers(1 << 31))
             for lst in example_lists]
    while True:
        for it, size in zip(iters, section_sizes):
            for _ in range(size):
                yield next(it)


def batch_dicts(dicts: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}


def shard_example_stream(example_iter: Iterator, global_block: int,
                         process_index: int, process_count: int) -> Iterator:
    """Multi-host data sharding: every process runs the SAME round-robin
    stream (same seed) and consumes only its `global_block/process_count`
    slice of each global block, so the assembled global batch
    (make_array_from_process_local_data) holds `global_block` DISTINCT
    examples with the round-robin composition intact — not process_count
    duplicates of one local stream."""
    if global_block % process_count:
        raise ValueError(
            f'global block {global_block} must divide process count '
            f'{process_count}')
    local = global_block // process_count
    lo = process_index * local
    while True:
        block = list(itertools.islice(example_iter, global_block))
        if len(block) < global_block:
            yield from block[lo:lo + local]
            return
        yield from block[lo:lo + local]


class ParallelBatchLoader:
    """Maps `load_fn(example, rng)` over an example stream with a worker pool
    and yields stacked batches.

    Uses threads by default (load functions that spend their time in numpy
    release the GIL); pass use_processes=True for pickleable load functions
    when Python-level parallelism is needed.
    """

    def __init__(self, load_fn: Callable, example_iter: Iterator,
                 batch_size: int, *, n_workers: int = 8, seed: int = 0,
                 use_processes: bool = False, prefetch_batches: int = 2):
        if batch_size < 1:
            raise ValueError(f'batch_size must be >= 1, got {batch_size}')
        self._load_fn = load_fn
        self._examples = example_iter
        self._batch_size = batch_size
        self._seed_counter = itertools.count(seed)
        pool_cls = ProcessPoolExecutor if use_processes else ThreadPoolExecutor
        self._pool = pool_cls(n_workers)
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch_batches)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded-queue put that aborts when close() is called — a plain
        put() would block forever on a full queue after the consumer stops,
        leaking the producer thread and its pool."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self):
        try:
            exhausted = False
            while not self._stop.is_set() and not exhausted:
                examples = []
                for _ in range(self._batch_size):
                    try:
                        examples.append(next(self._examples))
                    except StopIteration:
                        exhausted = True
                        break
                if examples:
                    rngs = [np.random.default_rng(next(self._seed_counter))
                            for _ in examples]
                    loaded = list(self._pool.map(self._load_fn, examples, rngs))
                    if not self._put(batch_dicts(loaded)):
                        return
            self._put(None)
        except Exception as e:  # surface worker errors to the consumer
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._queue.get()
        if item is None or isinstance(item, Exception):
            # Terminal either way: the producer exits after posting it, so
            # mark the stream closed instead of blocking future gets.
            self._stop.set()
            if item is None:
                raise StopIteration
            raise item
        return item

    def close(self):
        self._stop.set()
        self._pool.shutdown(wait=False, cancel_futures=True)


def device_prefetch(batch_iter: Iterable[Dict[str, np.ndarray]], device='cuda',
                    depth: int = 2, local_rows: bool = False
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """The batches of `batch_iter` (dicts of numpy arrays) as dicts of tensors
    on `device`, with `depth` batches in flight so that host loading
    overlaps the step. On a CUDA device each array is pinned and copied
    with `non_blocking=True` on a side stream; the consumer's stream waits
    on the copy's event before the batch is handed out. Raises at the call
    where CUDA is not available and no other device was named.

    Under several processes each rank feeds its own rows of the global
    batch to its own device: with `local_rows` the batches are yielded as
    `parallel.mesh.LocalRows`, which a sharded step takes as this rank's
    rows (JAX's `make_array_from_process_local_data`)."""
    device = checked_device(device)
    if device.type != 'cuda':
        out = ({k: torch.as_tensor(v, device=device) for k, v in batch.items()}
               for batch in batch_iter)
    else:
        out = _cuda_prefetch(iter(batch_iter), device, depth)
    return (LocalRows(b) for b in out) if local_rows else out


def _cuda_prefetch(it: Iterator, device: torch.device, depth: int):
    stream = torch.cuda.Stream(device)

    def put(batch):
        with torch.cuda.stream(stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
                device, non_blocking=True) for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def take(item):
        out, event = item
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in out.values():
            t.record_stream(current)  # allocated on the side stream, used on this one
        return out

    buf = collections.deque()
    for batch in it:
        buf.append(put(batch))
        if len(buf) > depth:
            yield take(buf.popleft())
    while buf:
        yield take(buf.popleft())


# Reference section-size tables for the multi-dataset mixtures
# (`main.py:308-363`): per-batch example counts keyed by dataset-name prefix,
# preserved verbatim for config parity with the published training recipes.
ROUNDROBIN_SECTIONS = {
    'huge8': {
        'h36m_': 4, 'muco_downscaled': 6, 'humbi': 5, '3doh_down': 3, 'agora': 3,
        'surreal': 5, 'panoptic_': 7, 'aist_': 6, 'aspset_': 4, 'gpa_': 4,
        '3dpeople': 4, 'sailvos': 5, 'bml_movi': 5, 'mads_down': 2, 'umpm_down': 2,
        'bmhad_down': 3, '3dhp_full_down': 3, 'totalcapture': 3,
        'jta_down': 3, 'ikea_down': 2, 'human4d': 1,
        'behave_down': 3, 'rich_down': 4, 'spec_down': 2,
        'fit3d_': 2, 'chi3d_': 1, 'humansc3d_': 1, 'hspace_': 3},
    'medium3': {
        'h36m_': 9, 'muco_downscaled': 9, 'humbi': 7, 'agora': 5,
        'surreal': 8, 'panoptic_': 9, 'aist_': 9,
        '3dpeople': 6, 'sailvos': 7, 'totalcapture': 5,
        'jta_down': 5, '3dhp_full_down': 5, 'rich_down': 7, 'hspace_': 5},
    'small5': {'surreal': 32, 'h36m': 32, 'muco_downscaled': 32},
    'huge2d': {'mpii_down': 8, 'coco_down': 8, 'jrdb_down': 8,
               'posetrack_down': 8},
}


def huge2d_sections(n_pieces: int) -> Dict[str, int]:
    """The reference's 2D-mixture divisibility tweaks (`main.py:344-356`):
    when the total batch must divide grad_accum_steps * n_replicas pieces,
    the huge2d counts are nudged (33 examples for 3 pieces, 30 for 6;
    default 32)."""
    if n_pieces == 3:
        return {'mpii_down': 8, 'coco_down': 9, 'jrdb_down': 8,
                'posetrack_down': 8}
    if n_pieces == 6:
        return {'mpii_down': 8, 'coco_down': 8, 'jrdb_down': 7,
                'posetrack_down': 7}
    return dict(ROUNDROBIN_SECTIONS['huge2d'])


def build_dataset_sections(examples, section_prefixes: Sequence[str]):
    """Partitions examples into sections by image-path substring match
    (`main.py:364-373`): an example goes to the FIRST section whose name
    (exact substring, trailing underscores significant — the reference's
    routing) occurs in its lowercased path; an unmatched example raises,
    as in the reference, instead of silently shrinking the dataset."""
    sections = {name: [] for name in section_prefixes}
    for ex in examples:
        path = getattr(ex, 'image_path', '').lower()
        for name in section_prefixes:
            if name in path:
                sections[name].append(ex)
                break
        else:
            raise RuntimeError(f'No section for {path!r}')
    return [sections[name] for name in section_prefixes]
