"""Parsing of torch.profiler's Chrome traces for the port's profiling
scripts (the counterpart of `scripts/_tracelib.py`).

`metrabs_tpu_torch.utils.profiling.trace(logdir)` writes one
`*.pt.trace.json[.gz]` per profile. This module loads the newest, takes the
device events (CUDA kernels, memcpys and memsets on the GPU streams), joins
each to the CPU op that launched it and sorts it into one of CATEGORIES, so
that the categories add up to the whole device time:

- `exclusive_durations` is `_tracelib.exclusive_op_durations`' rule over
  plain (name, ts, dur) spans of one thread: spans sorted by start, each
  child's duration subtracted from its innermost enclosing span. Kernels on
  a stream do not nest, but a stream also carries the GPU projections of
  `record_function` ranges, which do; those are left out, and the rule
  keeps any nesting that is left from counting twice;
- `device_events` joins a kernel to its launching op through the trace's
  `External id` (the innermost op open at the launch), falling back to the
  launch call's `correlation` and then to the op that encloses the launch
  call in time; each op's chain of enclosing ops and ranges comes along;
- `category` classifies by the launching op chain first and by the kernel's
  name second (cuDNN's kernel names change with the algorithm it picks);
- `summarise` gives the totals, the categories, the top kernels and the
  memory format of every convolution's input.
"""

from __future__ import annotations

import bisect
import collections
import glob
import gzip
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

K1_KERNELS = ('warp_pyramid_kernel',)
K2_KERNELS = ('mbconv_warp_kernel', 'mbconv_strip_kernel')
BN_LABEL = 'BatchNorm'  # the range `label_norm_modules` puts around each norm module

CONV, DEPTHWISE, K1, K2, BN, ELEMENTWISE, REDUCTION, LAYOUT, MEMCPY, NCCL, OTHER = CATEGORIES = (
    'conv/GEMM (cuDNN, cuBLAS)', 'depthwise conv', 'K1 warp_pyramid_kernel',
    'K2 mbconv_{warp,strip}_kernel', 'BatchNorm', 'elementwise and activations', 'reductions',
    'padding and layout', 'memcpy/memset', 'NCCL', 'other')

DEVICE_CATS = {'kernel': 'kernel', 'gpu_memcpy': 'memcpy', 'gpu_memset': 'memset'}
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
HOST_CATS = ('cpu_op', 'user_annotation')
CONV_OPS = ('aten::convolution', 'aten::convolution_backward')
GEMM_OPS = {'aten::mm', 'aten::addmm', 'aten::bmm', 'aten::baddbmm', 'aten::matmul',
            'aten::linear', 'aten::_scaled_mm', 'aten::addmv', 'aten::mv', 'aten::dot'}
BN_OPS = ('batch_norm', 'group_norm', 'layer_norm')
LAYOUT_OPS = {'aten::constant_pad_nd', 'aten::pad', 'aten::reflection_pad2d',
              'aten::replication_pad2d', 'aten::contiguous', 'aten::clone', 'aten::cat',
              'aten::stack', 'aten::copy_', 'aten::permute', 'aten::transpose',
              'aten::flip', 'aten::roll', 'aten::repeat', 'aten::expand_as',
              # metadata ops: no kernel of their own on the card, host time only
              'aten::view', 'aten::reshape', 'aten::_unsafe_view', 'aten::as_strided',
              'aten::slice', 'aten::narrow', 'aten::select', 'aten::expand', 'aten::squeeze',
              'aten::unsqueeze', 'aten::t', 'aten::detach', 'aten::alias', 'aten::unbind',
              'aten::split', 'aten::chunk', 'aten::empty', 'aten::empty_strided',
              'aten::empty_like', 'aten::resize_', 'aten::to', 'aten::lift_fresh'}
REDUCTION_OPS = {'aten::sum', 'aten::mean', 'aten::amax', 'aten::amin', 'aten::max',
                 'aten::min', 'aten::var', 'aten::std', 'aten::var_mean', 'aten::norm',
                 'aten::linalg_vector_norm', 'aten::softmax', 'aten::_softmax',
                 'aten::log_softmax', 'aten::_log_softmax', 'aten::logsumexp', 'aten::argmax',
                 'aten::argmin', 'aten::cumsum', 'aten::prod', 'aten::all', 'aten::any',
                 'aten::topk', 'aten::sort', 'aten::argsort', 'aten::_softmax_backward_data',
                 'aten::_foreach_norm'}
# Indexing, selection, random numbers and solvers: 'other'.
OTHER_OP_PREFIXES = tuple(f'aten::{k}' for k in (
    'index', 'gather', 'scatter', 'nonzero', 'masked', 'where', 'unique', 'arange', 'randperm',
    'rand', 'normal', 'bernoulli', 'linalg', '_linalg', 'lu', 'inverse', 'take', 'put'))
LAYOUT_NAMES = ('nchwtonhwc', 'nhwctonchw', 'transpose', 'pad', 'permute', 'cat_',
                'catarraybatched', 'copy')
NAME_RULES = ((CONV, ('gemm', 'xmma', 'cudnn', 'cutlass', 'implicit_convolve', 'winograd',
                      'sm90_', 'sm80_', 'conv2d', 'wgrad', 'dgrad', 'fprop')),
              (DEPTHWISE, ('depthwise',)),
              (BN, ('batch_norm', 'batchnorm', 'bn_fw', 'bn_bw')),
              (REDUCTION, ('reduce', 'softmax', 'argmax', 'topk', 'sort', 'scan')),
              (LAYOUT, LAYOUT_NAMES),
              (ELEMENTWISE, ('elementwise', 'vectorized', 'unrolled', 'foreach', 'multi_tensor',
                             'silu', 'sigmoid', 'activation')))


def card_name() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them ('not measured' without
    nvidia-smi)."""
    import subprocess
    try:
        smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return 'not measured'
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else 'not measured'


def times_ms(fn, device, n: int = 20, n_warm: int = 2) -> List[float]:
    """The times of `n` calls of `fn()` after `n_warm` warm-up calls: on the
    card, between CUDA events recorded around each call (each call waited
    for); elsewhere on the host's clock."""
    import time

    import torch

    for _ in range(n_warm):
        fn()
    times = []
    for _ in range(n):
        if torch.device(device).type == 'cuda':
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def load_latest_trace(outdir: str) -> Optional[list]:
    """The traceEvents of the newest `*.pt.trace.json[.gz]` under `outdir`
    (torch.profiler's tensorboard_trace_handler output), or None."""
    paths = [p for pattern in ('*.pt.trace.json', '*.pt.trace.json.gz')
             for p in glob.glob(os.path.join(outdir, '**', pattern), recursive=True)]
    if not paths:
        return None
    path = max(paths, key=os.path.getmtime)
    with (gzip.open(path, 'rt') if path.endswith('.gz') else open(path)) as f:
        return json.load(f).get('traceEvents', [])


def exclusive_durations(spans: Iterable[Tuple[str, float, float]]) -> List[Tuple[str, float]]:
    """[(name, exclusive dur)] of one thread's (name, ts, dur) spans:
    `_tracelib.exclusive_op_durations`' rule (sorted by start, longer first
    at equal starts; each span's duration less its children's, floored at
    0), in sorted order."""
    exclusive: List[List] = []
    stack: List[Tuple[float, int]] = []  # (end, index into exclusive)
    for name, ts, dur in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][0] <= ts:
            stack.pop()
        if stack:
            exclusive[stack[-1][1]][1] -= dur
        exclusive.append([name, dur])
        stack.append((ts + dur, len(exclusive) - 1))
    return [(name, max(dur, 0)) for name, dur in exclusive]


def _ancestry(host_events: List[dict]) -> Dict[int, Optional[dict]]:
    """{id(event): its innermost enclosing event} over host events, per
    (pid, tid)."""
    parent: Dict[int, Optional[dict]] = {}
    by_thread = collections.defaultdict(list)
    for e in host_events:
        by_thread[(e.get('pid'), e.get('tid'))].append(e)
    for thread_events in by_thread.values():
        thread_events.sort(key=lambda e: (e['ts'], -e.get('dur', 0)))
        stack: List[dict] = []
        for e in thread_events:
            while stack and stack[-1]['ts'] + stack[-1].get('dur', 0) <= e['ts']:
                stack.pop()
            parent[id(e)] = stack[-1] if stack else None
            stack.append(e)
    return parent


def _chain(op: Optional[dict], parent: Dict[int, Optional[dict]]) -> List[dict]:
    """`op` and its enclosing host events, innermost first."""
    chain = []
    while op is not None:
        chain.append(op)
        op = parent.get(id(op))
    return chain


class _Enclosing:
    """The innermost host event of a thread that contains a point in time."""

    def __init__(self, host_events: List[dict], parent: Dict[int, Optional[dict]]):
        self.parent = parent
        self.by_thread = collections.defaultdict(list)
        for e in host_events:
            self.by_thread[(e.get('pid'), e.get('tid'))].append(e)
        for thread_events in self.by_thread.values():
            thread_events.sort(key=lambda e: (e['ts'], -e.get('dur', 0)))
        self.starts = {k: [e['ts'] for e in v] for k, v in self.by_thread.items()}

    def at(self, thread, ts: float) -> Optional[dict]:
        k = bisect.bisect_right(self.starts.get(thread, []), ts)
        e = self.by_thread[thread][k - 1] if k else None
        while e is not None and e['ts'] + e.get('dur', 0) < ts:
            e = self.parent.get(id(e))
        return e


def device_events(events: List[dict]) -> List[dict]:
    """The trace's device events (CUDA kernels, memcpys, memsets; not the GPU
    projections of ranges), each as {name, kind, ts, dur, stream (pid,
    tid), ops: the launching op's chain, innermost first, as host events}."""
    host = [e for e in events if e.get('ph') == 'X' and e.get('cat') in HOST_CATS]
    parent = _ancestry(host)
    by_external = {}
    for e in host:
        ext = e.get('args', {}).get('External id')
        if ext is not None and e.get('cat') != 'user_annotation':
            by_external.setdefault(ext, e)
    launches = {e['args']['correlation']: e for e in events
                if e.get('ph') == 'X' and e.get('cat') in LAUNCH_CATS
                and 'correlation' in e.get('args', {})}
    enclosing = _Enclosing(host, parent)
    out = []
    for e in events:
        kind = DEVICE_CATS.get(e.get('cat'))
        if e.get('ph') != 'X' or kind is None:
            continue
        args = e.get('args', {})
        launch = launches.get(args.get('correlation'))
        ext = args.get('External id')
        if ext is None and launch is not None:
            ext = launch.get('args', {}).get('External id')
        op = by_external.get(ext)
        if op is None and launch is not None:
            op = enclosing.at((launch.get('pid'), launch.get('tid')), launch['ts'])
        out.append(dict(name=e.get('name', ''), kind=kind, ts=e['ts'], dur=e.get('dur', 0),
                        stream=(e.get('pid'), e.get('tid')), ops=_chain(op, parent)))
    return out


def host_op_events(events: List[dict]) -> List[dict]:
    """The trace's CPU ops in `device_events`' form (kind 'host op', each op
    its own launching op), for a run without device events: timed by their
    exclusive durations per thread, they cover the host's op time once."""
    host = [e for e in events if e.get('ph') == 'X' and e.get('cat') in HOST_CATS]
    parent = _ancestry(host)
    out = []
    for e in host:
        if e.get('cat') == 'user_annotation':
            continue
        out.append(dict(name=e.get('name', ''), kind='host op', ts=e['ts'], dur=e.get('dur', 0),
                        stream=(e.get('pid'), e.get('tid')), ops=_chain(e, parent)))
    return out


def _conv_shapes(op: dict) -> Tuple[Optional[list], Optional[list], Optional[list]]:
    """(input dims, input strides, weight dims) of an aten::convolution or
    aten::convolution_backward event recorded with shapes."""
    args = op.get('args', {})
    dims, strides = args.get('Input Dims') or [], args.get('Input Strides') or []
    i, w = (1, 2) if op['name'] == 'aten::convolution_backward' else (0, 1)
    get = lambda seq, k: seq[k] if len(seq) > k and seq[k] else None
    return get(dims, i), get(strides, i), get(dims, w)


def is_depthwise(conv_op: dict) -> bool:
    """A grouped convolution with one input channel per group (weight [O, 1,
    kh, kw]) over more than one channel."""
    x, _, w = _conv_shapes(conv_op)
    return bool(x and w and len(w) == 4 and w[1] == 1 and x[1] > 1)


def memory_format(conv_op: dict) -> str:
    """'NCHW contiguous', 'channels_last' or 'other' for the conv's input, or
    'not recorded' where the trace has no shapes."""
    x, strides, _ = _conv_shapes(conv_op)
    if not x or not strides or len(x) != 4:
        return 'not recorded'
    n, c, h, w = x
    if list(strides) == [c * h * w, h * w, w, 1]:
        return 'NCHW contiguous'
    if list(strides) == [h * w * c, 1, w * c, c]:
        return 'channels_last'
    return 'other'


def category(event: dict) -> str:
    """The category of a `device_events` entry: the kernels named by K1, K2
    and NCCL, memcpys and memsets, then the launching op (a convolution or
    GEMM op itself, then the norm ranges and ops anywhere in its chain, then
    the innermost op's kind: a bias add inside `aten::convolution` is
    elementwise), then the kernel's name."""
    name = event['name'].lower()
    if event['kind'] in ('memcpy', 'memset'):
        return MEMCPY
    if any(k.lower() in name for k in K1_KERNELS):
        return K1
    if any(k.lower() in name for k in K2_KERNELS):
        return K2
    if 'nccl' in name:
        return NCCL
    op_names = [op['name'] for op in event['ops']]
    innermost = op_names[0] if op_names else ''
    if innermost.startswith('aten::') and 'conv' in innermost:
        if any(k in name for k in ('nchwtonhwc', 'nhwctonchw')):
            return LAYOUT
        conv = next((op for op in event['ops'] if op['name'] in CONV_OPS), None)
        depthwise = any('conv_depthwise' in n for n in op_names) or (
            conv is not None and is_depthwise(conv))
        return DEPTHWISE if depthwise else CONV
    if innermost in GEMM_OPS:
        return CONV
    if any(n == BN_LABEL or any(b in n for b in BN_OPS) for n in op_names):
        return BN
    if op_names:
        if innermost in LAYOUT_OPS:
            return LAYOUT
        if innermost in REDUCTION_OPS:
            return REDUCTION
        if innermost.startswith('aten::'):
            return OTHER if innermost.startswith(OTHER_OP_PREFIXES) else ELEMENTWISE
    return next((cat for cat, keys in NAME_RULES if any(k in name for k in keys)), OTHER)


def busy_time(events: List[dict]) -> float:
    """The union of the device events' intervals (us): time in which the
    device ran at least one of them."""
    total, end = 0.0, None
    for e in sorted(events, key=lambda e: e['ts']):
        start, stop = e['ts'], e['ts'] + e['dur']
        if end is None or start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def summarise(events: List[dict], iters: int, top: int = 25) -> dict:
    """Per iteration, in ms: the device time (exclusive durations summed over
    the streams), the busy time (union of intervals), the time per category
    (CATEGORIES, each present) and the `top` kernels (by name and category:
    one kernel can run inside and outside a norm range) with their launches;
    plus the launches per category and the memory format of each
    convolution's input, by count (over all iterations). A trace without
    device events (a CPU run) is summarised over its host ops instead
    (`timeline` says which)."""
    dev = device_events(events)
    timeline = 'device' if dev else 'host ops'
    if not dev:
        dev = host_op_events(events)
    by_stream = collections.defaultdict(list)
    for i, e in enumerate(dev):
        by_stream[e['stream']].append((i, e['ts'], e['dur']))
    exclusive = [0.0] * len(dev)
    for spans in by_stream.values():
        ordered = sorted(spans, key=lambda s: (s[1], -s[2]))
        durs = exclusive_durations([(i, ts, dur) for i, ts, dur in ordered])
        for i, dur in durs:
            exclusive[i] = dur
    per_cat = dict.fromkeys(CATEGORIES, 0.0)
    launches = dict.fromkeys(CATEGORIES, 0)
    by_kernel = collections.defaultdict(lambda: [0, 0.0])
    for e, dur in zip(dev, exclusive):
        cat = category(e)
        per_cat[cat] += dur
        launches[cat] += 1
        by_kernel[(e['name'], cat)][0] += 1
        by_kernel[(e['name'], cat)][1] += dur
    formats = collections.Counter()
    for e in events:
        if e.get('ph') == 'X' and e.get('cat') in HOST_CATS and e.get('name') in CONV_OPS:
            formats[f"{'backward' if e['name'].endswith('backward') else 'forward'} "
                    f'{memory_format(e)}'] += 1
    total = sum(exclusive)
    top_kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:top]
    ms = lambda us: us / 1e3 / iters
    return dict(
        iters=iters, timeline=timeline, device_events=len(dev) if timeline == 'device' else 0,
        device_ms=ms(total), busy_ms=ms(busy_time(dev)),
        categories_ms={k: ms(v) for k, v in per_cat.items()},
        category_launches=launches,
        top_kernels=[dict(name=name, launches=n / iters, ms=ms(us), category=cat)
                     for (name, cat), (n, us) in top_kernels],
        conv_input_formats=dict(formats))
