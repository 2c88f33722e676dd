"""`scripts/_tracelib_torch.py` against `scripts/_tracelib.py`: the
exclusive-duration rule gives JAX's numbers on JAX-format traces (nested
spans on a `TPU:0` process's `XLA Ops` threads, hand-made and generated),
device events join their launching ops in the Chrome-trace layout that
torch.profiler writes with CUDA (kernels, memcpys and memsets on a stream,
`External id` and `correlation` shared with the ops and launch calls), and
a CPU trace of the tiny crop model loads with every event in a category."""

import itertools

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from scripts import _tracelib as jax_tracelib
from scripts import _tracelib_torch as tracelib
from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

DEVICE_PID, HOST_PID = 7, 1


def jax_trace(threads, host_spans=()):
    """A jax.profiler-style trace: process `TPU:0` with one 'XLA Ops'
    thread per entry of `threads` ([(name, ts, dur)]) and a 'Steps' thread
    that JAX leaves out, plus host spans in another process."""
    events = [dict(ph='M', name='process_name', pid=DEVICE_PID, args=dict(name='/device:TPU:0')),
              dict(ph='M', name='process_name', pid=HOST_PID, args=dict(name='/host:CPU')),
              dict(ph='M', name='thread_name', pid=DEVICE_PID, tid=99, args=dict(name='Steps'))]
    for tid, spans in enumerate(threads, start=1):
        events.append(dict(ph='M', name='thread_name', pid=DEVICE_PID, tid=tid,
                           args=dict(name=f'XLA Ops {tid}')))
        events += [dict(ph='X', pid=DEVICE_PID, tid=tid, name=n, ts=ts, dur=dur)
                   for n, ts, dur in spans]
        events.append(dict(ph='X', pid=DEVICE_PID, tid=99, name='step', ts=0, dur=10 ** 6))
    events += [dict(ph='X', pid=HOST_PID, tid=1, name=n, ts=ts, dur=dur)
               for n, ts, dur in host_spans]
    return events


def port_exclusive(events):
    """The port's rule over the spans JAX selects, thread by thread in the
    order JAX meets them."""
    threads = {}
    for e in events:
        if e.get('ph') == 'X' and e['pid'] == DEVICE_PID and e['tid'] != 99:
            threads.setdefault(e['tid'], []).append((e['name'], e['ts'], e.get('dur', 0)))
    return list(itertools.chain.from_iterable(
        tracelib.exclusive_durations(spans) for spans in threads.values()))


NESTED = [
    # a while loop holding its condition and body, the body holding fusions
    [('while.1', 0, 100), ('cond', 0, 10), ('body', 10, 80), ('fusion.1', 12, 30),
     ('convolution.3', 45, 40), ('copy.2', 92, 8), ('fusion.2', 100, 5)],
    # equal starts (the longer span first), touching spans, a zero-length span
    [('outer', 0, 50), ('inner', 0, 50), ('a', 0, 20), ('b', 20, 30), ('c', 50, 0),
     ('d', 50, 10)],
    # children longer than their parent's room (floored at 0)
    [('p', 0, 10), ('q', 2, 8), ('r', 3, 7), ('s', 4, 2)],
]


@pytest.mark.parametrize('case', range(len(NESTED)))
def test_exclusive_durations_equal_jax_on_nested_traces(case):
    events = jax_trace([NESTED[case]], host_spans=[('host', 0, 500)])
    want = jax_tracelib.exclusive_op_durations(events)
    assert port_exclusive(events) == want
    assert sum(d for _, d in want) > 0


def test_exclusive_durations_equal_jax_over_several_threads():
    events = jax_trace(NESTED)
    assert port_exclusive(events) == jax_tracelib.exclusive_op_durations(events)


spans = st.lists(st.tuples(st.sampled_from('abcdef'), st.integers(0, 60), st.integers(0, 40)),
                 max_size=25)


@settings(max_examples=200, deadline=None)
@given(st.lists(spans, min_size=1, max_size=3))
def test_exclusive_durations_equal_jax_on_generated_traces(threads):
    """Any spans, nested, touching, tied or partly overlapping: JAX's rule."""
    events = jax_trace(threads)
    assert port_exclusive(events) == jax_tracelib.exclusive_op_durations(events)


def card_trace():
    """A trace in the layout torch.profiler writes with CUDA activity: host
    ops (`cpu_op`, with shapes) and ranges (`user_annotation`) on the
    Python thread, launch calls (`cuda_runtime`, `cuda_driver`), and on
    stream 7 of device 0 kernels, a memcpy, a memset and a range's GPU
    projection (`gpu_user_annotation`, left out)."""
    ext = itertools.count(10)
    corr = itertools.count(500)
    events = [dict(ph='M', name='process_name', pid=0, args=dict(name='python')),
              dict(ph='M', name='process_labels', pid=0, args=dict(labels='GPU 0'))]

    def op(name, ts, dur, cat='cpu_op', **args):
        e = dict(ph='X', cat=cat, name=name, pid=HOST_PID, tid=HOST_PID, ts=ts, dur=dur,
                 args={'External id': next(ext), **args})
        events.append(e)
        return e

    def launch(parent, name, ts, dur, kind='kernel', with_external=True, api='cuda_runtime'):
        c = next(corr)
        events.append(dict(ph='X', cat=api, name='cudaLaunchKernel', pid=HOST_PID,
                           tid=HOST_PID, ts=parent['ts'] + 1, dur=1,
                           args={'External id': parent['args']['External id'],
                                 'correlation': c}))
        args = {'correlation': c, 'device': 0, 'stream': 7}
        if with_external:
            args['External id'] = parent['args']['External id']
        events.append(dict(ph='X', cat=kind, name=name, pid=0, tid=7, ts=ts, dur=dur,
                           args=args))

    nchw = dict(x=[8, 64, 32, 32], s=[65536, 1024, 32, 1])
    nhwc = dict(x=[8, 64, 32, 32], s=[65536, 1, 2048, 64])

    def conv(ts, x, weight, groups, kernels, bias=''):
        outer = op('aten::conv2d', ts, 40)
        mid = op('aten::convolution', ts + 1, 38, **{
            'Input Dims': [x['x'], weight, [], [], [], [], [], [], []],
            'Input Strides': [x['s'], [], [], [], [], [], [], [], []],
            'Concrete Inputs': ['', '', '', '[1, 1]', '[1, 1]', '[1, 1]', 'False', '[0, 0]',
                                str(groups)]})
        inner = op('aten::cudnn_convolution', ts + 2, 30)
        for k, (name, dur) in enumerate(kernels):
            launch(inner, name, 1000 + ts + 10 * k, dur)
        if bias:  # the bias add of `aten::_convolution`, after cuDNN's kernels
            launch(op('aten::add_', ts + 33, 4), bias, 1000 + ts + 30, 2)
        return outer, mid

    op('detector', 0, 900, cat='user_annotation')
    conv(0, nchw, [64, 64, 3, 3], 1, [('sm90_xmma_fprop_implicit_gemm_bf16', 7),
                                      ('nchwToNhwcKernel', 2)],
         bias='vectorized_elementwise_kernel<add bias>')
    conv(50, nhwc, [64, 1, 3, 3], 64, [('conv2d_grouped_direct_kernel', 5)])
    bn = op(tracelib.BN_LABEL, 100, 40, cat='user_annotation')
    launch(op('aten::mul', 101, 5), 'vectorized_elementwise_kernel<mul>', 1200, 3)
    launch(op('aten::add', 110, 5), 'vectorized_elementwise_kernel<add>', 1204, 3)
    assert bn['name'] == 'BatchNorm'
    launch(op('aten::silu', 150, 5), 'vectorized_elementwise_kernel<silu>', 1210, 4)
    launch(op('aten::mean', 160, 5), 'reduce_kernel<512, 1>', 1215, 6)
    pad = op('aten::pad', 170, 10)
    launch(op('aten::constant_pad_nd', 171, 8), 'elementwise_kernel<fill>', 1222, 2)
    assert pad['ts'] == 170
    launch(op('aten::contiguous', 185, 5), 'elementwise_kernel<copy>', 1225, 3)
    launch(op('aten::addmm', 200, 5), 'sm90_gemm_bf16_tn', 1230, 5, api='cuda_driver')
    launch(op('warp_cuda::warp_pyramid', 210, 5), 'warp_pyramid_kernel', 1240, 60)
    k2 = op('mbconv', 220, 20)
    launch(k2, 'mbconv_warp_kernel<__nv_bfloat16>', 1300, 30)
    launch(k2, 'mbconv_strip_kernel<__nv_bfloat16>', 1331, 10, with_external=False)
    launch(op('aten::copy_', 250, 5), 'Memcpy HtoD (Pinned -> Device)', 1345, 4,
           kind='gpu_memcpy')
    launch(op('aten::zero_', 260, 5), 'Memset (Device)', 1350, 1, kind='gpu_memset')
    launch(op('aten::nonzero', 270, 5), 'ncclDevKernel_AllReduce_Sum_bf16', 1352, 8)
    launch(op('aten::nonzero', 280, 5), 'index_elementwise_kernel', 1361, 2)
    events.append(dict(ph='X', cat='kernel', name='orphan_reduce_kernel', pid=0, tid=7,
                       ts=1364, dur=1, args={'correlation': 99999}))
    events.append(dict(ph='X', cat='gpu_user_annotation', name='detector', pid=0, tid=7,
                       ts=1000, dur=400, args={}))
    return events


WANT_CATEGORIES = {
    'sm90_xmma_fprop_implicit_gemm_bf16': tracelib.CONV,
    'nchwToNhwcKernel': tracelib.LAYOUT,
    'vectorized_elementwise_kernel<add bias>': tracelib.ELEMENTWISE,
    'conv2d_grouped_direct_kernel': tracelib.DEPTHWISE,
    'vectorized_elementwise_kernel<mul>': tracelib.BN,
    'vectorized_elementwise_kernel<add>': tracelib.BN,
    'vectorized_elementwise_kernel<silu>': tracelib.ELEMENTWISE,
    'reduce_kernel<512, 1>': tracelib.REDUCTION,
    'elementwise_kernel<fill>': tracelib.LAYOUT,
    'elementwise_kernel<copy>': tracelib.LAYOUT,
    'sm90_gemm_bf16_tn': tracelib.CONV,
    'warp_pyramid_kernel': tracelib.K1,
    'mbconv_warp_kernel<__nv_bfloat16>': tracelib.K2,
    'mbconv_strip_kernel<__nv_bfloat16>': tracelib.K2,
    'Memcpy HtoD (Pinned -> Device)': tracelib.MEMCPY,
    'Memset (Device)': tracelib.MEMCPY,
    'ncclDevKernel_AllReduce_Sum_bf16': tracelib.NCCL,
    'index_elementwise_kernel': tracelib.OTHER,
    'orphan_reduce_kernel': tracelib.REDUCTION,
}


def test_device_events_join_their_ops_and_fall_in_categories():
    events = card_trace()
    dev = tracelib.device_events(events)
    assert sorted(e['name'] for e in dev) == sorted(WANT_CATEGORIES)
    got = {e['name']: tracelib.category(e) for e in dev}
    assert got == WANT_CATEGORIES
    by_name = {e['name']: e for e in dev}
    # the strip kernel carries no External id: joined through its launch call
    assert by_name['mbconv_strip_kernel<__nv_bfloat16>']['ops'][0]['name'] == 'mbconv'
    assert [o['name'] for o in by_name['conv2d_grouped_direct_kernel']['ops']] == [
        'aten::cudnn_convolution', 'aten::convolution', 'aten::conv2d', 'detector']
    assert by_name['orphan_reduce_kernel']['ops'] == []


def test_summary_categories_cover_every_device_event():
    s = tracelib.summarise(card_trace(), iters=1)
    assert s['timeline'] == 'device' and s['device_events'] == len(WANT_CATEGORIES)
    assert set(s['categories_ms']) == set(tracelib.CATEGORIES)
    assert sum(s['category_launches'].values()) == len(WANT_CATEGORIES)
    assert sum(s['categories_ms'].values()) == pytest.approx(s['device_ms'], rel=1e-12)
    # one stream, kernels back to back or apart: busy time is their sum
    assert s['busy_ms'] == pytest.approx(s['device_ms'], rel=1e-12)
    assert s['category_launches'][tracelib.K1] == 1 and s['category_launches'][tracelib.K2] == 2
    assert s['categories_ms'][tracelib.K2] == pytest.approx(0.040)
    assert s['conv_input_formats'] == {'forward NCHW contiguous': 1, 'forward channels_last': 1}
    assert s['top_kernels'][0] == dict(name='warp_pyramid_kernel', launches=1.0, ms=0.060,
                                       category=tracelib.K1)


def test_busy_time_counts_overlap_once():
    events = [dict(ts=0, dur=10), dict(ts=5, dur=10), dict(ts=30, dur=5), dict(ts=31, dur=1)]
    assert tracelib.busy_time(events) == 20


def test_cpu_trace_of_the_tiny_crop_model(tmp_path, one_torch_thread):  # noqa: F811
    """torch.profiler on the CPU (as `utils.profiling.trace` writes it, with
    shapes): the newest trace loads, and with no device event its host ops
    are the timeline, each in one category, summing to their union."""
    from metrabs_tpu_torch.config import ModelConfig
    from metrabs_tpu_torch.models.metrabs import build_crop_model
    from metrabs_tpu_torch.utils import profiling

    cfg = ModelConfig(proc_side=64, backbone='tiny', n_joints=17, dtype='float32', depth=4)
    model = build_crop_model(cfg).eval()
    crops, k = torch.rand(2, 64, 64, 3), torch.eye(3).expand(2, 3, 3) * 50
    with profiling.trace(str(tmp_path / 'old')):
        model(crops, k)
    with profiling.trace(str(tmp_path / 'new'), record_shapes=True), torch.no_grad():
        model(crops, k)
    events = tracelib.load_latest_trace(str(tmp_path))
    assert any(e.get('name') == 'aten::convolution' and 'Input Dims' in e.get('args', {})
               for e in events)
    s = tracelib.summarise(events, iters=1)
    n_ops = sum(e.get('ph') == 'X' and e.get('cat') == 'cpu_op' for e in events)
    assert s['timeline'] == 'host ops' and sum(s['category_launches'].values()) == n_ops
    assert sum(s['categories_ms'].values()) == pytest.approx(s['device_ms'], rel=1e-9)
    assert s['busy_ms'] == pytest.approx(s['device_ms'], rel=5e-3)
    assert s['categories_ms'][tracelib.CONV] > 0
    assert sum(s['conv_input_formats'].values()) == 5 + 1  # the backbone's and the head's
