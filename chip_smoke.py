#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`metrabs_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, one line or a few each; any failure exits non-zero before the last
line:
 1. device: a CUDA device, its name and power limit from nvidia-smi;
 2. build: nvcc builds the port's two kernels, the crop warp
    `metrabs_tpu_torch/csrc/warp.cu` and the fused MBConv chain
    `metrabs_tpu_torch/csrc/mbconv.cu`, for sm_90a from the checkout, and the
    host C++ compiler the JPEG decoder `csrc/jpeg_decode.cpp`, all three
    compilers started together;
 3. kernel: the warp kernel against its plain PyTorch version at the serving
    shape (8 synthetic 1080p frames, 64 crops of 256x256, pyramid levels 0-2,
    lens distortion on some crops, a crop entirely outside its frame); the
    MBConv kernel against its plain version at every shape of K2_CASES (the
    four the detect path gives it, EffNetV2-L@384's stage 5 and 6 in
    bfloat16, S stage 5 in float32), v required equal. For each: the
    kernel's time, the bytes it must move (for the warp: its output and the
    distinct pyramid pixels its taps read), its bound and share of it, the
    plain version's time and, for K2, the port's unfused chain's (BN, silu,
    pad, cuDNN depthwise conv, BN, silu, mean). A kernel timed above
    MAX_BOUND_SHARE of its bound, or a profile that lost launches, is
    measured again and then fails;
 4. main: `estimate_poses_batched` of an estimator built by the same
    function `load_pose_estimator` uses after reading a package, with
    EffNetV2-S at 256 px in bfloat16 (BN folded, flat layout) and weights
    minted from a seed, on 8 synthetic 1080p frames with 16 boxes each
    (some invalid), num_aug 2, internal batch 64. Checks shapes, finiteness,
    the validity mask and that the warp kernel ran once per non-empty chunk;
    then holds a float32 estimator on the GPU against the same estimator on
    the CPU (plain warp) on a small input, and times the bf16 path;
 5. detect: `detect_poses_batched` of the same crop model with BN unfolded
    and `fuse_mbconv='on'`, plus a minted YOLOv4-416 in bfloat16, on the
    same frames: num_aug 2, max_detections 16, internal batch 64, detector
    threshold 0 (every slot valid) and the plausibility filter on. Checks
    shapes, finiteness, and that the warp kernel ran once and the MBConv
    kernel 28 times (the qualifying blocks) per non-empty chunk, split over
    its input shapes as K2_CASES expects; then holds a float32 detect
    estimator on the GPU against the same one on the CPU on a small frame,
    times the bf16 path, and splits one call's time under torch.profiler,
    with K2's launches and device time per call against the bound of the
    launches its wrapper counted, shape by shape;
 6. train: the trainer (`metrabs_tpu_torch.train`) on EffNetV2-S@256
    Metrabs with BN unfolded and `fuse_mbconv='on'`, H36M-17 3D and LSP-14
    2D joints, weights minted from TrainConfig's seed, bf16 compute with
    f32 master weights, batches of 32 + 32 synthetic examples through
    `ParallelBatchLoader` and `device_prefetch` (one batch, repeated): 3
    warm-up and 20 timed steps (median step time, images/s), one more under
    torch.profiler (device-busy share, kernels), the peak memory and the
    losses. Checks finite losses that fall on the repeated batch, a nonzero
    gradient in every backbone parameter (F1) and no K1 or K2 launch in a
    step; holds one float32 step on the GPU (TF32 off) against the same
    step on the CPU; then packages the EMA weights and serves them with
    `load_pose_estimator` on the main phase's frames and boxes, folded (K1
    once per non-empty chunk) and unfolded with `fuse_mbconv='on'` (K2 28
    times per chunk, v equal to the plain chain's on the trained weights);
 6b. train_families: every other crop-model family trained as phase 6
    trains plain Metrabs (EffNetV2-S@256, bf16 compute with f32 master
    weights, TrainConfig defaults, 32 + 32 synthetic examples, one batch
    repeated): Metro, Model25D (H36M-17 bones, minted ideal lengths),
    Metrabs in `transform_coords` and `predict_all_and_latents` (an affine
    autoencoder of FAMILY_N_LATENTS points minted into an npz and read back
    by `load_affine_weights`) and plain Metrabs with `regularize_to_manifold`,
    warm-started by `warm_start_backbone` from phase 6's package (backbone
    and head equal to the source's bit for bit). Per mode: 3 warm-up and 5
    timed steps and one profiled (median step time, images/s, device-busy
    share, peak memory), the checks of phase 6 (finite, falling losses, a
    gradient in every backbone parameter, no K1 or K2 launch), one step
    past `teacher_start_step` for `predict_all_and_latents` (the teacher term
    live), one float32 step on the GPU against the CPU; then the EMA weights
    packaged with the bone lengths of the 3D batches (`BoneLengthStats`),
    the crop model's eval-mode predictions on its training batch scored by
    `compute_pose3d_metrics` and `rigid_align` on the GPU against the CPU,
    and the package served on the main frames and boxes: folded bf16 through
    `load_pose_estimator` with K1 once per non-empty chunk (Metro: refused
    there, as in JAX), and FAMILY_FUSED_SERVE also unfolded with
    `fuse_mbconv='on'` (K2 28 times per chunk, v equal to the plain chain's);
 6c. train_app: the training app (`apps.train.main`) on a dataset minted
    under runs/ with the port's own classes and PNG writer (64 Example3D on
    1000x1000 frames with Human3.6M's cameras, half with lens distortion,
    half with foreground masks; 64 Example2D, some without a camera; 32
    held out): first `ParallelBatchLoader` alone over each stream
    (examples/s with every augmentation), then `main` at EffNetV2-S@256,
    bf16, 32 + 32, the default LoadConfig (every augmentation, synthetic
    occluders and backgrounds), 24 steps with log period 4, checkpoint
    period 8 and validation through `predict_dataset` every 12 steps, and
    again to 28 steps. Checks finite losses and validation metrics, the
    newest two checkpoints kept, the resumed run restoring step 24 and
    taking 4 steps, no K1 or K2 launch in the app, finite positive bone
    means in the exported manifest, and the package served as [train]
    serves its own (folded: K1 per chunk; fused: K2 28 times per chunk, v
    exact). Prints the loader's examples/s, the app's median step time and
    images/s, and [train]'s repeated-batch step time of the same run;
 7. families: the other model families, weights minted from a seed:
    (a) `detect_poses_batched` of ResNet-50@256 (metrabs_rn50_y4's crop
    model) in bf16 with BN folded by the loader's default, plus a minted
    YOLOv8-m@640 in bf16, on the main frames (settings of phase 5): shapes,
    finiteness on the detector's mask, K1 once per non-empty chunk and K2
    never; the float32 pair on the GPU against the CPU on a small frame
    (masks equal, boxes within BOX_TOL_PX, poses within 1 mm + 1e-3); the
    median of 5 calls and one call under torch.profiler. (b)
    `estimate_poses_batched` of MobileNetV3-L@256 (metrabs_mob3l_y4t's) in
    bf16, folded, on the main frames and boxes: K1 once per non-empty chunk,
    K2 never, the median of 5 calls and one profiled call. (c) each of
    FAMILY_CASES in float32 on the GPU against the CPU on a small frame with
    2 boxes, with another frame moving the poses; Metro built by
    `load_crop_model` and refused by `load_pose_estimator`; a float32
    YOLOv8-n's detections equal on the GPU and the CPU;
 8. import: the released metrabs_eff2s_y4 (EffNetV2-S@256 and YOLOv4-416,
    bf16), weights minted from a seed, written in the released formats by
    the port's own code (a TF TensorBundle under the reference fork's names,
    a darknet yolov4.weights, both under runs/ and deleted after the phase),
    read back by its importers (every leaf equal to the minted one bit for
    bit), packaged with the detector by its writer and loaded unfolded with
    `fuse_mbconv='on'`; on the main frames: `detect_poses_stream` (K=2
    batches, the second the frames mirrored) with K1 once and K2 28 times
    per non-empty chunk, `detect_poses_pipelined` (in_flight 2, 3 batches)
    and `estimate_poses_stream` (K=2, the main boxes), each against the
    batched calls within STREAM_TOL; F3 (the detect output's CUDA boxes back
    into `estimate_poses_batched`) and F2 (zero boxes, empty shapes); K1 and
    K2 counted again under torch.profiler on one stream call; the median of
    5 calls per frame batch, stream against batched, with the device-busy
    share of one profiled call of each;
 9. bench_apps: the benchmark path on JPEG frames. The host JPEG decoder
    (`csrc/jpeg_decode.cpp`) on every fixture of tests/torch_fixtures/jpeg,
    each held to the SHA-256 of cv2's decode in its manifest, then its time
    on the 1080x1920 frame (median of 20 on one thread, frames/s on 8). A
    3DPW layout (2 sequences x 24 copies of the portrait fixture, sequence
    pickles with 2 tracks) and a Human3.6M one (S9, one activity, 4 cameras
    x 8 copies of the 1000x1002 fixture, CDF poses from the port's writer, a
    cameras JSON) are minted under runs/ (deleted after), with
    metrabs_eff2s_y4 minted on SMPL-24 joints with a YOLOv4-416 whose heads
    fire (`firing_detector_variables`) and on H36M-17. `apps.predict_3dpw
    .main --gtassoc` with its defaults runs the first loaded unfolded with
    `fuse_mbconv='on'` (K1 once and K2 28 times per non-empty chunk), then
    `apps.eval_3dpw.main`; its first batch again with each K1 launch
    (portrait pyramids) held against the plain warp, K2's v against the
    plain chain, and under torch.profiler; `apps.predict_h36m.main` runs the
    second folded (K1 once per batch, K2 never), its first batch again with
    each K1 launch (odd level sizes, lens distortion) against the plain
    warp, then `apps.eval_benchmark.main` on a pickle of the same examples.
    Prints frames/s per driver with and without the package's loading, the
    share of `jpeg.decode` in its wall time, valid boxes per frame and
    finite metrics.
The second-to-last line is a JSON object with the kernels' measurements
(each kernel's `launches_by_path` counts every path's run);
the last is {"ok": true, "device": {...}}.
"""

import collections
import concurrent.futures
import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
PROC_SIDE = 256
N_FRAMES, FRAME_H, FRAME_W = 8, 1080, 1920
BOXES_PER_FRAME = 16
NUM_AUG = 2
INTERNAL_BATCH = 64
WARP_TOL = 1e-4  # linear [0, 1] values; FMA and reassociation between nvcc and ATen
POSE_ATOL_MM, POSE_RTOL = 1.0, 1e-3
# The fused MBConv kernel's cases: (label, [N, E, H, W], dtype, launches
# expected per detect-path chunk of 64 crops, which the detect phase checks
# against the wrapper's count per shape): the four shapes the detect path
# gives it (EffNetV2-S@256), EffNetV2-L@384's stage 5 and 6 at batch 128,
# and S stage 5 in float32. v must equal the plain version's exactly (same
# operations in the same order, no FMA contraction); the SE mean sums the
# same values in another order: 1e-5.
K2_CASES = (('S@256 stage 4', (64, 512, 16, 16), torch.bfloat16, 5),
            ('S@256 stage 5 first', (64, 768, 16, 16), torch.bfloat16, 1),
            ('S@256 stage 5', (64, 960, 16, 16), torch.bfloat16, 8),
            ('S@256 stage 6', (64, 1536, 8, 8), torch.bfloat16, 14),
            ('L@384 stage 5', (128, 1344, 24, 24), torch.bfloat16, 0),
            ('L@384 stage 6', (128, 2304, 12, 12), torch.bfloat16, 0),
            ('S@256 stage 5', (64, 960, 16, 16), torch.float32, 0))
K2_MAIN_CASE = 2  # the one the kernels line reports; every case is under 'cases'
K2_MEAN_TOL = dict(atol=1e-5, rtol=1e-5)
K2_BLOCKS = 28  # MBConv blocks of EffNetV2-S that the fused chain takes
K2_KERNELS = ('mbconv_warp_kernel', 'mbconv_strip_kernel')  # profiler names
# Bounds (H100 SXM datasheet peaks, at 700 W): HBM
# bytes per second and float32 operations per second outside the tensor
# cores, where both kernels compute. Operations counted per element: K2 2
# (BN0) + 4 (silu: exp, add, reciprocal, multiply) + 18 (9 taps) + 2 (BN1) +
# 4 (silu) + 1 (mean) = 31; K1 per output pixel ~20 (ray and divide) + ~25
# (distortion) + 4 (intrinsics) + 6 (clamps, floor) + 27 (3 bilinear blends)
# = 82.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K2_OPS_PER_ELEMENT = 31
K1_OPS_PER_PIXEL = 82
# A kernel's bound over its time above this share is a timing fault, not a
# fast kernel (5% for the datasheet rates' rounding).
MAX_BOUND_SHARE = 1.05
TIMING_TRIES = 3  # profiles of a kernel before a lost record or such a share fails
DETECTOR_SIZE = 416
MAX_DETECTIONS = 16
BOX_TOL_PX = 1e-2
TRAIN_WARMUP, TRAIN_STEPS = 3, 20
TRAINED_PACKAGE = 'runs/chip_smoke_trained_package'  # [train]'s, read by [train_families]
TRAIN_PARITY_BATCH = 2  # per stream, in the float32 GPU-vs-CPU step
# Kernel-name groups of a train step's device time, first match wins.
TRAIN_KERNEL_GROUPS = (
    ('optimizer (foreach)', ('multi_tensor_apply',)),
    ('convolution', ('conv', 'gemm', 'xmma', 'cudnn', 'sm90_', 'cutlass', 'wgrad', 'dgrad')),
    ('reduction', ('reduce',)),
    ('copy, cast, memcpy', ('copy', 'memcpy', 'memset', 'cat')),
    ('elementwise', ('elementwise', 'vectorized', 'unrolled')))


def phase(name: str, msg: str) -> None:
    print(f'[{name}] {msg}', flush=True)


def fail(name: str, msg: str) -> None:
    print(f'[{name}] FAIL: {msg}', flush=True)
    sys.exit(1)


def cuda_time_ms(fn, n_warm: int = 3, n: int = 25) -> float:
    """Median over `n` warm calls of the device time between CUDA events."""
    for _ in range(n_warm):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled(run, name: str):
    """(the events of one `run()` under torch.profiler, its wall ms). A
    profile without a single GPU kernel record (torch.profiler drops a whole
    profile now and then) is taken again, up to TIMING_TRIES times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TIMING_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        if any(e.device_type == DeviceType.CUDA for e in events):
            return events, wall_ms
        phase(name, 'torch.profiler recorded no GPU kernels: profiling again')
    fail(name, f'torch.profiler recorded no GPU kernels in {TIMING_TRIES} profiles')


def device_time_ms(fn, n: int = 25) -> float:
    """Mean device time of `fn` over `n` warm calls: the summed durations of
    the GPU kernels it launches, from torch.profiler, so without the host's
    launch gaps that `cuda_time_ms` includes. `fn` launches the same kernels
    every call, so each kernel name must be recorded a multiple of `n`
    times; a profile that lost records (a sum over fewer launches than were
    made, which reads as a kernel faster than its bound) is taken again, up
    to TIMING_TRIES times."""
    from torch.autograd import DeviceType

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(TIMING_TRIES):
        events, _ = profiled(lambda: [fn() for _ in range(n)], 'kernel')
        events = [e for e in events if e.device_type == DeviceType.CUDA]
        counts = collections.Counter(e.name for e in events)
        if all(c % n == 0 for c in counts.values()):
            return sum(e.device_time_total for e in events) / n / 1e3
        phase('kernel', f'torch.profiler recorded {sorted(counts.values())} launches per '
                        f'kernel over {n} calls, not a multiple of {n}: profiling again')
    fail('kernel', f'torch.profiler lost kernel records in {TIMING_TRIES} profiles of {n} '
                   f'calls')


def timed_against_bound(name: str, fn, bound_ms: float) -> float:
    """`device_time_ms(fn)`, which must not beat `bound_ms` by more than
    MAX_BOUND_SHARE allows: a kernel timed faster than the card can move its
    bytes or do its operations was timed wrong. Measured again, up to
    TIMING_TRIES times, before it fails."""
    for _ in range(TIMING_TRIES):
        ms = device_time_ms(fn)
        if bound_ms / ms <= MAX_BOUND_SHARE:
            return ms
        phase('kernel', f'{name}: {ms:.4f} ms is {100 * bound_ms / ms:.1f}% of its bound '
                        f'{bound_ms:.4f} ms: timing again')
    fail('kernel', f'{name}: timed above {100 * MAX_BOUND_SHARE:.0f}% of its bound in '
                   f'{TIMING_TRIES} measurements')


def synthetic_frames(gen: torch.Generator, dev) -> torch.Tensor:
    """[N, 1080, 1920, 3] uint8: smooth random structure plus pixel noise."""
    coarse = torch.rand((N_FRAMES, 3, 34, 60), generator=gen, device=dev)
    img = torch.nn.functional.interpolate(coarse, size=(FRAME_H, FRAME_W), mode='bicubic',
                                          align_corners=False)
    img = img * 235 + torch.rand(img.shape, generator=gen, device=dev) * 20
    return img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def warp_case(dev, n_crops: int = 64, side: int = 256):
    """Per-crop geometry of the kernel check: scales that select pyramid
    levels 0, 1 and 2, rotations, distortion on every third crop, and the
    last crop looking far outside its frame (all zero border)."""
    g = np.random.default_rng(SEED)
    scales = np.array([0.7, 0.35, 0.18, 1.4] * (n_crops // 4), np.float32)
    angles = g.uniform(-0.6, 0.6, n_crops)
    cx = g.uniform(0, FRAME_W, n_crops)
    cy = g.uniform(0, FRAME_H, n_crops)
    k_old = np.array([[1500.0, 0, FRAME_W / 2], [0, 1500.0, FRAME_H / 2], [0, 0, 1]])
    invproj = np.zeros((n_crops, 3, 3))
    for i in range(n_crops):
        c, s = math.cos(angles[i]), math.sin(angles[i])
        a = np.array([[c, -s], [s, c]]) / scales[i]
        m = np.eye(3)
        m[:2, :2] = a
        m[:2, 2] = np.array([cx[i], cy[i]]) - a @ np.array([side / 2, side / 2])
        invproj[i] = np.linalg.inv(k_old) @ m
    invproj[-1, :2, 2] += 10.0  # ~15000 px away: only the zero ring is sampled
    dist = np.zeros((n_crops, 12))
    dist[::3, 0] = g.uniform(-0.2, 0.2, len(dist[::3]))
    dist[::3, 1] = g.uniform(-0.05, 0.05, len(dist[::3]))
    dist[::3, 2:4] = g.uniform(-0.01, 0.01, (len(dist[::3]), 2))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    return dict(intrinsic_matrix=t(np.tile(k_old, (n_crops, 1, 1))),
                new_invprojmat=t(invproj), distortion_coeffs=t(dist),
                crop_scales=t(scales),
                image_ids=torch.arange(n_crops, device=dev) % N_FRAMES)


def mint_state(shapes, gen: torch.Generator):
    """A state dict for the meta tensors `shapes`: 0.8x He fan-in kernels,
    random BN statistics and affine, small random biases."""
    state = {}
    for name, meta in shapes.items():
        shape = tuple(meta.shape)
        if name.endswith('weight') and len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            v = torch.randn(shape, generator=gen) * (0.8 * math.sqrt(2.0 / fan_in))
        elif name.endswith('running_var'):
            v = torch.rand(shape, generator=gen) * 0.8 + 0.6
        elif name.endswith('weight'):
            v = torch.rand(shape, generator=gen) * 0.6 + 0.7
        else:
            v = torch.randn(shape, generator=gen) * 0.1
        state[name] = v
    return state


def mint_crop_variables(cfg, gen: torch.Generator, **crop_model_kwargs):
    """Flat, unfolded JAX-layout variables for `cfg` and the crop model of
    `crop_model_kwargs` (`build_crop_model`'s model class and latent mode),
    minted by `mint_state`, with a Metrabs 3D head that agrees with the 2D
    head (so the reconstruction places joints in front of the camera) and
    latent recombinations that are affine (each point's weights sum to 1)."""
    from metrabs_tpu_torch.io.weights import flax_variables_from_state_dict
    from metrabs_tpu_torch.models.metrabs import build_crop_model

    with torch.device('meta'):
        shapes = build_crop_model(cfg, **crop_model_kwargs).state_dict()
    state = mint_state(shapes, gen)
    for name in ('heatmap_heads.conv_final.weight', 'heatmap_heads.conv_final.bias'):
        if name in state:
            v = state[name]
            j = v.shape[0] // (1 + cfg.depth)
            v[j:] = v[:j].repeat((cfg.depth,) + (1,) * (v.ndim - 1)) + 0.05 * torch.randn(
                v[j:].shape, generator=gen)
    for name in ('recombination_weights', 'encoder_weights'):
        if name in state:
            v = torch.rand(state[name].shape, generator=gen)
            state[name] = v / v.sum(dim=0, keepdim=True)
    return flax_variables_from_state_dict(state)


# The H36M 17-joint skeleton.
JOINT_NAMES = ['pelv', 'rhip', 'rkne', 'rank', 'lhip', 'lkne', 'lank', 'spin', 'neck',
               'head', 'htop', 'lsho', 'lelb', 'lwri', 'rsho', 'relb', 'rwri']
JOINT_EDGES = [[0, 1], [1, 2], [2, 3], [0, 4], [4, 5], [5, 6], [0, 7], [7, 8], [8, 9],
               [9, 10], [8, 11], [11, 12], [12, 13], [8, 14], [14, 15], [15, 16]]


def manifest_for(dtype: str) -> dict:
    """A package manifest for the minted crop model."""
    return dict(
        format_version=1,
        model_config=dict(proc_side=PROC_SIDE, backbone='efficientnetv2-s', n_joints=17,
                          dtype=dtype, backbone_scan_blocks=False),
        aug_config={}, joint_names=JOINT_NAMES, joint_edges=JOINT_EDGES,
        has_detector=False)


def synthetic_boxes():
    """[8, 16, 4] person-like boxes inside the frames and their validity; 3
    per frame invalid, one of them the degenerate [0, 0, 0, 0]."""
    g = np.random.default_rng(SEED + 1)
    h = g.uniform(150, 1000, (N_FRAMES, BOXES_PER_FRAME))
    w = h * g.uniform(0.35, 0.6, h.shape)
    x = g.uniform(0, 1, h.shape) * (FRAME_W - w)
    y = g.uniform(0, 1, h.shape) * (FRAME_H - h)
    boxes = np.stack([x, y, w, h], axis=-1).astype(np.float32)
    valid = np.ones(h.shape, bool)
    valid[:, [3, 9, 15]] = False
    boxes[:, 15] = 0.0
    return boxes, valid


def detect_manifest_for(dtype: str) -> dict:
    """The manifest with a YOLOv4-416 detector in `dtype` (flat layout)."""
    return dict(manifest_for(dtype), has_detector=True, detector_type='yolov4',
                detector_dtype=dtype, detector_input_size=DETECTOR_SIZE,
                detector_scan_repeats=False)


def mint_detector_variables(gen: torch.Generator, kind: str = 'yolov4'):
    """Flat, unfolded JAX-layout variables of a detector of `kind`, minted by
    `mint_state`."""
    from metrabs_tpu_torch.detect.yolov4 import build_detector_model
    from metrabs_tpu_torch.io.weights import flax_variables_from_state_dict

    with torch.device('meta'):
        shapes = build_detector_model(kind).state_dict()
    return flax_variables_from_state_dict(mint_state(shapes, gen))


# Added to the objectness and person-class logits of every YOLOv4 head of a
# minted detector, so that its scores pass a driver's fixed threshold (0.2
# in predict_3dpw and predict_mupots): a random head's scores sit near
# sigmoid(0)^2 = 0.25 with a wide spread, and many frames would have no box.
DETECTOR_FIRE_BIAS = 3.0


def firing_detector_variables(gen: torch.Generator, kind: str = 'yolov4'):
    """`mint_detector_variables` with DETECTOR_FIRE_BIAS added to each head's
    objectness and person logits (channels 4 and 5 of each anchor's 85)."""
    variables = mint_detector_variables(gen, kind)
    for layer in variables['params'].values():
        conv_bias = layer.get('conv', {}).get('bias') if isinstance(layer, dict) else None
        if conv_bias is not None and conv_bias.shape == (3 * 85,):
            conv_bias = np.array(conv_bias, copy=True)
            conv_bias.reshape(3, 85)[:, 4:6] += np.float32(DETECTOR_FIRE_BIAS)
            layer['conv']['bias'] = conv_bias
    return variables


def k2_case(shape, dtype, gen: torch.Generator, dev):
    """The expand-conv output u [N, E, H, W] in `dtype`, the depthwise weight
    [E, 1, 3, 3] and the two inference BatchNorms around the depthwise conv,
    with random statistics."""
    from metrabs_tpu_torch.models.backbones.common import FrozenBatchNorm2d

    e = shape[1]
    rand = lambda lo, hi: torch.rand(e, generator=gen, device=dev) * (hi - lo) + lo
    u = (torch.randn(shape, generator=gen, device=dev) * 2).to(dtype)
    dw = torch.randn((e, 1, 3, 3), generator=gen, device=dev) * 0.3
    bns = []
    for _ in range(2):
        bn = FrozenBatchNorm2d(e, 1e-3).to(dev)
        bn.weight.data, bn.bias.data = rand(0.5, 1.5), rand(-0.3, 0.3)
        bn.running_mean.copy_(rand(-0.5, 0.5))
        bn.running_var.copy_(rand(0.5, 1.5))
        bns.append(bn)
    return u, dw, bns


def unfused_chain(u, dw, bn0, bn1):
    """The port's unfused MBConv inner chain (`efficientnet_v2.MBConv` with
    `fuse_mbconv='off'`): BN, silu, pad, cuDNN depthwise conv, BN, silu, and
    the SE block's spatial mean."""
    x = torch.nn.functional.silu(bn0(u))
    x = torch.nn.functional.conv2d(torch.nn.functional.pad(x, (1, 1, 1, 1)), dw.to(x.dtype),
                                   groups=x.shape[1])
    x = torch.nn.functional.silu(bn1(x))
    return x, torch.mean(x, dim=(2, 3))


def bound(n_bytes: float, n_ops: float):
    """(least ms, 'bytes' or 'operations'): the larger of the bytes over the
    HBM rate and the float32 operations over the float32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def k2_bound(shape, element_size: int):
    """(bytes, least ms, what bounds it) of K2 on a u of `shape`: u read and
    v written once, the float32 taps, BN constants and SE mean;
    K2_OPS_PER_ELEMENT."""
    n, e = shape[:2]
    numel = math.prod(shape)
    n_bytes = 2 * numel * element_size + 4 * (n * e + 9 * e + 4 * e)
    return (n_bytes, *bound(n_bytes, K2_OPS_PER_ELEMENT * numel))


def check_k2(gen, dev):
    """Every K2 case: the kernel against its plain version, its times beside
    its bound, the plain version's and the unfused chain's. Returns one dict
    per case."""
    from metrabs_tpu_torch.ops import mbconv, mbconv_cuda

    results = []
    for label, shape, dtype, _ in K2_CASES:
        u, dw, (bn0, bn1) = k2_case(shape, dtype, gen, dev)
        taps, sb = mbconv.inner_constants(dw, *bn0.folded(), *bn1.folded())
        got_v, got_mean = mbconv_cuda.fused_mbconv_inner(u, taps, sb)
        want_v, want_mean = mbconv.fused_mbconv_inner(u, taps, sb)
        torch.cuda.synchronize()
        name = f'fused_mbconv_inner {label} {list(shape)} {str(dtype)[6:]}'
        if got_v.shape != u.shape or got_v.dtype != dtype or got_mean.shape != shape[:2]:
            fail('kernel', f'{name}: output {tuple(got_v.shape)} {got_v.dtype}, '
                           f'mean {tuple(got_mean.shape)}')
        if not (torch.isfinite(got_v).all() and torch.isfinite(got_mean).all()):
            fail('kernel', f'{name}: non-finite kernel output')
        err_v = (got_v.float() - want_v.float()).abs().max().item()
        err_mean = (got_mean - want_mean).abs().max().item()
        if err_v != 0.0 or not torch.allclose(got_mean, want_mean, **K2_MEAN_TOL):
            fail('kernel', f'{name}: max |kernel - plain| v {err_v:.3g} (must be 0), mean '
                           f'{err_mean:.3g} (tol {K2_MEAN_TOL})')
        unfused_v, _ = unfused_chain(u, dw, bn0, bn1)
        err_unfused = (got_v.float() - unfused_v.float()).abs().max().item()
        del got_v, want_v, unfused_v
        kernel = lambda: mbconv_cuda.fused_mbconv_inner(u, taps, sb)
        n_bytes, bound_ms, bound_by = k2_bound(u.shape, u.element_size())
        ms, event_ms = timed_against_bound(name, kernel, bound_ms), cuda_time_ms(kernel)
        plain_ms = device_time_ms(lambda: mbconv.fused_mbconv_inner(u, taps, sb))
        unfused_ms = device_time_ms(lambda: unfused_chain(u, dw, bn0, bn1))
        phase('kernel', f'{name}: max |kernel - plain| v {err_v:.3g}, mean {err_mean:.3g}; '
                        f'vs the unfused chain {err_unfused:.3g} (BN folded vs not); kernel '
                        f'{ms:.4f} ms, {n_bytes / 1e6:.1f} MB, bound {bound_ms:.4f} ms '
                        f'({bound_by}), {100 * bound_ms / ms:.1f}% of bound; plain torch '
                        f'{plain_ms:.4f} ms, unfused cuDNN chain {unfused_ms:.4f} ms (device '
                        f'time, mean of 25); kernel {event_ms:.4f} ms between CUDA events '
                        f'(median of 25 single calls, launch included)')
        results.append(dict(case=label, shape=list(shape), dtype=str(dtype)[6:],
                            max_abs_err=err_v, max_abs_err_mean=err_mean, ms=ms,
                            event_ms=event_ms,
                            plain_ms=plain_ms, unfused_ms=unfused_ms, bytes=n_bytes,
                            bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms))
        del u
    return results


def k1_bound(flat, params, geom, side):
    """(bytes, least ms, what bounds it) of K1 on these inputs: every output
    byte, the parameters, and each distinct pyramid pixel that a bilinear tap
    reads, once; K1_OPS_PER_PIXEL."""
    from metrabs_tpu_torch.ops import warp as warp_ops

    coords = warp_ops.warp_pyramid_coords(params, side)
    idx00, _, _ = warp_ops.bilinear_corners(geom[:, 0], geom[:, 1], geom[:, 2], coords)
    used = torch.zeros(flat.shape[0], dtype=torch.bool, device=flat.device)
    wp = geom[:, 2, None, None]
    for offset in (0, 1, wp, wp + 1):
        used[(idx00 + offset).reshape(-1)] = True
    n_pixels = params.shape[0] * side[0] * side[1]
    n_bytes = (n_pixels * 3 * 4 + int(used.sum()) * flat.element_size() * 3
               + params.numel() * 4 + geom.numel() * 8)
    return (n_bytes, *bound(n_bytes, K1_OPS_PER_PIXEL * n_pixels))


def profile_detect(est, run):
    """One `run()` under torch.profiler, with ranges around the detector, its
    box NMS (where `est` has a detector), the crop model, the plausibility
    filter and its pose NMS. Returns (wall ms, {name: device ms}, {name:
    host ms}, busy device ms, kernel count, {kernel: launches})."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    from metrabs_tpu_torch.detect import yolov4
    from metrabs_tpu_torch.pipeline import plausibility

    def labelled(name, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapped

    patches = [(est.detector, 'detect_batched', 'detector'), (yolov4, 'box_nms', 'detector_nms'),
               (est, 'crop_model', 'crop_model'),
               (plausibility, 'suppress_implausible_poses', 'pose_filter'),
               (plausibility, 'pose_non_max_suppression', 'pose_nms')]
    patches = [p for p in patches if p[0] is not None]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, name in patches:
        setattr(obj, attr, labelled(name, getattr(obj, attr)))
    try:
        events, wall_ms = profiled(run, 'profile')
    finally:
        for obj, attr, value in saved:
            setattr(obj, attr, value)
    names = {name for _, _, name in patches}
    device_ms, host_ms = {}, {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in names:
            device_ms[e.name] = device_ms.get(e.name, 0.0) + e.device_time_total / 1e3
            host_ms[e.name] = host_ms.get(e.name, 0.0) + e.cpu_time_total / 1e3
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in names]
    counts = {}
    for key, patterns in (('K2 (mbconv kernel)', K2_KERNELS),
                          ('K1 (warp kernel)', ('warp_pyramid_kernel',))):
        mine = [e for e in kernels if any(p in e.name for p in patterns)]
        device_ms[key] = sum(e.device_time_total for e in mine) / 1e3
        counts[key] = len(mine)
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3  # one stream: no overlap
    return wall_ms, device_ms, host_ms, busy_ms, len(kernels), counts


def synthetic_example(index: int, stream: str, side: int = PROC_SIDE) -> dict:
    """Training example `index` of the 3D or 2D stream, made from (SEED,
    index) alone: a noise image, a camera, and a person of 17 joints around
    a root 2.5-5 m away with their projection into the crop (3D) or 14
    joints inside the crop (2D), ~10% of the joints marked invalid."""
    rng = np.random.default_rng((SEED, index))
    k = np.float32([[1.5 * side, 0, side / 2], [0, 1.5 * side, side / 2], [0, 0, 1]])
    out = dict(image=rng.random((side, side, 3), dtype=np.float32), intrinsics=k)
    if stream == '3d':
        root = np.concatenate([rng.normal(0, 300, 2), rng.uniform(2500, 5000, 1)])
        coords = (root + rng.normal(0, 250, (17, 3))).astype(np.float32)
        projected = coords @ k.T
        out.update(coords3d_true=coords, coords2d_true=projected[:, :2] / projected[:, 2:],
                   joint_validity_mask=rng.random(17) < 0.9)
    else:
        out.update(coords2d_true=rng.uniform(0.12 * side, 0.88 * side, (14, 2)).astype(
            np.float32), joint_validity_mask=rng.random(14) < 0.9)
    return out


def synthetic_batches(tcfg, n_steps: int, dev, bone_stats=None, first_example: int = 0):
    """`n_steps` (3D, 2D) batch pairs of tcfg's sizes through
    `ParallelBatchLoader` and `device_prefetch`, of the examples from
    `first_example` on. Both streams cycle over one batch's worth of
    examples, so every step sees the same batch. The 3D batches update
    `bone_stats` (a `BoneLengthStats`) on the host as they stream by, as the
    trainer measures the package's bone lengths."""
    import itertools

    from metrabs_tpu_torch.data.pipeline import ParallelBatchLoader, device_prefetch

    loaders = [ParallelBatchLoader(lambda i, _, s=stream: synthetic_example(i, s),
                                   itertools.cycle(range(offset, offset + size)), size,
                                   n_workers=4, seed=SEED)
               for stream, offset, size in (
                   ('3d', first_example, tcfg.batch_size),
                   ('2d', first_example + tcfg.batch_size, tcfg.batch_size_2d))]
    pairs = ({'3d': a, '2d': b} for a, b in itertools.islice(zip(*loaders), n_steps))
    if bone_stats is not None:
        pairs = (bone_stats.update(pair['3d']['coords3d_true'],
                                   pair['3d']['joint_validity_mask']) or pair for pair in pairs)
    return device_prefetch(({f'{s}/{k}': v for s, batch in pair.items()
                             for k, v in batch.items()} for pair in pairs), device=dev), loaders


def split_streams(batch: dict):
    return [{k.split('/', 1)[1]: v for k, v in batch.items() if k.startswith(s)}
            for s in ('3d/', '2d/')]


def make_trainer(cfg, tcfg, variables, dev, fuse: str = 'off', model_kwargs=None,
                 affine_weights=None):
    """(train state on `dev`, train step) of a crop model with `variables`,
    of the class and latent mode of `model_kwargs` (`build_crop_model`'s),
    with the autoencoder's `affine_weights` in the latent and manifold
    modes."""
    from metrabs_tpu_torch.io.weights import crop_model_state_dict_from_flax
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    from metrabs_tpu_torch.models.metrabs import build_crop_model
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17, LSP_14
    from metrabs_tpu_torch.train import loop, optim

    model_kwargs = model_kwargs or {}
    model = build_crop_model(cfg, functools.partial(build_backbone, fuse_mbconv=fuse),
                             **model_kwargs)
    model.load_state_dict(crop_model_state_dict_from_flax(variables, cfg, **model_kwargs))
    optimizer = optim.Optimizer(tcfg)
    state = loop.create_train_state(model, optimizer, device=dev)
    model_class = model_kwargs.get('model_class', 'metrabs')
    if model_class != 'metrabs':
        maker = dict(metro=loop.make_train_step_metro,
                     model25d=loop.make_train_step_model25d)[model_class]
        return state, maker(model, optimizer, H36M_17, LSP_14, cfg, tcfg)
    return state, loop.make_train_step(model, optimizer, H36M_17, LSP_14, cfg, tcfg,
                                       affine_weights=affine_weights)


def train_parity(cfg, tcfg, variables, dev, name='train', model_kwargs=None,
                 affine_weights=None):
    """One float32 step (TF32 off) on the GPU against the same step on the CPU
    from the same state, batch and mix (the Metrabs step's), drop-connect off
    on both (the two devices' generators differ), for the crop model of
    `model_kwargs` (`make_trainer`'s). Returns the worst deviations; fails past
    the parity tolerance of tests/_torch_train.py, with Adam's moments held
    per tensor as the gradients are (mu is 0.1 g after one step; float32
    rounding through forty train-mode BatchNorms reaches ~6e-5 of a tensor's
    largest gradient, beyond an elementwise rtol on its small elements)."""
    from metrabs_tpu_torch.models.backbones import efficientnet_v2

    cfg32 = dataclasses.replace(cfg, dtype='float32')
    n = TRAIN_PARITY_BATCH
    b3, b2 = [{k: torch.as_tensor(np.stack([synthetic_example(i, s)[k] for i in ids]))
               for k in synthetic_example(0, s)}
              for s, ids in (('3d', range(n)), ('2d', range(100, 100 + n)))]
    mix = torch.rand((2 * n, 1, 1), generator=torch.Generator().manual_seed(SEED))
    step_kwargs = {} if (model_kwargs or {}).get('model_class', 'metrabs') != 'metrabs' else dict(
        mix=mix)
    saved_survival = efficientnet_v2.SURVIVAL_PROB
    efficientnet_v2.SURVIVAL_PROB = 1.0
    try:
        runs = []
        for d in (dev, 'cpu'):
            state, step = make_trainer(cfg32, tcfg, variables, d, model_kwargs=model_kwargs,
                                       affine_weights=affine_weights)
            losses = step(state, b3, b2, **step_kwargs)
            named = lambda t: {k: v.detach().float().cpu() for k, v in t.items()}
            adam = state.opt_state.groups['all']
            runs.append(dict(
                losses=named(losses), grads=named({k: p.grad for k, p in state.params().items()}),
                params=named(state.params()), mu=named(adam.mu), nu=named(adam.nu),
                ema=named(state.ema_params),
                stats=named({k: b for k, b in state.model.named_buffers()
                             if k.endswith(('running_mean', 'running_var'))})))
            del state
    finally:
        efficientnet_v2.SURVIVAL_PROB = saved_survival
    got, want = runs
    lr = float(tcfg.base_learning_rate)
    worst = {}
    worst['loss_rel'] = max(abs(got['losses'][k] - want['losses'][k]).item()
                            / abs(want['losses'][k]).item() for k in want['losses'])
    # A tensor whose gradient is zero in exact arithmetic (the bias of a BN
    # that the next train-mode BN cancels) holds rounding noise on both
    # sides: it and its moments are held against the model's largest value.
    largest_grad = max(v.abs().max().item() for v in want['grads'].values())
    zero = {k for k, w in want['grads'].items() if w.abs().max().item() < 1e-6 * largest_grad}
    for key in ('grads', 'mu', 'nu'):
        largest = max(v.abs().max().item() for v in want[key].values())
        worst[f'{key}_rel_to_tensor_max'] = max(
            (got[key][k] - w).abs().max().item() / (largest if k in zero else w.abs().max().item())
            for k, w in want[key].items())
    stats_excess = max(((got['stats'][k] - w).abs() - (1e-7 + 1e-4 * w.abs())).max().item()
                       for k, w in want['stats'].items())
    moved = {k: (got['params'][k] - w).abs() for k, w in want['params'].items()}
    n_near = sum(int((d <= 1e-2 * lr).sum()) for d in moved.values())
    n_all = sum(d.numel() for d in moved.values())
    worst['params_max_over_lr'] = max(d.max().item() for d in moved.values()) / lr
    worst['params_near_share'] = n_near / n_all
    # The EMA blends (1 - momentum) of the updated parameters in (all of
    # them at momentum 1): it carries that share of their difference.
    carried = 1.0 if tcfg.ema_momentum >= 1.0 else 1.0 - tcfg.ema_momentum
    ema_excess = max(((got['ema'][k] - w).abs() - carried * moved[k]
                      - (1e-7 + 1e-4 * w.abs())).max().item() for k, w in want['ema'].items())
    worst['stats_excess'], worst['ema_excess'] = stats_excess, ema_excess
    ok = (worst['loss_rel'] <= 1e-4 and worst['grads_rel_to_tensor_max'] <= 1e-4
          and worst['mu_rel_to_tensor_max'] <= 1e-4 and worst['nu_rel_to_tensor_max'] <= 2e-4
          and stats_excess <= 0 and ema_excess <= 0 and worst['params_max_over_lr'] <= 2
          and worst['params_near_share'] >= 0.999)
    if not ok:
        fail(name, f'the float32 GPU step differs from the CPU step: {worst}')
    return worst


def profile_step(run):
    """One `run()` under torch.profiler: (wall ms, device busy ms, kernels,
    {kernel group: device ms})."""
    from torch.autograd import DeviceType

    events, wall_ms = profiled(run, 'train')
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if not e.name.startswith(('Memcpy', 'Memset'))]
    groups = {}
    for e in device:
        name = e.name.lower()
        group = next((g for g, keys in TRAIN_KERNEL_GROUPS if any(k in name for k in keys)),
                     'other')
        groups[group] = groups.get(group, 0.0) + e.device_time_total / 1e3
    return wall_ms, sum(e.device_time_total for e in device) / 1e3, len(kernels), groups


def train_steps(state, step, tcfg, dev, name: str, n_warmup: int, n_timed: int,
                fall_window: int, bone_stats=None, first_example: int = 0) -> dict:
    """`n_warmup` + `n_timed` steps of `step` on the repeated synthetic batch
    (`synthetic_batches` from `first_example`, updating `bone_stats`), then
    one more under torch.profiler, with the drop-connect masks (and the
    Metrabs step's mix) from a generator on `dev`. Fails unless every loss is finite, the mean
    loss of the last `fall_window` steps is below that of the first, every
    backbone parameter got a nonzero gradient in the last step and no step
    launched K1 or K2. Returns the median step time, the busy share of the
    profiled step, the peak memory since the caller's
    `reset_peak_memory_stats`, the last batch (host tensors) and a `summary`
    line."""
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda

    gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
    batches, loaders = synthetic_batches(tcfg, n_warmup + n_timed + 1, dev, bone_stats,
                                         first_example)
    warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
    losses, times = [], []
    try:
        for _ in range(n_warmup + n_timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b3, b2 = split_streams(next(batches))
            losses.append(step(state, b3, b2, generator=gen))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        b3, b2 = split_streams(next(batches))
        wall_ms, busy_ms, n_kernels, groups = profile_step(
            lambda: losses.append(step(state, b3, b2, generator=gen)))
    finally:
        for loader in loaders:
            loader.close()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if warp_cuda.warp_pyramid.launches or mbconv_cuda.fused_mbconv_inner.launches:
        fail(name, 'a train step launched K1 or K2')
    loss = torch.stack([l['loss'] for l in losses]).float().cpu()
    if not all(bool(torch.isfinite(v).all()) for l in losses for v in l.values()):
        fail(name, f'non-finite losses: {loss.tolist()}')
    if not loss[-fall_window:].mean() < loss[:fall_window].mean():
        fail(name, f'the loss on the repeated batch does not fall: {loss.tolist()}')
    silent = [n for n, p in state.model.backbone.named_parameters()
              if p.grad is None or not p.grad.abs().max() > 0]
    if silent:
        fail(name, f'{len(silent)} backbone parameters got no gradient, e.g. {silent[:4]}')
    step_s = statistics.median(times[n_warmup:])
    n_images = tcfg.batch_size + tcfg.batch_size_2d
    summary = (
        f'{n_timed} timed steps after {n_warmup}: median {step_s * 1e3:.1f} ms/step '
        f'(CUDA-synchronised), {n_images / step_s:.1f} images/s; all: '
        + ', '.join(f'{t * 1e3:.1f}' for t in times)
        + f'; one step under torch.profiler: wall {wall_ms:.1f} ms, device busy '
          f'{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), {n_kernels} kernels; peak '
          f'memory {peak_gb:.2f} GiB (max_memory_allocated); device time: '
        + ', '.join(f'{g} {ms:.2f} ms ({100 * ms / busy_ms:.1f}%)'
                    for g, ms in sorted(groups.items(), key=lambda x: -x[1]))
        + f'; loss first {loss[0]:.4f}, last {loss[-1]:.4f} (repeated batch; all: '
        + ', '.join(f'{v:.4f}' for v in loss.tolist()) + '); every backbone parameter got a '
          'nonzero gradient; K1 and K2 launches in training: 0')
    host = lambda batch: {k: v.cpu() for k, v in batch.items()}
    return dict(step_s=step_s, busy_share=busy_ms / wall_ms, peak_gb=peak_gb,
                batch=(host(b3), host(b2)), summary=summary)


def train_phase(root: Path, dev, frames, boxes, box_valid) -> dict:
    """The [train] phase (module docstring). Returns the K1 and K2 launches
    of the serving run after training and the median step time. The trained
    package stays at
    TRAINED_PACKAGE under `root` for [train_families]; the caller deletes
    it."""
    from metrabs_tpu_torch.config import AugConfig, ModelConfig, TrainConfig
    from metrabs_tpu_torch.io.packaging import save_pose_estimator_package
    from metrabs_tpu_torch.io.weights import flax_variables_from_state_dict
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17

    cfg = ModelConfig(**manifest_for('bfloat16')['model_config'])
    tcfg = TrainConfig()
    variables = mint_crop_variables(cfg, torch.Generator().manual_seed(tcfg.seed))
    torch.cuda.reset_peak_memory_stats()
    state, step = make_trainer(cfg, tcfg, variables, dev, fuse='on')
    if sum(getattr(b, 'fusable', False) and b.fuse == 'on'
           for b in state.model.backbone.blocks) != K2_BLOCKS:
        fail('train', f'expected {K2_BLOCKS} blocks built with fuse_mbconv on')
    run = train_steps(state, step, tcfg, dev, 'train', TRAIN_WARMUP, TRAIN_STEPS, fall_window=5)
    phase('train', f'EffNetV2-S@{PROC_SIDE} Metrabs, bf16 compute, f32 master weights, '
                   f'fuse_mbconv on, batch {tcfg.batch_size}+{tcfg.batch_size_2d}: '
                   + run['summary'])
    worst = train_parity(cfg, tcfg, variables, dev)
    phase('train', 'float32 step, GPU (TF32 off) vs CPU from the same state and mix: '
                   + ', '.join(f'{k} {v:.3g}' for k, v in worst.items()))

    # Serve the EMA weights through a package, kept for [train_families].
    package = root / TRAINED_PACKAGE
    save_pose_estimator_package(
        str(package), cfg=cfg, aug_cfg=AugConfig(), joint_info=H36M_17,
        crop_model_variables=flax_variables_from_state_dict(state.ema_state_dict()))
    del state
    chunks = math.ceil(int(box_valid.sum()) / (INTERNAL_BATCH // NUM_AUG))
    k1_folded = serve_folded(package, dev, frames, boxes, box_valid, 'train')[1]
    k1_fused, k2, err_v, n_blocks = serve_fused(package, dev, frames, boxes, box_valid,
                                                'train')[1:]
    phase('train', f'trained EMA weights packaged and served ({int(box_valid.sum())} valid '
                   f'boxes, {chunks} chunks): folded K1 launches {k1_folded}; unfused with '
                   f'fuse_mbconv on K1 {k1_fused}, K2 {k2}, K2 v vs plain on the trained '
                   f'weights {err_v:.3g} on the first chunk\'s input to each of the '
                   f'{n_blocks} blocks; poses finite')
    return dict(k1=k1_fused, k2=k2, step_s=run['step_s'])


def serve_folded(package: Path, dev, frames, boxes, box_valid, name: str):
    """`load_pose_estimator(package)` (bf16, BN folded) on the main frames and
    boxes, warmed up, then counted: K1 must run once per non-empty chunk and
    K2 never, the poses of valid boxes be finite. Returns (output, K1
    launches)."""
    from metrabs_tpu_torch.io.packaging import load_pose_estimator
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda

    chunks = math.ceil(int(box_valid.sum()) / (INTERNAL_BATCH // NUM_AUG))
    est = load_pose_estimator(str(package), device=dev)
    run = lambda: est.estimate_poses_batched(frames, boxes, box_valid, num_aug=NUM_AUG,
                                             internal_batch_size=INTERNAL_BATCH)
    run()  # warm-up
    torch.cuda.synchronize()
    warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
    out = run()
    torch.cuda.synchronize()
    k1, k2 = warp_cuda.warp_pyramid.launches, mbconv_cuda.fused_mbconv_inner.launches
    if not est.cfg.bn_fold or k1 != chunks or k2 != 0:
        fail(name, f'folded serving: bn_fold {est.cfg.bn_fold}, K1 launched {k1} times and K2 '
                   f'{k2}, expected {chunks} and 0')
    check_served_poses(out, dev, box_valid, name)
    return out, k1


def serve_fused(package: Path, dev, frames, boxes, box_valid, name: str):
    """`load_pose_estimator(package)` unfolded with `fuse_mbconv='on'` on the
    main frames and boxes: K1 must run once and K2 K2_BLOCKS times per
    non-empty chunk, and K2's v on the first chunk's input to each fused
    block equal the plain chain's on the package's weights. Returns (output,
    K1 launches, K2 launches, max |kernel - plain| of v, blocks checked)."""
    from metrabs_tpu_torch.io.packaging import load_pose_estimator
    from metrabs_tpu_torch.models.backbones.builder import build_backbone

    chunks = math.ceil(int(box_valid.sum()) / (INTERNAL_BATCH // NUM_AUG))
    fused = load_pose_estimator(str(package), device=dev, cfg_overrides={'bn_fold': False},
                                backbone_builder=functools.partial(build_backbone,
                                                                   fuse_mbconv='on'))
    out, k1, k2, err_v, n_blocks = k2_v_error(fused, lambda: fused.estimate_poses_batched(
        frames, boxes, box_valid, num_aug=NUM_AUG, internal_batch_size=INTERNAL_BATCH))
    if k1 != chunks or k2 != K2_BLOCKS * chunks:
        fail(name, f'fused serving: K1 launched {k1} times and K2 {k2}, expected {chunks} and '
                   f'{K2_BLOCKS * chunks}')
    if n_blocks != K2_BLOCKS or err_v != 0.0:
        fail(name, f'K2 on the trained weights: max |kernel - plain| v {err_v:.3g} over '
                   f'{n_blocks} blocks (must be 0)')
    check_served_poses(out, dev, box_valid, name)
    return out, k1, k2, err_v, n_blocks


def keep_first_input(inputs: dict, block, module, args, output) -> None:
    """A forward hook on a fused block's expand conv: keeps the output of its
    first call (the chain's input) in `inputs[block]`. It returns None, so
    the forward goes on with its own output."""
    if block not in inputs:
        inputs[block] = output.contiguous()


def k2_v_error(est, run):
    """`run()` once with K1's and K2's counts set to 0 and a hook on each
    fused block of `est`'s backbone keeping the first input to its chain;
    then K2 on each kept input against the plain chain on the block's
    constants (made from the loaded weights at the first call). Returns
    (run's output, K1 launches, K2 launches, max |kernel - plain| of v,
    blocks checked)."""
    from metrabs_tpu_torch.ops import mbconv, mbconv_cuda, warp_cuda

    fused_blocks = [b for b in est.crop_model.backbone.blocks if getattr(b, 'fusable', False)]
    inputs = {}
    hooks = [b.expand_conv.register_forward_hook(
        functools.partial(keep_first_input, inputs, b)) for b in fused_blocks]
    torch.cuda.synchronize()
    warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        for hook in hooks:
            hook.remove()
    k1, k2 = warp_cuda.warp_pyramid.launches, mbconv_cuda.fused_mbconv_inner.launches
    err_v = max((mbconv_cuda.fused_mbconv_inner(u, *b._inner_constants())[0].float()
                 - mbconv.fused_mbconv_inner(u, *b._inner_constants())[0].float()
                 ).abs().max().item() for b, u in inputs.items()) if inputs else math.inf
    return out, k1, k2, err_v, len(inputs)


def checked_warps(run):
    """`run()` with `warp_cuda.warp_pyramid` wrapped: each launch's crops are
    held against the plain `ops.warp.warp_pyramid` on the same tensors.
    Returns (run's output, max |kernel - plain| of each launch). The
    kernel's wrapper counts on the module's name, the wrapper here while it
    stands there: its count starts from the kernel's and goes back to it."""
    from metrabs_tpu_torch.ops import warp as warp_ops
    from metrabs_tpu_torch.ops import warp_cuda

    kernel, errors = warp_cuda.warp_pyramid, []

    def compared(flat, params, geom, output_shape, **kwargs):
        launches = compared.launches
        got = kernel(flat, params, geom, output_shape, **kwargs)
        if compared.launches != launches:
            want = warp_ops.warp_pyramid(flat, params, geom, output_shape)
            errors.append((got - want).abs().max().item())
        return got

    compared.launches = kernel.launches
    warp_cuda.warp_pyramid = compared
    try:
        return run(), errors
    finally:
        warp_cuda.warp_pyramid = kernel
        kernel.launches = compared.launches


def check_served_poses(out, dev, box_valid, name: str) -> None:
    valid_t = torch.as_tensor(box_valid, device=dev)
    if not torch.equal(out['valid'], valid_t) or not all(
            bool(torch.isfinite(out[k][valid_t]).all()) for k in ('poses3d', 'poses2d')):
        fail(name, 'non-finite poses or a wrong valid mask from a trained package')


# The [families] phase: (label, backbone, extra model config, build_crop_model
# arguments) of part (c), each in float32 on the GPU against the CPU.
FAMILY_CASES = (
    ('MobileNetV3-S-mini', 'mobilenetv3-small-mini', {}, {}),
    ('ResNet-18', 'resnet18', {}, {}),
    ('ResNet-50 V1.5-GroupNorm (unfolded)', 'resnet50v1-5-groupnorm', {}, {}),
    ('ResNet-50 V2 (unfolded)', 'resnet50v2', {}, {}),
    ('ResNet-50-stride16, stride_test 8', 'resnet50-stride16',
     dict(stride_train=16, stride_test=8), {}),
    ('Model25D on MobileNetV3-S-mini', 'mobilenetv3-small-mini', {},
     dict(model_class='model25d')),
    ('latent transform_coords on MobileNetV3-S-mini', 'mobilenetv3-small-mini', {},
     dict(latent_mode='transform_coords', n_latents=32)),
    ('latent predict_all_and_latents on MobileNetV3-S-mini', 'mobilenetv3-small-mini', {},
     dict(latent_mode='predict_all_and_latents', n_latents=32)))
FAMILY_DETECTOR = 'yolov8m'
RESIDUAL_GAIN = 0.3  # `family_variables`
FAMILY_DETECTOR_SIZE = 640


def family_manifest(backbone: str, dtype: str, model_config=None, detector: str = '',
                    **crop_model_kwargs) -> dict:
    """A package manifest of the minted crop model on `backbone` (plus
    `model_config` fields), of the class and latent mode of
    `crop_model_kwargs` (Model25D with the H36M bones at 300 mm), with a
    `detector` at FAMILY_DETECTOR_SIZE if one is named."""
    manifest = manifest_for(dtype)
    manifest['model_config'] = dict(manifest['model_config'], backbone=backbone,
                                    **(model_config or {}))
    manifest.update(model_class=crop_model_kwargs.get('model_class', 'metrabs'),
                    latent_mode=crop_model_kwargs.get('latent_mode', ''),
                    n_latents=crop_model_kwargs.get('n_latents', 0))
    if manifest['model_class'] == 'model25d':
        manifest.update(bones_25d=JOINT_EDGES, bone_lengths_ideal=[300.0] * len(JOINT_EDGES))
    if detector:
        manifest.update(has_detector=True, detector_type=detector, detector_dtype=dtype,
                        detector_input_size=FAMILY_DETECTOR_SIZE, detector_scan_repeats=True)
    return manifest


def family_variables(manifest: dict, gen: torch.Generator, dev):
    """Minted variables (`mint_crop_variables`) of the manifest's crop model,
    made to behave as a trained net's: the BatchNorm running statistics set
    to the batch statistics of 16 uniform random crops (one train-mode
    forward on `dev` in float32), then the last layer of each ResNet
    residual branch scaled by RESIDUAL_GAIN (trained ResNets keep their
    branches small). Without either, a random ResNet-50 is chaotic: its
    activations reach the thousands (ResNet V1's caffe input), some joints
    fall behind the camera, and a relative input change of 1e-6 moves its
    poses by ~3 mm on the CPU (0.006 mm with both)."""
    from metrabs_tpu_torch.config import ModelConfig
    from metrabs_tpu_torch.io.packaging import crop_model_kwargs
    from metrabs_tpu_torch.io.weights import (crop_model_state_dict_from_flax,
                                              flax_variables_from_state_dict)
    from metrabs_tpu_torch.models.backbones import resnet
    from metrabs_tpu_torch.models.backbones.common import GhostBatchNorm
    from metrabs_tpu_torch.models.metrabs import build_crop_model

    cfg = ModelConfig(**dict(manifest['model_config'], dtype='float32'))
    kwargs = crop_model_kwargs(manifest)
    variables = mint_crop_variables(cfg, gen, **kwargs)
    model = build_crop_model(cfg, **kwargs)
    model.load_state_dict(crop_model_state_dict_from_flax(variables, cfg, **kwargs))
    model.to(dev).train()
    for m in model.modules():
        if isinstance(m, GhostBatchNorm):
            m.momentum = 0.0
    crops = torch.rand((16, cfg.proc_side, cfg.proc_side, 3), generator=gen).to(dev)
    last_layers = {resnet.BottleneckBlock: 'bn3', resnet.BasicBlock: 'bn2',
                   resnet.PreactBlock: 'conv3'}
    with torch.no_grad():
        model.backbone(crops)
        for m in model.modules():
            if type(m) in last_layers:
                for p in getattr(m, last_layers[type(m)]).parameters():
                    p.mul_(RESIDUAL_GAIN)
    return flax_variables_from_state_dict(model.state_dict())


def timed_calls(run, n: int = 5):
    """Wall seconds of `n` CUDA-synchronised calls."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def families_phase(root: Path, dev, frames, boxes, box_valid) -> dict:
    """The [families] phase: (a) `detect_poses_batched` of ResNet-50@256
    (metrabs_rn50_y4's crop model) bf16 with BN folded, plus a YOLOv8-m@640
    bf16, on the main frames; (b) `estimate_poses_batched` of
    MobileNetV3-L@256 (metrabs_mob3l_y4t's) bf16 folded on the main frames
    and boxes; (c) every other family of FAMILY_CASES in float32 on the GPU
    against the CPU on a small frame, Metro built by `load_crop_model` and
    refused by `load_pose_estimator`, and a float32 YOLOv8-n's GPU and CPU
    detections. Returns the K1 and K2 launches of each path."""
    from metrabs_tpu_torch.config import AugConfig, ModelConfig
    from metrabs_tpu_torch.io.packaging import (detector_from_variables, load_crop_model,
                                                load_pose_estimator,
                                                pose_estimator_from_variables,
                                                save_pose_estimator_package)
    from metrabs_tpu_torch.models.metro import Metro
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17

    gen = torch.Generator().manual_seed(SEED + 5)
    launches = {}

    def count(run):
        torch.cuda.synchronize()
        warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
        out = run()
        torch.cuda.synchronize()
        return out, warp_cuda.warp_pyramid.launches, mbconv_cuda.fused_mbconv_inner.launches

    # (a) ResNet-50@256 + YOLOv8-m@640, detect path.
    manifest = family_manifest('resnet50', 'bfloat16', detector=FAMILY_DETECTOR)
    variables = family_variables(manifest, gen, dev)
    det_variables = mint_detector_variables(gen, FAMILY_DETECTOR)
    est = pose_estimator_from_variables(variables, manifest, device=dev,
                                        detector_variables=det_variables)
    if (not est.cfg.bn_fold or type(est.detector.model).__name__ != 'YOLOv8'
            or est.detector.input_size != FAMILY_DETECTOR_SIZE):
        fail('families', f'expected folded ResNet-50 and YOLOv8-m@{FAMILY_DETECTOR_SIZE}')
    detect = lambda: est.detect_poses_batched(
        frames, num_aug=NUM_AUG, max_detections=MAX_DETECTIONS,
        internal_batch_size=INTERNAL_BATCH, detector_threshold=0.0,
        suppress_implausible_poses=True)
    detect()  # warm-up (cuDNN algorithm selection)
    with torch.inference_mode():
        _, det_valid = est.detector.detect_batched(frames, threshold=0.0,
                                                   max_detections=MAX_DETECTIONS)
    n_detected = int(det_valid.sum())
    out, k1, k2 = count(detect)
    chunks = math.ceil(n_detected / (INTERNAL_BATCH // NUM_AUG))
    want_shapes = dict(boxes=(8, MAX_DETECTIONS, 5), poses3d=(8, MAX_DETECTIONS, 17, 3),
                       poses2d=(8, MAX_DETECTIONS, 17, 2), valid=(8, MAX_DETECTIONS))
    if {k: tuple(v.shape) for k, v in out.items()} != want_shapes:
        fail('families', f'detect output shapes {[tuple(v.shape) for v in out.values()]}')
    if n_detected == 0 or (out['valid'] & ~det_valid).any():
        fail('families', f'{n_detected} detections; the filter must only drop detections')
    for k in ('boxes', 'poses3d', 'poses2d'):
        if not torch.isfinite(out[k][det_valid]).all():
            fail('families', f'non-finite {k} on detected rows')
    if k1 != chunks or k2 != 0:
        fail('families', f'detect: K1 launched {k1} times and K2 {k2}, expected {chunks} and 0')
    launches['families_detect'] = (k1, k2)

    # The float32 pair on the GPU (TF32 off) against the CPU, small frame.
    manifest32 = family_manifest('resnet50', 'float32', detector=FAMILY_DETECTOR)
    ests32 = [pose_estimator_from_variables(variables, manifest32, device=d,
                                            detector_variables=det_variables)
              for d in (dev, 'cpu')]
    small = frames[:1, 300:660, 500:980].contiguous()
    small_kwargs = dict(num_aug=NUM_AUG, max_detections=4, detector_threshold=0.0,
                        suppress_implausible_poses=False)
    with torch.inference_mode():
        (b_got, v_got), (b_want, v_want) = [
            e.detector.detect_batched(x, threshold=0.0, max_detections=4)
            for e, x in zip(ests32, (small, small.cpu()))]
    box_err = (b_got.cpu() - b_want).abs().max().item()
    if not torch.equal(v_got.cpu(), v_want) or not box_err <= BOX_TOL_PX:
        fail('families', f'float32 GPU YOLOv8-m detections differ from the CPU: masks '
                         f'{v_got.tolist()} vs {v_want.tolist()}, boxes by {box_err:.3g} px')
    got32, want32 = [e.detect_poses_batched(x, **small_kwargs)
                     for e, x in zip(ests32, (small, small.cpu()))]
    v32 = want32['valid']
    det_pose_err = (got32['poses3d'].cpu()[v32] - want32['poses3d'][v32]).abs().max().item()
    if not torch.equal(got32['valid'].cpu(), v32) or not torch.allclose(
            got32['poses3d'].cpu()[v32], want32['poses3d'][v32], atol=POSE_ATOL_MM,
            rtol=POSE_RTOL):
        fail('families', f'float32 GPU ResNet-50 + YOLOv8-m poses differ from the CPU by '
                         f'{det_pose_err:.3g} mm')
    del ests32
    times = timed_calls(detect)
    wall_ms, device_ms, host_ms, busy_ms, n_kernels, counts = profile_detect(est, detect)
    phase('families', f'(a) detect_poses_batched YOLOv8-m@{FAMILY_DETECTOR_SIZE} bf16 + '
                      f'ResNet-50@{PROC_SIDE} bf16 folded, {N_FRAMES}x{FRAME_H}p, '
                      f'max_detections {MAX_DETECTIONS}, num_aug {NUM_AUG}, threshold 0: '
                      f'{n_detected} detections, {int(out["valid"].sum())} after the filter; '
                      f'K1 {k1}, K2 {k2} ({chunks} chunks); f32 GPU vs CPU: masks equal, max '
                      f'|dbox| {box_err:.3g} px, max |dpose| {det_pose_err:.3g} mm; '
                      f'{statistics.median(times) * 1e3:.1f} ms/call (median of {len(times)}; '
                      f'all: {", ".join(f"{t * 1e3:.1f}" for t in times)})')
    phase('families', f'(a) one call under torch.profiler: wall {wall_ms:.1f} ms, device busy '
                      f'{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), {n_kernels} kernels; '
                      + ', '.join(f'{name} {device_ms[name]:.3f} ms'
                                  + (f' (host {host_ms[name]:.1f} ms)' if name in host_ms else '')
                                  for name in sorted(device_ms, key=device_ms.get, reverse=True)))
    if counts['K1 (warp kernel)'] != k1:
        fail('families', f'the profiler saw {counts["K1 (warp kernel)"]} warp kernels, the '
                         f'wrapper counted {k1}')
    del est

    # (b) MobileNetV3-L@256, estimate path.
    manifest = family_manifest('mobilenetv3-large', 'bfloat16')
    est = pose_estimator_from_variables(family_variables(manifest, gen, dev), manifest,
                                        device=dev)
    if not est.cfg.bn_fold:
        fail('families', 'expected the folded MobileNetV3-L')
    run = lambda: est.estimate_poses_batched(frames, boxes, box_valid, num_aug=NUM_AUG,
                                             internal_batch_size=INTERNAL_BATCH)
    run()  # warm-up
    out, k1, k2 = count(run)
    chunks = math.ceil(int(box_valid.sum()) / (INTERNAL_BATCH // NUM_AUG))
    valid_t = torch.as_tensor(box_valid, device=dev)
    if not torch.equal(out['valid'], valid_t) or not all(
            bool(torch.isfinite(out[k][valid_t]).all()) for k in ('poses3d', 'poses2d')):
        fail('families', 'MobileNetV3-L: non-finite poses or a wrong valid mask')
    if k1 != chunks or k2 != 0:
        fail('families', f'estimate: K1 launched {k1} times and K2 {k2}, expected {chunks} '
                         f'and 0')
    launches['families_estimate'] = (k1, k2)
    times = timed_calls(run)
    wall_ms, device_ms, host_ms, busy_ms, n_kernels, counts = profile_detect(est, run)
    phase('families', f'(b) estimate_poses_batched MobileNetV3-L@{PROC_SIDE} bf16 folded, '
                      f'{N_FRAMES}x{FRAME_H}p, {int(box_valid.sum())} valid boxes, num_aug '
                      f'{NUM_AUG}: K1 {k1}, K2 {k2} ({chunks} chunks); '
                      f'{statistics.median(times) * 1e3:.1f} ms/call (median of {len(times)}; '
                      f'all: {", ".join(f"{t * 1e3:.1f}" for t in times)}); one call under '
                      f'torch.profiler: wall {wall_ms:.1f} ms, device busy {busy_ms:.2f} ms '
                      f'({100 * busy_ms / wall_ms:.1f}%), {n_kernels} kernels; '
                      + ', '.join(f'{name} {device_ms[name]:.3f} ms' for name in
                                  sorted(device_ms, key=device_ms.get, reverse=True)))
    del est

    # (c) Every other family, float32, GPU against CPU on a small frame.
    small = frames[:1, 400:700, 600:1000].contiguous()
    small_boxes = np.array([[[60, 20, 110, 250], [200, 40, 120, 240]]], np.float32)
    other = frames[1:2, 400:700, 600:1000].contiguous()
    k1_total = k2_total = 0
    results = []
    for label, backbone, model_config, kwargs in FAMILY_CASES:
        manifest = family_manifest(backbone, 'float32', model_config, **kwargs)
        variables = family_variables(manifest, gen, dev)
        pair = [pose_estimator_from_variables(variables, manifest, device=d)
                for d in (dev, 'cpu')]
        (got, k1, k2) = count(lambda: pair[0].estimate_poses_batched(small, small_boxes,
                                                                     num_aug=NUM_AUG))
        want = pair[1].estimate_poses_batched(small.cpu(), small_boxes, num_aug=NUM_AUG)
        moved = (pair[0].estimate_poses_batched(other, small_boxes, num_aug=NUM_AUG)['poses3d']
                 - got['poses3d']).abs().max().item()
        p_got, p_want = got['poses3d'].cpu(), want['poses3d']
        err = (p_got - p_want).abs().max().item()
        if not (torch.isfinite(p_got).all() and torch.allclose(p_got, p_want, atol=POSE_ATOL_MM,
                                                                  rtol=POSE_RTOL)):
            fail('families', f'{label}: float32 GPU poses differ from the CPU by {err:.3g} mm')
        if not moved > max(10 * err, POSE_ATOL_MM):
            fail('families', f'{label}: another frame moves the poses by {moved:.3g} mm only')
        if k1 != 1 or k2 != 0:
            fail('families', f'{label}: K1 launched {k1} times and K2 {k2}, expected 1 and 0')
        k1_total, k2_total = k1_total + k1, k2_total + k2
        results.append(f'{label} bn_fold={pair[0].cfg.bn_fold}: {err:.3g} mm (another frame '
                       f'moves them {moved:.1f} mm)')
        del pair
    launches['families_f32'] = (k1_total, k2_total)
    phase('families', '(c) float32 GPU (TF32 off) vs CPU, max |dpose|: ' + '; '.join(results))

    # Metro: a bare crop model, refused by the estimator loader.
    package = root / 'runs' / 'chip_smoke_metro_package'
    shutil.rmtree(package, ignore_errors=True)
    try:
        manifest = family_manifest('mobilenetv3-small-mini', 'float32', model_class='metro')
        save_pose_estimator_package(
            str(package), cfg=ModelConfig(**manifest['model_config']), aug_cfg=AugConfig(),
            joint_info=H36M_17, crop_model_variables=family_variables(manifest, gen, dev),
            model_class='metro')
        metro, _, _, _ = load_crop_model(str(package), device=dev)
        with torch.inference_mode():
            rel = metro(torch.rand((2, PROC_SIDE, PROC_SIDE, 3), device=dev))
        if not isinstance(metro, Metro) or rel.shape != (2, 17, 3) or not rel.isfinite().all():
            fail('families', f'load_crop_model gave {type(metro).__name__} {tuple(rel.shape)}')
        try:
            load_pose_estimator(str(package), device=dev)
            fail('families', 'load_pose_estimator accepted a Metro package')
        except ValueError as e:
            refusal = str(e).split(' (')[0]
    finally:
        shutil.rmtree(package, ignore_errors=True)

    # YOLOv8-n in float32: GPU and CPU detections.
    nano = mint_detector_variables(gen, 'yolov8n')
    manifest = family_manifest('mobilenetv3-small-mini', 'float32', detector='yolov8n')
    dets = [detector_from_variables(nano, manifest, bn_fold=False, device=d) for d in (dev, 'cpu')]
    small = frames[:1, 300:660, 500:980].contiguous()
    with torch.inference_mode():
        (b_got, v_got), (b_want, v_want) = [d.detect_batched(x, threshold=0.0, max_detections=4)
                                            for d, x in zip(dets, (small, small.cpu()))]
    box_err = (b_got.cpu() - b_want).abs().max().item()
    if not torch.equal(v_got.cpu(), v_want) or not box_err <= BOX_TOL_PX:
        fail('families', f'YOLOv8-n GPU detections differ from the CPU: masks {v_got.tolist()} '
                         f'vs {v_want.tolist()}, boxes by {box_err:.3g} px')
    phase('families', f'Metro: load_crop_model built {type(metro).__name__}, '
                      f'load_pose_estimator refused it ("{refusal}"); YOLOv8-n float32 GPU vs '
                      f'CPU: masks equal ({int(v_want.sum())} of {v_want.numel()}), max |dbox| '
                      f'{box_err:.3g} px')
    return launches


# The [train_families] phase: (label, build_crop_model arguments, TrainConfig
# fields) of each mode trained at EffNetV2-S@256, in this order; the last is
# warm-started from the [train] phase's package.
FAMILY_TRAIN_MODES = (
    ('Metro', dict(model_class='metro'), {}),
    ('Model25D', dict(model_class='model25d'), {}),
    ('transform_coords', dict(latent_mode='transform_coords'), dict(transform_coords=True)),
    ('predict_all_and_latents', dict(latent_mode='predict_all_and_latents'),
     dict(predict_all_and_latents=True)),
    ('regularize_to_manifold', {}, dict(regularize_to_manifold=True)))
FAMILY_N_LATENTS = 32  # latent points of the minted autoencoder
FAMILY_TRAIN_WARMUP, FAMILY_TRAIN_STEPS = 3, 5
FAMILY_FUSED_SERVE = 'transform_coords'  # the mode also served unfolded through K2
# The families train on examples of their own: the last mode warm-starts
# from a package trained on [train]'s batch, and fine-tuning on that same
# batch again has nothing left to fit.
FAMILY_FIRST_EXAMPLE = 1000
METRIC_RTOL = 1e-4  # GPU vs CPU eval metrics of the same predictions


def score_trained(package: Path, batch3d: dict, dev, label: str):
    """The package's crop model (bf16, eval mode) on its training batch
    `batch3d`, scored by `compute_pose3d_metrics` on the GPU and on the CPU
    from the same predictions, and `rigid_align` on both. Fails where a
    metric, or an aligned pose relative to the largest true coordinate,
    differs by more than METRIC_RTOL. Returns (GPU metrics, worst relative
    metric difference, max |aligned GPU - CPU| mm, the source lines of the
    host syncs in the GPU metrics call)."""
    import warnings

    from metrabs_tpu_torch.eval.metrics import compute_pose3d_metrics
    from metrabs_tpu_torch.io.packaging import load_crop_model
    from metrabs_tpu_torch.ops.procrustes import rigid_align
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17

    model, cfg, _, manifest = load_crop_model(str(package), device=dev)
    is_metro = manifest['model_class'] == 'metro'
    images = batch3d['image'].to(dev, getattr(torch, cfg.dtype))
    with torch.inference_mode():
        pred = (model(images) if is_metro
                else model(images, batch3d['intrinsics'].to(dev))).float()
    true, valid = batch3d['coords3d_true'], batch3d['joint_validity_mask']
    true_dev, valid_dev = true.to(dev), valid.to(dev)
    kwargs = dict(coords3d_pred_is_abs=not is_metro, joint_info=H36M_17)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            got = compute_pose3d_metrics(pred, true_dev, valid_dev, device=dev, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    syncs = [f'{Path(w.filename).name}:{w.lineno}' for w in caught
             if 'synchroniz' in str(w.message)]
    want = compute_pose3d_metrics(pred.cpu(), true, valid, device='cpu', **kwargs)
    rel = {k: abs(got[k].item() - w.item()) / max(abs(w.item()), 1e-30) for k, w in want.items()}
    if got.keys() != want.keys() or not all(
            torch.isfinite(v).all() for v in got.values()) or max(rel.values()) > METRIC_RTOL:
        fail('train_families', f'{label}: GPU metrics differ from the CPU\'s: {rel}')
    aligned = [rigid_align(p, t.to(p.device), joint_validity_mask=v.to(p.device),
                           scale_align=True).cpu() for p, t, v in
               ((pred, true, valid), (pred.cpu(), true, valid))]
    align_err = (aligned[0] - aligned[1]).abs().max().item()
    if not align_err <= METRIC_RTOL * true.abs().max().item():
        fail('train_families', f'{label}: rigid_align on the GPU differs from the CPU by '
                               f'{align_err:.3g} mm')
    return {k: v.item() for k, v in got.items()}, max(rel.values()), align_err, syncs


def train_families_phase(root: Path, dev, frames, boxes, box_valid, source_package: Path) -> dict:
    """The [train_families] phase: each of FAMILY_TRAIN_MODES trained at
    EffNetV2-S@256 as the [train] phase trains plain Metrabs (bf16 compute, f32
    master weights, TrainConfig defaults, 32 + 32 synthetic examples, one
    batch repeated), its step held in float32 against the CPU, packaged with
    the bone lengths of its 3D batches, scored on that batch and served.
    Returns the K1 and K2 launches of each path."""
    from metrabs_tpu_torch.apps.train import warm_start_backbone
    from metrabs_tpu_torch.config import AugConfig, ModelConfig, TrainConfig
    from metrabs_tpu_torch.io.checkpoints import load_model_msgpack
    from metrabs_tpu_torch.io.packaging import load_pose_estimator, save_pose_estimator_package
    from metrabs_tpu_torch.io.weights import (flax_variables_from_state_dict,
                                              torch_state_dict_from_flax)
    from metrabs_tpu_torch.pipeline.plausibility import BoneLengthStats
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17
    from metrabs_tpu_torch.train.loop import load_affine_weights

    name = 'train_families'
    cfg = ModelConfig(**manifest_for('bfloat16')['model_config'])
    work = root / 'runs' / 'chip_smoke_train_families'
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    gen = torch.Generator().manual_seed(SEED + 7)
    # The autoencoder, affine (each point's weights sum to 1), through its npz.
    w1 = torch.rand((17, FAMILY_N_LATENTS), generator=gen)
    w2 = torch.rand((FAMILY_N_LATENTS, 17), generator=gen)
    np.savez(work / 'affine.npz', w1=(w1 / w1.sum(0)).numpy(), w2=(w2 / w2.sum(0)).numpy())
    affine = load_affine_weights(str(work / 'affine.npz'))
    bones = [tuple(e) for e in H36M_17.edges]
    lengths = (torch.rand(len(bones), generator=gen) * 300 + 150).tolist()
    chunks = math.ceil(int(box_valid.sum()) / (INTERNAL_BATCH // NUM_AUG))
    launches = {'train_families': (0, 0), 'serve_trained_families': (0, 0)}
    table = []
    try:
        for label, model_kwargs, tcfg_fields in FAMILY_TRAIN_MODES:
            tcfg = TrainConfig(**tcfg_fields)
            kwargs = dict(model_kwargs)
            model_class = kwargs.get('model_class', 'metrabs')
            if kwargs.get('latent_mode'):
                kwargs['n_latents'] = FAMILY_N_LATENTS
            if model_class == 'model25d':
                kwargs.update(bones=bones, bone_lengths_ideal=lengths)
            ae = affine if kwargs.get('latent_mode') or tcfg.regularize_to_manifold else None
            variables = mint_crop_variables(cfg, gen, **kwargs)
            if kwargs.get('latent_mode'):
                variables['constants'] = dict(affine)
            torch.cuda.reset_peak_memory_stats()
            state, step = make_trainer(cfg, tcfg, variables, dev, model_kwargs=kwargs,
                                       affine_weights=ae)
            notes = []
            if tcfg.regularize_to_manifold:
                warm_start_backbone(state, str(source_package), cfg, apply_head_surgery=True)
                source = torch_state_dict_from_flax(load_model_msgpack(
                    str(source_package / 'crop_model.msgpack'))['variables'])
                own = state.model.state_dict()
                backbone = [k for k in source if k.startswith('backbone.')]
                head = [k for k in source if k.startswith('heatmap_heads.')]
                unequal = [k for k in backbone + head if not torch.equal(own[k].cpu(), source[k])]
                ema_reset = all(torch.equal(state.ema_params[k], p)
                                for k, p in state.model.named_parameters())
                if unequal or not backbone or not head or not ema_reset:
                    fail(name, f'warm start: {len(unequal)} of {len(backbone)} backbone and '
                               f'{len(head)} head tensors differ from the source (e.g. '
                               f'{unequal[:3]}); EMA reset {ema_reset}')
                notes.append(f'warm-started from the [train] package: {len(backbone)} backbone '
                             f'tensors and the head\'s last {cfg.n_joints} slots equal to the '
                             f'source bit for bit, EMA reset')
                variables = flax_variables_from_state_dict(state.model.state_dict())
            bone_stats = BoneLengthStats(H36M_17.edges)
            run = train_steps(state, step, tcfg, dev, name, FAMILY_TRAIN_WARMUP,
                              FAMILY_TRAIN_STEPS, fall_window=3, bone_stats=bone_stats,
                              first_example=FAMILY_FIRST_EXAMPLE)
            phase(name, f'{label}: ' + run['summary'])
            if tcfg.predict_all_and_latents:
                state.step = tcfg.teacher_start_step + 1
                l = {k: v.item() for k, v in step(state, *run['batch'],
                                                  generator=torch.Generator(device=dev)).items()}
                teacher = l['loss_3dbatch'] - (
                    l['loss_allhead_vs_gt'] + l['loss_latentheadreconstruction_vs_gt']
                    + tcfg.allhead_aegt_loss_factor * l['loss_allhead_ae_vs_gt']
                    + tcfg.loss_manif_factor * l['loss_allhead_vs_reconstr'])
                want = tcfg.teacher_loss_factor * l['loss_latenthead_vs_latents_from_allhead']
                if not (want > 0 and math.isfinite(l['loss'])
                        and abs(teacher - want) <= 1e-3 * want):
                    fail(name, f'{label}: the teacher term is not live past teacher_start_step: '
                               f'{teacher} vs {want}')
                notes.append(f'one step at step {tcfg.teacher_start_step + 1}: teacher term '
                             f'{teacher:.5f} (loss_latenthead_vs_latents_from_allhead '
                             f'{want:.5f}), loss {l["loss"]:.4f}')
            worst = train_parity(cfg, tcfg, variables, dev, name, kwargs, ae)
            notes.append('float32 step, GPU (TF32 off) vs CPU: '
                         + ', '.join(f'{k} {v:.3g}' for k, v in worst.items()))
            package = work / label
            save_pose_estimator_package(
                str(package), cfg=cfg, aug_cfg=AugConfig(), joint_info=H36M_17,
                crop_model_variables=flax_variables_from_state_dict(state.ema_state_dict()),
                bone_mean_lengths=bone_stats.mean_lengths(), model_class=model_class,
                latent_mode=kwargs.get('latent_mode', ''), n_latents=kwargs.get('n_latents', 0),
                bones_25d=kwargs.get('bones'), bone_lengths_ideal=kwargs.get('bone_lengths_ideal'))
            del state, step
            torch.cuda.empty_cache()
            metrics, rel, align_err, syncs = score_trained(package, run['batch'][0], dev, label)
            means = bone_stats.mean_lengths()
            notes.append(f'packaged with {len(means)} bone means from {bone_stats.n_samples}+ '
                         f'samples each ({means.min():.1f}-{means.max():.1f} mm); scored on its '
                         f'training batch, GPU vs CPU metrics within {rel:.3g} relative, '
                         f'rigid_align within {align_err:.3g} mm, {len(syncs)} host syncs in the '
                         f'GPU metrics call ({", ".join(syncs)}): '
                         + ', '.join(f'{k} {v:.4g}' for k, v in metrics.items()))
            if model_class == 'metro':
                try:
                    load_pose_estimator(str(package), device=dev)
                    fail(name, 'load_pose_estimator accepted a trained Metro package')
                except ValueError as e:
                    notes.append(f'load_pose_estimator refused it ("{str(e).split(" (")[0]}")')
            else:
                k1 = serve_folded(package, dev, frames, boxes, box_valid, name)[1]
                launches['serve_trained_families'] = (
                    launches['serve_trained_families'][0] + k1, 0)
                notes.append(f'served folded bf16: K1 {k1} ({chunks} chunks), K2 0, poses finite')
            if label == FAMILY_FUSED_SERVE:
                k1, k2, err_v, n_blocks = serve_fused(package, dev, frames, boxes, box_valid,
                                                      name)[1:]
                launches['serve_trained_family_fused'] = (k1, k2)
                notes.append(f'served unfolded with fuse_mbconv on: K1 {k1}, K2 {k2}, K2 v vs '
                             f'plain {err_v:.3g} over {n_blocks} blocks')
            phase(name, f'{label}: ' + '; '.join(notes))
            table.append(f'{label} {run["step_s"] * 1e3:.1f} ms/step, '
                         f'{(tcfg.batch_size + tcfg.batch_size_2d) / run["step_s"]:.1f} images/s, '
                         f'busy {100 * run["busy_share"]:.1f}%, peak {run["peak_gb"]:.2f} GiB')
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase(name, 'summary: ' + '; '.join(table))
    return launches


# The [train_app] phase: `apps.train.main` on a dataset minted under runs/.
TRAIN_APP_DIR = 'runs/chip_smoke_train_app'
TRAIN_APP_EXAMPLES = (64, 64, 32)  # 3D, 2D and held-out 3D examples
TRAIN_APP_FRAMES = 16  # distinct 1000x1000 PNG frames the examples are cut from
TRAIN_APP_FRAME_SIDE = 1000  # Human3.6M's frames are 1000x1000 (1002 rows for some cameras)
TRAIN_APP_STEPS, TRAIN_APP_RESUMED_STEPS = 24, 28
TRAIN_APP_PERIODS = dict(log=4, checkpoint=8, validate=12)
TRAIN_APP_LOADER_BATCHES = 3  # batches of 32 per stream in the loader-alone measurement


def mint_train_app_dataset(work: Path) -> dict:
    """Example pickles of the port's own classes over PNG frames written by
    the port's PNG writer (smooth random content, 1000x1000): 64
    `Example3D` (cameras of Human3.6M's intrinsics, every other one with its
    lens distortion, every other one with a foreground mask, so that the
    background augmentation runs), 64 `Example2D` (every fourth without a
    camera) and 32 held-out `Example3D`; people of 17 joints 3-6 m from
    the camera, their boxes from the projected joints. Returns the paths."""
    import pickle

    from metrabs_tpu_torch.data import cvfree
    from metrabs_tpu_torch.data.camera import Camera
    from metrabs_tpu_torch.data.loading import Example2D, Example3D

    rng = np.random.default_rng(SEED + 11)
    side = TRAIN_APP_FRAME_SIDE
    frame_paths = []
    (work / 'frames').mkdir(parents=True)
    for i in range(TRAIN_APP_FRAMES):
        coarse = rng.integers(0, 256, (12, 12, 3), dtype=np.uint8)
        frame = cvfree.resize(coarse, (side, side), cvfree.INTER_LINEAR)
        frame = np.clip(frame + rng.integers(-6, 7, frame.shape), 0, 255).astype(np.uint8)
        frame_paths.append(str(work / 'frames' / f'{i}.png'))
        cvfree.write_png(frame_paths[-1], frame)
    # A camera looking along the world's +y axis, z up, tilted down a little.
    tilt = np.deg2rad(10)
    rot = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32) @ np.array(
        [[1, 0, 0], [0, np.cos(tilt), -np.sin(tilt)], [0, np.sin(tilt), np.cos(tilt)]],
        np.float32)
    intrinsics = np.array([[1145.0, 0, 512.5], [0, 1143.8, 515.5], [0, 0, 1]], np.float32)
    distortion = np.array([-0.207, 0.248, -0.0009, -0.0014, -0.0031], np.float32)

    def camera(i):
        return Camera(optical_center=np.array([0, -4500, 1600], np.float32),
                      rot_world_to_cam=rot, intrinsic_matrix=intrinsics,
                      distortion_coeffs=distortion if i % 2 else None, world_up=(0, 0, 1))

    def person(i, cam):
        root = np.array([rng.uniform(-600, 600), rng.uniform(-400, 400),
                         rng.uniform(3000, 6000)], np.float32)
        in_cam = (root + rng.normal(0, 250, (17, 3))).astype(np.float32)
        world = cam.camera_to_world(in_cam).astype(np.float32)
        image_points = cam.world_to_image(world)
        (x0, y0), (x1, y1) = image_points.min(0) - 40, image_points.max(0) + 40
        return world, image_points, np.array([x0, y0, x1 - x0, y1 - y0], np.float32)

    def example3d(i):
        cam = camera(i)
        world, _, box = person(i, cam)
        mask = None
        if i % 4 < 2:
            mask = np.zeros((side, side), bool)
            x, y, w, h = np.clip(np.round(box), 0, side).astype(int)
            mask[y:y + h, x + w // 4:x + 3 * w // 4] = True
        return Example3D(image_path=frame_paths[i % TRAIN_APP_FRAMES], camera=cam, bbox=box,
                         world_coords=world, mask=mask)

    def example2d(i):
        cam = camera(i)
        _, image_points, box = person(i, cam)
        return Example2D(image_path=frame_paths[i % TRAIN_APP_FRAMES], bbox=box,
                         coords=image_points[:14].astype(np.float32),
                         camera=cam if i % 4 else None)

    n3, n2, n_val = TRAIN_APP_EXAMPLES
    paths = {}
    for name, examples in (('ds3d', [example3d(i) for i in range(n3)]),
                           ('ds2d', [example2d(i) for i in range(n2)]),
                           ('val', [example3d(n3 + i) for i in range(n_val)])):
        paths[name] = str(work / f'{name}.pkl')
        with open(paths[name], 'wb') as f:
            pickle.dump(examples, f)
    return paths


def loader_examples_per_s(paths: dict, workers: int) -> dict:
    """Examples per second of `ParallelBatchLoader` alone (the app's load
    functions, EffNetV2-S@256's config, every augmentation, `workers`
    threads), for the 3D and the 2D stream: TRAIN_APP_LOADER_BATCHES batches
    of 32 after one."""
    import itertools

    from metrabs_tpu_torch.config import ModelConfig
    from metrabs_tpu_torch.data.loading import (LoadConfig, load_and_transform2d,
                                                load_and_transform3d, load_examples)
    from metrabs_tpu_torch.data.pipeline import ParallelBatchLoader
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17, LSP_14

    cfg = ModelConfig(proc_side=PROC_SIDE)
    out = {}
    for name, load, joints in (('3d', load_and_transform3d, H36M_17),
                               ('2d', load_and_transform2d, LSP_14)):
        examples = load_examples(paths[f'ds{name}'])
        loader = ParallelBatchLoader(lambda ex, r: load(ex, joints, True, r, cfg, LoadConfig()),
                                     itertools.cycle(examples), 32, n_workers=workers, seed=SEED)
        try:
            next(loader)
            start = time.perf_counter()
            for _ in range(TRAIN_APP_LOADER_BATCHES):
                batch = next(loader)
            out[name] = 32 * TRAIN_APP_LOADER_BATCHES / (time.perf_counter() - start)
        finally:
            loader.close()
        if batch['image'].shape != (32, PROC_SIDE, PROC_SIDE, 3) or not np.isfinite(
                batch['image']).all():
            fail('train_app', f'the {name} loader gave {batch["image"].shape} images')
    return out


def train_app_phase(root: Path, dev, frames, boxes, box_valid, repeated_step_s: float) -> dict:
    """The [train_app] phase (module docstring). Returns the K1 and K2
    launches of the app's run and of serving its package."""
    import contextlib
    import io

    from metrabs_tpu_torch.apps import train as train_app
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda

    name = 'train_app'
    work = root / TRAIN_APP_DIR
    shutil.rmtree(work, ignore_errors=True)
    try:
        start = time.perf_counter()
        paths = mint_train_app_dataset(work)
        mint_s = time.perf_counter() - start
        workers = train_app.parse_args(['--ds3d', '', '--ds2d', '', '--checkpoint-dir', '']).workers
        loader_rate = loader_examples_per_s(paths, workers)
        ckpt, package = work / 'checkpoints', work / 'package'
        argv = ['--ds3d', paths['ds3d'], '--ds2d', paths['ds2d'], '--ds3d-val', paths['val'],
                '--checkpoint-dir', str(ckpt), '--export-dir', str(package),
                '--backbone', 'efficientnetv2-s', '--proc-side', str(PROC_SIDE),
                '--dtype', 'bfloat16', '--batch-size', '32', '--batch-size-2d', '32',
                '--log-period', str(TRAIN_APP_PERIODS['log']),
                '--checkpoint-period', str(TRAIN_APP_PERIODS['checkpoint']),
                '--validate-period', str(TRAIN_APP_PERIODS['validate']),
                '--absloss-start-step', str(TRAIN_APP_PERIODS['validate'])]
        runs = []
        torch.cuda.reset_peak_memory_stats()
        for steps in (TRAIN_APP_STEPS, TRAIN_APP_RESUMED_STEPS):
            out = io.StringIO()
            warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
            start = time.perf_counter()
            with contextlib.redirect_stdout(out):
                train_app.main(argv + ['--training-steps', str(steps)])
            torch.cuda.synchronize()
            runs.append(dict(seconds=time.perf_counter() - start, stdout=out.getvalue(),
                             checkpoints=sorted(int(p.stem) for p in ckpt.glob('*.pt')),
                             launches=(warp_cuda.warp_pyramid.launches,
                                       mbconv_cuda.fused_mbconv_inner.launches)))
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        log = [json.loads(line) for line in (ckpt / 'train_log.jsonl').read_text().splitlines()]
        losses = [r for r in log if 'loss' in r]
        vals = [r for r in log if 'val_mean_error' in r]
        period = TRAIN_APP_PERIODS['log']
        want_steps = list(range(period, TRAIN_APP_RESUMED_STEPS + 1, period))
        if [r['step'] for r in losses] != want_steps or not all(
                math.isfinite(r['loss']) for r in losses):
            fail(name, f'loss records {losses}, expected finite ones at steps {want_steps}')
        if [r['step'] for r in vals] != [12, 24] or not all(
                math.isfinite(v) for r in vals for k, v in r.items() if k.startswith('val_')):
            fail(name, f'validation records {vals}, expected finite ones at steps 12 and 24')
        if runs[0]['checkpoints'] != [16, 24] or runs[1]['checkpoints'] != [24, 28]:
            fail(name, f'checkpoints {runs[0]["checkpoints"]} after the first run and '
                       f'{runs[1]["checkpoints"]} after the second, expected [16, 24], [24, 28]')
        resumed = torch.load(ckpt / '28.pt', map_location='cpu', weights_only=True)['step']
        if (f'restored checkpoint at step {TRAIN_APP_STEPS}' not in runs[1]['stdout']
                or resumed != TRAIN_APP_RESUMED_STEPS
                or [r['step'] for r in losses if r['step'] > TRAIN_APP_STEPS] != [28]):
            fail(name, f'the second run did not restore step {TRAIN_APP_STEPS} and take '
                       f'{TRAIN_APP_RESUMED_STEPS - TRAIN_APP_STEPS} steps (checkpoint step '
                       f'{resumed})')
        if any(r['launches'] != (0, 0) for r in runs):
            fail(name, f'the app launched K1 and K2 {[r["launches"] for r in runs]} times')
        manifest = json.loads((package / 'manifest.json').read_text())
        means = np.asarray(manifest.get('bone_mean_lengths') or [np.nan], np.float64)
        if means.shape != (16,) or not (np.isfinite(means).all() and (means > 0).all()):
            fail(name, f'bone means {means} in the exported manifest')
        # Windows of log_period steps after the first (which holds the
        # warm-up), the feed included, validation and checkpoints not.
        window_s = [period / r['steps_per_sec'] for r in losses[1:]
                    if r['step'] <= TRAIN_APP_STEPS]
        step_s = statistics.median(window_s) / period
        k1_folded = serve_folded(package, dev, frames, boxes, box_valid, name)[1]
        k1_fused, k2, err_v, n_blocks = serve_fused(package, dev, frames, boxes, box_valid,
                                                    name)[1:]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n_images = 64
    phase(name, f'dataset minted in {mint_s:.1f} s: {TRAIN_APP_EXAMPLES[0]} Example3D, '
                f'{TRAIN_APP_EXAMPLES[1]} Example2D, {TRAIN_APP_EXAMPLES[2]} held out, over '
                f'{TRAIN_APP_FRAMES} {TRAIN_APP_FRAME_SIDE}x{TRAIN_APP_FRAME_SIDE} PNG frames')
    phase(name, f'loader alone ({workers} threads, every augmentation, {PROC_SIDE} px): '
                f'3D {loader_rate["3d"]:.1f} examples/s, 2D {loader_rate["2d"]:.1f} examples/s')
    phase(name, f'apps.train.main EffNetV2-S@{PROC_SIDE} bf16 32+32 through the real loader: '
                f'{TRAIN_APP_STEPS} steps in {runs[0]["seconds"]:.1f} s, then resumed at step '
                f'{TRAIN_APP_STEPS} to {TRAIN_APP_RESUMED_STEPS} in {runs[1]["seconds"]:.1f} s; '
                f'median step {step_s * 1e3:.1f} ms ({n_images / step_s:.1f} images/s) over '
                f'{len(window_s)} windows of {period} steps (all: '
                + ', '.join(f'{1e3 * w / period:.1f}' for w in window_s)
                + f'); [train] repeated batch in this run {repeated_step_s * 1e3:.1f} ms '
                  f'({n_images / repeated_step_s:.1f} images/s); peak {peak_gb:.2f} GiB; losses '
                + ', '.join(f'{r["step"]}: {r["loss"]:.4f}' for r in losses)
                + '; validation ' + '; '.join(
                    f'step {r["step"]}: MPJPE {r["val_mean_error"]:.1f} mm, PCK '
                    f'{r["val_mean_pck"]:.3f} in {r["seconds"]:.1f} s' for r in vals))
    phase(name, f'checkpoints {runs[0]["checkpoints"]} then {runs[1]["checkpoints"]}, the second '
                f'run restored step {TRAIN_APP_STEPS} and took '
                f'{TRAIN_APP_RESUMED_STEPS - TRAIN_APP_STEPS} steps; K1 and K2 launches in the '
                f'app: 0; package bone means {means.min():.1f}-{means.max():.1f} mm; served '
                f'folded K1 {k1_folded}, unfolded with fuse_mbconv on K1 {k1_fused}, K2 {k2}, '
                f'K2 v vs plain {err_v:.3g} over {n_blocks} blocks')
    return {'train_app': (0, 0), 'serve_train_app': (k1_folded + k1_fused, k2)}


IMPORT_MODEL = 'metrabs_eff2s_y4'  # EffNetV2-S@256 crop model + YOLOv4-416, both bf16
IMPORT_K = 2  # frame batches per stream call
IMPORT_PIPELINED = 3  # frame batches through detect_poses_pipelined
# Stream, pipelined and batched calls run the same kernels in the same order
# on the same inputs, so they are expected to agree exactly; the tolerance
# only admits a cuDNN algorithm that sums in another order between calls.
STREAM_TOL = dict(boxes_px=BOX_TOL_PX, poses_mm=POSE_ATOL_MM)


def zeros_template(module) -> dict:
    """The JAX-layout variable tree of `module` (built on the meta device),
    zero-filled: an importer's template that holds no value of its own."""
    from metrabs_tpu_torch.io.weights import flax_variables_from_state_dict
    return flax_variables_from_state_dict(
        {k: torch.zeros(v.shape) for k, v in module.state_dict().items()})


def trees_equal(got: dict, want: dict) -> bool:
    """Same paths, dtypes, shapes and bits."""
    from metrabs_tpu_torch.io.weights import flatten_dict
    got, want = flatten_dict(got), flatten_dict(want)
    return got.keys() == want.keys() and all(
        got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)


def max_diff(got: dict, want: dict, rows) -> tuple:
    """(valid masks equal, max |dbox| px, max |dpose3d| mm) on `rows`."""
    same_valid = torch.equal(torch.as_tensor(got['valid']).to(rows.device), want['valid'])
    diff = lambda k: (torch.as_tensor(got[k]).to(rows.device)[rows] - want[k][rows]).abs().max()
    return same_valid, diff('boxes').item(), diff('poses3d').item()


def import_phase(root: Path, dev, frames, boxes, box_valid) -> dict:
    """The [import] phase: the released metrabs_eff2s_y4 (EffNetV2-S@256 and
    YOLOv4-416, bf16) with weights minted from a seed, written in the
    released formats (a TF TensorBundle under the reference fork's names, a
    darknet yolov4.weights) and read back bit for bit by the port's
    importers, packaged with its detector by the port's writer, loaded
    unfolded with `fuse_mbconv='on'`, then `detect_poses_stream` (K=2),
    `detect_poses_pipelined` (3 batches) and `estimate_poses_stream` (K=2)
    against the batched calls, F3 and F2 on the card, the K1 and K2 launches
    of one profiled stream call and the stream and batched times. Returns
    the K1 and K2 launches of the counted stream call."""
    from metrabs_tpu_torch.detect.yolov4 import (build_detector_model, load_darknet_weights,
                                                 write_darknet_weights)
    from metrabs_tpu_torch.io import tf_checkpoint, weights_import
    from metrabs_tpu_torch.io.packaging import load_pose_estimator, save_pose_estimator_package
    from metrabs_tpu_torch.io.weights import flatten_dict
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    from metrabs_tpu_torch.models.metrabs import build_crop_model
    from metrabs_tpu_torch.models.registry import get_named_model
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17

    named = get_named_model(IMPORT_MODEL)
    cfg = named.model_config(dtype='bfloat16', n_joints=17, backbone_scan_blocks=False)
    gen = torch.Generator().manual_seed(SEED + 6)
    t0 = time.perf_counter()
    minted = mint_crop_variables(cfg, gen)
    minted_det = mint_detector_variables(gen, named.detector)
    work = root / 'runs' / f'chip_smoke_import_{os.getpid()}'
    try:
        # The released formats, written by the port's own code.
        prefix = str(work / 'saved_model' / 'variables' / 'variables')
        pairs = (weights_import.import_backbone_from_tf(None, minted, cfg.backbone)
                 + weights_import.import_metrabs_head_from_tf(None, minted))
        flat = {'/'.join(k): v for k, v in flatten_dict(minted).items()}
        if sorted(p for p, _, _ in pairs) != sorted(flat):
            fail('import', 'the TF mapping does not cover the crop model exactly')
        # `_dw`, the one transform, swaps two axes: it is its own inverse.
        tf_checkpoint.write_tf_checkpoint(prefix, {name: (t or np.asarray)(flat[path])
                                                   for path, name, t in pairs})
        darknet = str(work / 'yolov4.weights')
        write_darknet_weights(minted_det, darknet)
        sizes = [os.path.getsize(prefix + '.data-00000-of-00001'), os.path.getsize(darknet)]

        # Read back into zero templates of the port's modules.
        with torch.device('meta'):
            crop_module = build_crop_model(cfg)
            det_module = build_detector_model(named.detector)
        tf_vars = tf_checkpoint.load_tf_checkpoint(prefix)
        imported = weights_import.import_metrabs_head_from_tf(
            tf_vars, weights_import.import_backbone_from_tf(tf_vars, zeros_template(crop_module),
                                                            cfg.backbone))
        imported_det = load_darknet_weights(zeros_template(det_module), darknet)
        if not trees_equal(imported, minted) or not trees_equal(imported_det, minted_det):
            fail('import', 'an imported leaf differs from the minted one')
        n_leaves = (len(flatten_dict(imported)), len(flatten_dict(imported_det)))
        pkg = str(work / 'package')
        save_pose_estimator_package(
            pkg, cfg=cfg, aug_cfg=named.aug_config(), crop_model_variables=imported,
            joint_info=H36M_17, detector_variables=imported_det, detector_type=named.detector,
            detector_dtype='bfloat16', detector_input_size=DETECTOR_SIZE)
        est = load_pose_estimator(
            pkg, device=dev, cfg_overrides={'bn_fold': False},
            backbone_builder=functools.partial(build_backbone, fuse_mbconv='on'))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    io_s = time.perf_counter() - t0
    fused_blocks = sum(getattr(b, 'fusable', False) and b.fuse == 'on'
                       for b in est.crop_model.backbone.blocks)
    if est.cfg.bn_fold or est.cfg.dtype != 'bfloat16' or fused_blocks != K2_BLOCKS:
        fail('import', f'expected the unfolded bf16 model with {K2_BLOCKS} fused blocks')
    phase('import', f'{IMPORT_MODEL}: minted, written as a TF TensorBundle ({len(pairs)} '
                    f'variables, {sizes[0] / 1e6:.1f} MB) and a darknet yolov4.weights '
                    f'({sizes[1] / 1e6:.1f} MB), read back: all {n_leaves[0]} crop-model and '
                    f'{n_leaves[1]} detector leaves equal the minted ones bit for bit; packaged '
                    f'with the detector and loaded unfolded, fuse_mbconv on, in {io_s:.1f} s')

    frames_k = torch.stack([frames, torch.flip(frames, dims=[2])])
    kwargs = dict(num_aug=NUM_AUG, max_detections=MAX_DETECTIONS,
                  internal_batch_size=INTERNAL_BATCH, detector_threshold=0.0,
                  suppress_implausible_poses=True)
    est.detect_poses_batched(frames, **kwargs)  # warm-up (cuDNN algorithm selection)
    with torch.inference_mode():
        det_valid = [est.detector.detect_batched(f, threshold=0.0,
                                                 max_detections=MAX_DETECTIONS)[1]
                     for f in frames_k]
    if not all(bool(v.all()) for v in det_valid):
        fail('import', f'threshold 0 left detection slots empty: '
                       f'{[int(v.sum()) for v in det_valid]} of {N_FRAMES * MAX_DETECTIONS}')
    chunks = sum(math.ceil(int(v.sum()) / (INTERNAL_BATCH // NUM_AUG)) for v in det_valid)
    stream = lambda: est.detect_poses_stream(frames_k, **kwargs)
    torch.cuda.synchronize()
    warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
    out = stream()
    torch.cuda.synchronize()
    k1, k2 = warp_cuda.warp_pyramid.launches, mbconv_cuda.fused_mbconv_inner.launches
    want_shapes = dict(boxes=(IMPORT_K, N_FRAMES, MAX_DETECTIONS, 5),
                       poses3d=(IMPORT_K, N_FRAMES, MAX_DETECTIONS, 17, 3),
                       poses2d=(IMPORT_K, N_FRAMES, MAX_DETECTIONS, 17, 2),
                       valid=(IMPORT_K, N_FRAMES, MAX_DETECTIONS))
    if {k: tuple(v.shape) for k, v in out.items()} != want_shapes:
        fail('import', f'stream output shapes {[tuple(v.shape) for v in out.values()]}')
    if k1 != chunks or k2 != K2_BLOCKS * chunks:
        fail('import', f'detect_poses_stream launched K1 {k1} and K2 {k2} times, expected '
                       f'{chunks} and {K2_BLOCKS * chunks} ({chunks} non-empty chunks)')

    # Stream and pipelined against batched calls, on the detector's rows.
    batches = [frames_k[0], frames_k[1], torch.flip(frames, dims=[1])]
    batched = [est.detect_poses_batched(b, **kwargs) for b in batches]
    with torch.inference_mode():
        det_valid.append(est.detector.detect_batched(batches[2], threshold=0.0,
                                                     max_detections=MAX_DETECTIONS)[1])
    checks = [('stream', k, {key: v[k] for key, v in out.items()}) for k in range(IMPORT_K)]
    pipelined = list(est.detect_poses_pipelined(iter(batches), in_flight=2, **kwargs))
    if len(pipelined) != IMPORT_PIPELINED:
        fail('import', f'detect_poses_pipelined gave {len(pipelined)} results')
    checks += [('pipelined', k, r) for k, r in enumerate(pipelined)]
    worst = {}
    for name, k, got in checks:
        same_valid, box_err, pose_err = max_diff(got, batched[k], det_valid[k])
        if not (torch.isfinite(batched[k]['poses3d'][det_valid[k]]).all() and same_valid
                and box_err <= STREAM_TOL['boxes_px'] and pose_err <= STREAM_TOL['poses_mm']):
            fail('import', f'{name} batch {k} differs from detect_poses_batched: masks equal '
                           f'{same_valid}, boxes by {box_err:.3g} px, poses by {pose_err:.3g} mm')
        prev = worst.get(name, (0.0, 0.0))
        worst[name] = (max(prev[0], box_err), max(prev[1], pose_err))

    # estimate_poses_stream with the main phase's boxes.
    est_kwargs = dict(num_aug=NUM_AUG, internal_batch_size=INTERNAL_BATCH)
    est_stream = est.estimate_poses_stream(frames_k, np.stack([boxes] * IMPORT_K),
                                           np.stack([box_valid] * IMPORT_K), **est_kwargs)
    valid_t = torch.as_tensor(box_valid, device=dev)
    est_err = 0.0
    for k in range(IMPORT_K):
        want = est.estimate_poses_batched(frames_k[k], boxes, box_valid, **est_kwargs)
        same_valid, _, err = max_diff({key: v[k] for key, v in est_stream.items()}, want, valid_t)
        if not same_valid or not err <= STREAM_TOL['poses_mm']:
            fail('import', f'estimate_poses_stream batch {k} differs by {err:.3g} mm')
        est_err = max(est_err, err)

    # F3: the detect output's CUDA boxes go back in; F2: zero boxes.
    f3 = est.estimate_poses_batched(frames, batched[0]['boxes'][..., :4], det_valid[0],
                                    **est_kwargs)
    f3_err = (f3['poses3d'] - batched[0]['poses3d'])[det_valid[0]].abs().max().item()
    if not torch.equal(f3['valid'], det_valid[0]) or not f3_err <= STREAM_TOL['poses_mm']:
        fail('import', f'F3: poses from the CUDA boxes differ by {f3_err:.3g} mm')
    for average_aug, aug in ((True, ()), (False, (NUM_AUG,))):
        f2 = est.estimate_poses_batched(frames, np.zeros((N_FRAMES, 0, 4)), num_aug=NUM_AUG,
                                        average_aug=average_aug)
        if {k: tuple(v.shape) for k, v in f2.items()} != dict(
                boxes=(N_FRAMES, 0, 5), poses3d=(N_FRAMES, 0, *aug, 17, 3),
                poses2d=(N_FRAMES, 0, *aug, 17, 2), valid=(N_FRAMES, 0)):
            fail('import', f'F2: zero boxes gave {[tuple(v.shape) for v in f2.values()]}')
    phase('import', f'detect_poses_stream K={IMPORT_K} x {N_FRAMES}x{FRAME_H}p: K1 {k1}, K2 '
                    f'{k2} ({chunks} chunks); stream vs batched: masks equal, max |dbox| '
                    f'{worst["stream"][0]:.3g} px, max |dpose| {worst["stream"][1]:.3g} mm; '
                    f'pipelined (in_flight 2, {IMPORT_PIPELINED} batches) vs batched: max |dbox| '
                    f'{worst["pipelined"][0]:.3g} px, max |dpose| {worst["pipelined"][1]:.3g} '
                    f'mm; estimate_poses_stream vs batched: max |dpose| {est_err:.3g} mm '
                    f'(tolerances {STREAM_TOL}); F3: CUDA boxes back in, max |dpose| '
                    f'{f3_err:.3g} mm; F2: zero boxes give empty shapes')

    # K1 and K2 under the profiler (again where it lost records), then times
    # per frame batch.
    for _ in range(TIMING_TRIES):
        wall_ms, device_ms, _, busy_ms, n_kernels, counts = profile_detect(est, stream)
        seen = (counts['K1 (warp kernel)'], counts['K2 (mbconv kernel)'])
        if seen == (k1, k2):
            break
        phase('import', f'the profiler saw K1 and K2 {seen} times in one stream call, the '
                        f'wrappers counted {(k1, k2)}: profiling again')
    else:
        fail('import', f'the profiler never saw the {k1} K1 and {k2} K2 launches the wrappers '
                       f'counted in one stream call')
    b_wall_ms, _, _, b_busy_ms, b_kernels, _ = profile_detect(
        est, lambda: est.detect_poses_batched(frames, **kwargs))
    stream_times = [t / IMPORT_K for t in timed_calls(stream)]
    batched_times = timed_calls(lambda: est.detect_poses_batched(frames, **kwargs))
    fmt = lambda ts: ', '.join(f'{t * 1e3:.1f}' for t in ts)
    phase('import', f'per frame batch: stream {statistics.median(stream_times) * 1e3:.1f} ms, '
                    f'batched {statistics.median(batched_times) * 1e3:.1f} ms (medians of 5; '
                    f'all: stream {fmt(stream_times)}; batched {fmt(batched_times)})')
    phase('import', f'one stream call under torch.profiler: wall {wall_ms:.1f} ms, device busy '
                    f'{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), {n_kernels} kernels, K1 '
                    f'{counts["K1 (warp kernel)"]} ({device_ms["K1 (warp kernel)"]:.3f} ms), K2 '
                    f'{counts["K2 (mbconv kernel)"]} ({device_ms["K2 (mbconv kernel)"]:.3f} ms); '
                    f'one batched call: wall {b_wall_ms:.1f} ms, busy {b_busy_ms:.2f} ms '
                    f'({100 * b_busy_ms / b_wall_ms:.1f}%), {b_kernels} kernels')
    return {'import_stream': (k1, k2)}


# The [bench_apps] phase: the benchmark drivers on JPEG layouts minted under
# runs/ from the committed fixtures (the card's machine has no JPEG encoder).
BENCH_DIR = 'runs/chip_smoke_bench_apps'
JPEG_FIXTURES = 'tests/torch_fixtures/jpeg'
FRAME_3DPW, FRAME_H36M = 'frame_3dpw_1080x1920.jpg', 'frame_h36m_1000x1002.jpg'
DECODE_REPEATS = 20  # single-thread decodes of the 1080x1920 frame, median taken
DECODE_THREADS = 8  # predict_*'s default --io-threads
BENCH_3DPW = dict(sequences=2, frames=24, tracks=2)
BENCH_H36M = dict(frames=64, frame_step=8)  # S9, one activity, 4 cameras: 32 examples
# 3DPW's published intrinsics (portrait 1080x1920) and Human3.6M's (camera 54138969).
K_3DPW = np.array([[1961.9, 0, 540.0], [0, 1969.2, 960.0], [0, 0, 1]])
K_H36M = np.array([[1145.05, 0, 512.54], [0, 1143.78, 515.45], [0, 0, 1]])


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def check_decoder(root: Path) -> dict:
    """Every fixture decoded and held to its manifest hash (cv2's decode on
    the machine that wrote them); the 1080x1920 frame's decode time on one
    thread and frames/s on DECODE_THREADS."""
    import hashlib

    from metrabs_tpu_torch.data import improc, jpeg

    manifest = json.loads((root / JPEG_FIXTURES / 'manifest.json').read_text())
    wrong = [name for name, entry in sorted(manifest.items())
             if hashlib.sha256(improc.imread(str(root / JPEG_FIXTURES / name)).tobytes())
             .hexdigest() != entry['sha256_rgb']]
    if wrong:
        fail('bench_apps', f'{len(wrong)} of {len(manifest)} fixtures decode differently from '
                           f'cv2: {wrong}')
    data = (root / JPEG_FIXTURES / FRAME_3DPW).read_bytes()
    times = []
    for _ in range(DECODE_REPEATS):
        t0 = time.perf_counter()
        jpeg.decode(data)
        times.append(time.perf_counter() - t0)
    n = 8 * DECODE_THREADS
    with concurrent.futures.ThreadPoolExecutor(DECODE_THREADS) as pool:
        list(pool.map(jpeg.decode, [data] * DECODE_THREADS))
        t0 = time.perf_counter()
        list(pool.map(jpeg.decode, [data] * n))
        fps = n / (time.perf_counter() - t0)
    return dict(n=len(manifest), ms=statistics.median(times) * 1e3,
                all_ms=[t * 1e3 for t in times], fps=fps, kib=len(data) / 1024)


def mint_3dpw_layout(root: Path, rng, frame: Path) -> None:
    """sequenceFiles/test/*.pkl (latin1-readable pickles: SMPL-24 world
    joints in metres, cam_poses, campose_valid, poses2d) and the frames,
    copies of the portrait fixture."""
    import pickle

    from metrabs_tpu_torch.data.camera import Camera

    n, n_tracks = BENCH_3DPW['frames'], BENCH_3DPW['tracks']
    cam = Camera(intrinsic_matrix=K_3DPW, world_up=(0, -1, 0))
    for i_seq in range(BENCH_3DPW['sequences']):
        name = f'bench_{i_seq:02d}'
        joints, poses2d = [], []
        for t in range(n_tracks):
            centre = np.array([(t - 0.5) * 900, 200, 4500.0])
            world = centre + rng.normal(0, 200, (n, 24, 3)) + np.arange(n)[:, None, None] * [8, 0, 0]
            joints.append((world / 1000).reshape(n, 72))
            image = cam.world_to_image(world.reshape(-1, 3)).reshape(n, 24, 2)
            coco = np.concatenate([image[:, :18], np.full((n, 18, 1), 0.9)], -1)
            poses2d.append(np.transpose(coco, (0, 2, 1)))
        seq = dict(sequence=name, cam_intrinsics=K_3DPW, jointPositions=joints,
                   cam_poses=np.tile(np.eye(4), (n, 1, 1)),
                   campose_valid=np.ones((n_tracks, n), bool), poses2d=poses2d)
        (root / 'sequenceFiles' / 'test').mkdir(parents=True, exist_ok=True)
        (root / 'sequenceFiles' / 'test' / f'{name}.pkl').write_bytes(pickle.dumps(seq, 2))
        (root / 'imageFiles' / name).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            shutil.copyfile(frame, root / 'imageFiles' / name / f'image_{i:05d}.jpg')


def mint_h36m_layout(root: Path, rng, frame: Path) -> str:
    """S9 with one activity: D3_Positions/Walking.cdf (the port's CDF writer),
    BBoxes/Walking.<camera>.npy and every frame_step-th frame per camera (copies
    of the 1000x1002 fixture), cameras.json around a person at the origin.
    Returns the cameras JSON's path."""
    from metrabs_tpu_torch.data import datasets
    from metrabs_tpu_torch.data.camera import Camera
    from metrabs_tpu_torch.utils.cdf import write_cdf

    n, step = BENCH_H36M['frames'], BENCH_H36M['frame_step']
    base = root / 'S9'
    (base / 'MyPoseFeatures' / 'D3_Positions').mkdir(parents=True)
    (base / 'BBoxes').mkdir()
    world = rng.normal(0, 200, (n, 32, 3)) + [0, 0, 1000.0]
    write_cdf(str(base / 'MyPoseFeatures' / 'D3_Positions' / 'Walking.cdf'),
              {'Pose': world.reshape(1, n, 96)})
    cameras = dict(intrinsics={}, extrinsics={'S9': {}})
    for i_cam, cam_id in enumerate(datasets.H36M_CAMERA_IDS):
        yaw = np.pi / 4 + i_cam * np.pi / 2
        forward = -np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.cross(forward, [0, 0, 1.0])
        rot = np.stack([right, [0, 0, -1.0], forward])
        centre = -4500 * forward + [0, 0, 1000.0]
        cameras['intrinsics'][cam_id] = dict(calibration_matrix=K_H36M.tolist(),
                                             distortion=[-0.207, 0.248, -0.0009, -0.0014, -0.0031])
        cameras['extrinsics']['S9'][cam_id] = dict(R=rot.tolist(), t=(-rot @ centre).tolist())
        cam = Camera(optical_center=centre, rot_world_to_cam=rot, intrinsic_matrix=K_H36M)
        joints = world[:, list(datasets.H36M_RELEVANT_JOINTS)]
        boxes = np.stack([datasets.boxes_from_joints(cam.world_to_image(j)) for j in joints])
        np.save(base / 'BBoxes' / f'Walking.{cam_id}.npy', boxes)
        (base / 'Images' / f'Walking.{cam_id}').mkdir(parents=True)
        for k in range(0, n, step):
            shutil.copyfile(frame, base / 'Images' / f'Walking.{cam_id}' / f'frame_{k:06d}.jpg')
    (root / 'cameras.json').write_text(json.dumps(cameras))
    return str(root / 'cameras.json')


def bench_package(path: Path, gen, joint_info, with_detector: bool) -> None:
    """metrabs_eff2s_y4 (EffNetV2-S@256, bf16) minted as [import] mints it,
    on `joint_info`'s joints, with a YOLOv4-416 whose heads fire."""
    from metrabs_tpu_torch.io.packaging import save_pose_estimator_package
    from metrabs_tpu_torch.models.registry import get_named_model

    named = get_named_model(IMPORT_MODEL)
    cfg = named.model_config(dtype='bfloat16', n_joints=joint_info.n_joints,
                             backbone_scan_blocks=False)
    det = {}
    if with_detector:
        det = dict(detector_variables=firing_detector_variables(gen, named.detector),
                   detector_type=named.detector, detector_dtype='bfloat16',
                   detector_input_size=DETECTOR_SIZE)
    save_pose_estimator_package(str(path), cfg=cfg, aug_cfg=named.aug_config(),
                                crop_model_variables=mint_crop_variables(cfg, gen),
                                joint_info=joint_info, **det)


def run_app(main, argv) -> tuple:
    """(seconds, the last line it printed) of a driver's `main(argv)`, its
    output kept off this script's."""
    import contextlib
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    seconds = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    return seconds, result, out.getvalue(), lines[-1] if lines else ''


def bench_apps_phase(root: Path, dev) -> dict:
    """The [bench_apps] phase (module docstring). Returns the K1 and K2
    launches of the predict_3dpw and predict_h36m runs."""
    import pickle

    import metrabs_tpu_torch.io.packaging as packaging
    from metrabs_tpu_torch.apps import (eval_3dpw, eval_benchmark, predict_3dpw,
                                        predict_h36m)
    from metrabs_tpu_torch.data import jpeg
    from metrabs_tpu_torch.data.datasets import load_h36m_examples
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17, SMPL_24

    name = 'bench_apps'
    dec = check_decoder(root)
    phase(name, f'JPEG decoder (host C++): all {dec["n"]} '
                f'fixtures equal their cv2 manifest hashes; {FRAME_3DPW} ({dec["kib"]:.0f} KiB): '
                f'{dec["ms"]:.2f} ms median of {DECODE_REPEATS} on one thread (all: '
                + ', '.join(f'{t:.1f}' for t in dec['all_ms'])
                + f'), {dec["fps"]:.1f} frames/s on {DECODE_THREADS} threads')

    work = root / BENCH_DIR
    shutil.rmtree(work, ignore_errors=True)
    rng = np.random.default_rng(SEED + 13)
    gen = torch.Generator().manual_seed(SEED + 13)
    original_load = packaging.load_pose_estimator
    original_decode = jpeg.decode
    try:
        t0 = time.perf_counter()
        mint_3dpw_layout(work / '3dpw', rng, root / JPEG_FIXTURES / FRAME_3DPW)
        cameras_json = mint_h36m_layout(work / 'h36m', rng, root / JPEG_FIXTURES / FRAME_H36M)
        bench_package(work / 'pkg_smpl', gen, SMPL_24, with_detector=True)
        bench_package(work / 'pkg_h36m', gen, H36M_17, with_detector=False)
        phase(name, f'layouts and packages minted in {time.perf_counter() - t0:.1f} s: 3DPW '
                    f'{BENCH_3DPW["sequences"]} sequences x {BENCH_3DPW["frames"]} frames '
                    f'1080x1920 with {BENCH_3DPW["tracks"]} tracks, Human3.6M S9 4 cameras x '
                    f'{BENCH_H36M["frames"] // BENCH_H36M["frame_step"]} frames 1000x1002; '
                    f'{IMPORT_MODEL} on SMPL-24 with a firing YOLOv4-{DETECTOR_SIZE} and on '
                    f'H36M-17')

        # Each driver loads its package through `load`, which keeps the
        # estimator, times the loading and records the arguments of each
        # call of `method`; `jpeg.decode` (what `improc.imread` calls) is
        # timed while the drivers run.
        loaded, calls, decode_spans, load_s = [], [], [], []

        def loader(method, **overrides):
            def load(path, device='cuda'):
                t = time.perf_counter()
                est = original_load(path, device=device, **overrides)
                load_s.append(time.perf_counter() - t)
                call = getattr(est, method)

                def recorded(images, *args, **kwargs):
                    out = call(images, *args, **kwargs)
                    calls.append((images, args, kwargs, int(out['valid'].sum())))
                    return out
                setattr(est, method, recorded)
                loaded.append(est)
                return est
            return load

        def timed_decode(data, path='<bytes>'):
            t = time.perf_counter()
            im = original_decode(data, path)
            decode_spans.append((t, time.perf_counter()))
            return im

        def run_driver(load, main, argv):
            for kept in (loaded, calls, decode_spans, load_s):
                kept.clear()
            packaging.load_pose_estimator, jpeg.decode = load, timed_decode
            torch.cuda.synchronize()
            warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
            try:
                seconds, _, _, last = run_app(main, argv)
                torch.cuda.synchronize()
            finally:
                packaging.load_pose_estimator, jpeg.decode = original_load, original_decode
            k1, k2 = warp_cuda.warp_pyramid.launches, mbconv_cuda.fused_mbconv_inner.launches
            # Frames/s and the decoding share without the package's loading,
            # which a whole benchmark run spreads over all its frames.
            run_s = seconds - load_s[0]
            decode_s = union_seconds(decode_spans)
            return dict(seconds=seconds, run_s=run_s, load_s=load_s[0], decode_s=decode_s,
                        k1=k1, k2=k2, last=last, est=loaded[0], calls=list(calls))

        def timing(r, n: int) -> str:
            return (f'{n} frames in {r["seconds"]:.2f} s = {n / r["seconds"]:.2f} frames/s, '
                    f'{r["run_s"]:.2f} s = {n / r["run_s"]:.2f} frames/s without loading the '
                    f'package ({r["load_s"]:.2f} s); decoding {r["decode_s"]:.2f} s '
                    f'({100 * r["decode_s"] / r["seconds"]:.1f}% of the wall, '
                    f'{100 * r["decode_s"] / r["run_s"]:.1f}% without the loading)')

        # predict_3dpw through K1 and K2: the package loaded unfolded, fuse_mbconv on.
        r = run_driver(loader('detect_poses_batched', cfg_overrides={'bn_fold': False},
                              backbone_builder=functools.partial(build_backbone,
                                                                 fuse_mbconv='on')),
                       predict_3dpw.main, [
                           '--package', str(work / 'pkg_smpl'), '--root', str(work / '3dpw'),
                           '--output-path', str(work / 'pred_3dpw'), '--gtassoc'])
        est = r['est']
        n_frames = BENCH_3DPW['sequences'] * BENCH_3DPW['frames']
        per_chunk = INTERNAL_BATCH // 5  # boxes per chunk at predict_3dpw's num_aug 5
        chunks = sum(math.ceil(v / per_chunk) for *_, v in r['calls'])
        boxes_per_frame = [v / len(images) for images, *_, v in r['calls']]
        if (r['k1'] != chunks or r['k2'] != K2_BLOCKS * chunks or chunks == 0
                or est.cfg.bn_fold):
            fail(name, f'predict_3dpw launched K1 {r["k1"]} and K2 {r["k2"]} times, expected '
                       f'{chunks} and {K2_BLOCKS * chunks} ({chunks} non-empty chunks; '
                       f'bn_fold {est.cfg.bn_fold})')
        preds = [pickle.loads(p.read_bytes())['jointPositions']
                 for p in sorted((work / 'pred_3dpw' / 'test').glob('*.pkl'))]
        want_shape = (BENCH_3DPW['tracks'], BENCH_3DPW['frames'], 24, 3)
        if len(preds) != BENCH_3DPW['sequences'] or any(
                p.shape != want_shape or not np.isfinite(p).all() for p in preds):
            fail(name, f'predict_3dpw wrote {[p.shape for p in preds]}, expected '
                       f'{BENCH_3DPW["sequences"]} x {want_shape}, finite')
        eval_s, metrics_3dpw, _, _ = run_app(eval_3dpw.main, [
            '--pred-path', str(work / 'pred_3dpw'), '--root', str(work / '3dpw')])
        if not all(np.isfinite(v) for v in metrics_3dpw.values()):
            fail(name, f'eval_3dpw metrics {metrics_3dpw}')
        phase(name, f'predict_3dpw --gtassoc (num_aug 5, batch 16, internal batch 64, '
                    f'max_detections 16, threshold 0.2), unfolded, fuse_mbconv on: '
                    + timing(r, n_frames) + f'; valid boxes per frame '
                    f'{min(boxes_per_frame):.2f}-{max(boxes_per_frame):.2f} (mean '
                    f'{statistics.mean(boxes_per_frame):.2f}) over {len(r["calls"])} calls; K1 '
                    f'{r["k1"]}, K2 {r["k2"]} ({chunks} chunks); {r["last"]}')
        phase(name, f'eval_3dpw in {eval_s:.2f} s: ' + json.dumps(metrics_3dpw))

        # The driver's first detect_poses_batched batch again: K1 and K2
        # counted, each K1 launch (portrait 1080x1920 pyramids) and K2's v
        # against their plain versions on the batch's inputs, then profiled.
        frames, args, kwargs, _ = r['calls'][0]
        (out, warp_errs), k1_batch, k2_batch, err_v, n_blocks = k2_v_error(
            est, lambda: checked_warps(lambda: est.detect_poses_batched(frames, *args,
                                                                        **kwargs)))
        warp_err = max(warp_errs, default=math.inf)
        if (n_blocks != K2_BLOCKS or err_v != 0.0 or k1_batch == 0
                or len(warp_errs) != k1_batch or not warp_err <= WARP_TOL):
            fail(name, f'one predict_3dpw batch: K1 {k1_batch} ({len(warp_errs)} compared, max '
                       f'|kernel - plain| {warp_err:.3g}, tol {WARP_TOL}), K2 {k2_batch}; K2 v '
                       f'max |kernel - plain| {err_v:.3g} over {n_blocks} blocks (must be 0)')
        for _ in range(TIMING_TRIES):
            wall_ms, device_ms, _, busy_ms, n_kernels, counts = profile_detect(
                est, lambda: est.detect_poses_batched(frames, *args, **kwargs))
            seen = (counts['K1 (warp kernel)'], counts['K2 (mbconv kernel)'])
            if seen == (k1_batch, k2_batch):
                break
        else:
            fail(name, f'the profiler never saw the {k1_batch} K1 and {k2_batch} K2 launches '
                       f'the wrappers counted in one batch')
        phase(name, f'one predict_3dpw batch ({len(frames)} frames, {int(out["valid"].sum())} '
                    f'valid boxes): K1 {k1_batch}, each against the plain warp (max |kernel - '
                    f'plain| {warp_err:.3g}, tol {WARP_TOL}); K2 {k2_batch}, v exact (max |kernel '
                    f'- plain| {err_v:.3g} over {n_blocks} blocks); under torch.profiler: wall '
                    f'{wall_ms:.1f} ms, device busy {busy_ms:.2f} ms '
                    f'({100 * busy_ms / wall_ms:.1f}%), {n_kernels} kernels, K1 '
                    f'{device_ms["K1 (warp kernel)"]:.3f} ms, K2 '
                    f'{device_ms["K2 (mbconv kernel)"]:.3f} ms, crop model '
                    f'{device_ms["crop_model"]:.2f} ms, detector {device_ms["detector"]:.2f} ms')
        k1_3dpw, k2_3dpw = r['k1'], r['k2']
        del est, r, out, frames
        torch.cuda.empty_cache()

        # predict_h36m (folded: K1 only), then eval_benchmark on the same examples.
        r = run_driver(loader('estimate_poses_batched'), predict_h36m.main, [
            '--package', str(work / 'pkg_h36m'), '--h36m-root', str(work / 'h36m'),
            '--cameras-json', cameras_json, '--output-path', str(work / 'pred_h36m.npz'),
            '--frame-step', str(BENCH_H36M['frame_step'])])
        examples = load_h36m_examples(str(work / 'h36m'), cameras_json, subjects=(9,),
                                      frame_step=BENCH_H36M['frame_step'])
        n_ex = len(examples)
        with np.load(work / 'pred_h36m.npz') as f:
            poses = f['coords3d_pred_world']
        batches = math.ceil(n_ex / 16)
        if r['k1'] != batches or r['k2'] != 0 or poses.shape != (n_ex, 17, 3) or not np.isfinite(
                poses).all():
            fail(name, f'predict_h36m: K1 {r["k1"]} (expected {batches}), K2 {r["k2"]} '
                       f'(expected 0), poses {poses.shape} finite {np.isfinite(poses).all()}')
        # Its first batch again, each K1 launch (1000x1002 pyramids with odd
        # level sizes, the cameras' lens distortion, 2x antialiasing) against
        # the plain warp.
        est = r['est']
        images, args, kwargs, _ = r['calls'][0]
        warp_cuda.warp_pyramid.launches = 0
        _, warp_errs = checked_warps(lambda: est.estimate_poses_batched(images, *args, **kwargs))
        torch.cuda.synchronize()
        k1_batch = warp_cuda.warp_pyramid.launches
        warp_err = max(warp_errs, default=math.inf)
        distorted = bool(np.any(kwargs['distortion_coeffs'] != 0))
        if not distorted or k1_batch == 0 or len(warp_errs) != k1_batch or not (
                warp_err <= WARP_TOL):
            fail(name, f'one predict_h36m batch: K1 {k1_batch} ({len(warp_errs)} compared, max '
                       f'|kernel - plain| {warp_err:.3g}, tol {WARP_TOL}); distortion {distorted}')
        phase(name, f'predict_h36m (num_aug 1, batch 16), folded: ' + timing(r, n_ex)
                    + f'; K1 {r["k1"]}, K2 {r["k2"]}; its first batch ({len(images)} frames, '
                      f'distorted cameras): K1 {k1_batch}, each against the plain warp (max '
                      f'|kernel - plain| {warp_err:.3g}, tol {WARP_TOL}); {r["last"]}')
        k1_h36m, k2_h36m = r['k1'], r['k2']
        del est, r, images
        (work / 'examples.pkl').write_bytes(pickle.dumps(examples))
        seconds, _, printed, _ = run_app(eval_benchmark.main, [
            '--package', str(work / 'pkg_h36m'), '--examples', str(work / 'examples.pkl'),
            '--benchmark', 'h36m', '--pred-out', str(work / 'preds.npz')])
        metrics = json.loads(printed[printed.index('{'):])
        if not all(np.isfinite(v) for k, v in metrics.items() if k != 'benchmark'):
            fail(name, f'eval_benchmark metrics {metrics}')
        phase(name, f'eval_benchmark --benchmark h36m ({n_ex} examples, crops on the host, '
                    f'no K1): {seconds:.2f} s, ' + json.dumps(metrics))
    finally:
        packaging.load_pose_estimator, jpeg.decode = original_load, original_decode
        shutil.rmtree(work, ignore_errors=True)
    return {'bench_3dpw': (k1_3dpw, k2_3dpw), 'bench_h36m': (k1_h36m, k2_h36m)}


def main() -> None:
    root = Path(__file__).resolve().parent
    if not (root / 'metrabs_tpu_torch' / 'csrc' / 'warp.cu').exists():
        fail('device', f'{root} is not a checkout of the repository')
    sys.path.insert(0, str(root))

    # 1. Device.
    if not torch.cuda.is_available():
        fail('device', 'torch.cuda.is_available() is False; this smoke run needs a GPU')
    dev = torch.device('cuda', 0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail('device', f'nvidia-smi failed: {smi.stderr.strip()}')
    card = smi.stdout.strip().splitlines()[0]
    phase('device', f'{torch.cuda.get_device_name(0)}; torch {torch.__version__}, '
                    f'CUDA {torch.version.cuda}')
    print(card, flush=True)
    # Every float32 check below runs without TF32 (cuDNN would use it for
    # float32 convolutions by default).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. Build: one nvcc per kernel source and the host compiler for the JPEG
    # decoder, started together.
    from metrabs_tpu_torch.ops import cuda_build, mbconv_cuda
    from metrabs_tpu_torch.ops import warp as warp_ops
    from metrabs_tpu_torch.ops import warp_cuda
    sources = ('warp', 'mbconv')
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as pool:
        host_build = pool.submit(cuda_build.build_host_library, 'jpeg_decode')
        built = list(pool.map(cuda_build.build_library, sources))
        host_lib, host_s = host_build.result()
    for name, (lib_path, build_s) in zip(sources, built):
        phase('build', f'nvcc {" ".join(cuda_build.NVCC_FLAGS)} '
                       f'{cuda_build.source_path(name).name} -> {lib_path.name} in {build_s:.2f} s')
    phase('build', f'{os.environ.get("CXX") or "c++"} {" ".join(cuda_build.CXX_FLAGS)} '
                   f'jpeg_decode.cpp -> {host_lib.name} in {host_s:.2f} s')
    phase('build', f'all three in {time.perf_counter() - start:.2f} s')

    # 3. The warp kernel against its plain version at the serving shape.
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    frames = synthetic_frames(gen, dev)
    flat, level_info, per_image_len = warp_ops.build_flat_pyramid(
        (frames.float() / 255.0) ** 2.2, 3)
    case = warp_case(dev)
    params, geom = warp_ops.pyramid_warp_params(
        level_info=level_info, per_image_len=per_image_len, **case)
    levels = sorted({int(i) for i in warp_ops.select_pyramid_level(
        case['crop_scales'], case['intrinsic_matrix'], 3)[0].tolist()})
    if levels != [0, 1, 2]:
        fail('kernel', f'the check must cover levels 0-2, got {levels}')
    side = (PROC_SIDE, PROC_SIDE)
    got = warp_cuda.warp_pyramid(flat, params, geom, side)
    want = warp_ops.warp_pyramid(flat, params, geom, side)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail('kernel', 'non-finite kernel output')
    if got[-1].abs().max().item() != 0.0:
        fail('kernel', 'the crop outside its frame must sample only the zero border')
    max_err = (got - want).abs().max().item()
    if not max_err <= WARP_TOL:
        fail('kernel', f'max |kernel - plain| = {max_err:.3g} > {WARP_TOL}')
    k1 = lambda: warp_cuda.warp_pyramid(flat, params, geom, side)
    k1_bytes, k1_bound_ms, k1_bound_by = k1_bound(flat, params, geom, side)
    kernel_ms = timed_against_bound('warp_pyramid', k1, k1_bound_ms)
    k1_event_ms = cuda_time_ms(k1)
    plain_ms = device_time_ms(lambda: warp_ops.warp_pyramid(flat, params, geom, side))
    phase('kernel', f'warp_pyramid {tuple(got.shape)}: max |kernel - plain| = {max_err:.3g} '
                    f'(tol {WARP_TOL}); kernel {kernel_ms:.4f} ms, {k1_bytes / 1e6:.1f} MB '
                    f'(output and distinct pyramid pixels), bound {k1_bound_ms:.4f} ms '
                    f'({k1_bound_by}), {100 * k1_bound_ms / kernel_ms:.1f}% of bound; plain '
                    f'torch {plain_ms:.4f} ms (device time, mean of 25); kernel '
                    f'{k1_event_ms:.4f} ms between CUDA events (median of 25 single calls)')
    del flat, got, want
    k2_results = check_k2(gen, dev)

    # 4. The main path.
    from metrabs_tpu_torch.io.packaging import pose_estimator_from_variables
    from metrabs_tpu_torch.models.metrabs import ModelConfig
    cpu_gen = torch.Generator().manual_seed(SEED)
    cfg = ModelConfig(**manifest_for('bfloat16')['model_config'])
    variables = mint_crop_variables(cfg, cpu_gen)
    est = pose_estimator_from_variables(variables, manifest_for('bfloat16'), device=dev)
    if not est.cfg.bn_fold or est.cfg.dtype != 'bfloat16':
        fail('main', f'expected the folded bf16 serving model, got {est.cfg}')

    crops = torch.rand((2, 4, PROC_SIDE, PROC_SIDE, 3), generator=gen, device=dev)
    k_crop = torch.tensor([[[300.0, 0, 128], [0, 300.0, 128], [0, 0, 1]]], device=dev)
    with torch.inference_mode():
        sens = [est.crop_model(c.bfloat16(), k_crop.expand(4, 3, 3)) for c in crops]
    sensitivity = (sens[0] - sens[1]).abs().max().item()
    if not sensitivity > 100 * POSE_ATOL_MM:
        fail('main', f'random crop model ignores its input ({sensitivity:.3g} mm)')

    boxes, box_valid = synthetic_boxes()
    run = lambda: est.estimate_poses_batched(
        frames, boxes, box_valid, num_aug=NUM_AUG, internal_batch_size=INTERNAL_BATCH)
    run()  # warm-up (cuDNN algorithm selection)
    torch.cuda.synchronize()
    warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
    out = run()
    torch.cuda.synchronize()
    launches = warp_cuda.warp_pyramid.launches
    main_k2_launches = mbconv_cuda.fused_mbconv_inner.launches
    n_valid = int(box_valid.sum())
    expected_launches = math.ceil(n_valid / (INTERNAL_BATCH // NUM_AUG))
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    want_shapes = dict(boxes=(8, 16, 5), poses3d=(8, 16, 17, 3), poses2d=(8, 16, 17, 2),
                       valid=(8, 16))
    if shapes != want_shapes:
        fail('main', f'output shapes {shapes} != {want_shapes}')
    valid_t = torch.as_tensor(box_valid, device=dev)
    if not torch.equal(out['valid'], valid_t):
        fail('main', 'valid mask differs from box_valid')
    for k in ('poses3d', 'poses2d'):
        if not torch.isfinite(out[k][valid_t]).all():
            fail('main', f'non-finite {k} on valid boxes')
    if launches != expected_launches:
        fail('main', f'warp kernel launched {launches} times, expected {expected_launches} '
                     f'(one per non-empty chunk)')

    # The float32 estimator on the GPU against the same one on the CPU.
    est32 = pose_estimator_from_variables(variables, manifest_for('float32'), device=dev)
    ref32 = pose_estimator_from_variables(variables, manifest_for('float32'), device='cpu')
    small = frames[:1, 400:700, 600:1000].contiguous()
    small_boxes = np.array([[[60, 20, 110, 250], [200, 40, 120, 240]]], np.float32)
    got32 = est32.estimate_poses_batched(small, small_boxes, num_aug=NUM_AUG)
    want32 = ref32.estimate_poses_batched(small.cpu(), small_boxes, num_aug=NUM_AUG)
    p_got, p_want = got32['poses3d'].cpu(), want32['poses3d']
    pose_err = (p_got - p_want).abs().max().item()
    if not torch.allclose(p_got, p_want, atol=POSE_ATOL_MM, rtol=POSE_RTOL):
        fail('main', f'float32 GPU poses differ from the CPU reference by {pose_err:.3g} mm')

    n_calls = 5
    times = []
    for _ in range(n_calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    call_s = statistics.median(times)
    phase('main', f'estimate_poses_batched EffNetV2-S@{PROC_SIDE} bf16 folded, '
                  f'{N_FRAMES}x{FRAME_H}p, {BOXES_PER_FRAME} boxes/frame ({n_valid} valid), '
                  f'num_aug {NUM_AUG}: warp launches {launches}; input sensitivity '
                  f'{sensitivity:.1f} mm; f32 GPU vs CPU max |dpose| {pose_err:.3g} mm; '
                  f'{call_s * 1e3:.1f} ms/call (median of {n_calls}), '
                  f'{n_valid * NUM_AUG / call_s:.1f} valid crops/s')

    if main_k2_launches != 0:
        fail('main', f'the folded model launched the MBConv kernel {main_k2_launches} times')

    # 5. The detect path: YOLOv4, the fused MBConv crop model, the filter.
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    fused_builder = functools.partial(build_backbone, fuse_mbconv='on')
    det_variables = mint_detector_variables(cpu_gen)
    unfolded = {'bn_fold': False}
    est_d = pose_estimator_from_variables(
        variables, detect_manifest_for('bfloat16'), device=dev, cfg_overrides=unfolded,
        detector_variables=det_variables, backbone_builder=fused_builder)
    fused_blocks = sum(getattr(b, 'fusable', False) and b.fuse == 'on'
                       for b in est_d.crop_model.backbone.blocks)
    if est_d.cfg.bn_fold or fused_blocks != K2_BLOCKS:
        fail('detect', f'expected the unfolded model with {K2_BLOCKS} fused blocks, got '
                       f'bn_fold={est_d.cfg.bn_fold} and {fused_blocks}')
    detect = lambda: est_d.detect_poses_batched(
        frames, num_aug=NUM_AUG, max_detections=MAX_DETECTIONS,
        internal_batch_size=INTERNAL_BATCH, detector_threshold=0.0,
        suppress_implausible_poses=True)
    detect()  # warm-up (cuDNN algorithm selection)
    with torch.inference_mode():
        _, det_valid = est_d.detector.detect_batched(frames, threshold=0.0,
                                                     max_detections=MAX_DETECTIONS)
    n_detected = int(det_valid.sum())
    torch.cuda.synchronize()
    warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
    mbconv_cuda.fused_mbconv_inner.launches_by_shape.clear()
    out = detect()
    torch.cuda.synchronize()
    det_warp_launches = warp_cuda.warp_pyramid.launches
    det_k2_launches = mbconv_cuda.fused_mbconv_inner.launches
    det_k2_by_shape = dict(mbconv_cuda.fused_mbconv_inner.launches_by_shape)
    chunks = math.ceil(n_detected / (INTERNAL_BATCH // NUM_AUG))
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    want_shapes = dict(boxes=(8, MAX_DETECTIONS, 5), poses3d=(8, MAX_DETECTIONS, 17, 3),
                       poses2d=(8, MAX_DETECTIONS, 17, 2), valid=(8, MAX_DETECTIONS))
    if shapes != want_shapes:
        fail('detect', f'output shapes {shapes} != {want_shapes}')
    if n_detected == 0 or (out['valid'] & ~det_valid).any():
        fail('detect', f'{n_detected} detections; the filter must only drop detections')
    for k in ('boxes', 'poses3d', 'poses2d'):
        if not torch.isfinite(out[k][det_valid]).all():
            fail('detect', f'non-finite {k} on detected rows')
    if det_warp_launches != chunks or det_k2_launches != K2_BLOCKS * chunks:
        fail('detect', f'warp kernel launched {det_warp_launches} times and MBConv kernel '
                       f'{det_k2_launches}, expected {chunks} and {K2_BLOCKS * chunks} '
                       f'({chunks} non-empty chunks)')
    # K2's launches per [E, H, W] and dtype in this run, against K2_CASES.
    by_case = {}
    for (n, e, h, w, dtype), count in det_k2_by_shape.items():
        by_case[(e, h, w, dtype)] = by_case.get((e, h, w, dtype), 0) + count
    want_by_case = {(*shape[1:], str(dtype)[6:]): per_chunk * chunks
                    for _, shape, dtype, per_chunk in K2_CASES if per_chunk}
    if by_case != want_by_case:
        fail('detect', f'MBConv launches per [E, H, W, dtype] {by_case}, expected '
                       f'{want_by_case}')
    for r in k2_results:
        r['detect_launches'] = by_case.get((*r['shape'][1:], r['dtype']), 0)
    k2_bound_call = sum(count * k2_bound((n, e, h, w), getattr(torch, dtype).itemsize)[1]
                        for (n, e, h, w, dtype), count in det_k2_by_shape.items())
    n_kept = int(out['valid'].sum())

    # The float32 detect estimator on the GPU against the same one on the CPU.
    ests32 = [pose_estimator_from_variables(
        variables, detect_manifest_for('float32'), device=d, cfg_overrides=unfolded,
        detector_variables=det_variables, backbone_builder=fused_builder)
        for d in (dev, 'cpu')]
    small = frames[:1, 300:660, 500:980].contiguous()
    small_kwargs = dict(num_aug=NUM_AUG, max_detections=4, detector_threshold=0.0,
                        suppress_implausible_poses=False)
    with torch.inference_mode():
        (b_got, v_got), (b_want, v_want) = [
            e.detector.detect_batched(x, threshold=0.0, max_detections=4)
            for e, x in zip(ests32, (small, small.cpu()))]
    box_err = (b_got.cpu() - b_want).abs().max().item()
    if not torch.equal(v_got.cpu(), v_want) or not box_err <= BOX_TOL_PX:
        fail('detect', f'float32 GPU detections differ from the CPU reference: masks '
                       f'{v_got.tolist()} vs {v_want.tolist()}, boxes by {box_err:.3g} px')
    got32, want32 = [e.detect_poses_batched(x, **small_kwargs)
                     for e, x in zip(ests32, (small, small.cpu()))]
    v32 = want32['valid']
    p_got, p_want = got32['poses3d'].cpu()[v32], want32['poses3d'][v32]
    det_pose_err = (p_got - p_want).abs().max().item()
    if not torch.equal(got32['valid'].cpu(), v32) or not torch.allclose(
            p_got, p_want, atol=POSE_ATOL_MM, rtol=POSE_RTOL):
        fail('detect', f'float32 GPU detect poses differ from the CPU reference by '
                       f'{det_pose_err:.3g} mm')
    del ests32

    times = []
    for _ in range(n_calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        detect()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    detect_s = statistics.median(times)
    phase('detect', f'detect_poses_batched YOLOv4-{DETECTOR_SIZE} bf16 + EffNetV2-S@{PROC_SIDE} '
                    f'bf16 unfolded, fuse_mbconv on, {N_FRAMES}x{FRAME_H}p, max_detections '
                    f'{MAX_DETECTIONS}, num_aug {NUM_AUG}, threshold 0: {n_detected} detections, '
                    f'{n_kept} after the plausibility filter; warp launches '
                    f'{det_warp_launches}, MBConv launches {det_k2_launches} ({chunks} chunks); '
                    f'f32 GPU vs CPU: masks equal, max |dbox| {box_err:.3g} px, max |dpose| '
                    f'{det_pose_err:.3g} mm; {detect_s * 1e3:.1f} ms/call (median of {n_calls}; '
                    f'all: {", ".join(f"{t * 1e3:.1f}" for t in times)})')
    wall_ms, device_ms, host_ms, busy_ms, n_kernels, counts = profile_detect(est_d, detect)
    phase('detect', f'one call under torch.profiler: wall {wall_ms:.1f} ms, device busy '
                    f'{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), {n_kernels} kernels')
    for name in sorted(device_ms, key=device_ms.get, reverse=True):
        host = f', host {host_ms[name]:.2f} ms' if name in host_ms else ''
        launched = f', {counts[name]} launches' if name in counts else ''
        phase('detect', f'  {name}: device {device_ms[name]:.3f} ms '
                        f'({100 * device_ms[name] / busy_ms:.1f}% of busy){launched}{host}')
    if counts['K2 (mbconv kernel)'] != det_k2_launches:
        fail('detect', f'the profiler saw {counts["K2 (mbconv kernel)"]} MBConv kernels, the '
                       f'wrapper counted {det_k2_launches}')
    phase('detect', f'K2 per call: {det_k2_launches} launches ('
                    + ', '.join(f'{list(k[:4])} {k[4]}: {c}' for k, c in det_k2_by_shape.items())
                    + f'), device {device_ms["K2 (mbconv kernel)"]:.3f} ms against a bound of '
                      f'{k2_bound_call:.3f} ms for these launches')

    # 6. The trainer, then the trained weights served through K1 and K2.
    del est, est32, ref32, est_d
    torch.cuda.empty_cache()
    shutil.rmtree(root / TRAINED_PACKAGE, ignore_errors=True)
    try:
        start = time.perf_counter()
        serve = train_phase(root, dev, frames, boxes, box_valid)
        phase('train', f'{time.perf_counter() - start:.1f} s')

        # 6b. Every other crop-model family trained, scored and served.
        torch.cuda.empty_cache()
        start = time.perf_counter()
        by_path = train_families_phase(root, dev, frames, boxes, box_valid,
                                       root / TRAINED_PACKAGE)
        phase('train_families', f'{time.perf_counter() - start:.1f} s')
    finally:
        shutil.rmtree(root / TRAINED_PACKAGE, ignore_errors=True)

    # 6c. The training app on dataset files, then its package served.
    torch.cuda.empty_cache()
    start = time.perf_counter()
    by_path.update(train_app_phase(root, dev, frames, boxes, box_valid, serve['step_s']))
    phase('train_app', f'{time.perf_counter() - start:.1f} s')

    # 7. The other model families.
    torch.cuda.empty_cache()
    by_path.update(families_phase(root, dev, frames, boxes, box_valid))

    # 8. The released weight formats and the streaming entry points.
    torch.cuda.empty_cache()
    by_path.update(import_phase(root, dev, frames, boxes, box_valid))

    # 9. The benchmark drivers on JPEG frames.
    torch.cuda.empty_cache()
    start = time.perf_counter()
    by_path.update(bench_apps_phase(root, dev))
    phase('bench_apps', f'{time.perf_counter() - start:.1f} s')

    # No single PyTorch call computes either kernel's function: library_ms is
    # null (the unfused cuDNN chain's time stands beside K2 as unfused_ms).
    k2_main = k2_results[K2_MAIN_CASE]
    print(json.dumps({'kernels': [
        dict(name='warp_pyramid', route='cuda', source='metrabs_tpu_torch/csrc/warp.cu',
             replaces='metrabs_tpu/ops/warp_pallas.py:68', launches=det_warp_launches,
             launches_by_path=dict(main=launches, detect=det_warp_launches, train=0,
                                   serve_after_train=serve['k1'],
                                   **{k: v[0] for k, v in by_path.items()}),
             max_abs_err=max_err, ms=kernel_ms, event_ms=k1_event_ms, plain_ms=plain_ms,
             bytes=k1_bytes,
             bound_ms=k1_bound_ms, bound_by=k1_bound_by, bound_share=k1_bound_ms / kernel_ms,
             library_ms=None),
        dict(name='fused_mbconv_inner', route='cuda', source='metrabs_tpu_torch/csrc/mbconv.cu',
             replaces='metrabs_tpu/ops/mbconv_pallas.py:77', launches=det_k2_launches,
             launches_by_path=dict(main=main_k2_launches, detect=det_k2_launches, train=0,
                                   serve_after_train=serve['k2'],
                                   **{k: v[1] for k, v in by_path.items()}),
             max_abs_err=max(r['max_abs_err'] for r in k2_results), ms=k2_main['ms'],
             event_ms=k2_main['event_ms'], plain_ms=k2_main['plain_ms'],
             bytes=k2_main['bytes'],
             bound_ms=k2_main['bound_ms'], bound_by=k2_main['bound_by'],
             bound_share=k2_main['bound_share'], library_ms=None,
             unfused_ms=k2_main['unfused_ms'],
             detect_call_device_ms=device_ms['K2 (mbconv kernel)'],
             detect_call_bound_ms=k2_bound_call, cases=k2_results)]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
