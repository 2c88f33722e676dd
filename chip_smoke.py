#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`metrabs_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the last line:
 1. device: a CUDA device, its name and power limit from nvidia-smi;
 2. build: nvcc builds the crop-warp kernel `metrabs_tpu_torch/csrc/warp.cu`
    for sm_90a from the checkout;
 3. kernel: the warp kernel against its plain PyTorch version at the serving
    shape (8 synthetic 1080p frames, 64 crops of 256x256, pyramid levels 0-2,
    lens distortion on some crops, a crop entirely outside its frame), and
    both times;
 4. main path: `estimate_poses_batched` of an estimator built by the same
    function `load_pose_estimator` uses after reading a package, with
    EffNetV2-S at 256 px in bfloat16 (BN folded, flat layout) and weights
    minted from a seed, on 8 synthetic 1080p frames with 16 boxes each
    (some invalid), num_aug 2, internal batch 64. Checks shapes, finiteness,
    the validity mask and that the warp kernel ran once per non-empty chunk;
    then holds a float32 estimator on the GPU against the same estimator on
    the CPU (plain warp) on a small input, and times the bf16 path.
The second-to-last line is a JSON object with the kernel's measurements;
the last is {"ok": true, "device": {...}}.
"""

import json
import math
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


def mint_crop_variables(cfg, gen: torch.Generator):
    """Flat, unfolded JAX-layout variables for `cfg`: 0.8x He fan-in
    kernels, random BN statistics and affine, and a 3D head that agrees with
    the 2D head (so the reconstruction places joints in front of the camera)."""
    from metrabs_tpu_torch.io.weights import flax_variables_from_state_dict
    from metrabs_tpu_torch.models.metrabs import build_crop_model

    with torch.device('meta'):
        shapes = build_crop_model(cfg).state_dict()
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
    j = cfg.n_joints
    for name in ('heatmap_heads.conv_final.weight', 'heatmap_heads.conv_final.bias'):
        v = state[name]
        v[j:] = v[:j].repeat((cfg.depth,) + (1,) * (v.ndim - 1)) + 0.05 * torch.randn(
            v[j:].shape, generator=gen)
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

    # 2. Build.
    from metrabs_tpu_torch.ops import warp as warp_ops
    from metrabs_tpu_torch.ops import warp_cuda
    lib_path, build_s = warp_cuda.build_library()
    phase('build', f'nvcc {" ".join(warp_cuda.NVCC_FLAGS)} {warp_cuda.SOURCE.name} -> '
                   f'{lib_path.name} in {build_s:.2f} s')

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
    kernel_ms = cuda_time_ms(lambda: warp_cuda.warp_pyramid(flat, params, geom, side))
    plain_ms = cuda_time_ms(lambda: warp_ops.warp_pyramid(flat, params, geom, side))
    phase('kernel', f'warp_pyramid {tuple(got.shape)}: max |kernel - plain| = {max_err:.3g} '
                    f'(tol {WARP_TOL}); kernel {kernel_ms:.4f} ms, plain torch '
                    f'{plain_ms:.4f} ms (CUDA events, median of 25)')
    del flat, got, want

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
    warp_cuda.warp_pyramid.launches = 0
    out = run()
    torch.cuda.synchronize()
    launches = warp_cuda.warp_pyramid.launches
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

    print(json.dumps({'kernels': [dict(
        name='warp_pyramid', route='cuda', source='metrabs_tpu_torch/csrc/warp.cu',
        replaces='metrabs_tpu/ops/warp_pallas.py:68', launches=launches,
        max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms)]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
