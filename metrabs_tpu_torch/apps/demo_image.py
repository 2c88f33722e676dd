"""Single-image demo (`metrabs_tpu/apps/demo_image.py`).

Usage:
  python -m metrabs_tpu_torch.apps.demo_image --image /path/img.jpg \
      --package /path/to/package_dir [--boxes x,y,w,h;x,y,w,h] [--out out.jpg] \
      [--out-3d scene.png] [--device cuda]

Without --package, runs a randomly initialised MobileNetV3-small estimator
(a pipeline smoke test); without --boxes, uses the detector (if packaged) or
one full-image box. The image is read as cv2.imread reads it (JPEG, PNG,
WebP, TIFF, BMP, PNM/PAM/PFM, GIF, Sun raster or Radiance HDR, EXIF and TIFF
orientation applied; `data.improc.imread`). Prints JAX's JSON line, then writes `--out` (the 2D
overlay, JPEG or PNG, equal to JAX's cv2 file) and `--out-3d` (the 3D scene
of `utils.viz.plot_poses_3d`). JAX's flags plus `--device` (default cuda);
`--fast-load` is accepted and does nothing: the port runs the flat backbone
layout only, so there is no scanned layout to keep (ROADMAP.md, "Left out").
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

FAST_LOAD_IGNORED = ('--fast-load: ignored; the port has no scanned backbone layout to keep '
                     '(ROADMAP.md, "Left out")')


def _lecun_normal_state(shapes, gen: torch.Generator) -> dict:
    """A state dict for the meta tensors `shapes`, as flax initialises: kernels
    normal with variance 1 / fan-in, biases and BN shifts 0, BN scales and
    variances 1, means 0."""
    state = {}
    for name, meta in shapes.items():
        shape = tuple(meta.shape)
        if name.endswith('weight') and len(shape) >= 2:
            fan_in = math.prod(shape[1:])
            state[name] = torch.randn(shape, generator=gen) / math.sqrt(fan_in)
        elif name.endswith(('running_var', 'weight')):
            state[name] = torch.ones(shape)
        elif name.endswith('num_batches_tracked'):
            state[name] = torch.zeros(shape, dtype=meta.dtype)
        else:
            state[name] = torch.zeros(shape)
    return state


def build_default_estimator(device='cuda', seed: int = 0):
    """Randomly initialised small estimator (no trained weights shipped):
    MobileNetV3-small at 256 px, depth 8, bfloat16, H36M-17 joints, its
    weights drawn from a `torch.Generator` seeded `seed`."""
    from metrabs_tpu_torch.config import ModelConfig
    from metrabs_tpu_torch.io.packaging import pose_estimator_from_variables
    from metrabs_tpu_torch.io.weights import flax_variables_from_state_dict
    from metrabs_tpu_torch.models.metrabs import build_crop_model
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17

    cfg = ModelConfig(proc_side=256, depth=8, n_joints=17, dtype='bfloat16',
                      backbone='mobilenetv3-small', backbone_scan_blocks=False)
    with torch.device('meta'):
        shapes = build_crop_model(cfg).state_dict()
    state = _lecun_normal_state(shapes, torch.Generator().manual_seed(seed))
    manifest = dict(format_version=1, model_config=dict(
        proc_side=cfg.proc_side, depth=cfg.depth, n_joints=cfg.n_joints, dtype=cfg.dtype,
        backbone=cfg.backbone, backbone_scan_blocks=False), aug_config={},
        joint_names=list(H36M_17.names), joint_edges=[list(e) for e in H36M_17.edges],
        has_detector=False)
    return pose_estimator_from_variables(flax_variables_from_state_dict(state), manifest,
                                         device=device)


def draw_poses(image: np.ndarray, poses2d: np.ndarray, edges) -> np.ndarray:
    """Green edges of thickness 2 and red discs of radius 3 on a copy of an
    RGB image, equal to JAX's cv2 drawing."""
    from metrabs_tpu_torch.data import cvfree
    out = image.copy()
    for pose in poses2d:
        for i, j in edges:
            p1 = tuple(np.round(pose[i]).astype(int))
            p2 = tuple(np.round(pose[j]).astype(int))
            cvfree.line(out, p1, p2, (0, 255, 0), 2)
        for pt in pose:
            cvfree.circle(out, tuple(np.round(pt).astype(int)), 3, (255, 0, 0), -1)
    return out


def load_estimator(package, device, fast_load: bool):
    """The package's estimator (or the default one) on `device`."""
    if fast_load:
        print(FAST_LOAD_IGNORED)
    if package:
        from metrabs_tpu_torch.io.packaging import load_pose_estimator
        return load_pose_estimator(package, device=device)
    return build_default_estimator(device=device)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--image', required=True)
    parser.add_argument('--package', default=None)
    parser.add_argument('--boxes', default=None,
                        help='person boxes as "x,y,w,h;x,y,w,h;..."')
    parser.add_argument('--out', default=None)
    parser.add_argument('--out-3d', default=None,
                        help='write a 3D scene (+2D panel) here (.png or .jpg)')
    parser.add_argument('--num-aug', type=int, default=5)
    parser.add_argument('--skeleton', default='')
    parser.add_argument('--fov', type=float, default=55.0)
    parser.add_argument('--fast-load', action='store_true',
                        help='accepted for JAX compatibility; does nothing here')
    parser.add_argument('--device', default='cuda',
                        help="the device to estimate on (default cuda; 'cpu' for a CPU run)")
    args = parser.parse_args(argv)

    from metrabs_tpu_torch.data.improc import imread, imwrite
    image = imread(args.image)
    estimator = load_estimator(args.package, args.device, args.fast_load)

    if args.boxes:
        boxes = np.array(
            [[float(v) for v in b.split(',')] for b in args.boxes.split(';')],
            np.float32)
        result = estimator.estimate_poses(
            image, boxes, num_aug=args.num_aug, skeleton=args.skeleton,
            default_fov_degrees=args.fov)
    elif estimator.detector is not None:
        result = estimator.detect_poses(
            image, num_aug=args.num_aug, skeleton=args.skeleton,
            default_fov_degrees=args.fov)
    else:
        h, w = image.shape[:2]
        boxes = np.array([[w * 0.25, h * 0.05, w * 0.5, h * 0.9]], np.float32)
        result = estimator.estimate_poses(
            image, boxes, num_aug=args.num_aug, skeleton=args.skeleton,
            default_fov_degrees=args.fov)

    print(json.dumps({
        'n_poses': int(result['poses3d'].shape[0]),
        'poses3d_shape': list(result['poses3d'].shape),
        'poses2d_shape': list(result['poses2d'].shape),
        'pose0_pelvis_mm': (result['poses3d'][0, 0].tolist()
                            if result['poses3d'].shape[0] else None)}))

    edges = estimator.skeletons.joint_edges(args.skeleton)
    if args.out:
        imwrite(args.out, draw_poses(image, result['poses2d'], edges))
        print(f'wrote {args.out}')

    if args.out_3d:
        from metrabs_tpu_torch.utils.viz import plot_poses_3d
        plot_poses_3d(result['poses3d'], edges, out_path=args.out_3d,
                      image=image, poses2d=result['poses2d'])
        print(f'wrote {args.out_3d}')
    return result


if __name__ == '__main__':
    main()
