"""Live webcam demo (`metrabs_tpu/apps/webcam_demo.py`).

Builds the camera extrinsics from a physical pitch angle and height above
ground: the world frame is y-up at ground level so output poses are in room
coordinates.

Usage:
  python -m metrabs_tpu_torch.apps.webcam_demo [--package dir] [--camera-id 0]
      [--pitch-degrees 0] [--height-m 1.0] [--fov 55] [--device cuda]

The arguments, the estimator and the extrinsics are set up as in JAX; the
capture and the display are not ported (JAX reads the camera through V4L2 and
shows frames with `cv2.imshow`; the port has neither a capture nor a window
library), so `main` raises NotImplementedError after its set-up (ROADMAP.md,
"webcam capture and display").
"""

from __future__ import annotations

import argparse

import numpy as np

CAPTURE_REFUSED = ('webcam capture and display are not ported: the port has no V4L2 capture '
                   'and no window library (ROADMAP.md, "webcam capture and display"); run '
                   'apps.demo_video on a recorded Motion JPEG file instead')


def camera_extrinsics_from_pitch_height(
        pitch_degrees: float, height_m: float) -> np.ndarray:
    """4x4 world->camera extrinsics for a camera `height_m` above the ground,
    pitched down by `pitch_degrees`, world up = -y (camera convention)."""
    pitch = np.deg2rad(pitch_degrees)
    c, s = np.cos(pitch), np.sin(pitch)
    # Rotation about the camera x-axis.
    R = np.array([[1, 0, 0], [0, c, s], [0, -s, c]], np.float32)
    t_world = np.array([0, -height_m * 1000.0, 0], np.float32)  # y-down world
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = R
    ext[:3, 3] = -R @ t_world
    return ext


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--package', default=None)
    parser.add_argument('--camera-id', type=int, default=0)
    parser.add_argument('--pitch-degrees', type=float, default=0.0)
    parser.add_argument('--height-m', type=float, default=1.0)
    parser.add_argument('--fov', type=float, default=55.0)
    parser.add_argument('--fast-load', action='store_true',
                        help='accepted for JAX compatibility; does nothing here')
    parser.add_argument('--num-aug', type=int, default=1)
    parser.add_argument('--skeleton', default='')
    parser.add_argument('--max-frames', type=int, default=0,
                        help='stop after N frames (0 = until q pressed)')
    parser.add_argument('--headless', action='store_true')
    parser.add_argument('--device', default='cuda',
                        help="the device to estimate on (default cuda; 'cpu' for a CPU run)")
    args = parser.parse_args(argv)

    from metrabs_tpu_torch.apps import demo_image
    estimator = demo_image.load_estimator(args.package, args.device, args.fast_load)
    extrinsics = camera_extrinsics_from_pitch_height(args.pitch_degrees, args.height_m)
    estimator.skeletons.joint_edges(args.skeleton)  # an unknown skeleton raises here
    raise NotImplementedError(f'camera {args.camera_id}: {CAPTURE_REFUSED} (extrinsics '
                              f'{extrinsics[:3, 3].tolist()} mm set up)')


if __name__ == '__main__':
    main()
