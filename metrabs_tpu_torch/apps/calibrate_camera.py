"""Checkerboard intrinsics calibration (`metrabs_tpu/apps/calibrate_camera.py`):
collect checkerboard detections from an image directory and solve for the
intrinsic matrix and the distortion coefficients, without OpenCV
(`utils/calibration.py` answers as cv2's findChessboardCorners, cornerSubPix
and calibrateCamera do).

Usage:
  python -m metrabs_tpu_torch.apps.calibrate_camera --images 'calib/*.jpg' \\
      --rows 6 --cols 9 --out intrinsics.json [--device cuda]

The output JSON is JAX's: `rms_reprojection_error`, `intrinsic_matrix`,
`distortion_coeffs` (k1 k2 p1 p2 k3) and `image_shape` (of the last readable
image). Its `intrinsic_matrix` and `distortion_coeffs` go unchanged into
`estimate_poses_batched(..., intrinsic_matrix=K, distortion_coeffs=d)`.
`--camera-id` parses as in JAX and raises NotImplementedError: the port has
no camera capture (ROADMAP.md, "webcam capture and display"). The views are
read in gray as cv2.imread(IMREAD_GRAYSCALE) reads them, in any format
`data.improc.imread` decodes (JPEG, PNG, WebP, TIFF with 16-bit samples
among them, BMP, PNM/PAM/PFM, GIF, Sun raster, Radiance HDR); a file it
cannot read is skipped, as cv2's None is.
"""

from __future__ import annotations

import argparse
import glob
import json

import numpy as np

CAPTURE_REFUSED = ('camera capture is not ported: the port has no V4L2 capture (ROADMAP.md, '
                   '"webcam capture and display"); save the frames as images and pass --images')


def find_corners(gray, rows, cols, device='cuda'):
    """JAX's `find_corners`: the board's corners refined with a window scaled
    to the square size, float32 [rows * cols, 1, 2], or None."""
    from metrabs_tpu_torch.utils import calibration

    found, corners = calibration.find_chessboard_corners(gray, (cols, rows), device=device)
    if not found:
        return None
    # Scale the refinement window to the detected square size: a fixed
    # 11x11 window spans NEIGHBORING edges when the board is small/far
    # (squares < ~25 px) and corrupts corners by multiple pixels.
    pts = corners.reshape(rows, cols, 2)
    spacing = min(
        float(np.median(np.linalg.norm(np.diff(pts, axis=1), axis=-1))),
        float(np.median(np.linalg.norm(np.diff(pts, axis=0), axis=-1))))
    half = int(np.clip(spacing * 0.4, 2, 11))
    criteria = (calibration.TERM_CRITERIA_EPS + calibration.TERM_CRITERIA_MAX_ITER, 30, 1e-3)
    return calibration.corner_subpix(gray, corners, (half, half), (-1, -1), criteria,
                                     device=device)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--images', default=None, help='glob of calib images')
    parser.add_argument('--camera-id', type=int, default=None)
    parser.add_argument('--n-frames', type=int, default=30)
    parser.add_argument('--rows', type=int, default=6)
    parser.add_argument('--cols', type=int, default=9)
    parser.add_argument('--square-mm', type=float, default=25.0)
    parser.add_argument('--out', default='intrinsics.json')
    parser.add_argument('--device', default='cuda',
                        help="the device to compute on (default cuda; 'cpu' for a CPU run)")
    args = parser.parse_args(argv)

    from metrabs_tpu_torch.data import improc
    from metrabs_tpu_torch.pipeline.estimator import checked_device
    from metrabs_tpu_torch.utils import calibration

    device = checked_device(args.device)
    objp = np.zeros((args.rows * args.cols, 3), np.float32)
    objp[:, :2] = (np.mgrid[0:args.cols, 0:args.rows].T.reshape(-1, 2)
                   * args.square_mm)

    obj_points, img_points = [], []
    imshape = None
    if args.images:
        for path in sorted(glob.glob(args.images)):
            try:
                gray = improc.imread(path, gray=True)
            except (OSError, ValueError, NotImplementedError):
                continue  # cv2.imread's None: unreadable files are skipped
            imshape = gray.shape
            corners = find_corners(gray, args.rows, args.cols, device)
            if corners is not None:
                obj_points.append(objp)
                img_points.append(corners)
    elif args.camera_id is not None:
        raise NotImplementedError(f'camera {args.camera_id}: {CAPTURE_REFUSED}')
    else:
        parser.error('Give --images or --camera-id')

    if len(obj_points) < 3:
        raise SystemExit(f'Only {len(obj_points)} checkerboard views found; '
                         'need at least 3.')
    rms, K, dist, _, _ = calibration.calibrate_camera(
        obj_points, img_points, imshape[::-1], device=device)
    result = dict(
        rms_reprojection_error=float(rms),
        intrinsic_matrix=np.asarray(K).tolist(),
        distortion_coeffs=np.asarray(dist).ravel().tolist(),
        image_shape=list(imshape))
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))


if __name__ == '__main__':
    main()
