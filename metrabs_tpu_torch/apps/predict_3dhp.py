"""MPI-INF-3DHP test-set prediction driver (`metrabs_tpu/apps/
predict_3dhp.py`): detector-driven (max_detections=1, threshold 0,
detector flip aug), mpi_inf_3dhp_17 skeleton, per-sequence intrinsics,
12-coefficient distortion and extrinsics, world-space NPZ dump for the
standard (Mehta matlab-compatible) evaluation.

  python -m metrabs_tpu_torch.apps.predict_3dhp --package models/eff2l \
      --root $DATA/3dhp --cameras-json $DATA/3dhp/test_cameras.json \
      --output-path preds/3dhp.npz [--num-aug 1]

JAX's flags and defaults, plus `--device` (default cuda; the driver raises
without CUDA unless another device is named). The valid frames come from
each sequence's `annot_data.mat` through the port's HDF5 reader; each batch
of JPEG frames is decoded on 8 threads (`data.improc.imread`, which releases
the GIL), where JAX reads them one by one.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor

IO_THREADS = 8


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--package', required=True)
    parser.add_argument('--root', required=True)
    parser.add_argument('--cameras-json', required=True)
    parser.add_argument('--output-path', required=True)
    parser.add_argument('--num-aug', type=int, default=1)
    parser.add_argument('--batch-size', type=int, default=16)
    parser.add_argument('--internal-batch-size', type=int, default=64)
    parser.add_argument('--device', default='cuda',
                        help="the device to predict on (default cuda; 'cpu' for a CPU run)")
    args = parser.parse_args(argv)

    import numpy as np

    from metrabs_tpu_torch.apps.predict_common import to_host
    from metrabs_tpu_torch.data.datasets import load_3dhp_test_frames
    from metrabs_tpu_torch.data.improc import imread
    from metrabs_tpu_torch.io.packaging import load_pose_estimator

    estimator = load_pose_estimator(args.package, device=args.device)
    if estimator.detector is None:
        raise ValueError('The 3DHP protocol is detector-driven; the package '
                         'has no detector.')
    if 'mpi_inf_3dhp_17' not in estimator.skeletons.skeleton_names:
        # eval_3dhp assumes the 3DHP joint order (pelvis at index 14).
        raise ValueError(
            "the package's skeleton registry lacks 'mpi_inf_3dhp_17', which "
            'the 3DHP protocol (and eval_3dhp) require')
    skeleton = 'mpi_inf_3dhp_17'
    sequences = load_3dhp_test_frames(args.root, args.cameras_json)

    all_paths = []
    all_poses = []
    with ThreadPoolExecutor(IO_THREADS) as pool:
        for seq_name, frame_paths, camera in sequences:
            print(f'{seq_name}: {len(frame_paths)} frames')
            dist = np.pad(np.asarray(
                camera.distortion_coeffs, np.float32).reshape(-1), (0, 12))[:12]
            for start in range(0, len(frame_paths), args.batch_size):
                chunk = frame_paths[start:start + args.batch_size]
                images = np.stack(list(pool.map(imread, chunk)))
                pred = estimator.detect_poses_batched(
                    images,
                    intrinsic_matrix=np.tile(
                        camera.intrinsic_matrix[None], (len(chunk), 1, 1)),
                    distortion_coeffs=np.tile(dist[None], (len(chunk), 1)),
                    extrinsic_matrix=np.tile(
                        camera.extrinsic_matrix[None], (len(chunk), 1, 1)),
                    world_up_vector=(0, 1, 0),
                    detector_threshold=0.0, detector_flip_aug=True,
                    max_detections=1, suppress_implausible_poses=False,
                    num_aug=args.num_aug, antialias_factor=2,
                    internal_batch_size=args.internal_batch_size,
                    skeleton=skeleton)
                all_poses.append(to_host(pred['poses3d'])[:, 0])
                all_paths.extend(chunk)

    np.savez(args.output_path,
             image_path=np.array(all_paths),
             coords3d_pred_world=np.concatenate(all_poses, axis=0))
    print(f'wrote {len(all_paths)} predictions to {args.output_path}')


if __name__ == '__main__':
    main()
