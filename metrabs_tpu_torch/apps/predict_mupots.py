"""MuPoTS-3D prediction driver (`metrabs_tpu/apps/predict_mupots.py`): full
multi-person detection over TS1-20 with per-sequence intrinsics,
mpi_inf_3dhp_17 output, world-space NPZ dump with one row per detected pose
(image_path repeated per pose), the input to `eval_mupots`.

  python -m metrabs_tpu_torch.apps.predict_mupots --package models/eff2l \
      --root $DATA/mupots --output-path preds/mupots.npz [--num-aug 1]

As in JAX: detector_threshold 0.2, flip aug, suppress_implausible_poses
False, antialias 2, per-sequence camera from camera_intrinsics.json,
annotations only for the frame count. JAX's flags and defaults, plus
`--device` (default cuda). `--viz-dir` writes JAX's figures (the frame with
its 2D overlay beside the 3D scene, `utils.viz.plot_poses_3d`) every
`--viz-step` frames as `<viz-dir>/TS<n>_<frame:05d>.jpg`.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
from concurrent.futures import ThreadPoolExecutor


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--package', required=True)
    parser.add_argument('--root', required=True, help='MuPoTS dataset root')
    parser.add_argument('--output-path', required=True)
    parser.add_argument('--num-aug', type=int, default=1)
    parser.add_argument('--batch-size', type=int, default=16)
    parser.add_argument('--internal-batch-size', type=int, default=128)
    parser.add_argument('--max-detections', type=int, default=16)
    parser.add_argument('--sequences', type=int, nargs='*', default=None,
                        help='subset of 1..20 (default all)')
    parser.add_argument('--io-threads', type=int, default=8)
    parser.add_argument('--viz-dir', default=None,
                        help='save 2D+3D overlay figures here')
    parser.add_argument('--viz-step', type=int, default=50)
    parser.add_argument('--device', default='cuda',
                        help="the device to predict on (default cuda; 'cpu' for a CPU run)")
    args = parser.parse_args(argv)

    import numpy as np

    from metrabs_tpu_torch.apps.predict_common import to_host
    from metrabs_tpu_torch.data.datasets import load_mupots_annotations
    from metrabs_tpu_torch.data.improc import imread
    from metrabs_tpu_torch.io.packaging import load_pose_estimator

    estimator = load_pose_estimator(args.package, device=args.device)
    skeleton = 'mpi_inf_3dhp_17'
    with open(osp.join(args.root, 'camera_intrinsics.json')) as f:
        intrinsics_all = json.load(f)

    pool = ThreadPoolExecutor(args.io_threads)
    image_relpaths_all = []
    poses_all = []
    for i_seq, annotations in load_mupots_annotations(
            args.root, args.sequences):
        n_frames = annotations.shape[0]
        intr = np.asarray(intrinsics_all[f'TS{i_seq}'], np.float32)
        frame_relpaths = [f'TS{i_seq}/img_{i:06d}.jpg'
                          for i in range(n_frames)]
        print(f'predicting TS{i_seq} ({n_frames} frames)...')
        for start in range(0, n_frames, args.batch_size):
            chunk = frame_relpaths[start:start + args.batch_size]
            images = np.stack(list(pool.map(
                lambda p: imread(osp.join(args.root, p)), chunk)))
            pred = estimator.detect_poses_batched(
                images,
                intrinsic_matrix=np.tile(intr[None], (len(images), 1, 1)),
                internal_batch_size=args.internal_batch_size,
                num_aug=args.num_aug, detector_threshold=0.2,
                detector_nms_iou_threshold=0.7, detector_flip_aug=True,
                antialias_factor=2, suppress_implausible_poses=False,
                skeleton=skeleton, max_detections=args.max_detections,
                world_up_vector=(0, -1, 0))
            valid = to_host(pred['valid'])
            poses3d = to_host(pred['poses3d'])
            poses2d = to_host(pred['poses2d'])
            for k, relpath in enumerate(chunk):
                i_frame = start + k
                if args.viz_dir and (i_frame % args.viz_step == 0):
                    import os

                    from metrabs_tpu_torch.pipeline.skeletons import MPI_INF_3DHP_17
                    from metrabs_tpu_torch.utils.viz import plot_poses_3d
                    os.makedirs(args.viz_dir, exist_ok=True)
                    plot_poses_3d(
                        poses3d[k][valid[k]], MPI_INF_3DHP_17.edges,
                        image=images[k], poses2d=poses2d[k][valid[k]],
                        out_path=osp.join(args.viz_dir, f'TS{i_seq}_{i_frame:05d}.jpg'))
                for pose in poses3d[k][valid[k]]:
                    image_relpaths_all.append(f'mupots/{relpath}')
                    poses_all.append(pose)
    pool.shutdown()

    np.savez(args.output_path,
             image_path=np.stack(image_relpaths_all, axis=0),
             coords3d_pred_world=np.stack(poses_all, axis=0))
    print(f'wrote {len(poses_all)} poses to {args.output_path}')


if __name__ == '__main__':
    main()
