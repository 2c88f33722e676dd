"""Human3.6M per-sequence prediction driver (`metrabs_tpu/apps/
predict_h36m.py`): S9/S11, all 4 cameras, every Nth frame, ground-truth
boxes, full-pipeline estimation in world space, NPZ dump (image_path +
coords3d_pred_world) for the standard evaluation.

  python -m metrabs_tpu_torch.apps.predict_h36m --package models/eff2l \
      --h36m-root $DATA/h36m --cameras-json $DATA/h36m/cameras.json \
      --output-path preds/h36m.npz [--frame-step 64] [--num-aug 1]

JAX's flags and defaults, plus `--device` (default cuda; the driver raises
without CUDA unless another device is named).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--package', required=True)
    parser.add_argument('--h36m-root', required=True)
    parser.add_argument('--cameras-json', required=True)
    parser.add_argument('--output-path', required=True)
    parser.add_argument('--frame-step', type=int, default=64)
    parser.add_argument('--num-aug', type=int, default=1)
    parser.add_argument('--batch-size', type=int, default=16)
    parser.add_argument('--internal-batch-size', type=int, default=64)
    parser.add_argument('--num-joints', type=int, default=17,
                        choices=(17, 25))
    parser.add_argument('--device', default='cuda',
                        help="the device to predict on (default cuda; 'cpu' for a CPU run)")
    args = parser.parse_args(argv)

    import numpy as np

    from metrabs_tpu_torch.apps.predict_common import predict_examples
    from metrabs_tpu_torch.data.datasets import load_h36m_examples
    from metrabs_tpu_torch.io.packaging import load_pose_estimator

    estimator = load_pose_estimator(args.package, device=args.device)
    examples = load_h36m_examples(
        args.h36m_root, args.cameras_json, frame_step=args.frame_step)
    skeleton = f'h36m_{args.num_joints}'
    if skeleton not in estimator.skeletons.skeleton_names:
        skeleton = ''  # model-native joints (trained on H36M-17)
    poses_world = predict_examples(
        estimator, examples, skeleton=skeleton, num_aug=args.num_aug,
        antialias_factor=2, batch_size=args.batch_size,
        internal_batch_size=args.internal_batch_size, world_up=(0, 0, 1))
    np.savez(
        args.output_path,
        image_path=np.array([ex.image_path for ex in examples]),
        coords3d_pred_world=poses_world)
    print(f'wrote {len(examples)} predictions to {args.output_path}')


if __name__ == '__main__':
    main()
