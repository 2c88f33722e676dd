"""3DOH50K test-set prediction driver (`metrabs_tpu/apps/predict_3doh.py`):
per-image intrinsics + ground-truth boxes, LSP-14 output, camera-space NPZ
dump keyed by image id.

  python -m metrabs_tpu_torch.apps.predict_3doh --package models/eff2l \
      --root $DATA/3doh --output-path preds/3doh.npz [--num-aug 1]

JAX's flags and defaults, plus `--device` (default cuda).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--package', required=True)
    parser.add_argument('--root', required=True)
    parser.add_argument('--output-path', required=True)
    parser.add_argument('--num-aug', type=int, default=1)
    parser.add_argument('--batch-size', type=int, default=16)
    parser.add_argument('--internal-batch-size', type=int, default=64)
    parser.add_argument('--device', default='cuda',
                        help="the device to predict on (default cuda; 'cpu' for a CPU run)")
    args = parser.parse_args(argv)

    import numpy as np

    from metrabs_tpu_torch.apps.predict_common import predict_examples
    from metrabs_tpu_torch.data.datasets import load_3doh_examples
    from metrabs_tpu_torch.io.packaging import load_pose_estimator

    estimator = load_pose_estimator(args.package, device=args.device)
    examples = load_3doh_examples(args.root)
    skeleton = ('lsp_14' if 'lsp_14' in estimator.skeletons.skeleton_names
                else '')
    # 3DOH poses are evaluated in camera space: predict with identity
    # extrinsics so world == camera.
    for ex in examples:
        ex.camera.R = np.eye(3, dtype=np.float32)
        ex.camera.t = np.zeros(3, np.float32)
    poses_cam = predict_examples(
        estimator, examples, skeleton=skeleton, num_aug=args.num_aug,
        antialias_factor=2, batch_size=args.batch_size,
        internal_batch_size=args.internal_batch_size)
    image_ids = [ex.image_path.split('/')[-1].rsplit('.', 1)[0]
                 for ex in examples]
    np.savez(args.output_path, coords3d_pred_cam=poses_cam,
             image_id=np.array(image_ids))
    print(f'wrote {len(examples)} predictions to {args.output_path}')


if __name__ == '__main__':
    main()
