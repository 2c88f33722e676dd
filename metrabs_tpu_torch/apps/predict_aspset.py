"""ASPset-510 prediction driver (`metrabs_tpu/apps/predict_aspset.py`):
per-sequence cameras and box CSVs, frames decoded from the .mkv videos
(`improc.imread('<video>#frame=N')`), aspset_17 skeleton, world-space NPZ
dump per sequence.

  python -m metrabs_tpu_torch.apps.predict_aspset --package models/eff2l \
      --root $DATA/aspset/data --output-dir preds/aspset [--num-aug 1]

JAX's flags and defaults, plus `--device` (default cuda). The videos may be
Motion JPEG, mp4v (MPEG-4 Part 2 Simple Profile, as cv2 writes it and as
JAX's tests lay ASPset out) or H.264 (progressive I, P and B slices, the
codec of most camera files): an mp4v or H.264 clip is decoded once per
frame, in order, through the file's decoder, whichever of the I/O threads
asks (a B-frame stream's packet may output several frames, all kept), its
frames numbered as cv2 numbers them. Other codecs (HEVC, interlaced H.264,
...) raise, naming the codec or tool (ROADMAP.md §1).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--package', required=True)
    parser.add_argument('--root', required=True)
    parser.add_argument('--output-dir', required=True)
    parser.add_argument('--split', default='test')
    parser.add_argument('--num-aug', type=int, default=1)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--internal-batch-size', type=int, default=64)
    parser.add_argument('--device', default='cuda',
                        help="the device to predict on (default cuda; 'cpu' for a CPU run)")
    args = parser.parse_args(argv)

    import numpy as np

    from metrabs_tpu_torch.apps.predict_common import predict_examples
    from metrabs_tpu_torch.data.datasets import load_aspset_examples
    from metrabs_tpu_torch.io.packaging import load_pose_estimator

    estimator = load_pose_estimator(args.package, device=args.device)
    examples = load_aspset_examples(args.root, split=args.split)
    skeleton = ('aspset_17' if 'aspset_17'
                in estimator.skeletons.skeleton_names else '')
    os.makedirs(args.output_dir, exist_ok=True)

    # Group by sequence (the video file part of the path).
    by_seq = {}
    for ex in examples:
        seq = ex.image_path.split('#')[0]
        by_seq.setdefault(seq, []).append(ex)

    for seq, seq_examples in by_seq.items():
        poses_world = predict_examples(
            estimator, seq_examples, skeleton=skeleton,
            num_aug=args.num_aug, antialias_factor=2,
            batch_size=args.batch_size,
            internal_batch_size=args.internal_batch_size,
            world_up=(0, -1, 0))
        name = os.path.splitext(os.path.basename(seq))[0]
        out_path = os.path.join(args.output_dir, f'{name}.npz')
        np.savez(out_path, coords3d_pred_world=poses_world)
        print(f'{name}: {len(seq_examples)} frames -> {out_path}')


if __name__ == '__main__':
    main()
