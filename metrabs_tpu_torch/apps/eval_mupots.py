"""MuPoTS-3D evaluation CLI (`metrabs_tpu/apps/eval_mupots.py`): consumes
the `predict_mupots` NPZ dump plus the dataset's `annot.mat` ground truth
and prints matched PCK@150 (root-relative, the published "PCK" column),
matched absolute PCK ("APCK") and recall.

  python -m metrabs_tpu_torch.apps.eval_mupots --pred-path preds/mupots.npz \
      --root $DATA/mupots [--all-joints]

Per-frame person matching, poses aligned at the PELVIS root (index 14 of
the mpi_inf_3dhp_17 order), PCK over the 14 evaluation joints (indices
0..13; `--all-joints` scores all 17), Hungarian matching on pelvis-relative
MPJPE. Host numpy, as in JAX: the flags are JAX's.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict


def load_mupots_gt(root: str, sequences=None):
    """Per-(seq, frame) lists of valid [17, 3] camera-space GT poses (mm)."""
    from metrabs_tpu_torch.data.datasets import (
        load_mupots_annotations, parse_mupots_person)

    gt = {}
    for i_seq, annotations in load_mupots_annotations(root, sequences):
        n_frames, n_people = annotations.shape
        for i_frame in range(n_frames):
            poses = []
            for i_person in range(n_people):
                parsed = parse_mupots_person(annotations[i_frame, i_person])
                if parsed is not None:
                    poses.append(parsed[0])
            gt[(i_seq, i_frame)] = poses
    return gt


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--pred-path', required=True)
    parser.add_argument('--root', required=True, help='MuPoTS dataset root')
    parser.add_argument('--threshold-mm', type=float, default=150.0)
    parser.add_argument('--all-joints', action='store_true',
                        help='evaluate all 17 joints instead of the '
                             'standard 14-joint subset')
    args = parser.parse_args(argv)

    import numpy as np

    from metrabs_tpu_torch.eval.harness import matched_pose_metrics

    data = np.load(args.pred_path, allow_pickle=True)
    preds_by_frame = defaultdict(list)
    for path, pose in zip(data['image_path'], data['coords3d_pred_world']):
        # 'mupots/TS3/img_000017.jpg' -> (3, 17)
        parts = str(path).split('/')
        i_seq = int(parts[-2][2:])
        i_frame = int(parts[-1].split('_')[1].split('.')[0])
        preds_by_frame[(i_seq, i_frame)].append(np.asarray(pose, np.float32))

    gt = load_mupots_gt(args.root)
    preds_per_frame, gts_per_frame = [], []
    for key, gts in sorted(gt.items()):
        gts_per_frame.append(gts)
        preds_per_frame.append(preds_by_frame.get(key, []))

    metrics = matched_pose_metrics(
        preds_per_frame, gts_per_frame, threshold_mm=args.threshold_mm,
        root_index=14,
        eval_joints=None if args.all_joints else list(range(14)))
    out = {'pck': metrics['matched_pck'] * 100,
           'apck': metrics['matched_apck'] * 100,
           'recall': metrics['recall'] * 100,
           'n_frames': len(gts_per_frame)}
    print(json.dumps(out, indent=2))
    return out


if __name__ == '__main__':
    main()
