"""MPI-INF-3DHP test-set evaluation CLI (`metrabs_tpu/apps/eval_3dhp.py`):
consumes the `predict_3dhp` NPZ dump plus each sequence's `annot_data.mat`
(MATLAB v7.3 = HDF5, read by the port's `utils/hdf5.py`) ground truth and
prints the standard metrics: PCK@150mm and AUC(0..150mm) over the 17
joints after pelvis-root alignment, MPJPE over the detected frames, plus
per-sequence PCK. Undetected frames count as infinite error.

  python -m metrabs_tpu_torch.apps.eval_3dhp --pred-path preds/3dhp.npz \
      --root $DATA/3dhp [--threshold-mm 150]

Predictions and annot3 ground truth are both camera-space mm (the test
cameras' extrinsics are identity), joint order mpi_inf_3dhp_17 with the
pelvis at index 14. Host numpy, as in JAX: the flags are JAX's.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
from collections import defaultdict


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--pred-path', required=True)
    parser.add_argument('--root', required=True, help='3DHP test-set root')
    parser.add_argument('--threshold-mm', type=float, default=150.0)
    args = parser.parse_args(argv)

    import numpy as np

    from metrabs_tpu_torch.utils import hdf5

    data = np.load(args.pred_path, allow_pickle=True)
    preds_by_frame = {}
    for path, pose in zip(data['image_path'], data['coords3d_pred_world']):
        parts = str(path).replace('\\', '/').split('/')
        seq = next(p for p in parts if p.startswith('TS'))
        i_frame = int(parts[-1].split('_')[1].split('.')[0]) - 1  # 1-based
        preds_by_frame[(seq, i_frame)] = np.asarray(pose, np.float32)

    per_seq_err = defaultdict(list)
    for subj in range(1, 7):
        annot_path = osp.join(args.root, f'TS{subj}', 'annot_data.mat')
        if not osp.exists(annot_path):
            continue
        with hdf5.File(annot_path, 'r') as m:
            valid = np.asarray(m['valid_frame']).reshape(-1).astype(bool)
            annot3 = np.asarray(m['annot3'], np.float32)
        # The MATLAB [3, 17, 1, F] array reads as [F, 1, 17, 3]; to [F, 17, 3].
        annot3 = annot3.reshape(len(valid), -1, 3)
        for i_frame in np.where(valid)[0]:
            pred = preds_by_frame.get((f'TS{subj}', int(i_frame)))
            gt = annot3[i_frame]
            if pred is None:
                # Undetected person: count as all-wrong (inf error).
                per_seq_err[f'TS{subj}'].append(
                    np.full(gt.shape[0], np.inf, np.float32))
                continue
            gt_rel = gt - gt[14:15]
            pred_rel = pred - pred[14:15]
            per_seq_err[f'TS{subj}'].append(
                np.linalg.norm(gt_rel - pred_rel, axis=-1))

    if not per_seq_err:
        raise SystemExit('No ground-truth sequences found.')
    all_err = np.concatenate([np.stack(v) for v in per_seq_err.values()])
    if not np.any(np.isfinite(all_err)):
        raise SystemExit(
            'No prediction matched any ground-truth frame (all errors are '
            'the undetected placeholder); check --pred-path contents.')
    thresholds = np.linspace(0, args.threshold_mm, 151)
    out = {
        'pck': float((all_err <= args.threshold_mm).mean() * 100),
        'auc': float(np.mean([(all_err <= t).mean() for t in thresholds])
                     * 100),
        'mpjpe': float(np.mean(all_err[np.isfinite(all_err)])),
        'per_seq_pck': {
            k: float((np.stack(v) <= args.threshold_mm).mean() * 100)
            for k, v in sorted(per_seq_err.items())},
        'n_frames': int(len(all_err)),
    }
    print(json.dumps(out, indent=2))
    return out


if __name__ == '__main__':
    main()
