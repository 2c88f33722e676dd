"""3DPW evaluation CLI (`metrabs_tpu/apps/eval_3dpw.py`): consumes the
`predict_3dpw` per-sequence pickle dumps plus the dataset's sequenceFiles
ground truth and prints the standard metrics: pelvis-relative MPJPE,
PA-MPJPE (Procrustes, on `--device`), PCK@50mm and AUC(0..200mm) over the 24
SMPL joints.

  python -m metrabs_tpu_torch.apps.eval_3dpw --pred-path preds/3dpw \
      --root $DATA/3dpw [--split test] [--joints 0,1,2,...]

Per-frame camera-space poses: GT world joints are moved to the camera frame
with each frame's cam_poses, predictions are the camera-space
(identity-extrinsics) output of predict_3dpw, tracks correspond by
construction, and frames with invalid camera poses or missing (NaN)
predictions are excluded. JAX's flags and defaults, plus `--device`
(default cuda).
"""

from __future__ import annotations

import argparse
import glob
import json
import os.path as osp
import pickle


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--pred-path', required=True,
                        help='output dir of predict_3dpw')
    parser.add_argument('--root', required=True, help='3DPW dataset root')
    parser.add_argument('--split', default='test')
    parser.add_argument('--joints', default=None,
                        help='comma-separated joint subset (default all 24)')
    parser.add_argument('--pck-threshold-mm', type=float, default=50.0)
    parser.add_argument('--device', default='cuda',
                        help="the device of the Procrustes alignment (default cuda; 'cpu')")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from metrabs_tpu_torch.ops.procrustes import rigid_align
    from metrabs_tpu_torch.pipeline.estimator import checked_device

    device = checked_device(args.device)
    sel = (np.array([int(i) for i in args.joints.split(',')])
           if args.joints else slice(None))

    all_pred = []
    all_gt = []
    seq_paths = sorted(
        glob.glob(osp.join(args.root, 'sequenceFiles', args.split, '*.pkl')))
    for seq_path in seq_paths:
        seq_name = osp.basename(seq_path).split('.')[0]
        pred_file = osp.join(args.pred_path, args.split, f'{seq_name}.pkl')
        if not osp.exists(pred_file):
            print(f'{seq_name}: no predictions, skipping')
            continue
        with open(seq_path, 'rb') as f:
            seq = pickle.load(f, encoding='latin1')
        with open(pred_file, 'rb') as f:
            preds = pickle.load(f)['jointPositions']  # [T, F, 24, 3] meters
        gt_tracks = [np.asarray(j, np.float64).reshape(-1, 24, 3)
                     for j in seq['jointPositions']]  # world meters
        cam_poses = np.asarray(seq['cam_poses'], np.float64)  # [F, 4, 4]
        valid = np.asarray(seq['campose_valid'])
        for i_track, gt_world in enumerate(gt_tracks):
            if i_track >= len(preds):
                continue
            pred_cam = np.asarray(preds[i_track], np.float64) * 1000.0  # mm
            n = min(len(gt_world), len(pred_cam))
            for i_frame in range(n):
                if valid.ndim == 2 and not valid[i_track, i_frame]:
                    continue
                p = pred_cam[i_frame]
                if np.any(np.isnan(p)):
                    continue
                ext = cam_poses[i_frame]
                g = (ext[:3, :3] @ (gt_world[i_frame] * 1000.0).T
                     + ext[:3, 3:4] * 1000.0).T  # world -> camera, mm
                all_pred.append(p)
                all_gt.append(g)

    if not all_pred:
        raise SystemExit('No overlapping predictions/GT found.')
    pred = np.stack(all_pred)  # [N, 24, 3] camera mm
    gt = np.stack(all_gt)
    # Pelvis (SMPL joint 0)-relative error; Procrustes batched over all poses.
    rel = (gt - gt[:, :1]) - (pred - pred[:, :1])
    err = np.linalg.norm(rel[:, sel], axis=-1).reshape(-1)
    aligned = rigid_align(
        torch.as_tensor(pred, dtype=torch.float32, device=device),
        torch.as_tensor(gt, dtype=torch.float32, device=device),
        scale_align=True).cpu().numpy()
    err_pa = np.linalg.norm((gt - aligned)[:, sel], axis=-1).reshape(-1)
    auc_grid = np.linspace(0, 200, 201)
    out = {
        'mpjpe': float(err.mean()),
        'pa_mpjpe': float(err_pa.mean()),
        f'pck@{args.pck_threshold_mm:g}':
            float((err <= args.pck_threshold_mm).mean() * 100),
        'auc@200': float(np.mean([(err <= t).mean() for t in auc_grid]) * 100),
        'n_poses': len(all_pred),
    }
    print(json.dumps(out, indent=2))
    return out


if __name__ == '__main__':
    main()
