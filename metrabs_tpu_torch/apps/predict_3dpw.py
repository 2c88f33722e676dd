"""3DPW test-set prediction driver (`metrabs_tpu/apps/predict_3dpw.py`):
full multi-person detection over every sequence, track association by
2D-AUC Hungarian assignment (--gtassoc) or by stick-figure vs segmentation-
mask IoU (STCN mask pickles), and a per-sequence pickle dump of
`jointPositions` in meters mirroring the 3DPW sequenceFiles layout, the
input of `eval_3dpw` and of the official 3DPW evaluation.

  python -m metrabs_tpu_torch.apps.predict_3dpw --package models/eff2l \
      --root $DATA/3dpw --output-path preds/3dpw \
      [--gtassoc | --masks-dir $DATA/3dpw-more/stcn-pred] \
      [--real-intrinsics] [--num-aug 5]

As in JAX: detector_threshold 0.2, flip aug, suppress_implausible_poses
False, skeleton smpl_24, camera-space output. JAX's flags and defaults,
plus `--device` (default cuda). `--viz-dir` writes JAX's figures (the frame
with its 2D overlay beside the 3D scene, `utils.viz.plot_poses_3d`) every
`--viz-step` frames as `<viz-dir>/<sequence>_<frame:05d>.jpg`.
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import pickle
from concurrent.futures import ThreadPoolExecutor

# 3DPW's 2D annotation joint order (COCO-style 18).
JOINT_NAMES_2D = (
    'nose,neck,rsho,relb,rwri,lsho,lelb,lwri,rhip,rkne,rank,lhip,lkne,lank,'
    'reye,leye,lear,rear')
EDGE_CHAINS_2D = (
    'lsho-lelb-lwri,rsho-relb-rwri,lhip-lkne-lank,rhip-rkne-rank,'
    'lear-leye-nose-reye-rear')


def _joint_info_2d():
    from metrabs_tpu_torch.utils.joint_info import JointInfo
    names = tuple(JOINT_NAMES_2D.split(','))
    ids = {n: i for i, n in enumerate(names)}
    edges = []
    for chain in EDGE_CHAINS_2D.split(','):
        members = chain.split('-')
        edges.extend((ids[a], ids[b]) for a, b in zip(members, members[1:]))
    return JointInfo(names=names, edges=tuple(edges))


def complete_track(track, n_frames):
    """Fills gaps by repeating the last seen pose; NaN before first
    sighting."""
    import numpy as np
    track_dict = dict(track)
    result = []
    for i in range(n_frames):
        if i in track_dict:
            result.append(track_dict[i])
        elif result:
            result.append(result[-1])
        else:
            result.append(np.full_like(track[0][1], fill_value=np.nan))
    return result


def predict_sequence(estimator, frame_paths, poses2d_true, masks, ji2d, ji3d,
                     *, intrinsic_matrix, args, pool, seq_name=''):
    import numpy as np

    from metrabs_tpu_torch.apps.predict_common import to_host
    from metrabs_tpu_torch.data.improc import imread
    from metrabs_tpu_torch.eval.association import (
        associate_predictions, associate_predictions_to_masks)

    n_frames = len(frame_paths)
    n_tracks = poses2d_true.shape[1]
    prev2d = np.zeros((n_tracks, ji3d.n_joints, 2), np.float32)
    tracks = [[] for _ in range(n_tracks)]
    i_frame = 0
    for start in range(0, n_frames, args.batch_size):
        chunk = frame_paths[start:start + args.batch_size]
        images = np.stack(list(pool.map(imread, chunk)))
        kwargs = dict(
            internal_batch_size=args.internal_batch_size,
            detector_threshold=0.2, detector_nms_iou_threshold=0.7,
            detector_flip_aug=True, antialias_factor=args.antialias_factor,
            num_aug=args.num_aug, suppress_implausible_poses=False,
            default_fov_degrees=args.default_fov, skeleton='smpl_24',
            max_detections=args.max_detections)
        if intrinsic_matrix is not None:
            kwargs['intrinsic_matrix'] = np.tile(
                intrinsic_matrix[None], (len(images), 1, 1))
        pred = estimator.detect_poses_batched(images, **kwargs)
        valid = to_host(pred['valid'])
        poses3d_all = to_host(pred['poses3d'])
        poses2d_all = to_host(pred['poses2d'])
        for k in range(len(images)):
            p3 = poses3d_all[k][valid[k]]
            p2 = poses2d_all[k][valid[k]]
            if args.viz_dir and (i_frame % args.viz_step == 0):
                from metrabs_tpu_torch.utils.viz import plot_poses_3d
                os.makedirs(args.viz_dir, exist_ok=True)
                plot_poses_3d(
                    p3, ji3d.edges, image=images[k], poses2d=p2,
                    out_path=osp.join(
                        args.viz_dir, f'{seq_name}_{i_frame:05d}.jpg'))
            if masks is None:
                ordered, prev2d = associate_predictions(
                    p3, p2, poses2d_true[i_frame], prev2d, ji3d, ji2d)
            else:
                ordered = associate_predictions_to_masks(
                    p3, p2, images[k].shape[:2], masks[i_frame], ji3d)
            for pose, track in zip(ordered, tracks):
                if not np.any(np.isnan(pose)):
                    track.append((i_frame, pose))
            i_frame += 1
    return tracks


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--package', required=True)
    parser.add_argument('--root', required=True, help='3DPW dataset root')
    parser.add_argument('--output-path', required=True)
    parser.add_argument('--masks-dir', default=None,
                        help='per-sequence STCN mask pickles; default '
                             '<root>/../3dpw-more/stcn-pred')
    parser.add_argument('--gtassoc', action='store_true',
                        help='associate via annotated 2D poses instead of '
                             'segmentation masks')
    parser.add_argument('--real-intrinsics', action='store_true')
    parser.add_argument('--default-fov', type=float, default=55)
    parser.add_argument('--num-aug', type=int, default=5)
    parser.add_argument('--batch-size', type=int, default=16)
    parser.add_argument('--internal-batch-size', type=int, default=64)
    parser.add_argument('--antialias-factor', type=int, default=2)
    parser.add_argument('--max-detections', type=int, default=16)
    parser.add_argument('--io-threads', type=int, default=8)
    parser.add_argument('--viz-dir', default=None,
                        help='save 2D+3D overlay figures here')
    parser.add_argument('--viz-step', type=int, default=50)
    parser.add_argument('--device', default='cuda',
                        help="the device to predict on (default cuda; 'cpu' for a CPU run)")
    args = parser.parse_args(argv)

    import numpy as np

    from metrabs_tpu_torch.io.packaging import load_pose_estimator
    from metrabs_tpu_torch.pipeline.skeletons import SMPL_24

    estimator = load_pose_estimator(args.package, device=args.device)
    ji3d = SMPL_24
    ji2d = _joint_info_2d()
    masks_dir = args.masks_dir or osp.join(args.root, '..', '3dpw-more',
                                           'stcn-pred')

    seq_filepaths = sorted(glob.glob(f'{args.root}/sequenceFiles/*/*.pkl'))
    pool = ThreadPoolExecutor(args.io_threads)  # one pool for the whole run
    for seq_filepath in seq_filepaths:
        seq_name = osp.basename(seq_filepath).split('.')[0]
        split = osp.basename(osp.dirname(seq_filepath))
        out_path = osp.join(args.output_path, split, f'{seq_name}.pkl')
        if osp.exists(out_path):
            print(f'{seq_name} already done')
            continue
        frame_paths = sorted(
            glob.glob(f'{args.root}/imageFiles/{seq_name}/image_*.jpg'))
        if not frame_paths:
            print(f'{seq_name}: no frames found, skipping')
            continue
        with open(seq_filepath, 'rb') as f:
            seq = pickle.load(f, encoding='latin1')
        # [Frame, Track, Joint, Coord].
        poses2d_true = np.transpose(np.array(seq['poses2d']), [1, 0, 3, 2])
        intr = (np.asarray(seq['cam_intrinsics'], np.float32)
                if args.real_intrinsics else None)
        if args.gtassoc:
            masks = None
        else:
            with open(osp.join(masks_dir, f'{seq_name}.pkl'), 'rb') as f:
                masks = pickle.load(f)
        print(f'predicting {seq_name} ({len(frame_paths)} frames)...')
        tracks = predict_sequence(
            estimator, frame_paths, poses2d_true, masks, ji2d, ji3d,
            intrinsic_matrix=intr, args=args, pool=pool, seq_name=seq_name)
        coords3d = np.array([
            complete_track(t, len(frame_paths)) if t
            else np.full((len(frame_paths), ji3d.n_joints, 3), np.nan)
            for t in tracks]) / 1000  # mm -> m
        os.makedirs(osp.dirname(out_path), exist_ok=True)
        with open(out_path, 'wb') as f:
            pickle.dump(dict(jointPositions=coords3d), f)
        print(f'wrote {out_path}')
    pool.shutdown()


if __name__ == '__main__':
    main()
