"""Attributes the gap between the crop-protocol validation error and the
served error of a trained package (`scripts/ablate_crop_served_gap.py` in
torch), on the same held-out scenes as `scripts/train_to_serve_e2e_torch.py`:

  crop_eval      the validation protocol: `load_and_transform3d` crops,
                 absolute metrics (`eval/harness.py`), the training log's
                 number
  served_neutral `estimate_poses_batched` on ground-truth boxes, one aug with
                 the TTA schedule replaced by identity (gamma 1, scale 1,
                 angle 0, no flip): the serving warp and decode alone
  served_gamma   gamma 0.8 only (scale 1): the brightness term of the TTA
  served_scale   scale 1.05 only (gamma 1): the zoom term
  served_aug1/2/5 the stock TTA schedules (num_aug 1 serves gamma 0.8 and
                 scale 1.05, the reference's linspace midpoint)
  served_aug2_0/1 each aug of num_aug 2's schedule alone (aug 0: flipped,
                 gamma 0.6, angle -25 degrees, scale 0.8; aug 1: gamma 1,
                 +25 degrees, scale 1.05), and each of aug 0's terms alone
                 (served_flip, served_gamma06, served_rot_neg, served_scale08)
                 and aug 1's rotation (served_rot_pos), then aug 0's terms
                 in pairs and in threes (e.g. served_flip+gamma06), to find
                 where they compound
  detect_aug1/2/5 `detect_poses_batched` as the run serves it (threshold 0.3,
                 max_detections 8) with matched recall, PCK and APCK at 150 mm
  near/far       scenes re-rendered with people at z 2800-3800 mm vs
                 5800-7000 mm, crop_eval and served_neutral each

Each served entry has root-relative (mean-aligned) and absolute MPJPE and the
share of joints within 150 mm absolute (`apck`). A single-aug entry replaces
`tta.make_tta_params`, which the estimator looks up at each call, for its
serve, and raises if the estimator did not call the replacement. Writes the
record as JSON.

  python scripts/ablate_crop_served_gap_torch.py \\
      [--package runs/train2serve_torch/package] [--device cuda]
"""

import argparse
import importlib.util
import itertools
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def load_train_to_serve():
    spec = importlib.util.spec_from_file_location(
        'train_to_serve_e2e_torch', os.path.join(REPO, 'scripts', 'train_to_serve_e2e_torch.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def single_aug_params(gamma=1.0, scale=1.0, angle=0.0, flip=False):
    """The TTA parameters of one aug of identity but for the given terms,
    its rotation and flip matrix made as `tta.make_tta_params` makes it."""
    from metrabs_tpu_torch.pipeline.tta import TTAParams

    sin, cos = np.sin(-np.float32(angle)), np.cos(-np.float32(angle))
    rotflip = np.diag(np.float32([-1 if flip else 1, 1, 1])) @ np.array(
        [[cos, -sin, 0], [sin, cos, 0], [0, 0, 1]], np.float32)
    return TTAParams(gammas=np.float32([gamma]), angles=np.float32([angle]),
                     scales=np.float32([scale]), should_flip=np.array([flip]),
                     rotflip_mats=rotflip[None])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--package', default=os.path.join(REPO, 'runs', 'train2serve_torch',
                                                     'package'))
    p.add_argument('--val-scenes', type=int, default=16)
    p.add_argument('--record', default=os.path.join(REPO, 'GAP_ABLATION_torch.json'))
    p.add_argument('--device', default='cuda',
                   help="the device to run on (default cuda; 'cpu' for a CPU run)")
    args = p.parse_args(argv)
    t0 = time.time()

    def tick(msg):
        print(f'[{time.time() - t0:7.1f}s] {msg}', flush=True)

    from metrabs_tpu_torch.config import AugConfig
    from metrabs_tpu_torch.eval.harness import (evaluate_predictions, matched_pose_metrics,
                                                predict_dataset)
    from metrabs_tpu_torch.io.packaging import load_crop_model, load_pose_estimator
    from metrabs_tpu_torch.pipeline import tta as tta_mod
    from metrabs_tpu_torch.pipeline.estimator import checked_device

    device = checked_device(args.device)
    t2s = load_train_to_serve()
    model, cfg, joint_info, manifest = load_crop_model(args.package, device=device)

    def crop_eval(examples):
        preds = predict_dataset(
            lambda crops, k, valid: model(crops, k, sample_valid=valid), examples, joint_info,
            cfg, batch_size=32, n_workers=3, device=device)
        m = evaluate_predictions(preds, joint_info=joint_info, device=device)
        return dict(mpjpe=m['mean_error'], mpjpe_abs=m['mean_error_abs'])

    def served_eval(est, scenes, cam, num_aug):
        imgs = np.stack([s[0] for s in scenes])
        intrinsics = np.tile(cam.intrinsic_matrix[None], (len(scenes), 1, 1))
        out = est.estimate_poses_batched(imgs, t2s.scene_boxes(scenes, cam),
                                         intrinsic_matrix=intrinsics, num_aug=num_aug)
        poses3d = out['poses3d'].cpu().numpy()
        errs, errs_abs = [], []
        for i, (_, poses) in enumerate(scenes):
            for k, gt in enumerate(poses):
                pred = poses3d[i, k]
                rr = (pred - pred.mean(0)) - (gt - gt.mean(0))
                errs.append(np.linalg.norm(rr, axis=-1).mean())
                errs_abs.append(np.linalg.norm(pred - gt, axis=-1))
        errs_abs = np.stack(errs_abs)
        return dict(mpjpe=float(np.mean(errs)), mpjpe_abs=float(errs_abs.mean()),
                    apck=float((errs_abs <= 150.0).mean()))

    def detect_eval(est, scenes, cam, num_aug):
        imgs = np.stack([s[0] for s in scenes])
        out = est.detect_poses_batched(
            imgs, intrinsic_matrix=np.tile(cam.intrinsic_matrix[None], (len(scenes), 1, 1)),
            num_aug=num_aug, max_detections=8, detector_threshold=0.3)
        poses3d = out['poses3d'].cpu().numpy()
        valid = out['valid'].cpu().numpy().astype(bool)
        return matched_pose_metrics([poses3d[i][valid[i]] for i in range(len(scenes))],
                                    [list(s[1]) for s in scenes], threshold_mm=150.0,
                                    root_index=0)

    variants = [('served_neutral', {}), ('served_gamma', dict(gamma=0.8)),
                ('served_scale', dict(scale=1.05))]
    two = tta_mod.make_tta_params(2, AugConfig(**manifest['aug_config']))
    terms = [dict(gamma=float(two.gammas[i]), scale=float(two.scales[i]),
                  angle=float(two.angles[i]), flip=bool(two.should_flip[i])) for i in range(2)]
    val_variants = [
        ('served_aug2_0', terms[0]), ('served_aug2_1', terms[1]),
        ('served_flip', dict(flip=terms[0]['flip'])),
        ('served_gamma06', dict(gamma=terms[0]['gamma'])),
        ('served_rot_neg', dict(angle=terms[0]['angle'])),
        ('served_scale08', dict(scale=terms[0]['scale'])),
        ('served_rot_pos', dict(angle=terms[1]['angle']))]
    term_names = dict(flip='flip', gamma='gamma06', angle='rot_neg', scale='scale08')
    for n_terms in (2, 3):
        for combo in itertools.combinations(term_names, n_terms):
            val_variants.append(('served_' + '+'.join(term_names[t] for t in combo),
                                 {t: terms[0][t] for t in combo}))
    splits = {
        'val': t2s.build_split(1007, args.val_scenes),
        'near': t2s.build_split(2007, args.val_scenes, z_range=(2800, 3800)),
        'far': t2s.build_split(3007, args.val_scenes, z_range=(5800, 7000)),
    }
    est = load_pose_estimator(args.package, device=device)
    results = {}
    for split_name, (scenes, ex3d, _, cam) in splits.items():
        r = {}
        tick(f'--- split {split_name} ({len(ex3d)} people) ---')
        r['crop_eval'] = crop_eval(ex3d)
        tick(f'{split_name} crop_eval: {r["crop_eval"]}')
        make_tta_params = tta_mod.make_tta_params
        for name, aug in variants + (val_variants if split_name == 'val' else []):
            calls = []

            def single(num_aug, aug_cfg, aug=aug):
                calls.append(num_aug)
                return single_aug_params(**aug)

            tta_mod.make_tta_params = single
            try:
                r[name] = served_eval(est, scenes, cam, num_aug=1)
            finally:
                tta_mod.make_tta_params = make_tta_params
            if not calls:
                raise RuntimeError(f'{name}: the estimator did not serve the replaced TTA '
                                   f'schedule')
            tick(f'{split_name} {name}: {r[name]}')
        if split_name == 'val':
            for num_aug in (1, 2, 5):
                r[f'served_aug{num_aug}'] = served_eval(est, scenes, cam, num_aug=num_aug)
                r[f'detect_aug{num_aug}'] = detect_eval(est, scenes, cam, num_aug=num_aug)
                tick(f'{split_name} num_aug {num_aug}: served {r[f"served_aug{num_aug}"]}, '
                     f'detect {r[f"detect_aug{num_aug}"]}')
        results[split_name] = r
    results['wall_s'] = time.time() - t0
    with open(args.record, 'w') as f:
        json.dump(results, f, indent=2)
    tick(f'record written to {args.record}')
    print(json.dumps(results), flush=True)
    print('GAP_ABLATION OK', flush=True)
    return results


if __name__ == '__main__':
    main()
