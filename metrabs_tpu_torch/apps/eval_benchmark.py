"""Benchmark predict+eval CLI (`metrabs_tpu/apps/eval_benchmark.py`): a
packaged model and a pickle of `Example3D` (from the port's or the JAX
package's dataset adapters) in, the crop model run over the test set by
`eval/harness.py::predict_dataset` on `--device`, the standard metric
table out. Predictions are optionally dumped as NPZ (`--pred-out`; an HDF5
path raises, ROADMAP.md "HDF5 reader").

  python -m metrabs_tpu_torch.apps.eval_benchmark \
      --package models/metrabs_eff2s --examples 3dpw_test.pkl \
      --benchmark 3dpw [--pred-out preds.npz] [--mirror-aug]

JAX's flags and defaults, plus `--device` (default cuda).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--package', required=True)
    parser.add_argument('--examples', required=True)
    parser.add_argument('--benchmark', default='h36m',
                        help='3dpw|h36m|3dhp|mupots|3doh|aspset')
    parser.add_argument('--pred-out', default=None)
    parser.add_argument('--mirror-aug', action='store_true')
    parser.add_argument('--batch-size', type=int, default=64)
    parser.add_argument('--workers', type=int, default=8)
    parser.add_argument('--device', default='cuda',
                        help="the device to predict on (default cuda; 'cpu' for a CPU run)")
    args = parser.parse_args(argv)

    from metrabs_tpu_torch.data.loading import load_examples
    from metrabs_tpu_torch.eval.harness import (
        BENCHMARK_PROTOCOLS, JOINT_SUBSETS, evaluate_predictions, predict_dataset,
        save_predictions)
    from metrabs_tpu_torch.io.packaging import load_pose_estimator

    estimator = load_pose_estimator(args.package, device=args.device)
    examples = load_examples(args.examples)
    protocol = BENCHMARK_PROTOCOLS[args.benchmark]

    # The packaged estimator's crop model is the prediction engine.
    model = estimator.crop_model
    preds = predict_dataset(
        lambda crops, intrinsics, valid: model(crops, intrinsics, sample_valid=valid),
        examples, estimator.joint_info, estimator.cfg,
        batch_size=args.batch_size, n_workers=args.workers,
        test_time_mirror_aug=args.mirror_aug, device=estimator.device)
    if args.pred_out:
        save_predictions(args.pred_out, preds)

    metrics = evaluate_predictions(
        preds, joint_info=estimator.joint_info,
        threshold_mm=protocol.pck_threshold_mm,
        joint_subset=(JOINT_SUBSETS[protocol.joint_subset]
                      if protocol.joint_subset else None),
        device=estimator.device)
    print(json.dumps({'benchmark': args.benchmark, **metrics}, indent=2))


if __name__ == '__main__':
    main()
