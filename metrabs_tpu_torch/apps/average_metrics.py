"""Multi-seed metric averaging (`metrabs_tpu/apps/average_metrics.py`, the
reference's 5-seed reporting protocol): averages the metric JSONs printed by
eval_benchmark runs and reports mean +- stdev per metric. A copy: host
numpy only.

  python -m metrabs_tpu_torch.apps.average_metrics run1.json run2.json ...
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('files', nargs='+')
    args = parser.parse_args(argv)

    runs = []
    for path in args.files:
        with open(path) as f:
            runs.append(json.load(f))
    keys = [k for k, v in runs[0].items() if isinstance(v, (int, float))]
    out = {}
    for k in keys:
        values = np.array([r[k] for r in runs if k in r], np.float64)
        out[k] = dict(mean=float(values.mean()),
                      stdev=float(values.std(ddof=1)) if len(values) > 1 else 0.0,
                      n=len(values))
    print(json.dumps(out, indent=2))


if __name__ == '__main__':
    main()
