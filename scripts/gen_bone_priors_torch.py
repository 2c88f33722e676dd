"""Regenerates the port's shipped bone-prior asset
(`metrabs_tpu_torch/assets/bone_priors.json`); see
`metrabs_tpu_torch/pipeline/bone_priors.py` for the distribution.
Deterministic: seed and sample count are pinned, so reruns are byte-stable.

  python scripts/gen_bone_priors_torch.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from metrabs_tpu_torch.pipeline import bone_priors


def main():
    data = bone_priors.accumulate_builtin_priors(n_samples=512, seed=0)
    os.makedirs(os.path.dirname(bone_priors.ASSET_PATH), exist_ok=True)
    with open(bone_priors.ASSET_PATH, 'w') as f:
        json.dump(data, f, indent=1)
    print(f'wrote {bone_priors.ASSET_PATH}: '
          f'{len(data)} skeletons, '
          f'{sum(len(v["mean_mm"]) for v in data.values())} edges')


if __name__ == '__main__':
    main()
