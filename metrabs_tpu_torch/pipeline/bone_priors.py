"""Built-in bone-length priors of the plausibility filter
(`metrabs_tpu/pipeline/bone_priors.py`'s lookup, copied so that the port
imports nothing of the JAX package).

The asset `metrabs_tpu_torch/assets/bone_priors.json` is a byte-for-byte
copy of `metrabs_tpu/assets/bone_priors.json` ({skeleton: {"names": [...],
"edges": [[i, j], ...], "mean_mm": [...]}}), which
`scripts/gen_bone_priors.py` regenerates; copy it again after regenerating.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, Optional

import numpy as np

from metrabs_tpu_torch.utils.joint_info import JointInfo

ASSET_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    'assets', 'bone_priors.json')


@functools.lru_cache(maxsize=1)
def load_builtin_priors() -> Dict[str, dict]:
    """The shipped asset (see module docstring). Empty dict if absent."""
    if not os.path.exists(ASSET_PATH):
        return {}
    with open(ASSET_PATH) as f:
        return json.load(f)


def priors_for_joint_info(joint_info: JointInfo) -> Optional[np.ndarray]:
    """Per-edge mean lengths for a joint set that matches a built-in
    skeleton by names AND edges (order-sensitive: the plausibility filter
    indexes priors by edge position). None if no built-in matches."""
    names = list(joint_info.names)
    edges = [[int(i), int(j)] for i, j in joint_info.edges]
    for entry in load_builtin_priors().values():
        if entry['names'] == names and entry['edges'] == edges:
            return np.asarray(entry['mean_mm'], np.float32)
    return None
