"""Built-in bone-length priors of the plausibility filter
(`metrabs_tpu/pipeline/bone_priors.py`, copied so that the port imports
nothing of the JAX package): the lookup of the shipped asset and the
generator that accumulates it.

The asset `metrabs_tpu_torch/assets/bone_priors.json` ({skeleton: {"names":
[...], "edges": [[i, j], ...], "mean_mm": [...]}}) holds per-edge mean
lengths for every built-in skeleton, accumulated through `BoneLengthStats`
(`pipeline.plausibility.compute_bone_mean_lengths`) from the synthetic
anthropometric distribution below. `scripts/gen_bone_priors_torch.py`
regenerates it (seed and sample count pinned); it comes out equal byte for
byte to the JAX package's asset.
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

# Canonical anthropometric template, millimeters, camera-style axes
# (x left-positive, y down-positive, z forward): an average standing adult.
# Joint names follow the posepile 'l'/'r' convention shared by all built-in
# skeletons (`pipeline/skeletons.py`).
BASE_TEMPLATE_MM: Dict[str, tuple] = {
    'pelv': (0, 0, 0),
    'rhip': (-130, 0, 0), 'rkne': (-145, 450, 0), 'rank': (-155, 890, 0),
    'rfoo': (-160, 950, 70), 'rtoe': (-160, 960, 170),
    'lhip': (130, 0, 0), 'lkne': (145, 450, 0), 'lank': (155, 890, 0),
    'lfoo': (160, 950, 70), 'ltoe': (160, 960, 170),
    'bell': (0, -110, 0), 'spin': (0, -250, 0), 'thor': (0, -400, 0),
    'neck': (0, -500, 0), 'head': (0, -600, 0), 'htop': (0, -720, 0),
    'nose': (0, -630, 95),
    'leye': (32, -660, 80), 'reye': (-32, -660, 80),
    'lear': (72, -645, 5), 'rear': (-72, -645, 5),
    'lcla': (60, -480, 0), 'rcla': (-60, -480, 0),
    'lsho': (185, -480, 0), 'rsho': (-185, -480, 0),
    'lelb': (265, -210, 0), 'relb': (-265, -210, 0),
    'lwri': (305, 40, 0), 'rwri': (-305, 40, 0),
    'lhan': (320, 115, 0), 'rhan': (-320, 115, 0),
    'lhti': (330, 170, 0), 'rhti': (-330, 170, 0),
    'lthu': (330, 75, 35), 'rthu': (-330, 75, 35),
    'lfin': (330, 165, 0), 'rfin': (-330, 165, 0),
}

# The spine-segment names mean different anatomical points per convention
# (JTA counts spi0..4 top-down, 3DHP-28 bottom-up, Kinect's spi2 is
# SpineShoulder, TotalCapture's chain is spin..spi3 bottom-up), so those
# joints are positioned per skeleton.
SKELETON_OVERRIDES_MM: Dict[str, Dict[str, tuple]] = {
    'kinectv2_25': {'spin': (0, -250, 0), 'spi2': (0, -450, 0)},
    'mpi_inf_3dhp_28': {'spin': (0, -140, 0), 'spi2': (0, -260, 0),
                        'spi3': (0, -380, 0), 'spi4': (0, -460, 0)},
    'jta_22': {'spi0': (0, -440, 0), 'spi1': (0, -340, 0),
               'spi2': (0, -240, 0), 'spi3': (0, -130, 0),
               'spi4': (0, -20, 0)},
    'total_capture_21': {'spin': (0, -125, 0), 'spi1': (0, -250, 0),
                         'spi2': (0, -375, 0), 'spi3': (0, -480, 0)},
}


def template_for(skeleton_name: str, joint_names) -> np.ndarray:
    """[J, 3] template positions for a built-in skeleton's joint list."""
    table = dict(BASE_TEMPLATE_MM)
    table.update(SKELETON_OVERRIDES_MM.get(skeleton_name, {}))
    return np.array([table[n] for n in joint_names], np.float32)


def accumulate_builtin_priors(n_samples: int = 512,
                              seed: int = 0) -> Dict[str, dict]:
    """Accumulates per-edge mean lengths for every built-in skeleton through
    the real `BoneLengthStats` path, over the synthetic pose distribution
    (per-sample uniform 0.9-1.1 global scale + 25mm isotropic joint jitter —
    the synthetic training world's regime)."""
    from metrabs_tpu_torch.pipeline.plausibility import compute_bone_mean_lengths
    from metrabs_tpu_torch.pipeline.skeletons import BUILTIN_SKELETONS

    out = {}
    for name, ji in BUILTIN_SKELETONS.items():
        rng = np.random.default_rng(seed)
        base = template_for(name, ji.names)
        scales = rng.uniform(0.9, 1.1, size=(n_samples, 1, 1))
        noise = rng.normal(size=(n_samples,) + base.shape) * 25.0
        coords = base[np.newaxis] * scales + noise
        validity = np.ones(coords.shape[:2], bool)
        mean_mm = compute_bone_mean_lengths(coords, validity, ji.edges)
        out[name] = dict(
            names=list(ji.names),
            edges=[[int(i), int(j)] for i, j in ji.edges],
            mean_mm=[round(float(x), 2) for x in mean_mm])
    return out


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
