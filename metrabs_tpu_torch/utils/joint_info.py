"""Joint metadata: names, kinematic edges, left/right mirror mapping
(`metrabs_tpu/utils/joint_info.py`, copied so that the port imports nothing
of the JAX package).

Joint names follow the posepile convention of 'l'/'r' prefixes (e.g.
'lsho'/'rsho'); the mirror mapping swaps them, which is what the TTA flip
unswap relies on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np


def _mirror_name(name: str) -> str:
    if name.startswith('l') and not name.startswith('le_'):
        return 'r' + name[1:]
    if name.startswith('r'):
        return 'l' + name[1:]
    return name


@dataclasses.dataclass(frozen=True)
class JointInfo:
    names: Tuple[str, ...]
    edges: Tuple[Tuple[int, int], ...]

    @property
    def n_joints(self) -> int:
        return len(self.names)

    @property
    def ids(self) -> Dict[str, int]:
        return {name: i for i, name in enumerate(self.names)}

    @property
    def mirror_mapping(self) -> np.ndarray:
        """Index permutation that swaps left and right joints."""
        ids = self.ids
        return np.array([ids.get(_mirror_name(name), ids[name]) for name in self.names],
                        np.int32)

    def joint2bone_matrix(self) -> np.ndarray:
        """[n_bones, n_joints] matrix mapping joints to bone vectors."""
        mat = np.zeros((len(self.edges), self.n_joints), np.float32)
        for i_bone, (i, j) in enumerate(self.edges):
            mat[i_bone, i] = 1.0
            mat[i_bone, j] = -1.0
        return mat


def make_joint_info(names: Sequence[str], edge_names: Sequence[Tuple[str, str]]) -> JointInfo:
    ids = {n: i for i, n in enumerate(names)}
    edges = tuple((ids[a], ids[b]) for a, b in edge_names)
    return JointInfo(names=tuple(names), edges=edges)
