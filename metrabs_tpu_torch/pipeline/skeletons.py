"""Skeleton-convention registry and output remapping
(`metrabs_tpu/pipeline/skeletons.py`, copied so that the port imports
nothing of the JAX package).

Each convention name resolves on the host to an index vector into the
model's joints; the estimator gathers its outputs with it. Built-in
conventions cover the standard public skeletons; a package manifest may
carry its own registry (`io.packaging`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from metrabs_tpu_torch.utils.joint_info import JointInfo, make_joint_info

H36M_17 = make_joint_info(
    ['pelv', 'rhip', 'rkne', 'rank', 'lhip', 'lkne', 'lank', 'spin', 'neck',
     'head', 'htop', 'lsho', 'lelb', 'lwri', 'rsho', 'relb', 'rwri'],
    [('pelv', 'rhip'), ('rhip', 'rkne'), ('rkne', 'rank'), ('pelv', 'lhip'),
     ('lhip', 'lkne'), ('lkne', 'lank'), ('pelv', 'spin'), ('spin', 'neck'),
     ('neck', 'head'), ('head', 'htop'), ('neck', 'lsho'), ('lsho', 'lelb'),
     ('lelb', 'lwri'), ('neck', 'rsho'), ('rsho', 'relb'), ('relb', 'rwri')])

COCO_19 = make_joint_info(
    ['neck', 'nose', 'pelv', 'lsho', 'lelb', 'lwri', 'lhip', 'lkne', 'lank',
     'rsho', 'relb', 'rwri', 'rhip', 'rkne', 'rank', 'leye', 'lear', 'reye',
     'rear'],
    [('neck', 'nose'), ('neck', 'pelv'), ('neck', 'lsho'), ('lsho', 'lelb'),
     ('lelb', 'lwri'), ('pelv', 'lhip'), ('lhip', 'lkne'), ('lkne', 'lank'),
     ('neck', 'rsho'), ('rsho', 'relb'), ('relb', 'rwri'), ('pelv', 'rhip'),
     ('rhip', 'rkne'), ('rkne', 'rank'), ('nose', 'leye'), ('leye', 'lear'),
     ('nose', 'reye'), ('reye', 'rear')])

SMPL_24 = make_joint_info(
    ['pelv', 'lhip', 'rhip', 'bell', 'lkne', 'rkne', 'spin', 'lank', 'rank',
     'thor', 'ltoe', 'rtoe', 'neck', 'lcla', 'rcla', 'head', 'lsho', 'rsho',
     'lelb', 'relb', 'lwri', 'rwri', 'lhan', 'rhan'],
    [('pelv', 'lhip'), ('lhip', 'lkne'), ('lkne', 'lank'), ('lank', 'ltoe'),
     ('pelv', 'rhip'), ('rhip', 'rkne'), ('rkne', 'rank'), ('rank', 'rtoe'),
     ('pelv', 'bell'), ('bell', 'spin'), ('spin', 'thor'), ('thor', 'neck'),
     ('neck', 'head'), ('thor', 'lcla'), ('lcla', 'lsho'), ('lsho', 'lelb'),
     ('lelb', 'lwri'), ('lwri', 'lhan'), ('thor', 'rcla'), ('rcla', 'rsho'),
     ('rsho', 'relb'), ('relb', 'rwri'), ('rwri', 'rhan')])

MPI_INF_3DHP_17 = make_joint_info(
    ['htop', 'neck', 'rsho', 'relb', 'rwri', 'lsho', 'lelb', 'lwri', 'rhip',
     'rkne', 'rank', 'lhip', 'lkne', 'lank', 'pelv', 'spin', 'head'],
    [('htop', 'head'), ('head', 'neck'), ('neck', 'rsho'), ('rsho', 'relb'),
     ('relb', 'rwri'), ('neck', 'lsho'), ('lsho', 'lelb'), ('lelb', 'lwri'),
     ('neck', 'spin'), ('spin', 'pelv'), ('pelv', 'rhip'), ('rhip', 'rkne'),
     ('rkne', 'rank'), ('pelv', 'lhip'), ('lhip', 'lkne'), ('lkne', 'lank')])

LSP_14 = make_joint_info(
    ['rank', 'rkne', 'rhip', 'lhip', 'lkne', 'lank', 'rwri', 'relb', 'rsho',
     'lsho', 'lelb', 'lwri', 'neck', 'htop'],
    [('rank', 'rkne'), ('rkne', 'rhip'), ('lhip', 'lkne'), ('lkne', 'lank'),
     ('rwri', 'relb'), ('relb', 'rsho'), ('lsho', 'lelb'), ('lelb', 'lwri'),
     ('rsho', 'neck'), ('neck', 'lsho'), ('neck', 'htop'), ('rhip', 'lhip')])

KINECTV2_25 = make_joint_info(
    # Kinect v2 SDK JointType order (SpineBase..ThumbRight).
    ['pelv', 'spin', 'neck', 'head', 'lsho', 'lelb', 'lwri', 'lhan', 'rsho',
     'relb', 'rwri', 'rhan', 'lhip', 'lkne', 'lank', 'lfoo', 'rhip', 'rkne',
     'rank', 'rfoo', 'spi2', 'lhti', 'lthu', 'rhti', 'rthu'],
    [('pelv', 'spin'), ('spin', 'spi2'), ('spi2', 'neck'), ('neck', 'head'),
     ('spi2', 'lsho'), ('lsho', 'lelb'), ('lelb', 'lwri'), ('lwri', 'lhan'),
     ('lhan', 'lhti'), ('lwri', 'lthu'), ('spi2', 'rsho'), ('rsho', 'relb'),
     ('relb', 'rwri'), ('rwri', 'rhan'), ('rhan', 'rhti'), ('rwri', 'rthu'),
     ('pelv', 'lhip'), ('lhip', 'lkne'), ('lkne', 'lank'), ('lank', 'lfoo'),
     ('pelv', 'rhip'), ('rhip', 'rkne'), ('rkne', 'rank'), ('rank', 'rfoo')])

MPI_INF_3DHP_28 = make_joint_info(
    # The full 3DHP 28-joint set ('all' annotation order).
    ['spi3', 'spi4', 'spi2', 'spin', 'pelv', 'neck', 'head', 'htop', 'lcla',
     'lsho', 'lelb', 'lwri', 'lhan', 'rcla', 'rsho', 'relb', 'rwri', 'rhan',
     'lhip', 'lkne', 'lank', 'lfoo', 'ltoe', 'rhip', 'rkne', 'rank', 'rfoo',
     'rtoe'],
    [('spi3', 'spi4'), ('spi2', 'spi3'), ('spin', 'spi2'), ('pelv', 'spin'),
     ('spi4', 'neck'), ('neck', 'head'), ('head', 'htop'), ('neck', 'lcla'),
     ('lcla', 'lsho'), ('lsho', 'lelb'), ('lelb', 'lwri'), ('lwri', 'lhan'),
     ('neck', 'rcla'), ('rcla', 'rsho'), ('rsho', 'relb'), ('relb', 'rwri'),
     ('rwri', 'rhan'), ('pelv', 'lhip'), ('lhip', 'lkne'), ('lkne', 'lank'),
     ('lank', 'lfoo'), ('lfoo', 'ltoe'), ('pelv', 'rhip'), ('rhip', 'rkne'),
     ('rkne', 'rank'), ('rank', 'rfoo'), ('rfoo', 'rtoe')])

H36M_25 = make_joint_info(
    # The 25 distinct named H36M joints (32 raw minus duplicates/zeros).
    ['pelv', 'rhip', 'rkne', 'rank', 'rfoo', 'rtoe', 'lhip', 'lkne', 'lank',
     'lfoo', 'ltoe', 'spin', 'neck', 'head', 'htop', 'lsho', 'lelb', 'lwri',
     'lthu', 'lfin', 'rsho', 'relb', 'rwri', 'rthu', 'rfin'],
    [('pelv', 'rhip'), ('rhip', 'rkne'), ('rkne', 'rank'), ('rank', 'rfoo'),
     ('rfoo', 'rtoe'), ('pelv', 'lhip'), ('lhip', 'lkne'), ('lkne', 'lank'),
     ('lank', 'lfoo'), ('lfoo', 'ltoe'), ('pelv', 'spin'), ('spin', 'neck'),
     ('neck', 'head'), ('head', 'htop'), ('neck', 'lsho'), ('lsho', 'lelb'),
     ('lelb', 'lwri'), ('lwri', 'lthu'), ('lwri', 'lfin'), ('neck', 'rsho'),
     ('rsho', 'relb'), ('relb', 'rwri'), ('rwri', 'rthu'), ('rwri', 'rfin')])

ASPSET_17 = make_joint_info(
    # ASPset-510 'aspset_17j' convention.
    ['rank', 'rkne', 'rhip', 'rwri', 'relb', 'rsho', 'lank', 'lkne', 'lhip',
     'lwri', 'lelb', 'lsho', 'htop', 'head', 'neck', 'spin', 'pelv'],
    [('rank', 'rkne'), ('rkne', 'rhip'), ('rhip', 'pelv'), ('rwri', 'relb'),
     ('relb', 'rsho'), ('rsho', 'neck'), ('lank', 'lkne'), ('lkne', 'lhip'),
     ('lhip', 'pelv'), ('lwri', 'lelb'), ('lelb', 'lsho'), ('lsho', 'neck'),
     ('htop', 'head'), ('head', 'neck'), ('neck', 'spin'), ('spin', 'pelv')])

SMPL_HEAD_30 = make_joint_info(
    # The reference's headline demo skeleton: SMPL's 24 body joints plus the
    # five COCO face keypoints and the head top (posepile 'smpl+head_30').
    list(SMPL_24.names) + ['nose', 'leye', 'reye', 'lear', 'rear', 'htop'],
    [(SMPL_24.names[a], SMPL_24.names[b]) for a, b in SMPL_24.edges]
    + [('head', 'nose'), ('nose', 'leye'), ('nose', 'reye'),
       ('leye', 'lear'), ('reye', 'rear'), ('head', 'htop')])

JTA_22 = make_joint_info(
    # JTA (Joint Track Auto) SDK joint order: head_top, head_center, neck,
    # right clavicle/shoulder/elbow/wrist, left likewise, spine0..spine4
    # (top to bottom), then right and left hip/knee/ankle.
    ['htop', 'head', 'neck', 'rcla', 'rsho', 'relb', 'rwri', 'lcla', 'lsho',
     'lelb', 'lwri', 'spi0', 'spi1', 'spi2', 'spi3', 'spi4', 'rhip', 'rkne',
     'rank', 'lhip', 'lkne', 'lank'],
    [('htop', 'head'), ('head', 'neck'), ('neck', 'rcla'), ('rcla', 'rsho'),
     ('rsho', 'relb'), ('relb', 'rwri'), ('neck', 'lcla'), ('lcla', 'lsho'),
     ('lsho', 'lelb'), ('lelb', 'lwri'), ('neck', 'spi0'), ('spi0', 'spi1'),
     ('spi1', 'spi2'), ('spi2', 'spi3'), ('spi3', 'spi4'), ('spi4', 'rhip'),
     ('rhip', 'rkne'), ('rkne', 'rank'), ('spi4', 'lhip'), ('lhip', 'lkne'),
     ('lkne', 'lank')])

TOTAL_CAPTURE_21 = make_joint_info(
    # TotalCapture's released Vicon BVH hierarchy order: Hips, Spine..Spine3,
    # Neck, Head, Right Shoulder(clavicle)/Arm/ForeArm/Hand, left likewise,
    # Right UpLeg/Leg/Foot, left likewise.
    ['pelv', 'spin', 'spi1', 'spi2', 'spi3', 'neck', 'head', 'rcla', 'rsho',
     'relb', 'rwri', 'lcla', 'lsho', 'lelb', 'lwri', 'rhip', 'rkne', 'rank',
     'lhip', 'lkne', 'lank'],
    [('pelv', 'spin'), ('spin', 'spi1'), ('spi1', 'spi2'), ('spi2', 'spi3'),
     ('spi3', 'neck'), ('neck', 'head'), ('spi3', 'rcla'), ('rcla', 'rsho'),
     ('rsho', 'relb'), ('relb', 'rwri'), ('spi3', 'lcla'), ('lcla', 'lsho'),
     ('lsho', 'lelb'), ('lelb', 'lwri'), ('pelv', 'rhip'), ('rhip', 'rkne'),
     ('rkne', 'rank'), ('pelv', 'lhip'), ('lhip', 'lkne'), ('lkne', 'lank')])

BUILTIN_SKELETONS: Dict[str, JointInfo] = {
    'h36m_17': H36M_17,
    'h36m_25': H36M_25,
    'coco_19': COCO_19,
    'smpl_24': SMPL_24,
    'smpl+head_30': SMPL_HEAD_30,
    'mpi_inf_3dhp_17': MPI_INF_3DHP_17,
    'mpi_inf_3dhp_28': MPI_INF_3DHP_28,
    'kinectv2_25': KINECTV2_25,
    'aspset_17': ASPSET_17,
    'lsp_14': LSP_14,
    'jta_22': JTA_22,
    'total_capture_21': TOTAL_CAPTURE_21,
}


@dataclasses.dataclass(frozen=True)
class SkeletonInfo:
    indices: Tuple[int, ...]  # indices into the model's joint set
    names: Tuple[str, ...]
    edges: Tuple[Tuple[int, int], ...]


def select_skeleton_indices(
        joint_info_src: JointInfo, skeleton_dst: JointInfo,
        skeleton_type_dst: str = '') -> np.ndarray:
    """Resolves each destination joint to a source joint index by name.

    Replicates `metrabs_tf/models/util.py:41-53` including its quirk: when a
    suffixed variant `name_<dst>` exists among the source joints, the source
    index of `name_h36m` is looked up regardless of dst.
    """
    names_src = list(joint_info_src.names)

    def get_index(name: str) -> int:
        if skeleton_type_dst and (name + '_' + skeleton_type_dst) in names_src:
            return names_src.index(name + '_h36m')
        return names_src.index(name)

    return np.array([get_index(n) for n in skeleton_dst.names], np.int32)


class SkeletonRegistry:
    """Maps skeleton-convention names to gather indices into the model's
    joints."""

    def __init__(self, model_joint_info: JointInfo,
                 skeleton_infos: Optional[Dict[str, SkeletonInfo]] = None):
        self.model_joint_info = model_joint_info
        self._infos: Dict[str, SkeletonInfo] = {}
        if skeleton_infos:
            self._infos.update(skeleton_infos)
        else:
            for name, ji in BUILTIN_SKELETONS.items():
                try:
                    indices = select_skeleton_indices(
                        model_joint_info, ji, name.rsplit('_', 1)[0])
                except ValueError:
                    continue  # model joint set does not cover this skeleton
                self._infos[name] = SkeletonInfo(
                    indices=tuple(int(i) for i in indices),
                    names=ji.names, edges=ji.edges)
        # '' = the model's full joint set.
        self._infos[''] = SkeletonInfo(
            indices=tuple(range(model_joint_info.n_joints)),
            names=model_joint_info.names, edges=model_joint_info.edges)

    @property
    def skeleton_names(self):
        return tuple(k for k in self._infos if k)

    def indices(self, skeleton: str) -> np.ndarray:
        if skeleton not in self._infos:
            raise KeyError(
                f'Unknown skeleton {skeleton!r}. Available: {sorted(self._infos)}')
        return np.array(self._infos[skeleton].indices, np.int32)

    def joint_names(self, skeleton: str) -> Tuple[str, ...]:
        return self._infos[skeleton].names

    def joint_edges(self, skeleton: str) -> Tuple[Tuple[int, int], ...]:
        return self._infos[skeleton].edges

    @property
    def per_skeleton_joint_names(self) -> Dict[str, Tuple[str, ...]]:
        return {k: v.names for k, v in self._infos.items() if k}

    @property
    def per_skeleton_joint_edges(self) -> Dict[str, Tuple[Tuple[int, int], ...]]:
        return {k: v.edges for k, v in self._infos.items() if k}

