"""Benchmark dataset layouts minted in a directory, and the stub estimator
that both packages' prediction drivers run against (tests/test_torch_
datasets.py, tests/test_torch_bench_apps.py).

Each `mint_*` writes the annotation files of one published benchmark in its
own format (3DPW sequence pickles, MuPoTS `annot.mat`, Human3.6M CDF poses
with a cameras JSON and `metadata.xml`, 3DOH50K's JSON, ASPset's CSV/JSON,
the generic NPZ) and, where a driver reads them, small JPEG frames written
by cv2, whose decode the port must equal.

`StubEstimator` is a plain Python object, shared by the JAX and the port
drivers: it records every call's images and keyword arguments and returns
poses computed from them, so equal output files mean equal arguments and
equal decoded frames.
"""

from __future__ import annotations

import json
import os
import pickle
import types
from pathlib import Path

import numpy as np

H36M_CAMERA_IDS = ('54138969', '55011271', '58860488', '60457274')
MUPOTS_JOINTS = 17


def write_jpeg(path, height: int, width: int, seed: int) -> None:
    """A JPEG of smooth colour and noise (cv2's default encoding, q 90)."""
    import cv2
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:height, :width]
    im = np.stack([128 + 80 * np.sin(x / 9 + k + seed) * np.cos(y / 7 - k) for k in range(3)], -1)
    im = np.clip(im + rng.normal(0, 12, im.shape), 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    assert cv2.imwrite(str(path), im, [cv2.IMWRITE_JPEG_QUALITY, 90])


def _look_at_world(rng, n: int, n_joints: int, depth=(3000.0, 5000.0)) -> np.ndarray:
    """Poses in mm in front of an identity camera."""
    centre = np.stack([rng.uniform(-400, 400, n), rng.uniform(-200, 200, n),
                       rng.uniform(*depth, n)], -1)
    return centre[:, None] + rng.normal(0, 250, (n, n_joints, 3))


def mint_3dpw(root: Path, rng, n_seqs: int = 2, n_frames: int = 5, n_tracks: int = 2,
              frame_hw=(120, 80), split: str = 'test', masks_dir: Path = None) -> dict:
    """`sequenceFiles/<split>/*.pkl` (latin1 pickles with SMPL-24 world
    joints in metres, per-frame cam_poses, campose_valid, 18-joint poses2d)
    and `imageFiles/<seq>/image_{i:05d}.jpg`; with `masks_dir`, one STCN
    mask pickle per sequence (a list over frames of per-track COCO RLEs)."""
    from metrabs_tpu.utils import rlemask
    h, w = frame_hw
    K = np.array([[150.0, 0, w / 2], [0, 150.0, h / 2], [0, 0, 1]])
    names = []
    for i_seq in range(n_seqs):
        name = f'seq_{i_seq:02d}'
        names.append(name)
        cam_poses = np.tile(np.eye(4), (n_frames, 1, 1))
        cam_poses[:, :3, 3] = rng.normal(0, 0.05, (n_frames, 3))
        joints = [(_look_at_world(rng, n_frames, 24) / 1000).reshape(n_frames, 72)
                  for _ in range(n_tracks)]
        valid = np.ones((n_tracks, n_frames), bool)
        valid[0, 1] = False
        poses2d = [np.concatenate([rng.uniform(5, min(h, w) - 5, (n_frames, 2, 18)),
                                   rng.uniform(0.1, 1, (n_frames, 1, 18))], 1)
                   for _ in range(n_tracks)]
        seq = dict(sequence=name, cam_intrinsics=K, jointPositions=joints,
                   cam_poses=cam_poses, campose_valid=valid, poses2d=poses2d)
        out = root / 'sequenceFiles' / split / f'{name}.pkl'
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(pickle.dumps(seq, protocol=2))
        for i in range(n_frames):
            write_jpeg(root / 'imageFiles' / name / f'image_{i:05d}.jpg', h, w,
                       seed=100 * i_seq + i)
        if masks_dir is not None:
            masks = []
            for i in range(n_frames):
                frame_masks = []
                for t in range(n_tracks):
                    m = np.zeros((h, w), np.uint8)
                    y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
                    m[y0:y0 + h // 2, x0:x0 + w // 3] = 1
                    frame_masks.append(rlemask.encode(m))
                masks.append(frame_masks)
            masks_dir.mkdir(parents=True, exist_ok=True)
            (masks_dir / f'{name}.pkl').write_bytes(pickle.dumps(masks))
    return dict(names=names, n_frames=n_frames, n_tracks=n_tracks)


def mint_mupots(root: Path, rng, sequences=(1, 6), n_frames: int = 4, n_people: int = 2,
                frame_hw=(90, 120), with_frames: bool = True) -> dict:
    """`TS{i}/annot.mat` (annotations[frame, person] structs with annot2,
    annot3, univ_annot3 and isValidFrame; one invalid cell, one without
    annot2, and a single-person sequence that loadmat squeezes),
    `camera_intrinsics.json` and `TS{i}/img_{k:06d}.jpg`."""
    import scipy.io
    h, w = frame_hw
    intrinsics = {}
    for i_seq in sequences:
        people = n_people if i_seq != sequences[-1] else 1  # the squeezed case
        ann = np.empty((n_frames, people), object)
        for f in range(n_frames):
            for p in range(people):
                world = _look_at_world(rng, 1, MUPOTS_JOINTS)[0]
                imcoords = rng.uniform(5, min(h, w) - 5, (MUPOTS_JOINTS, 2))
                cell = dict(annot3=world.T, univ_annot3=world.T * 0.98,
                            annot2=imcoords.T, isValidFrame=1)
                if (f, p) == (1, 0):
                    cell['isValidFrame'] = 0
                if (f, p) == (2, people - 1):
                    del cell['annot2']
                ann[f, p] = cell
        (root / f'TS{i_seq}').mkdir(parents=True, exist_ok=True)
        scipy.io.savemat(str(root / f'TS{i_seq}' / 'annot.mat'), {'annotations': ann})
        intrinsics[f'TS{i_seq}'] = [[160.0, 0, w / 2], [0, 160.0, h / 2], [0, 0, 1]]
        if with_frames:
            for f in range(n_frames):
                write_jpeg(root / f'TS{i_seq}' / f'img_{f:06d}.jpg', h, w, seed=1000 * i_seq + f)
    (root / 'camera_intrinsics.json').write_text(json.dumps(intrinsics))
    return dict(sequences=tuple(sequences), n_frames=n_frames)


def h36m_cameras(rng) -> dict:
    """The community JSON export's layout for S9 and S11."""
    cameras = dict(intrinsics={}, extrinsics={'S9': {}, 'S11': {}})
    for cam_id in H36M_CAMERA_IDS:
        cameras['intrinsics'][cam_id] = dict(
            calibration_matrix=[[150.0, 0, 48.0], [0, 151.0, 52.0], [0, 0, 1]],
            distortion=rng.uniform(-0.01, 0.01, 5).tolist())
        for subject in ('S9', 'S11'):
            angle = rng.uniform(-0.2, 0.2)
            R = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                          [-np.sin(angle), 0, np.cos(angle)]]) @ np.diag([1.0, -1.0, -1.0])
            cameras['extrinsics'][subject][cam_id] = dict(
                R=R.tolist(), t=[rng.uniform(-100, 100), rng.uniform(-100, 100), 4500.0])
    return cameras


def h36m_metadata_xml(path: Path, rng) -> None:
    """A `metadata.xml` with the release's 300-value `<w0>` packing."""
    extr = np.zeros((4, 11, 6))
    extr[..., :3] = rng.uniform(-np.pi, np.pi, (4, 11, 3))
    extr[..., 3:] = rng.uniform(-4000, 4000, (4, 11, 3))
    intr = np.zeros((4, 9))
    intr[:, 0:2] = rng.uniform(1100, 1160, (4, 2))
    intr[:, 2:4] = rng.uniform(500, 520, (4, 2))
    intr[:, 4:7] = rng.uniform(-0.3, 0.3, (4, 3))
    intr[:, 7:9] = rng.uniform(-0.003, 0.003, (4, 2))
    w0 = np.concatenate([extr.reshape(-1), intr.reshape(-1)])
    path.write_text('<metadata><dbcameras><w0>[%s]</w0></dbcameras></metadata>'
                    % ' '.join(f'{v:.10g}' for v in w0))


def mint_h36m(root: Path, rng, subjects=(9,), activities=('Walking', 'Eating 2'),
              n_frames: int = 10, frame_step: int = 4, frame_hw=(100, 96),
              with_frames: bool = True, write_cdf=None) -> dict:
    """`S{i}/MyPoseFeatures/D3_Positions/{act}.cdf` (Pose [1, n, 96], mm),
    `S{i}/BBoxes/{act}.{cam}.npy`, `cameras.json`, `metadata.xml` and the
    frames `S{i}/Images/{act}.{cam}/frame_{k:06d}.jpg` of every
    `frame_step`-th k. `write_cdf` is a CDF writer (default: the JAX
    package's)."""
    if write_cdf is None:
        from metrabs_tpu.utils.cdf import write_cdf
    h, w = frame_hw
    cam_json = root / 'cameras.json'
    root.mkdir(parents=True, exist_ok=True)
    cam_json.write_text(json.dumps(h36m_cameras(rng)))
    h36m_metadata_xml(root / 'metadata.xml', rng)
    for subject in subjects:
        base = root / f'S{subject}'
        (base / 'MyPoseFeatures' / 'D3_Positions').mkdir(parents=True, exist_ok=True)
        (base / 'BBoxes').mkdir(parents=True, exist_ok=True)
        for act in activities:
            pose = (rng.normal(0, 200, (1, n_frames, 96)) + np.tile([0, 0, 1000.0], 32))
            write_cdf(str(base / 'MyPoseFeatures' / 'D3_Positions' / f'{act}.cdf'),
                      {'Pose': pose})
            for cam_id in H36M_CAMERA_IDS:
                boxes = np.stack([rng.uniform(0, w / 3, n_frames), rng.uniform(0, h / 3, n_frames),
                                  rng.uniform(w / 3, w / 2, n_frames),
                                  rng.uniform(h / 3, h / 2, n_frames)], -1)
                np.save(base / 'BBoxes' / f'{act}.{cam_id}.npy', boxes.astype(np.float32))
                if with_frames:
                    for k in range(0, n_frames, frame_step):
                        write_jpeg(base / 'Images' / f'{act}.{cam_id}' / f'frame_{k:06d}.jpg',
                                   h, w, seed=subject * 7919 + k + int(cam_id) % 1000)
    return dict(cameras_json=str(cam_json), metadata_xml=str(root / 'metadata.xml'))


def mint_3doh(root: Path, rng, n: int = 4, frame_hw=(80, 110)) -> None:
    """`testset/annots.json` (intri, extri as 4x4 and 3x4, bbox corners, and
    each of the three joint keys and none) and `testset/images/{id}.jpg`,
    the last image another size than the others."""
    annots = {}
    for i in range(n):
        h, w = frame_hw if i < n - 1 else (frame_hw[0] + 10, frame_hw[1] - 6)
        image_id = f'{i:05d}'
        ext = np.eye(4)
        ext[:3, 3] = rng.normal(0, 50, 3)
        anno = dict(intri=[[140.0, 0, w / 2], [0, 140.0, h / 2], [0, 0, 1]],
                    bbox=[[5, 6], [5 + w / 2, 6 + h / 2]])
        if i % 2:
            anno['extri'] = ext[:3].tolist()
        else:
            anno['extri'] = ext.tolist()
        key = ('lsp_joints_3d', 'joints_3d', 'smpl_joints_3d', None)[i % 4]
        if key:
            anno[key] = (_look_at_world(rng, 1, 14)[0] / 1000).tolist()
        annots[image_id] = anno
        write_jpeg(root / 'testset' / 'images' / f'{image_id}.jpg', h, w, seed=5000 + i)
    (root / 'testset' / 'annots.json').write_text(json.dumps(annots))


def mint_aspset(root: Path, rng, split: str = 'test') -> None:
    """`splits.csv`, per-clip box CSVs (with a header row) and per-camera
    JSONs of ASPset-510; the videos are never opened by the adapter."""
    rows = [('01', '0001', 'left', split), ('01', '0001', 'mid', split),
            ('02', '0003', 'right', 'train'), ('03', '0004', 'mid', split)]
    (root).mkdir(parents=True, exist_ok=True)
    (root / 'splits.csv').write_text('\n'.join(','.join(r) for r in rows) + '\n')
    for subj, vid, view, s in rows[:2]:
        box_dir = root / s / 'boxes' / subj
        box_dir.mkdir(parents=True, exist_ok=True)
        lines = ['x1,y1,x2,y2'] + [','.join(f'{v:.3f}' for v in
                                           (rng.uniform(0, 100, 2).tolist()
                                            + rng.uniform(200, 400, 2).tolist()))
                                  for _ in range(5)]
        (box_dir / f'{subj}-{vid}-{view}.csv').write_text('\n'.join(lines) + '\n')
        cam_dir = root / s / 'cameras' / subj
        cam_dir.mkdir(parents=True, exist_ok=True)
        cam = dict(intrinsic_matrix=[[900.0, 0, 960, 0], [0, 900.0, 540, 0], [0, 0, 1, 0]])
        if view == 'mid':
            cam['extrinsic_matrix'] = np.eye(4)[:3].tolist()
        (cam_dir / f'{subj}-{view}.json').write_text(json.dumps(cam))


def mint_npz(path: Path, rng, n: int = 5, with_extrinsics=True, with_bbox=True) -> None:
    data = dict(image_path=np.array([f'img/{i:04d}.jpg' for i in range(n)]),
                world_coords=_look_at_world(rng, n, 17).astype(np.float32),
                intrinsics=np.tile(np.float32([[500, 0, 320], [0, 500, 240], [0, 0, 1]]),
                                   (n, 1, 1)))
    data['world_coords'][1] = np.nan  # no finite joint: skipped without boxes
    if with_extrinsics:
        ext = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        ext[:, :3, 3] = rng.normal(0, 30, (n, 3))
        data['extrinsics'] = ext
    if with_bbox:
        data['bbox'] = rng.uniform(10, 200, (n, 4)).astype(np.float32)
    np.savez(path, **data)


SKELETON_JOINTS = {'': 17, 'h36m_17': 17, 'h36m_25': 25, 'smpl_24': 24, 'lsp_14': 14,
                   'mpi_inf_3dhp_17': 17}


class StubEstimator:
    """An estimator for both packages' drivers: records each call as
    (method, images, keyword arguments) and returns poses computed from the
    images, the boxes and the arguments."""

    def __init__(self, skeleton_names=tuple(SKELETON_JOINTS)):
        self.skeletons = types.SimpleNamespace(skeleton_names=skeleton_names)
        self.calls = []

    @staticmethod
    def _features(images):
        return images.reshape(len(images), -1, 3).astype(np.float64).mean(1)  # [B, 3]

    def estimate_poses_batched(self, images, boxes, **kwargs):
        images, boxes = np.asarray(images), np.asarray(boxes, np.float64)
        self.calls.append(('estimate', images.copy(), dict(kwargs, boxes=boxes.copy())))
        n_joints = SKELETON_JOINTS[kwargs.get('skeleton', '')]
        joint = np.arange(n_joints)[:, None] * [1.0, 2.0, 3.0]
        poses = (10 * self._features(images)[:, None, None] + boxes[..., None, :3] + joint
                 + np.asarray(kwargs['intrinsic_matrix'])[:, None, None, 0, :]
                 + [0, 0, 3000.0])
        return dict(poses3d=poses.astype(np.float32),
                    valid=np.ones(boxes.shape[:2], bool))

    def detect_poses_batched(self, images, **kwargs):
        images = np.asarray(images)
        self.calls.append(('detect', images.copy(), dict(kwargs)))
        n_joints = SKELETON_JOINTS[kwargs.get('skeleton', '')]
        b, h, w = images.shape[:3]
        d = kwargs['max_detections']
        feat = self._features(images)
        n_valid = 1 + (np.floor(feat.sum(1)).astype(int) % min(d, 3))
        valid = np.arange(d)[None] < n_valid[:, None]
        frac = (feat[:, None, None, :2] / 255 + np.arange(d)[None, :, None, None] * 0.13
                + np.arange(n_joints)[None, None, :, None] * [0.031, 0.017]) % 1
        poses2d = 4 + frac * [w - 8, h - 8]
        poses3d = np.concatenate([poses2d * 3, 4000 + 50 * frac[..., :1]], -1)
        return dict(poses3d=poses3d.astype(np.float32), poses2d=poses2d.astype(np.float32),
                    boxes=np.zeros((b, d, 5), np.float32), valid=valid)


def tdhp_cameras(scale: float = 1.0) -> dict:
    """MPI-INF-3DHP's test cameras as `load_3dhp_test_frames` reads them, for
    frames scaled by `scale`: TS1-4 (2048x2048) without distortion, TS5-6
    (1920x1080) with 12 distortion coefficients, extrinsics identity (3x4)."""
    k14 = np.array([[1497.7, 0, 1024.1], [0, 1497.6, 1051.1], [0, 0, 1]])
    k56 = np.array([[1684.0, 0, 939.9], [0, 1672.6, 560.4], [0, 0, 1]])
    s = np.diag([scale, scale, 1.0])
    return {'subj1_4': dict(intrinsic_matrix=(s @ k14).tolist()),
            'subj5_6': dict(intrinsic_matrix=(s @ k56).tolist(),
                            extrinsic_matrix=np.eye(4)[:3].tolist(),
                            distortion=[-0.12, 0.05, 0.001, -0.0005, -0.01, 0.002, 0.0, 0.0,
                                        0.0005, 0.0, -0.0003, 0.0])}


def mint_3dhp(root: Path, sequences: dict, frame_hw: dict, scale: float, seed: int = 0,
              libver: str = 'earliest', track_order: bool = False) -> str:
    """TS{n}/annot_data.mat in MATLAB's layout (h5py under `libver`, with
    `track_order`; tests/_torch_hdf5_fixtures.py) and TS{n}/imageSequence/
    img_%06d.jpg for `sequences` {n: (frames, invalid frames)}, frames of
    `frame_hw[n]`; returns the cameras JSON's path."""
    import _torch_hdf5_fixtures as hdf5_fixtures
    for subj, (n_frames, invalid) in sequences.items():
        seq = root / f'TS{subj}'
        (seq / 'imageSequence').mkdir(parents=True)
        arrays = hdf5_fixtures.matlab_annotations(n_frames, invalid, seed=seed + subj)
        hdf5_fixtures.write_matlab_h5py(seq / 'annot_data.mat', arrays, libver=libver,
                                        track_order=track_order)
        for i in range(n_frames):
            write_jpeg(seq / 'imageSequence' / f'img_{i + 1:06d}.jpg', *frame_hw[subj],
                       seed=seed + 100 * subj + i)
    (root / 'cameras.json').write_text(json.dumps(tdhp_cameras(scale)))
    return str(root / 'cameras.json')
