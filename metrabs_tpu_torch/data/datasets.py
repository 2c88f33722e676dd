"""Dataset adapters (`metrabs_tpu/data/datasets.py`): benchmark annotation
formats -> lists of `Example3D`, for `eval/harness.predict_dataset`, the
prediction drivers and the training loaders.

A copy of the JAX package's adapters with the port's classes: 3DPW sequence
pickles, MuPoTS `annot.mat` (scipy.io), the generic NPZ layout, Human3.6M
(CDF poses through `utils/cdf.py`, cameras from the community JSON export or
the release's `metadata.xml`), 3DOH50K's JSON and ASPset-510's CSV/JSON
(`#frame=N` paths into its videos, which `imread` refuses until a video
decoder is ported). MPI-INF-3DHP's `annot_data.mat` is MATLAB v7.3, that
is HDF5, and the card's machine has no HDF5 reader: `load_3dhp_test_frames`
parses its cameras and raises where it would open that file (ROADMAP.md).
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Iterator, List, Optional, Sequence

import numpy as np

from metrabs_tpu_torch.data.camera import Camera
from metrabs_tpu_torch.data.loading import Example3D
from metrabs_tpu_torch.utils import matlabfile


def boxes_from_joints(imcoords: np.ndarray, margin: float = 0.1) -> np.ndarray:
    """Margin-padded bounding box of the finite joints; the all-invalid case
    returns the degenerate zero box (loaders skip such examples) instead of
    crashing on an empty reduction."""
    valid = ~np.any(np.isnan(imcoords), axis=-1)
    pts = imcoords[valid]
    if pts.shape[0] == 0:
        return np.zeros(4, np.float32)
    x0, y0 = pts.min(0)
    x1, y1 = pts.max(0)
    w, h = x1 - x0, y1 - y0
    m = margin * max(w, h)
    return np.array([x0 - m, y0 - m, w + 2 * m, h + 2 * m], np.float32)


def load_3dpw_examples(
        root: str, split: str = 'test',
        image_subdir: str = 'imageFiles') -> List[Example3D]:
    """3DPW sequence pickles (`sequenceFiles/<split>/*.pkl`): SMPL 24-joint
    world positions in meters, per-frame extrinsics, shared intrinsics."""
    examples = []
    for path in sorted(glob.glob(os.path.join(root, 'sequenceFiles', split, '*.pkl'))):
        with open(path, 'rb') as f:
            seq = pickle.load(f, encoding='latin1')
        seq_name = seq['sequence']
        K = np.asarray(seq['cam_intrinsics'], np.float32)
        jp = [np.asarray(j).reshape(-1, 24, 3) * 1000.0
              for j in seq['jointPositions']]  # per track: [n_frames, 24, 3] mm
        cam_poses = np.asarray(seq['cam_poses'], np.float32)  # [n_frames, 4, 4]
        valid = np.asarray(seq['campose_valid'])
        for i_frame in range(cam_poses.shape[0]):
            ext = cam_poses[i_frame].copy()
            ext[:3, 3] *= 1000.0  # meters -> millimeters
            cam = Camera(extrinsic_matrix=ext, intrinsic_matrix=K,
                         world_up=(0, 1, 0))
            img_path = os.path.join(
                root, image_subdir, seq_name, f'image_{i_frame:05d}.jpg')
            for i_track, track in enumerate(jp):
                if i_frame >= len(track):
                    continue
                if valid.ndim == 2 and not valid[i_track, i_frame]:
                    continue
                world = track[i_frame]
                imcoords = cam.world_to_image(world)
                # Skip when NO joint is fully finite (a pose where every
                # joint has some NaN coordinate would produce an empty/
                # degenerate box).
                if not np.any(np.all(np.isfinite(imcoords), axis=-1)):
                    continue
                examples.append(Example3D(
                    image_path=img_path, camera=cam,
                    bbox=boxes_from_joints(imcoords), world_coords=world))
    return examples


def load_mupots_annotations(root: str, sequences=None) -> Iterator:
    """Yields (i_seq, annotations[F, P] object array of per-person dicts)
    for each sequence whose `TS{n}/annot.mat` exists — the single parsing
    point shared by the example adapter and the evaluation CLI.

    loadmat's squeeze_me collapses size-1 axes: a 0-d result is one frame of
    one person, a 1-D result is interpreted frame-axis-first ([F] -> [F, 1],
    the single-person long-sequence case; real MuPoTS sequences have
    hundreds of frames, so a squeezed [1, P] cannot be distinguished but
    does not occur)."""
    for i_seq in (range(1, 21) if sequences is None else sequences):
        annot_path = os.path.join(root, f'TS{i_seq}', 'annot.mat')
        if not os.path.exists(annot_path):
            continue
        annotations = matlabfile.load(annot_path)['annotations']
        if not isinstance(annotations, np.ndarray):
            arr = np.empty((1, 1), object)
            arr[0, 0] = annotations
            annotations = arr
        elif annotations.ndim == 0:
            arr = np.empty((1, 1), object)
            arr[0, 0] = annotations.item()
            annotations = arr
        elif annotations.ndim == 1:
            annotations = annotations[:, None]
        yield i_seq, annotations


def parse_mupots_person(ann):
    """Single MuPoTS annot[frame][person] cell -> (camcoords [J,3] mm,
    imcoords [J,2] px or None) or None when absent/invalid. THE parsing
    point for the per-person validity semantics — the predict and eval
    sides must agree on it (`isValidFrame` gate, [3,J]->[J,3] transpose).
    imcoords is None when the cell has no annot2 (the eval side only needs
    annot3)."""
    if not isinstance(ann, dict):
        return None
    if not np.all(ann.get('isValidFrame', 1)):
        return None
    camcoords = np.asarray(ann['annot3'], np.float32).T
    imcoords = (np.asarray(ann['annot2'], np.float32).T
                if 'annot2' in ann else None)
    return camcoords, imcoords


def load_mupots_examples(root: str) -> List[Example3D]:
    """MuPoTS-3D: per-sequence `annot.mat` with annot[frame][person]
    (annot3/univ_annot3 in mm camera space, annot2 pixels, isValidFrame)."""
    examples = []
    for i_seq, annotations in load_mupots_annotations(root):
        seq_dir = os.path.join(root, f'TS{i_seq}')
        # MuPoTS test intrinsics (published camera calibrations).
        K = np.array([[1500.9799, 0, 1024.704],
                      [0, 1500.9633, 1051.3849], [0, 0, 1]], np.float32) \
            if i_seq <= 5 else \
            np.array([[1683.9846, 0, 939.6174],
                      [0, 1672.9968, 560.2072], [0, 0, 1]], np.float32)
        cam = Camera(intrinsic_matrix=K, world_up=(0, -1, 0))
        n_frames, n_people = annotations.shape
        for i_frame in range(n_frames):
            img_path = os.path.join(seq_dir, f'img_{i_frame:06d}.jpg')
            for i_person in range(n_people):
                parsed = parse_mupots_person(annotations[i_frame, i_person])
                if parsed is None or parsed[1] is None:
                    continue  # the example needs annot2 for its box
                camcoords, imcoords = parsed
                examples.append(Example3D(
                    image_path=img_path, camera=cam,
                    bbox=boxes_from_joints(imcoords),
                    world_coords=camcoords))  # camera frame == world here
    return examples


def load_npz_examples(path: str, image_root: str = '') -> List[Example3D]:
    """Generic preprocessed NPZ: arrays image_path [N], world_coords [N,J,3]
    (mm), intrinsics [N,3,3], extrinsics [N,4,4] (optional), bbox [N,4]
    (optional) — the common interchange format for H36M/3DHP preprocessed
    annotations."""
    data = np.load(path, allow_pickle=True)
    n = len(data['image_path'])
    exts = data['extrinsics'] if 'extrinsics' in data else None
    bboxes = data['bbox'] if 'bbox' in data else None
    examples = []
    for i in range(n):
        cam = Camera(
            intrinsic_matrix=np.asarray(data['intrinsics'][i], np.float32),
            extrinsic_matrix=(np.asarray(exts[i], np.float32)
                              if exts is not None else None),
            world_up=(0, -1, 0))
        world = np.asarray(data['world_coords'][i], np.float32)
        bbox = (np.asarray(bboxes[i], np.float32) if bboxes is not None
                else boxes_from_joints(cam.world_to_image(world)))
        if bboxes is None and bbox[2] <= 0:
            continue  # no finite joint -> degenerate box -> unusable example
        examples.append(Example3D(
            image_path=os.path.join(image_root, str(data['image_path'][i])),
            camera=cam, bbox=bbox, world_coords=world))
    return examples


def load_h36m_cameras(path: str):
    """Human3.6M camera parameters from the widely-shared JSON layout
    ({"intrinsics": {cam_id: {"calibration_matrix", "distortion"}},
      "extrinsics": {subject: {cam_id: {"R", "t"}}}}; t in mm).

    The reference derives the same parameters from `metadata.xml` via
    posepile (`predict_h36m.py:103-105`); the JSON is a one-time export of
    that data and avoids guessing the xml's undocumented packing.
    """
    import json
    with open(path) as f:
        raw = json.load(f)
    cameras = {}
    for subject, cams in raw['extrinsics'].items():
        for cam_id, ext in cams.items():
            intr = raw['intrinsics'][cam_id]
            R = np.asarray(ext['R'], np.float32)
            t = np.asarray(ext['t'], np.float32).reshape(3)
            extrinsic = np.eye(4, dtype=np.float32)
            extrinsic[:3, :3] = R
            extrinsic[:3, 3] = t
            cameras[(subject, cam_id)] = Camera(
                extrinsic_matrix=extrinsic,
                intrinsic_matrix=np.asarray(
                    intr['calibration_matrix'], np.float32),
                distortion_coeffs=np.asarray(
                    intr.get('distortion', []), np.float32),
                world_up=(0, 0, 1))
    return cameras


H36M_METADATA_SUBJECTS = tuple(f'S{i}' for i in range(1, 12))  # S1..S11


def h36m_rotation_from_angles(angles: np.ndarray) -> np.ndarray:
    """Euler angles (radians) -> rotation matrix, official H36M composition
    (the release's `rotationMatrix.m`: R = Rx(a1) @ Ry(a2) @ Rz(a3))."""
    a1, a2, a3 = (float(a) for a in angles)
    c1, s1 = np.cos(a1), np.sin(a1)
    c2, s2 = np.cos(a2), np.sin(a2)
    c3, s3 = np.cos(a3), np.sin(a3)
    rx = np.array([[1, 0, 0], [0, c1, -s1], [0, s1, c1]], np.float64)
    ry = np.array([[c2, 0, s2], [0, 1, 0], [-s2, 0, c2]], np.float64)
    rz = np.array([[c3, -s3, 0], [s3, c3, 0], [0, 0, 1]], np.float64)
    return (rx @ ry @ rz).astype(np.float32)


def load_h36m_metadata_xml(path: str):
    """Human3.6M camera parameters straight from the official release's
    `metadata.xml` (the reference gets them via posepile,
    `predict_h36m.py:103-105`).

    The `<w0>` element is a 300-float vector: 264 extrinsic values packed
    camera-major as [4 cameras][11 subjects][rx ry rz tx ty tz] followed by
    36 intrinsic values as [4 cameras][fx fy cx cy k1 k2 k3 p1 p2] (the
    official Matlab `H36MCamera` layout; 264 = 4*11*6, 36 = 4*9). T is the
    camera center in world mm; the returned extrinsics use x_cam = R @ x + t
    with t = -R @ T. The Euler composition constant (Rx@Ry@Rz) cannot be
    unit-tested without real data — when a community JSON export is also on
    disk, run `validate_h36m_metadata_against_json` once to confirm parity.

    Returns {(subject, camera_id): Camera} like `load_h36m_cameras`.
    """
    import xml.etree.ElementTree as ET
    root = ET.parse(path).getroot()
    w0_text = root.find('.//w0').text.strip()
    if w0_text.startswith('['):
        w0_text = w0_text[1:-1]
    w0 = np.array([float(x) for x in w0_text.split()], np.float64)
    if w0.size != 300:
        raise ValueError(f'Expected 300 w0 values in {path}, got {w0.size}')
    n_sub = len(H36M_METADATA_SUBJECTS)
    extr = w0[:264].reshape(4, n_sub, 6)
    intr = w0[264:].reshape(4, 9)
    cameras = {}
    for i_cam, cam_id in enumerate(H36M_CAMERA_IDS):
        fx, fy, cx, cy, k1, k2, k3, p1, p2 = intr[i_cam]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        dist = np.array([k1, k2, p1, p2, k3], np.float32)  # OpenCV order
        for i_sub, subject in enumerate(H36M_METADATA_SUBJECTS):
            R = h36m_rotation_from_angles(extr[i_cam, i_sub, :3])
            T = extr[i_cam, i_sub, 3:6]  # camera center, world mm
            extrinsic = np.eye(4, dtype=np.float32)
            extrinsic[:3, :3] = R
            extrinsic[:3, 3] = (-R @ T).astype(np.float32)
            cameras[(subject, cam_id)] = Camera(
                extrinsic_matrix=extrinsic, intrinsic_matrix=K,
                distortion_coeffs=dist, world_up=(0, 0, 1))
    return cameras


def validate_h36m_metadata_against_json(xml_path: str, json_path: str,
                                        atol_deg: float = 0.1) -> None:
    """Asserts the xml parse agrees with the community JSON export for every
    (subject, camera) with data — catches a wrong Euler/packing convention
    loudly instead of silently producing bad world coordinates."""
    from_xml = load_h36m_metadata_xml(xml_path)
    from_json = load_h36m_cameras(json_path)
    for key, cam_j in from_json.items():
        cam_x = from_xml[key]
        r_rel = cam_x.extrinsic_matrix[:3, :3] @ cam_j.extrinsic_matrix[:3, :3].T
        angle = np.degrees(np.arccos(np.clip((np.trace(r_rel) - 1) / 2, -1, 1)))
        assert angle < atol_deg, f'{key}: rotation differs by {angle:.3f} deg'
        np.testing.assert_allclose(
            cam_x.extrinsic_matrix[:3, 3], cam_j.extrinsic_matrix[:3, 3],
            atol=5.0, err_msg=str(key))
        np.testing.assert_allclose(
            cam_x.intrinsic_matrix, cam_j.intrinsic_matrix, atol=0.5,
            err_msg=str(key))


H36M_CAMERA_IDS = ('54138969', '55011271', '58860488', '60457274')
# H36M 32-joint raw annotation -> the 17 evaluation joints, in the order the
# reference uses (`predict_h36m.py:112`).
H36M_RELEVANT_JOINTS = (1, 2, 3, 6, 7, 8, 12, 13, 14, 15, 17, 18, 19, 25,
                        26, 27, 0)


def load_h36m_examples(
        root: str, cameras_json: str, subjects: Sequence[int] = (9, 11),
        frame_step: int = 64, n_joints: int = 17) -> List[Example3D]:
    """Human3.6M per-sequence protocol (`predict_h36m.py:102-125`): world
    coords from the `D3_Positions/*.cdf` annotations (read with the
    first-party CDF parser), every `frame_step`-th frame, the published
    `BBoxes/*.npy` person boxes, all 4 cameras.

    `cameras_json` accepts either the community JSON export or the official
    release's `metadata.xml` (dispatch by extension).

    Directory layout: `<root>/S{i}/MyPoseFeatures/D3_Positions/{act}.cdf`,
    `<root>/S{i}/BBoxes/{act}.{cam}.npy`,
    `<root>/S{i}/Images/{act}.{cam}/frame_{k:06d}.jpg`.
    """
    from metrabs_tpu_torch.utils import cdf as cdf_mod
    assert n_joints == 17, 'only the 17-joint protocol subset is built in'
    if cameras_json.endswith('.xml'):
        cameras = load_h36m_metadata_xml(cameras_json)
    else:
        cameras = load_h36m_cameras(cameras_json)
    examples = []
    for i_subject in subjects:
        coord_dir = os.path.join(
            root, f'S{i_subject}', 'MyPoseFeatures', 'D3_Positions')
        for coord_path in sorted(glob.glob(os.path.join(coord_dir, '*.cdf'))):
            activity = os.path.splitext(os.path.basename(coord_path))[0]
            raw = cdf_mod.load_cdf(coord_path)['Pose'][0].astype(np.float32)
            n_total = raw.shape[0]
            world_all = raw.reshape(n_total, -1, 3)[
                ::frame_step, H36M_RELEVANT_JOINTS]
            for i_cam, cam_id in enumerate(H36M_CAMERA_IDS):
                cam = cameras[(f'S{i_subject}', cam_id)]
                bbox_path = os.path.join(
                    root, f'S{i_subject}', 'BBoxes',
                    f'{activity}.{cam_id}.npy')
                bboxes = np.load(bbox_path)[::frame_step]
                img_dir = os.path.join(
                    root, f'S{i_subject}', 'Images', f'{activity}.{cam_id}')
                for i_out, i_frame in enumerate(
                        range(0, n_total, frame_step)):
                    examples.append(Example3D(
                        image_path=os.path.join(
                            img_dir, f'frame_{i_frame:06d}.jpg'),
                        camera=cam,
                        bbox=np.asarray(bboxes[i_out], np.float32),
                        world_coords=world_all[i_out]))
    return examples


def load_3doh_examples(root: str) -> List[Example3D]:
    """3DOH50K test set (`predict_tdoh.py:42-56`): `testset/annots.json`
    with per-image `intri` (3x3), `extri`, `bbox` ((x1,y1),(x2,y2)) and
    `lsp_joints_3d` (14, meters, world)."""
    import json
    with open(os.path.join(root, 'testset', 'annots.json')) as f:
        annotations = json.load(f)
    examples = []
    for image_id, anno in annotations.items():
        K = np.asarray(anno['intri'], np.float32)
        extrinsic = np.eye(4, dtype=np.float32)
        if 'extri' in anno:
            extrinsic = np.asarray(anno['extri'], np.float32)
            if extrinsic.shape == (3, 4):
                extrinsic = np.concatenate(
                    [extrinsic, [[0, 0, 0, 1]]], axis=0).astype(np.float32)
        (x1, y1), (x2, y2) = anno['bbox']
        bbox = np.array([x1, y1, x2 - x1, y2 - y1], np.float32)
        joints_key = next(
            (k for k in ('lsp_joints_3d', 'joints_3d', 'smpl_joints_3d')
             if k in anno), None)
        world = (np.asarray(anno[joints_key], np.float32) * 1000.0
                 if joints_key else
                 np.full((14, 3), np.nan, np.float32))
        cam = Camera(extrinsic_matrix=extrinsic, intrinsic_matrix=K)
        examples.append(Example3D(
            image_path=os.path.join(root, 'testset', 'images',
                                    f'{image_id}.jpg'),
            camera=cam, bbox=bbox, world_coords=world))
    return examples


def load_aspset_examples(
        root: str, split: str = 'test',
        frame_step: int = 1) -> List[Example3D]:
    """ASPset-510 (`predict_aspset.py:44-60`): per-sequence box CSVs, camera
    JSONs and .mkv videos; ground-truth 3D (when present, train/val splits)
    comes from posekit .c3d files, which the evaluation loads separately —
    the examples here carry boxes and cameras for prediction.

    The examples' image paths name video frames (`<video>.mkv#frame=N`),
    which `imread` refuses until a video decoder is ported (ROADMAP.md).
    """
    import csv
    import json
    split_rows = []
    with open(os.path.join(root, 'splits.csv')) as f:
        for row in csv.reader(f):
            if row and row[-1].strip() == split:
                split_rows.append([c.strip() for c in row[:-1]])

    examples = []
    for subj_id, vid_id, view in split_rows:
        box_path = os.path.join(
            root, split, 'boxes', subj_id, f'{subj_id}-{vid_id}-{view}.csv')
        cam_path = os.path.join(
            root, split, 'cameras', subj_id, f'{subj_id}-{view}.json')
        video_path = os.path.join(
            root, split, 'videos', subj_id, f'{subj_id}-{vid_id}-{view}.mkv')
        if not (os.path.exists(box_path) and os.path.exists(cam_path)):
            continue
        with open(cam_path) as f:
            cam_data = json.load(f)
        K = np.asarray(cam_data['intrinsic_matrix'], np.float32)[:3, :3]
        extrinsic = np.asarray(
            cam_data.get('extrinsic_matrix', np.eye(4)), np.float32)
        if extrinsic.shape == (3, 4):
            extrinsic = np.concatenate(
                [extrinsic, [[0, 0, 0, 1]]], 0).astype(np.float32)
        cam = Camera(extrinsic_matrix=extrinsic, intrinsic_matrix=K,
                     world_up=(0, -1, 0))
        boxes = []
        with open(box_path) as f:
            for row in csv.reader(f):
                try:
                    boxes.append([float(x) for x in row[:4]])
                except ValueError:
                    continue  # header
        for i_frame in range(0, len(boxes), frame_step):
            x1, y1, x2, y2 = boxes[i_frame]
            examples.append(Example3D(
                image_path=f'{video_path}#frame={i_frame}',
                camera=cam,
                bbox=np.array([x1, y1, x2 - x1, y2 - y1], np.float32),
                world_coords=np.full((17, 3), np.nan, np.float32)))
    return examples


def load_3dhp_test_frames(root: str, camera_json: str):
    """MPI-INF-3DHP test set (`predict_tdhp.py:52-67`): per-sequence valid
    frames from `TS{n}/annot_data.mat` (MATLAB v7.3 = HDF5) plus the test
    cameras from a JSON ({"subj1_4": {"intrinsic_matrix", "extrinsic_matrix",
    "distortion"?}, "subj5_6": {...}} — the posepile
    get_test_camera_subj1_4/5_6 constants exported once).

    In the port: raises NotImplementedError for the first sequence whose
    `annot_data.mat` exists (no HDF5 reader on the card's machine); returns
    [] when there is none, as JAX does.

    Returns [(sequence_name, frame_paths, camera)] — the 3DHP protocol runs
    the DETECTOR (max_detections=1), so there are no ground-truth boxes and
    the output of this adapter feeds apps/predict_3dhp rather than Example3D
    lists. Ground truth for evaluation lives in the same annot_data.mat
    (annot3/univ_annot3) and is read by the eval side separately.
    """
    import json

    with open(camera_json) as f:
        cams = json.load(f)

    def make_cam(d):
        ext = np.asarray(d.get('extrinsic_matrix', np.eye(4)), np.float32)
        if ext.shape == (3, 4):
            ext = np.concatenate([ext, [[0, 0, 0, 1]]], 0).astype(np.float32)
        return Camera(
            extrinsic_matrix=ext,
            intrinsic_matrix=np.asarray(d['intrinsic_matrix'], np.float32),
            distortion_coeffs=np.asarray(d.get('distortion', []), np.float32)
            if d.get('distortion') else None,
            world_up=(0, 1, 0))

    make_cam(cams['subj1_4'])  # parsed (and checked) as JAX parses them
    make_cam(cams['subj5_6'])
    for subj in range(1, 7):
        annot_path = os.path.join(root, f'TS{subj}', 'annot_data.mat')
        if not os.path.exists(annot_path):
            continue
        raise NotImplementedError(
            f'{annot_path}: MATLAB v7.3 (HDF5) files cannot be read yet: the port has no '
            f'HDF5 reader (ROADMAP.md, "HDF5 reader"), so MPI-INF-3DHP is not ported')
    return []
