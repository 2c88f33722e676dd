"""Benchmark evaluation (`metrabs_tpu/eval/harness.py`): `predict_dataset`,
which runs a crop model over a test set's examples to make a prediction
dump, the per-benchmark protocols (3DPW's 14 joints with PCK at 50 mm, H36M,
3DHP, MuPoTS, 3DOH, ASPset), `evaluate_predictions` over a dump, the NPZ
dump writer (HDF5 dumps raise: no h5py on the card's machine), and the
matched multi-person metrics of the MuPoTS protocol.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from metrabs_tpu_torch.config import ModelConfig
from metrabs_tpu_torch.data.loading import Example3D, LoadConfig, load_and_transform3d
from metrabs_tpu_torch.data.pipeline import ParallelBatchLoader
from metrabs_tpu_torch.eval import metrics as metrics_mod
from metrabs_tpu_torch.pipeline.estimator import checked_device
from metrabs_tpu_torch.utils.joint_info import JointInfo


def predict_dataset(
        crop_model_fn: Callable, examples: Sequence[Example3D],
        joint_info: JointInfo, cfg: ModelConfig, *, batch_size: int = 64,
        n_workers: int = 8, test_time_mirror_aug: bool = False,
        lcfg: Optional[LoadConfig] = None, device='cuda') -> Dict[str, np.ndarray]:
    """Runs the crop model over a test set; returns stacked predictions in the
    original camera and world frames (`poses3d_pred_cam`,
    `poses3d_pred_world`, `poses3d_true_cam`, `joint_validity_mask`, numpy).

    `crop_model_fn(crops [N, S, S, 3] in cfg.dtype, intrinsics [N, 3, 3],
    valid [N]) -> [N, J, 3]` runs on `device` (a Metrabs or Model25D module
    is such a function), under `torch.inference_mode`. Every batch has
    `min(batch_size, len(examples))` rows: the last one is padded with
    invalid rows (zero images, identity intrinsics), as in JAX. With
    `test_time_mirror_aug` the mirrored crops' poses are mirrored back (x
    negated, left and right swapped) and averaged in. `lcfg` defaults to no
    augmentation at all. Raises without CUDA unless another device is
    named."""
    device = checked_device(device)
    lcfg = lcfg or LoadConfig(
        geom_aug=False, occlude_aug_prob=0, color_aug=False,
        background_aug_prob=0, partial_visibility_prob=0)

    def load_fn(ex, rng):
        return load_and_transform3d(ex, joint_info, False, rng, cfg, lcfg)

    n_total = len(examples)
    if n_total == 0:
        raise ValueError('predict_dataset called with an empty example list '
                         '(did the dataset adapter match any files?)')
    full_bs = min(batch_size, n_total)
    loader = ParallelBatchLoader(load_fn, iter(list(examples)), batch_size=full_bs,
                                 n_workers=n_workers)
    mirror = torch.as_tensor(joint_info.mirror_mapping, device=device)
    flip_x = torch.tensor([-1.0, 1.0, 1.0], device=device)
    dtype = getattr(torch, cfg.dtype)

    def predict_batch(images, intrinsics, valid):
        crops = images.to(dtype)
        poses = crop_model_fn(crops, intrinsics, valid).float()
        if test_time_mirror_aug:
            flipped = crop_model_fn(crops.flip(2), intrinsics, valid).float()
            poses = (poses + (flipped * flip_x)[:, mirror]) / 2
        return poses

    all_preds_cam, all_true_cam, all_valid, all_preds_world = [], [], [], []
    n_done = 0
    try:
        for batch in loader:
            if n_done >= n_total:
                break
            n = len(batch['image'])
            take = min(n, n_total - n_done)
            images = torch.zeros((full_bs,) + batch['image'].shape[1:])
            images[:n] = torch.from_numpy(batch['image'])
            intrinsics = torch.eye(3).repeat(full_bs, 1, 1)
            intrinsics[:n] = torch.from_numpy(batch['intrinsics'])
            valid = torch.arange(full_bs) < n
            with torch.inference_mode():
                poses = predict_batch(images.to(device), intrinsics.to(device),
                                      valid.to(device)).cpu().numpy()
            for i in range(take):
                # Crop camera -> original camera / world (`main.py:496-507`).
                rot_oc = batch['rot_to_orig_cam'][i]
                all_preds_cam.append(poses[i] @ rot_oc.T)
                all_preds_world.append(poses[i] @ batch['rot_to_world'][i].T
                                       + batch['cam_loc'][i])
                all_true_cam.append(batch['coords3d_true'][i] @ rot_oc.T)
                all_valid.append(batch['joint_validity_mask'][i])
            n_done += take
    finally:
        loader.close()
    return dict(
        poses3d_pred_cam=np.stack(all_preds_cam),
        poses3d_pred_world=np.stack(all_preds_world),
        poses3d_true_cam=np.stack(all_true_cam),
        joint_validity_mask=np.stack(all_valid))


@dataclasses.dataclass(frozen=True)
class EvalProtocol:
    """Per-benchmark evaluation configuration. `joint_subset` names a
    JOINT_SUBSETS entry the metrics are restricted to (None = all joints)."""
    name: str
    pck_threshold_mm: float = 150.0
    joint_subset: Optional[str] = None


# Evaluation joint subsets (indices into the h36m_17 joints): the 3DPW
# protocol's 14 LSP-like joints (limbs, neck and head).
JOINT_SUBSETS = {
    'lsp_14_of_h36m17': [3, 2, 1, 4, 5, 6, 16, 15, 14, 11, 12, 13, 8, 10],
}

BENCHMARK_PROTOCOLS = {
    '3dpw': EvalProtocol(name='3dpw', pck_threshold_mm=50.0, joint_subset='lsp_14_of_h36m17'),
    'h36m': EvalProtocol(name='h36m'),
    '3dhp': EvalProtocol(name='3dhp'),
    'mupots': EvalProtocol(name='mupots'),
    '3doh': EvalProtocol(name='3doh'),
    'aspset': EvalProtocol(name='aspset'),
}


def evaluate_predictions(preds: Dict[str, np.ndarray], joint_info: Optional[JointInfo] = None,
                         threshold_mm: float = 150.0,
                         joint_subset: Optional[Sequence[int]] = None,
                         device='cuda') -> Dict[str, float]:
    """The metric table of a prediction dump (`poses3d_pred_cam`,
    `poses3d_true_cam`, `joint_validity_mask`), computed on `device`;
    `joint_subset` restricts it to those joint indices (the wrist metrics
    then need no `joint_info`)."""
    pred = preds['poses3d_pred_cam']
    true = preds['poses3d_true_cam']
    mask = preds['joint_validity_mask']
    if joint_subset is not None:
        idx = np.asarray(joint_subset)
        pred, true, mask = pred[:, idx], true[:, idx], mask[:, idx]
    m = metrics_mod.compute_pose3d_metrics(
        pred, true, mask, joint_info=joint_info if joint_subset is None else None,
        threshold_mm=threshold_mm, device=device)
    return {k: float(v) for k, v in m.items()}


def save_predictions_npz(path: str, preds: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **preds)


def save_predictions(path: str, preds: Dict[str, np.ndarray]) -> None:
    """NPZ. A .h5 or .hdf5 path raises NotImplementedError: the card's
    machine has no HDF5 writer (F5; ROADMAP.md, "HDF5 reader")."""
    if path.endswith(('.h5', '.hdf5')):
        raise NotImplementedError(
            f'{path}: HDF5 prediction dumps are not ported (no h5py on the GPU machine; '
            f'ROADMAP.md, "HDF5 reader"); write an .npz path instead')
    save_predictions_npz(path, preds)


def matched_pose_metrics(preds_per_frame, gts_per_frame, threshold_mm: float = 150.0,
                         match_threshold_mm: float = 500.0, root_index=None, eval_joints=None):
    """Multi-person matched metrics (the MuPoTS protocol): per frame, the
    predictions [n_i, J, 3] are Hungarian-matched to the ground-truth poses by
    root-relative MPJPE (at most `match_threshold_mm`); an unmatched
    ground-truth pose counts all its joints as misses. `root_index` aligns at
    that joint (None: at the mean); `eval_joints` are the scored joints (None:
    all; the alignment always uses the whole pose). Returns matched_pck
    (root-relative), matched_apck (absolute) and recall."""
    import scipy.optimize

    sel = slice(None) if eval_joints is None else np.asarray(eval_joints)

    def rootrel(p):
        if root_index is None:
            return p - p.mean(axis=-2, keepdims=True)
        return p - p[..., root_index:root_index + 1, :]

    n_correct = n_correct_abs = n_total = n_matched = n_gt = 0
    for preds, gts in zip(preds_per_frame, gts_per_frame):
        n_gt += len(gts)
        n_total += sum(g[sel].shape[0] for g in gts)
        if len(gts) == 0 or len(preds) == 0:
            continue
        cost = np.zeros((len(gts), len(preds)))
        for i, g in enumerate(gts):
            for j, q in enumerate(preds):
                cost[i, j] = np.linalg.norm(rootrel(g)[sel] - rootrel(q)[sel], axis=-1).mean()
        gi, pj = scipy.optimize.linear_sum_assignment(cost)
        for i, j in zip(gi, pj):
            if cost[i, j] > match_threshold_mm:
                continue
            n_matched += 1
            dist = np.linalg.norm(rootrel(gts[i])[sel] - rootrel(preds[j])[sel], axis=-1)
            n_correct += int((dist <= threshold_mm).sum())
            dist_abs = np.linalg.norm(gts[i][sel] - preds[j][sel], axis=-1)
            n_correct_abs += int((dist_abs <= threshold_mm).sum())
    return dict(matched_pck=n_correct / max(n_total, 1),
                matched_apck=n_correct_abs / max(n_total, 1),
                recall=n_matched / max(n_gt, 1))
