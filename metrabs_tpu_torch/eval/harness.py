"""Benchmark evaluation, the metric half (`metrabs_tpu/eval/harness.py`):
the per-benchmark protocols (3DPW's 14 joints with PCK at 50 mm, H36M,
3DHP, MuPoTS, 3DOH, ASPset), `evaluate_predictions` over a prediction dump,
the NPZ and HDF5 dump writers, and the matched multi-person metrics of the
MuPoTS protocol.

`predict_dataset`, which runs a crop model over a test set to make the dump,
goes through the data layer (example loading and its image warps) and comes
with it; it is not here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from metrabs_tpu_torch.eval import metrics as metrics_mod
from metrabs_tpu_torch.utils.joint_info import JointInfo


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


def save_predictions_hdf5(path: str, preds: Dict[str, np.ndarray]) -> None:
    """An HDF5 prediction dump; string arrays as variable-length UTF-8. Needs
    h5py."""
    import h5py
    with h5py.File(path, 'w') as f:
        for key, value in preds.items():
            value = np.asarray(value)
            if value.dtype.kind in ('U', 'O'):
                f.create_dataset(key, data=value.astype(object),
                                 dtype=h5py.string_dtype(encoding='utf-8'))
            else:
                f.create_dataset(key, data=value, compression='gzip')


def save_predictions(path: str, preds: Dict[str, np.ndarray]) -> None:
    """HDF5 for a .h5 or .hdf5 path, NPZ otherwise."""
    if path.endswith(('.h5', '.hdf5')):
        save_predictions_hdf5(path, preds)
    else:
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
