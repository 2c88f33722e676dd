"""Matlab .mat loading with struct curing (`metrabs_tf/matlabfile.py`
equivalent): mat_structs become plain nested dicts, so benchmark annotation
files (MuPoTS etc.) read as regular Python data.

A copy of `metrabs_tpu/utils/matlabfile.py`; the port keeps its own."""

from __future__ import annotations

from typing import Any

import numpy as np
import scipy.io


def load(path: str) -> dict:
    data = scipy.io.loadmat(path, struct_as_record=False, squeeze_me=True)
    return {k: _cure(v) for k, v in data.items() if not k.startswith('__')}


def _cure(value: Any) -> Any:
    if isinstance(value, scipy.io.matlab.mat_struct):
        return {name: _cure(getattr(value, name)) for name in value._fieldnames}
    if isinstance(value, np.ndarray) and value.dtype == object:
        # Element-wise assignment: np.array(list_of_arrays, dtype=object)
        # merges same-shaped element arrays into one rectangular array
        # instead of keeping them as objects.
        out = np.empty(value.shape, object)
        for idx, v in np.ndenumerate(value):
            out[idx] = _cure(v)
        return out
    return value
