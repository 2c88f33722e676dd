"""Binary-mask helpers of `metrabs_tpu/data/masks.py` that the evaluation
needs, numpy only: `mask_iou`. The rest of that module (morphology,
rasterisation, RLE resizing) uses cv2 and comes with the data layer.
"""

from __future__ import annotations

import numpy as np


def mask_iou(mask1: np.ndarray, mask2: np.ndarray) -> float:
    """IoU of two binary masks; an empty union gives 0, not NaN."""
    m1 = np.asarray(mask1).astype(bool)
    m2 = np.asarray(mask2).astype(bool)
    union = np.count_nonzero(m1 | m2)
    if union == 0:
        return 0.0
    return float(np.count_nonzero(m1 & m2) / union)
