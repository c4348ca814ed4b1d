"""Label padding for the frame cache (the part of
``playground3d_tpu/data/dataset.py`` that :mod:`frame_cache` needs; the
training datasets come with the training slice)."""

from __future__ import annotations

import numpy as np

MAX_OBJS = 32


def pad_labels(labels: np.ndarray, max_objs: int = MAX_OBJS) -> np.ndarray:
    """Pad [m,21] to [max_objs,21] with class -1 rows (the reference's
    collate padding, corrected_3D_dataset.py:714-741)."""
    out = np.full((max_objs, 21), -1.0, np.float32)
    m = min(len(labels), max_objs)
    if m:
        out[:m] = labels[:m]
    return out
