"""``map_gap``: the widest gap of a set of heatmaps from the reference.

The largest ``|map - ref|`` of a frame over that frame's largest
reference pixel, the worst frame.  A check is found by its name in the
configuration's ``"limits"``: ``checks/<name>.py`` with
``value(maps, ref)``.
"""

from __future__ import annotations

import numpy as np


def value(maps: np.ndarray, ref: np.ndarray) -> float:
    maps = np.asarray(maps, np.float64)
    err = np.abs(maps - ref).reshape(len(ref), -1).max(axis=1)
    peak = ref.reshape(len(ref), -1).max(axis=1)
    return float((err / peak).max()) if len(ref) else 0.0
