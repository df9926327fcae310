"""Web application support.

Only :class:`SyntheticCamera` is ported so far: the headless camera that
``demo sensorfusion --camera -1`` reads.  The MJPEG monitor itself (the
JAX package's ``apps/web.py``: routes, backends, replay page, metrics) is
ROADMAP queue 1 item 14.
"""

from __future__ import annotations

import numpy as np


class SyntheticCamera:
    """Headless camera stand-in: moving gradient frames."""

    def __init__(self, size=(480, 640)):
        self.size = size
        self.i = 0

    def read(self):
        h, w = self.size
        self.i += 1
        x = np.linspace(0, 255, w, dtype=np.float32)[None, :]
        y = np.linspace(0, 255, h, dtype=np.float32)[:, None]
        img = np.stack([np.broadcast_to((x + self.i * 3) % 256, (h, w)),
                        np.broadcast_to(y, (h, w)),
                        np.full((h, w), 64, np.float32)], axis=-1)
        return True, img.astype(np.uint8)
