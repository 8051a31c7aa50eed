"""Fiducial tag tracker (L1 host orchestration): the `TrackAruco` equivalent.

Mirrors TrackAruco::perform_tracking (TrackAruco.cpp:59-150): detect markers,
keep tags with id <= max_tag_id, and emit each tag's 4 corners as point
features with the stable id  `id_base + tag_id + n * max_tag_id`  (the
reference uses tag_id + n*max_tag_id; id_base lifts the block above the KLT
id space so both trackers can share one FeatureDatabase).  Detection itself
is the batched template-bank NCC detector (ops/aruco.py) instead of the
reference's cv::aruco wrap.
"""

from __future__ import annotations

import numpy as np

from ..ops.aruco import TagDetector


class ArucoTracker:
    def __init__(self, max_tag_id: int = 16, id_base: int = 10_000_000,
                 detector: TagDetector | None = None, **det_kwargs):
        self.det = detector or TagDetector(**det_kwargs)
        self.max_tag_id = max_tag_id
        self.id_base = id_base
        self.last = {}  # tag_id -> (4,2) corners of the newest frame

    def feed(self, img):
        """One frame -> (ids (4K,), uvs (4K,2)) corner features."""
        out = {k: np.asarray(v) for k, v in self.det.detect(img).items()}
        ids, uvs = [], []
        self.last = {}
        for i in np.nonzero(out["valid"])[0]:
            tag = int(out["tag_id"][i])
            if tag >= self.max_tag_id:
                continue
            corners = out["corners"][i]
            H, W = img.shape
            if not np.all((corners[:, 0] > 1) & (corners[:, 0] < W - 2)
                          & (corners[:, 1] > 1) & (corners[:, 1] < H - 2)):
                continue
            self.last[tag] = corners
            for n in range(4):
                ids.append(self.id_base + tag + n * self.max_tag_id)
                uvs.append(corners[n])
        if not ids:
            return np.zeros(0, dtype=np.int64), np.zeros((0, 2))
        return np.asarray(ids, dtype=np.int64), np.asarray(uvs)
