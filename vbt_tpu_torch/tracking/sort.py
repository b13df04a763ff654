"""SORT's Kalman track (host lane): the part of ``vbt_tpu.tracking.sort``
that OC-SORT builds on. Each ``KalmanBoxTracker`` has a 0-based ``.id`` and
a filterpy-shaped ``.kf.x`` column vector; the track CLI reads center
velocities from ``trk.kf.x.flatten()[4:6]``. The ``SortTracker`` loop
itself is not ported: the track path runs OC-SORT."""

from __future__ import annotations

import numpy as np

from vbt_tpu_torch.tracking.kalman import (
    bbox_to_z,
    kf_init,
    kf_predict,
    kf_update,
    state_bbox,
)


class _KFView:
    """filterpy-compatible view: ``kf.x`` is a (7, 1) column vector."""

    def __init__(self, owner: "KalmanBoxTracker"):
        self._owner = owner

    @property
    def x(self) -> np.ndarray:
        return self._owner.x.reshape(-1, 1)


class KalmanBoxTracker:
    """Single-target constant-velocity Kalman track."""

    count = 0

    def __init__(self, det: np.ndarray):
        self.x, self.p = kf_init(bbox_to_z(det[:4]))
        self.time_since_update = 0
        self.id = KalmanBoxTracker.count
        KalmanBoxTracker.count += 1
        self.hits = 0
        self.hit_streak = 0
        self.age = 0
        self.conf = float(det[4]) if det.shape[0] > 4 else 0.0
        self.cls = float(det[5]) if det.shape[0] > 5 else 0.0
        self.kf = _KFView(self)

    def predict(self) -> np.ndarray:
        self.x, self.p = kf_predict(self.x, self.p)
        self.age += 1
        if self.time_since_update > 0:
            self.hit_streak = 0
        self.time_since_update += 1
        return state_bbox(self.x)

    def update(self, det: np.ndarray) -> None:
        self.time_since_update = 0
        self.hits += 1
        self.hit_streak += 1
        self.conf = float(det[4]) if det.shape[0] > 4 else self.conf
        if det.shape[0] > 5:
            self.cls = float(det[5])
        self.x, self.p = kf_update(self.x, self.p, bbox_to_z(det[:4]))

    def get_state(self) -> np.ndarray:
        return state_bbox(self.x)

