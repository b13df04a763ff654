"""SORT multi-object tracker (host lane), copy of ``vbt_tpu.tracking.sort``.

Classic SORT (Bewley et al., 2016) with the call surface of the
``sort-track`` package the original project used:

- ``SortTracker.update(dets, _)`` takes an (N, >=5) array of
  [x1,y1,x2,y2,score(,cls)] rows and returns (K, 7) rows
  [x1,y1,x2,y2,track_id,cls,score] with 1-based track ids;
- live ``KalmanBoxTracker`` objects are ``.trackers``, each with a 0-based
  ``.id`` (counted on the class, so ids continue across videos) and a
  filterpy-shaped ``.kf.x`` column vector; the track CLI reads center
  velocities from ``trk.kf.x.flatten()[4:6]``. OC-SORT builds on the same
  track class.

The scan tracker runs the same algorithm on the card
(``ScanTrackerConfig.sort``, kernel K3); this loop is its host oracle.
"""

from __future__ import annotations

import numpy as np

from vbt_tpu_torch.tracking.assignment import linear_assignment
from vbt_tpu_torch.tracking.association import iou_batch
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


def associate_iou(dets: np.ndarray, trks: np.ndarray, iou_threshold: float):
    """IoU association with the SORT shortcut: when the thresholded IoU
    matrix is a partial permutation, skip the assignment solve. Returns
    (matched (K, 2) [det, trk], unmatched dets, unmatched trks)."""
    if dets.shape[0] == 0 or trks.shape[0] == 0:
        return (
            np.empty((0, 2), int),
            np.arange(dets.shape[0]),
            np.arange(trks.shape[0]),
        )
    iou = iou_batch(dets[:, :4], trks)
    over = (iou > iou_threshold).astype(np.int32)
    if over.sum(1).max() == 1 and over.sum(0).max() == 1:
        matched = np.stack(np.nonzero(over), axis=1)
    else:
        matched = linear_assignment(-iou)
    keep = iou[matched[:, 0], matched[:, 1]] >= iou_threshold
    matched = matched[keep]
    unmatched_dets = np.setdiff1d(np.arange(dets.shape[0]), matched[:, 0])
    unmatched_trks = np.setdiff1d(np.arange(trks.shape[0]), matched[:, 1])
    return matched, unmatched_dets, unmatched_trks


class SortTracker:
    """Frame-by-frame SORT with max_age pruning and min_hits warmup.

    ``min_hits=1`` is the default the JAX package pins by replaying the
    original project's dataframes (``min_hits=3`` loses birth and re-find
    rows). A track is reported in a frame it was matched or born in, once
    its hit streak reaches ``min_hits`` or while ``frame_count <= min_hits``;
    it dies when more than ``max_age`` frames passed since its last match."""

    def __init__(self, max_age: int = 1, min_hits: int = 1, iou_threshold: float = 0.3):
        self.max_age = max_age
        self.min_hits = min_hits
        self.iou_threshold = iou_threshold
        self.trackers: list[KalmanBoxTracker] = []
        self.frame_count = 0

    def update(self, dets: np.ndarray, _=None) -> np.ndarray:
        self.frame_count += 1
        dets = np.asarray(dets, dtype=np.float64).reshape(-1, dets.shape[-1] if dets.size else 6)

        # Predict existing tracks; drop any that went numerically invalid.
        trks = np.zeros((len(self.trackers), 4))
        to_del = []
        for t, trk in enumerate(self.trackers):
            pos = trk.predict()
            trks[t] = pos
            if np.any(np.isnan(pos)):
                to_del.append(t)
        for t in reversed(to_del):
            self.trackers.pop(t)
            trks = np.delete(trks, t, axis=0)

        matched, unmatched_dets, _unmatched = associate_iou(dets, trks, self.iou_threshold)
        for d, t in matched:
            self.trackers[t].update(dets[d])
        for d in unmatched_dets:
            self.trackers.append(KalmanBoxTracker(dets[d]))

        ret = []
        for trk in reversed(self.trackers):
            if trk.time_since_update < 1 and (
                trk.hit_streak >= self.min_hits or self.frame_count <= self.min_hits
            ):
                box = trk.get_state()
                ret.append(np.concatenate([box, [trk.id + 1, trk.cls, trk.conf]]))
        self.trackers = [trk for trk in self.trackers if trk.time_since_update <= self.max_age]
        return np.stack(ret) if ret else np.empty((0, 7))
