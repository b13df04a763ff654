"""OC-SORT multi-object tracker (host reference lane).

Re-implementation of Observation-Centric SORT (Cao et al., 2022) with the
call surface the reference uses from the ``ocsort`` pip package
(track.py:17,157: ``OCSort(max_age=30, asso_func="diou", iou_threshold=0.1)``
and ``update(dets, [])``; track.py:194-199 reads ``tracker.trackers`` /
``trk.kf.x``). The three OC-SORT mechanisms are implemented:

- **OCM** (observation-centric momentum): the association cost adds a
  direction-consistency term between each track's historical motion
  (velocity estimated from the observation ``delta_t`` frames back) and the
  direction from its last observation to each candidate detection.
- **OCR** (observation-centric recovery): a second association round matches
  leftover detections to leftover tracks by their *last observations*
  rather than Kalman predictions.
- **ORU** (observation-centric re-update): when a track is re-found after
  being lost, the Kalman filter rolls back to its state at the last
  observation and replays a linearly interpolated virtual trajectory,
  undoing error accumulated while coasting.
"""

from __future__ import annotations

import numpy as np

from vbt_tpu_torch.tracking.assignment import linear_assignment
from vbt_tpu_torch.tracking.association import (
    ASSO_FUNCS,
    direction_consistency,
    speed_direction,
)
from vbt_tpu_torch.tracking.kalman import (
    bbox_to_z,
    kf_init,
    kf_predict,
    kf_update,
    state_bbox,
)
from vbt_tpu_torch.tracking.sort import _KFView


class KalmanBoxTracker:
    """OC-SORT track: Kalman state + observation history + ORU rollback."""

    count = 0

    def __init__(self, det: np.ndarray, delta_t: int = 3):
        self.x, self.p = kf_init(bbox_to_z(det[:4]))
        self.time_since_update = 0
        self.id = KalmanBoxTracker.count
        KalmanBoxTracker.count += 1
        self.hits = 0
        self.hit_streak = 0
        self.age = 0
        self.conf = float(det[4]) if det.shape[0] > 4 else 0.0
        self.cls = float(det[5]) if det.shape[0] > 5 else 0.0
        self.delta_t = delta_t

        self.last_observation = np.full(5, -1.0)  # [x1,y1,x2,y2,score]
        self.observations: dict[int, np.ndarray] = {}
        self.velocity: np.ndarray | None = None
        self._frozen: tuple | None = None  # (x, p) at the last observation
        self._miss_gap = 0  # frames coasted since the freeze
        self.kf = _KFView(self)

    # -- ORU ---------------------------------------------------------------
    def _freeze(self):
        if self._frozen is None:
            self._frozen = (self.x.copy(), self.p.copy())
            self._miss_gap = 0
        self._miss_gap += 1

    def _reupdate(self, det: np.ndarray) -> bool:
        """Roll back and replay a virtual trajectory to the new observation.

        Semantics pinned NUMERICALLY to the real OC-SORT by replay against
        the golden dataframes (dfs_ocsort/ record the real tracker's
        kf.x[4:6] per frame, reference track.py:194-199): starting from the
        post-update state at the last real observation, each missed frame
        gets a plain predict+update cycle with a virtual observation
        interpolated linearly in MEASUREMENT space (center x, y, width,
        height; s=w*h, r=w/h recomputed per step), ending with the
        re-found frame whose virtual equals the real observation — which is
        therefore NOT applied again by the caller (returns True when the
        replay consumed it).

        (The stored frozen state is the post-predict state of the first
        missed frame, i.e. post-update-at-T plus one predict, so the loop
        below runs update-then-predict; the two formulations are the same
        sequence.)
        """
        if self._frozen is None or self.last_observation[4] < 0:
            return False
        self.x, self.p = self._frozen
        x1, y1, s1, r1 = bbox_to_z(self.last_observation[:4])
        x2, y2, s2, r2 = bbox_to_z(det[:4])
        w1, h1 = np.sqrt(s1 * r1), np.sqrt(s1 / r1)
        w2, h2 = np.sqrt(s2 * r2), np.sqrt(s2 / r2)
        gap = self._miss_gap + 1  # frames between the two real observations
        for i in range(gap):
            f = (i + 1) / gap
            w = w1 + f * (w2 - w1)
            h = h1 + f * (h2 - h1)
            virtual = np.array(
                [x1 + f * (x2 - x1), y1 + f * (y2 - y1), w * h, w / h]
            )
            self.x, self.p = kf_update(self.x, self.p, virtual)
            if i != gap - 1:
                self.x, self.p = kf_predict(self.x, self.p)
        self._frozen = None
        self._miss_gap = 0
        return True

    # -- SORT lifecycle ------------------------------------------------------
    def predict(self) -> np.ndarray:
        self.x, self.p = kf_predict(self.x, self.p)
        self.age += 1
        if self.time_since_update > 0:
            self.hit_streak = 0
        self.time_since_update += 1
        return state_bbox(self.x)

    def update(self, det: np.ndarray | None) -> None:
        if det is None:
            self._freeze()
            return
        replayed = False
        if self.time_since_update > 1:
            replayed = self._reupdate(det)

        if self.last_observation[4] >= 0:
            # OCM velocity: direction from the observation delta_t frames
            # back (or the most recent available) to the new one.
            previous = None
            for i in range(self.delta_t):
                dt = self.delta_t - i
                if self.age - dt in self.observations:
                    previous = self.observations[self.age - dt]
                    break
            if previous is None:
                previous = self.last_observation
            self.velocity = speed_direction(previous[:4], det[:4])

        obs = np.concatenate([det[:4], [det[4] if det.shape[0] > 4 else 0.0]])
        self.last_observation = obs
        self.observations[self.age] = obs
        self.conf = float(obs[4])
        if det.shape[0] > 5:
            self.cls = float(det[5])
        self.time_since_update = 0
        self.hits += 1
        self.hit_streak += 1
        self._frozen = None
        self._miss_gap = 0
        if not replayed:
            self.x, self.p = kf_update(self.x, self.p, bbox_to_z(det[:4]))

    def get_state(self) -> np.ndarray:
        return state_bbox(self.x)


class OCSort:
    """Observation-centric SORT with the reference's constructor surface."""

    def __init__(
        self,
        det_thresh: float = 0.0,
        max_age: int = 30,
        # min_hits=1 pinned by golden replay: dfs_ocsort/ rows appear from a
        # track's SECOND consecutive hit (and immediately on re-find), while
        # never-re-matched births leave no rows — exactly min_hits=1
        # (tests/test_tracker_golden_replay.py).
        min_hits: int = 1,
        iou_threshold: float = 0.3,
        delta_t: int = 3,
        asso_func: str = "iou",
        inertia: float = 0.2,
    ):
        self.det_thresh = det_thresh
        self.max_age = max_age
        self.min_hits = min_hits
        self.iou_threshold = iou_threshold
        self.delta_t = delta_t
        self.asso_func = ASSO_FUNCS[asso_func]
        self.inertia = inertia
        self.trackers: list[KalmanBoxTracker] = []
        self.frame_count = 0
        # Fresh id space per tracker instance: the golden dfs_ocsort/ files
        # all carry id1 while the SORT-generation dfs/ ids climb across
        # videos (class-global counter) — so OC-SORT resets, SORT does not.
        KalmanBoxTracker.count = 0

    def _associate(self, dets, trks, velocities, k_observations):
        if dets.shape[0] == 0 or trks.shape[0] == 0:
            return (
                np.empty((0, 2), int),
                np.arange(dets.shape[0]),
                np.arange(trks.shape[0]),
            )
        affinity = self.asso_func(dets[:, :4], trks)
        momentum = direction_consistency(dets[:, :4], k_observations, velocities)
        cost = affinity + self.inertia * momentum

        over = (affinity > self.iou_threshold).astype(np.int32)
        if over.sum(1).max() == 1 and over.sum(0).max() == 1:
            matched = np.stack(np.nonzero(over), axis=1)
        else:
            matched = linear_assignment(-cost)
        keep = affinity[matched[:, 0], matched[:, 1]] >= self.iou_threshold
        matched = matched[keep]
        unmatched_dets = np.setdiff1d(np.arange(dets.shape[0]), matched[:, 0])
        unmatched_trks = np.setdiff1d(np.arange(trks.shape[0]), matched[:, 1])
        return matched, unmatched_dets, unmatched_trks

    def update(self, dets: np.ndarray, _=None) -> np.ndarray:
        self.frame_count += 1
        dets = np.asarray(dets, dtype=np.float64).reshape(
            -1, dets.shape[-1] if dets.size else 6
        )
        if dets.shape[0]:
            dets = dets[dets[:, 4] >= self.det_thresh]

        # Kalman predictions for all live tracks.
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

        velocities = np.array(
            [
                trk.velocity if trk.velocity is not None else np.zeros(2)
                for trk in self.trackers
            ]
        ).reshape(-1, 2)
        last_boxes = np.array(
            [trk.last_observation for trk in self.trackers]
        ).reshape(-1, 5)
        # Reference observation delta_t frames back for the momentum term.
        k_observations = np.array(
            [self._k_previous_obs(trk) for trk in self.trackers]
        ).reshape(-1, 5)

        matched, unmatched_dets, unmatched_trks = self._associate(
            dets, trks, velocities, k_observations
        )
        for d, t in matched:
            self.trackers[t].update(dets[d])

        # OCR: second chance by last observation.
        if unmatched_dets.size and unmatched_trks.size:
            left_dets = dets[unmatched_dets]
            left_trks = last_boxes[unmatched_trks][:, :4]
            affinity = self.asso_func(left_dets[:, :4], left_trks)
            if affinity.max() > self.iou_threshold:
                rematched = linear_assignment(-affinity)
                covered_d, covered_t = set(), set()
                for d, t in rematched:
                    if affinity[d, t] < self.iou_threshold:
                        continue
                    self.trackers[unmatched_trks[t]].update(dets[unmatched_dets[d]])
                    covered_d.add(d)
                    covered_t.add(t)
                unmatched_dets = np.array(
                    [d for i, d in enumerate(unmatched_dets) if i not in covered_d],
                    dtype=int,
                )
                unmatched_trks = np.array(
                    [t for i, t in enumerate(unmatched_trks) if i not in covered_t],
                    dtype=int,
                )

        for t in unmatched_trks:
            self.trackers[t].update(None)
        for d in unmatched_dets:
            self.trackers.append(KalmanBoxTracker(dets[d], delta_t=self.delta_t))

        ret = []
        for trk in reversed(self.trackers):
            if trk.last_observation[4] < 0:
                box = trk.get_state()
            else:
                # Report the last observation, not the Kalman state — the
                # observation-centric output convention.
                box = trk.last_observation[:4]
            if trk.time_since_update < 1 and (
                trk.hit_streak >= self.min_hits or self.frame_count <= self.min_hits
            ):
                ret.append(np.concatenate([box, [trk.id + 1, trk.cls, trk.conf]]))
        self.trackers = [
            trk for trk in self.trackers if trk.time_since_update <= self.max_age
        ]
        return np.stack(ret) if ret else np.empty((0, 7))

    def _k_previous_obs(self, trk: KalmanBoxTracker) -> np.ndarray:
        if trk.last_observation[4] < 0:
            return np.full(5, -1.0)
        for i in range(self.delta_t):
            dt = self.delta_t - i
            if trk.age - dt in trk.observations:
                return trk.observations[trk.age - dt]
        return trk.last_observation
