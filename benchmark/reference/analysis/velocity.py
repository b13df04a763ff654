"""Phase segmentation state machine — exact host reference lane.

Copy of ``vbt_tpu.analysis.velocity``, the default engine of the plot CLI.
Re-implements the behaviour of the reference VelocityTracker
(VelocityTracker.py:15-230) as an explicit transition system, in numpy
float64. The torch lane lives in
:mod:`benchmark.reference.analysis.velocity_torch` and is tested for equality
against this.

Semantics replicated exactly, including the reference's quirks
(SURVEY.md §2.1):

- widths *and* heights flow through one shared 30-sample running average,
  interleaved (quirk 1);
- once a previous sample exists, the incoming velocity ``dy`` is overwritten
  by the finite difference ``y - y_prev``; ``dx`` is never used (quirk 2);
- a phase starts after 3 same-sign dy samples (HOLD -> CONC on negative dy,
  HOLD -> ECC on positive dy; image y grows downward) and ends after a single
  opposite-sign sample (VelocityTracker.py:11-12);
- on the first counted HOLD sample the bar path resets and the sample is NOT
  recorded; subsequent counted samples are (VelocityTracker.py:136-141);
- phase acceptance gates: ``y_diff > max_y_diff * diff_threshold`` where
  ``max_y_diff`` has already absorbed the candidate, and metric path length
  >= ``min_distance`` (VelocityTracker.py:186-208);
- retro-filtering drops recorded phases with ``y_diff < max_y_diff / 2``
  every time ``max_y_diff`` grows and after each accepted phase
  (VelocityTracker.py:50-67);
- a phase still open at stream end is flushed (VelocityTracker.py:224-230).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from benchmark.reference.analysis.phase import CONCENTRIC, ECCENTRIC, HOLD, Phase

START_COUNT = 3  # samples of one sign needed to leave HOLD
END_COUNT = 1  # samples of the opposite sign needed to end a phase


@dataclass
class _PathPoint:
    t: float
    x: float
    y: float
    w: float
    h: float


@dataclass
class _State:
    phase: int = HOLD
    pos_cnt: int = 0
    neg_cnt: int = 0
    y_prev: float | None = None
    max_y_diff: float | None = None
    path: list[_PathPoint] = field(default_factory=list)
    phases: list[Phase] = field(default_factory=list)


def _path_rom(path: list[_PathPoint], s: int, e: int, plate_diameter: float) -> float:
    """Metric path length between path indices s and e (inclusive end).

    Each step contributes |dx| and |dy| separately, scaled from normalized
    image coordinates to meters by the plate diameter over the local average
    plate width/height (VelocityTracker.py:195-201).
    """
    dist = 0.0
    for i in range(s + 1, e + 1):
        a, b = path[i - 1], path[i]
        dist += abs(b.x - a.x) / ((b.w + a.w) / 2) * plate_diameter
        dist += abs(b.y - a.y) / ((b.h + a.h) / 2) * plate_diameter
    return dist


class VelocityTracker:
    """Streaming phase segmentation with the reference's public API.

    ``process_measurements`` consumes one (already plot-smoothed) sample at a
    time; ``end_processing`` flushes; ``phases`` holds the surviving
    :class:`Phase` records.
    """

    def __init__(
        self,
        plate_diameter: float,
        diff_threshold: float = 0.6,
        min_distance: float = 0.1,
        avg_window: int = 30,
    ):
        self.plate_diameter = plate_diameter
        self.diff_threshold = diff_threshold
        self.min_distance = min_distance
        self._st = _State()
        # The shared width/height running average (quirk 1): one sliding
        # window fed interleaved width, height each step.
        self._avg_window = avg_window
        self._avg_buf: list[float] = []
        self._avg_total = 0.0

    # -- shared running average ------------------------------------------------
    def _avg_update(self, value: float) -> float:
        self._avg_buf.append(value)
        self._avg_total += value
        if len(self._avg_buf) >= self._avg_window:
            out = self._avg_total / self._avg_window
            self._avg_total -= self._avg_buf.pop(0)
            return out
        return self._avg_total / len(self._avg_buf)

    # -- phase list maintenance --------------------------------------------------
    def _prune(self) -> None:
        threshold = self._st.max_y_diff / 2
        self._st.phases = [p for p in self._st.phases if not (p.y_diff < threshold)]

    def _finish_phase(self) -> None:
        st = self._st
        ys = [p.y for p in st.path]
        if st.phase == CONCENTRIC:
            s, e = int(np.argmax(ys)), int(np.argmin(ys))
        else:
            s, e = int(np.argmin(ys)), int(np.argmax(ys))

        y_diff = abs(st.path[s].y - st.path[e].y)
        if st.max_y_diff is None or y_diff > st.max_y_diff:
            st.max_y_diff = y_diff
            self._prune()

        if y_diff > st.max_y_diff * self.diff_threshold:
            rom = _path_rom(st.path, s, e, self.plate_diameter)
            if rom >= self.min_distance:
                st.phases.append(
                    Phase(
                        time_start=st.path[s].t,
                        time_end=st.path[e].t,
                        y_start=st.path[s].y,
                        y_end=st.path[e].y,
                        rom=rom,
                        type=st.phase,
                    )
                )
                self._prune()

        st.phase = HOLD
        st.pos_cnt = 0
        st.neg_cnt = 0

    # -- public API ---------------------------------------------------------------
    def process_measurements(self, time, x, y, dx, dy, norm_plate_height, norm_plate_width):
        st = self._st
        w = self._avg_update(norm_plate_width)
        h = self._avg_update(norm_plate_height)
        point = _PathPoint(t=time, x=x, y=y, w=w, h=h)

        if st.y_prev is not None:
            dy = y - st.y_prev

        if st.phase != HOLD:
            st.path.append(point)

        if st.phase == CONCENTRIC:
            if dy > 0:
                st.pos_cnt += 1
                st.neg_cnt = 0
                if st.pos_cnt >= END_COUNT:
                    self._finish_phase()
            else:
                st.pos_cnt = 0

        if st.phase == ECCENTRIC:
            if dy < 0:
                st.neg_cnt += 1
                st.pos_cnt = 0
                if st.neg_cnt >= END_COUNT:
                    self._finish_phase()
            else:
                # Asymmetric to the concentric branch in the reference
                # (VelocityTracker.py:121-127): the opposite counter grows.
                st.neg_cnt = 0
                st.pos_cnt += 1

        if dy < 0 and st.phase == HOLD:
            st.neg_cnt += 1
            st.pos_cnt = 0
            if st.neg_cnt == 1:
                st.path = []  # reset; the triggering sample is dropped
            else:
                st.path.append(point)
            if st.neg_cnt >= START_COUNT:
                st.phase = CONCENTRIC
                st.pos_cnt = 0
                st.neg_cnt = 0

        if dy > 0 and st.phase == HOLD:
            st.pos_cnt += 1
            st.neg_cnt = 0
            if st.pos_cnt == 1:
                st.path = []
            else:
                st.path.append(point)
            if st.pos_cnt >= START_COUNT:
                st.phase = ECCENTRIC
                st.pos_cnt = 0
                st.neg_cnt = 0

        st.y_prev = y

    def end_processing(self):
        if self._st.phase != HOLD:
            self._finish_phase()

    @property
    def phases(self) -> list[Phase]:
        return self._st.phases


def analyze_df(df, plate_diameter: float) -> list[Phase]:
    """Segment a plot-smoothed tracking dataframe into phases.

    Equivalent of plot.py:33-47 ``analyze_df``: feeds each row through the
    tracker and flushes. Expects columns
    (time, x, y, dx, dy, norm_plate_height, norm_plate_width).
    """
    vt = VelocityTracker(plate_diameter)
    cols = ["time", "x", "y", "dx", "dy", "norm_plate_height", "norm_plate_width"]
    for row in df[cols].itertuples(index=False):
        vt.process_measurements(*row)
    vt.end_processing()
    return vt.phases
