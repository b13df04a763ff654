"""The track family: ``vbt-torch-track`` from a video file to its dataframe.

Traffic (``traffic/<mix>.json``): ``videos`` distinct sets a seed, each
``frames`` frames of ``height`` x ``width`` at ``fps``, rendered by
:mod:`benchmark.core.scene` and written as mp4v files under ``TMPDIR`` at
set-up; the window tracks them whole, back to back, cycled, through
``track_one(pipeline, path, threshold, "scan", batch_size=batch)``, the
track CLI's body for one video (decode, detection, K1, K3, the dict).

``track_fps``: the frames of every video finished in the window over the
time from the window's start to the end of the last one; the window
closes at the end of the first video that ends after ``--seconds``.

The check (:meth:`Cell.check`), once the window has closed: ``judged``
finished videos drawn from the seed (each distinct video at least once
where the window holds it), decoded again by the reference with OpenCV
from the same file: ``box_gap``, ``box_gap_p90``, ``motion_gap`` and
``valid_gap`` on all their frames, ``track_gap`` of their dicts
(``drivers/_detect.py``).
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np

from benchmark.core import scene
from benchmark.drivers import _detect


class Cell:
    device = "cuda"
    pipeline_hook = None  # a control or a test may swap the served pipeline

    def __init__(self, config: dict, mix: dict, seed: int, traced: bool, root):
        self.config, self.mix, self.seed, self.traced, self.root = config, mix, seed, traced, root
        self.attempted = self.failed = 0
        self.window_s = 0.0
        self.spans = {}
        self.counters = {}

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        import torch

        from vbt_tpu_torch.cli.track import track_one

        m = self.mix
        self.track_one = track_one
        rng = np.random.default_rng(self.seed)
        self.plans = [scene.plan_set(rng, m["frames"], m["height"], m["width"], m["reps_min"],
                                     m["reps_max"], m["radius"], m["amplitude"])
                      for _ in range(m["videos"])]
        self.tmp = tempfile.mkdtemp(prefix="bench_track_")
        self.paths = []
        for i, plan in enumerate(self.plans):
            path = os.path.join(self.tmp, f"set_{i}.mp4")
            scene.write_video(plan, path, m["fps"], self.device)
            self.paths.append(path)
        pipe = _detect.build_pipeline(self.config, self.root, self.device)
        if self.pipeline_hook is not None:
            pipe = self.pipeline_hook(pipe, scene.render(self.plans[0], self.device, 0,
                                                         m["batch"]).cpu().numpy())
        self.pipe = _detect.Recorder(pipe)
        # Warm-up: one whole video (every batch shape, K1, K3 at this length).
        self._track(self.paths[0])
        if self.device == "cuda":
            torch.cuda.synchronize()
        if self.traced:
            self._time_decode()

    def _track(self, path, timer=None):
        return self.track_one(self.pipe, path, self.mix["threshold"], "scan",
                              batch_size=self.mix["batch"], timer=timer)

    def _time_decode(self) -> None:
        """The program's reader alone over each video (no detection),
        decoding into a ring of three reused buffers as it decodes into the
        pipeline's lent ones."""
        from vbt_tpu_torch.io.video import VideoReader

        ring, turn = [], [0]

        def lend(shape):
            if not ring:
                ring.extend(np.empty(shape, np.uint8) for _ in range(3))
            turn[0] += 1
            return ring[turn[0] % 3]

        frames, t0 = 0, time.perf_counter()
        for path in self.paths:
            for _, valid, _ in VideoReader(path, batch_size=self.mix["batch"], lend=lend):
                frames += int(valid.sum())
        self.counters["decode_only_s"] = time.perf_counter() - t0
        self.counters["decode_only_frames"] = frames

    # -- window ---------------------------------------------------------------
    def run_window(self, seconds: float, tracer) -> dict:
        from vbt_tpu_torch.utils.profiling import StageTimer

        timer = StageTimer()
        self.done = []  # (video index, rows, valid, data)
        frames = 0
        per_video = []
        with tracer.window():
            t0 = time.perf_counter()
            i = 0
            while True:
                k = i % len(self.paths)
                self.pipe.rows = []
                data = self._track(self.paths[k], timer)
                rows = np.concatenate([r for r, _ in self.pipe.rows])[:self.plans[k].frames]
                valid = np.concatenate([v for _, v in self.pipe.rows])[:self.plans[k].frames]
                self.pipe.rows = None
                self.done.append((k, rows, valid, data))
                frames += self.plans[k].frames
                i += 1
                now = time.perf_counter()
                per_video.append(now - (t0 + sum(per_video)))
                if now - t0 >= seconds:
                    break
        self.window_s = now - t0
        self.attempted = len(self.done)
        q = np.percentile(per_video, [0, 25, 50, 75, 100])
        print(f"window: {len(per_video)} videos in {self.window_s:.3f} s, seconds a video "
              f"min/q1/median/q3/max {' '.join(f'{x:.3f}' for x in q)}", file=sys.stderr)
        self.spans = {name: (timer.totals[name], timer.counts[name]) for name in timer.totals}
        self.counters.update(frames=frames, videos=len(self.done))
        return {"track_fps": frames / self.window_s}

    def release(self) -> None:
        import torch

        del self.pipe, self.track_one
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # -- check ------------------------------------------------------------------
    def judged(self) -> list[int]:
        """Indices into ``done``: one finished video of each distinct set the
        window holds, drawn from the seed, up to ``judged``."""
        rng = np.random.default_rng(self.seed + 1)
        by_set = {}
        for j, (k, *_rest) in enumerate(self.done):
            by_set.setdefault(k, []).append(j)
        picks = [int(rng.choice(js)) for _, js in sorted(by_set.items())]
        return picks[:self.mix["judged"]]

    def _nothing_judged(self, limits: dict, names) -> list[dict]:
        """No finished request in the window: nothing to hold, so not correct."""
        return [_detect.check(n, float("inf"), limits) for n in names]

    def check(self, limits: dict, detector=None) -> list[dict]:
        import cv2

        from benchmark.reference.detect import PlainDetector
        from benchmark.reference.track import host_tracks, tracks_to_data

        if not self.done:
            return self._nothing_judged(limits, _detect.DETECTION_NUMBERS + ("track_gap",))
        ref = detector or PlainDetector(self.config["spec"],
                                        str(self.root / self.config["checkpoint"]), self.device)
        gaps = _detect.DetectionGaps(self.mix["batch"], self.mix["threshold"])
        tgap = 0.0
        for j in self.judged():
            k, rows, valid, data = self.done[j]
            cap = cv2.VideoCapture(self.paths[k])
            fps = cap.get(cv2.CAP_PROP_FPS)
            frames = []
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            cap.release()
            ref_rows, ref_valid = ref.rows(np.stack(frames), self.mix["threshold"])
            gaps.add(rows, valid, ref_rows, ref_valid)
            want = tracks_to_data(host_tracks(rows, valid), fps)
            tgap = max(tgap, _detect.track_gap(data, want))
        if detector is None:
            ref.free()
        shutil.rmtree(self.tmp, ignore_errors=True)
        self.counters["top_rows"] = gaps.top_rows
        return gaps.checks(limits) + [_detect.check("track_gap", tgap, limits)]
