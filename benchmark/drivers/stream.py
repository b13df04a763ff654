"""The stream family: ``vbt-torch-stream``'s session loop on replayed sets.

Traffic (``traffic/<mix>.json``): ``sets`` distinct sets a seed, each
``frames`` frames of ``height`` x ``width``, rendered by
:mod:`benchmark.core.scene` into host uint8 arrays at set-up. A session is
one set: a new ``StreamingPipeline`` (fresh tracker and analysis state),
then each chunk of ``chunk`` frames handed to ``process_frames`` and the
live reps read with ``phases(include_open=False)``, as ``run_stream``
does; a short last chunk is padded to ``chunk`` frames and counts only
its real ones. Each chunk is copied into a staging buffer the pipeline
lends (``lend_frames``) before it is due, as the CLI's reader decodes
into one. Sessions run back to back, cycled over the sets. Chunks
arrive on a fixed schedule of ``rate`` chunks a second (an open loop: a
chunk is due whether or not the last one is done), a rate fixed from a
sweep of the sustained rate (``tools/windows.py``); without ``rate`` the
loop is closed (a chunk sent when the last one's reps are out). At a session's end ``phases()``
gives its final reps (in the window, not in a chunk's time).

``stream_p95_ms``: the 95th percentile over every chunk in the window of
the time from when the chunk was due (its arrival) until
``phases(include_open=False)`` returns, so a chunk that waited behind a
slow one counts its wait. The window closes after the first chunk that ends after
``--seconds``, once a session has finished.

The check, once the window has closed: ``judged`` finished sessions drawn
from the seed (each distinct set at least once where the window holds
one): ``box_gap``, ``box_gap_p90``, ``motion_gap`` and ``valid_gap`` on
all their frames against the plain float32 detector, ``track_gap`` of
K3's rows and ``phase_gap`` of the final reps against the reference's host OC-SORT
and analysis of the rows the program fed its tracker
(``drivers/_detect.py``).
"""

from __future__ import annotations

import sys
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
        self.rate = mix.get("rate")
        self._due = None
        self.window_s = 0.0
        self.spans = {}
        self.counters = {}

    def setup(self) -> None:
        import torch

        from vbt_tpu_torch.runtime import streaming

        m = self.mix
        self.streaming = streaming.StreamingPipeline
        # A pass-through that keeps the scan's outputs (K3's on the card) while
        # ``self.tracks`` is a list; put back at release.
        self._streaming_mod, self._real_track_chunk = streaming, streaming.track_chunk
        self.tracks = None

        def track_chunk(*args, **kwargs):
            state, out = self._real_track_chunk(*args, **kwargs)
            if self.tracks is not None:
                self.tracks.append(out)
            return state, out

        streaming.track_chunk = track_chunk
        rng = np.random.default_rng(self.seed)
        self.plans = [scene.plan_set(rng, m["frames"], m["height"], m["width"], m["reps_min"],
                                     m["reps_max"], m["radius"], m["amplitude"])
                      for _ in range(m["sets"])]
        self.sets = [scene.render_host(p, self.device) for p in self.plans]
        pipe = _detect.build_pipeline(self.config, self.root, self.device)
        if self.pipeline_hook is not None:
            pipe = self.pipeline_hook(pipe, self.sets[0][:m["chunk"]])
        self.pipe = _detect.Recorder(pipe)
        # Warm-up: one whole session (the chunk shape, K1, K3 with its state,
        # K4, the padded last chunk).
        self._session(0, None, None)
        if self.device == "cuda":
            torch.cuda.synchronize()

    def _session(self, k: int, latencies, timer, deadline=None):
        """Stream set ``k``; returns its final phases, or None where the
        clock passed ``deadline`` before its last chunk. With a ``rate``,
        each chunk is due at its place in the schedule (``self._due``) and
        waits for it; its latency runs from when it was due."""
        m = self.mix
        frames = self.sets[k]
        kw = {} if timer is None else {"timer": timer}
        sp = self.streaming(detector=self.pipe, fps=m["fps"],
                            detection_threshold=m["threshold"],
                            plate_diameter=m["plate_diameter"], follow_id=m["follow_id"], **kw)
        c = m["chunk"]
        for i in range(0, len(frames), c):
            # The frames land in a buffer the pipeline lends, as the stream
            # CLI's reader decodes into one before the chunk is complete; a
            # short last chunk is padded.
            src = frames[i:i + c]
            keep = len(src)
            chunk = self.pipe.lend_frames((c, *frames.shape[1:]))
            chunk[:keep] = src
            chunk[keep:] = 0
            t0 = time.perf_counter()
            if self._due is not None:
                while t0 < self._due:
                    time.sleep(min(self._due - t0, 0.002))
                    t0 = time.perf_counter()
                self.late.append(t0 - self._due)
                t0, self._due = self._due, self._due + 1.0 / self.rate
            sp.process_frames(chunk, keep)
            sp.phases(include_open=False)
            now = time.perf_counter()
            if latencies is not None:
                latencies.append(now - t0)
                self.positions.append(i // c)
            if deadline is not None and now >= deadline and i + c < len(frames):
                return None
        return sp.phases()

    def run_window(self, seconds: float, tracer) -> dict:
        from vbt_tpu_torch.utils.profiling import StageTimer

        timer = StageTimer()
        self.done = []  # (set index, rows, valid, final phases)
        latencies = []
        self.late, self.positions = [], []
        with tracer.window():
            t0 = time.perf_counter()
            self._due = t0 if self.rate else None
            i = 0
            while time.perf_counter() - t0 < seconds:
                k = i % len(self.sets)
                self.pipe.rows, self.tracks = [], []
                # The first session always finishes, so the check has one.
                phases = self._session(k, latencies, timer, t0 + seconds if i else None)
                if phases is None:
                    break
                n = self.plans[k].frames
                rows = np.concatenate([r for r, _ in self.pipe.rows])[:n]
                valid = np.concatenate([v for _, v in self.pipe.rows])[:n]
                self.done.append((k, rows, valid, phases, self.tracks))
                i += 1
            self.pipe.rows = self.tracks = None
            self.window_s = time.perf_counter() - t0
        self._due = None
        self.attempted = len(latencies)
        self.spans = {name: (timer.totals[name], timer.counts[name]) for name in timer.totals}
        lat = np.asarray(latencies) * 1e3
        print(f"window: {len(lat)} chunks in {self.window_s:.3f} s, latency ms p50 "
              f"{np.percentile(lat, 50):.2f} p95 {np.percentile(lat, 95):.2f} max {lat.max():.2f}"
              + (f", started late at most {1e3 * max(self.late):.2f} ms" if self.late else ""),
              file=sys.stderr)
        pos = np.asarray(self.positions)
        print("window: median latency ms by chunk of a session: " + " ".join(
            f"{p}:{np.median(lat[pos == p]):.1f}" for p in np.unique(pos)), file=sys.stderr)
        self.counters.update(chunks=len(latencies), sessions=len(self.done), late=self.late,
                             frames=sum(self.plans[k].frames for k, *_ in self.done),
                             latencies=latencies)
        return {"stream_p95_ms": float(np.percentile(latencies, 95)) * 1e3}

    def release(self) -> None:
        import torch

        self._streaming_mod.track_chunk = self._real_track_chunk
        del self.pipe, self.streaming
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def judged(self) -> list[int]:
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
        from benchmark.reference.detect import PlainDetector
        from benchmark.reference.track import followed_phases, host_tracks, tracks_to_data

        m = self.mix
        names = _detect.DETECTION_NUMBERS + ("track_gap", "phase_gap")
        if not self.done:
            return self._nothing_judged(limits, names)
        ref = detector or PlainDetector(self.config["spec"],
                                        str(self.root / self.config["checkpoint"]), self.device)
        gaps = _detect.DetectionGaps(m["chunk"], m["threshold"])
        tgap, pgap = 0.0, 0.0
        for j in self.judged():
            k, rows, valid, phases, tracks = self.done[j]
            ref_rows, ref_valid = ref.rows(self.sets[k], m["threshold"])
            gaps.add(rows, valid, ref_rows, ref_valid)
            data = tracks_to_data(_detect.tracks_numpy(tracks, len(rows)), m["fps"])
            tgap = max(tgap, _detect.track_gap(data, tracks_to_data(host_tracks(rows, valid),
                                                                    m["fps"])))
            want = followed_phases(data, m["follow_id"], m["plate_diameter"], flush=True)
            pgap = max(pgap, _detect.phase_gap(phases, want, m["fps"]))
        if detector is None:
            ref.free()
        self.counters["top_rows"] = gaps.top_rows
        return gaps.checks(limits) + [_detect.check("track_gap", tgap, limits),
                                      _detect.check("phase_gap", pgap, limits)]
