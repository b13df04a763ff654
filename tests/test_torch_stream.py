"""The port's streaming path against the JAX package on the CPU.

Held against ``vbt_tpu.analysis.smoother_scan``, ``vbt_tpu.runtime.streaming``
and ``vbt_tpu.cli.stream`` on the same numpy inputs, float64 (the tests turn
on JAX's x64):

- ``smoother_step``: equal bit for bit to JAX's step run one sample at a
  time. Against JAX's compiled scan and the host oracle ``_CausalSmoother``
  within 1e-12 absolute (JAX's own bound, tests/test_streaming.py): XLA
  compiles the division by 30 as a product with 1/30, and the oracle sums
  the 5-window oldest first where the ring sums in ring order, each a
  rounding step apart;
- ``StreamingAnalyzer`` pushed in chunks of 7 and 64 against JAX's on the
  fuzz series of tests/test_velocity_jax.py: the same phases, types and
  times exact, positions and ROM within 1e-12 relative (the width and
  height averages differ by XLA's 1/30 in the last bit);
- the plain chunked tracker with the state carried (``track_chunk``)
  against JAX's ``track_chunk``: ids, report and conf exact, boxes and dxdy
  within 1e-12, final states too; and against one whole scan bit for bit;
- ``run_stream`` against JAX's ``run_stream`` with the same injected pixel
  detector on the same synthetic video: the same printed lines;
- ``StreamingPipeline`` on the CPU keeps the followed id's samples in frame
  order and follows ``follow_id``.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_track_cli import PixelDetector, synthetic_video  # noqa: E402,F401
from vbt_tpu.analysis import smoother_scan as jax_smoother  # noqa: E402
from vbt_tpu.cli import stream as jax_stream  # noqa: E402
from vbt_tpu.runtime import streaming as jax_streaming  # noqa: E402
from vbt_tpu.tracking import scan as jax_scan  # noqa: E402
from vbt_tpu_torch.analysis.smoother_scan import initial_smoother, smoother_step  # noqa: E402
from vbt_tpu_torch.cli import stream as port_stream  # noqa: E402
from vbt_tpu_torch.io.synthetic import plate_detections, tracker_cases  # noqa: E402
from vbt_tpu_torch.runtime import streaming  # noqa: E402
from vbt_tpu_torch.tracking.scan import ScanTrackerConfig, init_state, track_video  # noqa: E402

PLATE_DIAMETER = 0.45


def _raw_samples(seed=7, n=120):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.2, 0.8, n), rng.uniform(0.2, 0.8, n), rng.normal(0, 0.01, n),
            rng.uniform(0.1, 0.2, n), rng.uniform(0.2, 0.3, n)]


def _port_smoother(cols):
    c, out = initial_smoother(), []
    for i in range(len(cols[0])):
        c, o = smoother_step(c, tuple(torch.tensor(a[i], dtype=torch.float64) for a in cols))
        out.append([float(v) for v in o])
    return np.array(out)


def test_smoother_step_equals_jax_step():
    cols = _raw_samples()
    got = _port_smoother(cols)
    c, want = jax_smoother.initial_smoother(jnp.float64), []
    for i in range(len(cols[0])):
        c, o = jax_smoother.smoother_step(c, tuple(jnp.asarray(a[i], jnp.float64) for a in cols))
        want.append([float(v) for v in o])
    np.testing.assert_array_equal(got, np.array(want))


def test_smoother_step_against_jax_scan_and_host_oracle():
    cols = _raw_samples()
    got = _port_smoother(cols)
    _, out = jax.lax.scan(jax_smoother.smoother_step, jax_smoother.initial_smoother(jnp.float64),
                          tuple(jnp.asarray(a, jnp.float64) for a in cols))
    np.testing.assert_allclose(got, np.stack([np.asarray(o) for o in out], axis=1), atol=1e-12,
                               rtol=0)
    host = jax_streaming._CausalSmoother()
    want = np.array([host.push(*(a[i] for a in cols)) for i in range(len(cols[0]))])
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    port_host = streaming._CausalSmoother()
    np.testing.assert_array_equal(
        np.array([port_host.push(*(a[i] for a in cols)) for i in range(len(cols[0]))]), want)


def _fuzz(trial):
    """One noisy sinusoidal bar path of the fuzz in tests/test_velocity_jax.py."""
    rng = np.random.default_rng(100 + trial)
    n = int(rng.integers(120, 400))
    t = np.arange(n) / 30.0
    y = (0.5 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.1, 0.6) * t)
         + rng.normal(0, 0.002, n))
    x = 0.4 + rng.normal(0, 0.005, n)
    nph = np.full(n, 0.16) + rng.normal(0, 0.01, n)
    npw = np.full(n, 0.28) + rng.normal(0, 0.01, n)
    return [t, x, y, np.gradient(y), nph, npw]


@pytest.mark.parametrize("chunk", [7, 64])
@pytest.mark.parametrize("trial", [0, 1])
def test_streaming_analyzer_matches_jax(chunk, trial):
    cols = _fuzz(trial)
    want_an = jax_streaming.StreamingAnalyzer(plate_diameter=PLATE_DIAMETER)
    got_an = streaming.StreamingAnalyzer(plate_diameter=PLATE_DIAMETER, device="cpu")
    mid = []
    for i in range(0, len(cols[0]), chunk):
        for an in (want_an, got_an):
            an.push_chunk(*(c[i:i + chunk] for c in cols))
        mid.append((len(want_an.phases(include_open=False)),
                    len(got_an.phases(include_open=False))))
    assert all(a == b for a, b in mid)  # live readings agree chunk by chunk
    want, got = want_an.phases(), got_an.phases()
    assert len(want) >= 3 and len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.type, g.time_start, g.time_end) == (w.type, w.time_start, w.time_end)
        for f in ("y_start", "y_end", "rom"):
            assert getattr(g, f) == pytest.approx(getattr(w, f), rel=1e-12, abs=0)


def _assert_state_equal(got, want, atol):
    for name, g, w in zip(got._fields, got, want):
        g, w = g[0].numpy(), np.asarray(w)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("name", ["ocsort_gap_ocr_oru", "ocsort_gap_skip_empty",
                                  "ocsort_crossing", "sort_dropout"])
@pytest.mark.parametrize("chunk", [7, 64])
def test_track_chunk_matches_jax(name, chunk):
    kind, kw, (dets, valid), skip = tracker_cases(8)[name]
    cfg = getattr(ScanTrackerConfig, kind)(**kw)
    jcfg = getattr(jax_scan.ScanTrackerConfig, kind)(**kw)
    state = init_state(cfg, 1, torch.float64)
    jstate = jax_scan.init_state(jcfg, dtype=jnp.float64)
    parts = []
    for a in range(0, dets.shape[0], chunk):
        d, v = dets[a:a + chunk], valid[a:a + chunk]
        state, out = streaming.track_chunk(cfg, state, torch.from_numpy(d), torch.from_numpy(v),
                                           skip)
        jstate, want = jax_streaming.track_chunk(jcfg, jstate, jnp.asarray(d, jnp.float64),
                                                 jnp.asarray(v), skip)
        rep = np.asarray(want.report)
        np.testing.assert_array_equal(out.report.numpy(), rep)
        np.testing.assert_array_equal(out.track_id.numpy()[rep], np.asarray(want.track_id)[rep])
        np.testing.assert_array_equal(out.conf.numpy()[rep], np.asarray(want.conf)[rep])
        for f in ("box", "dxdy"):
            np.testing.assert_allclose(getattr(out, f).numpy()[rep],
                                       np.asarray(getattr(want, f))[rep], atol=1e-12, rtol=0)
        _assert_state_equal(state, jstate, atol=1e-12)
        parts.append(out)
    whole = track_video(cfg, torch.from_numpy(dets), torch.from_numpy(valid), skip)
    for i, field in enumerate(whole):
        assert torch.equal(torch.cat([p[i] for p in parts]), field)


def test_run_stream_matches_jax(synthetic_video):  # noqa: F811
    kw = dict(model="unused", detection_threshold=0.5, chunk_size=32,
              plate_diameter=PLATE_DIAMETER, follow_id=1)
    want_out, got_out = io.StringIO(), io.StringIO()
    want = jax_stream.run_stream(synthetic_video, out=want_out, detector=PixelDetector(), **kw)
    got = port_stream.run_stream(synthetic_video, out=got_out, detector=PixelDetector(), **kw)
    assert got_out.getvalue() == want_out.getvalue()
    assert "session complete: 3 reps" in got_out.getvalue()
    assert [(p.type, p.time_start, p.time_end) for p in got] == [
        (p.type, p.time_start, p.time_end) for p in want]


def test_stream_cli_options_match_jax():
    def params(command):
        return {p.name: (p.opts, p.default, getattr(p, "is_flag", None)) for p in command.params}

    got = params(port_stream.make_command())
    # The port's one option beyond JAX's: the span report at the session's end.
    assert got.pop("timing") == (["--timing"], False, True)
    assert got == params(jax_stream.main)


class _Replay:
    """A detector that hands out recorded tracker rows, a chunk at a time."""

    def __init__(self, dets, valid):
        self.dets, self.valid, self.t = dets, valid, 0

    def detect_batch(self, frames):
        return frames.shape[0]

    def detections_to_tracker_inputs(self, n, threshold):
        self.t += n
        return self.dets[self.t - n:self.t], self.valid[self.t - n:self.t]


@pytest.mark.parametrize("follow_id", [1, 2])
def test_streaming_pipeline_follows_one_id_in_frame_order(follow_id):
    dets, valid = plate_detections(90, 2, miss={40, 41}, seed=5, d_cap=8)
    pipe = streaming.StreamingPipeline(_Replay(dets, valid), fps=30.0, follow_id=follow_id)
    assert pipe.tracker_dtype == torch.float64
    seen = []
    pipe.analyzer.push_chunk = lambda *cols: seen.append(np.stack(cols))
    for a in range(0, 90, 32):
        pipe.process_frames(np.zeros((min(32, 90 - a), 1, 1, 3), np.uint8))
    samples = np.concatenate(seen, axis=1)
    cfg = ScanTrackerConfig.ocsort(max_age=30, asso="diou", iou_threshold=0.1, max_tracks=16)
    out = track_video(cfg, torch.from_numpy(dets), torch.from_numpy(valid))
    t_idx, s_idx = np.nonzero(out.report.numpy() & (out.track_id.numpy() == follow_id))
    box = out.box.numpy()[t_idx, s_idx]
    np.testing.assert_array_equal(samples[0], (t_idx + 1) / 30.0)
    np.testing.assert_array_equal(samples[2], (box[:, 1] + box[:, 3]) / 2)
    assert samples.shape[1] == 88  # every frame but the two misses
    assert pipe.timer.stage_names == {"detect", "track", "select", "analysis"}
    # Beside the stages, the tracker's readbacks (the replayed detector and
    # the stand-in analysis read nothing back).
    assert set(pipe.timer.counts) == pipe.timer.stage_names | {"track.readback"}
