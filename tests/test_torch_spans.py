"""The port's spans and readback count (``utils/profiling.py``) on the CPU.

- a span records into the innermost open stage's timer, else into the
  process-wide one; each name keeps its last ``RECENT_CALLS`` durations;
- ``record_function`` is opened only while a ``torch.profiler`` records,
  and the program's span names then stand in the trace;
- a ``StreamingPipeline`` session (the shipped lite0 weights on the CPU, a
  synthetic plate in chunks of 4 frames) and ``DeviceDataTrainer.step``
  (a tiny spec) give the same outputs bit for bit with and without a
  profiler and an open outer stage;
- every stream span is recorded once a chunk, and the ``*.readback`` spans
  3 + 4 + 1 + 10 = 18 times in a chunk in which no phase ended, once one
  has (9 more in one where one did; the phase list reads 9 tensors, not
  10, while there is no phase yet); each train span once a step;
- the model's ``model.backbone`` and ``model.fpn`` record once a forward,
  inside ``detect.forward`` (the CPU's eager chain) and ``train.forward``;
- each per-layer reader of these spans (``benchmark/metrics``) returns a
  number from a run built of these sessions, and the nested spans sum to
  no more than their stage.
"""

import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

from benchmark.core import registry  # noqa: E402
from benchmark.drivers._detect import Recorder  # noqa: E402
from vbt_tpu_torch.io.synthetic import plate_frames  # noqa: E402
from vbt_tpu_torch.models import ModelSpec  # noqa: E402
from vbt_tpu_torch.runtime.pipeline import DetectionPipeline  # noqa: E402
from vbt_tpu_torch.runtime.streaming import StreamingPipeline  # noqa: E402
from vbt_tpu_torch.train.data import DetectionDataset  # noqa: E402
from vbt_tpu_torch.train.fused import DeviceDataTrainer  # noqa: E402
from vbt_tpu_torch.train.train_step import Trainer  # noqa: E402
from vbt_tpu_torch.utils import profiling  # noqa: E402
from vbt_tpu_torch.utils.profiling import StageTimer, process_timer, span, to_host  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
CHUNK, FRAMES = 4, 24
STREAM_SPANS = ("detect", "track", "select", "analysis", "detect.upload", "detect.forward",
                "detect.postprocess", "detect.readback", "track.readback",
                "analysis.readback", "phases.readback", "model.backbone", "model.fpn")
# Readbacks a stage makes each chunk (analysis: 10 where a phase ended;
# phases: 9 until the first phase has ended, 10 from then on).
READBACKS = {"detect.readback": 3, "track.readback": 4}
TRAIN_SPANS = ("train.step", "train.augment", "train.targets", "train.forward",
               "train.backward", "train.update", "model.backbone", "model.fpn")
TRAIN_STEPS = 2


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def test_a_span_records_into_the_innermost_open_stage_else_the_process_timer():
    outer, inner = StageTimer(), StageTimer()
    before = process_timer().counts["spans.loose"]
    with span("spans.loose"):
        pass
    with outer.stage("a"):
        with span("spans.x"):
            pass
        with inner.stage("b"):
            with span("spans.y"):
                pass
        with span("spans.z"):
            pass
    assert process_timer().counts["spans.loose"] == before + 1
    assert dict(outer.counts) == {"a": 1, "spans.x": 1, "spans.z": 1}
    assert dict(inner.counts) == {"b": 1, "spans.y": 1}
    assert "spans.x" not in process_timer().counts
    assert outer.totals["a"] >= outer.totals["spans.x"] + inner.totals["b"]


def test_the_per_call_buffer_is_bounded_and_keeps_the_last_calls():
    timer = StageTimer()
    n = profiling.RECENT_CALLS + 10
    for i in range(n):
        timer.add("x", float(i))
    assert len(timer.recent["x"]) == profiling.RECENT_CALLS
    assert list(timer.recent["x"]) == [float(i) for i in range(10, n)]
    assert timer.last("x", 3) == [float(n - 3), float(n - 2), float(n - 1)]
    assert timer.last("x", 0) == [] and timer.last("missing", 5) == []
    assert timer.counts["x"] == n and timer.totals["x"] == sum(range(n))
    with timer.stage("s"):
        for _ in range(n):
            with span("y"):
                pass
    assert len(timer.recent["y"]) == profiling.RECENT_CALLS and timer.counts["y"] == n


def test_record_function_only_under_a_profiler(monkeypatch):
    opened = []
    real = profiling.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    timer = StageTimer()
    with timer.stage("outside"):
        with span("outside.span"):
            to_host(torch.ones(2), "outside")
    assert opened == []
    with _profile() as prof:
        with timer.stage("inside"):
            with span("inside.span"):
                to_host(torch.ones(2), "inside")
    assert opened == ["inside", "inside.span", "inside.readback"]
    names = {e.name for e in prof.events()}
    assert {"inside", "inside.span", "inside.readback"} <= names
    assert timer.counts["inside.readback"] == 1


def _session(pipe, frames, traced: bool):
    """One stream session in chunks of CHUNK; the outputs, the timer, the
    readbacks of each chunk by span, and the profiler's event names."""
    timer = StageTimer()
    detector = Recorder(pipe)  # keeps every chunk's tracker rows
    detector.rows = []
    sp = StreamingPipeline(detector=detector, fps=30.0, timer=timer)
    per_chunk, names = [], set()

    def run():
        for i in range(0, len(frames), CHUNK):
            before = dict(timer.counts)
            sp.process_frames(frames[i:i + CHUNK])
            sp.phases(include_open=False)
            per_chunk.append({n: timer.counts[n] - before.get(n, 0) for n in timer.counts})
        return sp.phases()

    t0 = time.perf_counter()
    if traced:
        with _profile() as prof, StageTimer().stage("session"):
            phases = run()
        names = {e.name for e in prof.events()}
    else:
        phases = run()
    return SimpleNamespace(phases=phases, rows=detector.rows, state=sp._tracker_state,
                           timer=timer, per_chunk=per_chunk, names=names,
                           window_s=time.perf_counter() - t0)


@pytest.fixture(scope="module")
def stream_runs():
    pipe = DetectionPipeline.from_model_arg(CKPT, device="cpu")
    frames = plate_frames(FRAMES, 120, 160, seed=3)
    return _session(pipe, frames, traced=False), _session(pipe, frames, traced=True)


def test_a_stream_session_is_bit_identical_with_a_profiler_and_an_open_stage(stream_runs):
    plain, traced = stream_runs
    assert [tuple(vars(p).values()) for p in traced.phases] == [
        tuple(vars(p).values()) for p in plain.phases]
    assert len(plain.rows) == FRAMES // CHUNK
    for (r0, v0), (r1, v1) in zip(plain.rows, traced.rows):
        np.testing.assert_array_equal(r1, r0)
        np.testing.assert_array_equal(v1, v0)
    for a, b in zip(plain.state, traced.state):
        assert torch.equal(a, b)


def test_every_stream_span_is_recorded_once_a_chunk(stream_runs):
    plain, traced = stream_runs
    assert plain.phases, "the scene should end phases"
    fired, ended = 0, False
    for chunk in plain.per_chunk:
        assert all(chunk[n] == READBACKS.get(n, 1) for n in STREAM_SPANS
                   if n not in ("analysis.readback", "phases.readback")), chunk
        assert chunk["analysis.readback"] in (1, 10)
        fired += chunk["analysis.readback"] == 10
        ended = ended or chunk["analysis.readback"] == 10
        assert chunk["phases.readback"] == (10 if ended else 9)
        readbacks = sum(v for n, v in chunk.items() if n.endswith(".readback"))
        assert readbacks == 8 + chunk["phases.readback"] + 9 * (chunk["analysis.readback"] == 10)
    assert 0 < fired < len(plain.per_chunk)  # both kinds of chunk are held
    assert plain.per_chunk[-1]["phases.readback"] == 10  # so 18 a chunk with no phase end
    assert traced.per_chunk == plain.per_chunk
    assert set(STREAM_SPANS) | {"phases"} <= traced.names


def _stream_run(session):
    timer = session.timer
    cell = SimpleNamespace(spans={n: (timer.totals[n], timer.counts[n]) for n in timer.totals},
                           counters={"chunks": len(session.per_chunk)})
    return SimpleNamespace(cell=cell, trace=None, config={}, window_s=session.window_s)


def test_the_stream_readers_read_the_spans(stream_runs):
    plain, _ = stream_runs
    run = _stream_run(plain)
    got = {m: registry.metric_reader(m)(run) for m in (
        "upload_ms.stream", "forward_host_ms.stream", "postprocess_ms.stream",
        "readback_ms.stream", "readbacks.stream", "detect_ms.stream")}
    assert all(v is not None and np.isfinite(v) and v >= 0 for v in got.values()), got
    chunks = len(plain.per_chunk)
    # The chunks' readbacks and the session's final phase list's, a chunk.
    final = plain.timer.counts["phases.readback"] - sum(c["phases.readback"]
                                                        for c in plain.per_chunk)
    assert final == 10
    assert got["readbacks.stream"] == (sum(
        v for c in plain.per_chunk for n, v in c.items() if n.endswith(".readback"))
        + final) / chunks
    assert got["forward_host_ms.stream"] == pytest.approx(
        1e3 * plain.timer.totals["detect.forward"] / chunks)
    detect_readback = 1e3 * plain.timer.totals["detect.readback"] / chunks
    assert (got["upload_ms.stream"] + got["forward_host_ms.stream"]
            + got["postprocess_ms.stream"] + detect_readback) <= got["detect_ms.stream"]
    # A program without the spans: nothing to read, and no error.
    bare = SimpleNamespace(cell=SimpleNamespace(spans={"detect": (1.0, 2)},
                                                counters={"chunks": 2}))
    for m in ("upload_ms.stream", "readback_ms.stream", "readbacks.stream"):
        assert registry.metric_reader(m)(bare) is None


def _train_setup():
    rng = np.random.default_rng(0)
    size, n = 64, 8
    images = np.zeros((n, size, size, 3), np.uint8)
    boxes = np.zeros((n, 4, 4), np.float32)
    valid = np.zeros((n, 4), bool)
    for i in range(n):
        y0, x0 = rng.integers(8, 30, 2)
        images[i, y0:y0 + 24, x0:x0 + 24] = 200
        boxes[i, 0] = [y0, x0, y0 + 24, x0 + 24]
        valid[i, 0] = True
    ds = DetectionDataset(images=images, boxes=boxes, valid=valid,
                          names=[str(i) for i in range(n)])
    trainer = Trainer(ModelSpec("tiny", "lite0", size, 32, 1, 1), base_lr=0.05, total_steps=8,
                      warmup_steps=1, input_size=size, device="cpu")
    return DeviceDataTrainer(trainer, ds, None, mosaic_p=0.5), trainer.init_state(seed=0)


def _train(ddt, state, traced: bool):
    gen = torch.Generator().manual_seed(7)
    before = dict(process_timer().counts)
    outer = StageTimer()
    losses = []

    def run(state):
        for i in range(TRAIN_STEPS):
            idx = torch.arange(4 * i, 4 * i + 4)
            state, metrics = ddt.step(state, idx, gen, 0.5)
            losses.append(metrics["loss"])
        return state

    names = set()
    t0 = time.perf_counter()
    if traced:
        with _profile() as prof, outer.stage("epoch"):
            state = run(state)
        names = {e.name for e in prof.events()}
    else:
        state = run(state)
    window_s = time.perf_counter() - t0
    counts = {n: process_timer().counts[n] - before.get(n, 0) for n in TRAIN_SPANS}
    return SimpleNamespace(state=state, losses=losses, names=names, outer=outer,
                           counts=counts, window_s=window_s)


@pytest.fixture(scope="module")
def train_runs():
    ddt, state = _train_setup()
    return _train(ddt, state, traced=True), _train(ddt, state, traced=False)


def test_a_train_step_is_bit_identical_with_a_profiler_and_an_open_stage(train_runs):
    traced, plain = train_runs
    assert [float(x) for x in traced.losses] == [float(x) for x in plain.losses]
    for group in ("params", "batch_stats", "ema_params"):
        a, b = getattr(plain.state, group), getattr(traced.state, group)
        assert all(torch.equal(a[k], b[k]) for k in a), group
    assert all(torch.equal(plain.state.opt_state.trace[k], traced.state.opt_state.trace[k])
               for k in plain.state.opt_state.trace)


def test_every_train_span_is_recorded_once_a_step(train_runs):
    traced, plain = train_runs
    # With no stage open the spans go to the process-wide timer; inside the
    # outer stage, to its timer.
    assert plain.counts == {n: TRAIN_STEPS for n in TRAIN_SPANS}
    assert traced.counts == {n: 0 for n in TRAIN_SPANS}
    assert {n: traced.outer.counts[n] for n in TRAIN_SPANS} == {
        n: TRAIN_STEPS for n in TRAIN_SPANS}
    assert set(TRAIN_SPANS) <= traced.names


def test_the_train_readers_read_the_window_steps(train_runs):
    _, plain = train_runs  # the process's last program steps
    run = SimpleNamespace(cell=SimpleNamespace(spans={}, counters={"steps": TRAIN_STEPS}),
                          trace=None, config={}, window_s=plain.window_s)
    stages = ("augment_ms.train", "targets_ms.train", "forward_host_ms.train",
              "backward_host_ms.train", "update_ms.train")
    got = {m: registry.metric_reader(m)(run) for m in stages + ("step_host_share.train",)}
    assert all(v is not None and np.isfinite(v) and v > 0 for v in got.values()), got
    step_ms = 1e3 * sum(process_timer().last("train.step", TRAIN_STEPS)) / TRAIN_STEPS
    assert sum(got[m] for m in stages) <= step_ms
    assert got["augment_ms.train"] == pytest.approx(
        1e3 * sum(process_timer().last("train.augment", TRAIN_STEPS)) / TRAIN_STEPS)
    assert 0 < got["step_host_share.train"] <= 100
    # More steps than the timer kept: nothing to read.
    run.cell.counters["steps"] = profiling.RECENT_CALLS + 1
    assert registry.metric_reader("update_ms.train")(run) is None


def test_the_model_spans_nest_inside_the_forward_spans(stream_runs, train_runs):
    plain, _ = stream_runs
    timer = plain.timer
    assert timer.counts["model.backbone"] == timer.counts["model.fpn"] == len(plain.per_chunk)
    assert timer.totals["model.backbone"] + timer.totals["model.fpn"] <= timer.totals[
        "detect.forward"]
    traced, _ = train_runs
    outer = traced.outer
    assert outer.counts["model.backbone"] == outer.counts["model.fpn"] == TRAIN_STEPS
    both = [a + b for a, b in zip(outer.last("model.backbone", TRAIN_STEPS),
                                  outer.last("model.fpn", TRAIN_STEPS))]
    assert all(m <= f for m, f in zip(both, outer.last("train.forward", TRAIN_STEPS)))
    # The readers take the process-wide timer's last steps (the plain run's).
    run = SimpleNamespace(cell=SimpleNamespace(spans={}, counters={"steps": TRAIN_STEPS}),
                          trace=None, config={}, window_s=1.0)
    got = {m: registry.metric_reader(m)(run) for m in ("backbone_host_ms.train",
                                                       "fpn_host_ms.train",
                                                       "forward_host_ms.train")}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["backbone_host_ms.train"] + got["fpn_host_ms.train"] <= got[
        "forward_host_ms.train"]
