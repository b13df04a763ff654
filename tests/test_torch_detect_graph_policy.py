"""When the detection pipeline captures and replays a CUDA graph, on the CPU
(``runtime/graphs.py``, ``DetectionPipeline.detect_batch``).

- :class:`CapturePolicy`: a key's first use is eager, its second captures,
  its third and later replay; keys are evicted least recently used at the
  capacity, graphs closed; a key whose capture failed is never captured
  again and the failure is counted;
- a CPU pipeline never captures, and its ``detect.replay`` span never
  records;
- ``detect_batch``'s graph path, with a stand-in graph that runs the same
  chain on the CPU: the key holds the batch shape, the score threshold and
  the prefilter; replays equal the eager detections bit for bit, results
  held across later replays keep their values, each span records once a
  call; a capture that raises leaves the key eager;
- ``benchmark/metrics/graph_share.stream.py`` reads the replays' share of
  the forwards, and nothing from a program without the span.
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

from benchmark.core import registry  # noqa: E402
from vbt_tpu_torch.io.synthetic import plate_frames  # noqa: E402
from vbt_tpu_torch.models import get_model_spec  # noqa: E402
from vbt_tpu_torch.runtime import pipeline as pipeline_mod  # noqa: E402
from vbt_tpu_torch.runtime.graphs import CAPTURE, EAGER, REPLAY, CapturePolicy  # noqa: E402
from vbt_tpu_torch.runtime.pipeline import MAX_RINGS, DetectionPipeline  # noqa: E402
from vbt_tpu_torch.utils.profiling import StageTimer  # noqa: E402

SPANS = ("detect.upload", "detect.forward", "detect.postprocess", "detect.replay")


class _Graph:
    closed = 0

    def close(self):
        _Graph.closed += 1
        self.is_closed = True


def test_first_use_is_eager_the_second_captures_later_ones_replay():
    policy = CapturePolicy(2)
    assert policy.use("a") == EAGER
    assert policy.use("a") == CAPTURE
    graph = _Graph()
    policy.keep("a", graph)
    assert [policy.use("a") for _ in range(3)] == [REPLAY] * 3
    assert policy["a"] is graph and policy.failures == 0


def test_keys_are_evicted_least_recently_used_and_their_graphs_closed():
    policy = CapturePolicy(2)
    graphs = {}
    for key in ("a", "b"):
        policy.use(key)
        assert policy.use(key) == CAPTURE
        policy.keep(key, graphs.setdefault(key, _Graph()))
    assert policy.use("a") == REPLAY  # "b" is now the one used longest ago
    assert policy.use("c") == EAGER
    assert list(policy.graphs) == ["a", "c"] and graphs["b"].is_closed
    assert not hasattr(graphs["a"], "is_closed")
    # An evicted key starts again from its first, eager use.
    assert [policy.use("b"), policy.use("b")] == [EAGER, CAPTURE]
    policy.keep("b", _Graph())
    assert list(policy.graphs) == ["c", "b"] and graphs["a"].is_closed
    # Keys seen once take places too, and cost nothing to evict.
    before = _Graph.closed
    for key in ("d", "e", "f"):
        assert policy.use(key) == EAGER
    assert len(policy.graphs) == 2 and _Graph.closed == before + 1


def test_a_key_whose_capture_failed_is_never_captured_again():
    policy = CapturePolicy(MAX_RINGS)
    policy.use("a")
    assert policy.use("a") == CAPTURE
    with pytest.warns(RuntimeWarning, match="served eagerly"):
        policy.refuse("a", RuntimeError("operation not permitted when stream is capturing"))
    assert [policy.use("a") for _ in range(4)] == [EAGER] * 4
    assert policy.failures == 1 and "a" not in policy.graphs
    policy.use("b")
    assert policy.use("b") == CAPTURE  # other keys are not affected


@pytest.fixture(scope="module")
def pipe():
    spec = get_model_spec("efficientdet_lite0")
    return DetectionPipeline(spec, DetectionPipeline.init_variables(spec, seed=1), device="cpu")


def _detect(pipe, frames, **kw):
    timer = StageTimer()
    with timer.stage("detect"):
        det = pipe.detect_batch(frames, **kw)
    return det, {n: timer.counts[n] for n in SPANS}


def test_a_cpu_pipeline_never_captures(pipe):
    frames = plate_frames(2, 96, 128, seed=0)
    assert pipe.graphs is None
    for _ in range(3):
        _, counts = _detect(pipe, frames)
        assert counts == {"detect.upload": 1, "detect.forward": 1, "detect.postprocess": 1,
                          "detect.replay": 0}


class _CpuGraph:
    """``ChainGraph``'s protocol on the CPU: the captured chain runs again
    on each replay and writes its outputs into the same tensors."""

    def __init__(self, x):
        self.input = x.clone()
        self.closed = False

    def warm_up(self, fn):
        return fn(self.input)

    def capture(self, fn):
        self.fn = fn
        self.outputs = fn(self.input)

    def load(self, x):
        self.input.copy_(x)

    def replay(self):
        for out, new in zip(self.outputs, self.fn(self.input)):
            out.copy_(new)

    def close(self):
        self.closed = True


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_replays_equal_eager_and_held_results_keep_their_values(pipe, monkeypatch):
    monkeypatch.setattr(pipeline_mod, "ChainGraph", _CpuGraph)
    monkeypatch.setattr(pipe, "graphs", CapturePolicy(MAX_RINGS))
    batches = [plate_frames(2, 96, 128, seed=s) for s in range(4)]
    want = [pipe._eager(torch.from_numpy(b), 0.0) for b in batches]
    held, spans = [], []
    for b in batches:
        det, counts = _detect(pipe, b)
        held.append(det)
        spans.append(counts)
    key = ((2, 96, 128, 3), 0.0, "exact", False)
    assert list(pipe.graphs.graphs) == [key]
    # Eager, eager on the graph's stream (then the capture), two replays.
    assert [c["detect.replay"] for c in spans] == [0, 0, 1, 1]
    assert all(c[n] == 1 for c in spans for n in SPANS if n != "detect.replay")
    graph = pipe.graphs[key]
    for got, w in zip(held, want):
        assert _equal(got, w)
        assert all(t.data_ptr() != o.data_ptr() for t, o in zip(got, graph.outputs))
    # The threshold and the prefilter are keys of their own.
    _detect(pipe, batches[0], score_threshold=0.25)
    monkeypatch.setattr(pipe, "prefilter", "approx")
    _detect(pipe, batches[0])
    assert set(pipe.graphs.graphs) == {key, ((2, 96, 128, 3), 0.25, "exact", False),
                                       ((2, 96, 128, 3), 0.0, "approx", False)}
    assert pipe.graphs[key] is graph and not graph.closed


def test_a_failed_capture_serves_the_key_eagerly(pipe, monkeypatch):
    class Failing(_CpuGraph):
        made = 0

        def __init__(self, x):
            super().__init__(x)
            Failing.made += 1

        def capture(self, fn):
            raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(pipeline_mod, "ChainGraph", Failing)
    monkeypatch.setattr(pipe, "graphs", CapturePolicy(MAX_RINGS))
    frames = plate_frames(2, 96, 128, seed=5)
    want = pipe._eager(torch.from_numpy(frames), 0.0)
    with pytest.warns(RuntimeWarning):
        results = [_detect(pipe, frames) for _ in range(4)]
    assert Failing.made == 1 and pipe.graphs.failures == 1
    assert all(_equal(det, want) and counts["detect.replay"] == 0 for det, counts in results)


def test_graph_share_reads_replays_over_forwards():
    read = registry.metric_reader("graph_share.stream")
    run = SimpleNamespace(cell=SimpleNamespace(spans={
        "detect.forward": (2.0, 250), "detect.replay": (0.1, 250)}, counters={"chunks": 250}))
    assert read(run) == 100.0
    run.cell.spans["detect.replay"] = (0.1, 200)
    assert read(run) == pytest.approx(80.0)
    # A program without the span: nothing to read, and no error.
    run.cell.spans.pop("detect.replay")
    assert read(run) is None
    assert read(SimpleNamespace(cell=SimpleNamespace(spans={}, counters={}))) is None
