"""When the port's graphed entries capture and replay a CUDA graph, on the
CPU (``runtime/graphs.py``, ``DetectionPipeline.detect_batch``).

- :class:`GraphedCalls`, with a stand-in graph that runs on the CPU
  (``tests/torch_cpu_graph.py``): a key's first call runs eagerly on the
  owner's stream, its second captures and is served by the first replay,
  later ones replay; keys are evicted least recently used at the
  capacity, graphs closed; a key whose capture failed is never captured
  again, served eagerly, and the failure is counted;
- the launch counters: every kernel binding registers its own; a capture
  leaves every registered counter as it was and each replay advances it by
  the launches the graph holds, a fake kernel binding standing in for one
  a graph would take in (K3, K4);
- the pool gauge: a named owner files the largest pool it captured under
  its name (process-wide), an unnamed one files nothing, and closing a graph
  leaves the reading;
- a CPU pipeline never captures, and its ``detect.replay`` span never
  records;
- ``detect_batch``'s graph path with the stand-in graph: the key holds the
  batch shape, the score threshold and the prefilter; replays equal the
  eager detections bit for bit, results held across later replays keep
  their values, each span records once a call; a capture that raises
  leaves the key eager;
- ``benchmark/metrics/graph_share.stream.py`` reads the replays' share of
  the forwards, and nothing from a program without the span.
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from torch_cpu_graph import CpuGraph, use_cpu_graphs  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

from benchmark.core import registry  # noqa: E402
from vbt_tpu_torch.io.synthetic import plate_frames  # noqa: E402
from vbt_tpu_torch.models import get_model_spec  # noqa: E402
from vbt_tpu_torch.runtime.graphs import GraphedCalls, ReplaySpans  # noqa: E402
from vbt_tpu_torch.runtime.pipeline import MAX_RINGS, REPLAY_SPANS, DetectionPipeline  # noqa: E402
from vbt_tpu_torch.utils import profiling  # noqa: E402
from vbt_tpu_torch.utils.profiling import StageTimer, launch_counter, launch_counts  # noqa: E402

SPANS = ("detect.upload", "detect.forward", "detect.postprocess", "detect.replay")
STREAM = "the owner's stream"


def _double(inputs, scalars):
    return (inputs[0] * 2, inputs[0])


def _graphed_calls(monkeypatch, capacity, graph=CpuGraph):
    ran_on = use_cpu_graphs(monkeypatch, graph)
    return GraphedCalls(capacity, STREAM, ReplaySpans(launch="replay")), ran_on


def _serve(calls, key, n=1, fn=_double, x=None):
    """``n`` calls of ``key``: their results and how many replayed."""
    x = torch.arange(4.0) if x is None else x
    timer = StageTimer()
    with timer.stage("calls"):
        out = [calls(key, fn, [x]) for _ in range(n)]
    return out, timer.counts["replay"]


def test_first_use_is_eager_the_second_captures_later_ones_replay(monkeypatch):
    calls, ran_on = _graphed_calls(monkeypatch, 2)
    x = torch.arange(4.0)
    out, replays = _serve(calls, "a", x=x)
    assert ran_on == [STREAM] and replays == 0 and calls["a"] is None
    out, replays = _serve(calls, "a", 4, x=x)
    assert ran_on == [STREAM] and replays == 4  # the capture call is the first replay's
    graph = calls["a"]
    assert isinstance(graph, CpuGraph) and not graph.closed and calls.failures == 0
    for doubled, same in out:
        assert torch.equal(doubled, x * 2) and doubled.data_ptr() != graph.outputs[0].data_ptr()
        assert same is x  # an output that is a static input: the caller's own tensor
    assert len({t.data_ptr() for t, _ in out}) == len(out)


def test_keys_are_evicted_least_recently_used_and_their_graphs_closed(monkeypatch):
    calls, ran_on = _graphed_calls(monkeypatch, 2)
    for key in ("a", "b"):
        _serve(calls, key, 2)
    graphs = {k: calls[k] for k in ("a", "b")}
    _, replays = _serve(calls, "a")  # "b" is now the one used longest ago
    assert replays == 1
    _serve(calls, "c")
    assert list(calls.graphs) == ["a", "c"] and graphs["b"].closed and not graphs["a"].closed
    # An evicted key starts again from its first, eager, call.
    assert [_serve(calls, "b")[1], _serve(calls, "b")[1]] == [0, 1]
    assert list(calls.graphs) == ["c", "b"] and graphs["a"].closed
    # Keys seen once take places too, and cost nothing to evict.
    made, b = CpuGraph.made, calls["b"]
    for key in ("d", "e", "f"):
        assert _serve(calls, key)[1] == 0
    assert list(calls.graphs) == ["e", "f"] and b.closed and CpuGraph.made == made


def test_a_key_whose_capture_failed_is_never_captured_again(monkeypatch):
    class Failing(CpuGraph):
        def _record(self, fn):
            raise RuntimeError("operation not permitted when stream is capturing")

    calls, ran_on = _graphed_calls(monkeypatch, MAX_RINGS, Failing)
    x = torch.arange(4.0)
    _serve(calls, "a", x=x)
    with pytest.warns(RuntimeWarning, match="served eagerly"):
        out, replays = _serve(calls, "a", 4, x=x)
    assert replays == 0 and len(ran_on) == 5
    assert all(torch.equal(doubled, x * 2) for doubled, _ in out)
    assert calls.failures == 1 and "a" not in calls.graphs
    use_cpu_graphs(monkeypatch)
    _serve(calls, "b", 2)
    assert isinstance(calls["b"], CpuGraph)  # other keys are not affected


def test_every_kernel_binding_registers_its_launch_counter():
    from vbt_tpu_torch.models.quant import int8_matmul
    from vbt_tpu_torch.ops.analysis_scan_cuda import analysis_scan
    from vbt_tpu_torch.ops.batchnorm_act import batchnorm_act
    from vbt_tpu_torch.ops.fused_mbconv import VARIANTS, fused_mbconv
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.ops.track_scan_cuda import track_scan

    counts = launch_counts()
    want = [(nms, "launches"), (fused_mbconv, "launches"), (int8_matmul, "calls"),
            (track_scan, "launches"), (analysis_scan, "launches")]
    for fn, attr in want:
        assert counts[f"{fn.__module__}.{fn.__qualname__}.{attr}"] == getattr(fn, attr)
    for v in VARIANTS:
        name = f"{fused_mbconv.__module__}.fused_mbconv.launches_by_variant[{v}]"
        assert counts[name] == fused_mbconv.launches_by_variant[v]
    for k, n in batchnorm_act.launches.items():
        assert counts[f"{batchnorm_act.__module__}.batchnorm_act.launches[{k}]"] == n


def test_a_replay_advances_each_registered_counter_and_the_capture_leaves_them(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTERS", dict(profiling._COUNTERS))

    def fake_scan(x, lane):
        """A kernel binding a graph would take in, as K3 or K4."""
        fake_scan.launches += 1
        fake_scan.by_lane[lane] += 1
        return x.cumsum(0)

    launch_counter(fake_scan)
    launch_counter(fake_scan, "by_lane", ("odd", "even"))

    def chain(inputs, scalars):  # two launches a call
        return fake_scan(fake_scan(inputs[0], "odd"), "even")

    def counters():
        return fake_scan.launches, dict(fake_scan.by_lane)

    calls, _ = _graphed_calls(monkeypatch, 1)
    others = {k: n for k, n in launch_counts().items() if "fake_scan" not in k}
    assert counters() == (0, {"odd": 0, "even": 0})
    _serve(calls, "k", fn=chain)  # eager
    assert counters() == (2, {"odd": 1, "even": 1})
    graph = CpuGraph([torch.arange(4.0)], (), (), None)
    before = launch_counts()
    graph.capture(chain)  # runs the chain once on the CPU; a CUDA capture runs nothing
    assert launch_counts() == before
    base = f"{__name__}.{fake_scan.__qualname__}"
    assert {k: n for k, n in graph.launches.items() if n} == {
        f"{base}.launches": 2, f"{base}.by_lane[odd]": 1, f"{base}.by_lane[even]": 1}
    graph.replay()
    assert counters() == (4, {"odd": 2, "even": 2})
    _, replays = _serve(calls, "k", 3, fn=chain)  # the capture call, then two replays
    assert replays == 3 and counters() == (10, {"odd": 5, "even": 5})
    assert {k: n for k, n in launch_counts().items() if "fake_scan" not in k} == others


def test_a_named_owner_files_its_largest_pool(monkeypatch):
    from vbt_tpu_torch.runtime import graphs

    monkeypatch.setattr(graphs, "_POOL_BYTES", {})
    use_cpu_graphs(monkeypatch)
    named = GraphedCalls(1, STREAM, ReplaySpans(), "probe")
    _serve(named, "big", 2, x=torch.arange(64.0))
    # The stand-in's pool: its outputs (x * 2; x is a static input).
    assert named["big"].pool_bytes == 64 * 4
    _serve(named, "small", 2)  # evicts and closes the big key's graph
    assert named["small"].pool_bytes == 4 * 4
    assert graphs.pool_bytes() == {"probe": 64 * 4}
    _serve(GraphedCalls(1, STREAM, ReplaySpans()), "k", 2)
    assert graphs.pool_bytes() == {"probe": 64 * 4}


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


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_replays_equal_eager_and_held_results_keep_their_values(pipe, monkeypatch):
    ran_on = use_cpu_graphs(monkeypatch)
    monkeypatch.setattr(pipe, "graphs", GraphedCalls(MAX_RINGS, STREAM, REPLAY_SPANS))
    batches = [plate_frames(2, 96, 128, seed=s) for s in range(4)]
    want = [pipe._eager(torch.from_numpy(b), 0.0) for b in batches]
    held, spans = [], []
    for b in batches:
        det, counts = _detect(pipe, b)
        held.append(det)
        spans.append(counts)
    key = ((2, 96, 128, 3), 0.0, "exact", False)
    assert list(pipe.graphs.graphs) == [key] and ran_on == [STREAM]
    # Eager on the pipeline's stream; the capture, served by the first
    # replay; two replays.
    assert [c["detect.replay"] for c in spans] == [0, 1, 1, 1]
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
    class Failing(CpuGraph):
        def _record(self, fn):
            raise RuntimeError("operation not permitted when stream is capturing")

    use_cpu_graphs(monkeypatch, Failing)
    monkeypatch.setattr(pipe, "graphs", GraphedCalls(MAX_RINGS, STREAM, REPLAY_SPANS))
    frames = plate_frames(2, 96, 128, seed=5)
    want = pipe._eager(torch.from_numpy(frames), 0.0)
    made = CpuGraph.made
    with pytest.warns(RuntimeWarning):
        results = [_detect(pipe, frames) for _ in range(4)]
    assert CpuGraph.made == made + 1 and pipe.graphs.failures == 1
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
