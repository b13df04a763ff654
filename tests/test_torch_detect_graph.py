"""The detect chain served from a CUDA graph, on the card
(``runtime/graphs.py``, ``DetectionPipeline.detect_batch``).

They skip without a card. On the machine with one, run them without the
JAX test configuration (this file imports neither jax nor vbt_tpu):

    python -m pytest --noconftest -m cuda tests/test_torch_detect_graph.py

- The graphed ``detect_batch`` equals the eager chain bit for bit (count,
  scores, classes, boxes) in the plain bf16 lane, the int8 lane and the
  turbo lane (K2), lite0 with random-init weights, at the stream's
  (64, 720, 1280, 3) and at (8, 480, 640, 3); each call grows ``nms.launches``
  by 1, in the turbo lane ``fused_mbconv.launches`` and its "mma" count by
  5, in the int8 lane ``int8_matmul.calls`` by a forward's products, as an
  eager call does, whether it ran eagerly, captured or replayed; the
  capture call is served by the graph's first replay.
- Nine batches queued before any is read, as ``cli/track.py`` keeps up to 8
  in flight: every held result equals its batch's eager detections.
- Past ``MAX_RINGS`` keys the graph used longest ago is closed and its
  memory given back, and the pipeline goes on serving every key.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

SHAPES = [(64, 720, 1280), (8, 480, 640)]
LANES = ["plain", "int8", "turbo"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda", 0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


_BASES = {}


def _batches(shape, n):
    """``n`` distinct uint8 batches of ``shape``: one synthetic plate set,
    its frames in another order in each batch."""
    from vbt_tpu_torch.io.synthetic import plate_frames

    b, h, w = shape
    if shape not in _BASES:
        _BASES[shape] = plate_frames(b, h, w, seed=7, period=9)
    base = _BASES[shape]
    return [np.ascontiguousarray(np.roll(base, 5 * i + 1, axis=0)) for i in range(n)]


def _pipeline(lane, dev, calibration=None):
    from vbt_tpu_torch.models import get_model_spec
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    spec = get_model_spec("efficientdet_lite0")
    variables = DetectionPipeline.init_variables(spec, seed=3)
    pipe = DetectionPipeline(spec, variables, device=dev,
                             backbone="turbo" if lane == "turbo" else "xla")
    if lane == "int8":
        pipe = pipe.calibrate(calibration)
    return pipe


def _eager(pipe, frames):
    with torch.inference_mode():
        return pipe._eager(torch.from_numpy(frames).to(pipe.device), 0.0)


def _assert_equal(got, want):
    for name in ("count", "scores", "classes", "boxes"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _counts():
    from vbt_tpu_torch.models.quant import int8_matmul
    from vbt_tpu_torch.ops.fused_mbconv import fused_mbconv
    from vbt_tpu_torch.ops.nms_cuda import nms

    return (nms.launches, fused_mbconv.launches, fused_mbconv.launches_by_variant["mma"],
            int8_matmul.calls)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("lane", LANES)
def test_graphed_detections_equal_eager(dev, lane, shape):
    from vbt_tpu_torch.runtime.graphs import Graph
    from vbt_tpu_torch.utils.profiling import StageTimer

    batches = _batches(shape, 3)
    pipe = _pipeline(lane, dev, batches[0][:8])
    before = _counts()
    want = [_eager(pipe, b) for b in batches]
    eager = tuple((a - b) // len(batches) for a, b in zip(_counts(), before))
    per_call = 5 if lane == "turbo" else 0
    assert eager[:3] == (1, per_call, per_call) and (eager[3] > 0) == (lane == "int8")
    timer = StageTimer()
    order = [0, 1, 2, 0, 1, 2]  # eager, the capture and its first replay, replays
    for n, i in enumerate(order):
        before = _counts()
        with timer.stage("detect"):
            got = pipe.detect_batch(batches[i])
        _assert_equal(got, want[i])
        grew = tuple(a - b for a, b in zip(_counts(), before))
        assert grew == eager, (n, grew, eager)
    key = ((*shape, 3), 0.0, "exact", True)
    assert isinstance(pipe.graphs[key], Graph) and pipe.graphs.failures == 0
    assert timer.counts["detect.replay"] == len(order) - 1
    assert timer.counts["detect.forward"] == timer.counts["detect.postprocess"] == len(order)


def test_nine_batches_in_flight_keep_their_detections(dev):
    from vbt_tpu_torch.ops.nms_cuda import nms

    shape = SHAPES[0]
    batches = _batches(shape, 9)
    pipe = _pipeline("plain", dev)
    want = [_eager(pipe, b) for b in batches]
    torch.cuda.synchronize()
    before = nms.launches
    held = [pipe.detect_batch(b) for b in batches]  # nothing read until all are queued
    assert nms.launches == before + len(batches)
    for got, w in zip(held, want):
        _assert_equal(got, w)
    # Again, all of them replays now.
    held = [pipe.detect_batch(b) for b in batches]
    for got, w in zip(held, want):
        _assert_equal(got, w)


def test_eviction_past_max_rings_frees_graphs_and_keeps_serving(dev):
    from vbt_tpu_torch.runtime.pipeline import MAX_RINGS

    sizes = [(240, 320), (360, 480), (288, 512), (480, 640), (720, 1280)]
    assert len(sizes) == MAX_RINGS + 1
    pipe = _pipeline("plain", dev)
    batches = {hw: _batches((4, *hw), 1)[0] for hw in sizes}
    want = {hw: _eager(pipe, b) for hw, b in batches.items()}

    def serve(hw, calls=3):
        for _ in range(calls):
            _assert_equal(pipe.detect_batch(batches[hw]), want[hw])

    for hw in sizes[:MAX_RINGS]:
        serve(hw)
    first_key = ((4, *sizes[0], 3), 0.0, "exact", True)
    first = pipe.graphs[first_key]
    assert first.graph is not None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    serve(sizes[-1], calls=1)  # a fifth key: the first one's graph goes
    assert first.graph is None and first_key not in pipe.graphs.graphs
    assert len(pipe.graphs.graphs) == MAX_RINGS
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() < allocated
    assert torch.cuda.memory_reserved() < reserved
    serve(sizes[-1], calls=3)
    serve(sizes[0], calls=3)  # captured anew
    assert pipe.graphs[first_key].graph is not None and pipe.graphs.failures == 0
