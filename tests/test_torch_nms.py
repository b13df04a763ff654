"""Port postprocess and the NMS kernel's plain version against the JAX
package: ``detection_postprocess_cuda`` (on CPU tensors its wrapper runs
``nms_plain``) against ``detection_postprocess_pallas(interpret=True)``, and
the class-aware ``detection_postprocess`` against the XLA one.

Tolerances are those of tests/test_ops.py: count exact, scores 1e-6 (one
sigmoid, computed by XLA on one side and torch on the other), boxes 1e-5
(one exp in the decode, normalized coordinates).

The pipeline's ``prefilter`` option, ``"exact"`` and ``"approx"``, on the
shipped lite0: the pipeline hands it to both postprocesses, where
``"approx"`` selects ``approx_top_k`` (the exact top-K, as
``lax.approx_max_k`` is off the TPU) and any other name the exact top-K. So
each prefilter's port pipeline is held against JAX's pipeline of the same
prefilter: JAX's head outputs through the port's kernel lane within these
bounds, and the whole ``detect_batch`` within the bounds of two forwards
(``tests/test_torch_eval.py``: scores 3e-5, boxes 1e-5); the class-aware
lane with each prefilter against JAX's XLA postprocess (which has no
prefilter) within these bounds. On both sides ``"approx"`` equals
``"exact"`` bit for bit, and an unknown name is served exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vbt_tpu.models.anchors import AnchorConfig, generate_anchors  # noqa: E402
from vbt_tpu.ops.nms_pallas import detection_postprocess_pallas  # noqa: E402
from vbt_tpu.ops.postprocess import detection_postprocess as jax_postprocess  # noqa: E402
from vbt_tpu.runtime.pipeline import DetectionPipeline as JaxPipeline  # noqa: E402
from vbt_tpu_torch.io.synthetic import plate_frames  # noqa: E402
from vbt_tpu_torch.ops.nms_cuda import detection_postprocess_cuda, nms  # noqa: E402
from vbt_tpu_torch.ops.postprocess import (  # noqa: E402
    detection_postprocess,
    iou_matrix,
    nms_plain,
)
from vbt_tpu_torch.runtime.pipeline import DetectionPipeline  # noqa: E402

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "models",
                    "efficientdet_lite0_whole.msgpack")
PREFILTERS = ("exact", "approx")
ANCHORS = generate_anchors(AnchorConfig(input_size=320))
N = ANCHORS.shape[0]


def _random_predictions(rng, batch=2, n=N, classes=1):
    """As tests/test_ops.py: background logits ~N(-4, 1) plus 8 strong,
    planted detections per image."""
    logits = rng.normal(-4.0, 1.0, size=(batch, n, classes))
    for b in range(batch):
        for idx in rng.choice(n, size=8, replace=False):
            logits[b, idx, rng.integers(classes)] = rng.uniform(2.0, 6.0)
    deltas = rng.normal(0.0, 0.2, size=(batch, n, 4))
    return deltas.astype(np.float32), logits.astype(np.float32)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-5, rtol=0)


def _kernel_lane(deltas, logits, anchors=ANCHORS, **kw):
    got = detection_postprocess_cuda(
        torch.from_numpy(deltas), torch.from_numpy(logits), torch.from_numpy(anchors),
        input_size=320, max_detections=25, **kw)
    want = detection_postprocess_pallas(
        jnp.asarray(deltas), jnp.asarray(logits), jnp.asarray(anchors),
        input_size=320, max_detections=25, interpret=True, **kw)
    return got, want


@pytest.mark.parametrize("seed", [42, 7])
def test_kernel_lane_matches_pallas_random(seed):
    got, want = _kernel_lane(*_random_predictions(np.random.default_rng(seed)))
    _assert_same(got, want)
    assert got.classes.dtype == torch.int32 and not got.classes.any()


def test_kernel_lane_exact_score_ties():
    rng = np.random.default_rng(3)
    deltas, logits = _random_predictions(rng)
    # 40 candidates share one logit: the winner among them is the lowest
    # candidate position (lax.top_k order, then lowest index).
    tied = rng.choice(N, size=40, replace=False)
    logits[:, tied, 0] = 3.0
    got, want = _kernel_lane(deltas, logits)
    _assert_same(got, want)


def test_kernel_lane_all_suppressed():
    # Every anchor decodes onto one box, so the first winner suppresses all.
    anchors = np.tile(np.array([[160.0, 160.0, 64.0, 64.0]], np.float32), (N, 1))
    deltas = np.zeros((2, N, 4), np.float32)
    _, logits = _random_predictions(np.random.default_rng(4))
    got, want = _kernel_lane(deltas, logits, anchors=anchors)
    _assert_same(got, want)
    assert got.count.tolist() == [1, 1]


def test_kernel_lane_threshold_above_every_score():
    deltas, logits = _random_predictions(np.random.default_rng(5))
    got, want = _kernel_lane(deltas, logits, score_threshold=0.999)
    _assert_same(got, want)
    assert got.count.tolist() == [0, 0]
    assert not got.scores.any() and not got.boxes.any()


def test_kernel_lane_fewer_candidates_than_k():
    # N = 300 < 512: Pallas pads to 384 lanes with -inf, the kernel takes
    # K = 300. -inf logits and logits below ~-88 give a score of exactly 0,
    # which the kernel never selects (the XLA path would).
    n = 300
    rng = np.random.default_rng(6)
    deltas, logits = _random_predictions(rng, n=n)
    logits[:, :20, 0] = -np.inf
    logits[:, 20:40, 0] = -100.0
    anchors = ANCHORS[:n]
    got, want = _kernel_lane(deltas, logits, anchors=anchors)
    _assert_same(got, want)


def test_kernel_lane_stops_at_zero_score():
    # Only 3 candidates have a nonzero score: the count stops at 3.
    n = 64
    logits = np.full((1, n, 1), -np.inf, np.float32)
    logits[0, [5, 17, 40], 0] = [1.0, 2.0, 3.0]
    anchors = ANCHORS[::300][:n]
    deltas = np.zeros((1, n, 4), np.float32)
    got, want = _kernel_lane(deltas, logits, anchors=anchors)
    _assert_same(got, want)
    assert got.count.tolist() == [3]


def _ranked_case(n, tied, far, top=6.0):
    """Candidates laid out in rank order (descending logits by index, so the
    stable top-K keeps them in place): candidate 0 wins round 1 and suppresses
    every candidate that shares its box; the candidates in ``far`` have boxes
    of their own; the candidates in ``tied`` share one logit. What is left
    after round 1 is exactly ``far``, so equal scores meet at whatever
    candidate indices ``tied`` names."""
    logits = np.linspace(top - 0.1, -4.0, n).astype(np.float32)  # strictly descending
    logits[0] = top
    lo, hi = min(tied), max(tied)
    logits[lo:hi + 1] = logits[lo]  # a sorted input's ties are one run
    anchors = np.tile(np.array([[160.0, 160.0, 64.0, 64.0]], np.float32), (n, 1))
    for slot, idx in enumerate(far):  # 8-pixel boxes on a 23 x 23 grid, none overlapping
        anchors[idx] = [8.0 + 13.0 * (slot // 23), 8.0 + 13.0 * (slot % 23), 8.0, 8.0]
    return (np.zeros((1, n, 4), np.float32), logits.reshape(1, n, 1), anchors)


@pytest.mark.parametrize("i,j", [(3, 4), (3, 19), (3, 35), (255, 256)],
                         ids=["i_i+1", "i_i+16", "i_i+32", "255_256"])
def test_kernel_lane_tie_between_two_live_candidates(i, j):
    # After round 1 only i and j (equal scores) and the tail stay live: the
    # lower index goes first, whichever lanes or warps hold the two.
    deltas, logits, anchors = _ranked_case(512, tied=(i, j), far=[i, j, 500, 501])
    got, want = _kernel_lane(deltas, logits, anchors=anchors)
    _assert_same(got, want)
    assert got.count.tolist() == [5]
    np.testing.assert_array_equal(got.scores[0, 1].numpy(), got.scores[0, 2].numpy())
    assert got.boxes[0, 1, 1] < got.boxes[0, 2, 1]  # i's box (grid slot 0) before j's (slot 1)


def test_kernel_lane_winner_in_last_slot():
    deltas, logits, anchors = _ranked_case(512, tied=(5, 5), far=[511])
    got, want = _kernel_lane(deltas, logits, anchors=anchors)
    _assert_same(got, want)
    assert got.count.tolist() == [2]
    assert got.scores[0, 1].item() == pytest.approx(1 / (1 + np.exp(4.0)), abs=1e-6)


def test_kernel_lane_k300_ties_in_last_group():
    # K = 300: the last lanes hold a partly filled group of candidates; its
    # ten equal scores come out in index order.
    far = list(range(290, 300))
    deltas, logits, anchors = _ranked_case(300, tied=(290, 299), far=far)
    got, want = _kernel_lane(deltas, logits, anchors=anchors)
    _assert_same(got, want)
    assert got.count.tolist() == [11]
    xs = got.boxes[0, 1:11, 1].numpy()
    assert (np.diff(xs) > 0).all()  # grid slots 0..9 in order


def test_kernel_lane_all_512_equal():
    deltas, logits, anchors = _ranked_case(512, tied=(0, 511), far=list(range(512)), top=1.5)
    got, want = _kernel_lane(deltas, logits, anchors=anchors)
    _assert_same(got, want)
    assert got.count.tolist() == [25]
    assert (np.diff(got.boxes[0, :23, 1].numpy()) > 0).all()  # candidates 0..22 in order


def test_nms_wrapper_checks_inputs():
    logits = torch.zeros(2, 8)
    boxes = torch.zeros(2, 8, 4)
    with pytest.raises(ValueError):
        nms(logits, torch.zeros(2, 8, 3))
    with pytest.raises(TypeError):
        nms(logits.double(), boxes)
    count, scores, out = nms(logits, boxes, max_detections=5)
    assert count.shape == (2,) and scores.shape == (2, 5) and out.shape == (2, 5, 4)
    ref = nms_plain(logits, boxes, max_detections=5)
    assert all(torch.equal(a, b) for a, b in zip((count, scores, out), ref))


def test_nms_on_cpu_does_not_launch():
    before = nms.launches
    nms(torch.zeros(1, 4), torch.zeros(1, 4, 4))
    assert nms.launches == before


@pytest.mark.parametrize("classes", [1, 3])
def test_class_aware_postprocess_matches_xla(classes):
    deltas, logits = _random_predictions(np.random.default_rng(10 + classes), classes=classes)
    got = detection_postprocess(torch.from_numpy(deltas), torch.from_numpy(logits),
                                torch.from_numpy(ANCHORS), input_size=320, max_detections=25)
    want = jax_postprocess(jnp.asarray(deltas), jnp.asarray(logits), jnp.asarray(ANCHORS),
                           input_size=320, max_detections=25)
    _assert_same(got, want)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))


def test_iou_matrix_basic():
    a = torch.tensor([[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 0.5, 0.5], [0.2, 0.2, 0.2, 0.2]])
    m = iou_matrix(a, a)
    np.testing.assert_allclose(torch.diag(m)[:2].numpy(), 1.0)
    assert m[0, 1].item() == pytest.approx(0.25)
    assert m[2, 2].item() == 0.0  # zero union guard


@pytest.fixture(scope="module")
def prefilter_lanes():
    """Each prefilter's JAX pipeline (the Pallas NMS in interpret mode) and
    its detections, each prefilter's port pipeline (CPU, the NMS kernel's
    lane: its wrapper runs ``nms_plain`` on CPU tensors) and two synthetic
    plate frames."""
    frames = plate_frames(2, 240, 320, seed=0, period=5)
    exact = JaxPipeline.from_model_arg(CKPT)
    jax_pipes = {p: dataclasses.replace(exact, prefilter=p) for p in PREFILTERS}
    jax_dets = {p: jpipe.detect_batch(jnp.asarray(frames)) for p, jpipe in jax_pipes.items()}
    pipes = {p: DetectionPipeline.from_model_arg(CKPT, device="cpu", prefilter=p)
             for p in PREFILTERS}
    for pipe in pipes.values():
        pipe.use_kernel = True
    return frames, jax_pipes, jax_dets, pipes


def _numpy(det):
    return [np.asarray(f) for f in (det.count, det.scores, det.boxes)]


@pytest.mark.parametrize("prefilter", PREFILTERS)
def test_pipeline_prefilter_matches_pallas(prefilter_lanes, prefilter):
    frames, jax_pipes, jax_dets, pipes = prefilter_lanes
    jpipe, pipe = jax_pipes[prefilter], pipes[prefilter]
    deltas, logits = jpipe._forward(jpipe.variables, jnp.asarray(frames))
    got = pipe.postprocess(torch.from_numpy(np.array(deltas, np.float32)),
                           torch.from_numpy(np.array(logits, np.float32)))
    want = jpipe._post(deltas, logits)
    _assert_same(got, want)
    assert int(got.count.min()) >= 1  # the plate is found in both frames
    got, want = pipe.detect_batch(frames), jax_dets[prefilter]
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=3e-5, rtol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-5, rtol=0)


def test_approx_prefilter_equals_exact(prefilter_lanes):
    jax_dets = prefilter_lanes[2]
    exact, approx = (_numpy(jax_dets[p]) for p in PREFILTERS)
    for a, b in zip(exact, approx):
        np.testing.assert_array_equal(a, b)
    logits = jax.random.normal(jax.random.PRNGKey(0), (4, 19206), jnp.float32)
    for a, b in zip(jax.lax.approx_max_k(logits, 512), jax.lax.top_k(logits, 512)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("prefilter", PREFILTERS)
def test_prefilter_reaches_both_postprocesses(prefilter_lanes, prefilter, monkeypatch):
    """The pipeline's name reaches the kernel lane and the class-aware lane;
    only ``"approx"`` takes ``approx_top_k``, and both lanes equal JAX's on
    the same head outputs."""
    from vbt_tpu_torch.ops import postprocess as port_post

    frames, jax_pipes, _, pipes = prefilter_lanes
    jpipe, pipe = jax_pipes[prefilter], pipes[prefilter]
    deltas, logits = jpipe._forward(jpipe.variables, jnp.asarray(frames))
    d, lg = (torch.from_numpy(np.array(a, np.float32)) for a in (deltas, logits))
    calls = []
    approx = port_post.approx_top_k
    monkeypatch.setattr(port_post, "approx_top_k",
                        lambda values, k: calls.append(k) or approx(values, k))
    _assert_same(pipe.postprocess(d, lg), jpipe._post(deltas, logits))
    pipe.use_kernel = False
    try:
        got = pipe.postprocess(d, lg)
    finally:
        pipe.use_kernel = True
    _assert_same(got, jax_postprocess(deltas, logits, jnp.asarray(ANCHORS), input_size=320,
                                      max_detections=25))
    assert calls == ([512, 512] if prefilter == "approx" else [])


def test_pipeline_takes_any_prefilter_name(prefilter_lanes):
    """As in JAX, no prefilter name is refused: it is stored, and a name
    other than ``"approx"`` is served by the exact top-K, bit for bit."""
    frames, _, _, pipes = prefilter_lanes
    for name in ("exact", "approx", "bogus"):
        assert DetectionPipeline.from_model_arg(CKPT, device="cpu",
                                                prefilter=name).prefilter == name
    pipe = pipes["exact"]
    d, lg = pipe.forward(frames)
    try:
        for use_kernel in (True, False):
            pipe.prefilter, pipe.use_kernel = "exact", use_kernel
            want = pipe.postprocess(d, lg)
            for name in ("approx", "bogus"):
                pipe.prefilter = name
                for a, b in zip(pipe.postprocess(d, lg), want):
                    torch.testing.assert_close(a, b, rtol=0, atol=0)
    finally:
        pipe.prefilter, pipe.use_kernel = "exact", True
