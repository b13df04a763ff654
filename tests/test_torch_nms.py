"""Port postprocess and the NMS kernel's plain version against the JAX
package: ``detection_postprocess_cuda`` (on CPU tensors its wrapper runs
``nms_plain``) against ``detection_postprocess_pallas(interpret=True)``, and
the class-aware ``detection_postprocess`` against the XLA one.

Tolerances are those of tests/test_ops.py: count exact, scores 1e-6 (one
sigmoid, computed by XLA on one side and torch on the other), boxes 1e-5
(one exp in the decode, normalized coordinates)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vbt_tpu.models.anchors import AnchorConfig, generate_anchors  # noqa: E402
from vbt_tpu.ops.nms_pallas import detection_postprocess_pallas  # noqa: E402
from vbt_tpu.ops.postprocess import detection_postprocess as jax_postprocess  # noqa: E402
from vbt_tpu_torch.ops.nms_cuda import detection_postprocess_cuda, nms  # noqa: E402
from vbt_tpu_torch.ops.postprocess import (  # noqa: E402
    detection_postprocess,
    iou_matrix,
    nms_plain,
)

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

