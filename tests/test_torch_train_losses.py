"""The port's training targets and losses against the JAX package's, on
the CPU, float32 on both sides (the test configuration turns on jax x64,
so every JAX input is cast to float32 explicitly).

Tolerances: ``encode_boxes``, ``focal_loss``, ``huber_loss`` and
``detection_loss`` within 1e-6 relative (the same float32 operations;
``log_sigmoid`` and the loss sums may round in another order);
``assign_targets``' labels exact (positive, ignore, class targets and the
matched box), its box targets within 1e-6 relative. The cases include no
valid ground truth, invalid padded rows, a forced match (a GT box no
anchor overlaps by 0.4) and two GT boxes that share one best anchor, where
JAX's duplicate scatter keeps the higher GT index on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vbt_tpu.models.anchors import AnchorConfig as JaxAnchorConfig  # noqa: E402
from vbt_tpu.models.anchors import encode_boxes as jax_encode_boxes  # noqa: E402
from vbt_tpu.models.anchors import generate_anchors as jax_generate_anchors  # noqa: E402
from vbt_tpu.train import losses as jl  # noqa: E402
from vbt_tpu.train.targets import assign_targets as jax_assign_targets  # noqa: E402
from vbt_tpu_torch.models.anchors import (  # noqa: E402
    AnchorConfig,
    decode_boxes,
    encode_boxes,
    generate_anchors,
)
from vbt_tpu_torch.train import losses as tl  # noqa: E402
from vbt_tpu_torch.train.targets import assign_targets  # noqa: E402

RTOL = 1e-6
SIZE = 128
SHARED = 700  # an anchor of level 3 whose box two GT boxes nearly equal


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def anchors():
    a = generate_anchors(AnchorConfig(input_size=SIZE))
    np.testing.assert_array_equal(a, jax_generate_anchors(JaxAnchorConfig(input_size=SIZE)))
    return a


def _random_boxes(rng, shape):
    yx = rng.uniform(0, SIZE * 0.8, size=(*shape, 2))
    hw = rng.uniform(4, SIZE * 0.5, size=(*shape, 2))
    return np.concatenate([yx, yx + hw], -1).astype(np.float32)


def test_encode_boxes_matches_jax_and_inverts_decode(anchors):
    rng = np.random.default_rng(0)
    boxes = _random_boxes(rng, (anchors.shape[0],))
    boxes[:7, 2:] = boxes[:7, :2]  # empty boxes hit the eps floor
    got = encode_boxes(torch.from_numpy(boxes), torch.from_numpy(anchors))
    want = jax_encode_boxes(jnp.asarray(boxes, jnp.float32), jnp.asarray(anchors, jnp.float32))
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    _close(got, want)
    back = decode_boxes(got[7:], torch.from_numpy(anchors[7:]))
    np.testing.assert_allclose(back.numpy(), boxes[7:], atol=1e-3)


def test_focal_and_huber_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 8, size=(4, 300)).astype(np.float32)
    logits[0, :4] = [-40.0, 40.0, 0.0, 1e-4]  # the clip at +-30 and the middle
    targets = (rng.uniform(size=logits.shape) < 0.3).astype(np.float32)
    _close(tl.focal_loss(torch.from_numpy(logits), torch.from_numpy(targets)),
           jl.focal_loss(jnp.asarray(logits), jnp.asarray(targets)))
    pred, tgt = (rng.normal(0, 0.3, size=(4, 300, 4)).astype(np.float32) for _ in range(2))
    _close(tl.huber_loss(torch.from_numpy(pred), torch.from_numpy(tgt)),
           jl.huber_loss(jnp.asarray(pred), jnp.asarray(tgt)))


def _jax_targets(anchors, gt, valid):
    out = jax.vmap(lambda b, v: jax_assign_targets(jnp.asarray(anchors), b, v))(
        jnp.asarray(gt, jnp.float32), jnp.asarray(valid))
    return [np.asarray(o) for o in out]


def _targets_cases(anchors):
    """(B, G) ground truth: random boxes with invalid rows; no valid box; a
    small box no anchor overlaps by 0.4 (forced); two boxes sharing their
    best anchor (G0 and G2, G1 invalid between them)."""
    rng = np.random.default_rng(2)
    b, g = 6, 5
    gt = _random_boxes(rng, (b, g))
    valid = rng.uniform(size=(b, g)) < 0.7
    valid[1] = False
    gt[2, 0] = [60.0, 60.0, 63.0, 62.0]
    valid[2, 0] = True
    yc, xc, h, w = anchors[SHARED]
    corners = np.array([yc - h / 2, xc - w / 2, yc + h / 2, xc + w / 2], np.float32)
    gt[3, :3] = [corners + 0.5, [0, 0, 0, 0], corners - 0.5]
    valid[3, :3] = [True, False, True]
    gt[4, :2] = [corners, corners + [0.0, 0.0, 0.5, 0.5]]
    valid[4, :2] = True
    return gt, valid


def test_assign_targets_matches_jax(anchors):
    gt, valid = _targets_cases(anchors)
    got = [t.numpy() for t in assign_targets(torch.from_numpy(anchors), torch.from_numpy(gt),
                                             torch.from_numpy(valid))]
    want = _jax_targets(anchors, gt, valid)
    box_t, cls_t, pos, ign = got
    np.testing.assert_array_equal(pos, want[2])
    np.testing.assert_array_equal(ign, want[3])
    np.testing.assert_array_equal(cls_t, want[1])
    assert cls_t.dtype == want[1].dtype == np.float32
    _close(box_t, want[0])
    assert not pos[1].any() and not ign[1].any()  # no valid GT
    assert pos[2].sum() >= 1  # the small box is forced onto its best anchor

    # The shared best anchor: both sides keep the higher GT index, which
    # shows in the box target (the two boxes differ).
    for i, (g_win, g_lose) in ((3, (2, 0)), (4, (1, 0))):
        iou_best = _best_anchor(anchors, gt[i, g_win])
        assert iou_best == _best_anchor(anchors, gt[i, g_lose])
        enc = encode_boxes(torch.from_numpy(gt[i, g_win]), torch.from_numpy(anchors[iou_best]))
        np.testing.assert_allclose(box_t[i, iou_best], enc.numpy(), rtol=1e-6)
        np.testing.assert_allclose(want[0][i, iou_best], enc.numpy(), rtol=1e-6)


def _best_anchor(anchors, box):
    from vbt_tpu_torch.train.targets import _corners, _pairwise_iou

    iou = _pairwise_iou(_corners(torch.from_numpy(anchors)), torch.from_numpy(box)[None, None])
    return int(torch.argmax(iou[0, :, 0]))


def test_detection_loss_matches_jax(anchors):
    gt, valid = _targets_cases(anchors)
    rng = np.random.default_rng(3)
    n = anchors.shape[0]
    deltas = rng.normal(0, 0.2, size=(gt.shape[0], n, 4)).astype(np.float32)
    logits = rng.normal(-3, 2, size=(gt.shape[0], n, 1)).astype(np.float32)
    want_t = _jax_targets(anchors, gt, valid)
    _, want = jl.detection_loss(jnp.asarray(deltas), jnp.asarray(logits),
                                *(jnp.asarray(t) for t in want_t))
    got_t = assign_targets(torch.from_numpy(anchors), torch.from_numpy(gt),
                           torch.from_numpy(valid))
    total, got = tl.detection_loss(torch.from_numpy(deltas), torch.from_numpy(logits), *got_t)
    assert got.keys() == want.keys() and total is got["loss"]
    for k in want:
        assert got[k].dtype == torch.float32, k
        _close(got[k], want[k])
