"""The port's host lane against the JAX package on the CPU: the assignment
solver of the host OC-SORT, the host OC-SORT itself on scenes full of ties,
and the video reader's refusal of a frame of another shape.

``linear_assignment`` is a numpy transliteration of the JAX package's
native Jonker-Volgenant solver (``vbt_tpu/native/csrc/hostops.cpp``), so
the two agree exactly, ties included, where several assignments are
optimal; scipy's solver picks other optima on such costs. The host OC-SORT
meets such ties when a frame holds the same box twice; its outputs are
compared exactly, frame by frame. The native solver comes from
``torch_hostops.native_hostops``, which builds it when the JAX package's own
in-place build did not (concurrent first imports can leave it out).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_hostops import native_hostops  # noqa: E402,F401
from vbt_tpu.tracking import OCSort as JaxOCSort  # noqa: E402
from vbt_tpu.tracking.assignment import linear_assignment as jax_linear_assignment  # noqa: E402
from vbt_tpu_torch.tracking import OCSort  # noqa: E402
from vbt_tpu_torch.tracking.assignment import linear_assignment  # noqa: E402


@pytest.fixture(autouse=True)
def native_solver(native_hostops):
    """The JAX host lane on the native JV solver, never scipy."""


@pytest.mark.parametrize("kind", ["ties", "continuous", "tracker"])
def test_linear_assignment_matches_jax(kind):
    rng = np.random.default_rng({"ties": 0, "continuous": 1, "tracker": 2}[kind])
    for _ in range(150):
        n, m = rng.integers(1, 9, size=2)
        if kind == "ties":
            cost = rng.integers(0, 3, size=(n, m)).astype(np.float64)
        elif kind == "continuous":
            cost = rng.normal(size=(n, m))
        else:  # negated affinities in [0, 1], a third of them exactly 0
            cost = -np.where(rng.uniform(size=(n, m)) < 0.3, 0.0,
                             np.round(rng.uniform(size=(n, m)), 2))
        np.testing.assert_array_equal(linear_assignment(cost), jax_linear_assignment(cost))


def test_linear_assignment_shapes():
    assert linear_assignment(np.zeros((0, 3))).shape == (0, 2)
    np.testing.assert_array_equal(linear_assignment(np.array([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5]])),
                                  [[0, 1], [1, 0]])


def _duplicate_scene(rng, n_frames=12):
    """Boxes on a 0.25 grid, some repeated exactly within a frame."""
    frames = []
    for _ in range(n_frames):
        k = int(rng.integers(1, 5))
        cells = rng.integers(0, 3, size=(k, 2)) * 0.25
        boxes = np.concatenate([cells, cells + 0.25 + 0.05 * rng.integers(0, 2, (k, 1))], 1)
        boxes = np.concatenate([boxes, boxes[rng.integers(0, k, size=int(rng.integers(0, 3)))]])
        scores = np.round(rng.uniform(0.5, 1.0, size=(len(boxes), 1)), 1)
        frames.append(np.concatenate([boxes, scores, np.zeros((len(boxes), 1))], 1))
    return frames


@pytest.mark.parametrize("seed", range(4))
def test_host_ocsort_matches_jax_on_duplicate_detections(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        frames = _duplicate_scene(rng)
        want_t = JaxOCSort(max_age=30, asso_func="diou", iou_threshold=0.1)
        got_t = OCSort(max_age=30, asso_func="diou", iou_threshold=0.1)
        for rows in frames:
            np.testing.assert_array_equal(got_t.update(rows, []), want_t.update(rows, []))


class _FakeCapture:
    """A capture that reports 8x10 frames and decodes one of 6x10 third."""

    def __init__(self, path):
        self.n = 0

    def isOpened(self):
        return True

    def get(self, prop):
        import cv2

        return {cv2.CAP_PROP_FPS: 30.0, cv2.CAP_PROP_FRAME_WIDTH: 10,
                cv2.CAP_PROP_FRAME_HEIGHT: 8}[prop]

    def read(self):
        self.n += 1
        return True, np.full((8 if self.n != 3 else 6, 10, 3), self.n, np.uint8)

    def release(self):
        pass


def test_video_reader_raises_on_a_frame_of_another_shape(monkeypatch):
    cv2 = pytest.importorskip("cv2")
    from vbt_tpu_torch.io.video import VideoReader

    monkeypatch.setattr(cv2, "VideoCapture", _FakeCapture)
    with pytest.raises(ValueError, match="decoded frame"):
        for _ in VideoReader("fake.mp4", batch_size=4):
            pass
