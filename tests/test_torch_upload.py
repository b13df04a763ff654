"""The staging ring of frame uploads on the CPU: the lending protocol, and
results equal to a plain ``.to()``.

On the card the buffers are pinned and the copies run on a copy stream
(tests/test_torch_cuda.py holds that lane); on the CPU the same protocol
runs on ordinary memory, so this file checks the protocol itself: a buffer
is not lent again while it is lent and not uploaded, the ring cycles, an
upload equals the frames it was given, a lent buffer goes up without a host
copy, and the video reader decodes into the buffers it is lent.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from vbt_tpu_torch.io.synthetic import plate_frames  # noqa: E402
from vbt_tpu_torch.io.video import VideoReader  # noqa: E402
from vbt_tpu_torch.runtime.pipeline import DetectionPipeline  # noqa: E402
from vbt_tpu_torch.runtime.upload import RING_DEPTH, StagingRing  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
SHAPE = (2, 24, 32, 3)


def _frames(seed):
    return np.random.default_rng(seed).integers(0, 256, size=SHAPE, dtype=np.uint8)


def test_lent_buffer_is_not_lent_again_until_uploaded():
    ring = StagingRing(SHAPE, torch.device("cpu"))
    lent = [ring.lend() for _ in range(RING_DEPTH)]
    assert len({a.__array_interface__["data"][0] for a in lent}) == RING_DEPTH
    with pytest.raises(RuntimeError, match="not uploaded"):
        ring.lend()  # the first buffer is still lent
    for i, buf in enumerate(lent):
        buf[...] = _frames(i)
        assert ring.index_of(buf) == i
        got = ring.upload(buf)
        assert torch.equal(got, torch.from_numpy(_frames(i)).to("cpu"))
        buf[...] = 0  # the upload holds its own copy
        assert torch.equal(got, torch.from_numpy(_frames(i)))
    again = ring.lend()  # the ring cycles back to the first buffer
    assert again.__array_interface__["data"][0] == lent[0].__array_interface__["data"][0]


def test_foreign_array_is_copied_into_the_next_buffer():
    ring = StagingRing(SHAPE, torch.device("cpu"))
    frames = _frames(5)
    assert ring.index_of(frames) is None
    got = ring.upload(frames)
    assert torch.equal(got, torch.from_numpy(frames))
    np.testing.assert_array_equal(ring.buffers[0].numpy(), frames)
    assert ring.lent == [False] * RING_DEPTH and ring.next == 1
    with pytest.raises(ValueError, match="ring of"):
        ring.upload(frames[:1])


def test_pipeline_detects_lent_and_plain_batches_alike():
    pipe = DetectionPipeline.from_model_arg(CKPT, device="cpu")
    frames = plate_frames(2, 96, 128, seed=4)
    want = pipe.detect_batch(frames)
    buf = pipe.lend_frames(frames.shape)
    buf[...] = frames
    got = pipe.detect_batch(buf)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert list(pipe.rings) == [frames.shape]


def test_video_reader_decodes_into_lent_buffers(tmp_path):
    path = str(tmp_path / "v.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (64, 48))
    for frame in plate_frames(7, 48, 64, seed=2):
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
    ring = StagingRing((3, 48, 64, 3), torch.device("cpu"))
    plain = list(VideoReader(path, batch_size=3))
    lent = []
    for frames, valid, start in VideoReader(path, batch_size=3, lend=lambda shape: ring.lend()):
        assert ring.index_of(frames) is not None  # the buffer itself, no copy
        lent.append((ring.upload(frames).numpy(), valid, start))
    assert [v.sum() for _, v, _ in lent] == [3, 3, 1]
    for (a, va, sa), (b, vb, sb) in zip(lent, plain):
        n = int(va.sum())
        np.testing.assert_array_equal(a[:n], b[:n])
        np.testing.assert_array_equal(va, vb)
        assert sa == sb
