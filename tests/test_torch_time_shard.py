"""The port's time-shard relay and multi-device multi-clip against the JAX
package on the CPU.

``track_video_time_sharded`` over 8 CPU devices (``make_mesh(devices=...)``)
against JAX's relay over its 8-device CPU mesh and against the port's own
single scan, on the scenes of tests/test_time_shard.py (misses straddling
the 25-frame chunk edges, so the relay carries coasting tracks and ORU
freeze state; ragged T = 173), OC-SORT and SORT, float64: report and ids
exact, boxes and dxdy within 1e-12 of JAX's; bit for bit with the single
scan. Then the CLI: ``--time_shard`` and ``--multi_clip`` with the clips
axis padded to the device count, each against JAX's CLI functions on the
same videos with the same pixel detector: the same rows, ids and times;
positions and plate sizes within 1e-6 and dx/dy within 1e-4 (the port's
CLI scans in float32, JAX's in float64 under x64: rows are float32 copies
of the detections, and dx/dy carry the float32 Kalman transient the JAX
CLI documents). The relay and the multi-device split equal the port's own
single scan bit for bit.
"""

import os

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_time_shard import _scene  # noqa: E402
from tests.test_track_cli import PixelDetector, synthetic_video  # noqa: E402,F401
from vbt_tpu.cli import track as jax_track  # noqa: E402
from vbt_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from vbt_tpu.parallel.time_shard import track_video_time_sharded as jax_time_sharded  # noqa: E402
from vbt_tpu.tracking import scan as jax_scan  # noqa: E402
from vbt_tpu_torch.cli import track as port_track  # noqa: E402
from vbt_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from vbt_tpu_torch.parallel.time_shard import track_video_time_sharded  # noqa: E402
from vbt_tpu_torch.runtime.batch_runner import shard_clips  # noqa: E402
from vbt_tpu_torch.tracking.scan import ScanTrackerConfig, track_video  # noqa: E402

CPU8 = [torch.device("cpu")] * 8


class PortPixelDetector(PixelDetector):
    """The JAX tests' pixel detector with what the port's CLI asks of a
    pipeline: its device and no staging buffers to lend."""

    device = torch.device("cpu")
    lend_frames = None
ROW_ATOL, DXDY_ATOL = 1e-6, 1e-4  # see the module docstring


def _cfgs(tracker):
    if tracker == "ocsort":
        kw = dict(max_age=30, iou_threshold=0.1, asso="diou", max_tracks=8)
        return ScanTrackerConfig.ocsort(**kw), jax_scan.ScanTrackerConfig.ocsort(**kw)
    kw = dict(max_age=30, max_tracks=8)
    return ScanTrackerConfig.sort(**kw), jax_scan.ScanTrackerConfig.sort(**kw)


def _assert_tracks(got, want, atol):
    rep = np.asarray(want.report)
    np.testing.assert_array_equal(got.report.numpy(), rep)
    np.testing.assert_array_equal(got.track_id.numpy(), np.asarray(want.track_id))
    for f in ("box", "dxdy"):
        np.testing.assert_allclose(getattr(got, f).numpy()[rep], np.asarray(getattr(want, f))[rep],
                                   atol=atol, rtol=0)


@pytest.mark.parametrize("tracker", ["ocsort", "sort"])
@pytest.mark.parametrize("n_frames,miss", [
    (200, set(range(22, 28)) | set(range(95, 103))),
    (173, {50, 51}),
], ids=["200", "173"])
def test_time_sharded_matches_jax_and_single_scan(tracker, n_frames, miss):
    cfg, jcfg = _cfgs(tracker)
    dets, valid = _scene(n_frames=n_frames, miss=miss)
    out = track_video_time_sharded(cfg, dets, valid, make_mesh(devices=CPU8))
    assert out.report.shape[0] == n_frames
    _assert_tracks(out, jax_time_sharded(jcfg, dets, valid, jax_make_mesh(8)), atol=1e-12)
    single = track_video(cfg, torch.from_numpy(dets), torch.from_numpy(valid))
    for got, want in zip(out, single):
        assert torch.equal(got, want)


def test_make_mesh_and_shard_clips():
    assert make_mesh(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
    arrays = (np.arange(24.0).reshape(4, 3, 2), np.ones((4, 3), bool))
    shares = shard_clips(CPU8[:2], *arrays)
    assert len(shares) == 2
    np.testing.assert_array_equal(shares[1][0].numpy(), arrays[0][2:])
    assert all(t.is_contiguous() for share in shares for t in share)
    with pytest.raises(ValueError, match="pad"):
        shard_clips(CPU8[:3], *arrays)


def _assert_data(got, want):
    assert got["id"] == want["id"] and len(got["id"]) > 0
    np.testing.assert_allclose(got["time"], want["time"], atol=1e-12, rtol=0)
    for col in ("x", "y", "norm_plate_height", "norm_plate_width"):
        np.testing.assert_allclose(got[col], want[col], atol=ROW_ATOL, rtol=0, err_msg=col)
    for col in ("dx", "dy"):
        np.testing.assert_allclose(got[col], want[col], atol=DXDY_ATOL, rtol=0, err_msg=col)


@pytest.fixture
def cpu8(monkeypatch):
    """The CLI's devices: 8 CPU devices, as JAX's tests have 8 virtual ones."""
    monkeypatch.setattr(port_track, "job_devices", lambda device: CPU8)


def test_cli_time_shard_matches_jax(synthetic_video, cpu8):  # noqa: F811
    want = jax_track.track_one(PixelDetector(), synthetic_video, 0.5, "scan", time_shard=True)
    got = port_track.track_one(PortPixelDetector(), synthetic_video, 0.5, time_shard=True)
    _assert_data(got, want)
    plain = port_track.track_one(PortPixelDetector(), synthetic_video, 0.5)
    assert got == plain  # the relay equals one scan, bit for bit


@pytest.fixture(scope="module")
def short_video(tmp_path_factory):
    """A second clip, 70 frames of a square moving up and down."""
    path = str(tmp_path_factory.mktemp("video") / "short_square.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (320, 240))
    for t in range(70):
        frame = np.zeros((240, 320, 3), np.uint8)
        y = int(120 + 60 * np.sin(2 * np.pi * t / 35)) - 20
        cv2.rectangle(frame, (100, y), (140, y + 40), (255, 255, 255), -1)
        writer.write(frame)
    writer.release()
    return path


def test_cli_multi_clip_padded_over_devices_matches_jax(synthetic_video, short_video,  # noqa: F811
                                                        monkeypatch):
    sources = [synthetic_video, short_video]
    want = jax_track.track_many(PixelDetector(), sources, 0.5)  # 8 CPU devices: padded to 8
    monkeypatch.setattr(port_track, "job_devices", lambda device: CPU8)
    got = port_track.track_many(PortPixelDetector(), sources, 0.5)
    monkeypatch.setattr(port_track, "job_devices", lambda device: CPU8[:1])
    one = port_track.track_many(PortPixelDetector(), sources, 0.5)
    assert list(got) == sources
    for src in sources:
        _assert_data(got[src], want[src])
        assert got[src] == one[src]


def test_cli_accepts_time_shard_and_checks_each_source_in_turn(synthetic_video, tmp_path,  # noqa: F811
                                                               monkeypatch, cpu8):
    """``--time_shard`` runs; a missing SRC raises when its turn comes, after
    the videos before it were exported (``--multi_clip`` checks first)."""
    from vbt_tpu_torch.runtime import pipeline

    monkeypatch.setattr(pipeline.DetectionPipeline, "from_model_arg",
                        classmethod(lambda cls, model, device="cuda": PortPixelDetector()))
    df_dir = str(tmp_path / "dfs")
    missing = str(tmp_path / "missing.mp4")
    with pytest.raises(FileNotFoundError):
        port_track.run([synthetic_video, missing], "models/efficientdet_lite0_whole.tflite",
                       0.5, df_dir, None, False, 1, 64, False, device="cpu", time_shard=True)
    assert [n.split("_id")[0] for n in os.listdir(df_dir)] == ["synthetic_squat_3reps"]
    multi_dir = str(tmp_path / "multi")
    with pytest.raises(FileNotFoundError):
        port_track.run([synthetic_video, missing], "models/efficientdet_lite0_whole.tflite",
                       0.5, multi_dir, None, False, 1, 64, False, multi_clip=True, device="cpu")
    assert os.listdir(multi_dir) == []
