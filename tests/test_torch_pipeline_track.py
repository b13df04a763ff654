"""Port detection pipeline and track path against the JAX package on the CPU.

The same seeded synthetic plate scene goes through
``vbt_tpu.runtime.pipeline.DetectionPipeline`` (f32, XLA postprocess, the
JAX CPU lane) and ``vbt_tpu_torch.runtime.pipeline.DetectionPipeline``
(``device="cpu"``, f32, plain class-aware postprocess), then through both
``track_one(..., tracker_kind="host")`` from a cv2-written video.

Tolerances: the two forwards sum their convolutions in another order, which
moves logits and deltas by ~1e-5 (tests/test_torch_model.py); after the
sigmoid and the box decode that is ~1e-6 on scores and normalized boxes. So
rows are held at 1e-5 absolute, and the track dataframes at 1e-4 absolute,
which also covers the Kalman filter carrying those box differences into
``dx``/``dy`` (a layout or tie-break error moves them by 1e-2 or more).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from vbt_tpu.cli import track as jax_track  # noqa: E402
from vbt_tpu.contract.golden import compare_track_dfs  # noqa: E402
from vbt_tpu.contract.schema import build_df_filename as jax_df_filename  # noqa: E402
from vbt_tpu.contract.schema import build_track_df as jax_track_df  # noqa: E402
from vbt_tpu.contract.schema import max_travel_id as jax_max_travel_id  # noqa: E402
from vbt_tpu.runtime.pipeline import DetectionPipeline as JaxPipeline  # noqa: E402
from vbt_tpu_torch.cli import track as port_track  # noqa: E402
from vbt_tpu_torch.contract.schema import (  # noqa: E402
    build_df_filename,
    build_track_df,
    max_travel_id,
)
from vbt_tpu_torch.io.synthetic import plate_frames  # noqa: E402
from vbt_tpu_torch.runtime.pipeline import DetectionPipeline, resolve_model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
H, W, FPS, FRAMES, BATCH = 240, 320, 30.0, 32, 16
THRESHOLD = 0.5
ROW_ATOL = 1e-5
DF_ATOL = 1e-4


@pytest.fixture(scope="module")
def pipelines():
    jax_pipe = JaxPipeline.from_model_arg(CKPT, use_pallas=False, dtype=jnp.float32)
    return jax_pipe, DetectionPipeline.from_model_arg(CKPT, device="cpu")


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("video") / "synthetic_plate.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    for frame in plate_frames(FRAMES, H, W, seed=1):
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
    return path


def test_cpu_pipeline_policy(pipelines):
    _, port = pipelines
    assert port.device == torch.device("cpu") and port.dtype == torch.float32
    assert not port.use_kernel
    spec, ckpt = resolve_model(os.path.join(REPO, "models", "efficientdet_lite0_whole.tflite"))
    assert spec.name == "efficientdet_lite0" and ckpt == CKPT
    with pytest.raises(FileNotFoundError):
        DetectionPipeline.from_model_arg("efficientdet_lite0", device="cpu")


def test_detect_batch_matches_jax(pipelines):
    jax_pipe, port = pipelines
    frames = plate_frames(4, H, W, seed=2)
    want = jax_pipe.detect_batch(frames)
    got = port.detect_batch(frames)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    want_rows, want_valid = jax_pipe.detections_to_tracker_inputs(want, THRESHOLD)
    got_rows, got_valid = port.detections_to_tracker_inputs(got, THRESHOLD)
    np.testing.assert_array_equal(got_valid, want_valid)
    assert want_valid[:, 0].all()  # the plate is found in every frame
    np.testing.assert_allclose(got_rows, want_rows, atol=ROW_ATOL, rtol=0)


def test_track_one_host_matches_jax(pipelines, video, tmp_path):
    jax_pipe, port = pipelines
    want = jax_track.track_one(jax_pipe, video, THRESHOLD, tracker_kind="host",
                               batch_size=BATCH)
    annotated = str(tmp_path / "annotated.mp4")
    got = port_track.track_one(port, video, THRESHOLD, tracker_kind="host",
                               batch_size=BATCH, video_path=annotated)
    assert os.path.getsize(annotated) > 0
    assert len(want["id"]) >= FRAMES - 2  # a track from the second frame on
    want_df, got_df = jax_track_df(want), build_track_df(got)
    cmp = compare_track_dfs(want_df, got_df, atol=DF_ATOL)
    assert cmp.equal, cmp.problems
    model = "models/efficientdet_lite0_whole.tflite"
    assert build_df_filename(video, max_travel_id(got_df), model) == jax_df_filename(
        video, jax_max_travel_id(want_df), model)


def test_track_one_refuses_scan(pipelines, video):
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        port_track.track_one(pipelines[1], video, THRESHOLD, tracker_kind="scan")


def _params(command):
    return {p.name: (p.opts, p.default, p.is_flag if hasattr(p, "is_flag") else None)
            for p in command.params}


def test_cli_options_match_jax():
    want = _params(jax_track.main)
    got = _params(port_track.make_command())
    assert list(got) == list(want)
    for name in want:
        if name == "tracker":
            assert got[name][1] == "host" and want[name][1] == "scan"
            continue
        assert got[name] == want[name], name


@pytest.mark.parametrize("argv,item", [
    (["--tracker", "scan", "x.mp4"], "item 8"),
    (["--multi_clip", "x.mp4"], "item 10"),
    (["--time_shard", "x.mp4"], "item 10"),
    (["--profile_dir", "trace", "x.mp4"], "item 15"),
])
def test_cli_refuses_unported_flags(argv, item):
    import click

    with pytest.raises(click.UsageError, match=item):
        port_track.main(argv, standalone_mode=False)
