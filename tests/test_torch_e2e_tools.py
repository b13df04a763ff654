"""The port's end-to-end tools against the JAX package's on the CPU.

``vbt_tpu_torch.tools.make_demo_video``, ``.e2e_acv_check`` and
``.track_e2e_bench`` against ``tools/make_demo_video.py``,
``tools/e2e_acv_check.py`` and the committed record of
``tools/track_e2e_bench.py`` (``python -m pytest`` puts the repository root
on ``sys.path``, so ``tools`` imports). The tools read the reference
project's test images, which the repository does not hold, so the test
writes a stand-in scene (``io/synthetic.py::write_demo_scene``, saved under
the JAX tool's pinned file name) and points both sides' ``DATA`` at it with
``monkeypatch``. Held:

- ``synthesize`` picks the same file, box and window, writes the same
  number of frames, the same trajectory (exactly) and the same decoded
  frames (exactly: both write with cv2's ``mp4v``);
- when no image passes the picker, both go on with the last image read;
- ``run_check`` at 1 rep / 15 fps / 2 s, the port's float32 CPU pipeline
  against JAX's (``use_pallas=False``, float32) on the same video: the same
  verdict, the same rep count, the same ``max_travel_id`` track, each
  rep's measured ROM and ACV within ``REP_RTOL`` relative (both sides round
  them to 4 decimals; the forwards agree within 1e-4,
  tests/test_torch_model.py);
- ``track_e2e_bench`` and ``e2e_acv_check``'s CLI with ``--device cpu``
  write records with the JAX records' keys plus the card's name and power
  limit, from a directory holding ``reference/data/test/`` (``DATA`` is
  relative to the working directory).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
pytest.importorskip("pandas")
pytest.importorskip("click")

from tools import e2e_acv_check as jax_check  # noqa: E402
from tools import make_demo_video as jax_video  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401
from vbt_tpu_torch.io.synthetic import write_demo_scene, write_voc  # noqa: E402
from vbt_tpu_torch.runtime.pipeline import DetectionPipeline  # noqa: E402
from vbt_tpu_torch.tools import e2e_acv_check as port_check  # noqa: E402
from vbt_tpu_torch.tools import make_demo_video as port_video  # noqa: E402
from vbt_tpu_torch.tools import track_e2e_bench as port_bench  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
REPS, FPS, SECONDS = 1, 15.0, 2.0  # the JAX package's quick lane (tests/test_e2e_acv.py)
REP_RTOL = 5e-4  # measured ROM and ACV a rep, port against JAX, both float32
PORT_DATA = port_video.DATA  # the relative default, before any fixture points it elsewhere


def _decoded(path) -> np.ndarray:
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    """A directory holding ``reference/data/test/`` with the stand-in scene
    under the pinned file name."""
    root = tmp_path_factory.mktemp("scene")
    data = root / port_video.DATA
    data.mkdir(parents=True)
    write_demo_scene(str(data), port_check.SCENE_IMAGE)
    return root


@pytest.fixture(scope="module")
def pointed(scene_root):
    """Both sides' ``DATA`` set to the stand-in's absolute directory."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_video, port_video):
            mp.setattr(module, "DATA", str(scene_root / port_video.DATA))
        yield


@pytest.fixture(scope="module")
def videos(pointed, tmp_path_factory):
    """The quick lane's video and trajectory, rendered by each side."""
    d = tmp_path_factory.mktemp("videos")
    out = {}
    for name, module in (("jax", jax_video), ("port", port_video)):
        path = str(d / f"{name}.mp4")
        frames, traj, picked = module.synthesize(path, reps=REPS, fps=FPS, seconds=SECONDS,
                                                 image=port_check.SCENE_IMAGE)
        out[name] = (path, frames, traj, picked)
    return out


@pytest.fixture(scope="module")
def checks(videos):
    """Each side's ``run_check`` on JAX's video: {side: (ok, errors, track
    id, printed rep counts)}, the track id each side's ``max_travel_id`` of
    what its ``run_check`` tracked (``track_one`` recorded on the way)."""
    from vbt_tpu.cli import track as jax_track
    from vbt_tpu.contract.schema import build_track_df as jax_build_track_df
    from vbt_tpu.contract.schema import max_travel_id as jax_max_travel_id
    from vbt_tpu.runtime.pipeline import DetectionPipeline as JaxPipeline
    from vbt_tpu_torch.cli import track as port_track
    from vbt_tpu_torch.contract.schema import build_track_df, max_travel_id

    video, _, traj, _ = videos["jax"]
    sides = {"jax": (jax_track, jax_check, jax_build_track_df, jax_max_travel_id,
                     lambda: JaxPipeline.from_model_arg(CKPT, use_pallas=False)),
             "port": (port_track, port_check, build_track_df, max_travel_id,
                      lambda: DetectionPipeline.from_model_arg(CKPT, device="cpu"))}
    out = {}
    for side, (track, check, to_df, travel_id, pipeline) in sides.items():
        tracked = []
        track_one = track.track_one

        def recording_track_one(*args, **kwargs):
            tracked.append(track_one(*args, **kwargs))
            return tracked[-1]

        printed = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(printed):
            mp.setattr(track, "track_one", recording_track_one)
            ok, errors = check.run_check(video, traj, REPS, pipeline=pipeline())
        assert len(tracked) == 1
        out[side] = (ok, errors, travel_id(to_df(tracked[0])),
                     printed.getvalue().splitlines()[0])
    return out


def test_synthesize_matches_jax(videos):
    jax_path, jax_frames, jax_traj, jax_picked = videos["jax"]
    port_path, port_frames, port_traj, port_picked = videos["port"]
    assert port_frames == jax_frames == int(SECONDS * FPS)
    assert port_picked[0] == jax_picked[0] == port_check.SCENE_IMAGE
    np.testing.assert_array_equal(port_picked[1], jax_picked[1])
    assert port_picked[2] == jax_picked[2] == (416, int(416 * 0.55))
    assert port_traj == jax_traj
    # The plate pans: the analytic y moves by most of the window.
    assert np.ptp(port_traj["y"]) > 0.5
    decoded = _decoded(port_path)
    assert decoded.shape == (port_frames, 228, 416, 3)
    np.testing.assert_array_equal(decoded, _decoded(jax_path))


def test_picker_falls_through_to_the_last_image(tmp_path, monkeypatch):
    """``write_voc``'s plates (0.6 of the height) fail the picker: both
    sides go on with the last image read, as the JAX tool does."""
    write_voc(str(tmp_path), [(240, 420), (300, 440)], n=2)
    for module in (jax_video, port_video):
        monkeypatch.setattr(module, "DATA", str(tmp_path))
    got = {}
    for name, module in (("jax", jax_video), ("port", port_video)):
        got[name] = module.synthesize(str(tmp_path / f"{name}.mp4"), reps=2, fps=10.0,
                                      seconds=1.0, trajectory_out=str(tmp_path / f"{name}.csv"))
    (jf, jt, jp), (pf, pt, pp) = got["jax"], got["port"]
    assert pp[0] == jp[0] == "plate_300x440_1.jpg"  # the last in sorted order
    np.testing.assert_array_equal(pp[1], jp[1])
    assert pp[2] == jp[2] and pf == jf == 10 and pt == jt
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()


def test_run_check_matches_jax(checks):
    jax_ok, jax_errors, jax_fid, jax_reps = checks["jax"]
    port_ok, port_errors, port_fid, port_reps = checks["port"]
    assert port_ok == jax_ok
    assert port_reps == jax_reps == f"reps: analytic {REPS}, measured {REPS} (want {REPS})"
    assert len(port_errors) == len(jax_errors) == REPS
    assert port_fid == jax_fid
    for p, j in zip(port_errors, jax_errors):
        assert p["rep"] == j["rep"]
        # The analytic side is the same analysis of the same trajectory.
        assert p["rom_true_m"] == j["rom_true_m"] and p["acv_true_ms"] == j["acv_true_ms"]
        for key in ("rom_measured_m", "acv_measured_ms"):
            assert abs(p[key] - j[key]) <= REP_RTOL * abs(j[key]), (key, p, j)


def test_track_e2e_bench_record(scene_root, monkeypatch, capsys):
    monkeypatch.chdir(scene_root)
    monkeypatch.setattr(port_video, "DATA", PORT_DATA)
    record = port_bench.main(["--device", "cpu", "--seconds", "1", "--reps", "1",
                              "--batch_size", "8", "--model", CKPT], standalone_mode=False)
    with open(os.path.join(REPO, "tools", "data_track_e2e_r5.json")) as f:
        jax_record = json.load(f)
    assert set(record) == set(jax_record) | {"device", "power_limit_w"}
    assert set(record["video"]) == set(jax_record["video"])
    assert set(record["stages_s"]) == set(jax_record["stages_s"])
    assert record["device"] == "cpu" and record["power_limit_w"] is None
    assert record["video"]["frames"] == 30 and record["video"]["resolution"] == "416x228"
    assert record["df_rows"] >= 30  # the plate tracked in every frame
    with open(scene_root / port_bench.OUT) as f:
        assert json.load(f) == record
    assert json.loads(capsys.readouterr().out) == record


def test_e2e_acv_check_cli(scene_root, checks, tmp_path, monkeypatch, capsys):
    """The CLI as a user runs it, from a directory holding the test set:
    its exit code is the verdict of ``run_check`` on the same scene."""
    monkeypatch.chdir(scene_root)
    monkeypatch.setattr(port_video, "DATA", PORT_DATA)
    out = tmp_path / "record.json"
    with pytest.raises(SystemExit) as exit_info:
        port_check.main(["--device", "cpu", "--reps", str(REPS), "--fps", str(FPS),
                         "--seconds", str(SECONDS), "--model", CKPT, "--out", str(out)])
    port_ok, port_errors = checks["port"][:2]
    assert exit_info.value.code == (0 if port_ok else 1)
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "PASS" if port_ok else "FAIL")
    record = json.loads(out.read_text())
    with open(os.path.join(REPO, "tools", "data_e2e_acv_tpu_r5.json")) as f:
        jax_record = json.load(f)
    assert set(record) == set(jax_record)
    assert set(record["serving"]) == set(jax_record["serving"]) | {"device", "power_limit_w"}
    assert record["serving"] == {"platform": "cpu", "dtype": "torch.float32",
                                 "pallas_nms": False, "device": "cpu", "power_limit_w": None}
    assert record["pass"] == port_ok and record["budget"] == port_check.BUDGET
    assert record["per_rep"] == port_errors  # the same video, the same pipeline
