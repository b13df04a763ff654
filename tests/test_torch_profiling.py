"""``utils.profiling.trace`` and ``vbt-torch-track --profile_dir`` on the CPU.

``trace(dir)`` writes one TensorBoard-loadable ``*.pt.trace.json`` (a
Chrome trace whose ``traceEvents`` hold the recorded operators) and
``trace(None)`` writes nothing; the track CLI's body with ``profile_dir``
tracks a short synthetic video on the CPU, exports its dataframe as
without it, and leaves a trace holding the forward's convolutions. That the
trace holds the CUDA kernels' launches by name is held on the card
(``chip_smoke.py`` phase 14 (c)).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cv2  # noqa: E402

from vbt_tpu_torch.cli import track as port_track  # noqa: E402
from vbt_tpu_torch.io.synthetic import plate_frames  # noqa: E402
from vbt_tpu_torch.utils.profiling import trace  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")


def _events(log_dir):
    (name,) = os.listdir(log_dir)
    assert name.endswith(".pt.trace.json")
    with open(os.path.join(log_dir, name)) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_trace_file(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)):
        torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8), torch.ones(4, 3, 3, 3)).sum()
    names = {e.get("name") for e in _events(log_dir)}
    assert "aten::conv2d" in names
    with trace(None):
        torch.ones(2).sum()
    with trace(""):
        torch.ones(2).sum()
    assert len(os.listdir(log_dir)) == 1


def test_track_cli_profile_dir(tmp_path):
    video = str(tmp_path / "plate.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (160, 120))
    for frame in plate_frames(12, 120, 160, seed=1):
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
    profile_dir, df_dir, plain_dir = (str(tmp_path / d) for d in ("trace", "dfs", "plain"))
    port_track.run([video], CKPT, 0.5, df_dir, None, False, 1, 8, False, device="cpu",
                   profile_dir=profile_dir)
    port_track.run([video], CKPT, 0.5, plain_dir, None, False, 1, 8, False, device="cpu")
    names = [e.get("name") for e in _events(profile_dir)]
    assert names.count("aten::conv2d") > 100  # two batches through the model
    (df_name,) = os.listdir(df_dir)
    assert os.listdir(plain_dir) == [df_name]
    import pandas as pd

    got, want = (pd.read_pickle(os.path.join(d, df_name)) for d in (df_dir, plain_dir))
    pd.testing.assert_frame_equal(got, want)
    assert len(got) > 0 and np.isfinite(got[["x", "y"]].to_numpy()).all()
