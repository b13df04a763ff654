"""The port's ground-truth validation (``vbt-torch-kinovea``,
``vbt-torch-qualisys``) against the JAX package's, on the CPU.

The test writes its own inputs from a seed: tracking dataframes of the
synthetic plate scene (``io.synthetic.plate_boxes`` in normalized
coordinates, with Gaussian jitter, a lateral sway and a second, short
track), and exports of the scene's analytic trajectory (and the sway, in
one clip) in both formats
(``plate_track_meters``: Kinovea at 30 Hz in cm with comma decimals,
Qualisys at 100 Hz in mm with x negated and an 11-row header). Each
export directory also holds an export with no dataframe and one whose
dataframe's name does not parse.

Held: the parsers' frames equal to JAX's exactly; every ``ClipResult``
field within 1e-12 of JAX's (the same pandas operations in the same order;
the MSE is numpy's mean where JAX calls sklearn); ``latex_summary`` equal;
both CLIs through ``CliRunner`` printing the same lines as the JAX CLIs,
and one PDF a clip with ``--fig_dir``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import matplotlib  # noqa: E402

matplotlib.use("Agg")

import pandas as pd  # noqa: E402
from click.testing import CliRunner  # noqa: E402

from vbt_tpu.cli import _groundtruth as jgt  # noqa: E402
from vbt_tpu.cli import kinovea as jkinovea  # noqa: E402
from vbt_tpu.cli import qualisys as jqualisys  # noqa: E402
from vbt_tpu.contract import parsers as jparsers  # noqa: E402
from vbt_tpu_torch.cli import _groundtruth as gt  # noqa: E402
from vbt_tpu_torch.cli import kinovea, qualisys  # noqa: E402
from vbt_tpu_torch.contract import parsers  # noqa: E402
from vbt_tpu_torch.contract.schema import build_df_filename, build_track_df  # noqa: E402
from vbt_tpu_torch.io.synthetic import (  # noqa: E402
    plate_boxes,
    plate_track_meters,
    write_kinovea_export,
    write_qualisys_export,
)

H, W, FPS, PERIOD = 720, 1280, 30.0, 48
MODEL = "efficientdet_lite0_whole"
TOL = 1e-12
# name: (export writer, its suffix, its rate in Hz); the port's and JAX's
# configs of each.
FORMATS = {
    "kinovea": (write_kinovea_export, "txt", 30, kinovea, jkinovea, parsers.read_kinovea_export,
                jparsers.read_kinovea_export),
    "qualisys": (write_qualisys_export, "tsv", 100, qualisys, jqualisys,
                 parsers.read_qualisys_export, jparsers.read_qualisys_export),
}
CLIPS = {"clip_a": (150, 0), "clip_b": (211, 1)}  # frames, seed


def _tracked_df(n: int, seed: int):
    """The scene's plate as a tracker would report it, id 2, with jitter,
    a lateral sway and a second track (id 1) on a few frames."""
    rng = np.random.default_rng(seed)
    boxes = plate_boxes(n, H, W, period=PERIOD)
    cy, cx = (boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2
    cx = cx + 6.0 * np.sin(np.arange(n) / 9.0) + rng.normal(0, 1.5, n)
    cy = cy + rng.normal(0, 1.5, n)
    data = {k: [] for k in ("id", "time", "x", "y", "dx", "dy", "norm_plate_height",
                            "norm_plate_width")}
    for t in range(n):
        rows = [(2, cx[t] / W, cy[t] / H, (boxes[t, 2] - boxes[t, 0]) / H * rng.uniform(0.97, 1.03),
                 (boxes[t, 3] - boxes[t, 1]) / W * rng.uniform(0.97, 1.03))]
        if t % 17 < 4:
            rows.append((1, 0.2 + rng.uniform(0, 0.01), 0.8, 0.1, 0.06))
        for tid, x, y, ph, pw in rows:
            data["id"].append(tid)
            data["time"].append((t + 1) / FPS)
            data["x"].append(x)
            data["y"].append(y)
            data["dx"].append(rng.normal())
            data["dy"].append(rng.normal())
            data["norm_plate_height"].append(ph)
            data["norm_plate_width"].append(pw)
    return build_track_df(data)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """{format: (export_dir, df_dir)}: both formats' exports of the two clips,
    an export without a dataframe and one whose dataframe name does not
    parse."""
    root = tmp_path_factory.mktemp("groundtruth")
    df_dir = root / "dfs"
    df_dir.mkdir()
    for clip, (n, seed) in CLIPS.items():
        _tracked_df(n, seed).to_pickle(df_dir / build_df_filename(f"{clip}.mp4", 2, MODEL))
    _tracked_df(40, 5).to_pickle(df_dir / "clip_c_unparsable.pkl.gz")
    out = {}
    for name, (write, suffix, hz, *_) in FORMATS.items():
        export_dir = root / name
        export_dir.mkdir()
        for clip, (n, _) in [*CLIPS.items(), ("clip_c", (40, 0)), ("clip_lost", (60, 0))]:
            # The export covers the clip and a little more, at its own rate.
            time = np.arange(1, int((n + 8) / FPS * hz)) / hz
            x, y = plate_track_meters(time, H, W, period=PERIOD, fps=FPS)
            if clip == "clip_b":  # the tracked sway, so that r_x is defined
                x = x + 6.0 * 0.45 / (0.6 * H) * np.sin((time * FPS - 1) / 9.0)
            write(export_dir / f"{clip}.{suffix}", time, x, y)
        out[name] = (str(export_dir), str(df_dir))
    return out


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_parsers_equal_jax(tree, name):
    _, suffix, hz, _, _, read, jread = FORMATS[name]
    path = f"{tree[name][0]}/clip_a.{suffix}"
    got, want = read(path), jread(path)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert list(got.columns) == ["time", "x", "y"]
    # Meters back: the analytic trajectory to the precision written.
    x, y = plate_track_meters(got["time"].to_numpy(), H, W, period=PERIOD, fps=FPS)
    np.testing.assert_allclose(got["x"], x, atol=1e-6)
    np.testing.assert_allclose(got["y"], y, atol=1e-6)
    np.testing.assert_allclose(np.diff(got["time"]), 1 / hz, atol=2e-6)  # 6 decimals written


def _close(a: float, b: float) -> bool:
    return (np.isnan(a) and np.isnan(b)) or abs(a - b) <= TOL * max(1.0, abs(b))


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_run_validation_equals_jax(tree, name, capsys):
    _, _, _, port_cli, jax_cli, _, _ = FORMATS[name]
    export_dir, df_dir = tree[name]
    want = jgt.run_validation(export_dir, df_dir, False, None, 0.45, jax_cli.CONFIG)
    want_out = capsys.readouterr().out
    got = gt.run_validation(export_dir, df_dir, False, None, 0.45, port_cli.CONFIG)
    got_out = capsys.readouterr().out
    assert got_out == want_out and "No matching df file found for:" in got_out
    assert sorted(r.video for r in got) == ["clip_a", "clip_b"]
    assert [r.video for r in got] == [r.video for r in want]
    for g, w in zip(got, want):
        for field in ("mse_x", "mse_y", "r_x", "p_x", "r_y", "p_y"):
            assert _close(getattr(g, field), getattr(w, field)), (g.video, field, g, w)
        assert g.r_y > 0.9  # the tracked plate follows the analytic one
    assert sum(np.isfinite(r.r_x) for r in got) == 1  # clip_b's; clip_a's truth x is constant
    assert gt.latex_summary(got) == jgt.latex_summary(want)


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_cli_prints_what_jax_prints(tree, name, tmp_path):
    _, _, _, port_cli, jax_cli, _, _ = FORMATS[name]
    export_dir, df_dir = tree[name]
    flag = "--kinovea_dir" if name == "kinovea" else "--qualysis_dir"
    args = [flag, export_dir, "--df_dir", df_dir]
    runner = CliRunner()
    want = runner.invoke(jax_cli.main, args, catch_exceptions=False)
    got = runner.invoke(port_cli.make_command(), args + ["--fig_dir", str(tmp_path / "figs")],
                        catch_exceptions=False)
    assert got.exit_code == want.exit_code == 0
    assert got.output == want.output
    assert "$r_x$" in got.output and "\\texttt{clip\\_a}" in got.output
    assert ("Total MSEx = " in got.output) == (name == "kinovea")
    pdfs = sorted(p.name for p in (tmp_path / "figs").glob("*.pdf"))
    assert pdfs == [f"{clip}_id2_{MODEL}.pdf" for clip in sorted(CLIPS)]
