"""The port's analysis lane and plot CLI against the JAX package on the CPU.

- ``rolling_mean``, ``expanding_mean`` and ``shared_plate_average`` (torch,
  float64) against ``vbt_tpu.analysis.smoothing`` at 1e-12 relative, and
  their numpy forms against pandas and the JAX host forms;
- ``velocity_torch.analyze_series`` + ``to_phase_list`` against JAX
  ``analyze_series`` and against the host ``analyze_df`` (the port's and
  JAX's) on the noisy synthetic series of tests/test_velocity_jax.py: the
  same phases, type and start and end times exact, ROM and the start and
  end positions within 1e-12 relative (the lanes smooth and sum the path in
  another order: shifted-copy sums against pandas' rolling sums, prefix
  differences against a pairwise sum);
- ``plot_one`` with both engines on a dataframe written by the port's track
  CLI from a cv2-written video, against JAX ``plot_one`` on the same file;
- ``--engine jax`` (an alias of ``torch``) against ``torch`` and JAX's
  ``jax`` engine on that file, and the CLI running the torch engine on the
  card for it;
- the plot CLI's options equal ``vbt-plot``'s, whose ``--engine`` choices
  the port's extend by ``torch``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")
cv2 = pytest.importorskip("cv2")
pytest.importorskip("matplotlib")

from vbt_tpu.analysis import smoothing as jax_smoothing  # noqa: E402
from vbt_tpu.analysis.velocity import analyze_df as jax_analyze_df  # noqa: E402
from vbt_tpu.analysis.velocity_jax import analyze_series as jax_analyze_series  # noqa: E402
from vbt_tpu.analysis.velocity_jax import to_phase_list as jax_to_phase_list  # noqa: E402
from vbt_tpu.cli import plot as jax_plot  # noqa: E402
from vbt_tpu_torch.analysis import smoothing  # noqa: E402
from vbt_tpu_torch.analysis.phase import CONCENTRIC  # noqa: E402
from vbt_tpu_torch.analysis.velocity import analyze_df  # noqa: E402
from vbt_tpu_torch.analysis.velocity_torch import analyze_series, to_phase_list  # noqa: E402
from vbt_tpu_torch.cli import plot as port_plot  # noqa: E402
from vbt_tpu_torch.cli import track as port_track  # noqa: E402
from vbt_tpu_torch.io.synthetic import plate_frames  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
PLATE_DIAMETER = 0.45
COLS = ["time", "x", "y", "dx", "dy", "norm_plate_height", "norm_plate_width"]


def _t(a):
    return torch.from_numpy(np.array(a, np.float64))


@pytest.mark.parametrize("window", [5, 30])
def test_rolling_mean_matches_jax(window):
    x = np.random.default_rng(0).normal(size=501)
    want = np.asarray(jax_smoothing.rolling_mean(x, window))
    np.testing.assert_allclose(smoothing.rolling_mean(_t(x), window).numpy(), want, rtol=1e-12)
    pandas = pd.Series(x).rolling(window=window, min_periods=1).mean().to_numpy()
    np.testing.assert_allclose(smoothing.rolling_mean_np(x, window), pandas, rtol=1e-12)


def test_expanding_mean_matches_jax():
    x = np.random.default_rng(1).normal(size=257)
    want = np.asarray(jax_smoothing.expanding_mean(x))
    np.testing.assert_allclose(smoothing.expanding_mean(_t(x)).numpy(), want, rtol=1e-12)
    pandas = pd.Series(x).expanding(min_periods=1).mean().to_numpy()
    np.testing.assert_allclose(smoothing.expanding_mean_np(x), pandas, rtol=1e-12)


def test_shared_plate_average_matches_jax():
    rng = np.random.default_rng(2)
    w, h = rng.uniform(0.1, 0.3, size=400), rng.uniform(0.1, 0.3, size=400)
    want_w, want_h = jax_smoothing.shared_plate_average(w, h)
    got_w, got_h = smoothing.shared_plate_average(_t(w), _t(h))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-12)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-12)
    host_w, host_h = jax_smoothing.shared_plate_average_np(w, h)
    np_w, np_h = smoothing.shared_plate_average_np(w, h)
    np.testing.assert_array_equal(np_w, host_w)
    np.testing.assert_array_equal(np_h, host_h)


def _noise_series(trial):
    """tests/test_velocity_jax.py's fuzz series: a noisy sinusoidal bar path."""
    rng = np.random.default_rng([7, trial])
    n = int(rng.integers(50, 800))
    t = np.arange(n) / 30.0
    y = 0.5 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.1, 0.6) * t) + rng.normal(0, 0.002, n)
    x = 0.4 + rng.normal(0, 0.005, n)
    return pd.DataFrame({"time": t, "x": x, "y": y, "dx": np.gradient(x), "dy": np.gradient(y),
                         "norm_plate_height": np.full(n, 0.16) + rng.normal(0, 0.01, n),
                         "norm_plate_width": np.full(n, 0.28) + rng.normal(0, 0.01, n)})


def _assert_phases_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.type, a.time_start, a.time_end) == (b.type, b.time_start, b.time_end)
        for field in ("y_start", "y_end", "rom"):
            assert getattr(a, field) == pytest.approx(getattr(b, field), rel=1e-12, abs=0)


@pytest.mark.parametrize("trial", range(6))
def test_analyze_series_matches_jax_and_host(trial):
    df = _noise_series(trial)
    arrays = [df[c].to_numpy() for c in COLS]
    want = jax_to_phase_list(jax_analyze_series(*arrays, plate_diameter=PLATE_DIAMETER))
    got = to_phase_list(analyze_series(*arrays, plate_diameter=PLATE_DIAMETER, device="cpu"))
    assert len(want) > 0
    _assert_phases_equal(got, want)
    smoothed = port_plot.smooth_track_df(df)
    host = analyze_df(smoothed, PLATE_DIAMETER)
    _assert_phases_equal(host, jax_analyze_df(jax_plot.smooth_track_df(df), PLATE_DIAMETER))
    _assert_phases_equal(got, host)


def test_analyze_series_refuses_cuda_without_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the no-card refusal is what is tested")
    df = _noise_series(0)
    with pytest.raises(RuntimeError, match="cuda"):
        analyze_series(*[df[c].to_numpy() for c in COLS])


@pytest.fixture(scope="module")
def track_df(tmp_path_factory):
    """A dataframe written by the port's track CLI (scan tracker, CPU) from a
    96-frame video: three periods of the synthetic plate's motion."""
    root = tmp_path_factory.mktemp("plot")
    video = str(root / "plate_reps.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (320, 240))
    for frame in plate_frames(96, 240, 320, seed=3):
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
    df_dir = str(root / "dfs")
    port_track.run([video], CKPT, 0.5, df_dir, None, False, 1, 32, False, device="cpu")
    (name,) = os.listdir(df_dir)
    return os.path.join(df_dir, name)


def test_plot_one_both_engines_match_jax(track_df, tmp_path):
    want = jax_plot.plot_one(track_df, False, False, PLATE_DIAMETER, None, engine="host")
    assert sum(p.type == CONCENTRIC for p in want) >= 2
    fig_dir = str(tmp_path / "figs")
    os.makedirs(fig_dir)
    host = port_plot.plot_one(track_df, False, True, PLATE_DIAMETER, fig_dir, engine="host")
    on_torch = port_plot.plot_one(track_df, False, False, PLATE_DIAMETER, None,
                                  engine="torch", device="cpu")
    _assert_phases_equal(host, want)
    _assert_phases_equal(on_torch, want)
    assert os.listdir(fig_dir) == [os.path.basename(track_df).split(".")[0] + ".pdf"]


def test_plot_one_skips_unparsable_name(tmp_path, capsys):
    assert port_plot.plot_one(str(tmp_path / "nothing.pkl"), False, False, 0.45, None) is None
    assert "Couldn't create a plot" in capsys.readouterr().out


def test_engine_jax_is_the_torch_engine(track_df):
    """``--engine jax`` gives the torch engine's phases, and JAX's ``jax``
    engine's; the CLI runs it on the card (which this CPU run lacks)."""
    from click.testing import CliRunner

    want = jax_plot.plot_one(track_df, False, False, PLATE_DIAMETER, None, engine="jax")
    assert sum(p.type == CONCENTRIC for p in want) >= 2
    alias = port_plot.plot_one(track_df, False, False, PLATE_DIAMETER, None, engine="jax",
                               device="cpu")
    on_torch = port_plot.plot_one(track_df, False, False, PLATE_DIAMETER, None,
                                  engine="torch", device="cpu")
    _assert_phases_equal(alias, on_torch)
    _assert_phases_equal(alias, want)
    if not torch.cuda.is_available():
        result = CliRunner().invoke(port_plot.make_command(), ["--engine", "jax", track_df])
        assert isinstance(result.exception, RuntimeError)
        assert "device 'cuda' requested" in str(result.exception)


def test_plot_cli_options_match_jax():
    def params(command):
        return {p.name: (p.opts, p.default, getattr(p, "is_flag", None),
                         list(getattr(p.type, "choices", None) or [])) for p in command.params}

    want, got = params(jax_plot.main), params(port_plot.make_command())
    assert list(got) == list(want)
    for name in want:
        if name == "engine":  # the one difference: the port adds "torch"
            assert got[name][3] == want[name][3] + ["torch"]
            assert got[name][:3] == want[name][:3]
            continue
        assert got[name] == want[name], name
