"""The port's checkpoint-selection tools and int8 shipping gate against the
JAX package's on the CPU.

A VOC directory written by ``io/synthetic.py::write_voc`` (4 train, 2
valid and 8 test plate images) and two train checkpoints written by the
port's ``vbt-torch-train`` body (lite0, warm-started from the shipped
weights, 2 epochs of 2 steps at 64 px, float32) feed both packages' tools:

- ``ckpt_sweep``: the port's lines equal those of JAX's
  ``tools/ckpt_sweep.py`` (through ``CliRunner``), character for character,
  so every AP to the printed 4 decimals;
- ``ckpt_soup.parse_sweep`` equals JAX's on a written log;
- ``ckpt_soup`` from the best candidate (``--top_k 2``) and from
  ``--seed_msgpack`` (the shipped lite0, with ``--min_step``, ``--top_k``
  and ``--metric``): the same lines as JAX's, and the ``--out`` msgpack
  byte for byte equal to JAX's (the float64 sums, the division and the
  float32 cast agree to the bit);
- each tool's click options (names, defaults, choices) are JAX's, but
  ``--data_dir``'s default: JAX's names a directory outside the
  repository, the port's is ``vbt-torch-train``'s ``data``.

``int8_delta`` calibrates the shipped lite0 on the first 2 sorted train
JPGs of the same directory and evaluates it on its 8 test images at
360x480 and 480x640, float32 on both sides:

- the ``calib set`` and ``float:`` lines equal JAX's, character for
  character;
- the int8 lane's AP, AP50 and AP75 within ``INT8_TOL`` of JAX's. The two
  int8 lanes are not bit for bit: an activation that lies on a rounding
  boundary of its int8 grid can round to neighbouring steps in the two
  forwards, which ``tests/test_torch_quant.py`` bounds at 5e-2 on the
  heads; on 8 images one box that crosses an IoU threshold moves that
  threshold's AP by up to about 1/8 and AP, the mean over ten thresholds,
  by about a tenth of that. The port's own int8 AP moves with torch's
  thread count (the float32 sums of the convolutions change order).
  Measured on this test's one thread: int8 AP 0.6425, AP50 1.0000, AP75
  0.7946 against JAX's 0.6383, 1.0000, 0.8094 (0.0042 and 0.0148 apart);
  with four threads the port gave 0.6512, 1.0000, 0.8094. Held: AP within
  0.03, AP50 and AP75 within 0.125 (one image's crossing);
- the exit codes: both packages fail the default budget 0.01 (AP75 -0.2054
  and -0.1906); the port's gate passes (0, ``OK``) with a budget of 0.25
  and fails (1, ``FAIL`` on stderr) with 0.01, the two sides of its
  measured delta, and notes a gain above the budget on stderr;
- a calibration set shorter than ``--calib_n`` raises ``SystemExit``.

Each JAX evaluation rebuilds a JAX pipeline and runs the Pallas NMS in
interpret mode over a padded batch of 32, so the file keeps their number
small: one directory for every tool, 4 sweep, 2 + 2 soup and 2 int8
evaluations on each side. JAX's tools select their own persistent compile
cache; the tests keep the one ``tests/conftest.py`` selects.
"""

import io
import os

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import click  # noqa: E402
from click.testing import CliRunner  # noqa: E402

import vbt_tpu.utils.cache as jax_cache  # noqa: E402
from tools import ckpt_soup as jax_soup  # noqa: E402
from tools import ckpt_sweep as jax_sweep  # noqa: E402
from tools import int8_delta as jax_int8  # noqa: E402
from vbt_tpu_torch.cli import train as port_train  # noqa: E402
from vbt_tpu_torch.io.synthetic import write_voc  # noqa: E402
from vbt_tpu_torch.tools import ckpt_soup, ckpt_sweep, int8_delta  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
ARCH = "efficientdet_lite0"
# (h, w) of each split's images and how many at each size.
SPLITS = {"train": (((240, 320), (288, 512)), 2), "valid": (((240, 320),), 2),
          "test": (((360, 480), (480, 640)), 4)}
INT8_TOL = {"AP": 0.03, "AP50": 0.125, "AP75": 0.125}


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_tools")
    for part, (sizes, n) in SPLITS.items():
        (root / part).mkdir()
        write_voc(str(root / part), sizes, n=n)
    return str(root)


@pytest.fixture(scope="module")
def ckpt_dir(voc, tmp_path_factory):
    out = tmp_path_factory.mktemp("run")
    port_train.train_model(ARCH, voc, str(out / "export"), epochs=2, batch_size=2,
                           train_whole_model=True, base_lr=0.01, input_size=64,
                           checkpoint_dir=str(out / "ckpt"), checkpoint_every=1,
                           init_from=CKPT, log_fn=lambda *a: None, device="cpu")
    assert sorted(os.listdir(out / "ckpt")) == ["LATEST", "step_00000001.msgpack",
                                                "step_00000002.msgpack"]
    return str(out / "ckpt")


@pytest.fixture(scope="module")
def jax_cli():
    """Invoke one of JAX's tools through ``CliRunner``, keeping the test run's
    compile cache; returns its output lines."""
    keep = jax_cache.enable_persistent_cache

    def invoke(command, args):
        jax_cache.enable_persistent_cache = lambda *a, **k: None
        try:
            result = CliRunner().invoke(command, args, catch_exceptions=False)
        finally:
            jax_cache.enable_persistent_cache = keep
        return result

    return invoke


@pytest.fixture(scope="module")
def sweeps(voc, ckpt_dir, jax_cli, tmp_path_factory):
    out = io.StringIO()
    results = ckpt_sweep.sweep(ARCH, ckpt_dir, voc, device="cpu", out=out)
    want = jax_cli(jax_sweep.main, [ARCH, ckpt_dir, "--data_dir", voc])
    log = tmp_path_factory.mktemp("sweep") / "sweep.txt"
    log.write_text(want.output)
    return out.getvalue(), want.output, results, str(log)


def test_sweep_lines_match_jax(sweeps):
    got, want, results, _ = sweeps
    assert got.splitlines() == want.splitlines()
    assert [(s, t) for s, t, _ in results] == [(1, "raw"), (1, "ema"), (2, "raw"), (2, "ema")]
    assert all(0 < m["AP"] <= 1 for _, _, m in results)


def test_parse_sweep_matches_jax(sweeps, tmp_path):
    log = tmp_path / "noisy.txt"
    log.write_text("loading...\n" + sweeps[1] + "epoch 12345 ema: AP 0.1234 AP50 0.5000 "
                   "AP75 0.0000 (rerun)\nepoch 7 best: AP 0.9\n")
    got = ckpt_soup.parse_sweep(str(log))
    assert got == jax_soup.parse_sweep(str(log))
    assert len(got) == 5 and got[-1][:2] == (12345, "ema")


def _soup_pair(jax_cli, voc, ckpt_dir, log, tmp_path, args, **kw):
    ours, theirs = tmp_path / "port.msgpack", tmp_path / "jax.msgpack"
    out = io.StringIO()
    ckpt_soup.soup(ARCH, ckpt_dir, log, data_dir=voc, out=str(ours), device="cpu", stream=out,
                   **kw)
    want = jax_cli(jax_soup.main, [ARCH, ckpt_dir, "--sweep_log", log, "--data_dir", voc,
                                   "--out", str(theirs), *args])
    return (out.getvalue().replace(str(ours), "OUT"), want.output.replace(str(theirs), "OUT"),
            ours.read_bytes(), theirs.read_bytes())


def test_soup_matches_jax(sweeps, voc, ckpt_dir, jax_cli, tmp_path):
    got, want, got_bytes, want_bytes = _soup_pair(jax_cli, voc, ckpt_dir, sweeps[3], tmp_path,
                                                  ["--top_k", "2"], top_k=2)
    assert got.splitlines() == want.splitlines()
    assert got.startswith("seed ") and got.count("\n+ ") == 1 and "final soup (" in got
    assert got_bytes == want_bytes


def test_soup_from_seed_matches_jax(sweeps, voc, ckpt_dir, jax_cli, tmp_path):
    args = ["--seed_msgpack", CKPT, "--min_step", "2", "--top_k", "1", "--metric", "AP50"]
    got, want, got_bytes, want_bytes = _soup_pair(
        jax_cli, voc, ckpt_dir, sweeps[3], tmp_path, args, seed_msgpack=CKPT, min_step=2,
        top_k=1, metric="AP50")
    assert got.splitlines() == want.splitlines()
    assert got.startswith(f"seed {CKPT}: AP50 ") and got.count("\n+ 2/") == 1
    assert got_bytes == want_bytes


def test_soup_without_candidates_raises(sweeps, voc, ckpt_dir):
    with pytest.raises(click.ClickException, match="no candidates parsed from sweep log"):
        ckpt_soup.soup(ARCH, ckpt_dir, sweeps[3], min_step=3, data_dir=voc, device="cpu")


def _options(command):
    return {p.name: (p.default, p.required, getattr(p.type, "choices", None))
            for p in command.params}


@pytest.mark.parametrize("port,jax_main", [(ckpt_sweep, jax_sweep.main),
                                           (ckpt_soup, jax_soup.main),
                                           (int8_delta, jax_int8.main)])
def test_cli_options_match_jax(port, jax_main):
    got, want = _options(port.make_command()), _options(jax_main)
    assert got.pop("data_dir")[0] == "data"
    want.pop("data_dir")
    assert got == want


@pytest.fixture(scope="module")
def runs(voc, jax_cli):
    out, err = io.StringIO(), io.StringIO()
    code, m_float, m_int8 = int8_delta.int8_delta(CKPT, voc, calib_n=2, device="cpu", out=out,
                                                  err=err)
    want = jax_cli(jax_int8.main, [CKPT, "--data_dir", voc, "--calib_n", "2"])
    return (code, out.getvalue(), err.getvalue(), m_float, m_int8), want


def _value(line, name):
    words = line.split()
    return float(words[words.index(name) + 1])


def test_calibration_and_float_lines_match_jax(runs):
    (_, out, _, _, _), want = runs
    got, want = out.splitlines(), want.output.splitlines()
    assert got[0] == want[0] == ("calib set (2): plate_240x320_0.jpg plate_240x320_1.jpg")
    assert got[1] == want[1] and got[1].startswith("float: AP ")


def test_int8_metrics_within_tolerance_of_jax(runs):
    (_, out, _, _, m_int8), want = runs
    got_line, want_line = out.splitlines()[2], want.output.splitlines()[2]
    assert got_line.startswith("int8 : AP ") and want_line.startswith("int8 : AP ")
    for name, tol in INT8_TOL.items():
        assert abs(_value(got_line, name) - _value(want_line, name)) <= tol, name
        assert _value(got_line, name) == round(m_int8[name], 4)


def test_exit_codes_and_budgets(runs):
    (code, out, err, m_float, m_int8), want = runs
    delta75 = m_int8["AP75"] - m_float["AP75"]
    assert -0.25 < delta75 < -0.01  # the default budget fails, 0.25 passes
    assert code == want.exit_code == 1
    assert out.splitlines()[3] == (f"delta: AP {m_int8['AP'] - m_float['AP']:+.4f} AP50 "
                                   f"{m_int8['AP50'] - m_float['AP50']:+.4f} AP75 "
                                   f"{delta75:+.4f} (budget -0.01)")
    assert "OK" not in out and err == "FAIL: int8 AP75 regression exceeds budget\n"
    out, err = io.StringIO(), io.StringIO()
    assert int8_delta.gate(m_float, m_int8, 0.25, out, err) == 0
    assert out.getvalue().splitlines()[-1] == "OK" and err.getvalue() == ""
    out, err = io.StringIO(), io.StringIO()
    assert int8_delta.gate(m_int8, m_float, 0.01, out, err) == 0  # a gain is only noted
    assert err.getvalue().startswith(f"note: int8 improves AP75 by {-delta75:+.4f}")


def test_short_calibration_set_raises(voc):
    with pytest.raises(SystemExit, match="only 4 readable calibration images"):
        int8_delta.calibration_frames(voc, 5, 320)
