"""The port's bench (``python -m vbt_tpu_torch.bench``) and its timing
method against the JAX package's ``bench.py`` on the CPU.

- ``_metric_name`` gives JAX's names for all 8 combinations of ``--int8``,
  ``--turbo`` and ``--approx_prefilter`` (the root ``bench.py`` is the
  oracle);
- ``main(device="cpu")`` at ``BENCH_BATCH`` 2, with the marginal loops cut
  to one trial of 1 and 3 calls (the timing's constants are read when
  called), prints one JSON line whose keys are JAX's headline keys
  (``bench.py:242-251``) plus ``device`` and ``power_limit_w``, ``mfu``
  null on the CPU, and writes the raw record;
- without a card, ``python -m vbt_tpu_torch.bench`` prints one invalid line
  naming the metric and exits 1 (nothing falls back to the CPU);
- ``_outer`` turns a child that times out into the "measurement wedged"
  verdict and one that dies without a line into the "died" verdict;
- the marginal method drops non-positive trials, keeps them in
  ``raw_trials``, and raises with ``raw_trials`` when none is left, which
  ``main`` turns into an invalid line with the trials.
"""

import itertools
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import bench as jax_bench  # noqa: E402
from vbt_tpu_torch import bench  # noqa: E402
from vbt_tpu_torch.tools import _timing  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ("--int8", "--turbo", "--approx_prefilter")
# The keys of JAX's headline (bench.py:242-251).
JAX_HEADLINE = {"metric", "value", "unit", "vs_baseline", "batch", "best_fps",
                "forward_ms_per_batch", "mfu"}


@pytest.mark.parametrize("flags", [list(c) for n in range(4)
                                   for c in itertools.combinations(FLAGS, n)])
def test_metric_name_matches_jax(flags):
    argv = ["--device", "cpu", *flags]
    assert bench._metric_name(argv) == jax_bench._metric_name(argv)


def _last_json(text):
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, text
    return json.loads(lines[0])


@pytest.fixture
def short_loops(monkeypatch):
    monkeypatch.setattr(_timing, "N_SHORT", 1)
    monkeypatch.setattr(_timing, "N_LONG", 3)
    monkeypatch.setattr(_timing, "TRIALS", 1)
    monkeypatch.setattr(bench, "BATCH", 2)


def test_main_on_cpu_prints_the_headline(short_loops, monkeypatch, tmp_path, capsys):
    raw = tmp_path / "raw.json"
    monkeypatch.setenv(bench.RAW_ENV, str(raw))
    headline = bench.main(device="cpu", prefilter="approx")
    line = _last_json(capsys.readouterr().out)
    assert line == headline
    assert set(line) == JAX_HEADLINE | {"device", "power_limit_w"}
    assert line["metric"] == jax_bench._metric_name(["--approx_prefilter"])
    assert line["mfu"] is None and line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["batch"] == 2 and line["value"] > 0 and line["best_fps"] >= line["value"]
    assert line["vs_baseline"] == round(line["value"] / 2000.0, 3)
    record = json.loads(raw.read_text())
    assert record["headline"] == line and record["n_short"] == 1 and record["n_long"] == 3
    assert len(record["detect_trials_s_per_iter"]) == 1
    assert record["checkpoint"] == "efficientdet_lite0_whole.msgpack"


def test_every_trial_non_positive_is_an_invalid_line(short_loops, monkeypatch, capsys):
    monkeypatch.setenv(bench.RAW_ENV, "0")
    monkeypatch.setattr(_timing, "timed_run", lambda fn, n: 1.0)  # long == short
    with pytest.raises(SystemExit) as exc:
        bench.main(device="cpu", int8=True)
    assert exc.value.code == 1
    line = _last_json(capsys.readouterr().out)
    assert line["invalid"] is True and line["value"] is None
    assert line["metric"] == "efficientdet_lite0_320_detection_throughput_int8"
    assert line["raw_trials_s_per_iter"] == [0.0]
    assert "no positive marginal-rate trial" in line["reason"]


def test_marginal_drops_non_positive_trials(monkeypatch):
    times = iter([1.0, 0.5, 1.0, 4.2, 1.0, 2.6])  # (short, long) per trial
    monkeypatch.setattr(_timing, "timed_run", lambda fn, n: next(times))
    m = _timing.marginal_seconds(lambda i: None, n_short=8, n_long=40, trials=3)
    raw = [(0.5 - 1.0) / 32, (4.2 - 1.0) / 32, (2.6 - 1.0) / 32]
    assert m.raw_trials == pytest.approx(raw)
    assert m.median_s == pytest.approx((raw[1] + raw[2]) / 2)
    assert m.best_s == pytest.approx(raw[2])
    times = iter([1.0, 1.0, 2.0, 1.0])
    monkeypatch.setattr(_timing, "timed_run", lambda fn, n: next(times))
    with pytest.raises(RuntimeError, match="no positive marginal-rate trial") as exc:
        _timing.marginal_seconds(lambda i: None, n_short=8, n_long=40, trials=2)
    assert exc.value.raw_trials == pytest.approx([0.0, -1.0 / 32])


def test_timed_run_reads_back_the_last_output():
    seen = []

    def fn(i):
        seen.append(i)
        return {"count": torch.tensor([i, 7])}

    assert _timing.timed_run(fn, 3) >= 0 and seen == [0, 1, 2]
    assert _timing.readback((torch.tensor([[5.0]]), None)) == 5.0


def test_bench_without_a_card_prints_one_invalid_line():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the no-card verdict is what is tested")
    env = {k: v for k, v in os.environ.items() if not k.startswith("VBT_TORCH_")}
    env["VBT_TORCH_HEALTH_RETRY_S"] = "0"
    proc = subprocess.run([sys.executable, "-m", "vbt_tpu_torch.bench", "--turbo"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    line = _last_json(proc.stdout)
    assert line["invalid"] is True and line["value"] is None
    assert line["metric"] == "efficientdet_lite0_320_detection_throughput_turbo"
    assert "torch.cuda.is_available() is False" in line["reason"]


def test_outer_reports_a_wedged_and_a_dead_child(monkeypatch, capsys):
    calls = []

    def wedged(cmd, **kw):
        calls.append((cmd, kw))
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])

    monkeypatch.setenv(bench.DEADLINE_ENV, "40")
    monkeypatch.setattr(subprocess, "run", wedged)
    assert bench._outer(["--device", "cpu", "--int8"]) == 1
    line = _last_json(capsys.readouterr().out)
    assert line["invalid"] is True and line["metric"].endswith("_int8")
    assert line["reason"].startswith("measurement wedged")
    (cmd, kw), = calls
    assert cmd[1:] == ["-m", "vbt_tpu_torch.bench", "--device", "cpu", "--int8"]
    assert 30 <= kw["timeout"] <= 40
    assert kw["env"][bench.INNER_ENV] == "1" and kw["env"]["VBT_TORCH_HEALTH_PROBE"] == "0"
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: subprocess.CompletedProcess(
        cmd, -9, stdout="", stderr="Killed\n"))
    assert bench._outer(["--device", "cpu"]) == 1
    line = _last_json(capsys.readouterr().out)
    assert line["reason"] == "bench subprocess died (rc=-9) with no JSON line"
