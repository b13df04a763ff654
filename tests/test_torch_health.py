"""The port's CUDA health probe (``vbt_tpu_torch.utils.health``) keeps the
contract of ``vbt_tpu.utils.health`` (``tests/test_health.py``), on the CPU.

The degradation windows and hangs only happen on a card; these tests run
the machinery through the ``VBT_TORCH_HEALTH_FAKE`` hook, the wedged mode
through the real subprocess-deadline kill. Cases: a CPU device skips the
probe, the opt-out, fake ok, fake slow, wedged killed within its deadline
plus slack, the retry window recovering and giving up, no retry by
default, a window too small for a retry, and a CUDA request without a card
raising. Deadlines are a few seconds.
"""

import time

import pytest

torch = pytest.importorskip("torch")

from vbt_tpu_torch.utils import health  # noqa: E402
from vbt_tpu_torch.utils.health import (  # noqa: E402
    CUDAUnhealthyError,
    HealthReport,
    probe_device,
    require_healthy_device,
)

SLACK_S = 15.0  # interpreter start and the kill, beyond the deadline


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for name in (health.FAKE_ENV, health.PROBE_ENV, health.DEADLINE_ENV, health.RETRY_ENV):
        monkeypatch.delenv(name, raising=False)


def test_cpu_device_skips_probe():
    rep = require_healthy_device("cpu")
    assert rep.ok and "skipped" in rep.reason


def test_opt_out_env(monkeypatch):
    monkeypatch.setenv(health.FAKE_ENV, "wedged")
    monkeypatch.setenv(health.PROBE_ENV, "0")
    assert require_healthy_device("cpu").ok


def test_fake_ok_passes(monkeypatch):
    monkeypatch.setenv(health.FAKE_ENV, "ok")
    rep = require_healthy_device("cpu")
    assert rep.ok and rep.forward_ms == 1.0 and rep.nms_launches == 0


def test_fake_slow_is_degradation_window(monkeypatch):
    monkeypatch.setenv(health.FAKE_ENV, "slow")
    with pytest.raises(CUDAUnhealthyError, match="degradation window"):
        require_healthy_device("cpu")


def test_wedged_card_fails_within_deadline(monkeypatch):
    """The child really sleeps; the parent must kill it at the deadline."""
    monkeypatch.setenv(health.FAKE_ENV, "wedged")
    t0 = time.perf_counter()
    rep = probe_device("cpu", deadline_s=3.0)
    assert not rep.ok and "wedged" in rep.reason
    assert time.perf_counter() - t0 < 3.0 + SLACK_S  # killed at the deadline, not hanging

    monkeypatch.setenv(health.DEADLINE_ENV, "2")  # the environment's deadline
    t0 = time.perf_counter()
    with pytest.raises(CUDAUnhealthyError, match=r"\[test\].*2s deadline"):
        require_healthy_device("cpu", context="test")
    assert time.perf_counter() - t0 < 2.0 + SLACK_S


def test_retry_window_recovers_from_transient(monkeypatch):
    monkeypatch.setenv(health.FAKE_ENV, "slow")  # defeat the CPU skip
    monkeypatch.setattr(health, "RETRY_SLEEP_S", 0.01)
    calls = {"n": 0}

    def fake_probe(device, deadline_s=None, slow_ms=None):
        calls["n"] += 1
        if calls["n"] < 3:
            return HealthReport(ok=False, reason="CUDA degradation window")
        return HealthReport(ok=True, reason="healthy", forward_ms=20.0)

    monkeypatch.setattr(health, "probe_device", fake_probe)
    rep = require_healthy_device("cpu", retry_window_s=30.0)
    assert rep.ok and calls["n"] == 3


def test_retry_window_gives_up(monkeypatch):
    monkeypatch.setenv(health.FAKE_ENV, "slow")
    monkeypatch.setattr(health, "RETRY_SLEEP_S", 0.01)
    monkeypatch.setattr(health, "probe_device", lambda device, deadline_s=None, slow_ms=None:
                        HealthReport(ok=False, reason="CUDA degradation window"))
    t0 = time.perf_counter()
    with pytest.raises(CUDAUnhealthyError, match="gave up after"):
        require_healthy_device("cpu", retry_window_s=0.2)
    assert time.perf_counter() - t0 < 10


def test_no_retry_by_default(monkeypatch):
    """Interactive CLIs stay fail-fast: one probe, no retry loop."""
    monkeypatch.setenv(health.FAKE_ENV, "slow")
    calls = {"n": 0}

    def fake_probe(device, deadline_s=None, slow_ms=None):
        calls["n"] += 1
        return HealthReport(ok=False, reason="CUDA degradation window")

    monkeypatch.setattr(health, "probe_device", fake_probe)
    with pytest.raises(CUDAUnhealthyError):
        require_healthy_device("cpu")
    assert calls["n"] == 1


def test_small_retry_window_reports_no_retry(monkeypatch):
    """A window below the retry cycle makes no retry and says so."""
    monkeypatch.setenv(health.FAKE_ENV, "slow")
    monkeypatch.setattr(health, "probe_device", lambda device, deadline_s=None, slow_ms=None:
                        HealthReport(ok=False, reason="CUDA degradation window"))
    with pytest.raises(CUDAUnhealthyError, match="too small for"):
        require_healthy_device("cpu", retry_window_s=30)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the no-card refusal is what is tested")
    with pytest.raises(RuntimeError, match="cuda"):
        require_healthy_device("cuda")
