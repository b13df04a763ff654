"""Small CPU runs of each mix through the whole harness and the
reference: the result line's keys, a correct run, and the faults the
check must catch, each planted in the timed path underneath.

The program runs its CPU lane (float32, the plain versions of its
kernels) at the tiny sizes of ``conftest.TINY``; the reference is the same
float32 mathematics, so sound runs read near 0 and every limit holds."""

import numpy as np
import pytest

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["lite0.track", "lite0.stream", "lite0.train"])
def test_a_small_run_is_correct_and_prints_the_contracts_line(cpu_run, workload):
    rc, result, err = cpu_run(workload)
    assert rc == 0, err
    assert list(result) == KEYS + ["checks"]
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert "setup_s" in result["metrics"] and len(result["metrics"]) == 2
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") for line in tail)


def test_a_traced_run_prints_the_per_layer_metrics_and_breakdown(cpu_run):
    rc, result, err = cpu_run("lite0.stream", trace=1)
    assert rc == 0, err
    assert list(result) == KEYS + ["breakdown", "checks"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    # The CPU has no device trace: the spans' readings come, the device's do not.
    assert {"detect_ms.stream", "track_ms.stream", "analysis_ms.stream",
            "mfu.stream"} <= set(result["metrics"])
    assert "nms_roofline.stream" not in result["metrics"]


def _shift_detections(monkeypatch, rows_fn):
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    real = DetectionPipeline.detections_to_tracker_inputs

    def broken(self, det, threshold):
        rows, valid = real(self, det, threshold)
        return rows_fn(rows.copy(), valid.copy())

    monkeypatch.setattr(DetectionPipeline, "detections_to_tracker_inputs", broken)


def _altered(rows, valid):
    # Each frame's boxes moved up or down by up to a twentieth of the frame.
    shift = np.random.default_rng(len(rows)).uniform(-0.05, 0.05, size=(len(rows), 1))
    rows[:, :, 1] += shift
    rows[:, :, 3] += shift
    return rows, valid


def _half_left_out(rows, valid):
    n = rows.shape[0] // 2
    rows[n:] = 0.0
    valid[n:] = False
    return rows, valid


def _wrong_slot(rows, valid):
    # The last frame of every batch gets the rows of the frame before it.
    rows[-1], valid[-1] = rows[-2], valid[-2]
    return rows, valid


def _scaled(rows, valid):
    # Every box 2% larger about its center.
    center = (rows[..., :2] + rows[..., 2:4]) / 2
    half = (rows[..., 2:4] - rows[..., :2]) / 2 * 1.02
    rows[..., :2], rows[..., 2:4] = center - half, center + half
    return rows, valid


def _threshold_ignored(rows, valid):
    # Every row the postprocess kept counts, whatever its score.
    valid[:] = rows[..., 4] > 0
    return rows, valid


FAULTS = {"altered": (_altered, "motion_gap"), "half_left_out": (_half_left_out, "motion_gap"),
          "wrong_slot": (_wrong_slot, "box_gap"), "scaled": (_scaled, "box_gap"),
          "threshold_ignored": (_threshold_ignored, "valid_gap")}


@pytest.mark.parametrize("workload", ["lite0.track", "lite0.stream"])
@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_detections_are_not_correct(cpu_run, monkeypatch, workload, fault):
    broken, number = FAULTS[fault]
    _shift_detections(monkeypatch, broken)
    rc, result, err = cpu_run(workload)
    assert rc == 0, err
    assert result["correct"] is False
    check = next(c for c in result["checks"] if c["name"] == number)
    assert check["value"] > check["limit"]


def test_an_altered_track_row_is_not_correct(cpu_run, monkeypatch):
    from vbt_tpu_torch.cli import track

    real = track.run_scan_tracker

    def broken(*args, **kwargs):
        out = real(*args, **kwargs)
        out["box"] = out["box"].copy()
        out["box"][len(out["box"]) // 2:, :, 1] += 0.01
        return out

    monkeypatch.setattr(track, "run_scan_tracker", broken)
    rc, result, err = cpu_run("lite0.track")
    assert rc == 0, err
    assert result["correct"] is False
    assert next(c for c in result["checks"] if c["name"] == "track_gap")["value"] > 1e-3


def test_an_altered_phase_is_not_correct(cpu_run, monkeypatch):
    from vbt_tpu_torch.runtime import streaming

    real = streaming.StreamingPipeline.phases

    def broken(self, include_open=True):
        phases = real(self, include_open)
        for p in phases:
            p.rom *= 1.01
        return phases

    monkeypatch.setattr(streaming.StreamingPipeline, "phases", broken)
    rc, result, err = cpu_run("lite0.stream", seed=2**31 + 9)
    assert rc == 0, err
    assert result["correct"] is False


def test_a_train_step_on_half_the_batch_is_not_correct(cpu_run, monkeypatch):
    from vbt_tpu_torch.train.train_step import Trainer

    real = Trainer.train_step

    def half(self, state, batch):
        n = batch["images"].shape[0] // 2
        return real(self, state, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(Trainer, "train_step", half)
    rc, result, err = cpu_run("lite0.train")
    assert rc == 0, err
    assert result["correct"] is False


def test_a_train_step_that_keeps_its_state_is_not_correct(cpu_run, monkeypatch):
    from vbt_tpu_torch.train.train_step import Trainer

    real = Trainer.train_step

    def unchanged(self, state, batch):
        _, metrics = real(self, state, batch)
        return state, metrics

    monkeypatch.setattr(Trainer, "train_step", unchanged)
    rc, result, err = cpu_run("lite0.train")
    assert rc == 0, err
    assert result["correct"] is False
    checks = {c["name"]: c["value"] for c in result["checks"]}
    assert checks["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("kept,number", [("ema_params", "ema_gap"), ("batch_stats", "stats_gap")])
def test_a_train_step_that_keeps_its_ema_or_statistics_is_not_correct(cpu_run, monkeypatch,
                                                                      kept, number):
    from vbt_tpu_torch.train.train_step import Trainer

    real = Trainer.train_step

    def keeps(self, state, batch):
        new, metrics = real(self, state, batch)
        return new._replace(**{kept: getattr(state, kept)}), metrics

    monkeypatch.setattr(Trainer, "train_step", keeps)
    rc, result, err = cpu_run("lite0.train")
    assert rc == 0, err
    assert result["correct"] is False
    checks = {c["name"]: c["value"] for c in result["checks"]}
    assert checks[number] == pytest.approx(1.0)


def test_a_fault_only_in_the_windows_steps_is_not_correct(cpu_run, monkeypatch):
    """Set-up's steps are sound; from the window on each step drops half its
    batch. Only the window's replayed steps can see it."""
    from benchmark.core import registry
    from vbt_tpu_torch.train.train_step import Trainer

    real = Trainer.train_step
    compared = registry.mix("train_voc")["compared"]
    calls = []

    def late_half(self, state, batch):
        calls.append(1)
        if len(calls) <= compared:
            return real(self, state, batch)
        n = batch["images"].shape[0] // 2
        return real(self, state, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(Trainer, "train_step", late_half)
    rc, result, err = cpu_run("lite0.train")
    assert rc == 0, err
    assert result["correct"] is False
    assert "check late stage" in err
