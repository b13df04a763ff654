"""The port's scan tracker against the JAX package on the CPU.

Held against ``vbt_tpu.tracking.assignment.hungarian_jax``,
``vbt_tpu.tracking.scan.track_video`` and
``vbt_tpu.runtime.batch_runner.track_clips`` on the same numpy inputs:

- ``hungarian``: ``col_of_row`` equal, on random costs, on costs padded with
  ``INVALID_COST`` as the tracker builds them and on costs with ties (the
  first-index argmin decides those);
- the plain ``track_video`` / ``track_clips`` (CPU tensors), OC-SORT and
  SORT, on moving-plate scenes with misses and dropout (OCR, ORU), crossing
  plates, more births than slots and empty frames with the skip on and off,
  and on ragged clips. float64: report, track_id and conf exact, box and
  dxdy within 1e-12, the bound JAX holds its own batched scan to
  (tests/test_batch_runner.py). float32 (x64 off for the JAX side): report,
  track_id and conf exact, box within 1e-6, dxdy within ``F32_DXDY_ATOL``:
  the two run the same float32 operations, but each library inverts the
  Kalman innovation covariance with its own LAPACK rounding, which the 1e4
  initial velocity variance can amplify about a hundredfold early in a
  track (one float32 step near 0.01 is 1e-9). The measured difference on
  these scenes is 0.
- ``track_clips`` against single-clip runs, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vbt_tpu.runtime import batch_runner as jax_batch  # noqa: E402
from vbt_tpu.tracking import scan as jax_scan  # noqa: E402
from vbt_tpu.tracking.assignment import hungarian_jax  # noqa: E402
from vbt_tpu_torch.io.synthetic import ragged_clips, tracker_cases  # noqa: E402
from vbt_tpu_torch.runtime import batch_runner  # noqa: E402
from vbt_tpu_torch.tracking import scan  # noqa: E402
from vbt_tpu_torch.tracking.assignment import hungarian  # noqa: E402

D_CAP = 8
F32_DXDY_ATOL = 1e-5


CASES = tracker_cases(D_CAP)
OCSORT = CASES["ocsort_simple"][1]


def _jax_tracks(fn, cfg, dtype, *arrays, **kw):
    with jax.enable_x64(dtype == np.float64):
        out = fn(cfg, *(jnp.asarray(a, dtype) if a.dtype.kind == "f" else jnp.asarray(a)
                        for a in arrays), **kw)
        return jax.tree.map(np.asarray, out)


def _assert_tracks_equal(got, want, dtype):
    rep = want.report
    np.testing.assert_array_equal(got.report.numpy(), rep)
    np.testing.assert_array_equal(got.track_id.numpy()[rep], want.track_id[rep])
    np.testing.assert_array_equal(got.conf.numpy()[rep], want.conf[rep])
    box_atol, dxdy_atol = (1e-12, 1e-12) if dtype == np.float64 else (1e-6, F32_DXDY_ATOL)
    np.testing.assert_allclose(got.box.numpy()[rep], want.box[rep], atol=box_atol, rtol=0)
    np.testing.assert_allclose(got.dxdy.numpy()[rep], want.dxdy[rep], atol=dxdy_atol, rtol=0)


# -- hungarian ------------------------------------------------------------------


def _costs(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.normal(size=(n, n)).astype(np.float32)
    if kind == "ties":  # few distinct values: many equal reduced costs
        return rng.integers(0, 3, size=(n, n)).astype(np.float32)
    # The tracker's square: (D, S) affinity costs in [-1, 0], INVALID_COST
    # where a pair is not valid and in the padding.
    d, s = n, max(1, n * 2 // 3)
    cost = -rng.uniform(0, 1, size=(d, s))
    cost[rng.uniform(size=(d, s)) < 0.4] = scan.INVALID_COST
    square = np.full((n, n), scan.INVALID_COST, np.float32)
    square[:d, :s] = cost
    return square


@pytest.mark.parametrize("kind", ["random", "ties", "padded"])
@pytest.mark.parametrize("n", [4, 8, 16, 25, 32])
def test_hungarian_matches_jax(kind, n):
    for seed in range(3):
        cost = _costs(kind, n, seed)
        want = np.asarray(hungarian_jax(jnp.asarray(cost)))
        got = hungarian(torch.from_numpy(cost)).numpy()
        np.testing.assert_array_equal(got, want)


# -- track_video / track_clips --------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_track_video_matches_jax(case, dtype):
    kind, kw, (dets, valid), skip = CASES[case]
    jax_cfg = getattr(jax_scan.ScanTrackerConfig, kind)(**kw)
    want = _jax_tracks(jax_scan.track_video, jax_cfg, dtype, dets, valid,
                       skip_empty_frames=skip)
    cfg = getattr(scan.ScanTrackerConfig, kind)(**kw)
    got = scan.track_video(cfg, dets.astype(dtype), valid, skip_empty_frames=skip)
    assert got.box.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    assert want.report.sum() > 0
    _assert_tracks_equal(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("skip", [True, False])
def test_track_clips_matches_jax(dtype, skip):
    clips = ragged_clips(D_CAP)
    dets, det_valid, frame_valid = batch_runner.pad_clips([c[0] for c in clips],
                                                          [c[1] for c in clips])
    want_pad = jax_batch.pad_clips([c[0] for c in clips], [c[1] for c in clips])
    for got_a, want_a in zip((dets, det_valid, frame_valid), want_pad):
        np.testing.assert_array_equal(got_a, want_a)
    cfg_kw = dict(OCSORT, max_age=10)
    want = _jax_tracks(jax_batch.track_clips, jax_scan.ScanTrackerConfig.ocsort(**cfg_kw), dtype,
                       dets, det_valid, frame_valid, skip_empty_frames=skip)
    got = batch_runner.track_clips(scan.ScanTrackerConfig.ocsort(**cfg_kw),
                                   dets.astype(dtype), det_valid, frame_valid,
                                   skip_empty_frames=skip)
    _assert_tracks_equal(got, want, dtype)


def test_track_clips_equals_single_clip_runs():
    clips = ragged_clips(D_CAP)
    cfg = scan.ScanTrackerConfig.ocsort(**OCSORT)
    dets, det_valid, frame_valid = batch_runner.pad_clips([c[0] for c in clips],
                                                          [c[1] for c in clips])
    batched = batch_runner.track_clips(cfg, dets, det_valid, frame_valid)
    for i, (d, v) in enumerate(clips):
        single = scan.track_video(cfg, d, v)
        t = d.shape[0]
        for got, want in zip(batched, single):
            assert torch.equal(got[i, :t], want)
        assert not batched.report[i, t:].any()  # padding frames report nothing


def test_dispatch_and_empty_video():
    cfg = scan.ScanTrackerConfig.ocsort(**OCSORT)
    out = scan.track_video(cfg, np.zeros((0, D_CAP, 6), np.float32), np.zeros((0, D_CAP), bool))
    assert out.report.shape == (0, D_CAP) and out.box.shape == (0, D_CAP, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        scan.track_video(cfg, torch.zeros((2, D_CAP, 6), device="meta"),
                         torch.zeros((2, D_CAP), dtype=torch.bool, device="meta"))
