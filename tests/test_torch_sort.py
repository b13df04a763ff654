"""The port's host SORT tracker and dataframe contract check against the JAX
package on the CPU.

- ``SortTracker`` on seeded two-plate scenes with misses and jitter (3
  seeds, ``max_age`` 1, 5 and 30, ``iou_threshold`` 0.1 and 0.3), frame by
  frame against JAX's: output rows within 1e-12 with ids exact, and every
  live track's id and ``kf.x`` within 1e-12. Both sides are float64 numpy
  on the same Jonker-Volgenant solver (the JAX host lane on the native one,
  ``torch_hostops.native_hostops``), so they should agree to the last bit;
  1e-12 leaves room for nothing but a different summation order.
- ``associate_iou`` against JAX's on random, partly overlapping boxes:
  matches and both unmatched lists exact.
- Track ids continue across two videos (the class-level counter), as in
  JAX; the empty frame returns a (0, 7) array.
- The port's ``SortTracker`` against the port's scan tracker with
  ``ScanTrackerConfig.sort`` (the plain version, float64, on the CPU),
  ``tests/test_tracker_scan.py``'s hold of JAX's pair with its tolerance,
  1e-6: the scan's covariance algebra is written another way.
- ``validate_track_df``: the same problem lists as JAX's on a conformant
  frame, a wrong column order, a wrong dtype, unsorted rows and several
  problems at once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pandas as pd  # noqa: E402

from torch_hostops import native_hostops  # noqa: E402,F401
from vbt_tpu.contract import validate_track_df as jax_validate  # noqa: E402
from vbt_tpu.contract.schema import build_track_df as jax_build_track_df  # noqa: E402
from vbt_tpu.tracking import SortTracker as JaxSortTracker  # noqa: E402
from vbt_tpu.tracking import sort as jax_sort  # noqa: E402
from vbt_tpu_torch.contract import TRACK_COLUMNS, validate_track_df  # noqa: E402
from vbt_tpu_torch.tracking import SortTracker  # noqa: E402
from vbt_tpu_torch.tracking import sort as port_sort  # noqa: E402
from vbt_tpu_torch.tracking.scan import ScanTrackerConfig, track_video  # noqa: E402

ATOL = 1e-12
SCAN_ATOL = 1e-6  # tests/test_tracker_scan.py's bound on JAX's host-vs-scan pair
D_CAP = 8


@pytest.fixture(autouse=True)
def native_solver(native_hostops):
    """The JAX host lane on the native JV solver, never scipy."""


@pytest.fixture(autouse=True)
def fresh_ids():
    jax_sort.KalmanBoxTracker.count = 0
    port_sort.KalmanBoxTracker.count = 0


def _plates(n_frames=60, miss=(), jitter=0.0, seed=0):
    """Two plates moving vertically in opposite directions, normalized
    coordinates (``tests/test_trackers_host.py``'s scene)."""
    rng = np.random.default_rng(seed)
    frames = []
    for f in range(n_frames):
        dets = []
        if f not in miss:
            y1 = 0.2 + 0.4 * (f / n_frames)
            dets.append([0.10, y1, 0.30, y1 + 0.15, 0.9, 0])
            y2 = 0.7 - 0.4 * (f / n_frames)
            dets.append([0.60, y2, 0.85, y2 + 0.15, 0.8, 0])
        dets = np.asarray(dets).reshape(-1, 6)
        if jitter and len(dets):
            dets[:, :4] += rng.normal(0, jitter, size=dets[:, :4].shape)
        frames.append(dets)
    return frames


def _misses(seed):
    """A gap of 8 frames, two single misses and a seeded random few."""
    rng = np.random.default_rng(100 + seed)
    return set(range(20, 28)) | {5, 41} | set(rng.integers(30, 60, size=4).tolist())


def _assert_same_trackers(got, want, where):
    assert [t.id for t in got.trackers] == [t.id for t in want.trackers], where
    for g, w in zip(got.trackers, want.trackers):
        np.testing.assert_allclose(g.kf.x, w.kf.x, rtol=0, atol=ATOL, err_msg=where)
        assert (g.hits, g.hit_streak, g.age, g.time_since_update) == (
            w.hits, w.hit_streak, w.age, w.time_since_update), where


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("max_age", [1, 5, 30])
@pytest.mark.parametrize("iou_threshold", [0.1, 0.3])
def test_sort_matches_jax(seed, max_age, iou_threshold):
    frames = _plates(miss=_misses(seed), jitter=0.004 * (seed + 1) / 2, seed=seed)
    got_t = SortTracker(max_age=max_age, iou_threshold=iou_threshold)
    want_t = JaxSortTracker(max_age=max_age, iou_threshold=iou_threshold)
    rows = 0
    for f, dets in enumerate(frames):
        got, want = got_t.update(dets, []), want_t.update(dets, [])
        assert got.shape == want.shape, f"frame {f}"
        np.testing.assert_array_equal(got[:, 4], want[:, 4], err_msg=f"frame {f} ids")
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=f"frame {f}")
        _assert_same_trackers(got_t, want_t, f"frame {f}")
        rows += len(got)
    assert rows > 60  # both plates tracked through most frames
    assert port_sort.KalmanBoxTracker.count == jax_sort.KalmanBoxTracker.count


def test_sort_defaults_match_jax():
    got, want = SortTracker(), JaxSortTracker()
    assert (got.max_age, got.min_hits, got.iou_threshold) == (1, 1, 0.3)
    assert (got.max_age, got.min_hits, got.iou_threshold) == (
        want.max_age, want.min_hits, want.iou_threshold)


def _random_boxes(rng, n):
    xy = rng.uniform(0, 0.7, size=(n, 2))
    wh = rng.uniform(0.1, 0.3, size=(n, 2))
    return np.concatenate([xy, xy + wh, rng.uniform(0.5, 1, size=(n, 1))], axis=1)


@pytest.mark.parametrize("iou_threshold", [0.1, 0.3])
def test_associate_iou_matches_jax(iou_threshold):
    rng = np.random.default_rng(7)
    for _ in range(200):
        n, m = rng.integers(0, 7, size=2)
        dets = _random_boxes(rng, n)
        trks = _random_boxes(rng, m)[:, :4]
        if n and m and rng.uniform() < 0.3:  # a near-copy of some detections
            k = min(n, m)
            trks[:k] = dets[:k, :4] + rng.normal(0, 0.01, size=(k, 4))
        got = port_sort.associate_iou(dets, trks, iou_threshold)
        want = jax_sort.associate_iou(dets, trks, iou_threshold)
        for g, w, name in zip(got, want, ("matched", "unmatched dets", "unmatched trks")):
            assert g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_ids_continue_across_videos_and_empty_frames():
    videos = [_plates(n_frames=20, jitter=0.002, seed=s) for s in (0, 1)]
    got_ids, want_ids = [], []
    for frames in videos:
        got_t, want_t = SortTracker(max_age=30, iou_threshold=0.1), JaxSortTracker(
            max_age=30, iou_threshold=0.1)
        for dets in frames:
            got_ids += got_t.update(dets, [])[:, 4].tolist()
            want_ids += want_t.update(dets, [])[:, 4].tolist()
        empty = got_t.update(np.empty((0, 6)), [])
        assert empty.shape == (0, 7) == want_t.update(np.empty((0, 6)), []).shape
    assert got_ids == want_ids
    assert sorted(set(got_ids)) == [1, 2, 3, 4]  # the second video's ids follow the first's


def _scan_scene(n_frames, n_obj, seed, dropout=0.0, jitter=0.004):
    """``tests/test_tracker_scan.py``'s scene: plates on sine paths."""
    rng = np.random.default_rng(seed)
    frames = []
    for f in range(n_frames):
        dets = []
        for k in range(n_obj):
            if dropout and rng.uniform() < dropout:
                continue
            x0 = 0.1 + 0.35 * k
            y0 = 0.3 + 0.3 * np.sin(2 * np.pi * (f / n_frames + k * 0.3))
            dets.append([x0, y0, x0 + 0.18, y0 + 0.15, 0.5 + 0.4 * rng.uniform(), 0])
        dets = np.asarray(dets).reshape(-1, 6)
        if jitter and len(dets):
            dets[:, :4] += rng.normal(0, jitter, size=dets[:, :4].shape)
        frames.append(dets)
    return frames


@pytest.mark.parametrize("scene,max_age,iou_threshold", [
    ((50, 2, 1, 0.0), 30, 0.1),
    ((80, 3, 2, 0.15), 5, 0.2),
])
def test_sort_matches_port_scan(scene, max_age, iou_threshold):
    frames = _scan_scene(*scene)
    tracker = SortTracker(max_age=max_age, iou_threshold=iou_threshold)
    host = [{int(r[4]): (r[:4], r[6]) for r in tracker.update(dets, [])} for dets in frames]
    dets = np.zeros((len(frames), D_CAP, 6))
    valid = np.zeros((len(frames), D_CAP), bool)
    for t, f in enumerate(frames):
        dets[t, :len(f)], valid[t, :len(f)] = f, True
    cfg = ScanTrackerConfig.sort(max_age=max_age, iou_threshold=iou_threshold, max_tracks=D_CAP)
    out = track_video(cfg, torch.from_numpy(dets), torch.from_numpy(valid),
                      skip_empty_frames=False)
    for t, h in enumerate(host):
        rep = out.report[t].numpy()
        scan = {int(i): (b, c) for i, b, c in zip(out.track_id[t].numpy()[rep],
                                                   out.box[t].numpy()[rep],
                                                   out.conf[t].numpy()[rep])}
        assert sorted(scan) == sorted(h), f"frame {t}"
        for tid, (box, conf) in h.items():
            np.testing.assert_allclose(scan[tid][0], box, rtol=0, atol=SCAN_ATOL,
                                       err_msg=f"frame {t} id {tid}")
            assert abs(scan[tid][1] - conf) <= SCAN_ATOL


def _capture(rng):
    rows = []
    for f in range(12):
        for tid in (2, 1):
            rows.append([tid, (f + 1) / 30, *rng.uniform(0, 1, size=6)])
    return {c: [r[i] for r in rows] for i, c in enumerate(TRACK_COLUMNS)}


@pytest.mark.parametrize("case", ["conformant", "column_order", "dtype", "unsorted", "several",
                                  "missing_column"])
def test_validate_track_df_matches_jax(case):
    df = jax_build_track_df(_capture(np.random.default_rng(3)))
    if case == "column_order":
        df = df[["time", "id", *TRACK_COLUMNS[2:]]]
    elif case == "dtype":
        df = df.astype({"x": np.float32})
    elif case == "unsorted":
        df = df.iloc[::-1]
    elif case == "several":
        df = df.astype({"id": np.int32, "dy": np.float32}).sample(frac=1.0, random_state=0)
    elif case == "missing_column":
        df = df.drop(columns=["dx"])
    got, want = validate_track_df(df), jax_validate(df)
    assert got == want
    assert (got == []) == (case == "conformant")
    if case == "several":
        assert len(got) == 3
    assert isinstance(df, pd.DataFrame)
