"""The scan tracker on Hopper: the wrapper of ``csrc/track_scan.cu`` (K3).

K3 runs the whole SORT / OC-SORT scan of every clip in one launch, one warp
a clip, and replaces what XLA compiled from
``vbt_tpu/tracking/scan.py::track_video`` and
``vbt_tpu/runtime/batch_runner.py::track_clips`` (no Pallas counterpart).
Its plain version is ``tracking/scan.py::scan_clips_plain``; the dispatch
in ``tracking/scan.py::scan_clips`` sends CUDA tensors here and CPU tensors
there. :func:`track_scan` takes CUDA tensors only, float32 only, at most 32
slots and 32 detections a frame, contiguous; it raises on anything else and
has no fallback. ``track_scan.launches`` counts kernel launches.

A ``TrackerState`` (``tracking/scan.py``, float32, every field contiguous
on the inputs' card) can go in as every clip's initial state, and the
final state can come out: a video then runs in chunks with the state
carried, bit for bit as one launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vbt_tpu_torch.ops import _build
from vbt_tpu_torch.tracking.scan import TrackerState, init_state
from vbt_tpu_torch.utils.profiling import launch_counter

MAX_SLOTS = 32  # a lane a slot (csrc/track_scan.cu kMaxSlots)
MAX_DETS = 32  # a lane a detection row (kMaxDets)
MAX_DELTA_T = 8  # observation ring length (kMaxDeltaT)
ASSO = {"iou": 0, "diou": 1}  # csrc/track_scan.cu Asso
MOMENTUM, RECOVERY, REUPDATE, REPORT_OBS, SKIP_EMPTY = 1, 2, 4, 8, 16


@functools.cache
def _launcher():
    """``vbt_track_scan_launch`` of the built library, its C signature declared."""
    return _build.bind("track_scan", "vbt_track_scan_launch",
                       [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 3)


@functools.lru_cache(maxsize=16)
def _state_layout(cfg, c: int) -> TrackerState:
    """The layout the kernel reads and writes: ``init_state``'s, float32,
    as shapes and dtypes only (on the meta device). Cached: building it
    takes about a millisecond of the host, more than a chunk's launch."""
    return init_state(cfg, c, torch.float32, "meta")


def track_scan(cfg, dets: torch.Tensor, det_valid: torch.Tensor, frame_valid: torch.Tensor,
               skip_empty_frames: bool = True, state=None, return_state: bool = False):
    """``cfg`` a ``ScanTrackerConfig``; ``dets`` (C, T, D, 6) float32,
    ``det_valid`` (C, T, D) bool, ``frame_valid`` (C, T) bool, all on one
    CUDA device -> (report (C, T, S) bool, box (C, T, S, 4), track_id
    (C, T, S) int32, conf, cls (C, T, S), dxdy (C, T, S, 2)). Fields other
    than ``report`` are zero on inactive frames.

    ``state``, a ``TrackerState`` with C clips, is every clip's initial
    state (``None``: the fresh state). With ``return_state`` the result is
    ``(final TrackerState, outputs)``."""
    if dets.dim() != 4 or dets.shape[-1] != 6:
        raise ValueError(f"want dets (C, T, D, 6), got {tuple(dets.shape)}")
    c, t, d, _ = dets.shape
    if det_valid.shape != (c, t, d) or frame_valid.shape != (c, t):
        raise ValueError(f"want det_valid {(c, t, d)} and frame_valid {(c, t)}, got "
                         f"{tuple(det_valid.shape)} and {tuple(frame_valid.shape)}")
    if dets.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 detections, got {dets.dtype}")
    if det_valid.dtype != torch.bool or frame_valid.dtype != torch.bool:
        raise TypeError(f"want bool masks, got {det_valid.dtype} and {frame_valid.dtype}")
    dev = dets.device
    if dev.type != "cuda" or det_valid.device != dev or frame_valid.device != dev:
        raise ValueError(f"want every input on one CUDA device, got {dets.device}, "
                         f"{det_valid.device}, {frame_valid.device}")
    s = cfg.max_tracks
    if not (0 < s <= MAX_SLOTS and 0 < d <= MAX_DETS):
        raise ValueError(f"the kernel takes 0 < max_tracks <= {MAX_SLOTS} and 0 < D <= "
                         f"{MAX_DETS}; got max_tracks={s}, D={d}")
    if not 0 < cfg.delta_t <= MAX_DELTA_T or cfg.asso not in ASSO:
        raise ValueError(f"the kernel takes 0 < delta_t <= {MAX_DELTA_T} and asso in "
                         f"{sorted(ASSO)}; got {cfg.delta_t}, {cfg.asso!r}")
    if not (dets.is_contiguous() and det_valid.is_contiguous() and frame_valid.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    fields_in = None if state is None else _build.check_layout(
        "state", state, _state_layout(cfg, c), dev, mismatch=ValueError)
    final = None
    if return_state:
        final = TrackerState(*(torch.empty(t.shape, dtype=t.dtype, device=dev)
                               for t in _state_layout(cfg, c)))
    report = torch.empty((c, t, s), dtype=torch.bool, device=dev)
    box = torch.empty((c, t, s, 4), dtype=torch.float32, device=dev)
    track_id = torch.empty((c, t, s), dtype=torch.int32, device=dev)
    conf = torch.empty((c, t, s), dtype=torch.float32, device=dev)
    cls = torch.empty((c, t, s), dtype=torch.float32, device=dev)
    dxdy = torch.empty((c, t, s, 2), dtype=torch.float32, device=dev)
    outs = (report, box, track_id, conf, cls, dxdy)
    if c == 0 or t == 0:
        if final is not None:  # no frame: the state goes out as it came in
            start = state if state is not None else init_state(cfg, c, torch.float32, dev)
            final = TrackerState(*(f.clone() for f in start))
        return (final, outs) if return_state else outs
    flags = (MOMENTUM * cfg.use_momentum | RECOVERY * cfg.use_recovery
             | REUPDATE * cfg.use_reupdate | REPORT_OBS * cfg.report_observation
             | SKIP_EMPTY * bool(skip_empty_frames))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            dets.data_ptr(), det_valid.data_ptr(), frame_valid.data_ptr(), report.data_ptr(),
            box.data_ptr(), track_id.data_ptr(), conf.data_ptr(), cls.data_ptr(),
            dxdy.data_ptr(), c, t, d, s, cfg.max_age, cfg.min_hits, cfg.iou_threshold,
            ASSO[cfg.asso], cfg.inertia, cfg.delta_t, flags, _build.pointers(fields_in),
            _build.pointers(final), stream)
    if err != 0:
        raise RuntimeError(f"track_scan kernel launch failed: cudaError {err}")
    track_scan.launches += 1
    return (final, outs) if return_state else outs


launch_counter(track_scan)
