"""Multi-clip tracking: several clips in one scan, over one or more devices.

Port of ``vbt_tpu.runtime.batch_runner``. Clips of ragged lengths are
padded to a common length (:func:`pad_clips`); the padding frames are inert
(they neither advance a track nor report). On CUDA the clips of one device
run in one launch of kernel K3, a warp each; on the CPU through the plain
version. :func:`shard_clips` splits the clips axis over a device list, one
scan a device; clips are independent, so nothing passes between devices.
"""

from __future__ import annotations

import numpy as np
import torch

from vbt_tpu_torch.tracking.scan import FrameTracks, ScanTrackerConfig, scan_clips


def track_clips(cfg: ScanTrackerConfig, dets, det_valid, frame_valid,
                skip_empty_frames: bool = True) -> FrameTracks:
    """Track C clips: ``dets`` (C, T, D, 6), ``det_valid`` (C, T, D),
    ``frame_valid`` (C, T) -> FrameTracks with a leading clips axis. CUDA
    tensors go to kernel K3 (float32), CPU tensors or numpy arrays to the
    plain version."""
    return scan_clips(cfg, dets, det_valid, frame_valid, skip_empty_frames)


def pad_clips(per_clip_dets: list[np.ndarray], per_clip_valid: list[np.ndarray]):
    """Stack ragged per-clip (T_i, D, 6) detections to (C, T_max, D, 6),
    with the (C, T_max, D) detection mask and the (C, T_max) frame mask."""
    c = len(per_clip_dets)
    t_max = max(d.shape[0] for d in per_clip_dets)
    d_cap = per_clip_dets[0].shape[1]
    dets = np.zeros((c, t_max, d_cap, 6), per_clip_dets[0].dtype)
    det_valid = np.zeros((c, t_max, d_cap), bool)
    frame_valid = np.zeros((c, t_max), bool)
    for i, (d, v) in enumerate(zip(per_clip_dets, per_clip_valid)):
        t = d.shape[0]
        dets[i, :t] = d
        det_valid[i, :t] = v
        frame_valid[i, :t] = True
    return dets, det_valid, frame_valid


def shard_clips(devices, *arrays) -> list[tuple[torch.Tensor, ...]]:
    """Split clip-major arrays (numpy or tensors, leading clips axis C, a
    multiple of ``len(devices)``) into one equal, contiguous share a device:
    ``[(array_0 share, array_1 share, ...) on devices[0], ...]``."""
    n = len(devices)
    c = arrays[0].shape[0]
    if c % n:
        raise ValueError(f"{c} clips do not split evenly over {n} devices; pad first")
    size = c // n
    return [tuple(torch.as_tensor(a)[r * size:(r + 1) * size].contiguous().to(dev)
                  for a in arrays) for r, dev in enumerate(devices)]
