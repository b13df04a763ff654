"""A video's frame axis cut into chunks over devices, the tracker carry relayed.

Port of ``vbt_tpu.parallel.time_shard``. The frame axis is padded to a
multiple of the device count with invalid frames and cut into one chunk a
device; chunk r is tracked on ``devices[r]`` starting from the state that
chunk r - 1 ended with, copied to ``devices[r]`` (a ``TrackerState`` is
about 10 KB). Padding frames are inert, so the output, cut back to T,
equals one scan over the whole video bit for bit.

The JAX relay runs every chunk's scan on every chip in every round (n^2
chunk scans) because one SPMD program cannot branch per chip; here one
process drives each device in turn, so each chunk runs once, where it
lives. The tracker's recursion is serial either way: chunk r cannot start
before chunk r - 1 ends. What the split buys is each device holding only
its own chunk's frames and detections.
"""

from __future__ import annotations

import torch

from vbt_tpu_torch.tracking.scan import (
    FrameTracks,
    ScanTrackerConfig,
    TrackerState,
    init_state,
    scan_clips,
)


def track_video_time_sharded(cfg: ScanTrackerConfig, dets, valid, devices,
                             skip_empty_frames: bool = True) -> FrameTracks:
    """Track one video (``dets`` (T, D, 6), ``valid`` (T, D), numpy or
    tensors) in ``len(devices)`` chunks, chunk r on ``devices[r]``, in the
    dtype of ``dets`` (float32 on a card: kernel K3). Returns FrameTracks
    (T, S, ...) on the CPU."""
    dets, valid = torch.as_tensor(dets), torch.as_tensor(valid)
    n = len(devices)
    t = dets.shape[0]
    t_pad = -(-t // n) * n
    frames = torch.zeros(t_pad, dtype=torch.bool)
    frames[:t] = True  # padding frames are inert
    if t_pad != t:
        dets = torch.cat([dets, dets.new_zeros((t_pad - t,) + tuple(dets.shape[1:]))])
        valid = torch.cat([valid, valid.new_zeros((t_pad - t,) + tuple(valid.shape[1:]))])
    size = t_pad // n
    state: TrackerState | None = None
    parts = []
    for r, dev in enumerate(devices):
        sl = slice(r * size, (r + 1) * size)
        state = (init_state(cfg, 1, dets.dtype, dev) if state is None
                 else TrackerState(*(f.to(dev) for f in state)))
        state, out = scan_clips(cfg, dets[None, sl].to(dev), valid[None, sl].to(dev),
                                frames[None, sl].to(dev), skip_empty_frames, state=state,
                                return_state=True)
        parts.append(out)
    return FrameTracks(*(torch.cat([p[i][0].cpu() for p in parts])[:t]
                         for i in range(len(FrameTracks._fields))))
