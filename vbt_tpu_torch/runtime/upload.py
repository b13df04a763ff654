"""Frame upload through a ring of pinned staging buffers and a copy stream.

A pageable ``.to(device, non_blocking=True)`` of a uint8 frame batch is
staged by CUDA through a bounce buffer while the host waits (PERF.md §5:
177 MB a 720p 64-frame batch at 4-8 GB/s). :class:`StagingRing` keeps a
few pinned host buffers of one batch shape instead:

- :meth:`StagingRing.lend` hands out the next buffer for the host to fill
  (the video reader decodes straight into it); a buffer is lent again only
  after the copy that last read it has completed, and never while it is
  still lent and not yet uploaded;
- :meth:`StagingRing.upload` enqueues the host-to-device copy on the copy
  stream, records an event after it, and makes the current (compute) stream
  wait on that event, so the copy of one batch overlaps the compute of the
  previous one. The device tensor is allocated on the copy stream and
  recorded on the compute stream, so its memory is not reused before the
  compute that reads it has finished.

On the CPU the same protocol runs on ordinary memory, without streams: an
upload is a copy, complete when it returns. :meth:`StagingRing.close`
waits for the ring's last copies and lets its buffers go.
"""

from __future__ import annotations

import numpy as np
import torch

RING_DEPTH = 3


class StagingRing:
    """``depth`` uint8 host buffers of ``shape``, pinned when ``device`` is
    CUDA, lent and uploaded in turn."""

    def __init__(self, shape: tuple[int, ...], device: torch.device, depth: int = RING_DEPTH):
        self.shape = tuple(shape)
        self.device = device
        cuda = device.type == "cuda"
        self.buffers = [torch.empty(self.shape, dtype=torch.uint8, pin_memory=cuda)
                        for _ in range(depth)]
        self._arrays = [b.numpy() for b in self.buffers]
        self.copy_stream = torch.cuda.Stream(device) if cuda else None
        self.copied: list[torch.cuda.Event | None] = [None] * depth  # last copy of each buffer
        self.lent = [False] * depth
        self.next = 0

    def close(self) -> None:
        """Wait for every copy out of the ring, then drop its buffers (a
        pinned buffer is freed while no copy reads it). A buffer still lent
        stays alive through the caller's array; uploading it later copies it
        into another ring."""
        for event in self.copied:
            if event is not None:
                event.synchronize()
        self.buffers, self._arrays = [], []
        self.copied, self.lent = [], []

    def index_of(self, frames: np.ndarray) -> int | None:
        """The buffer ``frames`` is (the same memory and shape), else None."""
        ptr = frames.__array_interface__["data"][0]
        for i, a in enumerate(self._arrays):
            if a.__array_interface__["data"][0] == ptr and frames.shape == a.shape:
                return i
        return None

    def lend(self) -> np.ndarray:
        """The next buffer, as a writable numpy array, once the copy that
        last read it has completed."""
        i = self.next
        if self.lent[i]:
            raise RuntimeError(f"staging buffer {i} is lent and not uploaded yet: upload each "
                               "lent batch before asking for more than the ring holds")
        if self.copied[i] is not None:
            self.copied[i].synchronize()
        self.lent[i] = True
        self.next = (i + 1) % len(self.buffers)
        return self._arrays[i]

    def fill(self, frames: np.ndarray) -> np.ndarray:
        """Copy ``frames`` into the next buffer and return it, lent."""
        if frames.shape != self.shape:
            raise ValueError(f"ring of {self.shape} given frames {frames.shape}")
        buf = self.lend()
        # torch's copy splits a large copy over the intra-op threads.
        torch.from_numpy(buf).copy_(torch.from_numpy(np.ascontiguousarray(frames)))
        return buf

    def upload(self, frames: np.ndarray) -> torch.Tensor:
        """``frames`` on the device. A lent buffer is copied as it is; any
        other array is first copied into the next buffer (one host copy)."""
        i = self.index_of(frames)
        if i is None:
            i = self.index_of(self.fill(frames))
        self.lent[i] = False
        host = self.buffers[i]
        if self.copy_stream is None:
            return host.clone()
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.copy_stream):
            dev = torch.empty(self.shape, dtype=torch.uint8, device=self.device)
            dev.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.copy_stream)
        self.copied[i] = event
        compute.wait_event(event)
        dev.record_stream(compute)
        return dev
