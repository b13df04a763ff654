"""Video decode/encode and annotation drawing (OpenCV host path).

Port of ``vbt_tpu.io.video``; cv2 is imported inside each function.

The reader yields fixed-size uint8 RGB frame batches so the device pipeline
sees static shapes; the tail batch is padded and masked. It decodes each
batch straight into a buffer: one the caller lends (``lend``, such as
``DetectionPipeline.lend_frames``, which hands out pinned staging buffers)
or a new array, never a copy of a reused one. Drawing reproduces
the reference's annotated-video output (track.py:28-62: bounding box +
"{score}%, tracking_id: N" label, polyline bar path capped at the last 120
points with a filled endpoint circle).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

BAR_PATH_MAX_POINTS = 120  # track.py:57


@dataclass
class VideoMeta:
    fps: float
    width: int
    height: int


class VideoReader:
    """Batched RGB frame reader over OpenCV's C++ decoder."""

    def __init__(self, path: str, batch_size: int = 32,
                 lend: Callable[[tuple[int, ...]], np.ndarray] | None = None):
        import cv2

        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise FileNotFoundError(path)
        self.meta = VideoMeta(
            fps=self._cap.get(cv2.CAP_PROP_FPS),
            width=int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        )
        self.batch_size = batch_size
        self._lend = lend

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
        """Yields (frames (B,H,W,3) uint8 RGB, valid (B,) bool, start_index).
        A lent buffer belongs to the caller from the yield on; the reader
        asks for the next one when it decodes the next frame. Slots past
        the last frame of the tail batch hold stale pixels (masked). A
        decoded frame of another shape than the video reports raises
        ``ValueError``."""
        import cv2

        b = self.batch_size
        shape = (b, self.meta.height, self.meta.width, 3)
        start = 0
        buf = None
        count = 0
        while True:
            ok, frame = self._cap.read()
            if not ok:
                break
            if buf is None:
                buf = self._lend(shape) if self._lend else np.zeros(shape, np.uint8)
            if frame.shape != shape[1:]:
                # cvtColor would write a new array and leave the batch stale.
                raise ValueError(f"decoded frame {frame.shape}, the video reports "
                                 f"{shape[1:]}")
            cv2.cvtColor(frame, cv2.COLOR_BGR2RGB, dst=buf[count])
            count += 1
            if count == b:
                yield buf, np.ones(b, bool), start
                start += b
                count = 0
                buf = None
        if count:
            valid = np.zeros(b, bool)
            valid[:count] = True
            yield buf, valid, start
        self._cap.release()


class VideoWriter:
    """mp4v writer matching the reference's export (track.py:152-154)."""

    def __init__(self, path: str, fps: float, width: int, height: int):
        import cv2

        self._writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height)
        )

    def write_rgb(self, frame_rgb: np.ndarray) -> None:
        import cv2

        self._writer.write(cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2BGR))

    def release(self) -> None:
        self._writer.release()


def draw_bounding_box(image, tracking_id, bounding_box, score, color):
    """Box + label in absolute pixels from a normalized [ymin,xmin,ymax,xmax]
    box (track.py:28-49)."""
    import cv2

    ymin, xmin, ymax, xmax = bounding_box
    x1 = int(xmin * image.shape[1])
    x2 = int(xmax * image.shape[1])
    y1 = int(ymin * image.shape[0])
    y2 = int(ymax * image.shape[0])
    cv2.rectangle(image, (x1, y1), (x2, y2), color, 2)
    y = y1 - 15 if y1 - 15 > 15 else y1 + 15
    label = "{:.0f}%, tracking_id: {}".format(score * 100, tracking_id)
    cv2.putText(image, label, (x1, y), cv2.FONT_HERSHEY_DUPLEX, 1, color, 2)


def draw_bar_path(image, bar_path: np.ndarray, color):
    """Polyline over the last 120 center points + endpoint dot
    (track.py:52-62)."""
    import cv2

    if len(bar_path) > BAR_PATH_MAX_POINTS:
        bar_path = bar_path[-BAR_PATH_MAX_POINTS:]
    cv2.polylines(image, [bar_path], isClosed=False, color=color, thickness=2)
    cv2.circle(image, center=bar_path[-1], radius=10, color=color, thickness=-1)
