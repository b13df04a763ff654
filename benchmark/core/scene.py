"""The benchmark's own lifting scene, rendered on the card from a seed.

A dark bumper-plate-like disc (rim, inner ring, bright hub) on a bar over
a background of blocky grey-ish colours, the disc's center moving up and
down for ``reps`` repetitions in a set of ``frames`` frames. It is written
for the benchmark, as the yardstick's own: the program's synthetic scenes
are not imported.

A set is drawn from a ``numpy.random.Generator``: the background, the
number of reps (between ``reps_min`` and ``reps_max``) and the bar's
horizontal place; every set has the same size, so a seed changes what the
frames show and not how much work they are.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BLOCK = 32  # frames rendered per call on the card


@dataclass(frozen=True)
class SetPlan:
    frames: int
    height: int
    width: int
    reps: int
    center_x: float  # of the width
    background: np.ndarray  # (rows, cols, 3) uint8 blocks
    radius: float  # of the height
    amplitude: float  # of the height


def plan_set(rng: np.random.Generator, frames: int, height: int, width: int, reps_min: int,
             reps_max: int, radius: float, amplitude: float) -> SetPlan:
    cell = max(1, height // 30)
    bg = rng.integers(90, 170, size=(-(-height // cell), -(-width // cell), 3), dtype=np.uint8)
    return SetPlan(frames, height, width, int(rng.integers(reps_min, reps_max + 1)),
                   float(rng.uniform(0.45, 0.55)), bg, radius, amplitude)


def center_y(plan: SetPlan) -> np.ndarray:
    """The disc's center (of the height) in each frame: low at the start,
    up (concentric) and down again once a rep."""
    t = np.arange(plan.frames)
    period = plan.frames / plan.reps
    return 0.5 + plan.amplitude * np.cos(2 * np.pi * t / period)


def render(plan: SetPlan, device, start: int = 0, stop: int | None = None):
    """Frames ``start:stop`` of the set as a uint8 RGB tensor (n, H, W, 3)
    on ``device``."""
    import torch

    stop = plan.frames if stop is None else stop
    h, w = plan.height, plan.width
    cell = max(1, h // 30)
    bg = torch.from_numpy(plan.background).to(device)
    bg = bg.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:h, :w].float()
    yy = torch.arange(h, device=device, dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, w)
    cy_all = torch.from_numpy(center_y(plan) * h).to(device, torch.float32)
    cx = plan.center_x * w
    r = plan.radius * h
    ring = max(1.0, h / 240)
    out = []
    for i in range(start, stop, BLOCK):
        cy = cy_all[i:min(i + BLOCK, stop)].view(-1, 1, 1)
        img = bg.expand(cy.shape[0], h, w, 3).clone()
        img[((yy - cy).abs() <= h / 80).expand(-1, -1, w)] = 200.0  # the bar
        d = torch.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        img[d <= r] = 20.0
        img[d <= 0.55 * r] = 40.0
        img[(d - 0.55 * r).abs() <= ring] = 90.0
        img[d <= 0.12 * r] = 220.0
        out.append(img.to(torch.uint8))
    return torch.cat(out)


def render_host(plan: SetPlan, device) -> np.ndarray:
    """The whole set as a host uint8 array (frames, H, W, 3)."""
    host = np.empty((plan.frames, plan.height, plan.width, 3), np.uint8)
    step = BLOCK * 8
    for i in range(0, plan.frames, step):
        j = min(i + step, plan.frames)
        host[i:j] = render(plan, device, i, j).cpu().numpy()
    return host


def write_video(plan: SetPlan, path: str, fps: float, device) -> None:
    """The set as an mp4v video file (OpenCV), as a phone's recording
    reaches ``vbt-torch-track``."""
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (plan.width, plan.height))
    if not writer.isOpened():
        raise RuntimeError(f"OpenCV cannot write {path}")
    step = BLOCK * 4
    for i in range(0, plan.frames, step):
        block = render(plan, device, i, min(i + step, plan.frames)).flip(-1).cpu().numpy()
        for frame in block:
            writer.write(frame)
    writer.release()
