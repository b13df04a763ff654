"""Fail-fast CUDA health probe, run before a CLI touches the card.

Port of ``vbt_tpu.utils.health`` with the same contract. A hung device
call cannot be interrupted from inside the process (a wedged driver, a
card stuck after an Xid fault, a kernel that never returns), so the probe
runs in a SUBPROCESS with a hard wall deadline: the parent gets a verdict
within ``deadline_s`` seconds or kills the child and reports the card as
wedged. A card that answers but runs slowly (clocks held down, a
neighbour's load) is reported as a degradation window.

The child, on the caller's device:

1. a 128x128 bf16 matmul with a host readback, which catches a card that
   does not answer at all;
2. the served path at the bench's operating point: EfficientDet-Lite0 from
   the port's flax-equivalent random initializer, bf16, batch 128 of
   320x320 uint8 frames already on the card, through ``detect_batch``
   (preprocess, forward, the NMS kernel K1), timed by the marginal
   short/long method (``(run(12) - run(4)) / 8``, each run ending in a
   readback), which catches "small ops fine, the real graph slow". It
   prints the K1 launches it made.

The child builds the kernels it needs first (a cold build of all sources
takes about 30 s, in the build directory of
:mod:`vbt_tpu_torch.utils.cache`, which the parent passes on), and
``DEADLINE_S`` covers that.

Healthy = marginal forward below ``slow_ms`` (:data:`SLOW_MS`, 4x the
18.76 ms an H100 at 700 W takes).

Environment: ``VBT_TORCH_HEALTH_FAKE=ok|wedged|slow`` replaces the probe
body in the child (``wedged`` sleeps past the deadline, so the kill path
runs for real) and runs the probe even for a CPU device;
``VBT_TORCH_HEALTH_PROBE=0`` turns probing off (for a caller that has just
probed); ``VBT_TORCH_HEALTH_DEADLINE_S`` and ``VBT_TORCH_HEALTH_RETRY_S``
set the deadline and the retry window where a caller cannot pass them.

A CPU device skips the probe, as the JAX package skips it on its CPU
platform; a CUDA device on a machine without a card raises
(:func:`vbt_tpu_torch.utils.device.resolve_device`).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from dataclasses import dataclass

import torch

from vbt_tpu_torch.ops import _build
from vbt_tpu_torch.utils.cache import ENV_DIR
from vbt_tpu_torch.utils.device import resolve_device

# Marginal forward above this is a degradation window, not a healthy card:
# 4x the healthy figure, 18.76 ms at B = 128 on an NVIDIA H100 80GB HBM3 at
# a 700.00 W power limit (chip_smoke.py phase 14 (a)), which leaves room for
# a card capped at a lower power limit and a loaded host, while the windows
# the JAX package met were 10-55x slow.
SLOW_MS = 75.0
# Wall deadline of the whole probe subprocess: enough for a cold build of
# every kernel source (about 30 s) and the first forward; a wedged card
# blows through it and is killed.
DEADLINE_S = 240.0
# Pause between probe attempts when a retry window is active.
RETRY_SLEEP_S = 120.0
BATCH, SIZE = 128, 320

FAKE_ENV = "VBT_TORCH_HEALTH_FAKE"
PROBE_ENV = "VBT_TORCH_HEALTH_PROBE"
DEADLINE_ENV = "VBT_TORCH_HEALTH_DEADLINE_S"
RETRY_ENV = "VBT_TORCH_HEALTH_RETRY_S"

_PROBE_SRC = r"""
import os, sys, time

fake = os.environ.get("VBT_TORCH_HEALTH_FAKE", "")
if fake == "ok":
    print("HEALTH ok fwd_ms=1.0 nms_launches=0 (faked)")
    sys.exit(0)
if fake == "wedged":
    time.sleep(3600)  # a wedged card: the parent must kill us
if fake == "slow":
    print("HEALTH ok fwd_ms=5000.0 nms_launches=0 (faked)")
    sys.exit(0)

import numpy as np
import torch

from vbt_tpu_torch.utils.cache import enable_persistent_cache

enable_persistent_cache()
dev = torch.device(sys.argv[1])
batch, size = int(sys.argv[2]), int(sys.argv[3])

# 1. A tiny op with a readback: catches a card that does not answer.
x = torch.ones(128, 128, dtype=torch.bfloat16, device=dev)
assert float((x @ x).float().sum().cpu()) > 0

# 2. The served path at batch 128, timed marginally.
from vbt_tpu_torch.models import get_model_spec
from vbt_tpu_torch.ops.nms_cuda import nms
from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

spec = get_model_spec("efficientdet_lite0")
pipe = DetectionPipeline(spec, DetectionPipeline.init_variables(spec), device=dev)
rng = np.random.default_rng(0)
frames = torch.from_numpy(rng.integers(0, 255, size=(batch, size, size, 3), dtype=np.uint8)).to(dev)

def run(n):
    t0 = time.perf_counter()
    det = None
    for _ in range(n):
        det = pipe.detect_batch(frames)
    float(det.scores[0, 0].cpu())  # readback
    return time.perf_counter() - t0

run(2)  # first launches, the kernels' build if they were not built
nms.launches = 0
ms = (run(12) - run(4)) / 8 * 1e3
print(f"HEALTH ok fwd_ms={ms:.2f} nms_launches={nms.launches}")
"""


class CUDAUnhealthyError(RuntimeError):
    """The card is wedged or in a degradation window."""


@dataclass
class HealthReport:
    ok: bool
    reason: str
    forward_ms: float | None = None
    nms_launches: int | None = None  # K1 launches the child made while timing


def probe_device(device: str | torch.device = "cuda", deadline_s: float | None = None,
                 slow_ms: float = SLOW_MS) -> HealthReport:
    """Probe ``device`` from a subprocess with a hard wall deadline.

    ``deadline_s`` defaults to ``$VBT_TORCH_HEALTH_DEADLINE_S``, else
    :data:`DEADLINE_S`."""
    if deadline_s is None:
        deadline_s = float(os.environ.get(DEADLINE_ENV, DEADLINE_S))
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env[ENV_DIR] = str(_build.BUILD_DIR)  # the caller's kernel build directory
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _PROBE_SRC, str(device), str(BATCH), str(SIZE)],
            env=env, capture_output=True, text=True, timeout=deadline_s)
    except subprocess.TimeoutExpired:
        return HealthReport(
            ok=False,
            reason=(f"CUDA health probe exceeded its {deadline_s:.0f}s deadline: the card "
                    f"{device} is wedged or its driver hung. Retry later, or run on the CPU "
                    "with device='cpu'."))
    out = proc.stdout or ""
    if proc.returncode != 0 or "HEALTH ok" not in out:
        tail = (proc.stderr or out).strip().splitlines()[-3:]
        return HealthReport(ok=False,
                            reason="CUDA health probe failed: " + (" | ".join(tail) or "no output"))
    fields = dict(tok.split("=", 1) for tok in out.split() if "=" in tok)
    fwd_ms = float(fields["fwd_ms"]) if "fwd_ms" in fields else None
    launches = int(fields["nms_launches"]) if "nms_launches" in fields else None
    if fwd_ms is not None and fwd_ms > slow_ms:
        return HealthReport(
            ok=False, forward_ms=fwd_ms, nms_launches=launches,
            reason=(f"CUDA degradation window: the marginal lite0 forward is {fwd_ms:.1f} "
                    f"ms/b{BATCH} (threshold {slow_ms:.0f}). Timing and throughput measured "
                    "now would be garbage."))
    return HealthReport(ok=True, reason="healthy", forward_ms=fwd_ms, nms_launches=launches)


def require_healthy_device(device: str | torch.device = "cuda", deadline_s: float | None = None,
                           slow_ms: float = SLOW_MS, context: str = "",
                           retry_window_s: float | None = None) -> HealthReport:
    """Raise :class:`CUDAUnhealthyError` unless ``device`` is serving sanely.

    No-op with ``VBT_TORCH_HEALTH_PROBE=0`` and for a CPU device (unless a
    fake is set); a CUDA device without a card raises ``RuntimeError``.

    ``retry_window_s`` (default ``$VBT_TORCH_HEALTH_RETRY_S``, else 0) keeps
    re-probing a failing card for that many seconds before giving up. It
    retries only while the window still has room for a full sleep
    (:data:`RETRY_SLEEP_S`) plus a probe, which leaves the tail of the
    window to the caller's own work, so a window shorter than the sleep
    makes no retry, and the error says so. Interactive CLIs keep the
    fail-fast default of no retry.
    """
    if os.environ.get(PROBE_ENV, "1") == "0":
        return HealthReport(ok=True, reason="probe skipped")
    dev = resolve_device(device)
    if dev.type == "cpu" and not os.environ.get(FAKE_ENV):
        return HealthReport(ok=True, reason="probe skipped")
    if retry_window_s is None:
        retry_window_s = float(os.environ.get(RETRY_ENV, "0"))
    prefix = f"[{context}] " if context else ""
    t_start = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        rep = probe_device(dev, deadline_s=deadline_s, slow_ms=slow_ms)
        if rep.ok:
            return rep
        remaining = retry_window_s - (time.monotonic() - t_start)
        if remaining <= RETRY_SLEEP_S:
            if attempt > 1:
                tail = (f" (gave up after {attempt} probe attempts over "
                        f"{time.monotonic() - t_start:.0f}s)")
            elif retry_window_s > 0:
                tail = (f" (retry window {retry_window_s:.0f}s is too small for a "
                        f"{RETRY_SLEEP_S:.0f}s retry cycle: no retry was attempted)")
            else:
                tail = ""
            raise CUDAUnhealthyError(prefix + rep.reason + tail)
        print(f"{prefix}health probe attempt {attempt} failed "
              f"({rep.reason.splitlines()[0][:120]}); retrying for another {remaining:.0f}s",
              file=sys.stderr, flush=True)
        time.sleep(RETRY_SLEEP_S)
