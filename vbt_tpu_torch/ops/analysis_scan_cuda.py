"""The streaming analysis of a chunk: kernel K4 (``csrc/analysis_scan.cu``)
and its plain version.

One chunk of a followed track's samples goes through the causal smoother
(:func:`~vbt_tpu_torch.analysis.smoother_scan.smoother_step`) and the phase
state machine (:func:`~vbt_tpu_torch.analysis.velocity_torch.velocity_step`),
float64, both carries in and out, one ``EventRecord`` a sample. This
replaces what XLA compiled from ``vbt_tpu/runtime/streaming.py::analysis_chunk``
(no Pallas counterpart).

:func:`analysis_scan` sends CUDA tensors to the kernel, one launch a chunk
(``analysis_scan.launches`` counts them), and CPU tensors to
:func:`analysis_chunk_plain`, the Python loop of the two steps. On the card
it takes float64 samples and carries of the layout :func:`initial_smoother`
and :func:`initial_carry` make, contiguous, on one device; it raises on
anything else and has no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vbt_tpu_torch.analysis.smoother_scan import SmootherCarry, initial_smoother, smoother_step
from vbt_tpu_torch.analysis.velocity_torch import (
    EventRecord,
    VelocityCarry,
    initial_carry,
    velocity_step,
)
from vbt_tpu_torch.ops import _build
from vbt_tpu_torch.utils.profiling import launch_counter

Tensor = torch.Tensor
_INT = torch.int32
_F64 = torch.float64
_EVENT_DTYPES = (torch.bool, _INT) + (_F64,) * 7  # EventRecord's fields in order


@functools.cache
def _launcher():
    """``vbt_analysis_scan_launch`` of the built library, its C signature declared."""
    return _build.bind("analysis_scan", "vbt_analysis_scan_launch",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6)


def analysis_chunk_plain(plate_diameter: Tensor, smoother: SmootherCarry, carry: VelocityCarry,
                         inputs) -> tuple[SmootherCarry, VelocityCarry, EventRecord]:
    """The plain version of K4: ``inputs`` = (time, x, y, dy_raw, nph, npw),
    each (N,), one smoother step and one phase step a sample."""
    events = []
    for i in range(inputs[0].shape[0]):
        t, x, y, dy, nph, npw = (col[i] for col in inputs)
        smoother, (x_s, y_s, dy_eff, w_ra, h_ra) = smoother_step(smoother, (x, y, dy, nph, npw))
        carry, ev = velocity_step(plate_diameter, carry, (t, dy_eff, x_s, y_s, w_ra, h_ra))
        events.append(ev)
    return smoother, carry, stack_events(events, inputs[0].device)


def stack_events(events: list[EventRecord], device) -> EventRecord:
    """Per-sample 0-dim records -> one record of (N,) fields."""
    if not events:
        return EventRecord(*(torch.empty(0, dtype=d, device=device) for d in _EVENT_DTYPES))
    return EventRecord(*(torch.stack(field) for field in zip(*events)))


@functools.cache
def _carry_layouts() -> tuple[SmootherCarry, VelocityCarry]:
    """The carries K4 takes, as shapes and dtypes only (float64, on the meta
    device). Cached: building them costs the host more than a launch."""
    return initial_smoother(_F64, "meta"), initial_carry(_F64, "meta")


def analysis_scan(plate_diameter: Tensor, smoother: SmootherCarry, carry: VelocityCarry,
                  inputs) -> tuple[SmootherCarry, VelocityCarry, EventRecord]:
    """One chunk: ``inputs`` = (time, x, y, dy_raw, nph, npw), each (N,)
    float64 -> (smoother, carry, events (N,) each field). CUDA tensors go to
    kernel K4, CPU tensors to :func:`analysis_chunk_plain`."""
    inputs = tuple(inputs)
    dev = inputs[0].device
    if dev.type == "cpu":
        return analysis_chunk_plain(plate_diameter, smoother, carry, inputs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = inputs[0].shape[0]
    if len(inputs) != 6 or any(c.dtype != _F64 or tuple(c.shape) != (n,) or c.device != dev
                               or not c.is_contiguous() for c in inputs):
        raise TypeError("the kernel takes six contiguous float64 (N,) sample columns on one "
                        f"device, got {[(c.dtype, tuple(c.shape), str(c.device)) for c in inputs]}")
    if plate_diameter.dtype != _F64 or plate_diameter.numel() != 1 or plate_diameter.device != dev:
        raise TypeError(f"want a float64 plate diameter on {dev}, got {plate_diameter.dtype} "
                        f"{tuple(plate_diameter.shape)} on {plate_diameter.device}")
    smoother_layout, carry_layout = _carry_layouts()
    s_in = _build.check_layout("smoother", smoother, smoother_layout, dev)
    v_in = _build.check_layout("carry", carry, carry_layout, dev)
    s_out = SmootherCarry(*(torch.empty_like(t) for t in s_in))
    v_out = VelocityCarry(*(torch.empty_like(t) for t in v_in))
    events = EventRecord(*(torch.empty(n, dtype=d, device=dev) for d in _EVENT_DTYPES))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(_build.pointers(inputs), plate_diameter.data_ptr(), n,
                          *map(_build.pointers, (s_in, v_in, s_out, v_out, events)), stream)
    if err != 0:
        raise RuntimeError(f"analysis_scan kernel launch failed: cudaError {err}")
    analysis_scan.launches += 1
    return s_out, v_out, events


launch_counter(analysis_scan)
