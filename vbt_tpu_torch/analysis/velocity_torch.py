"""Phase segmentation as a two-pass torch program, on a named device.

Port of ``vbt_tpu.analysis.velocity_jax``; the semantics are those of the
host lane (:mod:`vbt_tpu_torch.analysis.velocity`). The control-flow state
(phase, direction counters, running ``max_y_diff``, the bar path's extrema
with their time and path-length prefix) never depends on the accepted
phases, so:

- **Pass 1** carries that O(1) state over the samples: a Python loop of
  torch ops with no ``.item()`` inside, so on the card the samples queue up
  without a sync. A phase end emits a complete candidate record; the prefix
  difference between the two extrema is the reference's pairwise path sum.
- **Pass 2** (vectorized) applies the acceptance gate
  ``y_diff > max_y_diff * diff_threshold``, ``rom >= min_distance`` and the
  retroactive ``y_diff >= final_max_y_diff / 2`` filter to every candidate.

Everything is float64 on the device the caller names (``device="cuda"``
by default; it raises without a card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vbt_tpu_torch.analysis.phase import CONCENTRIC, ECCENTRIC, HOLD, Phase
from vbt_tpu_torch.analysis.smoothing import expanding_mean, rolling_mean, shared_plate_average
from vbt_tpu_torch.analysis.velocity import END_COUNT, START_COUNT
from vbt_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


class VelocityCarry(NamedTuple):
    phase: Tensor  # int32
    pos: Tensor  # int32
    neg: Tensor  # int32
    max_y_diff: Tensor  # -inf == "no phase seen yet"
    pmax_y: Tensor  # running path max (first occurrence) + its time/prefix
    pmax_t: Tensor
    pmax_prefix: Tensor
    pmin_y: Tensor
    pmin_t: Tensor
    pmin_prefix: Tensor
    prefix: Tensor  # running metric-path-length prefix (inclusive)
    pa_x: Tensor  # previous appended sample (for path-length increments)
    pa_y: Tensor
    pa_w: Tensor
    pa_h: Tensor
    pa_valid: Tensor  # bool


class EventRecord(NamedTuple):
    """One phase-end candidate (``fired`` False where no phase ended)."""

    fired: Tensor
    type: Tensor
    time_start: Tensor
    time_end: Tensor
    y_start: Tensor
    y_end: Tensor
    rom: Tensor
    y_diff: Tensor
    max_after: Tensor  # running max_y_diff including this candidate


class PhaseArrays(NamedTuple):
    """Fixed-shape segmentation result (one slot per sample + the flush)."""

    valid: Tensor
    type: Tensor
    time_start: Tensor
    time_end: Tensor
    y_start: Tensor
    y_end: Tensor
    rom: Tensor


def initial_carry(dtype: torch.dtype = torch.float64, device="cpu") -> VelocityCarry:
    def f(v):
        return torch.tensor(v, dtype=dtype, device=device)

    def i(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    inf = float("inf")
    return VelocityCarry(
        phase=i(HOLD), pos=i(0), neg=i(0), max_y_diff=f(-inf),
        pmax_y=f(-inf), pmax_t=f(0.0), pmax_prefix=f(0.0),
        pmin_y=f(inf), pmin_t=f(0.0), pmin_prefix=f(0.0),
        prefix=f(0.0), pa_x=f(0.0), pa_y=f(0.0), pa_w=f(1.0), pa_h=f(1.0),
        pa_valid=torch.tensor(False, device=device),
    )


def _event_from_carry(c: VelocityCarry):
    """(s_t, e_t, s_y, e_y, rom, y_diff) for a phase ending now."""
    is_conc = c.phase == CONCENTRIC
    s_t = torch.where(is_conc, c.pmax_t, c.pmin_t)
    e_t = torch.where(is_conc, c.pmin_t, c.pmax_t)
    s_y = torch.where(is_conc, c.pmax_y, c.pmin_y)
    e_y = torch.where(is_conc, c.pmin_y, c.pmax_y)
    s_p = torch.where(is_conc, c.pmax_prefix, c.pmin_prefix)
    e_p = torch.where(is_conc, c.pmin_prefix, c.pmax_prefix)
    return s_t, e_t, s_y, e_y, e_p - s_p, c.pmax_y - c.pmin_y


def velocity_step(plate_diameter: Tensor, c: VelocityCarry,
                  inp) -> tuple[VelocityCarry, EventRecord]:
    """One sample of the reference state machine (0-dim tensors in ``inp``:
    time, dy, x, y, width, height)."""
    tv, dy, xv, yv, wv, hv = inp
    zero = torch.zeros((), dtype=c.pmax_y.dtype, device=c.pmax_y.device)

    def masked_append(c: VelocityCarry, mask: Tensor) -> VelocityCarry:
        dx_m = torch.abs(xv - c.pa_x) / ((wv + c.pa_w) / 2) * plate_diameter
        dy_m = torch.abs(yv - c.pa_y) / ((hv + c.pa_h) / 2) * plate_diameter
        contrib = torch.where(c.pa_valid, dx_m + dy_m, zero)
        prefix = c.prefix + torch.where(mask, contrib, zero)
        new_max = mask & (yv > c.pmax_y)
        new_min = mask & (yv < c.pmin_y)
        return c._replace(
            prefix=prefix,
            pmax_y=torch.where(new_max, yv, c.pmax_y),
            pmax_t=torch.where(new_max, tv, c.pmax_t),
            pmax_prefix=torch.where(new_max, prefix, c.pmax_prefix),
            pmin_y=torch.where(new_min, yv, c.pmin_y),
            pmin_t=torch.where(new_min, tv, c.pmin_t),
            pmin_prefix=torch.where(new_min, prefix, c.pmin_prefix),
            pa_x=torch.where(mask, xv, c.pa_x),
            pa_y=torch.where(mask, yv, c.pa_y),
            pa_w=torch.where(mask, wv, c.pa_w),
            pa_h=torch.where(mask, hv, c.pa_h),
            pa_valid=c.pa_valid | mask,
        )

    # record the sample on the active bar path
    c = masked_append(c, c.phase != HOLD)

    # concentric end check
    is_conc = c.phase == CONCENTRIC
    pos1 = torch.where(is_conc, torch.where(dy > 0, c.pos + 1, 0), c.pos)
    neg1 = torch.where(is_conc & (dy > 0), 0, c.neg)
    conc_end = is_conc & (dy > 0) & (pos1 >= END_COUNT)

    # eccentric end check; note the asymmetric else branch
    is_ecc = c.phase == ECCENTRIC
    neg2 = torch.where(is_ecc, torch.where(dy < 0, neg1 + 1, 0), neg1)
    pos2 = torch.where(is_ecc, torch.where(dy < 0, 0, pos1 + 1), pos1)
    ecc_end = is_ecc & (dy < 0) & (neg2 >= END_COUNT)

    ended = conc_end | ecc_end
    etype = c.phase
    s_t, e_t, s_y, e_y, rom, y_diff = _event_from_carry(c)
    max_after = torch.where(ended & (y_diff > c.max_y_diff), y_diff, c.max_y_diff)

    phase1 = torch.where(ended, HOLD, c.phase)
    pos3 = torch.where(ended, 0, pos2)
    neg3 = torch.where(ended, 0, neg2)

    # HOLD, negative dy: count toward a concentric start
    hn = (dy < 0) & (phase1 == HOLD)
    neg4 = torch.where(hn, neg3 + 1, neg3)
    pos4 = torch.where(hn, 0, pos3)
    reset_n = hn & (neg4 == 1)
    app_n = hn & (neg4 != 1)
    start_c = hn & (neg4 >= START_COUNT)
    phase2 = torch.where(start_c, CONCENTRIC, phase1)
    pos5 = torch.where(start_c, 0, pos4)
    neg5 = torch.where(start_c, 0, neg4)

    # HOLD, positive dy: count toward an eccentric start
    hp = (dy > 0) & (phase2 == HOLD)
    pos6 = torch.where(hp, pos5 + 1, pos5)
    neg6 = torch.where(hp, 0, neg5)
    reset_p = hp & (pos6 == 1)
    app_p = hp & (pos6 != 1)
    start_e = hp & (pos6 >= START_COUNT)
    phase3 = torch.where(start_e, ECCENTRIC, phase2)
    pos7 = torch.where(start_e, 0, pos6)
    neg7 = torch.where(start_e, 0, neg6)

    # a bar-path reset drops the triggering sample
    reset = reset_n | reset_p
    inf = float("inf")
    c = c._replace(
        pmax_y=torch.where(reset, -inf, c.pmax_y),
        pmin_y=torch.where(reset, inf, c.pmin_y),
        pa_valid=torch.where(reset, False, c.pa_valid),
    )

    # pre-start appends while counting in HOLD
    c = masked_append(c, app_n | app_p)

    carry = c._replace(phase=phase3, pos=pos7, neg=neg7, max_y_diff=max_after)
    event = EventRecord(fired=ended, type=etype, time_start=s_t, time_end=e_t, y_start=s_y,
                        y_end=e_y, rom=rom, y_diff=y_diff, max_after=max_after)
    return carry, event


def flush_event(c: VelocityCarry) -> tuple[VelocityCarry, EventRecord]:
    """End-of-stream flush of an open phase."""
    fired = c.phase != HOLD
    s_t, e_t, s_y, e_y, rom, y_diff = _event_from_carry(c)
    max_after = torch.where(fired & (y_diff > c.max_y_diff), y_diff, c.max_y_diff)
    event = EventRecord(fired=fired, type=c.phase, time_start=s_t, time_end=e_t, y_start=s_y,
                        y_end=e_y, rom=rom, y_diff=y_diff, max_after=max_after)
    return c._replace(max_y_diff=max_after), event


def finalize_events(events: EventRecord, final_max: Tensor, diff_threshold: float,
                    min_distance: float) -> PhaseArrays:
    """Pass 2: vectorized acceptance + the one-shot retroactive filter."""
    accept = (events.fired
              & (events.y_diff > events.max_after * diff_threshold)
              & (events.rom >= min_distance)
              & (events.y_diff >= final_max / 2))
    return PhaseArrays(valid=accept, type=events.type, time_start=events.time_start,
                       time_end=events.time_end, y_start=events.y_start, y_end=events.y_end,
                       rom=events.rom)


def segment_phases(time: Tensor, x: Tensor, y: Tensor, dy: Tensor, width: Tensor,
                   height: Tensor, plate_diameter: float, diff_threshold: float = 0.6,
                   min_distance: float = 0.1) -> PhaseArrays:
    """The two passes over pre-smoothed sample tensors (one device, one
    dtype); ``width``/``height`` already through the shared running average
    and ``dy`` already the finite difference (:func:`analyze_series`)."""
    c = initial_carry(y.dtype, y.device)
    pd_ = torch.tensor(plate_diameter, dtype=y.dtype, device=y.device)
    events = []
    for i in range(y.shape[0]):
        c, ev = velocity_step(pd_, c, (time[i], dy[i], x[i], y[i], width[i], height[i]))
        events.append(ev)
    c, flush = flush_event(c)
    events.append(flush)
    stacked = EventRecord(*(torch.stack(field) for field in zip(*events)))
    return finalize_events(stacked, c.max_y_diff, diff_threshold, min_distance)


def analyze_series(time, x, y, dx, dy, norm_plate_height, norm_plate_width,
                   plate_diameter: float = 0.45, diff_threshold: float = 0.6,
                   min_distance: float = 0.1, presmooth: bool = True,
                   device="cuda") -> PhaseArrays:
    """One track's raw measurement series -> phases, float64 on ``device``.

    With ``presmooth`` it first applies the plot CLI's smoothing (rolling-5
    mean on x, y, dx, dy; expanding mean on the plate dimensions); then the
    shared running-average plate smoothing, the dy finite-difference
    override and the two passes."""
    dev = resolve_device(device)
    time, x, y, dx, dy, norm_plate_height, norm_plate_width = (
        torch.tensor(a, dtype=torch.float64, device=dev) if not isinstance(a, torch.Tensor)
        else a.to(device=dev, dtype=torch.float64)
        for a in (time, x, y, dx, dy, norm_plate_height, norm_plate_width))
    if presmooth:
        x, y, dx, dy = (rolling_mean(a, 5) for a in (x, y, dx, dy))
        norm_plate_height = expanding_mean(norm_plate_height)
        norm_plate_width = expanding_mean(norm_plate_width)
    width, height = shared_plate_average(norm_plate_width, norm_plate_height)
    dy_eff = torch.cat([dy[:1], torch.diff(y)])
    return segment_phases(time, x, y, dy_eff, width, height, plate_diameter=plate_diameter,
                          diff_threshold=diff_threshold, min_distance=min_distance)


def to_phase_list(pa: PhaseArrays) -> list[Phase]:
    """Compact the fixed-shape result into the ordered host Phase list (one
    copy to the host)."""
    fields = {k: v.cpu().tolist() for k, v in pa._asdict().items()}
    return [Phase(time_start=fields["time_start"][i], time_end=fields["time_end"][i],
                  y_start=fields["y_start"][i], y_end=fields["y_end"][i],
                  rom=fields["rom"][i], type=int(fields["type"][i]))
            for i, ok in enumerate(fields["valid"]) if ok]
