"""Causal smoothing as a state machine over samples, carried from chunk to chunk.

Port of ``vbt_tpu.analysis.smoother_scan``. The plot CLI smooths a whole
series at once (rolling-5 mean of x and y, expanding mean of the plate's
size, the shared 30-sample running average of VelocityTracker); a stream
sees one sample at a time. The state is all fixed-size (a 5-ring, two
expanding sums, one 30-ring shared by width and height), so one step
advances it by a sample; :mod:`vbt_tpu_torch.runtime.streaming` runs it
fused with the phase state machine, as kernel K4 on the card
(``csrc/analysis_scan.cu``) and as a loop of this step on the CPU.

Numerics are those of the host lane (``_CausalSmoother``): the 5-window
mean divides by the current count, the shared 30-ring emits total / 30
exactly when it fills and then evicts, and width then height pass through
the same ring (the reference's shared-instance quirk). The 5-ring is
summed in ring order, one add after another, as XLA sums the JAX ring;
K4 adds in the same order.

Every field is a 0-dim (or ring-shaped) tensor on one device, float64 by
default; a step does no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor
RING5, RING_RA = 5, 30


class SmootherCarry(NamedTuple):
    ring5_x: Tensor  # (5,)
    ring5_y: Tensor  # (5,)
    n5: Tensor  # () int32, samples seen, capped at 5
    pos5: Tensor  # () int32, next write slot
    exp_h_sum: Tensor
    exp_w_sum: Tensor
    exp_n: Tensor  # () int32
    ra_buf: Tensor  # (30,) shared width/height ring
    ra_total: Tensor
    ra_len: Tensor  # () int32 (29 <-> 30 once warm)
    ra_head: Tensor  # () int32 eviction pointer
    y_prev: Tensor
    has_prev: Tensor  # () bool


def initial_smoother(dtype: torch.dtype = torch.float64, device="cpu") -> SmootherCarry:
    def z(shape=()):
        return torch.zeros(shape, dtype=dtype, device=device)

    def i():
        return torch.zeros((), dtype=torch.int32, device=device)

    return SmootherCarry(ring5_x=z((RING5,)), ring5_y=z((RING5,)), n5=i(), pos5=i(),
                         exp_h_sum=z(), exp_w_sum=z(), exp_n=i(), ra_buf=z((RING_RA,)),
                         ra_total=z(), ra_len=i(), ra_head=i(), y_prev=z(),
                         has_prev=torch.zeros((), dtype=torch.bool, device=device))


def _ring_sum(ring: Tensor) -> Tensor:
    """``ring[0] + ring[1] + ...``, left to right."""
    total = ring[0]
    for k in range(1, ring.shape[0]):
        total = total + ring[k]
    return total


def _ra_update(c: SmootherCarry, value: Tensor) -> tuple[SmootherCarry, Tensor]:
    """One push into the shared running average."""
    slots = torch.arange(RING_RA, device=value.device)
    tail = torch.remainder(c.ra_head + c.ra_len, RING_RA)
    buf = torch.where(slots == tail, value, c.ra_buf)
    total = c.ra_total + value
    length = c.ra_len + 1
    full = length >= RING_RA
    out = torch.where(full, total / 30.0, total / length.to(total.dtype))
    evicted = torch.take(buf, c.ra_head.long())
    total = torch.where(full, total - evicted, total)
    head = torch.where(full, torch.remainder(c.ra_head + 1, RING_RA), c.ra_head)
    length = torch.where(full, length - 1, length)
    return c._replace(ra_buf=buf, ra_total=total, ra_len=length.to(torch.int32),
                      ra_head=head.to(torch.int32)), out


def smoother_step(c: SmootherCarry, inp) -> tuple[SmootherCarry, tuple[Tensor, ...]]:
    """One raw sample -> (carry, (x_s, y_s, dy_eff, w_ra, h_ra)).

    ``inp`` = (x, y, dy_raw, norm_plate_height, norm_plate_width), 0-dim."""
    x, y, dy_raw, nph, npw = inp
    at = torch.arange(RING5, device=x.device) == c.pos5
    ring5_x = torch.where(at, x, c.ring5_x)
    ring5_y = torch.where(at, y, c.ring5_y)
    n5 = torch.clamp(c.n5 + 1, max=RING5).to(torch.int32)
    pos5 = torch.remainder(c.pos5 + 1, RING5).to(torch.int32)
    denom = n5.to(ring5_x.dtype)
    x_s = _ring_sum(ring5_x) / denom
    y_s = _ring_sum(ring5_y) / denom

    exp_h = c.exp_h_sum + nph
    exp_w = c.exp_w_sum + npw
    exp_n = (c.exp_n + 1).to(torch.int32)
    h_e = exp_h / exp_n.to(exp_h.dtype)
    w_e = exp_w / exp_n.to(exp_w.dtype)

    c = c._replace(ring5_x=ring5_x, ring5_y=ring5_y, n5=n5, pos5=pos5, exp_h_sum=exp_h,
                   exp_w_sum=exp_w, exp_n=exp_n)
    # Width first, then height, through the same ring (the shared-instance quirk).
    c, w_ra = _ra_update(c, w_e)
    c, h_ra = _ra_update(c, h_e)

    dy_eff = torch.where(c.has_prev, y_s - c.y_prev, dy_raw)
    c = c._replace(y_prev=y_s, has_prev=torch.ones_like(c.has_prev))
    return c, (x_s, y_s, dy_eff, w_ra, h_ra)
