"""Phase value object: one concentric or eccentric segment of a set.

Copy of ``vbt_tpu.analysis.phase``.

Behavioural contract from the reference Phase class (Phase.py:6-40):
integer phase-type codes, start/end time and y position, metric ROM, and
the derived ``y_diff`` / ``duration`` properties.
"""

from __future__ import annotations

from dataclasses import dataclass

CONCENTRIC = 0
ECCENTRIC = 1
HOLD = 2

_NAMES = {CONCENTRIC: "concentric", ECCENTRIC: "eccentric", HOLD: "hold"}


@dataclass
class Phase:
    time_start: float
    time_end: float
    y_start: float
    y_end: float
    rom: float  # range of motion [m]
    type: int

    # Class-level aliases so callers can use Phase.CONCENTRIC like the
    # reference API (Phase.py:12-14).
    CONCENTRIC = CONCENTRIC
    ECCENTRIC = ECCENTRIC
    HOLD = HOLD

    @property
    def y_diff(self) -> float:
        return abs(self.y_start - self.y_end)

    @property
    def duration(self) -> float:
        return self.time_end - self.time_start

    def __str__(self) -> str:
        return (
            f"{_NAMES.get(self.type, 'hold')}, t_start: {self.time_start}, "
            f"t_end: {self.time_end}, y_start: {self.y_start}, y_end: {self.y_end}"
        )
