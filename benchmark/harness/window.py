"""The measured window: whole units of work, back to back, until the
window's length has passed.  No unit starts after it; the timed interval
runs from the window's start to the end of the last unit, so a stall
anywhere in it counts."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, List


@dataclass
class Window:
    start: float
    end: float
    unit_s: List[float] = field(default_factory=list)

    @property
    def interval_s(self) -> float:
        return self.end - self.start

    @property
    def units(self) -> int:
        return len(self.unit_s)

    def per_unit_s(self) -> float:
        """The timed interval over the units completed."""
        return self.interval_s / self.units

    def percentile_s(self, q: float) -> float:
        """The q-quantile of the single units (nearest rank)."""
        xs = sorted(self.unit_s)
        return xs[max(math.ceil(q * len(xs)), 1) - 1]


def run(seconds: float, unit: Callable[[int], None],
        clock: Callable[[], float] = time.perf_counter) -> Window:
    """Call unit(i) for i = 0, 1, ... while the clock is short of
    start + seconds; each call is one whole unit, ending on the device."""
    w = Window(clock(), 0.0)
    deadline = w.start + seconds
    t = w.start
    while t < deadline:
        unit(len(w.unit_s))
        t1 = clock()
        w.unit_s.append(t1 - t)
        t = t1
    w.end = t
    return w
