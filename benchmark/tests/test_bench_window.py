"""The window's whole-unit timing arithmetic, on a clock the test drives."""

import pytest

from harness import window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("durations,seconds,units", [
    ([0.4] * 10, 1.0, 3),  # starts at 0, 0.4, 0.8; the third ends at 1.2
    ([2.5], 1.0, 1),  # one unit longer than the window still runs whole
    ([0.5, 0.5, 0.5], 1.0, 2),  # a unit ending exactly at the deadline starts no other
    ([0.1, 3.0, 0.1, 0.1], 1.5, 2),
])
def test_whole_units_and_interval(durations, seconds, units):
    clock = Clock()
    started = []

    def unit(i):
        started.append(clock.t)
        clock.t += durations[i]

    w = window.run(seconds, unit, clock)
    assert w.units == units
    assert all(t < 100.0 + seconds for t in started)
    assert w.interval_s == pytest.approx(sum(durations[:units]))
    assert w.per_unit_s() == pytest.approx(sum(durations[:units]) / units)
    assert w.unit_s == pytest.approx(durations[:units])


def test_a_stall_counts_in_the_interval():
    clock = Clock()
    step = {1: 0.75}
    w = window.run(1.0, lambda i: setattr(clock, "t", clock.t + step.get(i, 0.125)), clock)
    assert w.units == 3 and w.interval_s == pytest.approx(1.0)
    assert max(w.unit_s) == 0.75


@pytest.mark.parametrize("n,q,want", [(10, 0.9, 9), (65, 0.9, 59), (1, 0.9, 1), (20, 0.5, 10)])
def test_percentile_is_nearest_rank(n, q, want):
    w = window.Window(0.0, 1.0, [float(i) for i in range(n, 0, -1)])
    assert w.percentile_s(q) == want
