"""The measured window's rules, on a fake clock."""

import pytest

from port_bench import window


class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("pace,seconds,units,span", [
    (7.0, 30.0, 4, 28.0),    # a 5th view would end at 28 + 7 > 30
    (6.0, 30.0, 5, 30.0),    # a 5th ends on the mark, so it runs
    (7.5, 30.0, 4, 30.0),    # the 4th ends on the mark; a 5th would not fit
    (26.0, 30.0, 1, 26.0),   # one long view; a 2nd would end at 52
    (40.0, 30.0, 1, 40.0),   # at least one, however long
])
def test_units_until_another_would_end_late(pace, seconds, units, span):
    clock = Clock()

    def unit(i):
        clock.now += pace

    assert window.run_units(unit, seconds, clock) == (units, span)


def test_units_follow_the_last_ones_pace():
    clock = Clock()
    paces = [2.0, 10.0, 10.0, 1.0]

    def unit(i):
        clock.now += paces[i]

    # after 12 s, at the last pace (10 s) a 3rd would end at 22 <= 25
    # and runs; after 22 s a 4th would end at 32 > 25
    assert window.run_units(unit, 25.0, clock) == (3, 22.0)


def test_steps_until_the_time_then_sync():
    clock = Clock()
    done = []

    def step(i):
        clock.now += 1.3

    def sync():
        clock.now += 0.7  # the queue drains
        done.append(clock.now)

    n, span = window.run_steps(step, 10.0, sync, clock)
    assert n == 8  # starts at 0, 1.3, ..., 9.1; not at 10.4
    assert span == pytest.approx(8 * 1.3 + 0.7)
    assert done == [pytest.approx(span)]
