"""The measured window's rules, with the clock passed in so that a test can
drive them with a fake one.

- Whole units (views): at least one; another starts only if, at the pace
  of the last one, it would end within ``seconds`` of the window's start.
  The window ends when the last unit has ended.
- Steps: steps start until ``seconds`` have passed; the window ends when
  ``sync()`` returns, with every step's work done.
"""

from __future__ import annotations

import time
from typing import Callable


def run_units(unit: Callable[[int], None], seconds: float,
              clock: Callable[[], float] = time.perf_counter
              ) -> tuple[int, float]:
    """Runs ``unit(0)``, ``unit(1)``, ... by the rule; returns ``(units,
    window seconds)``."""
    start = clock()
    n = 0
    while True:
        t = clock()
        unit(n)
        end = clock()
        n += 1
        if (end - start) + (end - t) > seconds:
            return n, end - start


def run_steps(step: Callable[[int], None], seconds: float,
              sync: Callable[[], None],
              clock: Callable[[], float] = time.perf_counter
              ) -> tuple[int, float]:
    """Runs ``step(0)``, ``step(1)``, ... until ``seconds`` have passed,
    then ``sync()``; returns ``(steps, window seconds)``."""
    start = clock()
    n = 0
    while clock() - start < seconds:
        step(n)
        n += 1
    sync()
    return n, clock() - start
