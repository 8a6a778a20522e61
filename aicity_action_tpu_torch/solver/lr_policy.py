"""Learning-rate policies (port of ``aicity_action_tpu/solver/lr_policy.py``;
reference: slowfast/utils/lr_policy.py).

The reference recomputes the LR every iteration at the fractional epoch
``cur_epoch + iter / steps_per_epoch`` (``tools/train_net.py:113-115``);
:func:`make_lr_schedule` gives that as a ``step -> lr`` function of Python
floats, with the linear warmup blended in.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable


def lr_func_cosine(solver, cur_epoch: float) -> float:
    offset = solver.WARMUP_EPOCHS if solver.COSINE_AFTER_WARMUP else 0.0
    if not solver.COSINE_END_LR < solver.BASE_LR:
        raise ValueError("SOLVER.COSINE_END_LR must be below SOLVER.BASE_LR")
    return (solver.COSINE_END_LR
            + (solver.BASE_LR - solver.COSINE_END_LR)
            * (math.cos(math.pi * (cur_epoch - offset)
                        / (solver.MAX_EPOCH - offset)) + 1.0) * 0.5)


def lr_func_steps_with_relative_lrs(solver, cur_epoch: float) -> float:
    steps = list(solver.STEPS) + [solver.MAX_EPOCH]
    ind = bisect.bisect_right(steps, cur_epoch) - 1
    return solver.LRS[min(max(ind, 0), len(solver.LRS) - 1)] * solver.BASE_LR


_POLICIES = {
    "cosine": lr_func_cosine,
    "steps_with_relative_lrs": lr_func_steps_with_relative_lrs,
}


def _policy_fn(solver):
    try:
        return _POLICIES[solver.LR_POLICY]
    except KeyError:
        raise NotImplementedError(
            f"Unknown LR policy: {solver.LR_POLICY}") from None


def get_lr_at_epoch(solver, cur_epoch: float) -> float:
    """LR at a fractional epoch, with the linear warmup blended in."""
    policy = _policy_fn(solver)
    warmup = solver.WARMUP_EPOCHS
    if warmup > 0 and cur_epoch < warmup:
        lr_start = solver.WARMUP_START_LR
        lr_end = policy(solver, warmup)
        return cur_epoch * (lr_end - lr_start) / warmup + lr_start
    return policy(solver, cur_epoch)


def make_lr_schedule(solver, steps_per_epoch: int) -> Callable[[int], float]:
    """``step -> lr``: the LR of the optimizer step with that count."""

    def schedule(step: int) -> float:
        return get_lr_at_epoch(solver, step / steps_per_epoch)

    return schedule
