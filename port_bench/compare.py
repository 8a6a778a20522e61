"""The numbers that decide ``correct``, each held against its limit.

Scoring: :func:`score_gap`, the widest relative gap between the program's
and the reference's centred log-scores of one window (the centred logits:
softmax's shift removed), over the windows compared.

Training (each step's loss, the first gradient as the optimizer gets it,
the parameters' change over the checked steps): :func:`rel_gap` for a
scalar; :func:`leaf_gap`, the largest gap between the program's norm of a
leaf and the reference's, over the larger of the reference's norm of that
leaf and of the median leaf.
"""

from __future__ import annotations

import math
import statistics

import torch


def score_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """``prog``, ``ref``: softmax scores ``[N, classes]``."""
    lp = torch.log(prog.double().clamp_min(1e-30))
    lr = torch.log(ref.double().clamp_min(1e-30))
    lp = lp - lp.mean(dim=1, keepdim=True)
    lr = lr - lr.mean(dim=1, keepdim=True)
    gap = (lp - lr).norm(dim=1) / lr.norm(dim=1).clamp_min(1e-30)
    return float(gap.max())


def rel_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-30)


def leaf_gap(prog: dict, ref: dict, names=None) -> tuple[float, str]:
    """``(gap, worst leaf)`` over ``names`` (every leaf of ``ref``)."""
    names = list(ref if names is None else names)
    med = statistics.median(ref[n] for n in names)
    worst, at = -1.0, ""
    for n in names:
        g = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if g > worst:
            worst, at = g, n
    return worst, at


def moving_leaves(grad_ref: dict) -> list[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(grad_ref.values())
    return [n for n, v in grad_ref.items() if v >= 1e-3 * med]


def check(name: str, value: float, limit: float) -> dict:
    """One compared number; it passes at or under its limit (a NaN
    fails)."""
    ok = not math.isnan(value) and value <= limit
    return {"name": name, "value": value, "limit": limit, "ok": ok}
