"""Running a cell of a tiny checkout on the CPU, past the look for a card
(``port_bench/run.py:main`` makes that look; everything after it runs)."""

from __future__ import annotations

import time
import types

import torch

from port_bench import run
from port_bench.registry import Registry

SEED = 2 ** 31 + 4_242  # past 32 signed bits, as a check's seeds may be


def run_cell(root, cell: str, seed: int = SEED, seconds: float = 0.2,
             trace: bool = False) -> tuple[dict, object]:
    """``(result line, record)`` of one CPU run of ``cell``."""
    registry = Registry(root)
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=int(trace))
    ctx = run.context(registry, cell, args, torch.device("cpu"),
                      time.perf_counter())
    record = run.execute(ctx)
    device = {"platform": "cpu", "kind": "cpu", "count": 1}
    return run.result_line(ctx, record, device), record


def context(root, cell: str, seed: int = SEED):
    return run.context(Registry(root), cell, types.SimpleNamespace(
        seed=seed, seconds=0.0, trace=0), torch.device("cpu"),
        time.perf_counter())
