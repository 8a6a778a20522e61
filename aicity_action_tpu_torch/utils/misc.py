"""Miscellaneous utilities (port of ``aicity_action_tpu/utils/misc.py``;
reference: slowfast/utils/misc.py).

Model statistics (parameters, and forward FLOPs from
``torch.utils.flop_counter.FlopCounterMode`` where the JAX package asks
XLA's cost analysis), memory logging, the NaN check, the eval cadence and
class names, and ``frozen_bn_stats``.
"""

from __future__ import annotations

import json
import math
from typing import Optional

import torch

from .logging import get_logger

logger = get_logger(__name__)


def check_nan_losses(loss: float) -> None:
    """Raise on NaN loss (reference misc.py:26-32)."""
    if math.isnan(loss):
        raise RuntimeError("ERROR: Got NaN losses")


def params_count(model: torch.nn.Module) -> int:
    """Number of parameters of ``model`` (reference misc.py params_count)."""
    return sum(p.numel() for p in model.parameters())


def get_flop_stats(model: torch.nn.Module, example_inputs) -> float:
    """Forward GFLOPs of ``model`` on ``example_inputs`` (its input, or a
    tuple of its positional arguments as ``models/build.py:
    example_inputs`` gives them), counted by ``FlopCounterMode`` (replaces
    fvcore's count, reference misc.py:78-206). The model runs once in eval
    mode without gradients; on the CPU every kernel wrapper runs its plain
    version, which the counter sees."""
    from torch.utils.flop_counter import FlopCounterMode

    args = example_inputs if isinstance(example_inputs, tuple) \
        else (example_inputs,)
    was_training = model.training
    model.eval()
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(*args)
    model.train(was_training)
    return counter.get_total_flops() / 1e9


def gpu_mem_usage() -> float:
    """Peak device memory in GB (``torch.cuda.max_memory_allocated``), 0
    without a card."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / 1024 ** 3


def cpu_mem_usage() -> tuple[float, float]:
    """(used, total) host memory in GB, from ``/proc/meminfo``."""
    try:
        with open("/proc/meminfo") as f:
            info = {}
            for line in f:
                k, v = line.split(":")
                info[k] = int(v.strip().split()[0]) * 1024
    except OSError:
        return 0.0, 0.0
    total = info["MemTotal"] / 1024 ** 3
    avail = info["MemAvailable"] / 1024 ** 3
    return total - avail, total


def log_model_info(model: torch.nn.Module, example_inputs=None) -> None:
    logger.info("Model: %s", type(model).__name__)
    logger.info("Params: {:,}".format(params_count(model)))
    logger.info("Mem: %.2f GB", gpu_mem_usage())
    if example_inputs is not None:
        logger.info("FLOPs: %.2f G", get_flop_stats(model, example_inputs))


def is_eval_epoch(cfg, cur_epoch: int, multigrid_schedule=None) -> bool:
    """Eval cadence, multigrid-aware (reference misc.py:209-230)."""
    if cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH:
        return True
    if multigrid_schedule is not None:
        prev_epoch = 0
        for s in multigrid_schedule:
            if cur_epoch < s[-1]:
                period = max(
                    (s[-1] - prev_epoch) // cfg.MULTIGRID.EVAL_FREQ + 1, 1
                )
                return (s[-1] - 1 - cur_epoch) % period == 0
            prev_epoch = s[-1]
    return (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0


def get_class_names(path: str, parent_path: Optional[str] = None,
                    subset_path: Optional[str] = None):
    """Class names from a ``{name: index}`` json, with the optional parent
    groups and subset (reference misc.py:get_class_names)."""
    with open(path) as f:
        class2idx = json.load(f)
    max_key = max(class2idx.values())
    class_names = [None] * (max_key + 1)
    for k, i in class2idx.items():
        class_names[i] = k

    class_parent = None
    if parent_path:
        with open(parent_path) as f:
            d_parent = json.load(f)
        class_parent = {}
        for parent, children in d_parent.items():
            indices = [
                class2idx[c] for c in children if class2idx.get(c) is not None
            ]
            class_parent[parent] = indices

    subset_ids = None
    if subset_path:
        with open(subset_path) as f:
            subset = f.read().split("\n")
            subset_ids = [
                class2idx[name] for name in subset
                if class2idx.get(name) is not None
            ]
    return class_names, class_parent, subset_ids


def frozen_bn_stats(model: torch.nn.Module) -> torch.nn.Module:
    """Put every BatchNorm of ``model`` in eval mode, so that a training
    forward normalizes with, and leaves unchanged, its running statistics
    (reference misc.py ``frozen_bn_stats``; the JAX package's eval step
    never writes ``batch_stats``). Returns ``model``."""
    from ..models.convnets import is_bn

    for m in model.modules():
        if is_bn(m):
            m.eval()
    return model
