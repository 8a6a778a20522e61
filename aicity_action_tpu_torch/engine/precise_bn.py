"""Precise BatchNorm statistics (port of ``aicity_action_tpu/engine/
precise_bn.py``; reference: fvcore ``update_bn_stats``, used at
train_net.py:543-564).

The running statistics of every BatchNorm become the plain average of the
raw batch statistics over ``num_batches`` batches, each batch weighted
equally. Under data parallelism each batch's statistics are those of the
global batch (the BatchNorm all-reduces them), so every rank ends with the
same averages. The JAX package recovers each batch's statistics by
inverting flax's EMA; the port's BatchNorm hands them over directly
(``models/convnets.py:collect_bn_stats``).

The forwards run with every BatchNorm in training mode and every other
module in eval mode: dropout and drop-connect act after or beside the
norms and need a generator, and neither changes what a norm sees.
"""

from __future__ import annotations

from typing import Iterable

import torch

from ..models.convnets import collect_bn_stats, is_bn


@torch.no_grad()
def calculate_and_update_precise_bn(model: torch.nn.Module,
                                    batches: Iterable, *,
                                    num_batches: int) -> int:
    """Replace the running statistics of ``model``'s BatchNorms by their
    average over the first ``num_batches`` of ``batches`` (each the
    model's input, or a tuple of its positional arguments: a detection
    model's input and boxes). Returns the number of batches used; with
    none the statistics stay as they were."""
    norms = [m for m in model.modules() if is_bn(m)]
    if not norms or num_batches <= 0:
        return 0
    was_training = model.training
    model.eval()
    for m in norms:
        m.train()
    sums = {id(m): [torch.zeros_like(m.running_mean),
                    torch.zeros_like(m.running_var)] for m in norms}
    saved = {id(m): (m.running_mean.clone(), m.running_var.clone())
             for m in norms}
    seen = 0
    try:
        for x in batches:
            if seen >= num_batches:
                break
            with collect_bn_stats() as stats:
                model(*x) if isinstance(x, tuple) else model(x)
            for m, mean, var in stats:
                acc = sums[id(m)]
                acc[0] += mean
                acc[1] += var
            seen += 1
    finally:
        model.train(was_training)
    for m in norms:
        mean, var = saved[id(m)]
        if seen:
            mean, var = (a / seen for a in sums[id(m)])
        m.running_mean.copy_(mean)
        m.running_var.copy_(var)
    return seen
