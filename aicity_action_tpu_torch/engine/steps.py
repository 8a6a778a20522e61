"""Train and eval steps (port of ``aicity_action_tpu/engine/steps.py:48-153,
265-270``; reference: tools/train_net.py:83-324).

One train step is: the step's random draws, mixup (or one-hot targets for a
soft-target loss), forward in training mode, the loss (masked to the
``n_valid`` real samples of a padded final batch), backward, clipping and
the optimizer update at the scheduled LR (:class:`TrainOptimizer`). On the
card every Pallas kernel the JAX step reaches runs as a CUDA kernel, its
backward included.

Data parallelism (the model inside ``DistributedDataParallel``, each rank
holding its slice of the global batch): DDP averages the gradients, which
equals the JAX step's gradient of the global batch's mean loss because
every training rank holds the same number of rows (the train loader drops
the last short batch). The step's ``loss`` metric is the global batch's;
mixup mixes the global batch (sample i with sample B-1-i, wherever they
lie) and each rank keeps its rows; dropout masks are drawn for the global
batch (``parallel/mesh.py:dp_rand``).

Randomness: where the JAX step folds the step count into its key, the port
seeds a ``torch.Generator`` (DropPath and head-dropout masks, on the
model's device) and a ``numpy.random.Generator`` (the mixup draw) from
``(seed, step)``. The two packages draw different numbers from the same
seed; a test passes the JAX draws in (``mixup_draw``) and turns the
stochastic layers off.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models import losses as loss_lib
from ..parallel import mesh
from ..solver.optimizer import TrainOptimizer


def step_generators(seed: int, step: int, device) -> tuple:
    """``(torch.Generator on device, numpy Generator)`` for one step."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen, np.random.default_rng([seed, step])


def make_train_step(model: torch.nn.Module, optimizer: TrainOptimizer,
                    loss_name: str, *, mixup_fn: Callable | None = None,
                    num_classes: int | None = None,
                    seed: int = 0) -> Callable:
    """Returns ``train_step(batch, mixup_draw=None) -> (metrics, preds)``.

    ``batch`` holds ``inputs`` (a ``[B, T, H, W, C]`` clip on the model's
    device), ``labels`` (int ``[B]`` or soft ``[B, C]``) and optionally
    ``n_valid``. ``metrics`` are device tensors: ``loss``, ``loss_is_nan``
    and ``grad_norm`` (the global L2 norm before clipping), plus the
    step's ``lr`` as a float."""
    if mixup_fn is not None and loss_name == "cross_entropy":
        loss_name = "soft_cross_entropy"  # mixup makes soft targets
    loss_func = loss_lib.get_loss_func(loss_name)
    device = next(model.parameters()).device

    def train_step(batch: dict, mixup_draw=None):
        step = optimizer.count
        gen, rng = step_generators(seed, step, device)
        inputs, labels = batch["inputs"], batch["labels"]
        if mixup_fn is not None:
            if isinstance(inputs, (list, tuple)):
                raise NotImplementedError(
                    "mixup of multi-pathway inputs is not ported")
            inputs, labels = mixup_fn(mesh.gather_rows(inputs),
                                      mesh.gather_rows(labels), rng,
                                      mixup_draw)
            inputs, labels = mesh.local_rows(inputs), mesh.local_rows(labels)
        elif (loss_name in loss_lib._SOFT_TARGET_LOSSES
              and labels.dim() == 1 and num_classes is not None):
            labels = torch.nn.functional.one_hot(labels.long(),
                                                 num_classes).float()
        model.train()
        optimizer.zero_grad()
        preds = model(inputs, generator=gen)
        n_valid = batch.get("n_valid")
        if n_valid is None:
            loss = loss_func(preds, labels)
        else:
            per_sample = loss_func(preds, labels, reduction="none")
            mask = (torch.arange(per_sample.shape[0], device=device)
                    < n_valid).to(per_sample.dtype)
            loss = (per_sample * mask).sum() / float(n_valid)
        loss.backward()
        lr = optimizer.schedule(step)
        grad_norm = optimizer.step()
        loss = loss.detach()
        if mesh.get_world_size() > 1:  # the global batch's mean loss
            n = float(preds.shape[0] if n_valid is None else n_valid)
            tot = mesh.all_reduce_sum(torch.stack([
                loss.float() * n, torch.tensor(n, device=loss.device)]))
            loss = tot[0] / tot[1]
        metrics = {"loss": loss, "loss_is_nan": ~torch.isfinite(loss),
                   "grad_norm": grad_norm, "lr": lr}
        return metrics, preds.detach()

    return train_step


def make_eval_step(model: torch.nn.Module) -> Callable:
    """Returns ``eval_step(batch) -> preds`` (eval mode, no gradients)."""

    def eval_step(batch: dict):
        model.eval()
        with torch.no_grad():
            return model(batch["inputs"])

    return eval_step
