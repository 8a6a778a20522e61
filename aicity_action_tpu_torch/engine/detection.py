"""Detection (AVA) train and eval steps (port of
``aicity_action_tpu/engine/detection.py``; reference: the DETECTION.ENABLE
branches of tools/train_net.py and test_net.py).

Boxes arrive as fixed slabs ``[B, max_boxes, 4]`` with a validity mask
(``data/ava.py``). A step flattens them into ``[B * max_boxes, 5]`` rows
with their batch index (what RoIAlign takes), scores every row, padded
ones included, and masks the padded rows out of the loss: no shape depends
on a batch's box count.

The train step is :func:`engine.steps.make_train_step`'s, with the loss
the per-box loss on the head's probabilities (``MODEL.LOSS_FUNC``, bce for
AVA) times the mask over ``max(mask.sum(), 1)``: the optimizer update at
the scheduled LR, clipping, ``grad_norm`` and ``loss_is_nan`` as there.
Under data parallelism the mask's sum is the global batch's, and each
rank's backward is scaled by the world size so that DDP's average of the
ranks' gradients is the gradient of the global batch's masked mean, the
JAX step's over its sharded batch.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import losses as loss_lib
from ..parallel import mesh
from ..solver.optimizer import TrainOptimizer
from .steps import step_generators


def flatten_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """``[B, M, 4]`` -> ``[B * M, 5]`` with the batch index first (the
    reference's detection collate, loader.py:98-132)."""
    b, m, _ = boxes.shape
    idx = torch.arange(b, dtype=boxes.dtype, device=boxes.device)
    return torch.cat([idx.repeat_interleave(m)[:, None],
                      boxes.reshape(b * m, 4)], dim=1)


def make_detection_train_step(model: torch.nn.Module,
                              optimizer: TrainOptimizer,
                              loss_name: str = "bce",
                              seed: int = 0) -> Callable:
    """Returns ``train_step(batch) -> (metrics, preds)``. ``batch`` holds
    ``inputs`` (one clip or the list of a model's pathways), ``boxes [B,
    M, 4]``, ``box_mask [B, M]`` and ``labels [B, M, C]``, on the model's
    device; ``preds`` are the ``[B * M, C]`` activations. ``metrics``:
    ``loss``, ``loss_is_nan``, ``grad_norm`` (device tensors) and ``lr``."""
    loss_func = loss_lib.get_loss_func(loss_name)
    device = next(model.parameters()).device

    def train_step(batch: dict):
        step = optimizer.count
        gen, _ = step_generators(seed, step, device)
        boxes5 = flatten_boxes(batch["boxes"])
        mask = batch["box_mask"].reshape(-1).float()
        labels = batch["labels"].reshape(mask.shape[0], -1)
        world = mesh.get_world_size()
        count = mask.sum()
        if world > 1:
            count = mesh.all_reduce_sum(count)
        model.train()
        optimizer.zero_grad()
        preds = model(batch["inputs"], boxes5, generator=gen)
        per_box = loss_func(preds, labels, reduction="none")
        loss = (per_box * mask).sum() / count.clamp_min(1.0)
        (loss * world).backward()
        lr = optimizer.schedule(step)
        grad_norm = optimizer.step()
        loss = loss.detach()
        if world > 1:
            loss = mesh.all_reduce_sum(loss)
        metrics = {"loss": loss, "loss_is_nan": ~torch.isfinite(loss),
                   "grad_norm": grad_norm, "lr": lr}
        return metrics, preds.detach()

    return train_step


def make_detection_eval_step(model: torch.nn.Module) -> Callable:
    """Returns ``eval_step(batch) -> preds [B * M, C]`` (eval mode, no
    gradients) for a batch of ``inputs`` and ``boxes [B, M, 4]``."""

    def eval_step(batch: dict):
        model.eval()
        with torch.no_grad():
            return model(batch["inputs"], flatten_boxes(batch["boxes"]))

    return eval_step
