"""Optimizer construction with parameter-group semantics (port of
``aicity_action_tpu/solver/optimizer.py``; reference:
slowfast/models/optimizer.py:26-236).

- Zero weight decay for 1-D params and biases when
  ``SOLVER.ZERO_WD_1D_PARAM`` (``optimizer.py:71-74``), and for the model's
  position embeddings when ``MVIT.ZERO_DECAY_POS_CLS``: two torch param
  groups, where the JAX package masks optax's decay.
- Gradients are clipped first (``CLIP_GRAD_VAL`` elementwise, or
  ``CLIP_GRAD_L2NORM`` by the global norm with optax's rule), then the
  torch optimizer steps with the LR the schedule gives for the step count.
- ``adamw`` is ``torch.optim.AdamW``: decoupled decay scaled by the LR, the
  arithmetic of optax's ``scale_by_adam -> add_decayed_weights ->
  scale_by_learning_rate``. ``sgd`` is ``torch.optim.SGD`` with the decay
  folded into the gradient before momentum, optax's ``add_decayed_weights
  -> trace -> scale_by_learning_rate``.
- ``adam`` is ``torch.optim.Adam`` with no weight decay at all: the JAX
  package's ``adam`` chain (``scale_by_adam -> scale_by_learning_rate``)
  applies none, unlike upstream PySlowFast's. ``sgd_8bit`` and
  ``adam_8bit`` are the JAX package's aliases of ``sgd`` and ``adam`` (no
  8-bit state there either). ``zero_sgd`` / ``zero_adamw`` (the optimizer
  state sharded over data-parallel ranks) wait for ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
from torch import nn

from .lr_policy import make_lr_schedule

_NO_DECAY_POS_CLS = ("pos_embed_spatial", "pos_embed_temporal",
                     "pos_embed_class", "pos_embed", "cls_token")


def no_weight_decay_names(cfg) -> frozenset:
    """Names excluded from weight decay (reference MViT.no_weight_decay,
    ``video_model_builder.py:1136-1159``)."""
    if cfg.MODEL.MODEL_NAME == "MViT" and cfg.MVIT.ZERO_DECAY_POS_CLS:
        return frozenset(_NO_DECAY_POS_CLS)
    return frozenset()


def param_groups(model: nn.Module, weight_decay: float, zero_wd_1d: bool,
                 no_decay_names: Iterable[str] = ()) -> list[dict]:
    """``[{params decayed}, {params not decayed}]`` (the JAX package's
    ``_param_labels``: 'zero_wd' vs 'default')."""
    decay, no_decay = [], []
    names = tuple(no_decay_names)
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        if any(n in name for n in names) or (
                zero_wd_1d and (p.dim() <= 1 or name.endswith(".bias"))):
            no_decay.append(p)
        else:
            decay.append(p)
    return [{"params": decay, "weight_decay": weight_decay},
            {"params": no_decay, "weight_decay": 0.0}]


def global_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm over the gradients of ``params`` (f32), as optax's
    ``global_norm``."""
    sq = [p.grad.float().pow(2).sum() for p in params if p.grad is not None]
    return torch.sqrt(torch.stack(sq).sum())


class TrainOptimizer:
    """Clip, then a torch optimizer step at the scheduled LR.

    :meth:`step` returns the gradients' global L2 norm before clipping."""

    def __init__(self, opt: torch.optim.Optimizer, schedule: Callable,
                 clip_val: float = 0.0, clip_l2norm: float = 0.0):
        self.opt = opt
        self.schedule = schedule
        self.clip_val = clip_val
        self.clip_l2norm = clip_l2norm
        self.count = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for g in self.opt.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        params = [p for p in self.params if p.grad is not None]
        norm = global_norm(params)
        if self.clip_val:
            for p in params:
                p.grad.clamp_(-self.clip_val, self.clip_val)
        elif self.clip_l2norm:
            # optax.clip_by_global_norm: g * max / norm where norm > max
            scale = torch.where(norm < self.clip_l2norm, 1.0,
                                self.clip_l2norm / norm)
            for p in params:
                p.grad.mul_(scale.to(p.grad.dtype))
        lr = self.schedule(self.count)
        for g in self.opt.param_groups:
            g["lr"] = lr
        self.opt.step()
        self.count += 1
        return norm


def construct_optimizer(cfg, model: nn.Module,
                        steps_per_epoch: int) -> TrainOptimizer:
    """The optimizer of ``cfg.SOLVER`` over ``model``'s parameters."""
    solver = cfg.SOLVER
    schedule = make_lr_schedule(solver, steps_per_epoch)
    groups = param_groups(model, solver.WEIGHT_DECAY,
                          solver.ZERO_WD_1D_PARAM, no_weight_decay_names(cfg))
    method = solver.OPTIMIZING_METHOD
    lr0 = schedule(0)
    if method == "adamw":
        opt = torch.optim.AdamW(groups, lr=lr0, betas=(0.9, 0.999), eps=1e-8)
    elif method in ("adam", "adam_8bit"):
        for g in groups:
            g["weight_decay"] = 0.0
        opt = torch.optim.Adam(groups, lr=lr0, betas=(0.9, 0.999), eps=1e-8)
    elif method in ("sgd", "sgd_8bit"):
        opt = torch.optim.SGD(groups, lr=lr0, momentum=solver.MOMENTUM,
                              nesterov=solver.NESTEROV)
    elif method in ("zero_sgd", "zero_adamw"):
        raise NotImplementedError(
            f"{method} shards the optimizer state over data-parallel ranks, "
            f"which is not ported (ROADMAP Queue 1 item 7)")
    else:
        raise NotImplementedError(f"Does not support {method} optimizer")
    return TrainOptimizer(opt, schedule, solver.CLIP_GRAD_VAL,
                          solver.CLIP_GRAD_L2NORM)
