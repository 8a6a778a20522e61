"""Optimizer construction with parameter-group semantics (port of
``aicity_action_tpu/solver/optimizer.py``; reference:
slowfast/models/optimizer.py:26-236).

- Zero weight decay for 1-D params and biases when
  ``SOLVER.ZERO_WD_1D_PARAM`` (``optimizer.py:71-74``), and for the model's
  position embeddings when ``MVIT.ZERO_DECAY_POS_CLS``; BatchNorm
  parameters decay by ``BN.WEIGHT_DECAY`` (``optimizer.py:92``): torch
  param groups, where the JAX package masks optax's decay.
- The multi-dataset head's cross projections (``head.cross_*``) form a
  group of their own without weight decay (the JAX ``cross_proj`` label):
  ``MODEL.MULTI_FIX_PROJ`` (with ``MULTI_ADD_CROSS_PROJ``) freezes them
  (LR 0), else ``MODEL.MULTI_PROJ_TRAIN_DIFF_LR`` steps them at
  ``MULTI_PROJ_LR`` whatever the schedule says (the JAX chain scales their
  update by ``MULTI_PROJ_LR / lr(step)``, ``optimizer.py:134-151``).
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
  8-bit state there either).
- ``zero_sgd`` / ``zero_adamw`` are ``sgd`` / ``adamw`` inside
  ``torch.distributed.optim.ZeroRedundancyOptimizer``: each rank keeps the
  moments of its share of the parameters and broadcasts its updated share
  (ZeRO stage 1; the JAX package shards the moments over the mesh's data
  axis, ``parallel/tp.py:zero1_state_shardings``). Without a process
  group they are the plain optimizers, which is what one rank would do.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
from torch import nn
from torch.distributed.optim import ZeroRedundancyOptimizer

from ..parallel import mesh
from .lr_policy import make_lr_schedule

_NO_DECAY_POS_CLS = ("pos_embed_spatial", "pos_embed_temporal",
                     "pos_embed_class", "pos_embed", "cls_token")


def no_weight_decay_names(cfg) -> frozenset:
    """Names excluded from weight decay (reference MViT.no_weight_decay,
    ``video_model_builder.py:1136-1159``)."""
    if cfg.MODEL.MODEL_NAME == "MViT" and cfg.MVIT.ZERO_DECAY_POS_CLS:
        return frozenset(_NO_DECAY_POS_CLS)
    return frozenset()


def _is_bn_param(name: str) -> bool:
    """The JAX package's 'bn' label: a module name holding "bn" (and not
    "attn")."""
    return any("bn" in k.lower() and "attn" not in k.lower()
               for k in name.split(".")[:-1])


def _is_cross_proj(name: str) -> bool:
    """The JAX package's 'cross_proj' label: a module named ``cross_*``."""
    return any(k.startswith("cross_") for k in name.split(".")[:-1])


def param_groups(model: nn.Module, weight_decay: float, zero_wd_1d: bool,
                 no_decay_names: Iterable[str] = (),
                 bn_weight_decay: float = 0.0,
                 cross_proj_lr: float | None = None) -> list[dict]:
    """``[{params decayed}, {params not decayed}]``, plus ``{BatchNorm
    params}`` decayed by ``bn_weight_decay`` where the model has any, and
    ``{cross projections}`` (no decay; at the fixed LR ``cross_proj_lr``
    where it is not None) where it has any (the JAX package's
    ``_param_labels``: 'default', 'zero_wd', 'bn', 'cross_proj')."""
    decay, no_decay, bn, cross = [], [], [], []
    names = tuple(no_decay_names)
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        if _is_cross_proj(name):
            cross.append(p)
        elif _is_bn_param(name):
            bn.append(p)
        elif any(n in name for n in names) or (
                zero_wd_1d and (p.dim() <= 1 or name.endswith(".bias"))):
            no_decay.append(p)
        else:
            decay.append(p)
    groups = [{"params": decay, "weight_decay": weight_decay},
              {"params": no_decay, "weight_decay": 0.0}]
    if bn:
        groups.append({"params": bn, "weight_decay": bn_weight_decay})
    if cross:
        groups.append({"params": cross, "weight_decay": 0.0})
        if cross_proj_lr is not None:
            groups[-1]["fixed_lr"] = cross_proj_lr
    return groups


def global_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm over the gradients of ``params`` (f32), as optax's
    ``global_norm``."""
    sq = [p.grad.float().pow(2).sum() for p in params if p.grad is not None]
    return torch.sqrt(torch.stack(sq).sum())


class TrainOptimizer:
    """Clip, then a torch optimizer step at the scheduled LR.

    :meth:`step` returns the gradients' global L2 norm before clipping,
    ``norm_fn(params)``: :func:`global_norm` unless a caller sets the
    attribute (a model whose parameters are pieces on several ranks counts
    each piece once, e.g. ``parallel/ep.py:ep_grad_norm``)."""

    def __init__(self, opt: torch.optim.Optimizer, schedule: Callable,
                 clip_val: float = 0.0, clip_l2norm: float = 0.0):
        self.opt = opt
        self.schedule = schedule
        self.clip_val = clip_val
        self.clip_l2norm = clip_l2norm
        self.norm_fn: Callable = global_norm
        self.count = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for g in self.opt.param_groups for p in g["params"]]

    @property
    def zero(self) -> bool:
        """Whether the state is sharded over ranks (ZeRO-1)."""
        return isinstance(self.opt, ZeroRedundancyOptimizer)

    def state_dict(self) -> dict | None:
        """The torch optimizer's state in the plain optimizer's format. A
        collective under ZeRO (every rank must call it): the shards gather
        on rank 0, which alone gets the dict; the other ranks get None."""
        if not self.zero:
            return self.opt.state_dict()
        self.opt.consolidate_state_dict(to=0)
        return self.opt.state_dict() if mesh.get_rank() == 0 else None

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        params = [p for p in self.params if p.grad is not None]
        norm = self.norm_fn(params)
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
            g["lr"] = g.get("fixed_lr", lr)
        self.opt.step()
        self.count += 1
        return norm


def construct_optimizer(cfg, model: nn.Module,
                        steps_per_epoch: int) -> TrainOptimizer:
    """The optimizer of ``cfg.SOLVER`` over ``model``'s parameters."""
    solver = cfg.SOLVER
    schedule = make_lr_schedule(solver, steps_per_epoch)
    m = cfg.MODEL
    cross_lr = (0.0 if m.MULTI_ADD_CROSS_PROJ and m.MULTI_FIX_PROJ
                else m.MULTI_PROJ_LR if m.MULTI_PROJ_TRAIN_DIFF_LR else None)
    groups = param_groups(model, solver.WEIGHT_DECAY,
                          solver.ZERO_WD_1D_PARAM, no_weight_decay_names(cfg),
                          cfg.BN.WEIGHT_DECAY, cross_lr)
    method = solver.OPTIMIZING_METHOD
    zero = method in ("zero_sgd", "zero_adamw")
    if zero:
        method = method[len("zero_"):]
    lr0 = schedule(0)
    if method == "adamw":
        cls, kw = torch.optim.AdamW, dict(betas=(0.9, 0.999), eps=1e-8)
    elif method in ("adam", "adam_8bit"):
        for g in groups:
            g["weight_decay"] = 0.0
        cls, kw = torch.optim.Adam, dict(betas=(0.9, 0.999), eps=1e-8)
    elif method in ("sgd", "sgd_8bit"):
        cls, kw = torch.optim.SGD, dict(momentum=solver.MOMENTUM,
                                        nesterov=solver.NESTEROV)
    else:
        raise NotImplementedError(
            f"Does not support {solver.OPTIMIZING_METHOD} optimizer")
    if zero and mesh.is_initialized():
        opt = ZeroRedundancyOptimizer(groups, optimizer_class=cls, lr=lr0,
                                      **kw)
    else:
        opt = cls(groups, lr=lr0, **kw)
    return TrainOptimizer(opt, schedule, solver.CLIP_GRAD_VAL,
                          solver.CLIP_GRAD_L2NORM)
