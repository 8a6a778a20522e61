"""Contrastive (CLIP-style) train step, feature step and retrieval metrics
(port of ``aicity_action_tpu/engine/contrastive.py``; reference:
tools/train_net_contrastive.py and test_net_contrastive.py).

- The loss is the symmetric soft cross-entropy over ``scale * V T^T`` with
  the row-normalized same-label matrix as targets. Padded rows of a short
  final batch (``n_valid``) take no part: their columns get a bias of -1e9
  and their target rows are zero, and the sum is divided by ``2 * n_valid``.
- ``logit_scale`` is clamped to [0, ln 100] after each update
  (train_net_contrastive.py:216-217).
- MoCo (``TRAIN.USE_MOCO``): the momentum weights are a second model whose
  tensors move by EMA at ``MOCO_MOMENTUM`` *before* they are used, then
  encode the batch in a ``no_grad`` forward in eval mode, so that the video
  tower takes the same inference kernels as the JAX package's
  ``train=False`` forward (``mvit.py:335-354``); the online features are
  contrasted with the momentum ones.
- Data parallelism: the similarity matrix is over the global batch. Each
  rank's features join the others' through a differentiable gather (the
  reference's ``all_gather_cat_self``), an all-reduce of a zero-padded
  buffer whose backward sums every rank's gradient of its rows; since every
  rank computes the same global loss, that sum is ``world`` times the
  gradient of one copy of the loss, and DDP's average over the ranks then
  leaves exactly the one-process gradient.
"""

from __future__ import annotations

import copy
import math
from typing import Callable

import numpy as np
import torch

from ..models import losses as loss_lib
from ..parallel import mesh
from ..solver.optimizer import TrainOptimizer
from .steps import step_generators

LOGIT_SCALE_MAX = math.log(100.0)


def contrastive_gt_matrix(labels: torch.Tensor,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """Row-normalized same-label matrix (metrics.py:9-23). ``valid`` (bool
    ``[B]``) zeroes padded rows and columns; the row sums are clamped to 1,
    so that a padded row's targets are all zero rather than NaN."""
    same = (labels[:, None] == labels[None, :]).float()
    if valid is not None:
        v = valid.float()
        same = same * v[:, None] * v[None, :]
    return same / same.sum(dim=1, keepdim=True).clamp_min(1.0)


def recall_at_rank(simi: np.ndarray, gt: np.ndarray, ks=(1, 5, 10)):
    """The fraction of rows whose top-k entries by ``simi`` hit a positive
    of ``gt`` (metrics.py:25-49)."""
    order = np.argsort(-simi, axis=1)
    hits = np.take_along_axis(gt, order, axis=1) > 0
    return [float(hits[:, :k].any(axis=1).mean()) for k in ks]


def retrieval_metrics(video_feats, text_feats, labels, ks=(1, 5, 10)):
    """Video-to-text and text-to-video recall@k over a feature set
    (test_net_contrastive.py:150-160)."""
    v = np.asarray(video_feats)
    t = np.asarray(text_feats)
    gt = contrastive_gt_matrix(torch.from_numpy(np.asarray(labels))).numpy()
    simi_v2t = v @ t.T
    out = {}
    for k, r in zip(ks, recall_at_rank(simi_v2t, gt, ks)):
        out[f"v2t_recall@{k}"] = r
    for k, r in zip(ks, recall_at_rank(simi_v2t.T, gt.T, ks)):
        out[f"t2v_recall@{k}"] = r
    return out


def contrastive_loss(v: torch.Tensor, t: torch.Tensor, scale: torch.Tensor,
                     labels: torch.Tensor, valid: torch.Tensor,
                     v_m: torch.Tensor | None = None,
                     t_m: torch.Tensor | None = None) -> torch.Tensor:
    """The symmetric soft cross-entropy of the features ``v``, ``t`` ``[N,
    D]`` (against the momentum features ``v_m``, ``t_m`` where given) at
    temperature ``scale``, with the same-label targets; rows where
    ``valid`` is False take no part, and the sum is divided by twice the
    valid rows."""
    gt = contrastive_gt_matrix(labels, valid)
    col_bias = torch.where(valid, 0.0, -1e9)[None, :]
    if v_m is not None:
        logits_v = scale * v @ t_m.T
        logits_t = scale * t @ v_m.T
    else:
        logits_v = scale * v @ t.T
        logits_t = logits_v.T
    per_v = loss_lib.soft_cross_entropy(logits_v + col_bias, gt,
                                        reduction="none")
    per_t = loss_lib.soft_cross_entropy(logits_t + col_bias, gt.T,
                                        reduction="none")
    return (per_v.sum() + per_t.sum()) / (2.0 * valid.sum().float())


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch ``[world * b, ...]`` of every rank's ``[b, ...]``
    rows, rank-major, differentiably: the backward hands each rank the sum
    over ranks of the gradient of its rows. ``x`` itself at world 1."""
    world = mesh.get_world_size()
    if world == 1:
        return x
    b, r = x.shape[0], mesh.get_rank()
    buf = torch.zeros((world * b, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    buf = buf.index_copy(0, torch.arange(r * b, (r + 1) * b,
                                         device=x.device), x)
    return mesh.all_reduce_sum(buf)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module inside ``DistributedDataParallel``, or ``model``."""
    return getattr(model, "module", model)


def make_momentum_model(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` (unwrapped from DDP) for MoCo's momentum
    weights: eval mode, no gradients, the same initial weights."""
    ema = copy.deepcopy(unwrap(model))
    for p in ema.parameters():
        p.requires_grad_(False)
    return ema.eval()


@torch.no_grad()
def ema_update(ema: torch.nn.Module, model: torch.nn.Module,
               momentum: float) -> None:
    """``m <- m * momentum + p * (1 - momentum)`` for every parameter."""
    ms = list(ema.parameters())
    ps = [p.detach() for p in unwrap(model).parameters()]
    torch._foreach_mul_(ms, momentum)
    torch._foreach_add_(ms, torch._foreach_mul(ps, 1.0 - momentum))


def make_contrastive_train_step(
        model: torch.nn.Module, optimizer: TrainOptimizer, *,
        use_moco: bool = False, moco_momentum: float = 0.99,
        momentum_model: torch.nn.Module | None = None,
        seed: int = 0) -> Callable:
    """Returns ``train_step(batch) -> (metrics, (v, t))``.

    ``model`` is an ActionCLIP (inside DDP under data parallelism);
    ``batch`` holds ``inputs`` (the clip on the model's device), ``tokens``
    (int ``[B, CONTEXT_LENGTH]``), ``labels`` (int ``[B]``) and optionally
    ``n_valid``, this rank's real rows. Under ``use_moco``,
    ``momentum_model`` (:func:`make_momentum_model`) holds the momentum
    weights. ``metrics`` are device tensors: ``loss`` (the global batch's),
    ``logit_scale`` (the temperature the step used), ``loss_is_nan`` and
    ``grad_norm``, plus the step's ``lr``; ``(v, t)`` are this rank's
    features."""
    if use_moco and momentum_model is None:
        raise ValueError("MoCo needs the momentum model")
    device = next(model.parameters()).device
    inner = unwrap(model)

    def train_step(batch: dict):
        step = optimizer.count
        gen, _ = step_generators(seed, step, device)
        frames, tokens = batch["inputs"], batch["tokens"]
        labels = batch["labels"]
        b = labels.shape[0]
        n_valid = batch.get("n_valid")
        local_valid = torch.arange(b, device=device) < (
            b if n_valid is None else n_valid)
        labels_g = mesh.gather_rows(labels)
        valid = mesh.gather_rows(local_valid.to(torch.int32)) > 0
        v_m = t_m = None
        if use_moco:  # EMA first, then the momentum features
            ema_update(momentum_model, inner, moco_momentum)
            with torch.no_grad():
                v_m, t_m, _ = momentum_model(frames, tokens)
            v_m, t_m = mesh.gather_rows(v_m), mesh.gather_rows(t_m)

        model.train()
        optimizer.zero_grad()
        v, t, scale = model(frames, tokens, generator=gen)
        loss = contrastive_loss(all_gather_rows(v), all_gather_rows(t),
                                scale, labels_g, valid, v_m, t_m)
        loss.backward()
        lr = optimizer.schedule(step)
        grad_norm = optimizer.step()
        with torch.no_grad():
            inner.logit_scale.clamp_(0.0, LOGIT_SCALE_MAX)
        loss = loss.detach()
        metrics = {"loss": loss, "loss_is_nan": ~torch.isfinite(loss),
                   "logit_scale": scale.detach(), "grad_norm": grad_norm,
                   "lr": lr}
        return metrics, (v.detach(), t.detach())

    return train_step


def make_feature_step(model: torch.nn.Module) -> Callable:
    """Returns ``step(batch) -> (v, t, scale)``: L2-normed features and the
    temperature, eval mode, no gradients."""

    def step(batch: dict):
        model.eval()
        with torch.no_grad():
            return model(batch["inputs"], batch["tokens"])

    return step
