"""Loss functions (port of ``aicity_action_tpu/models/losses.py``'s
registered losses; reference: slowfast/models/losses.py).

Each loss is ``loss(logits, targets, reduction)``: int labels for
``cross_entropy``, ``[B, C]`` soft or multi-hot targets for the rest.
Computed in f32 whatever the logits' type. The multi-dataset and VICReg
losses serve the multi-head models (ROADMAP Queue 1 item 9b).
"""

from __future__ import annotations

import torch


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "none":
        return loss
    raise NotImplementedError(reduction)


def cross_entropy(logits, labels, reduction="mean"):
    """Int-label CE, as ``torch.nn.CrossEntropyLoss``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return _reduce(loss, reduction)


def soft_cross_entropy(logits, targets, reduction="mean"):
    """Soft-target CE (losses.py:119-142), for MixUp and label smoothing."""
    loss = torch.sum(-targets.float() * torch.log_softmax(logits.float(), -1),
                     dim=-1)
    return _reduce(loss, reduction)


def bce(probs, targets, reduction="mean"):
    """``torch.nn.BCELoss`` on probabilities clamped to [1e-7, 1 - 1e-7];
    ``none`` gives the per-sample mean over classes."""
    p = probs.float().clamp(1e-7, 1 - 1e-7)
    t = targets.float()
    loss = -(t * torch.log(p) + (1 - t) * torch.log(1 - p))
    if loss.dim() == 2 and reduction == "none":
        loss = loss.mean(-1)
    return _reduce(loss, reduction)


def bce_logit(logits, targets, reduction="mean"):
    """``torch.nn.BCEWithLogitsLoss`` in the JAX package's stable form;
    ``none`` gives the per-sample mean over classes."""
    x = logits.float()
    loss = x.clamp_min(0) - x * targets.float() + torch.log1p(
        torch.exp(-x.abs()))
    if loss.dim() == 2 and reduction == "none":
        loss = loss.mean(-1)
    return _reduce(loss, reduction)


def normalized_soft_cross_entropy(logits, targets, reduction="mean"):
    logp = torch.log_softmax(logits.float(), -1)
    loss = -torch.sum(targets.float() * logp, -1) / (-logp.sum(-1))
    return _reduce(loss, reduction)


def reverse_soft_cross_entropy(logits, targets, reduction="mean"):
    pred = torch.softmax(logits.float(), -1).clamp(1e-7, 1.0)
    t = torch.log(targets.float().clamp(1e-4, 1.0))
    loss = -torch.sum(t * pred, -1)
    return _reduce(loss, reduction)


def mean_absolute_error(logits, targets, reduction="mean"):
    """Reduced MAE, 1 - sum(p q) (losses.py:205-240)."""
    pred = torch.softmax(logits.float(), -1)
    loss = 1.0 - torch.sum(targets.float() * pred, -1)
    return _reduce(loss, reduction)


def nce_and_rce(logits, targets, reduction="mean", alpha=1.0, beta=1.0):
    return alpha * normalized_soft_cross_entropy(logits, targets, reduction) \
        + beta * reverse_soft_cross_entropy(logits, targets, reduction)


def lsep(scores, labels, reduction="mean"):
    """Pairwise log-sum-exp ranking loss (losses.py:253-282), with the
    reference's reduction: one sum over the whole batch before the log."""
    s = scores.float()
    lab = labels.float()
    mask = ((lab[:, None, :] - lab[:, :, None]) > 0).float()
    diff = s[:, :, None] - s[:, None, :]
    loss = torch.log1p(torch.sum(torch.exp(diff) * mask))
    return _reduce(loss, reduction)


_LOSSES = {
    "cross_entropy": cross_entropy,
    "bce": bce,
    "bce_logit": bce_logit,
    "soft_cross_entropy": soft_cross_entropy,
    "mean_absolute_error": mean_absolute_error,
    "reverse_soft_cross_entropy": reverse_soft_cross_entropy,
    "normalized_soft_cross_entropy": normalized_soft_cross_entropy,
    "nce_and_rce": nce_and_rce,
    "lsep": lsep,
}

_SOFT_TARGET_LOSSES = frozenset(
    {"bce", "bce_logit", "soft_cross_entropy", "nce_and_rce",
     "normalized_soft_cross_entropy", "reverse_soft_cross_entropy"})


def get_loss_func(loss_name: str):
    if loss_name not in _LOSSES:
        raise NotImplementedError(f"Loss {loss_name} is not supported")
    return _LOSSES[loss_name]
