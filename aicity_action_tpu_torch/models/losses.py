"""Loss functions (port of ``aicity_action_tpu/models/losses.py``, the part
the training step needs; reference: slowfast/models/losses.py).

Each loss is ``loss(logits, targets, reduction)``: int labels for
``cross_entropy``, ``[B, C]`` soft targets for ``soft_cross_entropy``.
Computed in f32 whatever the logits' type.
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


_LOSSES = {
    "cross_entropy": cross_entropy,
    "soft_cross_entropy": soft_cross_entropy,
}

# the JAX package's soft-target family; the port has soft_cross_entropy
_SOFT_TARGET_LOSSES = frozenset(
    {"bce", "bce_logit", "soft_cross_entropy", "nce_and_rce",
     "normalized_soft_cross_entropy", "reverse_soft_cross_entropy"})


def get_loss_func(loss_name: str):
    if loss_name not in _LOSSES:
        raise NotImplementedError(f"Loss {loss_name} is not supported")
    return _LOSSES[loss_name]
