"""Loss functions (port of ``aicity_action_tpu/models/losses.py``'s
registered losses; reference: slowfast/models/losses.py).

Each loss is ``loss(logits, targets, reduction)``: int labels for
``cross_entropy``, ``[B, C]`` soft or multi-hot targets for the rest.
Computed in f32 whatever the logits' type. :func:`compute_multi_dataset_loss`
and :func:`compute_vicreg_loss` serve the multi-head models.
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


def compute_multi_dataset_loss(preds: dict, labels: dict, masks: dict,
                               datasets, loss_funcs,
                               dataset_loss_weights=None,
                               add_cross_proj=False,
                               cross_proj_add_to_pred=False,
                               proj_loss_func=None, proj_loss_weight=0.5,
                               num_valid=None) -> torch.Tensor:
    """Masked multi-head loss (the JAX ``losses.py:114``; reference:
    losses.py:12-89). ``preds`` may hold ``"{src}_{dst}"`` cross-projection
    entries besides the heads'. Each head's per-sample loss (a multi-label
    one averaged over classes), plus, under ``add_cross_proj``, the
    projections into its class space (added to its logits by
    ``proj_loss_weight`` under ``cross_proj_add_to_pred``, else their
    losses' mean by that weight), weighted by ``dataset_loss_weights``
    and masked to the head's samples (``masks``, 0/1 ``[B]``, padded rows
    already 0); the sum over heads and samples over the batch size, or
    ``num_valid`` where the batch carries padding."""
    if len(datasets) != len(loss_funcs):
        raise ValueError("one loss function a dataset")
    pfn = get_loss_func(proj_loss_func) if proj_loss_func else None

    def into(name):  # the cross projections into ``name``'s class space
        return [k for k in preds if k not in datasets
                and k.split("_", 1)[1] == name]

    losses = []
    for name, loss_name in zip(datasets, loss_funcs):
        if loss_name not in _SOFT_TARGET_LOSSES:
            raise NotImplementedError(
                f"Loss {loss_name} is not supported for multi-dataset")
        pred = preds[name]
        if add_cross_proj and cross_proj_add_to_pred:
            for k in into(name):
                pred = pred + preds[k] * proj_loss_weight
        loss = get_loss_func(loss_name)(pred, labels[name], reduction="none")
        if loss.dim() == 2:
            loss = loss.mean(-1)
        if add_cross_proj and not cross_proj_add_to_pred:
            proj = []
            for k in into(name):
                pl = pfn(preds[k], labels[name], reduction="none")
                if pl.dim() == 2:
                    pl = pl.mean(-1)
                proj.append(pl * proj_loss_weight)
            if proj:
                loss = loss + torch.stack(proj, 1).mean(1)
        if dataset_loss_weights is not None:
            loss = dataset_loss_weights[name] * loss
        losses.append(masks[name] * loss)
    denom = losses[0].shape[0] if num_valid is None else num_valid
    return torch.cat(losses).sum() / denom


def compute_vicreg_loss(emb: torch.Tensor, std_weight: float = 25.0,
                        cov_weight: float = 1.0,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """VICReg's std + covariance regularizer (the JAX ``losses.py:181``;
    reference: losses.py:97-116) over the batch ``emb [B, F]``. ``mask``
    (0/1 ``[B]``) keeps padded rows out of the statistics (all ones is the
    unmasked form). The variance is the unbiased one, over ``max(n - 1,
    1)`` so that one valid row gives a finite loss."""
    if mask is None:
        n = emb.shape[0]
        emb = emb - emb.mean(0)
        denom = max(n - 1, 1)
    else:
        m = mask.to(emb.dtype)[:, None]
        n = m.sum().clamp_min(1)
        emb = (emb - (emb * m).sum(0) / n) * m
        denom = (n - 1).clamp_min(1)
    var = (emb ** 2).sum(0) / denom
    std_loss = torch.relu(1 - torch.sqrt(var + 1e-4)).mean()
    f = emb.shape[1]
    cov = emb.t() @ emb / denom
    off_diag = cov - torch.diag(torch.diag(cov))
    return std_loss * std_weight + (off_diag ** 2).sum() / f * cov_weight
