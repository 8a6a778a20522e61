"""Train and eval steps (port of ``aicity_action_tpu/engine/steps.py:48-270``;
reference: tools/train_net.py:83-324), the multi-head models' included.

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
lie; every pathway of a multi-pathway input with the same draw) and each
rank keeps its rows; dropout masks are drawn for the global
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


def step_generators(seed: int, step: int, device,
                    data: mesh.DataRanks | None = None) -> tuple:
    """``(torch.Generator on device, numpy Generator)`` for one step; the
    torch one draws for the batch sharded over ``data``
    (``parallel/mesh.py:RowGenerator``)."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    gen = mesh.RowGenerator(device=device, data=data)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen, np.random.default_rng([seed, step])


def moe_aux_loss(model: torch.nn.Module) -> torch.Tensor | None:
    """The mean of the MoE blocks' load-balance losses of ``model``'s last
    forward (``DistributedDataParallel`` unwrapped), None without MoE
    blocks (the JAX step's ``sum(aux_leaves) / len(aux_leaves)``)."""
    aux = getattr(getattr(model, "module", model), "moe_aux", None)
    return torch.stack(aux).mean() if aux else None


def make_train_step(model: torch.nn.Module, optimizer: TrainOptimizer,
                    loss_name: str, *, mixup_fn: Callable | None = None,
                    num_classes: int | None = None, seed: int = 0,
                    moe_aux_weight: float = 0.0,
                    grad_sync: Callable | None = None,
                    data: mesh.DataRanks | None = None) -> Callable:
    """Returns ``train_step(batch, mixup_draw=None) -> (metrics, preds)``.

    ``batch`` holds ``inputs`` (a ``[B, T, H, W, C]`` clip on the model's
    device), ``labels`` (int ``[B]`` or soft ``[B, C]``) and optionally
    ``n_valid``. ``metrics`` are device tensors: ``loss``, ``loss_is_nan``
    and ``grad_norm`` (the global L2 norm before clipping), plus the
    step's ``lr`` as a float. ``moe_aux_weight`` (``MVIT.MOE.
    AUX_LOSS_WEIGHT`` of an MoE model) adds that times the mean of the MoE
    blocks' load-balance losses to the loss; ``grad_sync()`` runs between
    the backward and the optimizer (expert parallelism's gradient
    reductions, ``parallel/ep.py``). ``data`` names the ranks over which
    the batch is sharded (every rank by default; ``parallel/tp.py``'s
    data axis), for mixup's global batch and the dropout masks."""
    if mixup_fn is not None and loss_name == "cross_entropy":
        loss_name = "soft_cross_entropy"  # mixup makes soft targets
    loss_func = loss_lib.get_loss_func(loss_name)
    device = next(model.parameters()).device

    def train_step(batch: dict, mixup_draw=None):
        step = optimizer.count
        gen, rng = step_generators(seed, step, device, data)
        inputs, labels = batch["inputs"], batch["labels"]
        if mixup_fn is not None:
            # every pathway of a multi-pathway input mixes with the same
            # draw (the JAX mixup.py:67-111)
            paths = isinstance(inputs, (list, tuple))
            xs, labels = mixup_fn(
                [mesh.gather_rows(x, data) for x in inputs] if paths
                else mesh.gather_rows(inputs, data),
                mesh.gather_rows(labels, data), rng, mixup_draw)
            inputs = ([mesh.local_rows(x, data) for x in xs] if paths
                      else mesh.local_rows(xs, data))
            labels = mesh.local_rows(labels, data)
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
        aux = moe_aux_loss(model) if moe_aux_weight else None
        if aux is not None:
            loss = loss + moe_aux_weight * aux
        loss.backward()
        if grad_sync is not None:
            grad_sync()
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


def multihead_step_kwargs(cfg) -> dict:
    """The arguments of :func:`make_multihead_train_step` that ``cfg``
    sets (``MODEL.MULTI_*``, the VICReg switches, ``RNG_SEED``)."""
    m = cfg.MODEL
    return dict(
        datasets=list(m.MULTI_DATASETS),
        num_classes=list(m.MULTI_NUM_CLASSES),
        loss_funcs=list(m.MULTI_LOSS_FUNCS),
        loss_weights=list(m.MULTI_LOSS_WEIGHTS),
        add_cross_proj=m.MULTI_ADD_CROSS_PROJ,
        cross_proj_add_to_pred=m.MULTI_CROSS_PROJ_ADD_TO_PRED,
        proj_loss_func=m.MULTI_PROJ_LOSS_FUNC,
        proj_loss_weight=m.MULTI_PROJ_LOSS_WEIGHT,
        use_vicreg=m.USE_VICREG_LOSS, vicreg_weight=m.VICREG_LOSS_WEIGHT,
        seed=cfg.RNG_SEED)


def make_multihead_train_step(
        model: torch.nn.Module, optimizer: TrainOptimizer, *, datasets,
        num_classes, loss_funcs, loss_weights=None,
        add_cross_proj: bool = False, cross_proj_add_to_pred: bool = False,
        proj_loss_func: str | None = None, proj_loss_weight: float = 0.5,
        use_vicreg: bool = False, vicreg_weight: float = 0.01,
        seed: int = 0) -> Callable:
    """Returns ``train_step(batch) -> (metrics, preds)`` of a multi-head
    model (the JAX ``steps.py:155-258``; reference: train_net.py:155-218).

    ``batch`` holds ``inputs``, ``labels`` (one-hot or multi-hot ``[B,
    max classes]``), ``dataset_idx`` (``[B]``, which dataset each row
    comes from) and optionally ``n_valid``. Each head's mask is its rows
    among the real ones, its labels the first ``classes`` columns;
    :func:`~aicity_action_tpu_torch.models.losses.compute_multi_dataset_loss`
    over every head (and the cross projections under ``add_cross_proj``),
    plus under ``use_vicreg`` ``vicreg_weight`` x VICReg (std and
    covariance weights 1) on the f32 pooled embedding of the real rows.

    The JAX step sees the global batch, and VICReg's statistics are not
    linear in it: under data parallelism the heads' outputs, the embedding
    (differentiably, :func:`~aicity_action_tpu_torch.engine.contrastive.
    all_gather_rows`), the labels, dataset indices and masks are gathered
    from every rank, so that each rank computes the global batch's loss
    over the global count of real rows, and DDP's average of the ranks'
    gradients is the one-process gradient. ``metrics`` as
    :func:`make_train_step`'s; ``preds`` this rank's heads' logits."""
    from .contrastive import all_gather_rows

    weights = (dict(zip(datasets, loss_weights))
               if loss_weights is not None else None)
    n_cls = dict(zip(datasets, num_classes))
    device = next(model.parameters()).device

    def train_step(batch: dict):
        step = optimizer.count
        gen, _ = step_generators(seed, step, device)
        b = batch["labels"].shape[0]
        n_valid = batch.get("n_valid")
        local = (torch.arange(b, device=device)
                 < (b if n_valid is None else n_valid)).float()
        labels = mesh.gather_rows(batch["labels"].float())
        ds_idx = mesh.gather_rows(batch["dataset_idx"].to(device))
        valid = mesh.gather_rows(local)
        unpadded = n_valid is None and mesh.get_world_size() == 1
        masks = {ds: (ds_idx == i).float() * valid
                 for i, ds in enumerate(datasets)}
        model.train()
        optimizer.zero_grad()
        out = model(batch["inputs"], generator=gen,
                    run_cross_proj=add_cross_proj, return_emb=use_vicreg)
        preds, emb = out if use_vicreg else (out, None)
        loss = loss_lib.compute_multi_dataset_loss(
            {k: all_gather_rows(v) for k, v in preds.items()},
            {ds: labels[:, :n_cls[ds]] for ds in datasets}, masks, datasets,
            loss_funcs, dataset_loss_weights=weights,
            add_cross_proj=add_cross_proj,
            cross_proj_add_to_pred=cross_proj_add_to_pred,
            proj_loss_func=proj_loss_func,
            proj_loss_weight=proj_loss_weight,
            num_valid=None if unpadded else valid.sum())
        if use_vicreg:
            loss = loss + vicreg_weight * loss_lib.compute_vicreg_loss(
                all_gather_rows(emb.float()), std_weight=1.0,
                cov_weight=1.0, mask=None if unpadded else valid)
        loss.backward()
        lr = optimizer.schedule(step)
        grad_norm = optimizer.step()
        loss = loss.detach()
        metrics = {"loss": loss, "loss_is_nan": ~torch.isfinite(loss),
                   "grad_norm": grad_norm, "lr": lr}
        return metrics, {k: v.detach() for k, v in preds.items()}

    return train_step


def make_multihead_eval_step(model: torch.nn.Module) -> Callable:
    """Returns ``eval_step(batch) -> {dataset: scores}``: every head scores
    the batch (eval mode, no gradients); the meter picks each sample's own
    dataset (the JAX ``make_multihead_eval_step``)."""

    def eval_step(batch: dict):
        model.eval()
        with torch.no_grad():
            return model(batch["inputs"])

    return eval_step


def make_eval_step(model: torch.nn.Module) -> Callable:
    """Returns ``eval_step(batch) -> preds`` (eval mode, no gradients)."""

    def eval_step(batch: dict):
        model.eval()
        with torch.no_grad():
            return model(batch["inputs"])

    return eval_step
