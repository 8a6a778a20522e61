"""The plain float32 training step that the reference follows for the
first steps of a training run: the model of :mod:`.mvit`, its random draws
reproduced, soft-target cross entropy over one-hot labels, the gradient
clipped by its global norm, AdamW.

- Random draws: each step seeds a generator on the device from ``(seed,
  step)`` as the recipe's step does (``numpy.random.SeedSequence([seed,
  step])``, two 32-bit words), then draws, in the forward's order, each
  block's two DropPath keep masks ``rand(B) < 1 - rate`` (blocks of rate
  0 draw none) and the head dropout's ``rand(B, C) < 1 - rate``.
- The batch is followed a clip at a time and its gradients summed, with
  each block recomputed in the backward: the same arithmetic as the whole
  batch at once, in a fraction of the memory.
- AdamW: betas (0.9, 0.999), eps 1e-8, decoupled decay ``lr * wd`` on every
  leaf of two or more dimensions that is not a bias (``ZERO_WD_1D_PARAM``),
  bias-corrected moments; the learning rate of the recipe's linear warmup
  (``WARMUP_START_LR`` to the cosine's value at ``WARMUP_EPOCHS``) at epoch
  ``step / steps_per_epoch``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .mvit import MViTReference

BETAS = (0.9, 0.999)
EPS = 1e-8


def step_seed(seed: int, step: int) -> int:
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return int(state[0]) << 32 | int(state[1])


def lr_at(solver: dict, step: int, steps_per_epoch: int) -> float:
    """The recipe's learning rate at ``step`` (cosine after a linear
    warmup)."""
    epoch = step / steps_per_epoch
    warm = solver["WARMUP_EPOCHS"]
    end = solver["COSINE_END_LR"]

    def cosine(e):
        off = warm if solver["COSINE_AFTER_WARMUP"] else 0.0
        return end + (solver["BASE_LR"] - end) * (
            math.cos(math.pi * (e - off) / (solver["MAX_EPOCH"] - off))
            + 1.0) * 0.5

    if warm > 0 and epoch < warm:
        start = solver["WARMUP_START_LR"]
        return epoch * (cosine(warm) - start) / warm + start
    return cosine(epoch)


def draw_masks(ref: MViTReference, batch: int, gen, device):
    masks = []
    for b in ref.blocks:
        if b.drop_path == 0.0:
            masks.append(None)
            continue
        masks.append(tuple(
            torch.rand((batch,), generator=gen, device=device)
            < 1.0 - b.drop_path for _ in range(2)))
    rate = ref.cfg["MODEL"]["DROPOUT_RATE"]
    head = None
    if rate > 0:
        width = ref.blocks[-1].dim_out
        head = torch.rand((batch, width), generator=gen, device=device) \
            < 1.0 - rate
    return masks, head


def decays(name: str, p: torch.Tensor, solver: dict) -> bool:
    return not (solver["ZERO_WD_1D_PARAM"]
                and (p.dim() <= 1 or name.endswith(".bias")))


def follow(cfg: dict, params: dict, batches: list, seed: int, steps: int,
           steps_per_epoch: int, quant=None, half_batch: bool = False
           ) -> dict:
    """Follows ``steps`` training steps from ``params`` on ``batches[k %
    len(batches)]`` (``{"inputs", "labels"}``). Returns each step's
    ``loss``, each leaf's norm of the first step's gradient as AdamW gets
    it (after clipping; ``grad1``) and each leaf's norm of its change over
    the ``steps`` (``change``). ``half_batch`` leaves out the second half
    of every batch and takes the mean over the rest (a fault the check
    must catch); ``quant`` computes in a lower precision (the control)."""
    solver = cfg["SOLVER"]
    p0 = {n: t.detach().float() for n, t in params.items()}
    p = {n: t.clone().requires_grad_(True) for n, t in p0.items()}
    m = {n: torch.zeros_like(t) for n, t in p0.items()}
    v = {n: torch.zeros_like(t) for n, t in p0.items()}
    ref = MViTReference(cfg, p, quant)
    classes = cfg["MODEL"]["NUM_CLASSES"]
    losses, grad1 = [], {}
    for k in range(steps):
        batch = batches[k % len(batches)]
        x, y = batch["inputs"], batch["labels"]
        B = x.shape[0]
        gen = torch.Generator(device=x.device).manual_seed(step_seed(seed, k))
        masks, head = draw_masks(ref, B, gen, x.device)
        rows = range(B // 2) if half_batch else range(B)
        for t in p.values():
            t.grad = None
        total = torch.zeros((), device=x.device)
        for r in rows:
            mk = [None if mm is None else (mm[0][r:r + 1], mm[1][r:r + 1])
                  for mm in masks]
            logits = ref.logits(x[r:r + 1].float(), mk,
                                None if head is None else head[r:r + 1],
                                remat=True)
            target = F.one_hot(y[r:r + 1].long(), classes).float()
            loss = -(target * torch.log_softmax(logits, -1)).sum() / len(rows)
            loss.backward()
            total += loss.detach()
        losses.append(float(total))
        with torch.no_grad():
            norm = torch.sqrt(sum(t.grad.pow(2).sum() for t in p.values()))
            clip = solver["CLIP_GRAD_L2NORM"]
            scale = 1.0 if float(norm) < clip else clip / float(norm)
            lr = lr_at(solver, k, steps_per_epoch)
            bc1, bc2 = 1 - BETAS[0] ** (k + 1), 1 - BETAS[1] ** (k + 1)
            for n, t in p.items():
                g = t.grad * scale
                if k == 0:
                    grad1[n] = float(g.norm())
                if decays(n, t, solver):
                    t.mul_(1 - lr * solver["WEIGHT_DECAY"])
                m[n].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[n].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = v[n].sqrt() / math.sqrt(bc2) + EPS
                t.addcdiv_(m[n], denom, value=-lr / bc1)
    change = {n: float((p[n].detach() - p0[n]).norm()) for n in p}
    return {"loss": losses, "grad1": grad1, "change": change}
