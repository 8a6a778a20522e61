"""Driver ``train``: the port's recipe train step (``engine/steps.py:
make_train_step`` with ``solver/optimizer.py:construct_optimizer``: the
config's loss, activation checkpointing, DropPath, head dropout, clipping,
AdamW) on batches of clips made on the device.

Set-up builds the one step object, with the model and the optimizer state,
and drives it through the mix's ``checked_steps`` first steps on batches
that all differ; those steps compile and warm up every shape, and their
readings are kept: each step's loss, each leaf's first gradient as AdamW
got it (its first moment after one step over 1 - beta1) and each leaf's
change over the checked steps. The same object then runs the window
(``port_bench/window.py:run_steps``), cycling through the batch pool.

Correctness, once the window has closed and the program is freed: the
float32 reference (``port_bench/reference/train.py``) follows the checked
steps from the same weights, batches and random draws; ``loss_gap`` is the
widest relative gap of a step's loss, ``grad_gap`` and ``change_gap`` the
worst leaf's (:func:`port_bench.compare.leaf_gap`; the change over the
leaves that the reference's gradient moves, :func:`port_bench.compare.
moving_leaves`). ``failed`` counts the window's steps whose loss is not
finite.
"""

from __future__ import annotations

import time
import types

import torch

from port_bench import compare, reference, traffic as tr, weights, window
from port_bench.profiling import window_profile
from port_bench.program import port_cfg, port_model
from port_bench.reference.train import BETAS, follow


def run(ctx):
    from aicity_action_tpu_torch.engine.steps import make_train_step
    from aicity_action_tpu_torch.solver.optimizer import construct_optimizer

    t, c, dev = ctx.traffic, ctx.config["cfg"], ctx.device
    cuda = dev.type == "cuda"
    ctx.mark("imports")
    cfg = port_cfg(ctx.config)
    model = port_model(cfg, weights.make(c, ctx.seed, dev), dev)
    opt = construct_optimizer(cfg, model, t["steps_per_epoch"])
    step = make_train_step(model, opt, cfg.MODEL.LOSS_FUNC,
                           num_classes=cfg.MODEL.NUM_CLASSES, seed=ctx.seed)
    D = c["DATA"]
    batches = tr.clip_batches(t, D["NUM_FRAMES"], D["TRAIN_CROP_SIZE"],
                              c["MODEL"]["NUM_CLASSES"], ctx.seed, dev)
    ctx.mark("model and batches")
    named = list(model.named_parameters())
    p0 = {n: p.detach().clone() for n, p in named}
    losses, grad1 = [], {}
    k0 = t["checked_steps"]
    for k in range(k0):
        metrics, _ = step(batches[k % len(batches)])
        losses.append(metrics["loss"])
        if k == 0:
            grad1 = {n: first_moment(opt, p).norm() / (1 - BETAS[0])
                     for n, p in named}
    prog = {"loss": [float(x) for x in losses],
            "grad1": {n: float(v) for n, v in grad1.items()},
            "change": {n: float((p.detach() - p0[n]).norm())
                       for n, p in named}}
    del p0
    if cuda:
        torch.cuda.synchronize(dev)
    ctx.mark("checked steps")
    rec = types.SimpleNamespace(kind="train", cfg=c, traffic=t,
                                setup_s=time.perf_counter() - ctx.t_start)
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    window_losses = []

    def one(i):
        metrics, _ = step(batches[(k0 + i) % len(batches)])
        window_losses.append(metrics["loss"])

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    with window_profile(ctx.trace, rec):
        rec.steps, rec.window_s = window.run_steps(one, ctx.seconds, sync)
    rec.clips = rec.steps * t["batch_size"]
    rec.window_peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else 0
    rec.memory_peak_bytes = max(setup_peak, rec.window_peak_bytes)
    rec.attempted = rec.steps
    rec.failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    del step, opt, model, batches, named, losses, grad1, window_losses
    if cuda:
        torch.cuda.empty_cache()

    with reference.exact():
        ref = follow(c, weights.make(c, ctx.seed, dev),
                     tr.clip_batches(t, D["NUM_FRAMES"], D["TRAIN_CROP_SIZE"],
                                     c["MODEL"]["NUM_CLASSES"], ctx.seed, dev),
                     ctx.seed, k0, t["steps_per_epoch"])
    rec.checks = checks(prog, ref, ctx.limits)
    return rec


def first_moment(opt, p) -> torch.Tensor:
    """AdamW's first moment of ``p`` (zeros before any update)."""
    state = opt.opt.state.get(p, {})
    return state["exp_avg"] if "exp_avg" in state else torch.zeros_like(p)


def checks(prog: dict, ref: dict, limits: dict) -> list:
    """The compared numbers of the checked steps."""
    loss = max(compare.rel_gap(p, r) for p, r in zip(prog["loss"],
                                                      ref["loss"]))
    grad, _ = compare.leaf_gap(prog["grad1"], ref["grad1"])
    change, _ = compare.leaf_gap(prog["change"], ref["change"],
                                 compare.moving_leaves(ref["grad1"]))
    return [compare.check("loss_gap", loss, limits["loss_gap"]),
            compare.check("grad_gap", grad, limits["grad_gap"]),
            compare.check("change_gap", change, limits["change_gap"])]
