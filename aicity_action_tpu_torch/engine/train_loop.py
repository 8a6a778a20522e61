"""Training engine (port of ``aicity_action_tpu/engine/train_loop.py``;
reference: tools/train_net.py).

One process drives one card. Each epoch: the epoch-seeded loader, batches
padded to the loader's batch size (the train step masks the loss to the
real samples, and mixup pairs sample i with sample B-1-i of the padded
batch, as in the JAX package), the host-to-card feed staging
``TPU.PREFETCH_DEPTH`` batches ahead, and the train step.

Data parallelism (``NUM_SHARDS * NUM_GPUS`` ranks, one a card, joined by
``parallel/mesh.py:init_distributed``, which ``tools/run_net.py`` calls):
each rank loads its slice of the global batch, the model runs inside
``DistributedDataParallel`` (also in a one-rank group), BatchNorm
statistics are the global batch's, and the logged loss and top-k errors are
the global batch's, as the JAX step's over its sharded batch. Only rank 0
logs and writes checkpoints; every rank reads them back after a barrier.

Deferred metric fetch (the JAX package's): the loss and logits of a step
stay device tensors and are read ``TPU.PREFETCH_DEPTH`` steps after the
step was dispatched, so the host never waits for the step it just queued.
The NaN gate reads every step's loss and drains before any checkpoint or
eval. Then the cadence of checkpoints and evals of the JAX loop.

``BN.USE_PRECISE_STATS`` recomputes the BatchNorm statistics before each
checkpoint and eval (``engine/precise_bn.py``; MViT has none, so nothing
runs for it, as in the JAX package).

Detection (``DETECTION.ENABLE``, AVA): the train step of
``engine/detection.py`` on the batch's box slabs, and an eval that scores
the val set's boxes into the ``AVAMeter``'s frame mAP
(:func:`eval_epoch_detection`, the JAX package's ``train_loop.py:
422-466``), each rank's slabs gathered once an epoch under data
parallelism.

Multi-head models (``MODEL.USE_MULTI_HEAD``, the JAX ``train_loop.py:
84-176``): the multi-dataset train step (``engine/steps.py:
make_multihead_train_step``) on batches that carry each row's
``dataset_idx``, the cross projections set from ``MODEL.
LOAD_MULTI_PROJ_INIT_FILE`` on a fresh start, and an eval that scores every
head into the ``MultiDatasetValMeter`` (:func:`eval_epoch_multihead`).
``TENSORBOARD.ENABLE`` writes the train scalars on rank 0
(``visualization/tensorboard_vis.py``).

Multigrid (``MULTIGRID.LONG_CYCLE`` / ``SHORT_CYCLE``, the JAX ``train_loop.
py:84-96, 211-217``): the schedule derives the solver's steps and epochs
(``utils/multigrid.py``); under the long cycle each epoch takes its base
(B, T, S), and where the shape changes :func:`_long_cycle_rebuild` builds
the model, loader and optimizer anew with the weights carried over and the
step count kept. Detection and multi-head models refuse it, as in the JAX
package. MoE models (``MVIT.MOE.ENABLE``) add ``MVIT.MOE.AUX_LOSS_WEIGHT``
times their load-balance loss to the train step's loss.
"""

from __future__ import annotations

import dataclasses
import math
import os
import pprint
import time

import numpy as np
import torch

from ..data.loader import construct_loader, shuffle_dataset
from ..data.mixup import build_mixup_from_cfg
from ..device import resolve_device
from ..models.build import build_model
from ..models.convnets import is_bn
from ..parallel import mesh
from ..parallel.prefetch import (DeviceFeed, host_transfer_dtype,
                                 prefetch_to_device)
from ..solver.optimizer import TrainOptimizer, construct_optimizer
from ..utils import checkpoint as cu
from ..utils.logging import get_logger, setup_logging
from ..utils.convert import load_cross_proj_weight
from ..utils.meters import (AVAMeter, EpochTimer, MultiDatasetValMeter,
                            TrainMeter, ValMeter)
from ..utils.multigrid import MultigridSchedule
from .detection import (flatten_boxes, make_detection_eval_step,
                        make_detection_train_step)
from .precise_bn import calculate_and_update_precise_bn
from .steps import (make_eval_step, make_multihead_eval_step,
                    make_multihead_train_step, make_train_step,
                    multihead_step_kwargs)

logger = get_logger(__name__)


def _pad_batch(batch: dict, size: int) -> tuple[dict, int]:
    """Pad a short batch to ``size`` by repeating its last sample. A rank's
    batch of a data-parallel loader comes padded, with its real rows in
    ``n_valid``."""
    if "n_valid" in batch:
        batch = dict(batch)
        return batch, int(batch.pop("n_valid"))
    n = batch["labels"].shape[0]
    if n == size:
        return batch, n
    pad = size - n

    def pad_arr(x):
        return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])

    out = {
        k: ([pad_arr(p) for p in v] if isinstance(v, list) else pad_arr(v))
        for k, v in batch.items()
    }
    return out, n


def _errors_mixed(preds: np.ndarray, labels_a: np.ndarray,
                  labels_b: np.ndarray, ks=(1, 5)):
    """Top-k errors under mixup: correct if top-k hits either source label."""
    max_k = min(max(ks), preds.shape[1])
    top = np.argsort(-preds, axis=1)[:, :max_k]
    out = []
    for k in ks:
        k = min(k, preds.shape[1])
        hit = ((top[:, :k] == labels_a[:, None])
               | (top[:, :k] == labels_b[:, None])).any(axis=1)
        out.append((1.0 - hit.mean()) * 100.0)
    return out


def _errors(preds: np.ndarray, labels: np.ndarray, ks=(1, 5)):
    max_k = min(max(ks), preds.shape[1])
    top = np.argsort(-preds, axis=1)[:, :max_k]
    out = []
    for k in ks:
        k = min(k, preds.shape[1])
        correct = (top[:, :k] == labels[:, None]).any(axis=1)
        out.append((1.0 - correct.mean()) * 100.0)
    return out


def moe_aux_weight(cfg) -> float:
    """``MVIT.MOE.AUX_LOSS_WEIGHT`` where MoE is on, else 0."""
    return cfg.MVIT.MOE.AUX_LOSS_WEIGHT if cfg.MVIT.MOE.ENABLE else 0.0


def check_supported(cfg) -> None:
    """Raise for what the JAX loops refuse, and for a data-parallel config
    outside its process group."""
    if (cfg.MULTIGRID.LONG_CYCLE or cfg.MULTIGRID.SHORT_CYCLE) and (
            cfg.DETECTION.ENABLE or cfg.MODEL.USE_MULTI_HEAD):
        raise NotImplementedError(
            "multigrid supports the standard classification path only")
    world = mesh.world_size(cfg)
    if world > 1 and mesh.get_world_size() != world:
        raise RuntimeError(
            f"NUM_SHARDS={cfg.NUM_SHARDS} x NUM_GPUS={cfg.NUM_GPUS} asks for "
            f"{world} ranks, but this process is in a group of "
            f"{mesh.get_world_size()}: launch through tools/run_net (one "
            f"process a card) or call parallel.mesh.init_distributed first")


# what a batch adds to the model's inputs and labels on the card: a
# detection batch's boxes and their mask, a contrastive batch's token ids,
# a multi-dataset batch's dataset indices
_EXTRA_KEYS = ("boxes", "box_mask", "tokens", "dataset_idx")


def _device_batch(feed: DeviceFeed, staged) -> dict:
    """The model's input (one clip, or the list of a multi-pathway model's)
    and the labels, and a detection batch's boxes and their mask, a
    contrastive batch's token ids or a multi-dataset batch's dataset
    indices, on the card."""
    dev = feed.take(staged)
    xs = dev["inputs"]
    out = {"inputs": xs[0] if len(xs) == 1 else xs, "labels": dev["labels"]}
    out.update((k, dev[k]) for k in _EXTRA_KEYS if k in dev)
    return out


def _put(feed: DeviceFeed, batch: dict):
    """Starts the copies of a host batch's model inputs, labels, and boxes
    or token ids."""
    return feed.put({k: batch[k] for k in ("inputs", "labels", *_EXTRA_KEYS)
                     if k in batch})


def wrap_ddp(model: torch.nn.Module, dev: torch.device) -> torch.nn.Module:
    """``model`` inside ``DistributedDataParallel`` where a process group is
    up (one rank included), else ``model``. Buffers are not broadcast: the
    BatchNorm statistics are the global batch's on every rank already."""
    if not mesh.is_initialized():
        return model
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None,
        broadcast_buffers=False)


def _global_rows(tensors: list, n_valid: int) -> tuple[list, int]:
    """The global batch's real rows of each of ``tensors`` (rows of one
    batch) from every rank's (rank-major; a rank's real rows come first),
    and their count. A collective: every rank calls it."""
    if mesh.get_world_size() == 1:
        return [t[:n_valid] for t in tensors], n_valid
    dev = tensors[0].device
    b = tensors[0].shape[0]
    counts = mesh.gather_rows(torch.tensor([n_valid], device=dev))
    keep = torch.cat([torch.arange(r * b, r * b + int(c))
                      for r, c in enumerate(counts.tolist())]).to(dev)
    return [mesh.gather_rows(t)[keep] for t in tensors], int(keep.numel())


def _gathered_rows(preds: torch.Tensor, labels: torch.Tensor,
                   n_valid: int) -> tuple:
    """:func:`_global_rows` of ``preds`` and ``labels``: ``(preds, labels,
    count)``."""
    (preds, labels), n = _global_rows([preds, labels], n_valid)
    return preds, labels, n


@dataclasses.dataclass
class TrainRun:
    """What :func:`train` leaves: the trained model and optimizer, the
    epoch it started at, and a record per epoch it trained (``losses`` of
    each step, ``iter_s`` / ``data_s`` each step's wall and data wait,
    ``wall_s``, ``ckpt_s`` the checkpoint save's seconds on the training
    thread or None, ``val`` the eval's stats or None)."""

    model: torch.nn.Module
    optimizer: TrainOptimizer
    start_epoch: int
    epochs: list


def train(cfg, device: str | torch.device = "cuda") -> TrainRun:
    """Train entry (reference: train_net.py:621-823) on ``device``: a
    machine without a card raises unless the caller asks for the CPU."""
    dev = resolve_device(device)
    check_supported(cfg)
    setup_logging(cfg.OUTPUT_DIR)
    np.random.seed(cfg.RNG_SEED)
    if cfg.LOG_CFG:
        logger.info("Train with config:")
        logger.info(pprint.pformat(cfg.to_dict()))

    multigrid = None
    if cfg.MULTIGRID.LONG_CYCLE or cfg.MULTIGRID.SHORT_CYCLE:
        # the long-cycle driver (upstream slowfast train_net.py's
        # build_trainer loop; dormant in the aicity fork)
        multigrid = MultigridSchedule()
        cfg = multigrid.init_multigrid(cfg)
        if cfg.MULTIGRID.LONG_CYCLE:
            cfg, _ = multigrid.update_long_cycle(cfg, cur_epoch=0)

    model = build_model(cfg, device=dev)
    train_loader = construct_loader(cfg, "train")
    val_loader = construct_loader(cfg, "val")
    steps_per_epoch = max(len(train_loader), 1)

    optimizer = construct_optimizer(cfg, model, steps_per_epoch)
    start_epoch = cu.load_train_checkpoint(cfg, model, optimizer)
    if (cfg.MODEL.MULTI_ADD_CROSS_PROJ and cfg.MODEL.LOAD_MULTI_PROJ_INIT_FILE
            and start_epoch == 0):
        # word-embedding-similarity warm start of the cross projections
        # (train_net.py:679-686)
        logger.info("loaded %d cross-dataset projection weights from %s",
                    load_cross_proj_weight(cfg, model),
                    cfg.MODEL.LOAD_MULTI_PROJ_INIT_FILE)
    ddp_model = wrap_ddp(model, dev)
    precise_bn = cfg.BN.USE_PRECISE_STATS and any(
        is_bn(m) for m in model.modules())

    detection = cfg.DETECTION.ENABLE
    multihead = cfg.MODEL.USE_MULTI_HEAD and not detection
    mixup_fn = None if detection or multihead else build_mixup_from_cfg(cfg)
    if detection:
        train_step = make_detection_train_step(
            ddp_model, optimizer, cfg.MODEL.LOSS_FUNC, seed=cfg.RNG_SEED)
        eval_step = make_detection_eval_step(model)
    elif multihead:
        train_step = make_multihead_train_step(
            ddp_model, optimizer, **multihead_step_kwargs(cfg))
        eval_step = make_multihead_eval_step(model)
    else:
        train_step = _train_step(cfg, ddp_model, optimizer, mixup_fn)
        eval_step = make_eval_step(model)
    feed = DeviceFeed(dev, host_transfer_dtype(cfg))

    train_meter = TrainMeter(steps_per_epoch, cfg)
    val_meter = (MultiDatasetValMeter if multihead else ValMeter)(
        len(val_loader), cfg)
    epoch_timer = EpochTimer()
    writer = None
    if cfg.TENSORBOARD.ENABLE and mesh.is_main_process():
        from ..visualization.tensorboard_vis import TensorboardWriter

        writer = TensorboardWriter(cfg)
    per_host_batch = train_loader.batch_size
    run = TrainRun(model, optimizer, start_epoch, [])

    def run_eval(epoch: int) -> dict:
        if detection:
            return eval_epoch_detection(cfg, eval_step, feed, val_loader,
                                        "val")
        if multihead:
            return eval_epoch_multihead(eval_step, feed, val_loader,
                                        val_meter, epoch)
        return eval_epoch(eval_step, feed, val_loader, val_meter, epoch)

    if cfg.TRAIN.EVAL_FIRST:
        run_eval(start_epoch - 1)

    profiler = None
    for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
        if multigrid is not None and cfg.MULTIGRID.LONG_CYCLE:
            cfg, changed = multigrid.update_long_cycle(cfg, cur_epoch)
            if changed:
                model, optimizer, train_loader = _long_cycle_rebuild(
                    cfg, model, optimizer, dev)
                ddp_model = wrap_ddp(model, dev)
                train_step = _train_step(cfg, ddp_model, optimizer, mixup_fn)
                eval_step = make_eval_step(model)
                precise_bn = cfg.BN.USE_PRECISE_STATS and any(
                    is_bn(m) for m in model.modules())
                steps_per_epoch = max(len(train_loader), 1)
                per_host_batch = train_loader.batch_size
                train_meter = TrainMeter(steps_per_epoch, cfg)
                run.model, run.optimizer = model, optimizer
        shuffle_dataset(train_loader, cur_epoch)
        epoch_timer.epoch_tic()
        train_meter.iter_tic()

        def pad_and_put(batch):
            padded, n_valid = _pad_batch(batch, per_host_batch)
            return _put(feed, padded), padded["labels"], n_valid

        runahead = max(int(cfg.TPU.PREFETCH_DEPTH), 0)
        host_step = optimizer.count
        losses = []

        def process(entry):
            cur_it, metrics, preds, labels, n_valid, step_at = entry
            labels_np = labels.cpu().numpy()
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                raise RuntimeError(
                    f"ERROR: Got NaN/Inf loss at epoch {cur_epoch} "
                    f"iter {cur_it}")
            losses.append(loss)
            if labels_np.ndim == 1:
                preds_np = preds.float().cpu().numpy()[:n_valid]
                if mixup_fn is not None:
                    # a prediction counts as correct if it hits either of
                    # the two mixed labels (train_net.py:248-258); sample i
                    # was mixed with sample B-1-i of the padded batch
                    partners = labels_np[::-1][:n_valid]
                    top1, top5 = _errors_mixed(
                        preds_np, labels_np[:n_valid], partners)
                else:
                    top1, top5 = _errors(preds_np, labels_np[:n_valid])
            else:
                top1 = top5 = None
            lr = float(optimizer.schedule(step_at))
            train_meter.update_stats(top1, top5, loss, lr, n_valid)
            if writer is not None:
                scalars = {"Train/loss": loss, "Train/lr": lr}
                if top1 is not None:
                    scalars["Train/Top1_err"] = top1
                    scalars["Train/Top5_err"] = top5
                writer.add_scalars(
                    scalars, global_step=cur_epoch * steps_per_epoch + cur_it)
            train_meter.log_iter_stats(cur_epoch, cur_it)

        prefetched = prefetch_to_device(train_loader, pad_and_put,
                                        lookahead=cfg.TPU.PREFETCH_DEPTH)
        pending: list = []
        for cur_iter, (_, (staged, _labels, n_valid)) in enumerate(
                prefetched):
            train_meter.data_toc()
            if cfg.TPU.PROFILE_DIR and mesh.is_main_process() and \
                    host_step == cfg.TPU.PROFILE_START_STEP:
                profiler = _start_profile(dev)
            batch = _device_batch(feed, staged)
            batch["n_valid"] = n_valid
            metrics, preds = train_step(batch)
            if profiler is not None and host_step == \
                    cfg.TPU.PROFILE_START_STEP + cfg.TPU.PROFILE_NUM_STEPS:
                profiler = _stop_profile(profiler, dev, cfg, host_step)
            if detection or multihead:
                # no top-k errors: the global batch's count only
                labels = batch["labels"]
                n_all = n_valid * mesh.get_world_size()
            else:  # the global batch's rows, for its top-k errors
                preds, labels, n_all = _gathered_rows(
                    preds, batch["labels"], n_valid)
            pending.append((cur_iter, metrics, preds, labels, n_all,
                            host_step))
            host_step += 1
            if len(pending) > runahead:
                process(pending.pop(0))
            train_meter.iter_toc()
            train_meter.iter_tic()
        for entry in pending:  # drain: NaN gate before checkpoint/eval
            process(entry)

        epoch_timer.epoch_toc()
        logger.info(
            "Epoch %d took %.2fs (avg %.2fs, median %.2fs)",
            cur_epoch, epoch_timer.last_epoch_time(),
            epoch_timer.avg_epoch_time(), epoch_timer.median_epoch_time())
        record = {"epoch": cur_epoch + 1, "losses": losses,
                  "iter_s": list(train_meter.iter_times),
                  "data_s": list(train_meter.data_times),
                  "wall_s": epoch_timer.last_epoch_time(),
                  "ckpt_s": None, "val": None}
        train_meter.log_epoch_stats(cur_epoch)
        train_meter.reset()

        is_ckpt = cu.is_checkpoint_epoch(cfg, cur_epoch)
        is_eval = (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0 or (
            cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH)
        if precise_bn and (is_ckpt or is_eval):
            # recompute BN stats as a true average (train_net.py:784-795)
            record["precise_bn_batches"] = calculate_and_update_precise_bn(
                model, _model_inputs(train_loader, feed),
                num_batches=min(cfg.BN.NUM_BATCHES_PRECISE, steps_per_epoch))
        if is_ckpt:
            t = time.perf_counter()
            cu.save_checkpoint(cfg.OUTPUT_DIR, model, optimizer, cur_epoch,
                               cfg, async_write=cfg.TPU.ASYNC_CHECKPOINT)
            record["ckpt_s"] = time.perf_counter() - t
        if is_eval:
            record["val"] = run_eval(cur_epoch)
        run.epochs.append(record)

    if profiler is not None:  # the run ended inside the traced steps
        _stop_profile(profiler, dev, cfg, optimizer.count - 1)
    if writer is not None:
        writer.close()
    cu.wait_for_pending_saves()
    mesh.barrier()  # rank 0's checkpoints are on disk for every rank
    logger.info("Training done.")
    return run


def _train_step(cfg, ddp_model, optimizer, mixup_fn):
    """The standard classification train step of ``cfg``."""
    return make_train_step(
        ddp_model, optimizer, cfg.MODEL.LOSS_FUNC, mixup_fn=mixup_fn,
        num_classes=cfg.MODEL.NUM_CLASSES, seed=cfg.RNG_SEED,
        moe_aux_weight=moe_aux_weight(cfg))


def _long_cycle_rebuild(cfg, old_model, old_optimizer, dev):
    """The model, optimizer and train loader for a long cycle's new (B, T,
    S) (the JAX ``_long_cycle_rebuild``; upstream slowfast's
    ``build_trainer``): the weights carry over by shape
    (``utils/checkpoint.py:merge_state_dict``), a BatchNorm's ``[C]``
    statistics broadcast into a SubBatchNorm's ``[splits, C]`` (the other
    way the new model keeps its fresh statistics, which the next precise-BN
    pass recomputes); the optimizer's moments restart, and its step count
    carries over so that the stretched LR schedule stays monotone."""
    model = build_model(cfg, device=dev)
    loaded, _, _ = cu.merge_state_dict(model, old_model.state_dict())
    logger.info("long-cycle weight transfer: %d of %d kept", len(loaded),
                len(model.state_dict()))
    train_loader = construct_loader(cfg, "train")
    optimizer = construct_optimizer(cfg, model, max(len(train_loader), 1))
    optimizer.count = old_optimizer.count
    return model, optimizer, train_loader


def _model_inputs(loader, feed: DeviceFeed):
    """The model inputs of ``loader``'s batches, padded and on the card (a
    detection batch's with its flattened boxes, as a tuple)."""
    for b in loader:
        b, _ = _pad_batch(b, loader.batch_size)
        dev = _device_batch(feed, _put(feed, b))
        yield ((dev["inputs"], flatten_boxes(dev["boxes"])) if "boxes" in dev
               else dev["inputs"])


def _start_profile(dev: torch.device):
    """``torch.profiler`` over the next steps (the JAX package's
    ``TPU.PROFILE_DIR`` trace of steady-state steps)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profile(prof, dev: torch.device, cfg, last_step: int) -> None:
    """Waits for the traced steps (to ``last_step``) to finish on the card,
    then writes the trace to ``TPU.PROFILE_DIR``; returns None."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof.__exit__(None, None, None)
    os.makedirs(cfg.TPU.PROFILE_DIR, exist_ok=True)
    path = os.path.join(cfg.TPU.PROFILE_DIR,
                        f"train_steps_{cfg.TPU.PROFILE_START_STEP}_"
                        f"{last_step}.json")
    prof.export_chrome_trace(path)
    logger.info("wrote the profile of the train steps to %s", path)
    return None


def eval_epoch(eval_step, feed: DeviceFeed, val_loader, val_meter,
               cur_epoch: int) -> dict:
    """Validation pass (reference: train_net.py:339-540). Returns the
    meter's epoch stats plus the eval's ``forwards``, ``clips`` and
    ``seconds`` (data loading included)."""
    val_meter.reset()
    t = time.perf_counter()
    forwards = clips = 0
    for batch in val_loader:
        batch, n_valid = _pad_batch(batch, val_loader.batch_size)
        dev_batch = _device_batch(feed, feed.put(
            {"inputs": batch["inputs"], "labels": batch["labels"]}))
        preds, labels, n_valid = _gathered_rows(
            eval_step(dev_batch), dev_batch["labels"], n_valid)
        preds_np = preds.float().cpu().numpy()
        labels = labels.cpu().numpy()
        if labels.ndim == 1:
            top1, top5 = _errors(preds_np, labels)
            val_meter.update_stats(top1, top5, n_valid)
        val_meter.update_predictions(preds_np, labels)
        forwards += 1
        clips += n_valid
    stats = val_meter.log_epoch_stats(cur_epoch)
    stats.update(forwards=forwards, clips=clips,
                 seconds=time.perf_counter() - t)
    return stats


def eval_epoch_multihead(eval_step, feed: DeviceFeed, val_loader, val_meter,
                         cur_epoch: int) -> dict:
    """Multi-head validation (the JAX ``eval_epoch_multihead``; reference:
    train_net.py's USE_MULTI_HEAD branch of eval_epoch): every head scores
    the batch, and the ``MultiDatasetValMeter`` keeps each sample's own
    dataset's scores; the global batch's rows under data parallelism.
    Returns the meter's stats plus the pass's ``forwards``, ``clips`` and
    ``seconds`` (data loading included)."""
    val_meter.reset()
    t = time.perf_counter()
    forwards = clips = 0
    for batch in val_loader:
        batch, n_valid = _pad_batch(batch, val_loader.batch_size)
        dev = _device_batch(feed, _put(feed, batch))
        preds = eval_step(dev)
        names = list(preds)
        rows, n_valid = _global_rows(
            [preds[k] for k in names] + [dev["labels"], dev["dataset_idx"]],
            n_valid)
        val_meter.update_stats(
            {k: r.float().cpu().numpy() for k, r in zip(names, rows)},
            rows[-2].cpu().numpy(), rows[-1].cpu().numpy())
        forwards += 1
        clips += n_valid
    stats = val_meter.log_epoch_stats(cur_epoch)
    stats.update(forwards=forwards, clips=clips,
                 seconds=time.perf_counter() - t)
    return stats


def eval_epoch_detection(cfg, eval_step, feed: DeviceFeed, loader,
                         mode: str) -> dict:
    """AVA detection eval (the JAX package's ``eval_epoch_detection``;
    reference: train_net.py's DETECTION branch of eval_epoch and
    test_net.py:98-108): every batch's box slabs scored, then the valid
    boxes' scores, their original boxes normalized by the frame's
    ``orig_hw`` and their (video, second) into the ``AVAMeter``. Under data
    parallelism each rank's fixed-size slabs are gathered once, after the
    last batch, and put back in the one-process order with each batch's
    padded rows dropped. Returns ``{"map"}`` plus the pass's ``forwards``,
    ``clips`` and ``seconds`` (data loading included)."""
    t = time.perf_counter()
    slabs: dict = {k: [] for k in ("preds", "box_mask", "ori_boxes",
                                   "metadata", "orig_hw")}
    n_valid_all = []
    for batch in loader:
        batch, n_valid = _pad_batch(batch, loader.batch_size)
        dev_batch = _device_batch(feed, _put(feed, batch))
        preds = eval_step(dev_batch).float().cpu().numpy()
        m = batch["boxes"].shape[1]
        slabs["preds"].append(preds.reshape(-1, m, preds.shape[-1]))
        for k in ("box_mask", "ori_boxes", "metadata", "orig_hw"):
            slabs[k].append(np.asarray(batch[k]))
        n_valid_all.append(n_valid)
    # [ranks][batches][rows, ...]: rank-major per epoch, one gather a slab
    ranks = {k: mesh.process_allgather(np.stack(v))
             for k, v in slabs.items()}
    counts = mesh.process_allgather(np.asarray(n_valid_all, np.int64))
    rows = {k: [] for k in slabs}
    for i in range(len(n_valid_all)):
        for r, n in enumerate(counts):
            for k in slabs:
                rows[k].append(ranks[k][r][i][:int(n[i])])
    got = {k: np.concatenate(v) for k, v in rows.items()}
    meter = AVAMeter(len(loader), cfg, mode)
    meter.video_idx_to_name = loader.dataset.video_idx_to_name
    for b in range(len(got["preds"])):
        keep = got["box_mask"][b].astype(bool)
        if not keep.any():
            continue
        h, w = got["orig_hw"][b]
        boxes = got["ori_boxes"][b][keep] / np.asarray([w, h, w, h],
                                                       np.float32)
        meter.update_stats(got["preds"][b][keep], boxes,
                           got["metadata"][b][keep])
    full_map = meter.finalize_metrics()
    return {"map": full_map, "forwards": len(n_valid_all),
            "clips": len(got["preds"]), "seconds": time.perf_counter() - t}
