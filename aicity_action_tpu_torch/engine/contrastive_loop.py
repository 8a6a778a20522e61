"""Contrastive training and retrieval-test loops (port of
``aicity_action_tpu/engine/contrastive_loop.py``; reference:
tools/train_net_contrastive.py and tools/test_net_contrastive.py).

- :func:`train_contrastive`: ActionCLIP on ``Web_video_text`` clips and
  their captions' ids. Each epoch: the epoch-seeded loader, every batch
  padded to the loader's batch size (the step masks the padded rows out of
  the similarity matrix), the host-to-card feed staging
  ``TPU.PREFETCH_DEPTH`` batches ahead, the train step
  (``engine/contrastive.py``), the ``TrainMeter``; then the checkpoint
  (with MoCo's momentum weights) and the retrieval eval on the cadence of
  the JAX loop. Auto-resume restores the momentum weights as well.
- :func:`eval_contrastive_epoch`: video-to-text and text-to-video recall@k
  over the whole val set; under data parallelism each rank's features are
  gathered once an epoch and put back in the one-process order (the
  dataset's order: the val and test loaders do not shuffle).
- :func:`test_contrastive`: the same over the test set; with
  ``TEST.SAVE_RESULTS_PATH`` the video features and their item indices
  are pickled as ``(features [N, D] f32, ids [N])``, the input of
  ``tools/inference_videotext.py``.

One process drives one card; under ``NUM_GPUS`` > 1 the ranks train under
``DistributedDataParallel`` (``tools/run_net_contrastive.py`` spawns them)
and only rank 0 logs and writes.
"""

from __future__ import annotations

import dataclasses
import math
import pickle
import pprint
import time

import numpy as np
import torch

from ..data.loader import construct_loader, shuffle_dataset
from ..device import resolve_device
from ..models.build import build_model
from ..parallel import mesh
from ..parallel.prefetch import (DeviceFeed, host_transfer_dtype,
                                 prefetch_to_device)
from ..solver.optimizer import TrainOptimizer, construct_optimizer
from ..utils import checkpoint as cu
from ..utils.logging import get_logger, log_json_stats, setup_logging
from ..utils.meters import EpochTimer, TrainMeter
from .contrastive import (make_contrastive_train_step, make_feature_step,
                          make_momentum_model, retrieval_metrics)
from .train_loop import (_device_batch, _pad_batch, _put, check_supported,
                         wrap_ddp)

logger = get_logger(__name__)


@dataclasses.dataclass
class ContrastiveRun:
    """What :func:`train_contrastive` leaves: the trained model, its
    optimizer and momentum model (None without MoCo), the epoch it started
    at, and a record per epoch (``losses`` and ``logit_scales`` of each
    step, ``iter_s`` / ``data_s`` each step's wall and data wait,
    ``wall_s``, ``ckpt_s``, ``val`` the eval's stats or None)."""

    model: torch.nn.Module
    optimizer: TrainOptimizer
    momentum_model: torch.nn.Module | None
    start_epoch: int
    epochs: list


def train_contrastive(cfg, device: str | torch.device = "cuda"
                      ) -> ContrastiveRun:
    """Contrastive train entry (train_net_contrastive.py) on ``device``: a
    machine without a card raises unless the caller asks for the CPU."""
    dev = resolve_device(device)
    check_supported(cfg)
    setup_logging(cfg.OUTPUT_DIR)
    np.random.seed(cfg.RNG_SEED)
    if cfg.LOG_CFG:
        logger.info("Contrastive train with config:")
        logger.info(pprint.pformat(cfg.to_dict()))

    model = build_model(cfg, device=dev)
    train_loader = construct_loader(cfg, "train")
    val_loader = construct_loader(cfg, "val")
    steps_per_epoch = max(len(train_loader), 1)
    optimizer = construct_optimizer(cfg, model, steps_per_epoch)
    # the momentum weights start as the initial weights, before any load
    # (the JAX package's ContrastiveState.create)
    momentum = make_momentum_model(model) if cfg.TRAIN.USE_MOCO else None
    start_epoch = cu.load_train_checkpoint(cfg, model, optimizer, momentum)
    step_fn = make_contrastive_train_step(
        wrap_ddp(model, dev), optimizer, use_moco=cfg.TRAIN.USE_MOCO,
        moco_momentum=cfg.TRAIN.MOCO_MOMENTUM, momentum_model=momentum,
        seed=cfg.RNG_SEED)
    feature_step = make_feature_step(model)
    feed = DeviceFeed(dev, host_transfer_dtype(cfg))

    meter = TrainMeter(steps_per_epoch, cfg)
    timer = EpochTimer()
    per_rank_batch = train_loader.batch_size
    run = ContrastiveRun(model, optimizer, momentum, start_epoch, [])

    for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
        shuffle_dataset(train_loader, cur_epoch)
        timer.epoch_tic()
        meter.iter_tic()

        def pad_and_put(batch):
            padded, n_valid = _pad_batch(batch, per_rank_batch)
            return _put(feed, padded), n_valid

        losses, scales = [], []
        for cur_iter, (_, (staged, n_valid)) in enumerate(prefetch_to_device(
                train_loader, pad_and_put, lookahead=cfg.TPU.PREFETCH_DEPTH)):
            meter.data_toc()
            batch = _device_batch(feed, staged)
            batch["n_valid"] = n_valid
            metrics, _ = step_fn(batch)
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                raise RuntimeError(
                    f"ERROR: Got NaN/Inf loss at epoch {cur_epoch} "
                    f"iter {cur_iter}")
            losses.append(loss)
            scales.append(float(metrics["logit_scale"]))
            meter.iter_toc()
            meter.update_stats(None, None, loss, metrics["lr"],
                               n_valid * mesh.get_world_size())
            meter.log_iter_stats(cur_epoch, cur_iter)
            meter.iter_tic()
        timer.epoch_toc()
        record = {"epoch": cur_epoch + 1, "losses": losses,
                  "logit_scales": scales, "iter_s": list(meter.iter_times),
                  "data_s": list(meter.data_times),
                  "wall_s": timer.last_epoch_time(), "ckpt_s": None,
                  "val": None}
        meter.log_epoch_stats(cur_epoch)
        meter.reset()

        if cu.is_checkpoint_epoch(cfg, cur_epoch):
            t = time.perf_counter()
            cu.save_checkpoint(cfg.OUTPUT_DIR, model, optimizer, cur_epoch,
                               cfg, async_write=cfg.TPU.ASYNC_CHECKPOINT,
                               momentum_model=momentum)
            record["ckpt_s"] = time.perf_counter() - t
        if (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0 or (
                cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH):
            record["val"] = eval_contrastive_epoch(
                cfg, feature_step, feed, val_loader, cur_epoch)
        run.epochs.append(record)
    cu.wait_for_pending_saves()
    mesh.barrier()  # rank 0's checkpoints are on disk for every rank
    logger.info("Contrastive training done.")
    return run


def _features(feature_step, feed: DeviceFeed, loader) -> tuple:
    """``(video features, text features, labels, item indices)`` of every
    item of ``loader``, f32 numpy, in the dataset's order (every rank's
    rows gathered once, after the last batch), and the forwards run."""
    vs, ts, ls, ids = [], [], [], []
    for batch in loader:
        batch, n_valid = _pad_batch(batch, loader.batch_size)
        v, t, _ = feature_step(_device_batch(feed, _put(feed, batch)))
        vs.append(v.float().cpu().numpy()[:n_valid])
        ts.append(t.float().cpu().numpy()[:n_valid])
        ls.append(batch["labels"][:n_valid])
        ids.append(batch["index"][:n_valid])
    parts = [np.concatenate(x) for x in (vs, ts, ls, ids)]
    if mesh.get_world_size() > 1:
        parts = [np.concatenate(mesh.process_allgather(x)) for x in parts]
    order = np.argsort(parts[3], kind="stable")
    return tuple(x[order] for x in parts) + (len(vs),)


def eval_contrastive_epoch(cfg, feature_step, feed: DeviceFeed, loader,
                           cur_epoch: int) -> dict:
    """Retrieval recall over the whole val set
    (test_net_contrastive.py:150-160). Returns the six recalls plus the
    pass's ``forwards``, ``clips`` and ``seconds``."""
    t0 = time.perf_counter()
    v, t, labels, _, forwards = _features(feature_step, feed, loader)
    stats = retrieval_metrics(v, t, labels)
    log_json_stats({**stats, "_type": "contrastive_val_epoch",
                    "epoch": f"{cur_epoch + 1}/{cfg.SOLVER.MAX_EPOCH}"})
    stats.update(forwards=forwards, clips=len(v),
                 seconds=time.perf_counter() - t0)
    return stats


def test_contrastive(cfg, device: str | torch.device = "cuda") -> dict:
    """Retrieval test (test_net_contrastive.py:173-226) on ``device``: the
    test set's recalls, plus ``forwards``, ``clips`` and ``seconds``. With
    ``TEST.SAVE_RESULTS_PATH`` (the JAX CLI's ``save_features_path``) rank
    0 pickles ``(video features [N, D], ids [N])`` there."""
    dev = resolve_device(device)
    check_supported(cfg)
    setup_logging(cfg.OUTPUT_DIR)
    model = build_model(cfg, device=dev)
    cu.load_test_checkpoint(cfg, model)
    loader = construct_loader(cfg, "test")
    feed = DeviceFeed(dev, host_transfer_dtype(cfg))
    t0 = time.perf_counter()
    v, t, labels, ids, forwards = _features(make_feature_step(model), feed,
                                            loader)
    stats = retrieval_metrics(v, t, labels)
    log_json_stats({**stats, "_type": "contrastive_test"})
    path = cfg.TEST.SAVE_RESULTS_PATH
    if path and mesh.is_main_process():
        with open(path, "wb") as f:
            pickle.dump((v, ids), f)
        logger.info("Saved features to %s", path)
    stats.update(forwards=forwards, clips=len(v),
                 seconds=time.perf_counter() - t0)
    return stats
