"""Multi-view test engine (port of ``aicity_action_tpu/engine/test_loop.py``;
reference: tools/test_net.py).

Each video is scored ``NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS`` times; the
``TestMeter`` ensembles the views of a video (sum or max). Under data
parallelism each rank scores its slice of every batch, and one host-side
gather of predictions, labels and clip indices an epoch
(``parallel/mesh.py:process_allgather``) gives every rank the whole set
before the meter. Under ``DETECTION.ENABLE`` the test set's boxes are
scored into the ``AVAMeter`` instead and the run returns ``{"map"}``
(``engine/train_loop.py:eval_epoch_detection``). A multi-head model is
tested on one head: ``TEST.DATASET``'s, or under ``DATA.MODEL_DIFF_DATA``
``TRAIN.DATASET``'s (the JAX ``test_loop.py:79-91``; reference
test_net.py:109-114).
"""

from __future__ import annotations

import pickle
import pprint
import time

import numpy as np
import torch

from ..data.loader import construct_loader
from ..device import resolve_device
from ..models.build import build_model
from ..parallel import mesh
from ..parallel.prefetch import DeviceFeed, host_transfer_dtype
from ..utils import checkpoint as cu
from ..utils.logging import get_logger, setup_logging
from ..utils.meters import TestMeter
from .detection import make_detection_eval_step
from .steps import make_eval_step
from .train_loop import (_device_batch, _pad_batch, check_supported,
                         eval_epoch_detection)

logger = get_logger(__name__)


def test(cfg, device: str | torch.device = "cuda") -> dict:
    """Test entry (reference: test_net.py:173-248) on ``device`` (a machine
    without a card raises unless the caller asks for the CPU). Returns the
    ``TestMeter``'s final stats (a detection config: ``{"map"}``) plus the
    run's ``forwards``, ``clips`` and ``seconds`` (data loading
    included)."""
    dev = resolve_device(device)
    check_supported(cfg)
    setup_logging(cfg.OUTPUT_DIR)
    np.random.seed(cfg.RNG_SEED)
    if cfg.LOG_CFG and not cfg.TEST.NO_LOG_CONFIG:
        logger.info("Test with config:")
        logger.info(pprint.pformat(cfg.to_dict()))

    model = build_model(cfg, device=dev)
    cu.load_test_checkpoint(cfg, model)
    loader = construct_loader(cfg, "test")
    dataset = loader.dataset
    feed = DeviceFeed(dev, host_transfer_dtype(cfg))
    if cfg.DETECTION.ENABLE:
        # AVA box testing: the frame mAP (the JAX test_loop.py:57-65)
        return eval_epoch_detection(cfg, make_detection_eval_step(model),
                                    feed, loader, "test")

    num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    if len(dataset) % num_clips:
        raise ValueError(f"{len(dataset)} test clips are not a multiple of "
                         f"{num_clips} views a video")
    meter = TestMeter(
        num_videos=dataset.num_videos,
        num_clips=num_clips,
        num_cls=cfg.MODEL.NUM_CLASSES,
        multi_label=cfg.DATA.MULTI_LABEL,
        ensemble_method=cfg.DATA.ENSEMBLE_METHOD,
    )
    if cfg.MODEL.USE_MULTI_HEAD:
        head = (cfg.TRAIN.DATASET if cfg.DATA.MODEL_DIFF_DATA
                else cfg.TEST.DATASET)

        def eval_step(batch):
            model.eval()
            with torch.no_grad():
                return model(batch["inputs"], dataset_name=head)[head]
    else:
        eval_step = make_eval_step(model)

    t = time.perf_counter()
    preds_all, labels_all, index_all = [], [], []
    for batch in loader:
        batch, n_valid = _pad_batch(batch, loader.batch_size)
        preds = eval_step(_device_batch(feed, feed.put(
            {"inputs": batch["inputs"], "labels": batch["labels"]})))
        preds_all.append(preds.float().cpu().numpy()[:n_valid])
        labels_all.append(batch["labels"][:n_valid])
        index_all.append(batch["index"][:n_valid])
    preds_np = np.concatenate(preds_all)
    labels = np.concatenate(labels_all)
    index = np.concatenate(index_all)
    if mesh.get_world_size() > 1:
        # one gather an epoch, not a batch (test_net.py:119-122)
        preds_np = np.concatenate(mesh.process_allgather(preds_np))
        labels = np.concatenate(mesh.process_allgather(labels))
        index = np.concatenate(mesh.process_allgather(index))
    seconds = time.perf_counter() - t
    meter.update_stats(preds_np, labels, index)

    stats = dict(meter.finalize_metrics())
    if cfg.TEST.SAVE_RESULTS_PATH and mesh.is_main_process():
        with open(cfg.TEST.SAVE_RESULTS_PATH, "wb") as f:
            pickle.dump([meter.video_preds, meter.video_labels], f)
        logger.info("Saved predictions to %s", cfg.TEST.SAVE_RESULTS_PATH)
    stats.update(forwards=len(preds_all), clips=len(dataset),
                 seconds=seconds)
    return stats
