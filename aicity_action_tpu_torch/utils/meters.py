"""Training and eval meters (port of ``aicity_action_tpu/utils/meters.py``;
reference: slowfast/utils/meters.py).

Host-side bookkeeping: windowed-median scalars, ETA estimation, the
clip -> video ensemble ``TestMeter`` and numpy mAP. Values arrive here as
host numbers. ``TrainMeter`` also keeps each iteration's wall and data
wait of the epoch (``iter_times``, ``data_times``), from which the train
loop reports its data-wait share. ``AVAMeter`` gives the AVA frame mAP of
detection. ``MultiDatasetValMeter`` gives the multi-head models' top-k
per dataset.
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from collections import deque

import numpy as np

from .logging import log_json_stats


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self._paused: float | None = None
        self._total = 0.0

    def pause(self):
        if self._paused is None:
            self._paused = time.perf_counter()

    def resume(self):
        if self._paused is not None:
            self._total += self._paused - self._start
            self._start = time.perf_counter()
            self._paused = None

    def seconds(self) -> float:
        if self._paused is not None:
            return self._total + (self._paused - self._start)
        return self._total + (time.perf_counter() - self._start)


class ScalarMeter:
    """Windowed scalar with median/avg (reference: meters.py ScalarMeter)."""

    def __init__(self, window_size: int = 10):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def reset(self):
        self.deque.clear()
        self.total = 0.0
        self.count = 0

    def add_value(self, value: float):
        self.deque.append(value)
        self.count += 1
        self.total += value

    def get_win_median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    def get_win_avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    def get_global_avg(self) -> float:
        return self.total / max(self.count, 1)


class TrainMeter:
    def __init__(self, epoch_iters: int, cfg):
        self.cfg = cfg
        self.epoch_iters = epoch_iters
        self.max_iter = cfg.SOLVER.MAX_EPOCH * epoch_iters
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()
        self.loss = ScalarMeter(cfg.LOG_PERIOD)
        self.loss_total = 0.0
        self.lr = 0.0
        self.mb_top1_err = ScalarMeter(cfg.LOG_PERIOD)
        self.mb_top5_err = ScalarMeter(cfg.LOG_PERIOD)
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.iter_times: list[float] = []
        self.data_times: list[float] = []

    def reset(self):
        self.loss.reset()
        self.loss_total = 0.0
        self.mb_top1_err.reset()
        self.mb_top5_err.reset()
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.iter_times = []
        self.data_times = []

    def iter_tic(self):
        self.iter_timer.reset()
        self.data_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()
        self.iter_times.append(self.iter_timer.seconds())
        self.data_times.append(self.data_timer.seconds())

    def data_toc(self):
        self.data_timer.pause()
        self.net_timer.reset()

    def update_stats(self, top1_err, top5_err, loss, lr, mb_size):
        self.loss.add_value(loss)
        self.lr = lr
        self.loss_total += loss * mb_size
        self.num_samples += mb_size
        if top1_err is not None:
            self.mb_top1_err.add_value(top1_err)
            self.mb_top5_err.add_value(top5_err)
            self.num_top1_mis += top1_err * mb_size
            self.num_top5_mis += top5_err * mb_size

    def log_iter_stats(self, cur_epoch: int, cur_iter: int):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        eta_sec = self.iter_timer.seconds() * (
            self.max_iter - (cur_epoch * self.epoch_iters + cur_iter + 1)
        )
        stats = {
            "_type": "train_iter",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.epoch_iters}",
            "dt": self.iter_timer.seconds(),
            "dt_data": self.data_timer.seconds(),
            "eta": str(datetime.timedelta(seconds=int(eta_sec))),
            "loss": self.loss.get_win_median(),
            "top1_err": self.mb_top1_err.get_win_median(),
            "top5_err": self.mb_top5_err.get_win_median(),
            "lr": self.lr,
        }
        log_json_stats(stats)

    def log_epoch_stats(self, cur_epoch: int):
        stats = {
            "_type": "train_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "loss": self.loss_total / max(self.num_samples, 1),
            "top1_err": self.num_top1_mis / max(self.num_samples, 1),
            "top5_err": self.num_top5_mis / max(self.num_samples, 1),
            "lr": self.lr,
        }
        log_json_stats(stats)


class ValMeter:
    def __init__(self, max_iter: int, cfg):
        self.cfg = cfg
        self.max_iter = max_iter
        self.iter_timer = Timer()
        self.mb_top1_err = ScalarMeter(cfg.LOG_PERIOD)
        self.mb_top5_err = ScalarMeter(cfg.LOG_PERIOD)
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.all_preds: list = []
        self.all_labels: list = []
        self.min_top1_err = 100.0

    def reset(self):
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.all_preds = []
        self.all_labels = []

    def iter_tic(self):
        self.iter_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def update_stats(self, top1_err, top5_err, mb_size):
        self.num_top1_mis += top1_err * mb_size
        self.num_top5_mis += top5_err * mb_size
        self.num_samples += mb_size

    def update_predictions(self, preds, labels):
        self.all_preds.append(np.asarray(preds))
        self.all_labels.append(np.asarray(labels))

    def log_epoch_stats(self, cur_epoch: int):
        top1 = self.num_top1_mis / max(self.num_samples, 1)
        self.min_top1_err = min(self.min_top1_err, top1)
        stats = {
            "_type": "val_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "top1_err": top1,
            "top5_err": self.num_top5_mis / max(self.num_samples, 1),
            "min_top1_err": self.min_top1_err,
        }
        if self.cfg.DATA.MULTI_LABEL and self.all_preds:
            stats["map"] = get_map(
                np.concatenate(self.all_preds), np.concatenate(self.all_labels)
            )
        log_json_stats(stats)
        return stats


class TestMeter:
    """Clip→video ensemble (reference: meters.py:278-481).

    Each video contributes ``num_clips`` scored views; scores are summed or
    maxed into per-video predictions keyed by ``clip_id // num_clips``.
    """

    def __init__(
        self,
        num_videos: int,
        num_clips: int,
        num_cls: int,
        overall_iters: int = 0,
        multi_label: bool = False,
        ensemble_method: str = "sum",
    ):
        assert ensemble_method in ("sum", "max")
        self.num_clips = num_clips
        self.multi_label = multi_label
        self.ensemble_method = ensemble_method
        self.video_preds = np.zeros((num_videos, num_cls), np.float32)
        if multi_label:
            self.video_preds -= 1e10
        self.video_labels = (
            np.zeros((num_videos, num_cls), np.float32)
            if multi_label else np.zeros(num_videos, np.int64)
        )
        self.clip_count = np.zeros(num_videos, np.int64)
        self.stats: dict = {}

    def reset(self):
        self.clip_count[:] = 0
        self.video_preds[:] = -1e10 if self.multi_label else 0
        self.video_labels[:] = 0

    def update_stats(self, preds, labels, clip_ids):
        preds = np.asarray(preds)
        labels = np.asarray(labels)
        clip_ids = np.asarray(clip_ids)
        for i in range(preds.shape[0]):
            vid_id = int(clip_ids[i]) // self.num_clips
            if not self.multi_label and self.clip_count[vid_id] > 0:
                assert np.array_equal(self.video_labels[vid_id], labels[i]), (
                    f"label mismatch for video {vid_id}"
                )
            self.video_labels[vid_id] = labels[i]
            if self.ensemble_method == "sum":
                self.video_preds[vid_id] += preds[i]
            else:
                self.video_preds[vid_id] = np.maximum(
                    self.video_preds[vid_id], preds[i]
                )
            self.clip_count[vid_id] += 1

    def finalize_metrics(self, ks=(1, 5)) -> dict:
        if not all(self.clip_count == self.num_clips):
            short = np.argwhere(self.clip_count != self.num_clips).ravel()
            logging.getLogger(__name__).warning(
                "clip count incomplete for videos %s (%s)",
                short[:8], self.clip_count[short][:8],
            )
        stats = {"_type": "test_final"}
        if self.multi_label:
            stats["map"] = get_map(self.video_preds, self.video_labels)
        else:
            for k in ks:
                topk = np.argsort(-self.video_preds, axis=1)[:, :k]
                correct = (topk == self.video_labels[:, None]).any(axis=1)
                acc = correct.mean() * 100.0
                stats[f"top{k}_acc"] = round(float(acc), 2)
        self.stats = stats
        log_json_stats(stats)
        return stats


def topks_correct_full_label(preds: np.ndarray, labels: np.ndarray,
                             ks=(1, 5)) -> list:
    """Multi-label top-k accuracy (reference: metrics.py:85-141).

    A sample counts as correct at k if ANY of its top-k predictions is a
    positive label (the Multi-Moments-in-Time convention).
    """
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    max_k = min(max(ks), preds.shape[1])
    top = np.argsort(-preds, axis=1)[:, :max_k]
    pos = labels == 1.0
    out = []
    for k in ks:
        k = min(k, preds.shape[1])
        hit = pos[np.arange(len(preds))[:, None], top[:, :k]].any(axis=1)
        out.append(float(hit.mean()) if len(preds) else 0.0)
    return out


class MultiDatasetValMeter:
    """Per-dataset validation accuracy of a multi-head model (the JAX
    ``meters.py:304``; reference: meters.py:856-898). Every head scores
    each sample; :meth:`update_stats` keeps each sample's own dataset's
    scores and labels (``labels_full [B, max classes]`` cut to the
    dataset's classes); :meth:`log_epoch_stats` gives each dataset's top-1
    / top-5 (:func:`topks_correct_full_label`) and their means."""

    def __init__(self, max_iter: int, cfg):
        self.cfg = cfg
        self.max_iter = max_iter
        self.datasets = list(cfg.MODEL.MULTI_DATASETS)
        self.num_classes = list(cfg.MODEL.MULTI_NUM_CLASSES)
        self.reset()

    def reset(self):
        self.all_preds = {ds: [] for ds in self.datasets}
        self.all_labels = {ds: [] for ds in self.datasets}

    def update_stats(self, preds_by_ds: dict, labels_full: np.ndarray,
                     dataset_idx: np.ndarray):
        dataset_idx = np.asarray(dataset_idx)
        for i, (ds, n_cls) in enumerate(zip(self.datasets,
                                            self.num_classes)):
            sel = dataset_idx == i
            if not sel.any():
                continue
            self.all_preds[ds].append(np.asarray(preds_by_ds[ds])[sel])
            self.all_labels[ds].append(
                np.asarray(labels_full)[sel][:, :n_cls])

    def log_epoch_stats(self, cur_epoch: int) -> dict:
        stats = {"_type": "val_epoch",
                 "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}"}
        per_ds, top1s, top5s = {}, [], []
        for ds in self.datasets:
            if not self.all_preds[ds]:
                continue
            top1, top5 = topks_correct_full_label(
                np.concatenate(self.all_preds[ds]),
                np.concatenate(self.all_labels[ds]), ks=(1, 5))
            per_ds[ds] = {"top1_acc": top1, "top5_acc": top5}
            top1s.append(top1)
            top5s.append(top5)
        stats["dataset_topk"] = per_ds
        stats["top1_avg_acc"] = float(np.mean(top1s)) if top1s else 0.0
        stats["top5_avg_acc"] = float(np.mean(top5s)) if top5s else 0.0
        log_json_stats(stats)
        return stats


class EpochTimer:
    """Per-epoch durations + median-based ETA (reference: meters.py:1125-1177)."""

    def __init__(self):
        self.timer = Timer()
        self.epoch_times: list[float] = []

    def reset(self):
        self.timer.reset()
        self.epoch_times = []

    def epoch_tic(self):
        self.timer.reset()

    def epoch_toc(self):
        self.timer.pause()
        self.epoch_times.append(self.timer.seconds())

    def last_epoch_time(self) -> float:
        return self.epoch_times[-1]

    def avg_epoch_time(self) -> float:
        return float(np.mean(self.epoch_times))

    def median_epoch_time(self) -> float:
        return float(np.median(self.epoch_times))


def get_map(preds: np.ndarray, labels: np.ndarray) -> float:
    """Mean average precision over classes (reference: meters.py:1097-1123,
    sklearn-free numpy implementation)."""
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    keep = ~((labels == 0).all(axis=1))
    preds, labels = preds[keep], labels[keep]
    aps = []
    for c in range(preds.shape[1]):
        y, s = labels[:, c], preds[:, c]
        if y.sum() == 0:
            continue
        order = np.argsort(-s)
        y = y[order]
        tp = np.cumsum(y)
        precision = tp / (np.arange(len(y)) + 1)
        ap = (precision * y).sum() / y.sum()
        aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0


class AVAMeter:
    """Accumulates box predictions over an epoch and computes the AVA frame
    mAP (reference: meters.py:48-275 + ava_eval_helper).

    ``update_stats(preds, ori_boxes, metadata)`` takes per-box rows already
    filtered to the valid boxes, ``ori_boxes`` ``(x1, y1, x2, y2)``
    normalized to the original frame; ``finalize_metrics`` runs the frame
    mAP against the configured ground-truth, exclusion and label-map files
    and returns it (also kept as ``full_map``).
    """

    def __init__(self, overall_iters: int, cfg, mode: str):
        from ..evaluation import ava_eval

        self.cfg = cfg
        self.mode = mode
        self.overall_iters = overall_iters
        self.all_preds: list = []
        self.all_ori_boxes: list = []
        self.all_metadata: list = []
        self.full_map = 0.0
        self._eval = ava_eval

        anno_dir = cfg.AVA.ANNOTATION_DIR
        self.excluded_keys = ava_eval.read_exclusions(
            os.path.join(anno_dir, cfg.AVA.EXCLUSION_FILE)
            if cfg.AVA.EXCLUSION_FILE else None)
        self.categories, self.class_whitelist = ava_eval.read_labelmap(
            os.path.join(anno_dir, cfg.AVA.LABEL_MAP_FILE))
        gt_file = os.path.join(anno_dir, cfg.AVA.GROUNDTRUTH_FILE)
        self.full_groundtruth = ava_eval.read_csv(gt_file,
                                                  self.class_whitelist)
        self.video_idx_to_name: list = []

    def reset(self):
        self.all_preds = []
        self.all_ori_boxes = []
        self.all_metadata = []

    def update_stats(self, preds, ori_boxes, metadata):
        self.all_preds.append(np.asarray(preds))
        self.all_ori_boxes.append(np.asarray(ori_boxes))
        self.all_metadata.append(np.asarray(metadata))

    def finalize_metrics(self, log: bool = True) -> float:
        preds = np.concatenate(self.all_preds)
        boxes = np.concatenate(self.all_ori_boxes)
        metadata = np.concatenate(self.all_metadata)
        full_boxes = np.concatenate(
            [np.zeros((len(boxes), 1), np.float32), boxes], axis=1)
        self.full_map = self._eval.evaluate_ava(
            preds, full_boxes, metadata.tolist(),
            self.excluded_keys, self.class_whitelist,
            groundtruth=self.full_groundtruth,
            video_idx_to_name=self.video_idx_to_name)
        if log:
            log_json_stats({"_type": f"{self.mode}_ava_map",
                            "map": self.full_map})
        return self.full_map
