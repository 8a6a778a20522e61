"""AVA frame-level mAP evaluation (port of
``aicity_action_tpu/evaluation/ava_eval.py``, numpy only).

Compact numpy re-implementation of the reference's vendored TF
object-detection evaluator (`slowfast/utils/ava_evaluation/` ~3.3k LoC +
`ava_eval_helper.py`): per-class PASCAL-VOC average precision at IoU 0.5
over keyframe detections, with AVA csv parsing, timestamp exclusions, and
pbtxt label maps.

Semantics matched to the TF implementation:
- greedy score-ordered matching; each groundtruth box matches at most one
  detection; duplicates are false positives
- AP = Σ (r_i − r_{i−1}) · p̃_i with precision made monotonically
  non-increasing from the right (``metrics.py:compute_average_precision``)
- boxes are (y1, x1, y2, x2) in [0, 1] as in the AVA csvs.
"""

from __future__ import annotations

import csv
from collections import defaultdict
from typing import Iterable, Optional

import numpy as np


def make_image_key(video_id: str, timestamp) -> str:
    return f"{video_id},{int(timestamp):04d}"


def read_csv(csv_file: str, class_whitelist=None, load_score: bool = False):
    """AVA csv → (boxes, labels, scores) keyed by image key
    (reference: ava_eval_helper.py:54-89)."""
    boxes = defaultdict(list)
    labels = defaultdict(list)
    scores = defaultdict(list)
    with open(csv_file) as f:
        for row in csv.reader(f):
            assert len(row) in (7, 8), f"Wrong number of columns: {row}"
            image_key = make_image_key(row[0], row[1])
            x1, y1, x2, y2 = (float(v) for v in row[2:6])
            action_id = int(row[6])
            if class_whitelist and action_id not in class_whitelist:
                continue
            score = float(row[7]) if load_score and len(row) == 8 else 1.0
            boxes[image_key].append([y1, x1, y2, x2])
            labels[image_key].append(action_id)
            scores[image_key].append(score)
    return boxes, labels, scores


def read_exclusions(exclusions_file: Optional[str]) -> set:
    excluded = set()
    if exclusions_file:
        with open(exclusions_file) as f:
            for row in csv.reader(f):
                assert len(row) == 2, f"Expected only 2 columns, got: {row}"
                excluded.add(make_image_key(row[0], row[1]))
    return excluded


def read_labelmap(labelmap_file: str):
    """Parse a pbtxt label map → (list of {id, name}, set of ids)."""
    labelmap = []
    class_ids = set()
    name = ""
    with open(labelmap_file) as f:
        for line in f:
            if line.startswith("  name:"):
                name = line.split('"')[1]
            elif line.startswith("  id:") or line.startswith("  label_id:"):
                class_id = int(line.strip().split(" ")[-1])
                labelmap.append({"id": class_id, "name": name})
                class_ids.add(class_id)
    return labelmap, class_ids


def box_iou_matrix(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """IoU between [N, 4] and [M, 4] boxes in (y1, x1, y2, x2)."""
    if len(boxes1) == 0 or len(boxes2) == 0:
        return np.zeros((len(boxes1), len(boxes2)), np.float32)
    b1 = boxes1[:, None]
    b2 = boxes2[None]
    iy1 = np.maximum(b1[..., 0], b2[..., 0])
    ix1 = np.maximum(b1[..., 1], b2[..., 1])
    iy2 = np.minimum(b1[..., 2], b2[..., 2])
    ix2 = np.minimum(b1[..., 3], b2[..., 3])
    inter = np.clip(iy2 - iy1, 0, None) * np.clip(ix2 - ix1, 0, None)
    a1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    a2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    union = a1[:, None] + a2[None] - inter
    return np.where(union > 0, inter / union, 0.0).astype(np.float32)


def compute_average_precision(precision: np.ndarray,
                              recall: np.ndarray) -> float:
    """TF-OD-style AP (all-points with right-monotone precision)."""
    if precision.size == 0:
        return 0.0
    recall = np.concatenate([[0], recall, [1]])
    precision = np.concatenate([[0], precision, [0]])
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    idx = np.where(recall[1:] != recall[:-1])[0] + 1
    return float(np.sum((recall[idx] - recall[idx - 1]) * precision[idx]))


class PascalDetectionEvaluator:
    """Per-class AP@IoU accumulator over images."""

    def __init__(self, class_ids: Iterable[int], iou_threshold: float = 0.5):
        self.class_ids = sorted(class_ids)
        self.iou = iou_threshold
        # per class: list of (score, is_tp); and total gt count
        self._scores: dict[int, list] = defaultdict(list)
        self._tp: dict[int, list] = defaultdict(list)
        self._num_gt: dict[int, int] = defaultdict(int)

    def add_image(self, gt_boxes, gt_labels, det_boxes, det_labels,
                  det_scores):
        gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
        gt_labels = np.asarray(gt_labels, np.int64)
        det_boxes = np.asarray(det_boxes, np.float32).reshape(-1, 4)
        det_labels = np.asarray(det_labels, np.int64)
        det_scores = np.asarray(det_scores, np.float32)

        for c in self.class_ids:
            g = gt_boxes[gt_labels == c]
            self._num_gt[c] += len(g)
            dmask = det_labels == c
            d = det_boxes[dmask]
            s = det_scores[dmask]
            if len(d) == 0:
                continue
            order = np.argsort(-s)
            d, s = d[order], s[order]
            iou = box_iou_matrix(d, g)
            matched = np.zeros(len(g), bool)
            for i in range(len(d)):
                tp = False
                if len(g):
                    j = int(np.argmax(iou[i]))
                    if iou[i, j] >= self.iou and not matched[j]:
                        matched[j] = True
                        tp = True
                self._scores[c].append(float(s[i]))
                self._tp[c].append(tp)

    def evaluate(self) -> dict:
        """Returns {"PascalBoxes_Precision/mAP@{iou}IOU": float, per-class...}."""
        aps = {}
        for c in self.class_ids:
            if self._num_gt[c] == 0:
                continue
            scores = np.asarray(self._scores[c])
            tps = np.asarray(self._tp[c], bool)
            order = np.argsort(-scores)
            tps = tps[order]
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(~tps)
            recall = tp_cum / self._num_gt[c]
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
            aps[c] = compute_average_precision(precision, recall)
        mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
        out = {f"PascalBoxes_Precision/mAP@{self.iou}IOU": mean_ap}
        for c, ap in aps.items():
            out[f"PascalBoxes_PerformanceByCategory/AP@{self.iou}IOU/{c}"] = ap
        return out


def run_evaluation(
    class_ids,
    gt_boxes, gt_labels,
    det_boxes, det_labels, det_scores,
    excluded_keys=frozenset(),
    iou_threshold: float = 0.5,
) -> dict:
    """Full-set evaluation over keyed dicts (ava_eval_helper.py:180-268)."""
    ev = PascalDetectionEvaluator(class_ids, iou_threshold)
    for key in gt_boxes:
        if key in excluded_keys:
            continue
        ev.add_image(
            gt_boxes[key], gt_labels[key],
            det_boxes.get(key, []), det_labels.get(key, []),
            det_scores.get(key, []),
        )
    # detections on excluded/non-gt keys are ignored (reference behavior)
    return ev.evaluate()


def evaluate_ava(
    preds: np.ndarray,
    original_boxes: np.ndarray,
    metadata: np.ndarray,
    excluded_keys: set,
    class_whitelist: set,
    groundtruth=None,
    video_idx_to_name=None,
) -> float:
    """End-to-end: model outputs → mAP (ava_eval_helper.py:138-178).

    ``preds``: [N, num_classes] sigmoid scores per box;
    ``original_boxes``: [N, 5] (batch_idx?, x1, y1, x2, y2) normalized with
    video idx in col 0; ``metadata``: [N, 2] (video_idx, sec).
    """
    det_boxes = defaultdict(list)
    det_labels = defaultdict(list)
    det_scores = defaultdict(list)
    for i in range(preds.shape[0]):
        vidx = int(metadata[i][0])
        sec = int(metadata[i][1])
        video = video_idx_to_name[vidx] if video_idx_to_name else str(vidx)
        key = make_image_key(video, sec)
        x1, y1, x2, y2 = original_boxes[i][1:5]
        for cls in range(preds.shape[1]):
            if (cls + 1) in class_whitelist:
                det_boxes[key].append([y1, x1, y2, x2])
                det_labels[key].append(cls + 1)
                det_scores[key].append(float(preds[i][cls]))

    gt_boxes, gt_labels, _ = groundtruth
    results = run_evaluation(
        class_whitelist, gt_boxes, gt_labels,
        det_boxes, det_labels, det_scores, excluded_keys,
    )
    return results["PascalBoxes_Precision/mAP@0.5IOU"]
