"""Temporal-localization post-processing (pure numpy; a copy of
``aicity_action_tpu/pipeline/postprocess.py``).

Faithful re-implementations of the challenge pipeline math:
- :func:`aggregate_predictions` — per-frame score fusion over overlapping
  windows (reference: scripts/aicity_inf_graph.py:313-351)
- :func:`get_chunks` — threshold → contiguous runs
  (aicity_inf_graph.py:288-309)
- :func:`derive_thresholds` — mean GT-segment score per class with
  min/max/mean reduction (aicity_inf_graph.py:46-168)
- :func:`compute_f1` — ±1 s boundary-match F1 (aicity_inf_graph.py:221-286)
- :func:`chunks_to_submission` — per-video top-1 chunk, cross-view top-1,
  ±1 s boundary tightening (scripts/aicity_inf.py:36-133)
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Sequence

import numpy as np

VIDEO_FPS = 30.0


def aggregate_predictions(
    pred_list: Sequence[tuple[int, int, np.ndarray]],
    aggregate_func: Callable = np.mean,
    num_class: int = 18,
) -> np.ndarray:
    """Fuse window scores into per-frame scores ``[num_frame, num_class]``.

    ``pred_list``: list of ``(t0, t1, scores[num_class])`` windows; each
    window contributes its score to frames ``[t0, t1)``; frames covered by
    no window score zero (the reference keeps the zero initializer then).
    """
    frame_idxs = [t[0] for t in pred_list] + [t[1] for t in pred_list]
    min_f, max_f = min(frame_idxs), max(frame_idxs)
    num_frame = max_f - min_f

    t0s = np.asarray([t[0] for t in pred_list], np.int64) - min_f
    t1s = np.asarray([t[1] for t in pred_list], np.int64) - min_f
    scores = np.stack(
        [np.asarray(t[2], np.float32) for t in pred_list]
    ).astype(np.float64)
    assert scores.shape[-1] == num_class

    # Segment decomposition: the active-window set only changes at window
    # boundaries, so compute per *segment* (between consecutive boundaries)
    # and expand to frames with one np.repeat — O(W log W + F) instead of
    # the reference's O(F x W) Python loop (aicity_inf_graph.py:313-351).
    ev_f = np.concatenate([t0s, t1s])
    order = np.argsort(ev_f, kind="stable")
    ev_f = ev_f[order]
    uniq, first_idx = np.unique(ev_f, return_index=True)
    last_idx = np.searchsorted(ev_f, uniq, side="right") - 1
    seg_lens = np.diff(np.append(uniq, num_frame))

    n_w = len(t0s)
    ev_cnt = np.concatenate([np.ones(n_w), -np.ones(n_w)])[order]
    seg_cnt = np.rint(np.cumsum(ev_cnt))[last_idx]

    if aggregate_func is np.mean:
        ev_s = np.concatenate([scores, -scores])[order]
        seg_sum = np.cumsum(ev_s, axis=0)[last_idx]
        # uncovered segments keep the zero initializer (reference semantics)
        seg_out = np.where(
            seg_cnt[:, None] > 0,
            seg_sum / np.maximum(seg_cnt, 1.0)[:, None],
            0.0,
        )
        return np.repeat(seg_out.astype(np.float32), seg_lens, axis=0)

    if aggregate_func in (np.max, np.amax, np.maximum):
        # One vectorized slice-max per window over the segment array; the
        # zero seed is dropped once covered, so track coverage via seg_cnt.
        seg_t0 = np.searchsorted(uniq, t0s)
        seg_t1 = np.searchsorted(uniq, t1s)
        run = np.full((len(uniq), num_class), -np.inf, np.float64)
        for a, b, s in zip(seg_t0, seg_t1, scores):
            np.maximum(run[a:b], s, out=run[a:b])
        seg_out = np.where(seg_cnt[:, None] > 0, run, 0.0)
        return np.repeat(seg_out.astype(np.float32), seg_lens, axis=0)

    # Generic aggregate: the reference's per-frame path, kept as fallback.
    per_frame: list[list[np.ndarray]] = [
        [np.zeros(num_class, np.float32)] for _ in range(num_frame)
    ]
    for t0, t1, s in zip(t0s, t1s, scores.astype(np.float32)):
        for t in range(t0, t1):
            per_frame[t].append(s)

    out = np.zeros((num_frame, num_class), np.float32)
    for i, lst in enumerate(per_frame):
        if len(lst) > 1:
            lst = lst[1:]  # drop the zero seed once covered
        out[i] = aggregate_func(np.vstack(lst), axis=0)
    return out


def get_chunks(
    score_list: np.ndarray, threshold: float
) -> list[tuple[int, int, int, float, np.ndarray]]:
    """Contiguous runs of ``score >= threshold``.

    Returns ``(start, end, length, mean_score, scores)`` per run. End-index
    semantics match the reference exactly (inclusive of the closing frame;
    a run reaching the final frame closes there).
    """
    chunks = []
    start = None
    n = len(score_list)
    for fidx in range(n):
        if score_list[fidx] >= threshold:
            if start is None:
                start = fidx
            elif fidx == n - 1:
                chunks.append(
                    (start, fidx, fidx - start + 1,
                     float(np.mean(score_list[start:fidx + 1])),
                     score_list[start:fidx + 1])
                )
                start = None
        else:
            if start is not None:
                chunks.append(
                    (start, fidx, fidx - start + 1,
                     float(np.mean(score_list[start:fidx + 1])),
                     score_list[start:fidx + 1])
                )
                start = None
    return chunks


def chunks_for_video(
    per_frame_scores: np.ndarray,
    thresholds: dict[int, float],
    *,
    use_num_chunk: int = 1,
    sort_base: str = "length",
    video_fps: float = VIDEO_FPS,
) -> dict[int, list[tuple[float, float, int, float]]]:
    """Per-class top chunks of one view, converted to seconds
    (aicity_inf.py:66-103 + compute_f1 preparation)."""
    out: dict[int, list] = defaultdict(list)
    for action_id, thres in thresholds.items():
        chunks = get_chunks(per_frame_scores[:, action_id], thres)
        if not chunks:
            continue
        key = 2 if sort_base == "length" else 3
        chunks.sort(key=lambda x: x[key], reverse=True)
        for start, end, length, mean_score, _ in chunks[:use_num_chunk]:
            out[action_id].append(
                (start / video_fps, end / video_fps, length, mean_score)
            )
    return out


def merge_views_to_submission(
    video_views: dict[str, list[str]],
    view_chunks: dict[str, dict[int, list]],
    thresholds: dict[int, float],
    *,
    use_num_chunk: int = 1,
    sort_base: str = "length",
) -> list[tuple[str, int, float, float]]:
    """Cross-view merge + boundary tightening → submission rows
    (aicity_inf.py:106-129): per (video_id, class), pool chunks from all
    views, keep the top ``use_num_chunk`` by length (or score), tighten
    boundaries by round(start)+1 / round(end)-1."""
    outputs = []
    for vid, views in video_views.items():
        for action_id in thresholds:
            pooled = [
                c
                for view in views
                for c in view_chunks.get(view, {}).get(action_id, [])
            ]
            if not pooled:
                continue
            key = 2 if sort_base == "length" else 3
            pooled.sort(key=lambda x: x[key], reverse=True)
            for start_s, end_s, _, _ in pooled[:use_num_chunk]:
                outputs.append(
                    (vid, action_id, round(start_s) + 1.0, round(end_s) - 1.0)
                )
    return outputs


def write_submission(rows, path: str) -> None:
    with open(path, "w") as f:
        for vid, action_id, start, end in rows:
            f.write(f"{vid} {action_id} {start:.6f} {end:.6f}\n")


def derive_thresholds(
    anno_data: dict[str, list[tuple]],
    per_frame_scores: dict[str, np.ndarray],
    classes: Sequence[int],
    *,
    thres_take: str = "mean",
    video_fps: float = VIDEO_FPS,
) -> dict[int, float]:
    """Per-class thresholds from mean GT-segment scores.

    ``anno_data``: vid → list of (file_id, user_id, t0_sec, t1_sec, class).
    Matches the reference including its seeded 0.0 entry per (vid, class)
    under the mean reduction (aicity_inf_graph.py:104 "bug for mean" kept
    for parity).
    """
    acc: dict[int, list[float]] = defaultdict(list)
    for vid, annos in anno_data.items():
        for action_id in classes:
            anno = [o for o in annos if o[-1] == action_id]
            score_thres = [0.0]
            for file_id, _, t0, t1, _ in anno[:3]:
                if file_id not in per_frame_scores:
                    continue
                scores = per_frame_scores[file_id][:, action_id]
                f0, f1 = int(t0 * video_fps), int(t1 * video_fps)
                gt = scores[f0:min(len(scores), f1)]
                if len(gt):
                    score_thres.append(float(np.mean(gt)))
            acc[action_id] += score_thres

    out = {}
    for action_id, scores in acc.items():
        if thres_take == "min":
            out[action_id] = float(min(scores))
        elif thres_take == "max":
            out[action_id] = float(max(scores))
        else:
            out[action_id] = float(np.mean(scores))
    return out


def compute_f1(
    anno_data: dict[str, list[tuple]],
    classes: Sequence[int],
    action_chunks: dict[str, dict[int, list]],
    *,
    use_num_chunk: int = 1,
    sec_thres: float = 1.0,
    chunk_sort_base: str = "length",
    return_pr: bool = False,
    use_tight_times: bool = False,
    use_ori_times: bool = False,
):
    """±sec_thres boundary-match F1 (TP iff BOTH boundaries within ±1 s).

    ``action_chunks``: file_id → {class → [(t0_s, t1_s, len, score)]}.
    """
    TP = FP = FN = 0
    for vid, annos in anno_data.items():
        for action_id in classes:
            anno = [o for o in annos if o[-1] == action_id]
            if len(anno) != 3:
                continue
            pooled = [
                c
                for o in anno
                for c in action_chunks.get(o[0], {}).get(action_id, [])
            ]
            if not pooled:
                FN += 1
                continue
            key = 2 if chunk_sort_base == "length" else 3
            pooled.sort(key=lambda x: x[key], reverse=True)
            pooled = pooled[:use_num_chunk]

            match_gt = 0
            for chunk in pooled:
                if use_ori_times:
                    ps, pe = chunk[0], chunk[1]
                elif use_tight_times:
                    ps, pe = round(chunk[0]) + 1.0, round(chunk[1]) - 1.0
                else:
                    ps, pe = round(chunk[0]), round(chunk[1])
                gs, ge = anno[0][2], anno[0][3]
                if (gs - sec_thres <= ps <= gs + sec_thres) and (
                    ge - sec_thres <= pe <= ge + sec_thres
                ):
                    if match_gt == 1:
                        FP += 1
                    else:
                        TP += 1
                        match_gt = 1
                else:
                    FP += 1
            if not match_gt:
                FN += 1

    f1 = TP / (TP + 0.5 * (FP + FN)) if (TP + FP + FN) else 0.0
    if return_pr:
        precision = TP / (TP + FP) if (TP + FP) else 0.0
        recall = TP / (TP + FN) if (TP + FN) else 0.0
        return f1, precision, recall
    return f1
