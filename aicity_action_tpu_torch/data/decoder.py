"""Video metadata and window frame sampling (copies of the two helpers of
``aicity_action_tpu/data/decoder.py`` that the sliding-window scorer needs;
``cv2`` is imported only where a video is opened)."""

from __future__ import annotations

import numpy as np


def sample_indices(
    start_idx: float, end_idx: float, num_samples: int, video_len: int
) -> np.ndarray:
    index = np.linspace(start_idx, end_idx, num_samples)
    return np.clip(index, 0, video_len - 1).astype(np.int64)


def cv2_video_meta(path: str) -> tuple[int, float]:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"cv2 failed to open {path}")
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    cap.release()
    return n, fps
