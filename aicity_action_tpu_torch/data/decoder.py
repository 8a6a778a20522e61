"""Video metadata and window frame sampling (copies of the helpers of
``aicity_action_tpu/data/decoder.py`` that the sliding-window scorer needs,
plus :func:`video_meta`, which reads metadata with the port's FFmpeg
library where it applies). ``cv2`` is imported only where it is used.

The FFmpeg library serves where ``pkg-config`` finds FFmpeg's development
files (:func:`~aicity_action_tpu_torch.native.ffmpeg_available`); where it
does not, or under ``AICITY_VDEC=0`` (its meaning in the JAX package),
metadata and decoding go through cv2.
"""

from __future__ import annotations

import os
from typing import Iterable

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


def probe(path: str):
    """The FFmpeg library's :class:`~aicity_action_tpu_torch.native.
    VideoMeta` of ``path`` where its decoder applies (FFmpeg's development
    files found, ``AICITY_VDEC`` not 0, a yuv420p stream), else None.
    Where the development files are found, a failed build raises."""
    from .. import native

    if os.environ.get("AICITY_VDEC", "1") == "0" or \
            not native.ffmpeg_available():
        return None

    meta = native.video_meta(path)
    return meta if meta is not None and meta.yuv420p else None


def video_meta(path: str) -> tuple[int, float]:
    """``(frame count, fps)`` of ``path`` as ``cv2_video_meta`` gives them:
    from the FFmpeg library where :func:`probe` applies, else from cv2."""
    meta = probe(path)
    if meta is None:
        return cv2_video_meta(path)
    return meta.frames, meta.fps or 30.0


def write_y4m(path: str, frames: Iterable[np.ndarray], fps: int = 30):
    """Planar I420 u8 frames, each ``[h*3//2, w]``, -> a YUV4MPEG2 file of
    ``w x h`` at ``fps`` with 4:2:0 JPEG chroma siting (FFmpeg and cv2
    read it; no encoder needed)."""
    with open(path, "wb") as f:
        for i, frame in enumerate(frames):
            if not i:
                rows, w = frame.shape
                f.write(f"YUV4MPEG2 W{w} H{rows * 2 // 3} F{fps}:1 Ip A1:1 "
                        f"C420jpeg\n".encode())
            f.write(b"FRAME\n")
            f.write(np.ascontiguousarray(frame, np.uint8).tobytes())
