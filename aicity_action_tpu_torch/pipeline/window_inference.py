"""Sliding-window temporal inference on the card (port of the device-gather
path of ``aicity_action_tpu/pipeline/window_inference.py``).

- :class:`WindowDataset` enumerates windows of ``frame_length x
  frame_stride`` source frames every ``proposal_stride`` frames, with the
  fps renormalization of the reference (module_wrapper.py:213-232), and
  decodes the video ONCE with cv2 into planar I420 u8 chunks.
- :class:`WindowScorer` uploads each chunk once, keeps the previous chunk's
  tail on the card, gathers every window's frames there by index, converts
  I420 to RGB, normalizes, and scores batches of windows with the model.
  :meth:`WindowScorer.score_chunks` takes any iterator of chunks plus the
  window plans, so a caller can drive it without a video file.

Output per video: the sorted list of ``(t0, t1, scores[num_class])`` that
the JAX package and the reference pickle (run_action_...py:110-130).
"""

from __future__ import annotations

import os
import pickle
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..data.decoder import cv2_video_meta, sample_indices


def window_spans(num_frames: int, fps: float, frame_length: int,
                 frame_stride: int, proposal_stride: int,
                 target_fps: float) -> list[tuple[int, int]]:
    """``(t0, t1)`` of every window; length and stride are rescaled when the
    video is not within 2 fps of ``target_fps``."""
    proposal_length = frame_length * frame_stride
    if abs(fps - target_fps) > 2.0:
        rate = fps / target_fps
        proposal_length = int(rate * proposal_length)
        proposal_stride = int(rate * proposal_stride)
    return [(t0, t0 + proposal_length)
            for t0 in range(0, num_frames, proposal_stride)]


def window_plans(spans: Sequence[tuple[int, int]], frame_length: int,
                 num_frames: int) -> list[tuple[int, int, np.ndarray]]:
    """``(t0, t1, sampled frame indices)`` of each window."""
    return [(t0, t1, sample_indices(t0, t1, frame_length, num_frames))
            for t0, t1 in spans]


class WindowDataset:
    """One video's sliding windows and its sequential I420 chunk decode."""

    def __init__(
        self,
        video_path: str,
        *,
        frame_length: int = 16,
        frame_stride: int = 4,
        proposal_stride: int = 16,
        frame_size: int = 448,
        target_fps: float = 30.0,
        roi: tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0),
        mean: Sequence[float] = (0.45, 0.45, 0.45),
        std: Sequence[float] = (0.225, 0.225, 0.225),
    ):
        self.video_path = video_path
        self.frame_length = frame_length
        self.frame_size = frame_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.num_frames, self.fps = cv2_video_meta(video_path)
        self.windows = window_spans(self.num_frames, self.fps, frame_length,
                                    frame_stride, proposal_stride, target_fps)
        self.roi = roi
        self._roi_px: Optional[tuple[int, int, int, int]] = None

    def __len__(self):
        return len(self.windows)

    def plans(self) -> list[tuple[int, int, np.ndarray]]:
        return window_plans(self.windows, self.frame_length, self.num_frames)

    def _resolve_roi_px(self, frame) -> tuple[int, int, int, int]:
        """The relative ROI in source pixels, fixed by the first frame."""
        if self._roi_px is None:
            h, w = frame.shape[:2]
            x1, y1, x2, y2 = self.roi
            self._roi_px = (int(w * x1), int(h * y1),
                            int(w * x2), int(h * y2))
        return self._roi_px

    def stream_chunks(self, chunk_frames: int) -> Iterator[np.ndarray]:
        """Sequential cv2 decode -> ROI crop -> resize -> planar I420, into
        ``[chunk_frames, s*3//2, s]`` u8 slabs; each source frame is decoded
        and resized once. Infinite: the EOF partial chunk is padded with its
        own last frame, then repeat-last chunks follow forever."""
        import cv2

        s = self.frame_size
        if s % 2:
            raise ValueError("I420 packing needs an even frame size")
        slab = np.empty((chunk_frames, s * 3 // 2, s), np.uint8)
        tmp = np.empty((s, s, 3), np.uint8)
        cap = cv2.VideoCapture(self.video_path)

        def read_row(row) -> bool:
            ok, frame = cap.read()
            if not ok:
                return False
            x1, y1, x2, y2 = self._resolve_roi_px(frame)
            cv2.resize(frame[y1:y2, x1:x2], (s, s), dst=tmp,
                       interpolation=cv2.INTER_LINEAR)
            cv2.cvtColor(tmp, cv2.COLOR_BGR2YUV_I420, dst=row)
            return True

        try:
            yield from _emit_chunks(slab, read_row)
        finally:
            cap.release()


def _emit_chunks(slab: np.ndarray, read_row) -> Iterator[np.ndarray]:
    """Drive ``read_row(slab_row) -> bool`` into full chunks: yields each
    filled slab, pads the EOF partial with its own last frame, then yields
    repeat-last padding chunks forever. The consumer owns every slab."""
    F = slab.shape[0]
    fill = 0
    last = None
    while read_row(slab[fill]):
        last = slab[fill]
        fill += 1
        if fill == F:
            out, slab, fill = slab, np.empty_like(slab), 0
            last = out[-1].copy()
            yield out
    if fill and last is not None:
        slab[fill:] = last
        last = slab[-1].copy()
        yield slab
    while True:
        pad = np.empty_like(slab)
        pad[:] = last if last is not None else 0
        yield pad


def i420_to_rgb(yuv: torch.Tensor, s: int) -> torch.Tensor:
    """Planar I420 u8 ``[..., s*3//2, s]`` -> RGB f32 ``[..., s, s, 3]`` in
    [0, 255]: the limited-range BT.601 inverse with nearest chroma
    upsampling of the JAX package (within 1/255 of cv2's
    ``COLOR_YUV2RGB_I420``)."""
    lead = yuv.shape[:-2]
    h4 = s // 4
    y = yuv[..., :s, :].float() - 16.0
    u = yuv[..., s:s + h4, :].reshape(*lead, s // 2, s // 2).float() - 128.0
    v = yuv[..., s + h4:, :].reshape(*lead, s // 2, s // 2).float() - 128.0
    u = u.repeat_interleave(2, -2).repeat_interleave(2, -1)
    v = v.repeat_interleave(2, -2).repeat_interleave(2, -1)
    rgb = torch.stack([
        1.1644 * y + 1.5960 * v,
        1.1644 * y - 0.3918 * u - 0.8130 * v,
        1.1644 * y + 2.0172 * u,
    ], -1)
    return rgb.clamp(0.0, 255.0)


class WindowScorer:
    """Scores sliding windows with ``model`` on the card that holds it.

    Each I420 chunk crosses to the card once; a window is gathered there
    from the previous chunk's tail and the current chunk, and windows are
    scored ``batch_size`` at a time. Results stay on the card until the
    video ends, so host decode overlaps device compute.
    """

    def __init__(self, model: torch.nn.Module, batch_size: int = 8,
                 chunk_frames: int = 512):
        self.model = model
        self.device = next(model.parameters()).device
        self.batch_size = batch_size
        self.chunk_frames = chunk_frames

    def score_video(self, dataset: WindowDataset) -> list:
        """Sorted ``[(t0, t1, scores)]`` for every window of ``dataset``."""
        return self.score_chunks(
            dataset.stream_chunks(self.chunk_frames), dataset.plans(),
            dataset.frame_size, dataset.mean, dataset.std)

    @torch.no_grad()
    def score_chunks(self, chunks: Iterator[np.ndarray],
                     plans: Sequence[tuple[int, int, np.ndarray]], s: int,
                     mean: Sequence[float], std: Sequence[float]) -> list:
        """Score ``plans`` (``(t0, t1, frame indices)``, indices ascending
        within a window) over ``chunks``, an iterator of consecutive
        ``[chunk_frames, s*3//2, s]`` u8 I420 slabs that covers every
        indexed frame. Returns the sorted ``[(t0, t1, scores f32)]``."""
        if not plans:
            return []
        F = self.chunk_frames
        span = max(int(p[2][-1]) - int(p[2][0]) for p in plans) + 1
        if span > F:
            raise ValueError(f"a window spans {span} frames, more than a "
                             f"chunk of {F}")
        # a window is scored with the chunk that holds its last frame; its
        # first frame then lies in that chunk or the previous one's tail
        by_chunk: dict[int, list[int]] = {}
        for w, (_, _, idxs) in enumerate(plans):
            by_chunk.setdefault(int(idxs[-1]) // F, []).append(w)
        dev = self.device
        mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=dev)
        std_t = torch.as_tensor(np.asarray(std, np.float32), device=dev)
        prev = torch.zeros((F, s * 3 // 2, s), dtype=torch.uint8, device=dev)
        pending = []  # (scores on the card, [(t0, t1)])
        for c in range(max(by_chunk) + 1):
            host = torch.from_numpy(next(chunks))
            if dev.type == "cuda":
                host = host.pin_memory()
            cur = host.to(dev, non_blocking=True)
            buf = torch.cat([prev[F - span:], cur])  # rows c*F - span ...
            ws = by_chunk.get(c, [])
            for i in range(0, len(ws), self.batch_size):
                grp = ws[i:i + self.batch_size]
                idx = np.stack([plans[w][2] for w in grp]) - c * F + span
                yuv = buf[torch.as_tensor(idx, device=dev)]
                x = (i420_to_rgb(yuv, s) / 255.0 - mean_t) / std_t
                pending.append((self.model(x).float(),
                                [(plans[w][0], plans[w][1]) for w in grp]))
            prev = cur
        scores = torch.cat([o for o, _ in pending]).cpu().numpy()
        spans = [sp for _, grp in pending for sp in grp]
        preds = [(t0, t1, scores[i]) for i, (t0, t1) in enumerate(spans)]
        preds.sort(key=lambda p: p[0])
        return preds


def save_window_predictions(preds: list, path: str) -> None:
    # atomic: an interrupted run never leaves a truncated pickle that a
    # resuming caller would skip as "done"
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(preds, f)
    os.replace(tmp, path)


def load_window_predictions(path: str) -> list:
    with open(path, "rb") as f:
        return pickle.load(f)
