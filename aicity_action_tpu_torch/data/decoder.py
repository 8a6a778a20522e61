"""Video decoding and temporal clip sampling (port of
``aicity_action_tpu/data/decoder.py``), plus :func:`video_meta`, which reads
metadata with the port's FFmpeg library where it applies, and
:func:`write_y4m`.

- The sampling math (:func:`temporal_sampling`, :func:`get_start_end_idx`,
  :func:`clip_size_in_frames`) is the JAX package's: linspace + clamp,
  clip placement renormalized to ``TARGET_FPS``, draws from the caller's
  ``random.Random`` in the same order.
- :func:`decode` dispatches as the JAX package does: decord or PyAV where
  ``DATA.DECODING_BACKEND`` names one and it imports, else cv2. ``cv2``,
  ``decord`` and ``av`` are imported only where they are used.

The FFmpeg library serves :func:`video_meta` where ``pkg-config`` finds
FFmpeg's development files (:func:`~aicity_action_tpu_torch.native.
ffmpeg_available`); where it does not, or under ``AICITY_VDEC=0`` (its
meaning in the JAX package), metadata and decoding go through cv2. All
decoders return uint8 RGB frames ``[T, H, W, 3]``.
"""

from __future__ import annotations

import importlib
import math
import os
import random
from typing import Iterable, Optional

import numpy as np


def _optional(name: str):
    """The module ``name`` where it imports, else None."""
    try:
        return importlib.import_module(name)
    except ImportError:
        return None


def temporal_sampling(
    frames: np.ndarray, start_idx: float, end_idx: float, num_samples: int
) -> np.ndarray:
    """``num_samples`` frames at uniform indices in [start, end], clamped
    (reference: decoder.py:10-31)."""
    index = sample_indices(start_idx, end_idx, num_samples, frames.shape[0])
    return frames[index]


def sample_indices(
    start_idx: float, end_idx: float, num_samples: int, video_len: int
) -> np.ndarray:
    index = np.linspace(start_idx, end_idx, num_samples)
    return np.clip(index, 0, video_len - 1).astype(np.int64)


def get_start_end_idx(
    video_size: int,
    clip_size: float,
    clip_idx: int,
    num_clips: int,
    use_offset: bool = False,
    rng: Optional[random.Random] = None,
) -> tuple[float, float]:
    """Clip placement: random (``clip_idx == -1``) or the ``clip_idx``-th
    of ``num_clips`` uniform positions (reference: decoder.py:34-73)."""
    delta = max(video_size - clip_size, 0)
    if clip_idx == -1:
        start_idx = (rng.uniform(0, delta) if rng is not None
                     else random.uniform(0, delta))
    elif use_offset:
        if num_clips == 1:
            start_idx = math.floor(delta / 2)
        else:
            start_idx = clip_idx * math.floor(delta / (num_clips - 1))
    else:
        start_idx = delta * clip_idx / num_clips
    end_idx = start_idx + clip_size - 1
    return start_idx, end_idx


def clip_size_in_frames(
    sampling_rate: int, num_frames: int, fps: float, target_fps: float
) -> float:
    """Length of the clip in source frames, renormalized to the target fps
    (reference: decoder.py:476)."""
    return sampling_rate * num_frames / target_fps * fps


def pyav_decode_stream(container, start_pts, end_pts, stream,
                       buffer_size: int = 0):
    """PyAV frames with pts in ``[start_pts, end_pts]``, seeking a
    1024-pts margin before the window start (reference:
    decoder.py:75-114)."""
    margin = 1024
    seek_offset = max(start_pts - margin, 0)
    container.seek(seek_offset, any_frame=False, backward=True, stream=stream)
    frames = {}
    buffer_count = 0
    max_pts = 0
    for frame in container.decode(stream):
        max_pts = max(max_pts, frame.pts)
        if frame.pts < start_pts:
            continue
        if frame.pts <= end_pts:
            frames[frame.pts] = frame
        else:
            buffer_count += 1
            frames[frame.pts] = frame
            if buffer_count >= buffer_size:
                break
    return [frames[p] for p in sorted(frames)], max_pts


def pyav_decode(
    container,
    sampling_rate: int,
    num_frames: int,
    clip_idx: int,
    num_clips: int = 10,
    target_fps: float = 30.0,
    use_offset: bool = False,
    rng: Optional[random.Random] = None,
) -> tuple[np.ndarray, float, bool]:
    """Selective-seek PyAV decode (reference: decoder.py:253-326): only
    the clip window where the stream header has a duration and a frame
    count, else the whole video. Returns ``(frames [T, H, W, 3] uint8, fps,
    decode_all_video)``."""
    stream = container.streams.video[0]
    fps = float(stream.average_rate or 30.0)
    frames_length = stream.frames
    duration = stream.duration

    if duration is None or not frames_length:
        decode_all_video = True
        start_pts, end_pts = 0, math.inf
    else:
        decode_all_video = False
        s, e = get_start_end_idx(
            frames_length,
            clip_size_in_frames(sampling_rate, num_frames, fps, target_fps),
            clip_idx, num_clips, use_offset, rng,
        )
        timebase = duration / frames_length
        start_pts = int(s * timebase)
        end_pts = int(e * timebase)

    video_frames, _ = pyav_decode_stream(container, start_pts, end_pts,
                                         stream)
    frames = np.stack([f.to_rgb().to_ndarray() for f in video_frames])
    return frames, fps, decode_all_video


def _cv2_decode_all(path: str) -> tuple[np.ndarray, float]:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"cv2 failed to open {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise RuntimeError(f"cv2 decoded 0 frames from {path}")
    return np.stack(frames), fps


def _cv2_decode_indices(path: str, indices: np.ndarray) -> np.ndarray:
    """Frames at ``indices`` by one forward pass from the first (a seek
    where cv2 lands on it exactly, else from frame 0); an index past the
    decoded frames takes the nearest decoded one."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"cv2 failed to open {path}")
    want = np.asarray(indices)
    out: dict[int, np.ndarray] = {}
    need = set(int(i) for i in want)
    last = max(need)
    first = min(need)
    i = 0
    if first > 0:
        cap.set(cv2.CAP_PROP_POS_FRAMES, first)
        if int(cap.get(cv2.CAP_PROP_POS_FRAMES)) == first:
            i = first
        else:  # unreliable seek on this codec: rewind and scan
            cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
    while i <= last:
        if not cap.grab():
            break
        if i in need:
            ok, frame = cap.retrieve()
            if not ok:
                break
            out[i] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        i += 1
    cap.release()
    if not out:
        raise RuntimeError(f"cv2 decoded 0 frames from {path}")
    got = sorted(out)

    def nearest(i):
        i = int(i)
        if i in out:
            return out[i]
        return out[min(got, key=lambda k: abs(k - i))]

    return np.stack([nearest(i) for i in want])


def cv2_video_meta(path: str) -> tuple[int, float]:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"cv2 failed to open {path}")
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    cap.release()
    return n, fps


def decode(
    path: str,
    sampling_rate: int,
    num_frames: int,
    clip_idx: int = -1,
    num_clips: int = 10,
    target_fps: float = 30.0,
    backend: str = "cv2",
    use_offset: bool = False,
    rng: Optional[random.Random] = None,
) -> np.ndarray:
    """One clip of ``path`` as uint8 RGB ``[T, H, W, 3]``: the clip placed
    in fps-renormalized frame space, then its sampled indices fetched
    (reference: decoder.py:391-486)."""
    decord = _optional("decord") if backend == "decord" else None
    if decord is not None:
        vr = decord.VideoReader(path, num_threads=1)
        fps = float(vr.get_avg_fps() or 30.0)
        video_size = len(vr)
        clip_sz = clip_size_in_frames(sampling_rate, num_frames, fps,
                                      target_fps)
        s, e = get_start_end_idx(video_size, clip_sz, clip_idx, num_clips,
                                 use_offset, rng)
        idx = sample_indices(s, e, num_frames, video_size)
        return vr.get_batch(idx).asnumpy()
    av = _optional("av") if backend == "pyav" else None
    if av is not None:
        with av.open(path) as container:
            frames, fps, decode_all = pyav_decode(
                container, sampling_rate, num_frames, clip_idx, num_clips,
                target_fps, use_offset, rng)
        clip_sz = clip_size_in_frames(sampling_rate, num_frames, fps,
                                      target_fps)
        # after a selective decode the window is the clip
        # (reference decoder.py:466-472)
        s, e = get_start_end_idx(
            frames.shape[0], clip_sz,
            clip_idx if decode_all else 0,
            num_clips if decode_all else 1,
            use_offset, rng)
        return temporal_sampling(frames, s, e, num_frames)
    video_size, fps = cv2_video_meta(path)
    clip_sz = clip_size_in_frames(sampling_rate, num_frames, fps, target_fps)
    if video_size <= 0:
        frames, fps = _cv2_decode_all(path)
        video_size = frames.shape[0]
        s, e = get_start_end_idx(video_size, clip_sz, clip_idx, num_clips,
                                 use_offset, rng)
        return temporal_sampling(frames, s, e, num_frames)
    s, e = get_start_end_idx(video_size, clip_sz, clip_idx, num_clips,
                             use_offset, rng)
    idx = sample_indices(s, e, num_frames, video_size)
    return _cv2_decode_indices(path, idx)


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
