"""One clip's decode time against video length, by backend (port of
``tools/benchmark_decode.py``).

Checks that selective decoding costs O(clip): writes a video of each
``--seconds`` length (128x96 at 30 fps, mp4v, by cv2), warms each backend
once, then times ``--reps`` clips of ``--num_frames`` frames every
``--sampling_rate``, placed as the test loader places its views, and prints
one JSON line a backend: ``{"metric": "clip_decode_ms[BACKEND]", "<S>s":
ms, ..., "long_over_short": ratio}``; a first line lists the backends that
ran and those absent here.

Backends: ``cv2`` (``data/decoder.py:decode``, RGB frames) and, where
``pkg-config`` finds FFmpeg's development files, ``ffmpeg``: the port's
FFmpeg library (``native/``), seeking to the clip and decoding its frames
to the scoring path's square planar I420 (crop and resize included).
decord and PyAV run where they import; neither is installed on the
machines this port is tested on, and they are then listed as absent.

Usage:
    python -m aicity_action_tpu_torch.tools.benchmark_decode \
        [--seconds 60 600] [--reps 5] [--num_frames 16] [--sampling_rate 4]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np

NUM_CLIPS = 5


def write_video(path: str, seconds: int, fps: int = 30, size=(128, 96)):
    import cv2

    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    if not w.isOpened():
        raise RuntimeError(f"cv2 cannot write {path}")
    base = np.random.RandomState(0).randint(0, 255, (size[1], size[0], 3),
                                            np.uint8)
    for i in range(seconds * fps):
        # cheap deterministic motion, so that frames compress as video
        w.write(np.roll(base, i, axis=1))
    w.release()


def ffmpeg_clip(path: str, sampling_rate: int, num_frames: int,
                clip_idx: int, num_clips: int = NUM_CLIPS,
                target_fps: float = 30.0) -> np.ndarray:
    """One clip through the port's FFmpeg library: the clip placed as
    :func:`~aicity_action_tpu_torch.data.decoder.decode` places it, one
    seek to its first frame, then its frames decoded in order, the sampled
    ones kept as square I420 ``[T, s*3//2, s]`` (s the shorter side,
    rounded down to even)."""
    from .. import native
    from ..data.decoder import (clip_size_in_frames, get_start_end_idx,
                                sample_indices)

    meta = native.video_meta(path)
    if meta is None:
        raise RuntimeError(f"FFmpeg cannot open {path}")
    clip = clip_size_in_frames(sampling_rate, num_frames, meta.fps or 30.0,
                               target_fps)
    s, e = get_start_end_idx(meta.frames, clip, clip_idx, num_clips)
    idx = sample_indices(s, e, num_frames, meta.frames)
    size = min(meta.width, meta.height) // 2 * 2
    out = np.empty((num_frames, size * 3 // 2, size), np.uint8)
    row = np.empty((size * 3 // 2, size), np.uint8)
    with native.VideoDecoderI420(path, size) as dec:
        first = int(idx[0])
        if first and not dec.seek(first):
            dec.skip(first)
        frame, k = first, 0
        while k < num_frames and dec.read(row):
            while k < num_frames and idx[k] == frame:
                out[k] = row
                k += 1
            frame += 1
    if k < num_frames:
        out[k:] = out[k - 1] if k else 0
    return out


def backends() -> tuple[list[str], list[str]]:
    """``(present, absent)`` backend names on this machine."""
    from .. import native

    present, absent = ["cv2"], []
    (present if native.ffmpeg_available() else absent).append("ffmpeg")
    for name, module in (("decord", "decord"), ("pyav", "av")):
        found = importlib.util.find_spec(module) is not None
        (present if found else absent).append(name)
    return present, absent


def decode_clip(backend: str, path: str, sampling_rate: int,
                num_frames: int, clip_idx: int) -> np.ndarray:
    if backend == "ffmpeg":
        return ffmpeg_clip(path, sampling_rate, num_frames, clip_idx)
    from ..data import decoder

    return decoder.decode(path, sampling_rate, num_frames,
                          clip_idx=clip_idx, num_clips=NUM_CLIPS,
                          backend=backend)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=int, nargs="+", default=[60, 600])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--num_frames", type=int, default=16)
    ap.add_argument("--sampling_rate", type=int, default=4)
    args = ap.parse_args(argv)

    present, absent = backends()
    print(json.dumps({"metric": "clip_decode_backends", "present": present,
                      "absent": absent}), flush=True)
    results: dict = {}
    with tempfile.TemporaryDirectory() as d:
        for sec in args.seconds:
            path = os.path.join(d, f"v{sec}.mp4")
            t0 = time.perf_counter()
            write_video(path, sec)
            print(f"# wrote {sec}s video in {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr)
            for backend in present:
                decode_clip(backend, path, args.sampling_rate,
                            args.num_frames, 0)  # warm
                t0 = time.perf_counter()
                for rep in range(args.reps):
                    frames = decode_clip(backend, path, args.sampling_rate,
                                         args.num_frames, rep % NUM_CLIPS)
                    if frames.shape[0] != args.num_frames:
                        raise RuntimeError(
                            f"{backend}: {frames.shape[0]} frames, asked "
                            f"for {args.num_frames}")
                dt = (time.perf_counter() - t0) / args.reps
                results.setdefault(backend, {})[f"{sec}s"] = round(dt * 1e3,
                                                                   1)
    for backend, per_len in results.items():
        times = list(per_len.values())
        print(json.dumps({
            "metric": f"clip_decode_ms[{backend}]", **per_len,
            "long_over_short": round(max(times) / max(min(times), 1e-9), 2),
        }), flush=True)
    return results


if __name__ == "__main__":
    main()
