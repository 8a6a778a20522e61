"""Sliding-window temporal inference on the card (port of
``aicity_action_tpu/pipeline/window_inference.py``).

- :class:`WindowDataset` enumerates windows of ``frame_length x
  frame_stride`` source frames every ``proposal_stride`` frames, with the
  fps renormalization of the reference (module_wrapper.py:213-232), and
  decodes the video: ONCE into u8 chunks (planar I420, or BGR for the
  exact-RGB path), by one generator or by seeking decoder threads that give
  the same bytes; or window by window. I420 chunks come from the port's
  FFmpeg library (:class:`~aicity_action_tpu_torch.native.
  VideoDecoderI420`) where it applies: FFmpeg's development files found by
  ``pkg-config``, a yuv420p source, an even pixel ROI, ``AICITY_VDEC`` not
  0. Everything else decodes with cv2, imported only there.
- :class:`WindowScorer` scores the windows with the model on the card that
  holds it (in a process group of several ranks, each rank a contiguous,
  chunk-aligned share of one video's windows, gathered back in order).
  The default path uploads each chunk once, keeps the previous
  chunk's tail on the card, gathers every window's frames there by index,
  converts to normalized RGB and scores batches of windows, while a decoder
  thread keeps two chunks ahead. :meth:`WindowScorer.score_chunks` takes
  any iterator of chunks plus the window plans, so a caller can drive it
  without a video file. A two-pathway (SlowFast) model takes the
  window-streaming path instead, as in the JAX package: one sequential
  decode into a rolling buffer of resized RGB frames, each window packed
  into its slow and fast clips (``data/transform.py:pack_pathway_output``)
  and scored ``batch_size`` windows at a time. A detection model
  (``detection=True``: an RoI head) takes that path too, with one
  whole-frame box a window; with one pathway its windows cross to the card
  as u8 and are normalized there, as in the JAX package.

Output per video: the sorted list of ``(t0, t1, scores[num_class])`` that
the JAX package and the reference pickle (run_action_...py:110-130).
"""

from __future__ import annotations

import os
import pickle
import queue
import threading
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..data.decoder import cv2_video_meta, probe, sample_indices
from ..data.transform import pack_pathway_output
from ..parallel import mesh


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
    """One video's sliding windows and its decoders.

    ``backend`` (``DATA.DECODING_BACKEND``) must be ``cv2``, the JAX
    package's default; decord and PyAV are not ported. Items
    (``dataset[i]``) are ``(pathway clips, t0, t1)``: ``[clip f32 [T, s,
    s, 3]]``, or with ``arch_pathways`` 2 the slow clip of ``T //
    slowfast_alpha`` frames and the fast clip.
    """

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
        arch_pathways: int = 1,
        slowfast_alpha: int = 4,
        backend: str = "cv2",
    ):
        if backend != "cv2":
            raise NotImplementedError(
                f"DATA.DECODING_BACKEND {backend!r} is not ported for "
                f"window scoring; the scorer decodes with cv2 or the port's "
                f"FFmpeg library")
        self.arch_pathways = arch_pathways
        self.slowfast_alpha = slowfast_alpha
        self.video_path = video_path
        self.frame_length = frame_length
        self.frame_size = frame_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.last_decode_backend: Optional[str] = None  # set per decode run
        # the FFmpeg library's reading where its decoder applies, else None
        # and cv2's
        self._meta = probe(video_path)
        if self._meta is not None:
            self.num_frames = self._meta.frames
            self.fps = self._meta.fps or 30.0
        else:
            self.num_frames, self.fps = cv2_video_meta(video_path)
        self.windows = window_spans(self.num_frames, self.fps, frame_length,
                                    frame_stride, proposal_stride, target_fps)
        # relative ROI -> source pixels, resolved once
        self.roi = roi
        self._roi_px: Optional[tuple[int, int, int, int]] = None

    def __len__(self):
        return len(self.windows)

    def plans(self) -> list[tuple[int, int, np.ndarray]]:
        return window_plans(self.windows, self.frame_length, self.num_frames)

    def _resolve_roi_px(self, frame=None) -> Optional[tuple]:
        """The relative ROI in source pixels, fixed once: from ``frame``'s
        size when given, else from the FFmpeg library's frame size where it
        serves (so that its path never opens cv2), else from one frame
        decoded with cv2 (None if none decodes)."""
        if self._roi_px is None:
            if frame is not None:
                h, w = frame.shape[:2]
            elif self._meta is not None:
                w, h = self._meta.width, self._meta.height
            else:
                import cv2

                cap = cv2.VideoCapture(self.video_path)
                ok, frame = cap.read()
                cap.release()
                if not ok:
                    return None
                h, w = frame.shape[:2]
            x1, y1, x2, y2 = self.roi
            self._roi_px = (int(w * x1), int(h * y1),
                            int(w * x2), int(h * y2))
        return self._roi_px

    def _read(self, idxs: np.ndarray) -> np.ndarray:
        """RGB u8 frames ``[T, H, W, 3]`` at ``idxs`` (cv2: a seek near the
        first, then sequential grabs; an index past EOF takes the nearest
        decoded frame)."""
        import cv2

        cap = cv2.VideoCapture(self.video_path)
        out = {}
        need = sorted(set(int(i) for i in idxs))
        # windows sit deep inside long videos: scanning from frame 0 would
        # make the whole pass O(frames^2)
        cap.set(cv2.CAP_PROP_POS_FRAMES, need[0])
        i = need[0]
        while need:
            if not cap.grab():
                break
            if i == need[0]:
                ok, frame = cap.retrieve()
                if not ok:
                    break
                out[i] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                need.pop(0)
            i += 1
        cap.release()
        got = sorted(out)
        if not got:
            raise RuntimeError(f"decoded 0 frames from {self.video_path}")
        return np.stack([
            out[int(j)] if int(j) in out
            else out[min(got, key=lambda k: abs(k - int(j)))]
            for j in idxs
        ])

    def __getitem__(self, idx: int):
        import cv2

        t0, t1 = self.windows[int(idx)]
        frames = self._read(sample_indices(t0, t1, self.frame_length,
                                           self.num_frames))
        self._resolve_roi_px(frames[0])
        s = self.frame_size
        # the per-frame crop -> cv2.resize of the chunk paths
        x1, y1, x2, y2 = self._roi_px
        cropped = frames[:, y1:y2, x1:x2]
        resized = np.empty((frames.shape[0], s, s, 3), np.uint8)
        for i in range(frames.shape[0]):
            cv2.resize(cropped[i], (s, s), dst=resized[i],
                       interpolation=cv2.INTER_LINEAR)
        x = (resized.astype(np.float32) / 255.0 - self.mean) / self.std
        return (pack_pathway_output(x, self.arch_pathways,
                                    self.slowfast_alpha), t0, t1)

    def stream_windows(self, raw_u8: bool = False,
                       windows: Optional[Sequence[int]] = None
                       ) -> Iterator[tuple]:
        """Single-pass windows: every frame decoded, cropped and resized
        once (the chunk paths' per-frame cv2 arithmetic) into a rolling
        buffer that holds the frames a later window still needs; yields
        ``(pathway clips, t0, t1)`` as :meth:`__getitem__` does, in t0
        order, or under ``raw_u8`` ``([RGB u8 [T, s, s, 3]], t0, t1)`` for
        the consumer to normalize. A frame index past EOF takes the last
        decoded frame. ``windows`` (ascending indices into :meth:`plans`)
        streams only those, decoding from the first one's first frame."""
        plans = self.plans()
        if windows is not None:
            plans = [plans[w] for w in windows]
        if not plans:
            return
        s = self.frame_size
        write = self._frame_writer(s, yuv420=False, rgb=True)
        frame_idx, eof = int(plans[0][2][0]), False
        cap = _cv2_capture_at(self.video_path, frame_idx)
        buf: dict[int, np.ndarray] = {}
        try:
            for w, (t0, t1, idxs) in enumerate(plans):
                while frame_idx <= int(idxs[-1]) and not eof:
                    ok, frame = cap.read()
                    if not ok:
                        eof = True
                        break
                    self._resolve_roi_px(frame)
                    row = np.empty((s, s, 3), np.uint8)
                    write(frame, row)
                    buf[frame_idx] = row
                    frame_idx += 1
                if not buf:
                    raise RuntimeError(
                        f"decoded 0 frames from {self.video_path}")
                last = max(buf)
                u8 = np.stack([buf.get(int(i), buf[last]) for i in idxs])
                if raw_u8:
                    yield [u8], t0, t1
                else:
                    x = (u8.astype(np.float32) / 255.0 - self.mean) / self.std
                    yield (pack_pathway_output(x, self.arch_pathways,
                                               self.slowfast_alpha), t0, t1)
                if w + 1 < len(plans):  # drop what no later window reads
                    low = int(plans[w + 1][2][0])
                    for i in [i for i in buf if i < low]:
                        del buf[i]
        finally:
            cap.release()

    def stream_chunks(self, chunk_frames: int, rgb: bool = True,
                      yuv420: bool = True) -> Iterator[np.ndarray]:
        """Sequential decode -> ROI crop -> resize into u8 chunks, each
        source frame decoded and resized once: planar I420 ``[chunk_frames,
        s*3//2, s]`` when ``yuv420`` (the FFmpeg library's planes where it
        applies, else cv2's BGR packed to I420; ``rgb`` is ignored), else
        ``[chunk_frames, s, s, 3]`` RGB, or BGR under ``rgb=False``.
        Infinite: the EOF partial chunk is padded with its own last frame,
        then repeat-last chunks follow forever."""
        s = self.frame_size
        if yuv420 and s % 2:
            raise ValueError("I420 packing needs an even frame size")
        slab = np.empty(self._chunk_shape(chunk_frames, yuv420), np.uint8)
        dec = self._open_vdec(s) if yuv420 else None
        if dec is not None:
            try:
                yield from _emit_chunks(slab, dec.read)
            finally:
                dec.close()
            return

        import cv2

        cap = cv2.VideoCapture(self.video_path)
        write = self._frame_writer(s, yuv420, rgb)

        def read_row(row) -> bool:
            ok, frame = cap.read()
            if not ok:
                return False
            self._resolve_roi_px(frame)
            write(frame, row)
            return True

        try:
            yield from _emit_chunks(slab, read_row)
        finally:
            cap.release()

    def _chunk_shape(self, F: int, yuv420: bool) -> tuple[int, ...]:
        s = self.frame_size
        return (F, s * 3 // 2, s) if yuv420 else (F, s, s, 3)

    def _open_vdec(self, s: int):
        """The FFmpeg I420 decoder where it applies to this video (FFmpeg's
        development files found, a yuv420p source and ``AICITY_VDEC`` not 0
        when the dataset was made; an even pixel ROI), else None: the caller
        decodes with cv2. The two resamplers differ by ~1 u8 LSB, and an odd
        ROI would shift the I420 crop by a pixel, so the rules keep the
        backends interchangeable. Where the decoder applies, a failure to
        open raises."""
        self.last_decode_backend = "cv2"
        if self._meta is None:
            return None
        from .. import native

        roi = None
        if tuple(self.roi) != (0.0, 0.0, 1.0, 1.0):
            roi = self._resolve_roi_px()
            if any(v % 2 for v in roi):
                return None
        dec = native.VideoDecoderI420(self.video_path, s, roi)
        self.last_decode_backend = "vdec"
        return dec

    def _frame_writer(self, s: int, yuv420: bool, rgb: bool):
        """``write(frame, out_row)``: ROI crop + resize ONE decoded BGR
        frame straight into a slab row (u8 ``[s, s, 3]``, or I420 ``[s*3//2,
        s]`` when ``yuv420``); the colour conversion runs after the resize
        on the s x s crop. Each writer owns one scratch buffer: decoder
        threads each take their own."""
        import cv2

        tmp = np.empty((s, s, 3), np.uint8) if (yuv420 or rgb) else None
        interp = cv2.INTER_LINEAR

        def write(frame, out):
            x1, y1, x2, y2 = self._roi_px
            crop = frame[y1:y2, x1:x2]
            if yuv420:
                cv2.resize(crop, (s, s), dst=tmp, interpolation=interp)
                cv2.cvtColor(tmp, cv2.COLOR_BGR2YUV_I420, dst=out)
            elif rgb:
                cv2.resize(crop, (s, s), dst=tmp, interpolation=interp)
                cv2.cvtColor(tmp, cv2.COLOR_BGR2RGB, dst=out)
            else:
                cv2.resize(crop, (s, s), dst=out, interpolation=interp)

        return write

    def _decode_chunk(self, c: int, F: int, rgb: bool, yuv420: bool,
                      end_frame: Optional[int] = None):
        """Chunk ``c`` (source frames ``[c*F, (c+1)*F)``, none at or past
        ``end_frame``) from a decoder of its own: ``(slab, n_real)``, the
        slab's tail padded with the chunk's own last frame where ``0 <
        n_real < F`` (the sequential generator's partial chunk); ``(None,
        0)`` past EOF. The same backend as :meth:`stream_chunks`, so the
        bytes are the same."""
        s = self.frame_size
        slab = np.empty(self._chunk_shape(F, yuv420), np.uint8)
        n = F if end_frame is None else min(F, end_frame - c * F)
        done = 0
        dec = self._open_vdec(s) if yuv420 else None
        if dec is not None:
            with dec:
                # a container that refuses timestamp seeks: an exact
                # decode-and-discard skip (no crop or scale work)
                if c and not dec.seek(c * F):
                    dec.skip(c * F)
                while done < n and dec.read(slab[done]):
                    done += 1
        else:
            cap = _cv2_capture_at(self.video_path, c * F)
            write = self._frame_writer(s, yuv420, rgb)
            try:
                while done < n:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    write(frame, slab[done])
                    done += 1
            finally:
                cap.release()
        if not done:
            return None, 0
        slab[done:] = slab[done - 1]
        return slab, done

    def stream_chunks_parallel(self, chunk_frames: int, n_threads: int,
                               rgb: bool = True, yuv420: bool = True,
                               max_chunks: Optional[int] = None,
                               first_chunk: int = 0,
                               end_frame: Optional[int] = None
                               ) -> Iterator[np.ndarray]:
        """Ordered ``n_threads`` variant of :meth:`stream_chunks`, equal to it
        bit for bit (EOF padding included) and infinite like it. Chunk ``c``
        covers the disjoint source range ``[c*F, (c+1)*F)``, so each worker
        seeks its own decoder there and fills one slab; decoding runs in
        native code without the GIL, so it scales with host cores. About
        ``n_threads + 1`` slabs are in flight. No chunk at or past
        ``max_chunks`` is submitted (a consumer that stops there leaves no
        decode behind; chunks asked for past it are repeat-last pads, as
        past EOF). ``first_chunk`` starts the stream at that chunk (a rank's
        share of the video), and no frame at or past ``end_frame`` is
        decoded: the chunk that holds it is padded from there, as at EOF."""
        if n_threads <= 1 and not first_chunk and end_frame is None:
            yield from self.stream_chunks(chunk_frames, rgb=rgb,
                                          yuv420=yuv420)
            return
        from concurrent.futures import ThreadPoolExecutor

        F = chunk_frames
        n_threads = max(n_threads, 1)
        if yuv420 and self.frame_size % 2:
            raise ValueError("I420 packing needs an even frame size")
        self._resolve_roi_px()  # once, before the workers race on it
        shape = self._chunk_shape(F, yuv420)
        limit = max_chunks if max_chunks is not None else float("inf")
        n0 = int(min(first_chunk + n_threads + 1, limit))
        last = None  # the last real frame seen so far

        def pad():
            out = np.empty(shape, np.uint8)
            out[:] = last if last is not None else 0
            return out

        def submit(c):
            return pool.submit(self._decode_chunk, c, F, rgb, yuv420,
                               end_frame)

        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            futs = {c: submit(c) for c in range(first_chunk, n0)}
            nxt, c, eof = n0, first_chunk, False
            try:
                while True:
                    if eof or c not in futs:
                        yield pad()
                        continue
                    slab, n_real = futs.pop(c).result()
                    if n_real == F:
                        if nxt < limit:
                            futs[nxt] = submit(nxt)
                            nxt += 1
                        last = slab[-1].copy()  # the consumer owns the slab
                        yield slab
                    else:
                        eof = True
                        for f in futs.values():  # past-EOF lookahead
                            f.cancel()
                        futs.clear()
                        if n_real:
                            last = slab[n_real - 1].copy()
                            yield slab
                        else:
                            yield pad()
                    c += 1
            finally:
                for f in futs.values():  # the consumer stopped early
                    f.cancel()


def _cv2_capture_at(path: str, frame: int):
    """A ``cv2.VideoCapture`` of ``path`` whose next read returns source
    frame ``frame``. cv2's seek is estimated from the average fps and can
    land off target on VFR / odd-GOP sources: then an exact sequential
    skip from frame 0."""
    import cv2

    cap = cv2.VideoCapture(path)
    if frame:
        cap.set(cv2.CAP_PROP_POS_FRAMES, frame)
        if int(round(cap.get(cv2.CAP_PROP_POS_FRAMES))) != frame:
            cap.release()
            cap = cv2.VideoCapture(path)
            for _ in range(frame):
                if not cap.grab():
                    break
    return cap


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

    ``score_video`` takes the device-gather path by default: each chunk
    crosses to the card once, as planar I420, or under ``chroma420=False``
    as exact BGR frames (the channel swap folded into a copy of the
    patch-embed weight); a window is gathered there from the previous
    chunk's tail and the current chunk, and windows are scored
    ``batch_size`` at a time. ``num_workers`` bounds the parallel decoders
    (one fewer than the host's cores at most) and the loader path's worker
    processes. Results stay on the card until the video ends, so host
    decode overlaps device compute. ``last_timers`` holds the device-gather
    run's phase split (seconds of decode / upload / dispatch / drain, and
    the calls, chunks and decoder) and is None after any other path at one
    rank. A
    two-pathway model's windows take :meth:`_score_streaming`, and so do a
    detection model's (``detection=True``): its RoI head scores one
    whole-frame box a window, ``[i, 0, 0, s, s]`` (the reference's
    module_wrapper.py:558-576), the mean-pooled frame in effect.

    In a process group of several ranks (``parallel/mesh.py``: one process
    a card, where the JAX package shards each batch over a host's chips,
    ``window_inference.py:559-571``) every path splits one video's windows
    over the ranks by the chunk their first frame lies in
    (:meth:`_rank_windows`; the device-gather path through
    :meth:`_score_ranks`), each rank scores only its own, and every rank
    returns the whole video's windows; ``last_timers`` then holds each
    rank's split and windows under ``ranks``.
    """

    def __init__(self, model: torch.nn.Module, batch_size: int = 8,
                 num_workers: int = 8, chunk_frames: int = 512,
                 detection: bool = False, chroma420: bool = True):
        self.detection = detection
        self.model = model
        self.device = next(model.parameters()).device
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.chunk_frames = chunk_frames
        self.chroma420 = chroma420
        self.last_timers: Optional[dict] = None

    def score_video(self, dataset: WindowDataset, *,
                    streaming: bool = True) -> list:
        """Sorted ``[(t0, t1, scores)]`` for every window of ``dataset``:
        the device-gather path (the window-streaming path for a
        two-pathway model), or under ``streaming=False`` the loader path."""
        self.last_timers = None
        if streaming and dataset.arch_pathways == 1 and not self.detection:
            return self._score_device_gather(dataset)
        score = self._score_streaming if streaming else self._score_loader
        if mesh.get_world_size() == 1:
            return score(dataset)
        plans = dataset.plans()
        mine, _ = self._rank_windows(plans)
        preds = score(dataset, mine) if mine else []
        return self._gather_ranks(plans, mine, preds, {})

    def _boxes(self, n: int, s: int) -> tuple:
        """The model's box argument for ``n`` windows of ``s x s`` frames:
        one whole-frame ``[i, 0, 0, s, s]`` row each under detection, else
        nothing."""
        if not self.detection:
            return ()
        boxes = torch.zeros((n, 5), dtype=torch.float32)
        boxes[:, 0] = torch.arange(n, dtype=torch.float32)
        boxes[:, 3:] = float(s)
        return (boxes.to(self.device),)

    @torch.no_grad()
    def _score_streaming(self, dataset: WindowDataset,
                         windows: Optional[Sequence[int]] = None) -> list:
        """:meth:`WindowDataset.stream_windows` (of ``windows`` only, where
        given) in batches of ``batch_size`` windows, each pathway's clips
        copied to the card (a one-pathway detection model's as u8,
        normalized there); the scores stay there until the video ends."""
        pending = []
        group: list = []
        raw_u8 = dataset.arch_pathways == 1
        mean = torch.as_tensor(dataset.mean, device=self.device)
        std = torch.as_tensor(dataset.std, device=self.device)

        def flush():
            if not group:
                return
            xs = [torch.from_numpy(np.stack([g[0][p] for g in group]))
                  for p in range(len(group[0][0]))]
            if self.device.type == "cuda":
                xs = [x.pin_memory().to(self.device, non_blocking=True)
                      for x in xs]
            if raw_u8:
                xs = [(xs[0].float() / 255.0 - mean) / std]
            out = self.model(xs, *self._boxes(len(group),
                                              dataset.frame_size)).float()
            pending.append((out, [(g[1], g[2]) for g in group]))
            group.clear()

        for item in dataset.stream_windows(raw_u8=raw_u8, windows=windows):
            group.append(item)
            if len(group) == self.batch_size:
                flush()
        flush()
        return _sorted_preds(pending)

    def _score_device_gather(self, dataset: WindowDataset) -> list:
        plans = dataset.plans()
        if mesh.get_world_size() > 1:
            return self._score_ranks(dataset, plans)
        if not plans:
            return []
        return self._gather_windows(dataset, plans)

    def _rank_windows(self, plans: list) -> tuple[list[int], int]:
        """This rank's windows (ascending indices into ``plans``) and the
        first chunk of its share: the windows whose first frame lies in
        its contiguous share of the chunks (:func:`rank_chunks`)."""
        F = self.chunk_frames
        first = [int(p[2][0]) // F for p in plans]
        lo, hi = rank_chunks(max(first) + 1 if plans else 0,
                             mesh.get_world_size(), mesh.get_rank())
        return [w for w, c in enumerate(first) if lo <= c < hi], lo

    def _gather_ranks(self, plans: list, mine: list[int], preds: list,
                      timers: dict) -> list:
        """Every rank's ``(window index, scores)`` gathered to every rank
        (``preds``: this rank's sorted scores of its windows ``mine``);
        returns the whole video's list in the one-rank order and leaves
        ``last_timers`` ``{"ranks": [each rank's timers and windows]}``.
        A rank with no windows joins the gathers."""
        scores = (np.stack([p[2] for p in preds]) if preds
                  else np.zeros((0, 0), np.float32))
        idx = np.concatenate(mesh.process_allgather(np.asarray(mine,
                                                               np.int64)))
        scores = [x for x in mesh.process_allgather(scores) if len(x)]
        ranks = mesh.allgather_objects({**timers, "windows": len(mine)})
        self.last_timers = {"ranks": ranks}
        if not len(idx):
            return []
        scores = np.concatenate(scores)
        return [(plans[w][0], plans[w][1], scores[k])
                for k, w in sorted(enumerate(idx.tolist()),
                                   key=lambda kw: kw[1])]

    def _score_ranks(self, dataset: WindowDataset, plans: list) -> list:
        """One video's windows over the group's ranks (one a card): each
        rank scores its windows (:meth:`_rank_windows`), decoding from its
        first chunk to the last frame its windows read (past its share's
        end where a window spans into the next chunk), then the ranks
        gather (:meth:`_gather_ranks`); each rank's timers carry its
        device-gather split."""
        mine, lo = self._rank_windows(plans)
        timers = {"upload": 0.0, "dispatch": 0.0, "drain": 0.0,
                  "calls": 0, "chunks": 0, "decode": 0.0, "decoder": None}
        preds = []
        if mine:
            share = [plans[w] for w in mine]
            preds = self._gather_windows(
                dataset, share, first_chunk=lo,
                end_frame=max(int(p[2][-1]) for p in share) + 1)
            timers = self.last_timers
        return self._gather_ranks(plans, mine, preds, timers)

    def _gather_windows(self, dataset: WindowDataset, plans: list,
                        first_chunk: int = 0,
                        end_frame: Optional[int] = None) -> list:
        """The device-gather path over ``plans``; a rank's share passes the
        chunk its windows start in (``first_chunk``: none reads a frame
        before it) and ``end_frame``, past the last frame they read, so that
        its decoders decode only from the one to the other."""
        s = dataset.frame_size
        F = self.chunk_frames
        chroma = self.chroma420 and s % 2 == 0
        n_chunks = max(int(p[2][-1]) for p in plans) // F + 1
        # decoders fill disjoint chunks in parallel, one core left for this
        # thread; max_chunks: no decode past the last scored chunk
        n_dec = max(1, min(self.num_workers, (os.cpu_count() or 1) - 1))
        gen = dataset.stream_chunks_parallel(
            F, n_dec, rgb=False, yuv420=chroma, max_chunks=n_chunks,
            first_chunk=first_chunk, end_frame=end_frame)
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()
        decode = [0.0]

        def put(item) -> bool:
            """False once the scoring loop has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def decoder() -> None:
            # a decode error must reach the scoring loop, not strand it on
            # q.get(): it travels through the queue and is raised there; a
            # scoring error stops the decoding at the next chunk
            try:
                for _ in range(n_chunks - first_chunk):
                    t = time.perf_counter()
                    chunk = next(gen)
                    decode[0] += time.perf_counter() - t
                    if not put(chunk):
                        return
            except BaseException as e:  # noqa: BLE001 (raised in chunks())
                put(e)

        def chunks() -> Iterator[np.ndarray]:
            while True:
                item = q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item

        th = threading.Thread(target=decoder, name="window-decoder",
                              daemon=True)
        th.start()
        try:
            preds = self.score_chunks(chunks(), plans, s, dataset.mean,
                                      dataset.std, first_chunk=first_chunk)
        finally:
            stop.set()
            th.join()
            gen.close()  # the parallel decoders' pool and handles
        self.last_timers.update(decode=decode[0],
                                decoder=dataset.last_decode_backend or "cv2")
        return preds

    @torch.no_grad()
    def score_chunks(self, chunks: Iterator[np.ndarray],
                     plans: Sequence[tuple[int, int, np.ndarray]], s: int,
                     mean: Sequence[float], std: Sequence[float],
                     first_chunk: int = 0) -> list:
        """Score ``plans`` (``(t0, t1, frame indices)``, indices ascending
        within a window) over ``chunks``, an iterator of consecutive u8
        chunks of ``chunk_frames`` frames from chunk ``first_chunk`` on (no
        window reads a frame before it) that covers every indexed frame:
        planar I420 ``[F, s*3//2, s]`` (``chroma420`` and an even ``s``),
        else BGR ``[F, s, s, 3]``. ``mean`` / ``std`` are in RGB order.
        Returns the sorted ``[(t0, t1, scores f32)]``; sets ``last_timers``
        (upload / dispatch / drain seconds, calls, chunks)."""
        if not plans:
            return []
        F = self.chunk_frames
        span = max(int(p[2][-1]) - int(p[2][0]) for p in plans) + 1
        if span > F:
            raise ValueError(f"a window spans {span} frames, more than a "
                             f"chunk of {F}")
        chroma = self.chroma420 and s % 2 == 0
        # a window is scored with the chunk that holds its last frame; its
        # first frame then lies in that chunk or the previous one's tail
        by_chunk: dict[int, list[int]] = {}
        for w, (_, _, idxs) in enumerate(plans):
            by_chunk.setdefault(int(idxs[-1]) // F, []).append(w)
        n_chunks = max(by_chunk) + 1
        dev = self.device
        params = {}
        if chroma:
            row = (s * 3 // 2, s)
        else:
            # BGR frames: reversing the stem's input channels (dim 1 of the
            # Conv3d weight [out, in, t, h, w]) and the mean / std
            # gives the RGB model's output bit for bit
            row = (s, s, 3)
            # the stem's conv: the model's first 5-D parameter
            name, w = next((n, p) for n, p in self.model.named_parameters()
                           if p.dim() == 5)
            params[name] = w.flip(1)
            mean, std = np.flip(mean).copy(), np.flip(std).copy()
        mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=dev)
        std_t = torch.as_tensor(np.asarray(std, np.float32), device=dev)
        timers = {"upload": 0.0, "dispatch": 0.0, "drain": 0.0}
        prev = torch.zeros((F, *row), dtype=torch.uint8, device=dev)
        pending = []  # (scores on the card, [(t0, t1)])
        for c in range(first_chunk, n_chunks):
            chunk = next(chunks)
            t = time.perf_counter()
            host = torch.from_numpy(chunk)
            if dev.type == "cuda":
                host = host.pin_memory()
            cur = host.to(dev, non_blocking=True)
            buf = torch.cat([prev[F - span:], cur])  # rows c*F - span ...
            timers["upload"] += time.perf_counter() - t
            t = time.perf_counter()
            ws = by_chunk.get(c, [])
            for i in range(0, len(ws), self.batch_size):
                grp = ws[i:i + self.batch_size]
                idx = np.stack([plans[w][2] for w in grp]) - c * F + span
                x = buf[torch.as_tensor(idx, device=dev)]
                x = i420_to_rgb(x, s) if chroma else x.float()
                x = (x / 255.0 - mean_t) / std_t
                out = torch.func.functional_call(self.model, params, (x,))
                pending.append((out.float(),
                                [(plans[w][0], plans[w][1]) for w in grp]))
            timers["dispatch"] += time.perf_counter() - t
            prev = cur
        t = time.perf_counter()
        preds = _sorted_preds(pending)
        timers["drain"] += time.perf_counter() - t
        self.last_timers = {**timers, "calls": len(pending),
                            "chunks": n_chunks - first_chunk}
        return preds

    @torch.no_grad()
    def _score_loader(self, dataset: WindowDataset,
                      windows: Optional[Sequence[int]] = None) -> list:
        """Windows (``windows`` only, where given) decoded one by one
        (``dataset[i]``, a seek each) by a ``torch.utils.data.DataLoader``
        with ``num_workers`` spawned worker processes, ``batch_size`` at a
        time."""
        loader = torch.utils.data.DataLoader(
            dataset if windows is None
            else torch.utils.data.Subset(dataset, list(windows)),
            batch_size=self.batch_size, shuffle=False,
            drop_last=False, num_workers=self.num_workers,
            multiprocessing_context="spawn" if self.num_workers else None)
        pending = []
        for inputs, t0, t1 in loader:
            xs = [x.to(self.device) for x in inputs]
            out = self.model(xs[0] if len(xs) == 1 else xs,
                             *self._boxes(len(t0), dataset.frame_size))
            out = out.float()
            pending.append((out, list(zip(t0.tolist(), t1.tolist()))))
        return _sorted_preds(pending)


def rank_chunks(n_chunks: int, world: int, rank: int) -> tuple[int, int]:
    """``[lo, hi)``: rank ``rank``'s contiguous share of ``n_chunks``
    chunks over ``world`` ranks (the first ``n_chunks % world`` ranks take
    one more; shares past the chunks are empty)."""
    per, extra = divmod(n_chunks, world)
    lo = rank * per + min(rank, extra)
    return lo, lo + per + (rank < extra)


def _sorted_preds(pending: list) -> list:
    """``[(scores on the card [n, classes], [(t0, t1)] * n)]`` -> sorted
    ``[(t0, t1, scores f32)]``, fetched from the card in one copy."""
    if not pending:
        return []
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
