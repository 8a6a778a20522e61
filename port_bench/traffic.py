"""The general traffic generator: every mix under ``port_bench/traffic/``
is a table of parameters that these functions read.

- Views for window scoring: the windows of a view (``frame_length`` frames
  every ``frame_stride`` over ``frame_length * frame_stride`` source frames,
  one every ``proposal_stride``; frame indices clipped to the view) and the
  view's chunks, each drawn from a pool of I420 chunks made in set-up. The
  window arithmetic is the reference scorer's (module_wrapper.py:213-232,
  with the view at the target frame rate), written here.
- Clips for training: a pool of batches of normalised clips and labels.

Everything is drawn from the run's seed: the same seed gives the same
windows, chunks, order, clips and labels.
"""

from __future__ import annotations

import numpy as np
import torch

from .weights import INPUTS, generator, seed_of


def view_windows(t: dict) -> list[tuple[int, int, np.ndarray]]:
    """``(t0, t1, frame indices)`` of every window of one view."""
    n, length = t["view_frames"], t["frame_length"]
    span = length * t["frame_stride"]
    out = []
    for t0 in range(0, n, t["proposal_stride"]):
        idx = np.clip(np.linspace(t0, t0 + span, length), 0, n - 1)
        out.append((t0, t0 + span, idx.astype(np.int64)))
    return out


def i420_pool(t: dict, s: int, seed: int, device) -> list[np.ndarray]:
    """``chunk_pool`` chunks of ``chunk_frames`` I420 frames ``[F, s*3//2,
    s]`` u8 on the host (as a decoder hands them: not pinned): luma a
    gradient moving 3 rows a frame plus noise in [0, 8), chroma uniform in
    [64, 192). Made on ``device`` in a few calls, then copied to the
    host."""
    F, n = t["chunk_frames"], t["chunk_pool"]
    gen = generator(seed, INPUTS, device)
    rows = torch.arange(s, device=device).view(1, s, 1)
    out = []
    for c in range(n):
        frame = torch.arange(F, device=device).view(F, 1, 1) + c * F
        luma = ((rows + 3 * frame) % 220 + 16).expand(F, s, s).to(torch.uint8)
        noise = torch.randint(0, 8, (F, s, s), generator=gen, device=device,
                              dtype=torch.uint8)
        chroma = torch.randint(64, 192, (F, s // 2, s), generator=gen,
                               device=device, dtype=torch.uint8)
        out.append(torch.cat([luma + noise, chroma], 1).cpu().numpy())
    return out


def chunk_order(t: dict, seed: int, view: int, n_chunks: int) -> np.ndarray:
    """Which pool chunk stands at each of a view's chunks."""
    rng = np.random.default_rng([seed_of(seed, INPUTS), view])
    return rng.integers(0, t["chunk_pool"], n_chunks)


def n_chunks(t: dict) -> int:
    return -(-t["view_frames"] // t["chunk_frames"])


def window_frames(t: dict, pool: list, order: np.ndarray,
                  idx: np.ndarray) -> np.ndarray:
    """The I420 frames ``[len(idx), s*3//2, s]`` that a view whose chunks
    are ``pool[order]`` holds at ``idx``."""
    F = t["chunk_frames"]
    return np.stack([pool[order[i // F]][i % F] for i in idx])


def clip_batches(t: dict, frames: int, crop: int, classes: int, seed: int,
                 device) -> list[dict]:
    """``batch_pool`` batches of ``batch_size`` normalised clips ``[B, T,
    S, S, 3]`` (float32, N(0, 1), as a loader hands them) and int labels."""
    gen = generator(seed, INPUTS, device)
    B = t["batch_size"]
    return [{"inputs": torch.randn((B, frames, crop, crop, 3), generator=gen,
                                   device=device),
             "labels": torch.randint(0, classes, (B,), generator=gen,
                                     device=device)}
            for _ in range(t["batch_pool"])]
