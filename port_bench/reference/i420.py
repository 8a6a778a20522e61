"""Planar I420 u8 frames to normalised RGB float32, written from the
limited-range BT.601 inverse with nearest chroma upsampling (the
conversion a decoder's I420 output needs; within 1/255 of OpenCV's
``COLOR_YUV2RGB_I420``)."""

from __future__ import annotations

import torch


def i420_to_rgb(yuv: torch.Tensor, s: int) -> torch.Tensor:
    """``[..., s*3//2, s]`` u8 -> ``[..., s, s, 3]`` float32 in [0, 255]."""
    lead = yuv.shape[:-2]
    q = s // 4
    y = yuv[..., :s, :].float() - 16.0
    u = yuv[..., s:s + q, :].reshape(*lead, s // 2, s // 2).float() - 128.0
    v = yuv[..., s + q:, :].reshape(*lead, s // 2, s // 2).float() - 128.0
    up = [t.repeat_interleave(2, -2).repeat_interleave(2, -1) for t in (u, v)]
    u, v = up
    r = 1.1644 * y + 1.5960 * v
    g = 1.1644 * y - 0.3918 * u - 0.8130 * v
    b = 1.1644 * y + 2.0172 * u
    return torch.stack([r, g, b], -1).clamp(0.0, 255.0)


def normalise(rgb: torch.Tensor, mean, std) -> torch.Tensor:
    m = torch.as_tensor(mean, dtype=torch.float32, device=rgb.device)
    d = torch.as_tensor(std, dtype=torch.float32, device=rgb.device)
    return (rgb / 255.0 - m) / d
