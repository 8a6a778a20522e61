"""RoIAlign in plain PyTorch (port of ``aicity_action_tpu/ops/roi_align.py``;
reference: detectron2's ROIAlign under the detection head,
head_helper.py:78-84).

The JAX op's rules, kept exactly:

- ``aligned=True`` shifts the scaled box by -0.5; legacy mode floors the
  RoI's width and height at 1;
- ``sampling_ratio=0`` samples each bin on a per-RoI grid of
  ``ceil(roi_h / out) x ceil(roi_w / out)``, capped at the static
  ``max_samples`` (by default ``ceil(H / out)`` and ``ceil(W / out)``): a
  box larger than the feature map saturates at the cap, where detectron2's
  kernel would take more samples;
- a sample is zero only outside ``[-1, size]`` on either axis, else its
  coordinates clamp into the map;
- each bin divides by ``max(grid_h * grid_w, 1)``, so a degenerate box (the
  padded rows of a box slab) gives 0.

Bilinear sampling is separable, and so is the sample grid: each RoI's bins
are one weight matrix over the map's rows times the map times one over its
columns (``[N, out, H] x [N, H, W, C] x [N, out, W]``), which is the JAX
op's sum over samples and their four corners in another order. It runs in
f32, or f64 for an f64 map (the JAX op's f32 coordinates promote a bf16
map), and gradients reach the map through autograd.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _axis_weights(start: torch.Tensor, bin_size: torch.Tensor,
                  grid: torch.Tensor, ns: int, out: int,
                  size: int) -> torch.Tensor:
    """``[N, out, size]``: for each RoI and output bin along one axis, the
    summed bilinear weights of its valid samples on the map's ``size``
    positions. ``start`` / ``bin_size`` / ``grid`` are ``[N]`` (``grid``
    the per-RoI sample count, at most ``ns``)."""
    dev = start.device
    i = torch.arange(ns, dtype=start.dtype, device=dev)
    p = torch.arange(out, dtype=start.dtype, device=dev)
    f = p[None, :, None] + (i[None, None, :] + 0.5) / grid.clamp_min(
        1.0)[:, None, None]
    c = start[:, None, None] + f * bin_size[:, None, None]  # [N, out, ns]
    valid = (c >= -1.0) & (c <= size)
    c = c.clamp(0.0, size - 1)
    c0 = c.floor()
    frac = c - c0
    c0 = c0.long()
    c1 = (c0 + 1).clamp_max(size - 1)
    keep = ((i[None, :] < grid[:, None])[:, None, :] & valid).to(c.dtype)
    w = (F.one_hot(c0, size) * ((1.0 - frac) * keep)[..., None]
         + F.one_hot(c1, size) * (frac * keep)[..., None])
    return w.sum(dim=2)


def roi_align(features: torch.Tensor, boxes: torch.Tensor, *,
              output_size: int, spatial_scale: float,
              sampling_ratio: int = 0, aligned: bool = True,
              max_samples: int | None = None) -> torch.Tensor:
    """RoIAlign of channels-last ``features [B, H, W, C]`` over ``boxes [N,
    5]`` rows ``(batch_idx, x1, y1, x2, y2)`` in input coordinates (scaled
    by ``spatial_scale``). Returns ``[N, output_size, output_size, C]`` in
    f32 (f64 for an f64 map)."""
    feats = features.to(torch.promote_types(features.dtype, torch.float32))
    boxes = boxes.to(device=feats.device, dtype=feats.dtype)
    _, H, W, _ = feats.shape
    out = output_size
    offset = 0.5 if aligned else 0.0
    batch_idx = boxes[:, 0].long()
    x1 = boxes[:, 1] * spatial_scale - offset
    y1 = boxes[:, 2] * spatial_scale - offset
    x2 = boxes[:, 3] * spatial_scale - offset
    y2 = boxes[:, 4] * spatial_scale - offset
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        roi_w, roi_h = roi_w.clamp_min(1.0), roi_h.clamp_min(1.0)
    bin_w, bin_h = roi_w / out, roi_h / out
    if sampling_ratio > 0:
        ns_h = ns_w = sampling_ratio
        gh = torch.full_like(roi_h, float(sampling_ratio))
        gw = torch.full_like(roi_w, float(sampling_ratio))
    else:
        if max_samples is None:
            ns_h = max(math.ceil(H / out), 1)
            ns_w = max(math.ceil(W / out), 1)
        else:
            ns_h = ns_w = max_samples
        gh = torch.ceil(roi_h / out).clamp(0, ns_h)
        gw = torch.ceil(roi_w / out).clamp(0, ns_w)
    count = (gh * gw).clamp_min(1.0)
    wy = _axis_weights(y1, bin_h, gh, ns_h, out, H)  # [N, out, H]
    wx = _axis_weights(x1, bin_w, gw, ns_w, out, W)  # [N, out, W]
    rows = torch.einsum("nph,nhwc->npwc", wy, feats[batch_idx])
    bins = torch.einsum("npwc,nqw->npqc", rows, wx)
    return bins / count[:, None, None, None]
