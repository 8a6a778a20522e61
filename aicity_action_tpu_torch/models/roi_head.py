"""Detection RoI head (port of ``aicity_action_tpu/models/roi_head.py``;
reference: head_helper.py ResNetRoIHead:14-136).

Per pathway: the mean over all frames (the reference's temporal AvgPool
over the whole clip; its ``pool_size`` is not needed), RoIAlign, a max over
the RoI's bins; then the pathways' features concatenated, dropout and the
linear ``projection``. The activation applies in training **and** at eval,
as the reference's head applies it unconditionally (AVA trains sigmoid
scores under BCE).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.roi_align import roi_align
from ..parallel.mesh import dp_rand


class ResNetRoIHead(nn.Module):
    """``forward(xs, bboxes)``: ``xs[p]`` channels-last ``[B, T, H, W,
    C_p]``, ``bboxes [N, 5]`` rows ``(batch_idx, x1, y1, x2, y2)`` in input
    pixels; returns the activation ``[N, num_classes]`` in f32 (f64 for f64
    maps). The linear layer runs in the maps' dtype; dropout (training
    only) draws its mask from the caller's ``generator``."""

    def __init__(self, dim_in: Sequence[int], num_classes: int,
                 resolution: Sequence[int], scale_factor: Sequence[int],
                 dropout_rate: float = 0.0, act_func: str = "sigmoid",
                 aligned: bool = True):
        super().__init__()
        if act_func not in ("softmax", "sigmoid"):
            raise NotImplementedError(
                f"{act_func} is not supported as an activation")
        self.resolution = tuple(resolution)
        self.scale_factor = tuple(scale_factor)
        self.dropout_rate = dropout_rate
        self.act_func = act_func
        self.aligned = aligned
        self.projection = nn.Linear(sum(dim_in), num_classes)

    def forward(self, xs: Sequence[torch.Tensor], bboxes: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = xs[0].dtype
        pooled = []
        for p, x in enumerate(xs):
            rois = roi_align(x.mean(dim=1), bboxes,
                             output_size=self.resolution[p],
                             spatial_scale=1.0 / self.scale_factor[p],
                             sampling_ratio=0, aligned=self.aligned)
            pooled.append(rois.amax(dim=(1, 2)))
        x = torch.cat(pooled, dim=-1)
        if self.training and self.dropout_rate > 0:
            if generator is None:
                raise ValueError("head dropout in training needs a generator")
            keep = 1.0 - self.dropout_rate
            mask = dp_rand(tuple(x.shape), generator, x.device) < keep
            x = torch.where(mask, x / keep, torch.zeros_like(x))
        x = F.linear(x.to(dt), self.projection.weight.to(dt),
                     self.projection.bias.to(dt))
        x = x.to(torch.promote_types(dt, torch.float32))
        return torch.softmax(x, dim=1) if self.act_func == "softmax" \
            else torch.sigmoid(x)
