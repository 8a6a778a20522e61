"""Shared model building blocks (port of ``aicity_action_tpu/models/
common.py``; reference: slowfast/models/common.py)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.fused_dense import exact_gelu  # noqa: F401  (the MLP's GELU)
from ..ops.layer_norm import fused_layer_norm


def round_width(width: float, multiplier: float, min_width: int = 1,
                divisor: int = 1) -> int:
    """Round a channel width to a divisor multiple (reference:
    models/utils.py:round_width)."""
    if not multiplier:
        return int(width)
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


class FusedLayerNorm(nn.Module):
    """LayerNorm through :func:`fused_layer_norm` (the CUDA kernel on the
    card). Parameters are ``weight`` / ``bias`` of width ``C // groups``,
    as ``nn.LayerNorm(C // groups)`` names them; ``groups > 1`` normalizes
    each channel group with the shared parameters. Parameters stay f32 and
    are cast to the activation's type where they are used."""

    def __init__(self, normalized: int, eps: float = 1e-6, groups: int = 1):
        super().__init__()
        self.eps = eps
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(normalized))
        self.bias = nn.Parameter(torch.zeros(normalized))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm(x.contiguous(), self.weight.to(x.dtype),
                                self.bias.to(x.dtype), self.eps, self.groups)
