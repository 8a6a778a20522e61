"""Classification head (port of ``aicity_action_tpu/models/heads.py:
TransformerBasicHead``; reference: head_helper.py:369-417)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class TransformerBasicHead(nn.Module):
    """dropout -> linear ``projection``; the activation (softmax or sigmoid)
    is applied at eval, and in training only when ``use_act_in_train``.
    Dropout is the identity at eval, the only mode this port serves."""

    def __init__(self, dim_in: int, num_classes: int,
                 dropout_rate: float = 0.0, act_func: str = "softmax",
                 use_act_in_train: bool = False):
        super().__init__()
        if act_func not in ("softmax", "sigmoid"):
            raise NotImplementedError(
                f"{act_func} is not supported as an activation")
        self.projection = nn.Linear(dim_in, num_classes)
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0 else None
        self.act_func = act_func
        self.use_act_in_train = use_act_in_train

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dropout is not None:
            x = self.dropout(x)
        x = F.linear(x, self.projection.weight.to(x.dtype),
                     self.projection.bias.to(x.dtype))
        if self.use_act_in_train or not self.training:
            # f32 softmax / sigmoid (the dtype policy)
            x = x.float()
            x = torch.softmax(x, dim=1) if self.act_func == "softmax" \
                else torch.sigmoid(x)
        return x
