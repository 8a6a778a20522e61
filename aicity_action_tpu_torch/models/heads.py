"""Classification and contrastive heads (port of ``aicity_action_tpu/
models/heads.py``: ``TransformerBasicHead``, reference head_helper.py:
369-417, and ``ContrastiveProjectionHead``, head_helper.py:419-450).
``TransformerMultiHead`` (the multi-dataset heads) is not ported yet
(ROADMAP Queue 1 item 9b)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import dp_rand
from .text import ProjectionMlp


class TransformerBasicHead(nn.Module):
    """dropout -> linear ``projection``; the activation (softmax or sigmoid)
    is applied at eval, and in training only when ``use_act_in_train``.
    Dropout acts in training only, with its mask drawn from the
    ``generator`` the caller passes (for the global batch under data
    parallelism)."""

    def __init__(self, dim_in: int, num_classes: int,
                 dropout_rate: float = 0.0, act_func: str = "softmax",
                 use_act_in_train: bool = False):
        super().__init__()
        if act_func not in ("softmax", "sigmoid"):
            raise NotImplementedError(
                f"{act_func} is not supported as an activation")
        self.projection = nn.Linear(dim_in, num_classes)
        self.dropout_rate = dropout_rate
        self.act_func = act_func
        self.use_act_in_train = use_act_in_train

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.training and self.dropout_rate > 0:
            if generator is None:
                raise ValueError("head dropout in training needs a generator")
            keep = 1.0 - self.dropout_rate
            mask = dp_rand(tuple(x.shape), generator, x.device) < keep
            x = torch.where(mask, x / keep, torch.zeros_like(x))
        x = F.linear(x, self.projection.weight.to(x.dtype),
                     self.projection.bias.to(x.dtype))
        if self.use_act_in_train or not self.training:
            # f32 softmax / sigmoid (the dtype policy)
            x = x.float()
            x = torch.softmax(x, dim=1) if self.act_func == "softmax" \
                else torch.sigmoid(x)
        return x


class ContrastiveProjectionHead(nn.Module):
    """The video tower's head of ActionCLIP: LayerNorm (eps 1e-6, f32
    statistics) then a bias-free linear ``projection`` to ``dim_out``, or
    under ``use_mlp`` a 2048-wide MLP (``projection.fc1`` / ``fc2``, dropout
    in training). Plain PyTorch, as the JAX package's is plain XLA; returns
    the compute type."""

    def __init__(self, dim_in: int, dim_out: int, use_mlp: bool = False,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.norm = nn.LayerNorm(dim_in, eps=1e-6)
        self.projection = (ProjectionMlp(dim_in, 2048, dim_out, dropout_rate)
                           if use_mlp else nn.Linear(dim_in, dim_out,
                                                     bias=False))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = x.dtype
        x = F.layer_norm(x.float(), (x.shape[-1],), self.norm.weight,
                         self.norm.bias, 1e-6).to(dt)
        if isinstance(self.projection, nn.Linear):
            return F.linear(x, self.projection.weight.to(dt))
        return self.projection(x, generator)
