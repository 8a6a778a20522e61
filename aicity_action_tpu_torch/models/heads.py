"""Classification and contrastive heads (port of ``aicity_action_tpu/
models/heads.py``: ``TransformerBasicHead``, reference head_helper.py:
369-417, ``ContrastiveProjectionHead``, head_helper.py:419-450, and the
multi-dataset ``TransformerMultiHead``, head_helper.py:464-601)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .text import ProjectionMlp, dropout


def head_activation(x: torch.Tensor, act_func: str) -> torch.Tensor:
    """The eval activation in f32 (the dtype policy)."""
    x = x.float()
    return torch.softmax(x, dim=1) if act_func == "softmax" \
        else torch.sigmoid(x)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` in ``x``'s compute type."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


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
            x = dropout(x, self.dropout_rate, generator)
        x = _linear(x, self.projection)
        if self.use_act_in_train or not self.training:
            x = head_activation(x, self.act_func)
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


class TransformerMultiHead(nn.Module):
    """One head a dataset (``head_{ds}``: a linear layer, or under
    ``use_mlp`` a 2048-wide MLP with its own dropout) and, under
    ``add_cross_proj``, a bias-free ``cross_{src}_{dst}`` projection of
    each head's logits into every other dataset's class space.

    ``forward`` returns ``{dataset: [B, classes]}`` for ``dataset_name``'s
    head, or every head's where it is None: logits in the compute type in
    training, the dataset's activation in f32 at eval. With
    ``run_cross_proj`` it adds ``{"{src}_{dst}": [B, classes of dst]}``,
    the projections of the src head's logits (before any activation).
    Dropout (without the MLP: on the input) acts in training only, its mask
    from ``generator``.

    Parameter names map one to one onto the JAX ``head/head_{ds}/{kernel,
    bias}``, ``head/head_{ds}/fc{1,2}/...`` and ``head/cross_{src}_{dst}/
    kernel`` leaves (``utils/convert.py``). The JAX converter of reference
    checkpoints maps none of these leaves, and no reference checkpoint is
    at hand, so the names ``head.head_{ds}.*`` and
    ``head.cross_{src}_{dst}.weight`` are inferred from the JAX names."""

    def __init__(self, dim_in: int, datasets, num_classes, act_funcs,
                 dropout_rate: float = 0.0, use_mlp: bool = False,
                 add_cross_proj: bool = False):
        super().__init__()
        for act in act_funcs:
            if act not in ("softmax", "sigmoid"):
                raise NotImplementedError(
                    f"{act} is not supported as an activation")
        self.datasets = list(datasets)
        self.num_classes = dict(zip(self.datasets, num_classes))
        self.act_funcs = dict(zip(self.datasets, act_funcs))
        self.dropout_rate = dropout_rate
        self.use_mlp = use_mlp
        self.add_cross_proj = add_cross_proj
        for ds, n in self.num_classes.items():
            self.add_module(f"head_{ds}", ProjectionMlp(
                dim_in, 2048, n, dropout_rate) if use_mlp
                else nn.Linear(dim_in, n))
        if add_cross_proj:
            for src, dst in self.cross_pairs():
                self.add_module(f"cross_{src}_{dst}", nn.Linear(
                    self.num_classes[src], self.num_classes[dst],
                    bias=False))

    def cross_pairs(self) -> list[tuple[str, str]]:
        return [(a, b) for a in self.datasets for b in self.datasets
                if a != b]

    def _logits(self, ds: str, x: torch.Tensor,
                generator: torch.Generator | None) -> torch.Tensor:
        head = getattr(self, f"head_{ds}")
        return head(x, generator) if self.use_mlp else _linear(x, head)

    def forward(self, x: torch.Tensor, dataset_name: str | None = None,
                run_cross_proj: bool = False,
                generator: torch.Generator | None = None) -> dict:
        if self.training and self.dropout_rate > 0 and not self.use_mlp:
            x = dropout(x, self.dropout_rate, generator)
        names = self.datasets if dataset_name is None else [dataset_name]
        raw = {ds: self._logits(ds, x, generator) for ds in names}
        out = {ds: (logits if self.training
                    else head_activation(logits, self.act_funcs[ds]))
               for ds, logits in raw.items()}
        if self.add_cross_proj and run_cross_proj:
            for src, dst in self.cross_pairs():
                if src not in raw:
                    raw[src] = self._logits(src, x, generator)
                out[f"{src}_{dst}"] = _linear(
                    raw[src], getattr(self, f"cross_{src}_{dst}"))
        return out
