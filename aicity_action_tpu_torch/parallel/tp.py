"""Tensor-parallel placement of MViT's big weights (port of
``aicity_action_tpu/parallel/tp.py``).

The Megatron rules of the JAX ``_spec_for`` in torch's ``[out, in]``
layout (:func:`placement`): the ``qkv`` and ``fc1`` weights are split on
their output features (dim 0), the attention ``proj`` and ``fc2`` weights
on their input features (dim 1); everything else is replicated. An
optimizer's moments follow their parameters (:func:`state_placements`).

The port runs tensor parallelism as the JAX package runs it on hardware
(``tests/test_tp_realistic.py``'s note): the kernels are compiled for
whole weights, so each split weight is gathered whole before the forward
that reads it and its gradient reduced back to the pieces after the
backward (:class:`TensorParallel`). Weights and their moments lie split
at rest; the kernels see whole weights (they refuse the widths a split
would give them: at tp 2, block 0's hidden width 192 breaks the LN+MLP
backward's ``H % 128 == 0``). So the axis saves parameter and optimizer
memory, not compute: every rank of the axis runs the whole model on the
same rows (the batch is sharded over the data axis alone).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from . import mesh as pmesh

_COLUMN = ("attn.qkv.weight", "mlp.fc1.weight")
_ROW = ("attn.proj.weight", "mlp.fc2.weight")


def placement(name: str, p: torch.Tensor) -> int | None:
    """The dim on which the parameter ``name`` is split over the model
    axis, None where it is replicated."""
    if p.dim() == 2:
        if name.endswith(_COLUMN):
            return 0
        if name.endswith(_ROW):
            return 1
    return None


def tp_placements(model: torch.nn.Module) -> dict:
    """``{name: split dim or None}`` of every parameter of ``model``."""
    return {n: placement(n, p) for n, p in model.named_parameters()}


def state_placements(optimizer: torch.optim.Optimizer, tp) -> dict:
    """``{parameter name: {state key: split dim or None}}`` of a torch
    optimizer over :meth:`TensorParallel.parameters`: each moment lies as
    its parameter does (the JAX ``state_shardings``)."""
    names = {id(p): n for n, p in tp.named_parameters()}
    return {names[id(p)]: {k: tp.dims.get(names[id(p)])
                           for k, v in st.items()
                           if torch.is_tensor(v) and v.dim() > 0}
            for p, st in optimizer.state.items()}


class TensorParallel:
    """``model``'s split weights over ``m``'s ``model_axis``: rank ``i`` of
    the axis keeps piece ``i`` (:attr:`shards`, what the optimizer
    steps); :meth:`gather` makes the whole weights before a step's forward
    and :meth:`release` frees them after it; :meth:`reduce_grads` averages
    every gradient over the ranks and keeps this rank's piece of each
    split one. A weight whose split dim does not divide stays replicated.
    """

    def __init__(self, model: torch.nn.Module, m: pmesh.Mesh,
                 model_axis: str = "model", data_axis: str = "data"):
        self.model, self.mesh = model, m
        self.axis, self.data = model_axis, data_axis
        n, i = m.size(model_axis), m.index(model_axis)
        self.whole: dict = {}  # name -> the model's (whole) parameter
        self.shards: dict = {}  # name -> this rank's piece
        self.dims: dict = {}
        for name, p in model.named_parameters():
            d = placement(name, p)
            if d is None or p.shape[d] % n:
                continue
            self.whole[name] = p
            self.dims[name] = d
            self.shards[name] = torch.nn.Parameter(
                p.detach().chunk(n, d)[i].clone())
        self._ids = {id(s) for s in self.shards.values()}
        self.release()

    def parameters(self) -> list:
        """What the optimizer steps: the replicated parameters and this
        rank's pieces."""
        whole = {id(p) for p in self.whole.values()}
        return [p for p in self.model.parameters()
                if id(p) not in whole] + list(self.shards.values())

    def named_parameters(self):
        """The model's names with this rank's pieces in place of the split
        weights (what ``solver/optimizer.py:construct_optimizer`` groups)."""
        whole = {id(p) for p in self.whole.values()}
        for n, p in self.model.named_parameters():
            yield n, (self.shards[n] if id(p) in whole else p)

    @torch.no_grad()
    def gather(self) -> None:
        """The whole weights from every rank's pieces (one all-reduce
        each)."""
        g, n, i = (self.mesh.group(self.axis), self.mesh.size(self.axis),
                   self.mesh.index(self.axis))
        for name, p in self.whole.items():
            s, d = self.shards[name], self.dims[name]
            shape = list(s.shape)
            shape[d] *= n
            buf = s.new_zeros(shape)
            buf.narrow(d, i * s.shape[d], s.shape[d]).copy_(s)
            if n > 1:
                dist.all_reduce(buf, group=g)
            p.data = buf

    def release(self) -> None:
        for p in self.whole.values():
            p.data = p.data.new_empty(0)
            p.grad = None

    def reduce_grads(self) -> None:
        """Every gradient averaged over the ranks (the data axis's rows
        differ; the model axis's ranks hold the same rows), then each
        split weight's handed to this rank's piece."""
        world = pmesh.get_world_size()
        n, i = self.mesh.size(self.axis), self.mesh.index(self.axis)
        for name, p in self.model.named_parameters():
            if p.grad is None:
                continue
            if world > 1:
                dist.all_reduce(p.grad)
            p.grad.div_(world)
            if name in self.shards:
                self.shards[name].grad = p.grad.chunk(
                    n, self.dims[name])[i].clone()
                p.grad = None

    def grad_norm(self, params) -> torch.Tensor:
        """The global gradient norm, each piece counted once."""
        return pmesh.sharded_grad_norm(params, self._ids, self.mesh,
                                       self.axis)


def make_tp_train_step(tp: TensorParallel, optimizer, loss_name: str,
                       **kw) -> Callable:
    """``train_step(batch) -> (metrics, preds)``: gather the whole
    weights, the port's train step (``engine/steps.py``) with the batch
    sharded over the data axis alone and :meth:`TensorParallel.
    reduce_grads` before the optimizer, then release the weights.
    ``optimizer`` steps :meth:`TensorParallel.parameters`, its
    ``norm_fn`` set to :meth:`TensorParallel.grad_norm`."""
    from ..engine.steps import make_train_step

    inner = make_train_step(tp.model, optimizer, loss_name,
                            grad_sync=tp.reduce_grads,
                            data=pmesh.data_ranks(tp.mesh, tp.data), **kw)

    def train_step(batch: dict, mixup_draw=None):
        tp.gather()
        try:
            return inner(batch, mixup_draw)
        finally:
            tp.release()

    return train_step
