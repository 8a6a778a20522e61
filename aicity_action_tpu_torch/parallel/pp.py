"""Pipeline parallelism (GPipe) for MViT (port of ``aicity_action_tpu/
parallel/pp.py``).

- The blocks are split into contiguous stages of balanced products
  (:func:`split_pp_stages`, a min-max dynamic program over
  :func:`block_flops`): MViT's early blocks see 16x the tokens of its last
  ones, so equal depths would idle most of the pipe. The patch embed rides
  on the first stage, the final norm and head on the last.
- :class:`MViTPipeline` is one process with a list of ``torch.device``\\ s,
  one a stage (on one card every stage sits on ``cuda:0``): each stage is
  a slice of the port's ``MViT`` (its blocks ``[lo, hi)``, the embed or the
  head), its parameters on its device.
- ``loss_and_grads`` runs the GPipe fill / drain schedule: the forward
  sweep keeps each stage's input per microbatch and nothing else (no
  autograd; the last stage is not run there), and the backward sweep runs
  each stage's forward under autograd (again, for all but the last) and
  back-propagates through it, so activation memory is the stages' inputs. The gradients of the microbatches add up on each stage's
  device.
- DropPath masks are drawn by the driver per (block, sample of the whole
  batch) before the split into microbatches, so the gradients do not
  depend on the number of microbatches.
- :meth:`MViTPipeline.init_optimizer` / :meth:`MViTPipeline.opt_step`
  keep each stage's optimizer (and its moments) on its own device.

The head is the projection without dropout or activation (the JAX
``_dense_head``); dropout inside attention and MLP is not plumbed (the
AI City recipes train them at 0). MoE blocks are refused.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..models.heads import _linear
from .sp_model import _pooled


def _active(kernel, stride) -> bool:
    return len(kernel) > 0 and not (
        np.prod(kernel) == 1 and np.prod(stride) == 1)


def thw_schedule(spec) -> list:
    """``out[i]``: the (T, H, W) grid into block ``i``; ``out[depth]`` the
    final grid."""
    thw = spec.patch_dims
    out = [thw]
    for bs in spec.blocks:
        if _active(bs.kernel_q, bs.stride_q):
            thw = tuple(_pooled(e, k, s)
                        for e, k, s in zip(thw, bs.kernel_q, bs.stride_q))
        out.append(thw)
    return out


def block_flops(spec, i: int, thw_in) -> float:
    """A rough count of block ``i``'s product FLOPs a sample (enough to
    balance stages; pool convolutions and norms are noise here)."""
    bs = spec.blocks[i]
    expand = spec.channel_expand_front and bs.dim != bs.dim_out
    dim_att = bs.dim_out if expand else bs.dim
    L = int(np.prod(thw_in))
    thw_q = thw_in
    if _active(bs.kernel_q, bs.stride_q):
        thw_q = tuple(_pooled(e, k, s)
                      for e, k, s in zip(thw_in, bs.kernel_q, bs.stride_q))
    Lq = int(np.prod(thw_q))
    Lk = L
    if _active(bs.kernel_kv, bs.stride_kv):
        Lk = int(np.prod(tuple(
            _pooled(e, k, s)
            for e, k, s in zip(thw_in, bs.kernel_kv, bs.stride_kv))))
    hidden = int(dim_att * spec.mlp_ratio)
    f = 2.0 * L * bs.dim * 3 * dim_att        # fused qkv
    f += 2.0 * Lq * Lk * dim_att * 2          # q k^T and attn v
    f += 2.0 * Lq * dim_att * dim_att         # attention projection
    f += 2.0 * Lq * dim_att * hidden          # fc1
    f += 2.0 * Lq * hidden * bs.dim_out       # fc2
    if expand:
        f += 2.0 * L * bs.dim * bs.dim_out    # the skip's expansion
    elif dim_att != bs.dim_out:
        f += 2.0 * Lq * dim_att * bs.dim_out  # the residual projection
    return f


def split_pp_stages(spec, n_stages: int) -> list:
    """``[lo, hi)`` block ranges of ``n_stages`` contiguous stages that
    minimise the largest stage's :func:`block_flops`."""
    depth = len(spec.blocks)
    if not 1 <= n_stages <= depth:
        raise ValueError(f"{n_stages} stages of {depth} blocks")
    sched = thw_schedule(spec)
    costs = [block_flops(spec, i, sched[i]) for i in range(depth)]
    prefix = np.concatenate([[0.0], np.cumsum(costs)])
    dp = np.full((n_stages + 1, depth + 1), np.inf)
    cut = np.full((n_stages + 1, depth + 1), -1, dtype=int)
    dp[0][0] = 0.0
    for s in range(1, n_stages + 1):
        for i in range(s, depth + 1):
            for j in range(s - 1, i):
                c = max(dp[s - 1][j], prefix[i] - prefix[j])
                if c < dp[s][i]:
                    dp[s][i] = c
                    cut[s][i] = j
    ranges = []
    i = depth
    for s in range(n_stages, 0, -1):
        j = int(cut[s][i])
        ranges.append((j, i))
        i = j
    return ranges[::-1]


_EMBED = ("patch_embed.", "pos_embed_spatial", "pos_embed_temporal",
          "pos_embed", "pos_embed_class", "cls_token")
_HEAD = ("norm.", "head.")


def stage_param_keys(spec, ranges, s: int) -> list:
    """The name prefixes of stage ``s``'s parameters."""
    keys = [f"blocks.{i}." for i in range(*ranges[s])]
    if s == 0:
        keys += list(_EMBED)
    if s == len(ranges) - 1:
        keys += list(_HEAD)
    return keys


def _in_stage(name: str, keys) -> bool:
    """Whether ``name`` falls under one of ``keys`` (a module prefix
    ending in ``.``, or a parameter's whole name)."""
    return any(name.startswith(k) if k.endswith(".") else name == k
               for k in keys)


def split_stage_params(state: dict, spec, ranges) -> list:
    """``state`` (a ``state_dict``) split into the stages' disjoint
    dicts, whose union is ``state``."""
    return [{k: v for k, v in state.items()
             if _in_stage(k, stage_param_keys(spec, ranges, s))}
            for s in range(len(ranges))]


def merge_stage_params(stage_params: list) -> dict:
    merged = {}
    for p in stage_params:
        merged.update(p)
    return merged


class MViTPipeline:
    """GPipe over ``devices`` (one a stage) of the port's ``model``.

    :meth:`apply`: inference logits (before the head's activation).
    :meth:`loss_and_grads`: the softmax cross entropy's mean over the
    batch, and each parameter's gradient in its ``.grad`` (on its stage's
    device), by the fill / drain schedule with each stage's forward run
    again in the backward sweep."""

    def __init__(self, model, devices, *, n_stages: int | None = None):
        n_stages = n_stages or len(devices)
        if len(devices) < n_stages:
            raise ValueError(f"{n_stages} stages on {len(devices)} devices")
        spec = model.spec
        if any(b.moe for b in spec.blocks):
            raise NotImplementedError(
                "MViTPipeline does not support MoE blocks; use data x "
                "expert parallelism")
        self.model, self.spec = model, spec
        self.devices = [torch.device(d) for d in devices][:n_stages]
        self.n_stages = n_stages
        self.ranges = split_pp_stages(spec, n_stages)
        self.sched = thw_schedule(spec)
        self.stage_params = []
        for s, dev in enumerate(self.devices):
            keys = stage_param_keys(spec, self.ranges, s)
            params = [(n, p) for n, p in model.named_parameters()
                      if _in_stage(n, keys)]
            for _, p in params:
                p.data = p.data.to(dev)
            self.stage_params.append(params)
        self.optimizers = None

    def _stage(self, s: int, carry, masks):
        """Stage ``s`` on its input (the clip on the first stage, else the
        tokens): the next stage's tokens, or the logits on the last."""
        model = self.model
        lo, hi = self.ranges[s]
        if s == 0:
            x, thw = model.embed(carry)
        else:
            x, thw = carry, self.sched[lo]
        for i in range(lo, hi):
            m = None if masks is None else (masks[i, 0], masks[i, 1])
            x, thw = model.blocks[i](x, thw, m)
        if s < self.n_stages - 1:
            return x
        if model.norm is not None:
            x = model.norm(x)
        feat = x[:, 0] if self.spec.cls_embed else x.mean(dim=1)
        return _linear(feat, model.head.projection)

    def _masks(self, generator, B: int):
        """Keep masks ``[depth, 2, B, 1, 1]`` (attention, MLP branch) of
        every block and sample of the batch, or None without DropPath."""
        rates = [b.drop_path for b in self.spec.blocks]
        if generator is None or not any(rates):
            return None
        keep = 1.0 - torch.tensor(rates)[:, None, None]
        draw = torch.rand((len(rates), 2, B), generator=generator)
        return (draw < keep).float()[..., None, None]

    def _to(self, t, s: int):
        return t.to(self.devices[s])

    @torch.no_grad()
    def apply(self, x, n_microbatches: int = 1) -> torch.Tensor:
        """Logits ``[B, classes]`` on the last stage's device."""
        self.model.eval()
        outs = []
        for xm in torch.tensor_split(x, n_microbatches):
            carry = self._to(xm, 0)
            for s in range(self.n_stages):
                carry = self._stage(s, carry, None)
                if s + 1 < self.n_stages:
                    carry = self._to(carry, s + 1)
            outs.append(carry)
        return torch.cat(outs)

    def loss_and_grads(self, x, labels, n_microbatches: int = 1,
                       droppath_generator: torch.Generator | None = None):
        """The batch's mean cross entropy; every parameter's ``.grad`` is
        set. DropPath acts where ``droppath_generator`` is given."""
        B, M, S = x.shape[0], n_microbatches, self.n_stages
        if B % M:
            raise ValueError(f"a batch of {B} in {M} microbatches")
        model = self.model
        model.train()
        for params in self.stage_params:
            for _, p in params:
                p.grad = None
        masks = self._masks(droppath_generator, B)
        dt = model.compute_dtype
        rows = [slice(m * (B // M), (m + 1) * (B // M)) for m in range(M)]

        def stage_masks(m, s):
            if masks is None:
                return None
            return self._to(masks[:, :, rows[m]], s).to(dt)

        inputs = [[None] * M for _ in range(S)]
        with torch.no_grad():  # fill: keep each stage's input
            for m in range(M):
                carry = self._to(x[rows[m]], 0)
                for s in range(S):
                    inputs[s][m] = carry
                    if s + 1 < S:
                        carry = self._to(self._stage(s, carry,
                                                     stage_masks(m, s)),
                                         s + 1)
        loss = torch.zeros((), device=self.devices[-1])
        for m in range(M):  # drain: run each stage again under autograd
            d = None
            for s in range(S - 1, -1, -1):
                inp = inputs[s][m]
                if s > 0:
                    inp = inp.detach().requires_grad_()
                out = self._stage(s, inp, stage_masks(m, s))
                if s == S - 1:
                    y = self._to(labels[rows[m]], s)
                    part = F.cross_entropy(out.float(), y.long()) / M
                    part.backward()
                    loss = loss + part.detach()
                else:
                    torch.autograd.backward(out, d)
                if s > 0:
                    d = self._to(inp.grad, s - 1)
        return loss

    def init_optimizer(self, make: Callable) -> None:
        """``make(parameters)`` -> a torch optimizer, one for each stage:
        its moments live on the stage's device."""
        self.optimizers = [make([p for _, p in params])
                           for params in self.stage_params]

    def opt_step(self, x, labels, n_microbatches: int = 1,
                 droppath_generator: torch.Generator | None = None):
        """One training step (forward, backward by recompute, each stage's
        optimizer); returns the batch's loss."""
        if self.optimizers is None:
            raise RuntimeError("call init_optimizer first")
        loss = self.loss_and_grads(x, labels, n_microbatches,
                                   droppath_generator)
        for opt in self.optimizers:
            opt.step()
        return loss

    def merged_params(self) -> dict:
        """The whole model's ``state_dict`` from the stages, on the host."""
        return merge_stage_params([
            {n: p.detach().cpu() for n, p in params}
            for params in self.stage_params])
