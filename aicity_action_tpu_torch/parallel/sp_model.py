"""Whole-model sequence parallelism for MViT (port of ``aicity_action_tpu/
parallel/sp_model.py``).

The forward runs with one axis of the token grid, H rows (``shard_axis
"h"``) or T frames (``"t"``), sharded over a mesh axis: h > 1 heads, cls
tokens, the real block schedule (q pooling, adaptive kv strides, channel
expansion in front or in the MLP) and the classification head. The
flagship 448 config shards H only 2-way (H = 112 against the first stage's
kv stride 8) but T up to 8-way through all 16 blocks (its temporal strides
are 1).

Where the JAX package writes the block again in plain ``jnp``
(``_sp_block``), the port drives its own ``MultiScaleBlock``'s submodules
on the local shard (:func:`sp_block`), so that the big early blocks run
the kernels on the card:

- norm1 + qkv through ``fused_ln_qkv`` on the local tokens;
- the pool convolutions (their weights on the channel-major ``[B, C, T,
  H_l, W]`` volumes) through ``sp.sp_pool_volume``'s halo exchanges;
- the pooled K / V gathered along the grid axis, then the module's fused
  or unfused attention (``MultiScaleAttention._fused`` / ``_unfused``):
  local queries against global keys;
- the skip max pool with ``-inf`` halos, then ``FusedMlp``.

The cls token is computed on every shard (it attends to the global keys).
Blocks run sharded while every shard holds whole pooling windows
(:func:`plan_sp_blocks`); at the first block where that fails the grid is
gathered once and the rest runs dense on every shard; where the plan
returns 0 the whole forward is dense. MoE blocks are refused: their
routing counts a sample's whole token set.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.heads import _linear
from ..models.mvit import _cast, _fuse_attn_ln_enabled
from ..ops.fused_dense import fused_ln_qkv
from .mesh import Mesh, axis_all_gather, axis_all_reduce
from .sp import sp_pool_volume


def _pooled(size: int, k: int, s: int) -> int:
    return (size + 2 * (k // 2) - k) // s + 1


def _axis_comp(shard_axis: str) -> int:
    """(T, H, W) component of the sharded grid axis."""
    if shard_axis not in ("t", "h"):
        raise ValueError(f"shard_axis is 't' or 'h', not {shard_axis!r}")
    return 0 if shard_axis == "t" else 1


def _strides_for(bs, comp: int):
    """``(stride_q, stride_kv, kernel_q, kernel_kv, skip kernel)`` of one
    block along grid component ``comp``, inactive pooling as 1."""

    def active(kernel, stride):
        return len(kernel) > 0 and not (
            np.prod(kernel) == 1 and np.prod(stride) == 1)

    sq = bs.stride_q[comp] if active(bs.kernel_q, bs.stride_q) else 1
    skv = bs.stride_kv[comp] if active(bs.kernel_kv, bs.stride_kv) else 1
    kq = bs.kernel_q[comp] if active(bs.kernel_q, bs.stride_q) else 1
    kkv = bs.kernel_kv[comp] if active(bs.kernel_kv, bs.stride_kv) else 1
    k_skip = sq + 1 if sq > 1 else 1
    return sq, skv, kq, kkv, k_skip


def plan_sp_blocks(spec, n_sp: int, shard_axis: str = "h") -> int:
    """How many leading blocks run sharded over ``n_sp`` shards of the
    grid's ``shard_axis``: each pooling needs the local extent divisible by
    its stride, odd kernels, and halos no wider than a shard (the JAX
    ``plan_sp_blocks``)."""
    comp = _axis_comp(shard_axis)
    E = spec.patch_dims[comp]
    n = 0
    for bs in spec.blocks:
        if E % n_sp:
            break
        El = E // n_sp
        sq, skv, kq, kkv, k_skip = _strides_for(bs, comp)
        if any(k % 2 == 0 for k in (kq, kkv, k_skip)):
            break
        if El % sq or El % skv:
            break
        if max(kq, kkv, k_skip) // 2 > El:
            break
        n += 1
        E = El // sq * n_sp
    return n


def dense_embed(model, x) -> tuple:
    """The patch embed and position embeddings, dense: ``(grid [B, T, H, W,
    D], cls [B, 1, D] or None)`` (the JAX ``dense_embed``)."""
    tokens, thw = model.embed(x)
    c = int(model.spec.cls_embed)
    grid = tokens[:, c:].reshape(tokens.shape[0], *thw, tokens.shape[-1])
    return grid, (tokens[:, :1] if c else None)


def _grid(x: torch.Tensor, c: int, thw) -> tuple:
    """Tokens ``[B, c + L, D]`` -> (cls rows, grid ``[B, T, H, W, D]``)."""
    return x[:, :c], x[:, c:].reshape(x.shape[0], *thw, x.shape[-1])


def _tokens(cls: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    flat = grid.reshape(grid.shape[0], -1, grid.shape[-1])
    return torch.cat([cls, flat], dim=1) if cls.shape[1] else flat


def _pool_grid(t: torch.Tensor, c: int, thw, m, axis, comp, mode, kernel,
               stride, weight=None, gather: bool = False):
    """A channel-major ``[B, C, c + L]`` tensor's grid pooled over the
    shards (and gathered along the grid axis where ``gather``), the cls
    column back in front; returns it flattened and the pooled local
    (T, H, W)."""
    B, C, _ = t.shape
    g = t[:, :, c:].reshape(B, C, *thw)
    if kernel is not None:
        g = sp_pool_volume(g, m, axis, mode=mode, kernel=kernel,
                           stride=stride, conv_weight=weight,
                           shard_dim=2 + comp)
    out_thw = tuple(g.shape[2:])
    if gather:
        g = axis_all_gather(g, m, axis, dim=2 + comp)
    g = g.flatten(2)
    return (torch.cat([t[:, :, :c], g], dim=2) if c else g), out_thw


def sp_block(blk, x: torch.Tensor, thw, m: Mesh, axis: str, comp: int):
    """One ``MultiScaleBlock`` (eval; no DropPath) on the local shard ``x
    [B, c + L_l, D]`` whose grid ``thw`` (local extents) is sharded on
    component ``comp``; returns the block's local output and its pooled
    local (T, H, W)."""
    attn = blk.attn
    c = int(attn.has_cls)
    B, Lt, D = x.shape
    dt = x.dtype
    n1 = blk.norm1
    t3 = dict(zip("qkv", fused_ln_qkv(
        x.reshape(B * Lt, D).contiguous(), n1.weight.to(dt), n1.bias.to(dt),
        attn.qkv.weight.to(dt), _cast(attn.qkv.bias, dt), n1.eps,
        tokens=Lt)))
    out_thw = thw
    for name in "qkv":
        kernel = stride = weight = None
        if name in attn.pooled:
            pool = getattr(attn, f"pool_{name}")
            if attn.mode == "conv":
                kernel, stride = pool.kernel_size, pool.stride
                weight = pool.weight.repeat(attn.num_heads, 1, 1, 1, 1)
            else:
                kernel, stride = pool
        t3[name], pooled = _pool_grid(t3[name], c, thw, m, axis, comp,
                                      attn.mode, kernel, stride, weight,
                                      gather=name != "q")
        if name == "q":
            out_thw = pooled
    if (attn.mode == "conv" and not attn.has_cls and attn.pooled
            and _fuse_attn_ln_enabled(blk.training)):
        out = attn._fused(t3, B, dt, x.device)
    else:
        out = attn._unfused(t3, B)
    out = F.linear(out, attn.proj.weight.to(dt), attn.proj.bias.to(dt))
    skip = x
    if blk.proj_max_pool is not None:
        skip = F.linear(skip, blk.proj_max_pool.weight.to(dt),
                        blk.proj_max_pool.bias.to(dt))
    if len(blk.kernel_skip) > 0 and np.prod(blk.kernel_skip) > 1:
        cls, g = _grid(skip, c, thw)
        g = sp_pool_volume(g.permute(0, 4, 1, 2, 3), m, axis, mode="max",
                           kernel=blk.kernel_skip, stride=blk.stride_skip,
                           shard_dim=2 + comp).permute(0, 2, 3, 4, 1)
        skip = _tokens(cls, g)
    x = skip + out
    if blk.proj is None:
        return x + blk.mlp(x, blk.norm2), out_thw
    xn = blk.norm2(x)
    return (F.linear(xn, blk.proj.weight.to(dt), blk.proj.bias.to(dt))
            + blk.mlp.dense(xn)), out_thw


def sp_forward(model, x, m: Mesh | None, axis: str | None,
               shard_axis: str = "h") -> torch.Tensor:
    """The MViT forward (eval, logits without the head's activation) with
    the grid's ``shard_axis`` sharded over ``m``'s ``axis``; every rank
    takes the whole clip ``x`` and returns the same logits. ``m`` None (or
    an axis of size 1) is the dense forward."""
    spec = model.spec
    comp = _axis_comp(shard_axis)
    n = m.size(axis) if m is not None else 1
    c = int(spec.cls_embed)
    x, thw = model.embed(x)
    n_shard = plan_sp_blocks(spec, n, shard_axis) if n > 1 else 0
    if n_shard:
        cls, g = _grid(x, c, thw)
        El = thw[comp] // n
        x = _tokens(cls, g.narrow(1 + comp, m.index(axis) * El, El))
        thw = tuple(El if i == comp else e for i, e in enumerate(thw))
    for i, blk in enumerate(model.blocks):
        if blk.moe:
            raise NotImplementedError(
                "sequence parallelism does not support MoE blocks")
        if n_shard and i == n_shard:
            # the geometry no longer keeps whole windows: gather, go dense
            cls, g = _grid(x, c, thw)
            g = axis_all_gather(g, m, axis, dim=1 + comp)
            x, thw = _tokens(cls, g), tuple(g.shape[1:4])
        if i < n_shard:
            x, thw = sp_block(blk, x, thw, m, axis, comp)
        else:
            x, thw = blk(x, thw)
    if model.norm is not None:
        x = model.norm(x)
    if c:
        feat = x[:, 0]
    elif n_shard == len(model.blocks):  # the mean over every shard's tokens
        feat = (axis_all_reduce(x.float().sum(1), m, axis)
                / (x.shape[1] * n)).to(x.dtype)
    else:
        feat = x.mean(dim=1)
    return _linear(feat, model.head.projection)


def sp_apply(model, x, m: Mesh, axis: str = "sp",
             shard_axis: str = "h") -> torch.Tensor:
    """:func:`sp_forward` of a classification MViT, refusing MoE blocks
    (their per-sample routing needs the whole token set; scale MoE with
    data x expert parallelism, ``parallel/ep.py``)."""
    if any(b.moe for b in model.spec.blocks):
        raise NotImplementedError(
            "sequence parallelism does not support MoE blocks")
    return sp_forward(model, x, m, axis, shard_axis)
