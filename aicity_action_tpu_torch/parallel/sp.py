"""Sequence (token-grid) parallelism for pooled attention (port of
``aicity_action_tpu/parallel/sp.py``).

One axis of the token grid, H rows or T frames, is sharded over a mesh
axis; every op stays local except two exchanges:

- the pooling convolutions and max pools read ``k // 2`` slices of the
  neighbouring shards (``mesh.halo_exchange``: zeros past the grid's edge
  for a convolution, ``-inf`` for a max pool), so a shard that holds whole
  pooling windows pools exactly as the dense op does;
- attention takes the local queries against the gathered pooled keys and
  values, which MViT's (1, s, s) kv strides keep small.

The port pools channel-major volumes ``[B, C, T, H, W]`` (the layout of
its pool convolutions, ``models/mvit.py``); ``sp_model.py`` runs whole
models on it. :func:`sp_pooled_attention` is the JAX package's one-block
demonstration (head count 1) in plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.pooling import pool3d_ncdhw
from .mesh import Mesh, axis_all_gather, halo_exchange  # noqa: F401


def sp_pool_volume(x: torch.Tensor, m: Mesh | None, axis: str | None, *,
                   mode: str, kernel, stride, conv_weight=None,
                   shard_dim: int = 3) -> torch.Tensor:
    """Pooling of a ``[B, C, T, H, W]`` volume whose ``shard_dim`` (3 = H
    rows, 2 = T frames) is sharded over ``axis``: a depthwise convolution
    (``conv_weight [C, 1, kT, kH, kW]``), a max or an average pool (the
    zero padding counted), padding ``k // 2``. The sharded dim's padding
    comes from the neighbours' halos; the local extent must divide by the
    stride there. ``m`` None is the dense op."""
    k = tuple(int(v) for v in kernel)
    s = tuple(int(v) for v in stride)
    pad = [v // 2 for v in k]
    if m is not None:
        if shard_dim not in (2, 3):
            raise ValueError(f"the grid's T or H dim, not {shard_dim}")
        j = shard_dim - 2
        if x.shape[shard_dim] % s[j]:
            raise ValueError(f"a shard of {x.shape[shard_dim]} rows does "
                             f"not hold whole windows of stride {s[j]}")
        if pad[j]:
            fill = float("-inf") if mode == "max" else 0.0
            above, below = halo_exchange(x, m, axis, shard_dim, pad[j],
                                         fill)
            x = torch.cat([above, x, below], dim=shard_dim)
        pad[j] = 0
    if mode == "conv":
        return F.conv3d(x, conv_weight.to(x.dtype), None, s, tuple(pad), 1,
                        x.shape[1])
    if mode not in ("max", "avg"):
        raise ValueError(f"unknown pool mode {mode!r}")
    if m is None:
        return pool3d_ncdhw(x, mode, k, s, pad)
    if mode == "max":
        return F.max_pool3d(x, k, s, tuple(pad))
    x = F.pad(x, (pad[2], pad[2], pad[1], pad[1], pad[0], pad[0]))
    return F.avg_pool3d(x, k, s, 0)


def sp_depthwise_pool(x: torch.Tensor, weight: torch.Tensor, stride_hw: int,
                      m: Mesh, axis: str) -> torch.Tensor:
    """H-sharded depthwise 3x3x3 convolution of ``[B, C, T, H_l, W]``
    (stride ``(1, s, s)``, padding 1): the JAX ``sp_depthwise_pool``."""
    return sp_pool_volume(x, m, axis, mode="conv", kernel=(3, 3, 3),
                          stride=(1, stride_hw, stride_hw),
                          conv_weight=weight, shard_dim=3)


def sp_pooled_attention(x: torch.Tensor, params: dict, m: Mesh, axis: str,
                        *, stride_q: int = 1, stride_kv: int = 8,
                        ln_eps: float = 1e-6,
                        pool_ln_eps: float = 1e-5) -> torch.Tensor:
    """One sequence-parallel pooled-attention block with one head (the
    shape of MViT's block 0) on the local H shard ``x [B, T, H_l, W, C]``
    (the JAX ``sp_pooled_attention``, plain PyTorch): LN, qkv, the three
    depthwise pools with their LNs (halo exchanges), attention of the local
    queries against the gathered pooled keys and values, the q residual
    and the projection. ``params`` in torch's layout: ``ln_weight``,
    ``ln_bias``, ``qkv_weight [3C, C]``, ``qkv_bias``, ``pool_{q,k,v}
    [C, 1, 3, 3, 3]``, ``norm_{q,k,v}_{weight,bias}``, ``proj_weight``,
    ``proj_bias``. Returns the local ``[B, T, Hq_l, Wq, C]``."""
    B, T, _, _, C = x.shape

    def ln(t, w, b, eps):
        return F.layer_norm(t.float(), (C,), w.float(), b.float(),
                            eps).to(t.dtype)

    q, k, v = F.linear(ln(x, params["ln_weight"], params["ln_bias"], ln_eps),
                       params["qkv_weight"],
                       params.get("qkv_bias")).chunk(3, dim=-1)

    def pool_norm(t, name, s):
        p = sp_depthwise_pool(t.permute(0, 4, 1, 2, 3), params[f"pool_{name}"],
                              s, m, axis).permute(0, 2, 3, 4, 1)
        return ln(p, params[f"norm_{name}_weight"],
                  params[f"norm_{name}_bias"], pool_ln_eps)

    q = pool_norm(q, "q", stride_q)
    k = axis_all_gather(pool_norm(k, "k", stride_kv), m, axis, dim=2)
    v = axis_all_gather(pool_norm(v, "v", stride_kv), m, axis, dim=2)
    Hq, Wq = q.shape[2], q.shape[3]
    qf, kf, vf = (t.reshape(B, -1, C) for t in (q, k, v))
    attn = torch.softmax(qf.float() @ kf.float().transpose(1, 2)
                         * C ** -0.5, dim=-1)
    out = (attn @ vf.float()).to(x.dtype) + qf
    out = F.linear(out, params["proj_weight"], params["proj_bias"])
    return out.reshape(B, T, Hq, Wq, C)
