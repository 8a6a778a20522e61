"""Grouped LayerNorm: the hand-written CUDA kernel and its plain version.

Replaces ``aicity_action_tpu/ops/pallas/layer_norm.py:fused_layer_norm``
(``_ln_fwd_kernel``). On the main path it is MViT's final norm,
``[B*1568, 768]``, groups 1, eps 1e-6. A row LayerNorm moves 4 bytes per
element (bf16 in and out) for ~8 flops, so the H100 bounds it by memory
bandwidth; the kernel (``csrc/layer_norm.cu``) reads each segment once per
pass from L1 with one warp per (row, group) and writes it once.
"""

from __future__ import annotations

import torch

from . import kernels


def layer_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float, groups: int = 1) -> torch.Tensor:
    """Grouped LN over the trailing axis with f32 statistics: each
    ``C // groups`` channel group is normalized and scaled by the shared
    ``[C // groups]`` gamma / beta. Returns ``x``'s dtype."""
    C = x.shape[-1]
    xs = x.reshape(*x.shape[:-1], groups, C // groups).float()
    mu = xs.mean(-1, keepdim=True)
    xc = xs - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.reshape(x.shape).to(x.dtype)


def fused_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float, groups: int = 1) -> torch.Tensor:
    """Grouped LayerNorm (see :func:`layer_norm_plain`). A CUDA tensor goes
    through the kernel (bf16, contiguous); a CPU tensor through the plain
    version."""
    if not kernels.use_kernel(x):
        return layer_norm_plain(x, gamma, beta, eps, groups)
    C = x.shape[-1]
    if groups < 1 or C % groups:
        raise ValueError(f"fused_layer_norm: {C} channels in {groups} groups")
    dg = C // groups
    kernels.require(x, "x")
    kernels.require(gamma, "gamma", (dg,), x.device)
    kernels.require(beta, "beta", (dg,), x.device)
    y = torch.empty_like(x)
    err = kernels.lib().aicity_layer_norm(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        x.numel() // C, C, groups, float(eps), kernels.stream())
    kernels.check(err, "fused_layer_norm")
    fused_layer_norm.launches += 1
    return y


fused_layer_norm.launches = 0
