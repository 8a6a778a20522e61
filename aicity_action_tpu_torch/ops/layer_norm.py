"""Grouped LayerNorm: the hand-written CUDA kernels (forward and backward)
and their plain version.

Replaces ``aicity_action_tpu/ops/pallas/layer_norm.py:fused_layer_norm``
(``_ln_fwd_kernel`` and, under autograd, ``_ln_bwd_kernel``). At inference
it is MViT's final norm, ``[B*1568, 768]``, groups 1, eps 1e-6; in training
also the pooled q/k/v norms of every block (eps 1e-5 over head_dim 96). A
row LayerNorm moves 4 bytes per element (bf16 in and out) for ~8 flops, its
backward 6 for ~20, so the H100 bounds both by memory bandwidth. The kernels
(``csrc/layer_norm.cu``) use one warp per (row, group) segment; the
backward's dgamma / dbeta are summed per block and then over blocks in a
second pass (no atomics).
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
    through the kernel (bf16, contiguous), differentiable through
    :func:`fused_layer_norm_bwd`; a CPU tensor through the plain version,
    which autograd differentiates."""
    if not kernels.use_kernel(x):
        return layer_norm_plain(x, gamma, beta, eps, groups)
    return _FusedLayerNorm.apply(x, gamma, beta, eps, groups)


def _ln_forward(x, gamma, beta, eps, groups):
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


def fused_layer_norm_bwd(x: torch.Tensor, gamma: torch.Tensor,
                         dy: torch.Tensor, eps: float, groups: int = 1):
    """The backward kernel: ``(dx, dgamma, dbeta)`` of the grouped LN at
    ``x`` for the output gradient ``dy`` (dgamma / dbeta summed over every
    row and group, rounded to bf16 like the forward's params)."""
    C = x.shape[-1]
    if groups < 1 or C % groups:
        raise ValueError(f"fused_layer_norm_bwd: {C} channels in {groups} "
                         "groups")
    dg = C // groups
    dev = x.device
    kernels.require(x, "x")
    kernels.require(gamma, "gamma", (dg,), dev)
    kernels.require(dy, "dy", tuple(x.shape), dev)
    lib = kernels.lib()
    rows = x.numel() // C
    part = torch.empty((lib.aicity_layer_norm_bwd_blocks(rows, groups), 2, dg),
                       dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dgb = torch.empty((2, dg), dtype=x.dtype, device=dev)
    err = lib.aicity_layer_norm_bwd(
        x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dgb.data_ptr(), part.data_ptr(), rows, C, groups, float(eps),
        kernels.stream())
    kernels.check(err, "fused_layer_norm_bwd")
    fused_layer_norm_bwd.launches += 1
    return dx, dgb[0], dgb[1]


fused_layer_norm_bwd.launches = 0


class _FusedLayerNorm(torch.autograd.Function):
    """The kernels under autograd; saves ``(x, gamma)`` as the Pallas
    forward rule does."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, groups):
        ctx.save_for_backward(x, gamma)
        ctx.eps, ctx.groups = eps, groups
        return _ln_forward(x, gamma, beta, eps, groups)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgam, dbet = fused_layer_norm_bwd(x, gamma, dy.contiguous(),
                                              ctx.eps, ctx.groups)
        return dx, dgam, dbet, None, None
