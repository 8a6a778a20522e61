"""LayerNorm fused into the block's dense layers: hand-written CUDA kernels
and their plain versions.

- :func:`fused_ln_qkv` replaces ``aicity_action_tpu/ops/pallas/
  fused_dense.py:fused_ln_qkv`` (``_ln_qkv_kernel``): MViT's norm1 + qkv.
  At 448 it sees ``x [B*L, D]``, D in {96, 192, 384, 768}, 3C in {288, 576,
  1152, 2304}: 64-400 flops per byte, around the H100's ridge, so both the
  tensor cores and memory matter. The Pallas kernel keeps the whole
  ``[D, 3C]`` weight in VMEM (3.5 MB at D=768, more than shared memory);
  ``csrc/fused_ln_qkv.cu`` normalizes each 128-row tile once over the full
  D, streams the weight through shared memory in 64x64 tiles (cp.async,
  double-buffered) and writes q, k, v channel-major for the pool convs.
- :func:`fused_ln_mlp` replaces ``fused_dense.py:fused_ln_mlp``
  (``_ln_mlp_kernel``): norm2 + fc1 + GELU + fc2, x ``[B*L, C]``, H = 4C.
  About 4C flops per byte, so the tensor cores bound it. Pallas holds both
  weights in VMEM (9.4 MB at C=768); ``csrc/fused_ln_mlp.cu`` loops over
  hidden chunks streamed with cp.async, with an f32 output accumulator in
  registers whose size (row tile x C) sets the row tile per width, so the
  hidden activation never reaches device memory. GELU is the exact erf
  (the Pallas kernel's polynomial exists only because Mosaic has no erf).

Weights keep the torch ``nn.Linear`` layout (``[out, in]``); both kernels
take bf16 and accumulate in f32 on ``mma.sync`` tensor-core tiles.

In training both are ``torch.autograd.Function``s whose backward is a
kernel too: ``csrc/fused_ln_qkv_bwd.cu`` replaces ``_ln_qkv_bwd_kernel``
and ``csrc/fused_ln_mlp_bwd.cu`` replaces ``_ln_mlp_bwd_kernel`` /
``_ln_mlp_bwd_hsplit_kernel``. As the Pallas forward rules do, they save
only x and the parameters and recompute the LayerNorm (and, for the MLP,
fc1 and GELU) in the backward; their notes say how the weight gradients
are summed across blocks. On a CPU tensor each wrapper runs its plain
version, which autograd differentiates.
"""

from __future__ import annotations

import torch

from . import kernels
from .layer_norm import layer_norm_plain

# widths csrc/fused_ln_mlp.cu has a tile configuration for (D == C)
MLP_WIDTHS = (96, 192, 384, 768)


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    """erf-form GELU, torch's default (not the tanh approximation)."""
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def _dense_f32(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor | None) -> torch.Tensor:
    """``x w^T (+ b)`` of operands in the compute type, summed in f32."""
    y = x.float() @ w.float().t()
    return y if b is None else y + b.float()


def ln_qkv_plain(x2, gamma, beta, w, bias, eps, tokens):
    """``LN(x2) w^T + bias`` split into (q, k, v), each channel-major
    ``[M / tokens, C, tokens]``: LN with f32 statistics rounded to the
    compute type, products summed in f32."""
    xn = layer_norm_plain(x2, gamma, beta, eps)
    C = w.shape[0] // 3
    return tuple(
        _dense_f32(xn, w[i * C:(i + 1) * C],
                   None if bias is None else bias[i * C:(i + 1) * C]
                   ).to(x2.dtype)
        .reshape(-1, tokens, C).transpose(1, 2).contiguous()
        for i in range(3))


def fused_ln_qkv(x2, gamma, beta, w, bias, eps, tokens):
    """norm1 + qkv. ``x2 [M, D]`` holds clips of ``tokens`` token rows
    (M = B * tokens), ``gamma``/``beta [D]``, ``w [3C, D]``, ``bias [3C]``
    or None; returns (q, k, v), each a contiguous channel-major
    ``[B, C, tokens]``: the NCDHW layout the pool convolutions take."""
    if not kernels.use_kernel(x2):
        return ln_qkv_plain(x2, gamma, beta, w, bias, eps, tokens)
    return _LnQkv.apply(x2, gamma, beta, w, bias, eps, tokens)


def _ln_qkv_forward(x2, gamma, beta, w, bias, eps, tokens):
    M, D = x2.shape
    C3 = w.shape[0]
    C = C3 // 3
    if D % 16 or C3 % 3 or C % 8:
        raise ValueError(f"fused_ln_qkv: the kernel takes D % 16 == 0 and "
                         f"C % 8 == 0, got D={D}, 3C={C3}")
    if tokens < 1 or M % tokens:
        raise ValueError(f"fused_ln_qkv: {M} rows are not clips of {tokens} "
                         "tokens")
    lib = kernels.lib()
    if lib.aicity_ln_qkv_smem_bytes(D, C) > kernels.MAX_SMEM_BYTES:
        raise ValueError(f"fused_ln_qkv: D={D} needs more shared memory "
                         "than a block has")
    dev = x2.device
    kernels.require(x2, "x")
    kernels.require(gamma, "gamma", (D,), dev)
    kernels.require(beta, "beta", (D,), dev)
    kernels.require(w, "w", (C3, D), dev)
    if bias is not None:
        kernels.require(bias, "bias", (C3,), dev)
    q, k, v = (torch.empty((M // tokens, C, tokens), dtype=x2.dtype,
                           device=dev) for _ in range(3))
    err = lib.aicity_ln_qkv(
        x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
        kernels.ptr(bias), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        M, D, C, float(eps), tokens, kernels.stream())
    kernels.check(err, "fused_ln_qkv")
    fused_ln_qkv.launches += 1
    return q, k, v


fused_ln_qkv.launches = 0


def ln_mlp_plain(x2, gamma, beta, w1, b1, w2, b2, eps):
    """``fc2(gelu(fc1(LN(x2))))``: LN with f32 statistics, products summed
    in f32, the hidden activation rounded to the compute type."""
    xn = layer_norm_plain(x2, gamma, beta, eps)
    h = exact_gelu(_dense_f32(xn, w1, b1)).to(x2.dtype)
    return _dense_f32(h, w2, b2).to(x2.dtype)


def fused_ln_mlp(x2, gamma, beta, w1, b1, w2, b2, eps):
    """norm2 + MLP. ``x2 [M, D]``, ``w1 [H, D]``, ``b1 [H]``, ``w2 [C, H]``,
    ``b2 [C]``; returns ``[M, C]``."""
    if not kernels.use_kernel(x2):
        return ln_mlp_plain(x2, gamma, beta, w1, b1, w2, b2, eps)
    return _LnMlp.apply(x2, gamma, beta, w1, b1, w2, b2, eps)


def _ln_mlp_forward(x2, gamma, beta, w1, b1, w2, b2, eps):
    M, D = x2.shape
    H = w1.shape[0]
    C = w2.shape[0]
    lib = kernels.lib()
    if not lib.aicity_ln_mlp_supported(D, H, C):
        raise ValueError(
            f"fused_ln_mlp: the kernel has tiles for D == C in {MLP_WIDTHS} "
            f"(H a multiple of 64, or of 32 from C=384), got D={D}, H={H}, "
            f"C={C}")
    dev = x2.device
    kernels.require(x2, "x")
    kernels.require(gamma, "gamma", (D,), dev)
    kernels.require(beta, "beta", (D,), dev)
    kernels.require(w1, "w1", (H, D), dev)
    kernels.require(b1, "b1", (H,), dev)
    kernels.require(w2, "w2", (C, H), dev)
    kernels.require(b2, "b2", (C,), dev)
    out = torch.empty((M, C), dtype=x2.dtype, device=dev)
    err = lib.aicity_ln_mlp(
        x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        M, D, H, C, float(eps), kernels.stream())
    kernels.check(err, "fused_ln_mlp")
    fused_ln_mlp.launches += 1
    return out


fused_ln_mlp.launches = 0


def fused_ln_qkv_bwd(x2, gamma, beta, w, dq, dk, dv, eps, tokens):
    """The backward kernels of :func:`fused_ln_qkv`: ``(dx, dgamma, dbeta,
    dw, db)`` from the forward's inputs and the gradients of q, k, v in
    the layout the forward wrote them, channel-major ``[B, C, tokens]``.
    The weight / bias gradients are summed over row splits of f32 partials
    (:func:`kernels.splits`) and, like dgamma / dbeta, rounded to bf16."""
    M, D = x2.shape
    C3 = w.shape[0]
    C = C3 // 3
    lib = kernels.lib()
    rows = lib.aicity_ln_qkv_bwd_rows(D)
    if not rows or C3 % 3 or C % 96 or tokens % 8 or M % tokens:
        raise ValueError(
            f"fused_ln_qkv_bwd: the kernels take D in {MLP_WIDTHS}, C a "
            f"multiple of 96 and clips of a multiple of 8 tokens, got D={D}, "
            f"3C={C3}, {M} rows of {tokens} tokens")
    dev = x2.device
    kernels.require(x2, "x")
    kernels.require(gamma, "gamma", (D,), dev)
    kernels.require(beta, "beta", (D,), dev)
    kernels.require(w, "w", (C3, D), dev)
    for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        kernels.require(t, name, (M // tokens, C, tokens), dev)
    rps = kernels.splits(M, (C3 // 96) * (D // 96), 32)
    nsplit = -(-M // rps)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x2)
    dw = torch.empty_like(w)
    db = torch.empty((C3,), dtype=x2.dtype, device=dev)
    dgb = torch.empty((2, D), dtype=x2.dtype, device=dev)
    part = torch.empty((-(-M // rows), 2, D), **f32)
    stats = torch.empty((2, M), **f32)
    dw_part = torch.empty((nsplit, C3, D), **f32)
    db_part = torch.empty((nsplit, C3), **f32)
    err = lib.aicity_ln_qkv_bwd(
        x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), db.data_ptr(), dgb.data_ptr(), part.data_ptr(),
        stats.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(), M, D, C,
        float(eps), tokens, rps, kernels.stream())
    kernels.check(err, "fused_ln_qkv_bwd")
    fused_ln_qkv_bwd.launches += 1
    return dx, dgb[0], dgb[1], dw, db


fused_ln_qkv_bwd.launches = 0


class _LnQkv(torch.autograd.Function):
    """norm1 + qkv under autograd: saves x and the parameters, as the
    Pallas forward rule does, and recomputes the LN in the backward."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, w, bias, eps, tokens):
        ctx.save_for_backward(x2, gamma, beta, w)
        ctx.eps, ctx.tokens, ctx.has_bias = eps, tokens, bias is not None
        return _ln_qkv_forward(x2, gamma, beta, w, bias, eps, tokens)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        x2, gamma, beta, w = ctx.saved_tensors
        C = w.shape[0] // 3
        shape = (x2.shape[0] // ctx.tokens, C, ctx.tokens)
        grads = [torch.zeros(shape, dtype=x2.dtype, device=x2.device)
                 if g is None else g.contiguous() for g in (dq, dk, dv)]
        dx, dgam, dbet, dw, db = fused_ln_qkv_bwd(
            x2, gamma, beta, w, *grads, ctx.eps, ctx.tokens)
        return (dx, dgam, dbet, dw, db if ctx.has_bias else None, None,
                None)


def fused_ln_mlp_bwd(x2, gamma, beta, w1, b1, w2, dout, eps):
    """The backward kernels of :func:`fused_ln_mlp`: ``(dx, dgamma, dbeta,
    dw1, db1, dw2, db2)`` from the forward's inputs and the output gradient
    ``dout [M, C]``. The forward is recomputed per row tile and hidden
    chunk; weight gradients are summed over row splits of f32 partials
    (:func:`kernels.splits`) and rounded to bf16."""
    M, D = x2.shape
    H = w1.shape[0]
    C = w2.shape[0]
    lib = kernels.lib()
    rows = lib.aicity_ln_mlp_bwd_cfg(C, 0)
    if D != C or not rows or H % 64:
        raise ValueError(
            f"fused_ln_mlp_bwd: the kernels take D == C in {MLP_WIDTHS} and H "
            f"a multiple of 64, got D={D}, H={H}, C={C}")
    dev = x2.device
    kernels.require(x2, "x")
    kernels.require(gamma, "gamma", (D,), dev)
    kernels.require(beta, "beta", (D,), dev)
    kernels.require(w1, "w1", (H, D), dev)
    kernels.require(b1, "b1", (H,), dev)
    kernels.require(w2, "w2", (C, H), dev)
    kernels.require(dout, "dout", (M, C), dev)
    hc, step = lib.aicity_ln_mlp_bwd_cfg(C, 1), lib.aicity_ln_mlp_bwd_cfg(C, 2)
    rps = kernels.splits(M, H // hc, step)
    nsplit = -(-M // rps)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x2)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    db1 = torch.empty_like(b1)
    dgb = torch.empty((3, C), dtype=x2.dtype, device=dev)
    part = torch.empty((-(-M // rows), 3, C), **f32)
    dw1_part = torch.empty((nsplit, H, C), **f32)
    dw2_part = torch.empty((nsplit, C, H), **f32)
    db1_part = torch.empty((nsplit, H), **f32)
    err = lib.aicity_ln_mlp_bwd(
        x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), dout.data_ptr(), dx.data_ptr(),
        dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), dgb.data_ptr(),
        part.data_ptr(), dw1_part.data_ptr(), dw2_part.data_ptr(),
        db1_part.data_ptr(), M, C, H, float(eps), rps, kernels.stream())
    kernels.check(err, "fused_ln_mlp_bwd")
    fused_ln_mlp_bwd.launches += 1
    return dx, dgb[0], dgb[1], dw1, db1, dw2, dgb[2]


fused_ln_mlp_bwd.launches = 0


class _LnMlp(torch.autograd.Function):
    """norm2 + MLP under autograd: saves x and the parameters, as the
    Pallas forward rule does; the backward recomputes the forward."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, w1, b1, w2, b2, eps):
        ctx.save_for_backward(x2, gamma, beta, w1, b1, w2)
        ctx.eps = eps
        return _ln_mlp_forward(x2, gamma, beta, w1, b1, w2, b2, eps)

    @staticmethod
    def backward(ctx, dout):
        x2, gamma, beta, w1, b1, w2 = ctx.saved_tensors
        grads = fused_ln_mlp_bwd(x2, gamma, beta, w1, b1, w2,
                                 dout.contiguous(), ctx.eps)
        return (*grads, None)
