"""LayerNorm fused into the block's dense layers: hand-written CUDA kernels
and their plain versions.

- :func:`fused_ln_qkv` replaces ``aicity_action_tpu/ops/pallas/
  fused_dense.py:fused_ln_qkv`` (``_ln_qkv_kernel``): MViT's norm1 + qkv.
  At 448 it sees ``x [B*L, D]``, D in {96, 192, 384, 768}, 3C in {288, 576,
  1152, 2304}: 64-400 flops per byte, around the H100's ridge, so the narrow
  blocks are bound by memory and the wide ones by the tensor cores and the
  weight's re-reads from L2. The Pallas kernel keeps the whole ``[D, 3C]``
  weight in VMEM (3.5 MB at D=768, more than shared memory);
  ``csrc/fused_ln_qkv.cu`` runs a pre-pass for the LN statistics, then the
  Hopper mainloop of ``csrc/hopper.cuh`` over a 2-D queue of 128-row x
  TN-column tiles: TMA loads of raw x and weight chunks through an
  mbarrier ring, the LN applied to each A fragment in registers, ``wgmma``
  with A from registers, q, k, v written channel-major for the pool convs
  (TMA stores where a tile's rows lie in one clip).
- :func:`fused_ln_mlp` replaces ``fused_dense.py:fused_ln_mlp``
  (``_ln_mlp_kernel``): norm2 + fc1 + GELU + fc2, x ``[B*L, C]``, H = 4C.
  About 4C flops per byte, so the tensor cores bound it, and the weights'
  re-reads. Pallas holds both weights in VMEM (9.4 MB at C=768). The output
  accumulator sets the design: for C <= 192 one fused kernel keeps the
  hidden activation in registers (fc1's accumulator becomes fc2's A
  operand); for C >= 384 the statistics pre-pass and two launches of the
  same mainloop, LN + fc1 + GELU into a bf16 ``h [M, 4C]`` and ``h W2^T +
  b2``. GELU is the exact-erf form; the kernels take erf by the Pallas
  kernel's Abramowitz-Stegun formula (1.5e-7 from erf), the plain version
  by ``torch.erf``.

Tile widths, ring depths and grids are plans computed here
(:func:`_qkv_plan`, :func:`_mlp_plan`) and passed to the kernels as launch
arguments; a shape no plan takes raises ``ValueError``. Weights keep the
torch ``nn.Linear`` layout (``[out, in]``); products take bf16 and sum in
f32.

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

import functools

import torch

from . import kernels
from .layer_norm import layer_norm_plain

# widths the backward kernels have tile configurations for (D == C)
MLP_WIDTHS = (96, 192, 384, 768)

# The forward kernels' plans. Rows of a block tile (two consumer
# warpgroups of 64), the column tiles each kernel is compiled for (the
# wgmma widths of csrc/hopper.cuh), the ring depth (at least 3, at most
# MAX_STAGES of the 8 barriers) and the hidden chunk of the fused MLP.
ROW_TILE = 128
QKV_TILES = (192, 96)
FC_TILES = (192, 128)
FUSED_MLP_WIDTHS = (96, 192)
MIN_STAGES, MAX_STAGES = 3, 4
MLP_HC = 64
# a tile's fixed cost (statistics, epilogue, its A rows) in units of one
# column of TN, for choosing TN: rounds of the persistent grid x (TN + this)
TILE_OVERHEAD = 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _dense_smem(tn: int, stages: int, K: int, ln: bool) -> int:
    """``csrc/hopper.cuh:dense_smem_bytes``: alignment slack, the ring of
    ``[128][64]`` A and ``[tn][64]`` B chunks (and, with a LayerNorm, 1 KB
    of a tile's (mean, rstd)), the epilogue's staging (two consumers' tn x
    64 bf16), gamma / beta in f32, each consumer's f32 bias slice, the
    barriers."""
    stage = ROW_TILE * 128 + tn * 128 + (1024 if ln else 0)
    return (1024 + stages * stage + 2 * tn * 128
            + (8 * _cdiv(K, 64) * 64 if ln else 0) + 2 * tn * 4 + 2 * 8 * 8)


def _fused_mlp_smem(C: int, H: int, stages: int) -> int:
    """``csrc/fused_ln_mlp.cu:fused_mlp_smem_bytes``: slack, the x panel,
    the ring of W1 / W2 chunks, b1 and b2 in f32, the barriers."""
    kb = _cdiv(C, 64)
    return (1024 + kb * ROW_TILE * 128
            + stages * (kb * MLP_HC * 128 + C * 128) + (H + C) * 4
            + (2 * 8 + 2) * 8)


def _stages(smem) -> int:
    """The deepest ring up to MAX_STAGES that fits a block's shared memory
    (``smem(stages)`` in bytes); ValueError below MIN_STAGES."""
    for s in range(MAX_STAGES, MIN_STAGES - 1, -1):
        if smem(s) <= kernels.MAX_SMEM_BYTES:
            return s
    raise ValueError("no ring of at least 3 stages fits shared memory")


def _pick_tn(N: int, rows: int, tiles: tuple, sms: int) -> int:
    """The column tile for N outputs over ``rows``: among the compiled
    widths that divide N (all of them if none does), one whose tiles give
    every SM work if any does, then the one whose persistent grid finishes
    first, counting each block's rounds x (TN + TILE_OVERHEAD); ties go to
    the wider tile."""
    fits = [tn for tn in tiles if N % tn == 0] or list(tiles)
    row_tiles = _cdiv(rows, ROW_TILE)

    def key(tn):
        n = row_tiles * _cdiv(N, tn)
        return n < sms, _cdiv(n, sms) * (tn + TILE_OVERHEAD), -tn

    return min(fits, key=key)


def _tma(name: str, ld: int, box_rows: int) -> dict:
    """A TMA descriptor of a row-major bf16 matrix read in ``box_rows`` x 64
    boxes: its global stride must be a multiple of 16 bytes and a box at
    most 256 rows."""
    d = {"tensor": name, "stride_bytes": 2 * ld, "box": (box_rows, 64)}
    if d["stride_bytes"] % 16 or not 0 < box_rows <= 256:
        raise ValueError(f"{name}: a TMA descriptor needs a 16-byte row "
                         f"stride and at most 256 box rows, got {d}")
    return d


def _dense_plan(M: int, N: int, K: int, tiles: tuple, sms: int,
                ln: bool) -> dict:
    tn = _pick_tn(N, M, tiles, sms)
    stages = _stages(lambda s: _dense_smem(tn, s, K, ln))
    n_tiles = _cdiv(M, ROW_TILE) * _cdiv(N, tn)
    return {"tn": tn, "stages": stages, "tiles": n_tiles,
            "grid": max(1, min(n_tiles, sms)),
            "smem": _dense_smem(tn, stages, K, ln)}


@functools.lru_cache(maxsize=256)
def _qkv_plan(M: int, D: int, C: int, tokens: int, sms: int) -> dict:
    """Launch plan of ``csrc/fused_ln_qkv.cu`` for ``x [M, D]`` -> q, k, v
    ``[M / tokens, C, tokens]`` (after the LN statistics pre-pass):
    column tile ``tn``, ring ``stages``, persistent ``grid`` over
    ``tiles``, shared memory ``smem``, and the store: TMA stores where a
    consumer's 64 rows lie in one clip (tokens % 64 == 0), else 16-byte
    stores where every run of tokens is 16-byte aligned (tokens % 8 == 0),
    else 2-byte stores. A tile writes one of q, k, v: tn divides C."""
    if D % 16 or C % 8 or not 0 < D <= 768:
        raise ValueError(f"fused_ln_qkv: the kernel takes D % 16 == 0, "
                         f"D <= 768 and C % 8 == 0, got D={D}, C={C}")
    if tokens < 1 or M % tokens:
        raise ValueError(f"fused_ln_qkv: {M} rows are not clips of {tokens} "
                         "tokens")
    tiles = tuple(tn for tn in QKV_TILES if C % tn == 0)
    if not tiles:
        raise ValueError(f"fused_ln_qkv: no column tile of {QKV_TILES} "
                         f"divides C={C} (a tile writes one of q, k, v)")
    plan = _dense_plan(M, 3 * C, D, tiles, sms, ln=True)
    plan["store"] = ("tma" if tokens % 64 == 0 else
                     "vec16" if tokens % 8 == 0 else "scalar")
    plan["tma"] = [_tma("x", D, ROW_TILE), _tma("w", D, plan["tn"])]
    if plan["store"] == "tma":
        plan["tma"].append(_tma("q, k, v", tokens, plan["tn"]))
    return plan


@functools.lru_cache(maxsize=256)
def _mlp_plan(M: int, D: int, H: int, C: int, sms: int) -> dict:
    """Launch plan of ``csrc/fused_ln_mlp.cu``: for C <= 192 the fused
    kernel (``fused``: ring ``stages``, persistent ``grid`` over 128-row
    tiles, ``smem``), else the LN statistics pre-pass and two launches of
    the dense mainloop, ``fc1`` (LN + fc1 + GELU -> h) and ``fc2`` (h W2^T
    + b2), each a plan as :func:`_qkv_plan`'s."""
    if D != C or H % MLP_HC or C % 16 or not 0 < C <= 768:
        raise ValueError(
            f"fused_ln_mlp: the kernels take D == C, C % 16 == 0, C <= 768 "
            f"and H a multiple of {MLP_HC}, got D={D}, H={H}, C={C}")
    tma = [_tma("x", C, ROW_TILE)]
    if C <= 192:
        if C not in FUSED_MLP_WIDTHS:
            raise ValueError(f"fused_ln_mlp: the fused kernel is built for C "
                             f"in {FUSED_MLP_WIDTHS}, got C={C}")
        stages = _stages(lambda s: _fused_mlp_smem(C, H, s))
        tiles = _cdiv(M, ROW_TILE)
        return {"fused": True, "stages": stages, "tiles": tiles,
                "grid": max(1, min(tiles, sms)),
                "smem": _fused_mlp_smem(C, H, stages),
                "tma": tma + [_tma("w1", C, MLP_HC), _tma("w2", H, C)]}
    fc1 = _dense_plan(M, H, C, FC_TILES, sms, ln=True)
    fc2 = _dense_plan(M, C, H, FC_TILES, sms, ln=False)
    return {"fused": False, "fc1": fc1, "fc2": fc2,
            "tma": tma + [_tma("w1", C, fc1["tn"]), _tma("h", H, ROW_TILE),
                          _tma("w2", H, fc2["tn"]), _tma("h out", H, 64),
                          _tma("out", C, 64)]}


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


def _stats_scratch(M: int, dev) -> torch.Tensor:
    """The LN statistics pre-pass's (mean, rstd) rows, padded to whole
    128-row tiles."""
    return torch.empty((_cdiv(M, ROW_TILE) * ROW_TILE, 2),
                       dtype=torch.float32, device=dev)


def _ln_qkv_forward(x2, gamma, beta, w, bias, eps, tokens):
    M, D = x2.shape
    C3 = w.shape[0]
    C = C3 // 3
    if C3 % 3:
        raise ValueError(f"fused_ln_qkv: 3C={C3} is not a multiple of 3")
    dev = x2.device
    lib = kernels.lib()
    plan = _qkv_plan(M, D, C, tokens, kernels.sm_count(dev))
    if lib.aicity_ln_qkv_smem_bytes(D, plan["tn"], plan["stages"]) != \
            plan["smem"]:
        raise RuntimeError("fused_ln_qkv: the plan's shared memory differs "
                           "from the kernel's")
    kernels.require(x2, "x")
    kernels.require(gamma, "gamma", (D,), dev)
    kernels.require(beta, "beta", (D,), dev)
    kernels.require(w, "w", (C3, D), dev)
    if bias is not None:
        kernels.require(bias, "bias", (C3,), dev)
    q, k, v = (torch.empty((M // tokens, C, tokens), dtype=x2.dtype,
                           device=dev) for _ in range(3))
    stats = _stats_scratch(M, dev)
    err = lib.aicity_ln_qkv(
        x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
        kernels.ptr(bias), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kernels.ptr(stats), M, D, C, float(eps), tokens, plan["tn"],
        plan["stages"], plan["grid"], kernels.stream())
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
    dev = x2.device
    lib = kernels.lib()
    plan = _mlp_plan(M, D, H, C, kernels.sm_count(dev))
    launches = ([(0, 0, plan["stages"], plan["smem"])] if plan["fused"] else
                [(v, plan[f]["tn"], plan[f]["stages"], plan[f]["smem"])
                 for v, f in ((1, "fc1"), (2, "fc2"))])
    for variant, tn, stages, smem in launches:
        if lib.aicity_ln_mlp_smem_bytes(variant, C, H, tn, stages) != smem:
            raise RuntimeError("fused_ln_mlp: the plan's shared memory "
                               "differs from the kernel's")
    kernels.require(x2, "x")
    kernels.require(gamma, "gamma", (D,), dev)
    kernels.require(beta, "beta", (D,), dev)
    kernels.require(w1, "w1", (H, D), dev)
    kernels.require(b1, "b1", (H,), dev)
    kernels.require(w2, "w2", (C, H), dev)
    kernels.require(b2, "b2", (C,), dev)
    out = torch.empty((M, C), dtype=x2.dtype, device=dev)
    if plan["fused"]:
        h = stats = None
        first = second = plan
    else:  # the bf16 hidden activation between the two launches
        h = torch.empty((M, H), dtype=x2.dtype, device=dev)
        stats = _stats_scratch(M, dev)
        first, second = plan["fc1"], plan["fc2"]
    err = lib.aicity_ln_mlp(
        x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        kernels.ptr(h), kernels.ptr(stats), M, D, H, C, float(eps),
        int(plan["fused"]),
        first.get("tn", 0), first["stages"], first["grid"],
        second.get("tn", 0), second["stages"], second["grid"],
        kernels.stream())
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
    if not rows or C3 % 3 or C % 96 or tokens < 1 or M % tokens:
        raise ValueError(
            f"fused_ln_qkv_bwd: the kernels take D in {MLP_WIDTHS}, C a "
            f"multiple of 96 and whole clips, got D={D}, 3C={C3}, {M} rows "
            f"of {tokens} tokens")
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
