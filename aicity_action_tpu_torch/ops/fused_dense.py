"""LayerNorm fused into the block's dense layers: hand-written CUDA kernels
and their plain versions.

- :func:`fused_ln_qkv` replaces ``aicity_action_tpu/ops/pallas/
  fused_dense.py:fused_ln_qkv`` (``_ln_qkv_kernel``): MViT's norm1 + qkv.
  At 448 it sees ``x [B*L, D]``, D in {96, 192, 384, 768}, 3C in {288, 576,
  1152, 2304} (MViT-v2-B; MViT-v2-L: D in {144, 288, 576, 1152}, 3C in
  {432, 864, 1728, 3456}, the 144-wide q, k, v on a 144-column tile):
  64-400 flops per byte, around the H100's ridge, so the narrow blocks
  are bound by memory and the wide ones by the tensor cores and the
  weight's re-reads from L2. The Pallas kernel keeps the whole ``[D, 3C]``
  weight in VMEM (3.5 MB at D=768, more than shared memory);
  ``csrc/fused_ln_qkv.cu`` runs a pre-pass for the LN statistics, then the
  Hopper mainloop of ``csrc/hopper.cuh`` over a 2-D queue of 128-row x
  TN-column tiles: TMA loads of raw x and weight chunks through an
  mbarrier ring, the LN applied to each A fragment in registers, ``wgmma``
  with A from registers, q, k, v written channel-major for the pool convs
  (TMA stores where a tile's rows lie in one clip).
- :func:`fused_ln_mlp` replaces ``fused_dense.py:fused_ln_mlp``
  (``_ln_mlp_kernel``): norm2 + fc1 + GELU + fc2, x ``[B*L, C]``, H = 4C,
  C from 96 to 1152 (MViT-v2-L's last four blocks, which the JAX package
  leaves to XLA, take the two-launch path: one branch for every block).
  About 4C flops per byte, so the tensor cores bound it, and the weights'
  re-reads. Pallas holds both weights in VMEM (9.4 MB at C=768). The output
  accumulator sets the design: for C in {96, 144, 192} one fused kernel
  keeps the hidden activation in registers (fc1's accumulator becomes
  fc2's A operand); for C >= 288 the statistics pre-pass and two launches
  of the same mainloop, LN + fc1 + GELU into a bf16 ``h [M, 4C]`` and
  ``h W2^T + b2``. GELU is the exact-erf form; the kernels take erf by
  the Pallas kernel's Abramowitz-Stegun formula (1.5e-7 from erf), the
  plain version by ``torch.erf``.

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
fc1 and GELU) in the backward. Both backwards run on the same Hopper
mainloop: an LN pre-pass that also writes the copies the products read
(for the qkv, the gradients of q, k, v token-major and packed
channel-major), ``dxn`` (for the MLP after a dual GEMM with a
GELU-backward epilogue that stores the hidden activations once), the LN
backward over rows and split-K weight gradients (:func:`_qkv_bwd_plan`,
:func:`_mlp_bwd_plan`); their notes say how the weight gradients are
summed across blocks. On a CPU tensor each wrapper runs its
plain version, which autograd differentiates.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import kernels
from .layer_norm import layer_norm_plain

# The forward kernels' plans. Rows of a block tile (two consumer
# warpgroups of 64), the column tiles each kernel is compiled for (the
# wgmma widths of csrc/hopper.cuh), the ring depth (at least 3, at most
# MAX_STAGES of the 8 barriers) and the hidden chunk of the fused MLP.
ROW_TILE = 128
QKV_TILES = (192, 144, 96)
FC_TILES = (192, 128)
FUSED_MLP_WIDTHS = (96, 144, 192)
# the widest LayerNorm'd input of the forwards (csrc/hopper.cuh:
# DENSE_MAX_LN_K): MViT-v2-L's 1152
MAX_LN_WIDTH = 1152
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


def _tma(name: str, ld: int, box_rows: int, box_cols: int = 64) -> dict:
    """A TMA descriptor of a row-major bf16 matrix read in ``box_rows`` x 64
    boxes with the 128-byte swizzle (or, with ``box_cols``, stored from
    unswizzled ``box_rows`` x ``box_cols`` boxes): its global stride must be
    a multiple of 16 bytes, a box at most 256 rows and columns, and a box
    row whole 16 bytes."""
    d = {"tensor": name, "stride_bytes": 2 * ld, "box": (box_rows, box_cols),
         "swizzle": 128 if box_cols == 64 else 0}
    if (d["stride_bytes"] % 16 or not 0 < box_rows <= 256
            or not 0 < box_cols <= 256 or 2 * box_cols % 16):
        raise ValueError(f"{name}: a TMA descriptor needs a 16-byte row "
                         f"stride, at most 256 box rows and columns and "
                         f"16-byte box rows, got {d}")
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
    if D % 16 or C % 8 or not 0 < D <= MAX_LN_WIDTH:
        raise ValueError(f"fused_ln_qkv: the kernel takes D % 16 == 0, "
                         f"D <= {MAX_LN_WIDTH} and C % 8 == 0, got D={D}, "
                         f"C={C}")
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
    kernel (``fused``, C in FUSED_MLP_WIDTHS: ring ``stages``, persistent
    ``grid`` over 128-row tiles, ``smem``), else (C up to MAX_LN_WIDTH) the
    LN statistics pre-pass and two launches of the dense mainloop, ``fc1``
    (LN + fc1 + GELU -> h) and ``fc2`` (h W2^T + b2), each a plan as
    :func:`_qkv_plan`'s."""
    if D != C or H % MLP_HC or C % 16 or not 0 < C <= MAX_LN_WIDTH:
        raise ValueError(
            f"fused_ln_mlp: the kernels take D == C, C % 16 == 0, C <= "
            f"{MAX_LN_WIDTH} and H a multiple of {MLP_HC}, got D={D}, H={H}, "
            f"C={C}")
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


# The LN+MLP backward's plan (csrc/fused_ln_mlp_bwd.cu). The dual GEMM's
# hidden tile (two f32 accumulators of 64 x 128 a consumer; 64 where 128
# does not divide H, MViT-v2-L's H = 576) and its least ring (three stages
# of 64 KB fit beside the staging boxes); rows of a pre-pass block;
# LN-backward blocks per SM (each warp at least one row); the split-K
# weight gradients' least rows a split (eight 64-deep chunks, so a split's
# f32 store stays a small share of its loads).
MLP_BWD_TN, MLP_BWD_NARROW_TN = 128, 64
MLP_BWD_MIN_STAGES = 3
PREP_ROWS = 32
LN_BWD_WARPS = 8
LN_BWD_BLOCKS_PER_SM = 4
SPLIT_MIN_ROWS = 512
# the split-K cost model: a tile's fixed cost (pipeline fill, epilogue) in
# chunks, and the bytes of f32 partials (written, then read) the card moves
# in one chunk's time (3.35 TB/s x ~0.65 us, a 64-deep chunk of a 128 x 128
# tile loaded from L2 on one SM)
SPLIT_TILE_CHUNKS = 3
SPLIT_PARTIAL_BYTES = 2.2e6


def _dual_smem(tn: int, stages: int) -> int:
    """``csrc/fused_ln_mlp_bwd.cu:dual_smem_bytes``: slack, the ring of xn
    and dout ``[128][64]`` and W1 and W2^T ``[tn][64]`` chunks, each
    consumer's staging box, each consumer's b1 slice in f32, the
    barriers."""
    return (1024 + stages * (2 * ROW_TILE * 128 + 2 * tn * 128)
            + 2 * tn * 128 + 2 * tn * 4 + 2 * 8 * 8)


def _split_plan(rows: int, N: int, K: int, sms: int) -> dict:
    """A split-K launch of the dense mainloop for an f32 ``[rows, N]``
    product summed over K: the dense plan of its tiles, K cut into
    ``splits`` runs of ``chunks`` whole 64-deep chunks (``split_rows``
    rows, at least SPLIT_MIN_ROWS unless K is shorter), every split a tile
    of the persistent queue. The splits minimize an estimate of the time,
    in units of one chunk's loads on one SM: the grid's rounds times the
    chunks (and a tile's fixed cost) each tile walks, plus writing and
    summing each split's f32 partial; first among the splits that give
    every SM a tile, if any do, and ties to fewer splits."""
    p = _dense_plan(rows, N, K, FC_TILES, sms, ln=False)
    nk = _cdiv(K, 64)
    most = max(1, nk // (SPLIT_MIN_ROWS // 64))

    def cost(s):
        chunks = _cdiv(nk, s)
        s = _cdiv(nk, chunks)
        rounds = _cdiv(p["tiles"] * s, sms)
        return (p["tiles"] * s < sms, rounds * (chunks + SPLIT_TILE_CHUNKS)
                + s * rows * N * 8 / SPLIT_PARTIAL_BYTES, s)

    best = min(range(1, most + 1), key=cost)
    chunks = _cdiv(nk, best)
    splits = _cdiv(nk, chunks)
    tiles = p["tiles"] * splits
    p.update(split_rows=64 * chunks, chunks=chunks, splits=splits,
             tiles=tiles, grid=max(1, min(tiles, sms)))
    return p


def _workspace(sizes: tuple) -> dict:
    """Byte offsets of scratch tensors of ``sizes`` bytes in one workspace,
    each 256-byte aligned."""
    offsets, end = [], 0
    for n in sizes:
        offsets.append(end)
        end += _cdiv(n, 256) * 256
    return {"offsets": tuple(offsets), "sizes": sizes, "bytes": end}


def _ln_bwd_blocks(M: int, sms: int) -> dict:
    """The LN backward over rows: ``blocks`` of ``rows`` contiguous rows,
    each warp at least one row, at most LN_BWD_BLOCKS_PER_SM a SM."""
    blocks = min(_cdiv(M, LN_BWD_WARPS), LN_BWD_BLOCKS_PER_SM * sms)
    rows = _cdiv(M, blocks)
    return {"rows": rows, "blocks": _cdiv(M, rows)}


@functools.lru_cache(maxsize=256)
def _mlp_bwd_plan(M: int, C: int, H: int, sms: int) -> dict:
    """Launch plan of ``csrc/fused_ln_mlp_bwd.cu`` for ``x [M, C]``, hidden
    H: ``ld``, the row stride of the channel-major copies (M rounded up to
    8: TMA strides are whole 16 bytes); ``prep`` (32-row blocks), ``dual``
    (the dual GEMM: tile, ring, persistent grid over 128-row x ``tn``-hidden
    tiles, ``tn`` 128, or 64 where 128 does not divide H), ``dxn`` (a dense
    plan, K = H), ``ln`` (blocks of ``rows``
    rows), ``dw1`` and ``dw2`` (split-K plans, K = M), and every TMA
    descriptor; ``scratch``, the byte offsets of the scratch tensors in
    one workspace, and ``ints``, the plan as the C entry point reads it."""
    if (M < 1 or C % 8 or not 0 < C <= MAX_LN_WIDTH
            or H % MLP_BWD_NARROW_TN):
        raise ValueError(
            f"fused_ln_mlp_bwd: the kernels take M >= 1, C % 8 == 0, C <= "
            f"{MAX_LN_WIDTH} and H a multiple of {MLP_BWD_NARROW_TN}, got "
            f"M={M}, C={C}, H={H}")
    ld = _cdiv(M, 8) * 8
    tn = MLP_BWD_TN if H % MLP_BWD_TN == 0 else MLP_BWD_NARROW_TN
    stages = next((s for s in range(MAX_STAGES, MLP_BWD_MIN_STAGES - 1, -1)
                   if _dual_smem(tn, s) <= kernels.MAX_SMEM_BYTES), None)
    if stages is None:
        raise ValueError("fused_ln_mlp_bwd: no dual-GEMM ring fits")
    dual_tiles = _cdiv(M, ROW_TILE) * (H // tn)
    plan = {
        "ld": ld,
        "prep": {"blocks": _cdiv(M, PREP_ROWS),
                 "smem": PREP_ROWS * (C + 8) * 2},
        "dual": {"tn": tn, "stages": stages, "tiles": dual_tiles,
                 "grid": max(1, min(dual_tiles, sms)),
                 "smem": _dual_smem(tn, stages)},
        "dxn": _dense_plan(M, C, H, FC_TILES, sms, ln=False),
        "ln": _ln_bwd_blocks(M, sms),
        "dw1": _split_plan(H, C, M, sms),  # dhp^T xn
        "dw2": _split_plan(C, H, M, sms),  # dout^T h
    }
    # one workspace of scratch, in the C entry point's order: W1^T, W2^T,
    # the statistics, xn, xn^T, dout^T, h^T, dhp^T, dhp, dxn (f32), the
    # partials of db1, of (dgamma, dbeta, db2), of dW1, of dW2 (f32)
    plan["scratch"] = _workspace((
        2 * C * H, 2 * H * C, 8 * _cdiv(M, ROW_TILE) * ROW_TILE, 2 * M * C,
        2 * C * ld, 2 * C * ld, 2 * H * ld, 2 * H * ld, 2 * M * H, 4 * M * C,
        4 * 2 * plan["dual"]["grid"] * H, 4 * plan["ln"]["blocks"] * 3 * C,
        4 * plan["dw1"]["splits"] * H * C,
        4 * plan["dw2"]["splits"] * C * H))
    plan["ints"] = (ld, stages, plan["dual"]["grid"], plan["dxn"]["tn"],
                    plan["dxn"]["stages"], plan["dxn"]["grid"],
                    plan["ln"]["blocks"], plan["ln"]["rows"]) + tuple(
        plan[k][f] for k in ("dw1", "dw2")
        for f in ("tn", "stages", "grid", "splits", "chunks"))
    plan["tma"] = [
        _tma("xn", C, ROW_TILE), _tma("dout", C, ROW_TILE),
        _tma("w1", C, tn), _tma("w2^T", C, tn),
        _tma("h^T store", ld, tn), _tma("dhp^T store", ld, tn),
        _tma("dhp store", H, 64), _tma("dhp", H, ROW_TILE),
        _tma("w1^T", H, plan["dxn"]["tn"]),
        _tma("dhp^T", ld, ROW_TILE), _tma("xn^T", ld, plan["dw1"]["tn"]),
        _tma("dout^T", ld, ROW_TILE), _tma("h^T", ld, plan["dw2"]["tn"])]
    return plan


# The LN+qkv backward's plan (csrc/fused_ln_qkv_bwd.cu): the gradients'
# pass takes 96-channel chunks of the 3C (the last one ragged where 96 does
# not divide 3C, MViT-v2-L's 432), each over 128-token tiles, and aims at
# this many blocks a SM (persistent blocks over the tiles, so that db has
# few partials)
QKV_GRAD_GC, QKV_GRAD_TOKENS = 96, 128
QKV_GRAD_BLOCKS_PER_SM = 8


def _qkv_grad_smem() -> int:
    """``csrc/fused_ln_qkv_bwd.cu:qkv_grad_smem_bytes``: the [channel][token]
    tile (rows of 130), alignment slack, the [token][channel] box."""
    return (QKV_GRAD_GC * (QKV_GRAD_TOKENS + 2) * 2 + 1024
            + QKV_GRAD_TOKENS * QKV_GRAD_GC * 2)


@functools.lru_cache(maxsize=256)
def _qkv_bwd_plan(M: int, D: int, C: int, tokens: int, sms: int) -> dict:
    """Launch plan of ``csrc/fused_ln_qkv_bwd.cu`` for ``x [M, D]`` and the
    gradients of q, k, v ``[M / tokens, C, tokens]``: ``ld``, the row
    stride of the channel-major copies (M rounded up to 8: TMA strides are
    whole 16 bytes); ``prep`` (the x pre-pass, 32-row blocks), ``grad``
    (the gradients' pass: ``blocks`` over the tokens for each of the
    ``chunks`` of 96 channels, the last partial where 96 does not divide
    3C), ``dxn`` (a dense plan, K = 3C), ``ln``
    (blocks of ``rows`` rows), ``dw`` (a split-K plan, K = M; its A read in
    place from q, k, v where tokens % 64 == 0, else from a packed copy),
    and every TMA descriptor; ``scratch``, the byte offsets of the scratch
    tensors in one workspace, and ``ints``, the plan as the C entry point
    reads it."""
    if (M < 1 or D % 8 or not 0 < D <= MAX_LN_WIDTH or C < 1 or C % 8
            or tokens < 1 or M % tokens):
        raise ValueError(
            f"fused_ln_qkv_bwd: the kernels take D % 8 == 0, D <= "
            f"{MAX_LN_WIDTH}, C % 8 == 0 and whole clips, got D={D}, C={C}, "
            f"{M} rows of {tokens} tokens")
    ld = _cdiv(M, 8) * 8
    N3 = 3 * C
    chunks = _cdiv(N3, QKV_GRAD_GC)
    grad_blocks = max(1, min(_cdiv(M, QKV_GRAD_TOKENS),
                             QKV_GRAD_BLOCKS_PER_SM * sms // chunks))
    plan = {
        "ld": ld,
        "prep": {"blocks": _cdiv(M, PREP_ROWS),
                 "smem": PREP_ROWS * (D + 8) * 2},
        "grad": {"blocks": grad_blocks, "chunks": chunks,
                 "smem": _qkv_grad_smem()},
        "dxn": _dense_plan(M, D, N3, FC_TILES, sms, ln=False),  # g W
        "ln": _ln_bwd_blocks(M, sms),
        "dw": _split_plan(N3, D, M, sms),  # G^T xn
    }
    # dW reads q, k, v in place where a 64-token chunk lies in one clip, in
    # boxes of the most rows (of 128, 64, 32, 16, 8: whole 1024-byte swizzle
    # atoms that tile a 128-row box) that divide C (a box lies in one of q,
    # k, v; MViT-v2-L's C = 144 takes 16)
    in_place = tokens % 64 == 0
    box = (next(b for b in (128, 64, 32, 16, 8) if C % b == 0) if in_place
           else 0)
    # one workspace of scratch, in the C entry point's order: W^T, the
    # statistics, xn^T, g, g^T (none where dW reads q, k, v in place), dxn
    # (f32), the partials of db, of (dgamma, dbeta), of dW (f32)
    plan["scratch"] = _workspace((
        2 * D * N3, 8 * _cdiv(M, ROW_TILE) * ROW_TILE, 2 * D * ld,
        2 * M * N3, 0 if in_place else 2 * N3 * ld, 4 * M * D,
        4 * grad_blocks * N3, 4 * plan["ln"]["blocks"] * 2 * D,
        4 * plan["dw"]["splits"] * N3 * D))
    dxn, dw = plan["dxn"], plan["dw"]
    plan["ints"] = (ld, grad_blocks, dxn["tn"], dxn["stages"], dxn["grid"],
                    plan["ln"]["blocks"], plan["ln"]["rows"]) + tuple(
        dw[f] for f in ("tn", "stages", "grid", "splits", "chunks")) + (box,)
    plan["tma"] = [_tma("g", N3, ROW_TILE), _tma("w^T", N3, dxn["tn"]),
                   _tma("q, k, v", tokens, box) if in_place
                   else _tma("g^T", ld, ROW_TILE),
                   _tma("xn^T", ld, dw["tn"]),
                   _tma("g store", N3, QKV_GRAD_TOKENS, QKV_GRAD_GC)]
    return plan


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
    if torch.compiler.is_exporting():
        return tuple(_LN_QKV_OP(x2, gamma, beta, w, bias, eps, tokens))
    if not kernels.use_kernel(x2):
        return ln_qkv_plain(x2, gamma, beta, w, bias, eps, tokens)
    return _LnQkv.apply(x2, gamma, beta, w, bias, eps, tokens)


def _ln_qkv_fake(x2, gamma, beta, w, bias, eps, tokens):
    shape = (x2.shape[0] // tokens, w.shape[0] // 3, tokens)
    return tuple(x2.new_empty(shape) for _ in range(3))


_LN_QKV_OP = kernels.export_op(
    "ln_qkv", "(Tensor x2, Tensor gamma, Tensor beta, Tensor w, Tensor? "
    "bias, float eps, int tokens) -> (Tensor, Tensor, Tensor)",
    fused_ln_qkv, _ln_qkv_fake)


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
    if torch.compiler.is_exporting():
        return _LN_MLP_OP(x2, gamma, beta, w1, b1, w2, b2, eps)
    if not kernels.use_kernel(x2):
        return ln_mlp_plain(x2, gamma, beta, w1, b1, w2, b2, eps)
    return _LnMlp.apply(x2, gamma, beta, w1, b1, w2, b2, eps)


_LN_MLP_OP = kernels.export_op(
    "ln_mlp", "(Tensor x2, Tensor gamma, Tensor beta, Tensor w1, Tensor b1, "
    "Tensor w2, Tensor b2, float eps) -> Tensor", fused_ln_mlp,
    lambda x2, gamma, beta, w1, b1, w2, b2, eps: x2.new_empty(
        (x2.shape[0], w2.shape[0])))


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


@functools.lru_cache(maxsize=256)
def _checked_qkv_bwd_plan(M: int, D: int, C: int, tokens: int,
                          sms: int) -> dict:
    """:func:`_qkv_bwd_plan`, its shared memory held once against the
    kernels' own."""
    plan = _qkv_bwd_plan(M, D, C, tokens, sms)
    smem = kernels.lib().aicity_ln_qkv_bwd_smem_bytes
    launches = [(1, plan[k]["tn"], plan[k]["stages"], plan[k]["smem"])
                for k in ("dxn", "dw")] + [(2, 0, 0, plan["prep"]["smem"]),
                                           (3, 0, 0, plan["grad"]["smem"])]
    for variant, tn, stages, want in launches:
        if smem(variant, D, tn, stages) != want:
            raise RuntimeError("fused_ln_qkv_bwd: the plan's shared memory "
                               "differs from the kernel's")
    return plan


def fused_ln_qkv_bwd(x2, gamma, beta, w, dq, dk, dv, eps, tokens):
    """The backward kernels of :func:`fused_ln_qkv`: ``(dx, dgamma, dbeta,
    dw, db)`` from the forward's inputs and the gradients of q, k, v in
    the layout the forward wrote them, channel-major ``[B, C, tokens]``,
    by the launches of ``csrc/fused_ln_qkv_bwd.cu`` under the plan
    :func:`_qkv_bwd_plan`: the pre-passes (the statistics, ``xn^T`` and
    the weight's transpose; the gradients token-major and, where dW cannot
    read them in place, packed channel-major, and db's partials), ``dxn =
    G W``, the LN backward and the split-K ``dW = G^T xn``; the partials
    are summed in a fixed order and rounded to bf16. One call counts one
    launch."""
    M, D = x2.shape
    C3 = w.shape[0]
    if C3 % 3:
        raise ValueError(f"fused_ln_qkv_bwd: 3C={C3} is not a multiple of 3")
    C = C3 // 3
    dev = x2.device
    plan = _checked_qkv_bwd_plan(M, D, C, tokens, kernels.sm_count(dev))
    kernels.require(x2, "x")
    kernels.require(gamma, "gamma", (D,), dev)
    kernels.require(beta, "beta", (D,), dev)
    kernels.require(w, "w", (C3, D), dev)
    for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        kernels.require(t, name, (M // tokens, C, tokens), dev)
    dx = torch.empty_like(x2)
    dw = torch.empty_like(w)
    db = torch.empty((C3,), dtype=x2.dtype, device=dev)
    dgb = torch.empty((2, D), dtype=x2.dtype, device=dev)
    work = torch.empty(plan["scratch"]["bytes"], dtype=torch.uint8,
                       device=dev)
    base = work.data_ptr()
    ptrs = [t.data_ptr() for t in (x2, gamma, beta, w, dq, dk, dv, dx, dw,
                                   db, dgb)]
    ptrs += [base + off for off in plan["scratch"]["offsets"]]
    ints = plan["ints"]
    err = kernels.lib().aicity_ln_qkv_bwd(
        ctypes.cast((ctypes.c_void_p * len(ptrs))(*ptrs), ctypes.c_void_p),
        ctypes.cast((ctypes.c_int * len(ints))(*ints), ctypes.c_void_p),
        M, D, C, tokens, float(eps), kernels.stream())
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


@functools.lru_cache(maxsize=256)
def _checked_mlp_bwd_plan(M: int, C: int, H: int, sms: int) -> dict:
    """:func:`_mlp_bwd_plan`, its shared memory held once against the
    kernels' own."""
    plan = _mlp_bwd_plan(M, C, H, sms)
    smem = kernels.lib().aicity_ln_mlp_bwd_smem_bytes
    dual = plan["dual"]
    launches = [(0, dual["tn"], dual["stages"], dual["smem"])] + [
        (1, plan[k]["tn"], plan[k]["stages"], plan[k]["smem"])
        for k in ("dxn", "dw1", "dw2")] + [(2, 0, 0, plan["prep"]["smem"])]
    for variant, tn, stages, want in launches:
        if smem(variant, C, H, tn, stages) != want:
            raise RuntimeError("fused_ln_mlp_bwd: the plan's shared memory "
                               "differs from the kernel's")
    return plan


def fused_ln_mlp_bwd(x2, gamma, beta, w1, b1, w2, dout, eps):
    """The backward kernels of :func:`fused_ln_mlp`: ``(dx, dgamma, dbeta,
    dw1, db1, dw2, db2)`` from the forward's inputs and the output gradient
    ``dout [M, C]``, by the launches of ``csrc/fused_ln_mlp_bwd.cu`` under
    the plan :func:`_mlp_bwd_plan`: the weights' transposes, the LN
    pre-pass (statistics, ``xn``, ``xn^T``, ``dout^T``), the dual GEMM
    (``h^T``, ``dhp``, ``dhp^T`` and the db1 partials), ``dxn = dhp W1``,
    the LN backward, and the split-K weight gradients; the partials are
    summed in a fixed order and rounded to bf16. One call counts one
    launch."""
    M, D = x2.shape
    H = w1.shape[0]
    C = w2.shape[0]
    if D != C:
        raise ValueError(f"fused_ln_mlp_bwd: the kernels take D == C, got "
                         f"D={D}, C={C}")
    dev = x2.device
    plan = _checked_mlp_bwd_plan(M, C, H, kernels.sm_count(dev))
    kernels.require(x2, "x")
    kernels.require(gamma, "gamma", (D,), dev)
    kernels.require(beta, "beta", (D,), dev)
    kernels.require(w1, "w1", (H, D), dev)
    kernels.require(b1, "b1", (H,), dev)
    kernels.require(w2, "w2", (C, H), dev)
    kernels.require(dout, "dout", (M, C), dev)
    dx = torch.empty_like(x2)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    db1 = torch.empty_like(b1)
    dgb = torch.empty((3, C), dtype=x2.dtype, device=dev)
    work = torch.empty(plan["scratch"]["bytes"], dtype=torch.uint8,
                       device=dev)
    base = work.data_ptr()
    ptrs = [t.data_ptr() for t in (x2, gamma, beta, w1, b1, w2, dout, dx,
                                   dw1, db1, dw2, dgb)]
    ptrs += [base + off for off in plan["scratch"]["offsets"]]
    ints = plan["ints"]
    err = kernels.lib().aicity_ln_mlp_bwd(
        ctypes.cast((ctypes.c_void_p * len(ptrs))(*ptrs), ctypes.c_void_p),
        ctypes.cast((ctypes.c_int * len(ints))(*ints), ctypes.c_void_p),
        M, C, H, float(eps), kernels.stream())
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
