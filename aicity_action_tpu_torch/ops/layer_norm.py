"""Grouped LayerNorm: the hand-written CUDA kernels (forward and backward)
in two instances, and their plain versions.

Replaces ``aicity_action_tpu/ops/pallas/layer_norm.py:fused_layer_norm``
(``_ln_fwd_kernel`` and, under autograd, ``_ln_bwd_kernel``): f32
statistics, ``xc = x - mean``, variance ``mean(xc^2)``, the output in the
input's type; the backward's dgamma / dbeta summed over every row and
group. A LayerNorm moves 4 bytes per element forward (bf16 in and out) and
6 backward for ~8 and ~20 flops, so the H100 bounds both by memory
bandwidth, and the kernels (``csrc/layer_norm.cu``) move each byte once.

- The rows instance, :func:`fused_layer_norm` (``[..., C]`` rows, groups of
  ``C // groups`` channels): MViT's final norm ``[B*1568, 768]`` (eps
  1e-6; MViT-v2-L's ``[B*1568, 1152]`` through the wide instances), the
  cls-token MViT-v1's pool norms (odd lengths ``1 + L'``), the pool norms
  of head dim 72 (MViT-v2-L's unfused path) and MViT-v1's
  separate norm2.
- The channel-major instance, :func:`pool_norm_rows`: the MViT-v2 pool
  norms (eps 1e-5 over head_dim 96, per head). It reads the pool
  convolution's ``[B, h*d, L]`` as it lies and writes the head-major rows
  ``[B*h, L, d]`` the attention takes; its backward writes dx back in the
  convolution's layout. It takes ``L % 8 == 0`` and no cls token
  (:func:`channel_major_applies`), so no ``[B, h*d, L] <-> [B*h, L, d]``
  copy is made around it.

Both backwards write one f32 slab of dgamma / dbeta a block and sum them in
the same launch, in a fixed order: the last block of each group of 16 to
finish sums the group's, the last of those the groups' (ticket counters:
:func:`_ticket`). The launch plans are :func:`_ln_plan`.
Launches count under ``fused_layer_norm.launches`` (row 12, both
instances) and ``fused_layer_norm_bwd.launches`` (row 13); the
channel-major instance also under ``pool_norm_rows.launches`` and
``pool_norm_rows_bwd.launches``. Under ``torch.export`` both forwards
trace as the custom ops ``aicity::layer_norm`` and
``aicity::pool_norm_rows`` (``kernels.export_op``).
"""

from __future__ import annotations

import functools

import torch

from . import kernels

# the rows kernels: threads a block, 16-byte vectors a lane, and the wide
# instances' (a warp a segment past 768 channels, forward and backward)
LN_THREADS, LN_BWD_THREADS, LN_VPL, LN_WIDE_VPL = 256, 384, 3, 5
# the backwards' slab tree: slabs a group (csrc/layer_norm.cu:SLAB_GROUP),
# and the ticket counters a stream keeps (one, then one a group)
SLAB_GROUP, TICKETS = 16, 64
# the channel-major kernels: the head dim they take, threads a block, lanes
# a token, tokens a tile (the backward's 64: 128-byte rows of its swizzled
# boxes), ring stages, blocks an SM at most (the backward's
# __launch_bounds__(256, 2))
POOL_NORM_D = 96
COL_THREADS, COL_LANES = 256, 4
COL_FWD_TILE, COL_FWD_STAGES = 64, 4
COL_BWD_TILE, COL_BWD_STAGES, COL_BWD_BLOCKS_PER_SM = 64, 3, 2
_COL_HEAD = 1024  # barriers and gamma / beta ahead of the ring
_MAX_THREADS_PER_SM = 2048


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def channel_major_applies(length: int, cls: bool, head_dim: int) -> bool:
    """Whether a pool norm over ``length`` tokens of ``head_dim`` channels a
    head takes the channel-major instance: its kernels are built for
    ``POOL_NORM_D`` channels, TMA reads the ``[B*h*d, L]`` view, whose rows
    must be whole 16 bytes (``L % 8 == 0``), and a cls token's column takes
    the rows instance (its lengths ``1 + L'`` are odd anyway). Every other
    pool norm takes the rows instance."""
    return head_dim == POOL_NORM_D and not cls and length % 8 == 0


def _col_smem(bwd: bool, tile: int, stages: int) -> int:
    """Dynamic shared memory of a channel-major launch, as
    ``csrc/layer_norm.cu:pool_norm_smem_bytes`` lays it out: 1024 bytes of
    alignment slack, the head, the ring (x boxes ``[96][tile]``, the
    backward's with the tile's dy rows as two boxes ``[tile][64]``) and two
    staged output tiles."""
    box = POOL_NORM_D * tile * 2
    stage = box + (2 * tile * 128 if bwd else 0)
    return 1024 + _COL_HEAD + stages * stage + 2 * box


def _rows_lanes(dg: int) -> int:
    """The fewest lanes (4, 8, 16 or 32) whose three 16-byte vectors each
    cover ``dg`` channels; 32 past that (the wide instances)."""
    need = _cdiv(dg // 8, LN_VPL)
    return next((n for n in (4, 8, 16, 32) if n >= need), 32)


@functools.lru_cache(maxsize=256)
def _ln_plan(kind: str, shape: tuple, sms: int) -> dict:
    """Launch plan of a ``csrc/layer_norm.cu`` kernel on a card of ``sms``
    SMs. ``kind`` "rows" / "rows_bwd" take ``shape = (rows, C, groups)``:
    ``lanes`` a segment of ``C // groups`` channels, ``vpl`` its 16-byte
    vectors a lane (LN_WIDE_VPL past 768 channels) and
    ``blocks`` (the forward one group of lanes a segment; the backward
    persistent, one block of LN_BWD_THREADS an SM). "cols" / "cols_bwd"
    take ``shape = (groups, d, L)`` (the channel-major ``[groups * d,
    L]``): ``tile``
    tokens a tile, ``stages``, ``blocks`` (persistent, as many an SM as
    shared memory, threads and registers allow) and ``tma``, the row stride
    and box of the x (and dx) descriptor and of the backward's dy one. Every plan has ``slabs``, the f32
    dgamma / dbeta partials of the backward's blocks (0 forward),
    ``slab_groups``, the groups of SLAB_GROUP slabs its tree sums first,
    and ``smem``. Raises ValueError for what no kernel takes."""
    if kind in ("rows", "rows_bwd"):
        rows, C, groups = shape
        if groups < 1 or C % groups:
            raise ValueError(f"fused_layer_norm: {C} channels in {groups} "
                             "groups")
        dg = C // groups
        most = 8 * LN_WIDE_VPL * 32
        if dg % 8 or not 0 < dg <= most or rows < 1:
            raise ValueError(f"fused_layer_norm: the {kind} kernels take "
                             f"groups of a multiple of 8 channels, at most "
                             f"{most}, got {dg} over {rows} rows")
        lanes = _rows_lanes(dg)
        vpl = LN_VPL if dg <= 8 * LN_VPL * lanes else LN_WIDE_VPL
        segments = rows * groups
        if kind == "rows":
            return {"lanes": lanes, "vpl": vpl, "threads": LN_THREADS,
                    "smem": 0, "blocks": _cdiv(segments, LN_THREADS // lanes),
                    "slabs": 0, "slab_groups": 0}
        blocks = min(sms, _cdiv(segments, LN_BWD_THREADS // lanes))
        return {"lanes": lanes, "vpl": vpl, "threads": LN_BWD_THREADS,
                "smem": (LN_BWD_THREADS // 32) * 2 * dg * 4,
                "blocks": blocks, "slabs": blocks,
                "slab_groups": _cdiv(blocks, SLAB_GROUP)}
    if kind not in ("cols", "cols_bwd"):
        raise ValueError(f"_ln_plan: no kind {kind!r}")
    groups, d, L = shape
    if d != POOL_NORM_D or groups < 1 or L < 1 or L % 8:
        raise ValueError(f"pool_norm_rows: the kernels take head dim "
                         f"{POOL_NORM_D} and L % 8 == 0, got d={d}, L={L}")
    bwd = kind == "cols_bwd"
    tile, stages = ((COL_BWD_TILE, COL_BWD_STAGES) if bwd
                    else (COL_FWD_TILE, COL_FWD_STAGES))
    smem = _col_smem(bwd, tile, stages)
    per_sm = min(kernels.SM_SMEM_BYTES // (smem + 1024),
                 _MAX_THREADS_PER_SM // COL_THREADS)
    if bwd:
        per_sm = min(per_sm, COL_BWD_BLOCKS_PER_SM)
    tiles = groups * _cdiv(L, tile)
    blocks = min(tiles, per_sm * sms)
    return {"tile": tile, "stages": stages, "threads": COL_THREADS,
            "smem": smem, "tiles": tiles, "blocks": blocks,
            "blocks_per_sm": per_sm, "slabs": blocks if bwd else 0,
            "slab_groups": _cdiv(blocks, SLAB_GROUP) if bwd else 0,
            "tma": {"x": {"stride_bytes": 2 * L, "box": (d, tile),
                          "box_row_bytes": 2 * tile},
                    **({"dy": {"stride_bytes": 2 * d, "box": (tile, 64),
                               "box_row_bytes": 128}} if bwd else {})}}


@functools.cache
def _check_kernel_smem() -> None:
    """Holds the plans' shared memory against the kernels' own, once a
    process."""
    lib = kernels.lib()
    for kind, bwd, tile, stages in ((1, False, COL_FWD_TILE, COL_FWD_STAGES),
                                    (2, True, COL_BWD_TILE, COL_BWD_STAGES)):
        if lib.aicity_layer_norm_smem_bytes(kind, 0, tile, stages) != \
                _col_smem(bwd, tile, stages):
            raise RuntimeError("pool_norm_rows: _col_smem differs from the "
                               "kernels' shared memory")
    if lib.aicity_layer_norm_smem_bytes(0, 768, 0, 0) != \
            _ln_plan("rows_bwd", (1, 768, 1), 1)["smem"]:
        raise RuntimeError("fused_layer_norm_bwd: the plan's shared memory "
                           "differs from the kernel's")


_tickets: dict = {}


def _ticket(device: torch.device) -> torch.Tensor:
    """The backwards' ticket counters for the current stream of ``device``:
    TICKETS int32 at 0, which each launch leaves at 0 (so launches in turn
    on one stream share them, and no two streams do)."""
    key = (device.index, kernels.stream())
    if key not in _tickets:
        _tickets[key] = torch.zeros(TICKETS, dtype=torch.int32,
                                    device=device)
    return _tickets[key]


def _plan(kind: str, shape: tuple, device: torch.device) -> dict:
    """:func:`_ln_plan` for the card of ``device``."""
    _check_kernel_smem()
    plan = _ln_plan(kind, tuple(int(n) for n in shape),
                    kernels.sm_count(device))
    if 1 + plan["slab_groups"] > TICKETS:
        raise ValueError(f"{kind}: {plan['slabs']} slabs need more than the "
                         f"{TICKETS} ticket counters a stream keeps")
    return plan


# ------------------------------------------------------------ rows instance

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
    through the rows kernel (bf16, contiguous), differentiable through
    :func:`fused_layer_norm_bwd`; a CPU tensor through the plain version,
    which autograd differentiates."""
    if torch.compiler.is_exporting():
        return _LAYER_NORM_OP(x, gamma, beta, eps, groups)
    if not kernels.use_kernel(x):
        return layer_norm_plain(x, gamma, beta, eps, groups)
    return _FusedLayerNorm.apply(x, gamma, beta, eps, groups)


_LAYER_NORM_OP = kernels.export_op(
    "layer_norm", "(Tensor x, Tensor gamma, Tensor beta, float eps, int "
    "groups) -> Tensor", fused_layer_norm,
    lambda x, gamma, beta, eps, groups: torch.empty_like(
        x, memory_format=torch.contiguous_format))


def _ln_forward(x, gamma, beta, eps, groups):
    C = x.shape[-1]
    rows = x.numel() // C if C else 0
    kernels.require(x, "x")
    plan = _plan("rows", (rows, C, groups), x.device)
    dg = C // groups
    kernels.require(gamma, "gamma", (dg,), x.device)
    kernels.require(beta, "beta", (dg,), x.device)
    y = torch.empty_like(x)
    err = kernels.lib().aicity_layer_norm(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), rows,
        C, groups, plan["lanes"], plan["blocks"], float(eps),
        kernels.stream())
    kernels.check(err, "fused_layer_norm")
    fused_layer_norm.launches += 1
    return y


fused_layer_norm.launches = 0


def fused_layer_norm_bwd(x: torch.Tensor, gamma: torch.Tensor,
                         dy: torch.Tensor, eps: float, groups: int = 1):
    """The rows backward kernel: ``(dx, dgamma, dbeta)`` of the grouped LN
    at ``x`` for the output gradient ``dy`` (dgamma / dbeta summed over
    every row and group, rounded to bf16 like the forward's params)."""
    C = x.shape[-1]
    rows = x.numel() // C if C else 0
    dev = x.device
    kernels.require(x, "x")
    plan = _plan("rows_bwd", (rows, C, groups), dev)
    dg = C // groups
    kernels.require(gamma, "gamma", (dg,), dev)
    kernels.require(dy, "dy", tuple(x.shape), dev)
    part = torch.empty((plan["slabs"] + plan["slab_groups"], 2, dg),
                       dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dgb = torch.empty((2, dg), dtype=x.dtype, device=dev)
    err = kernels.lib().aicity_layer_norm_bwd(
        x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dgb.data_ptr(), part.data_ptr(), _ticket(dev).data_ptr(), rows, C,
        groups, plan["lanes"], plan["blocks"], float(eps), kernels.stream())
    kernels.check(err, "fused_layer_norm_bwd")
    fused_layer_norm_bwd.launches += 1
    return dx, dgb[0], dgb[1]


fused_layer_norm_bwd.launches = 0


class _FusedLayerNorm(torch.autograd.Function):
    """The rows kernels under autograd; saves ``(x, gamma)`` as the Pallas
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


# --------------------------------------------------- channel-major instance

def pool_norm_rows_plain(t: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, eps: float,
                         heads: int) -> torch.Tensor:
    """The pool norm of a channel-major ``t [B, h*d, L]``: its head-major
    rows ``[B*h, L, d]`` (a contiguous copy) normalized per head over
    ``d`` by :func:`layer_norm_plain`."""
    B, C, L = t.shape
    d = C // heads
    r = (t.reshape(B, heads, d, L).transpose(2, 3).reshape(B * heads, L, d)
         .contiguous())
    return layer_norm_plain(r, gamma, beta, eps)


def pool_norm_rows_bwd_plain(t: torch.Tensor, gamma: torch.Tensor,
                             dy: torch.Tensor, eps: float, heads: int):
    """``(dx [B, h*d, L], dgamma, dbeta)`` of :func:`pool_norm_rows_plain`
    for the rows' gradient ``dy [B*h, L, d]``, by autograd."""
    with torch.enable_grad():
        ts = [a.detach().requires_grad_() for a in
              (t, gamma, torch.zeros_like(gamma))]
        out = pool_norm_rows_plain(ts[0], ts[1], ts[2], eps, heads)
        return torch.autograd.grad(out, ts, dy)


def _pool_norm_shape(name, t, gamma, heads):
    if t.dim() != 3 or heads < 1 or t.shape[1] % heads:
        raise ValueError(f"{name}: expected t [B, h*d, L] of {heads} heads, "
                         f"got {tuple(t.shape)}")
    B, C, L = t.shape
    d = C // heads
    kernels.require(t, "t")
    kernels.require(gamma, "gamma", (d,), t.device)
    return B, C, L, d


def pool_norm_rows(t: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float, heads: int) -> torch.Tensor:
    """The pool norm of ``t [B, h*d, L]``, the pool convolution's output:
    head-major LayerNormed rows ``[B*h, L, d]`` (see
    :func:`pool_norm_rows_plain`). A CUDA tensor goes through the
    channel-major kernel (bf16, contiguous, d 96, ``L % 8 == 0``; it
    raises on anything else), differentiable through
    :func:`pool_norm_rows_bwd`; a CPU tensor through the plain version."""
    if torch.compiler.is_exporting():
        return _POOL_NORM_OP(t, gamma, beta, eps, heads)
    if not kernels.use_kernel(t):
        return pool_norm_rows_plain(t, gamma, beta, eps, heads)
    return _PoolNormRows.apply(t, gamma, beta, eps, heads)


_POOL_NORM_OP = kernels.export_op(
    "pool_norm_rows", "(Tensor t, Tensor gamma, Tensor beta, float eps, int "
    "heads) -> Tensor", pool_norm_rows,
    lambda t, gamma, beta, eps, heads: t.new_empty(
        (t.shape[0] * heads, t.shape[2], t.shape[1] // heads)))


def _pool_norm_forward(t, gamma, beta, eps, heads):
    B, C, L, d = _pool_norm_shape("pool_norm_rows", t, gamma, heads)
    kernels.require(beta, "beta", (d,), t.device)
    plan = _plan("cols", (B * heads, d, L), t.device)
    y = torch.empty((B * heads, L, d), dtype=t.dtype, device=t.device)
    err = kernels.lib().aicity_pool_norm(
        t.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        B * heads, d, L, plan["tile"], plan["stages"], plan["blocks"],
        float(eps), kernels.stream())
    kernels.check(err, "pool_norm_rows")
    fused_layer_norm.launches += 1
    pool_norm_rows.launches += 1
    return y


pool_norm_rows.launches = 0


def pool_norm_rows_bwd(t: torch.Tensor, gamma: torch.Tensor,
                       dy: torch.Tensor, eps: float, heads: int):
    """The channel-major backward: ``(dx [B, h*d, L], dgamma, dbeta)`` of
    :func:`pool_norm_rows` at ``t`` for the rows' gradient ``dy [B*h, L,
    d]``, dx in ``t``'s layout (the pool convolution's), dgamma / dbeta
    summed over every token and head and rounded to bf16. A CPU tensor
    takes :func:`pool_norm_rows_bwd_plain`."""
    if not kernels.use_kernel(t):
        return pool_norm_rows_bwd_plain(t, gamma, dy, eps, heads)
    B, C, L, d = _pool_norm_shape("pool_norm_rows_bwd", t, gamma, heads)
    dev = t.device
    kernels.require(dy, "dy", (B * heads, L, d), dev)
    plan = _plan("cols_bwd", (B * heads, d, L), dev)
    part = torch.empty((plan["slabs"] + plan["slab_groups"], 2, d),
                       dtype=torch.float32, device=dev)
    dx = torch.empty_like(t)
    dgb = torch.empty((2, d), dtype=t.dtype, device=dev)
    err = kernels.lib().aicity_pool_norm_bwd(
        t.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dgb.data_ptr(), part.data_ptr(), _ticket(dev).data_ptr(), B * heads,
        d, L, plan["tile"], plan["stages"], plan["blocks"], float(eps),
        kernels.stream())
    kernels.check(err, "pool_norm_rows_bwd")
    fused_layer_norm_bwd.launches += 1
    pool_norm_rows_bwd.launches += 1
    return dx, dgb[0], dgb[1]


pool_norm_rows_bwd.launches = 0


class _PoolNormRows(torch.autograd.Function):
    """The channel-major kernels under autograd; saves ``(t, gamma)``."""

    @staticmethod
    def forward(ctx, t, gamma, beta, eps, heads):
        ctx.save_for_backward(t, gamma)
        ctx.eps, ctx.heads = eps, heads
        return _pool_norm_forward(t, gamma, beta, eps, heads)

    @staticmethod
    def backward(ctx, dy):
        t, gamma = ctx.saved_tensors
        dx, dgam, dbet = pool_norm_rows_bwd(t, gamma, dy.contiguous(),
                                            ctx.eps, ctx.heads)
        return dx, dgam, dbet, None, None
