"""Flash attention: the hand-written CUDA kernels and their plain versions.

:func:`flash_attention` (forward with the logsumexp, and backward) serves
training and the pool modes without norms; ``csrc/flash_attention.cu``
replaces ``aicity_action_tpu/ops/pallas/flash_attention.py:flash_attention``
(``_flash_kernel``, ``_flash_fwd_lse_kernel`` and the backward kernels of
``_flash_bwd``). It takes contiguous head-major token rows ``[G, L, 96]``;
its note says how the backward is split across blocks.

:func:`flash_attention_padded` is the same function at any lengths: the
attention of a cls-token MViT, whose lengths ``1 + T*H*W`` no tile
divides. It replaces ``flash_attention.py:flash_attention_padded`` (and
``_flash_padded_fwd`` / ``_flash_padded_bwd``), which zero-pads q, k, v to
a tile multiple and masks the padded key columns. The CUDA kernels mask
keys past ``Lk`` and rows past ``Lq`` themselves, so they run on the
unpadded tensors and no padded copy goes through device memory; the
wrapper differs from :func:`flash_attention` only in its launch counts.

:func:`flash_attention_ln` is attention over raw pooled q/k/v with the
per-head LayerNorms and the MViT-v2 query residual fused in. It replaces
``aicity_action_tpu/ops/pallas/flash_attention.py:flash_attention_ln``
(``_flash_ln_fwd_kernel``; ``_flash_ln_fwd_lse_kernel`` and the backward
kernels of ``_flash_ln_bwd`` under autograd), which every MViT block runs
at inference, and in training under ``AICITY_TPU_FUSE_ATTN_LN=1``. At 448
it sees head-major ``q [B*h, Lq, 96]`` and ``k, v [B*h, Lk, 96]`` with Lq up
to 100352 and Lk in {1568, 6272}: 4*Lq*Lk*d flops against 2*(Lq + 2*Lk)*d
bytes, so the tensor cores (and the softmax's exponentials) bound it. The
Pallas kernel keeps a group's whole K/V in VMEM and normalizes it once per
group; GPU blocks share nothing, so ``csrc/flash_attention_ln.cu``
normalizes K and V once, into token-row scratch the wrapper allocates,
then runs the forward core of ``csrc/flash_fwd.cuh`` on them (128 query
rows a block, 64-key tiles through a TMA ring, ``wgmma``, online
softmax), as the plain forward does. It reads q,
k, v in the d-major layout the pool convolutions leave, so no transpose
goes through device memory; its backward (``csrc/flash_attention_ln_bwd.
cu``) writes dq, dk, dv back in that layout.
"""

from __future__ import annotations

import functools

import torch

from . import kernels
from .layer_norm import layer_norm_plain

# the head dim the kernel is instantiated for (every MViT-v2 block's)
KERNEL_HEAD_DIM = 96
# logits the plain version materializes at once (f32 elements)
_PLAIN_CHUNK = 1 << 28

# the backward's tiles (query rows or keys a block, csrc/flash_bwd.cuh:BW_T)
BWD_TILE = 64
# backward blocks an SM holds at once (__launch_bounds__(128, 2): registers
# and shared memory leave room for two)
BWD_BLOCKS_PER_SM = 2
# shared memory an SM gives its blocks (228 KB, 1 KB of it reserved per
# block)
SM_SMEM_BYTES = 233_472
_BWD_TILE_BYTES = BWD_TILE * KERNEL_HEAD_DIM * 2
# the ring depths of csrc/flash_bwd.cuh (DQ_STAGES, DQ_LN_STAGES,
# DKV_STAGES)
_DQ_STAGES, _DQ_LN_STAGES, _DKV_STAGES = 3, 2, 3
# the dk/dv kernel's query splits a plan considers at most
_MAX_SPLITS = 64


def _bwd_smem() -> dict:
    """Dynamic shared memory of the backward's kernels (bytes), as
    ``csrc/flash_bwd.cuh`` and ``csrc/flash_attention_ln_bwd.cu`` lay it
    out: 1 KB of alignment slack; the dq kernels' K/V ring (a K and a V
    tile and a barrier a stage), the fused-LN one also its LN(q) and dO
    rows, the raw q tile, the O rows / dq staging (each padded by 8 bf16 a
    row) and its f32 statistics and column sums; the dk/dv kernel's ring of
    (qs, dO) tiles with their (lse, delta) rows and a barrier a stage (its
    K and V stay in registers)."""
    d, t = KERNEL_HEAD_DIM, BWD_TILE
    ring = 2 * _BWD_TILE_BYTES + 8
    ln_rows = 2 * (2 * t * (d + 8) + d * (t + 8) + max(d * (t + 8),
                                                       t * (d + 8)))
    return {"dq": 1024 + _DQ_STAGES * ring,
            "ln_dq": 1024 + _DQ_LN_STAGES * ring + ln_rows
            + 4 * (3 * t + 8 * d),
            "dkv": 1024 + _DKV_STAGES * (2 * _BWD_TILE_BYTES + t * 8 + 8)}


def _attn_bwd_plan(G: int, Lq: int, Lk: int, d: int, sms: int) -> dict:
    """The query splits of the attention backward's dk/dv kernel (rows 3, 4
    and 7), whose grid is (key tiles, G, splits): ``qps`` query rows a
    split, a whole number of 64-row tiles, and ``nsplit`` splits. The
    splits give the grid at least every block slot of the card
    (BWD_BLOCKS_PER_SM an SM) wherever Lq has the tiles for it; from there
    the count takes the fewest waves x tiles a block over the slots, plus
    the bytes each split's f32 partials add to the sums, counted in tile
    steps. ``lqp``: Lq rounded up to whole tiles, the rows of the padded
    (lse, delta) scratch. The dq kernel's grid is one block a tile."""
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"flash attention backward: the kernel takes head "
                         f"dim {KERNEL_HEAD_DIM}, got {d}")
    if not 0 < G <= 65535 or Lq <= 0 or Lk <= 0:
        raise ValueError(f"flash attention backward: no kernel takes "
                         f"G {G}, Lq {Lq}, Lk {Lk}")
    ntq, nkt = -(-Lq // BWD_TILE), -(-Lk // BWD_TILE)
    slots = BWD_BLOCKS_PER_SM * sms
    # (rows a split in tiles, splits) for every split count the tiles allow
    plans = {(-(-ntq // n), -(-ntq // -(-ntq // n)))
             for n in range(1, min(ntq, _MAX_SPLITS) + 1)}
    fewest = min(max(n for _, n in plans), -(-slots // (G * nkt)))
    # a split writes and sums G * Lk * 96 f32 pairs: at 3.35 TB/s about
    # G * Lk / 7000 tile steps of a full wave (~1.6 us each)
    split_cost = G * Lk / 7000.0
    best = min((-(-G * nkt * n // slots) * per + n * split_cost, n, per)
               for per, n in plans if n >= fewest)
    _, nsplit, per = best
    return {"qps": per * BWD_TILE, "nsplit": nsplit, "lqp": ntq * BWD_TILE}


@functools.cache
def _check_kernel_smem() -> None:
    """Holds :func:`_bwd_smem` against the kernels' own shared memory, once
    a process."""
    lib = kernels.lib()
    theirs = (lib.aicity_flash_bwd_smem_bytes(0),
              lib.aicity_flash_ln_bwd_dq_smem_bytes(),
              lib.aicity_flash_bwd_smem_bytes(1))
    if theirs != tuple(_bwd_smem().values()):
        raise RuntimeError("flash attention backward: _bwd_smem differs from "
                           "the kernels' shared memory")


def _checked_attn_bwd_plan(G: int, Lq: int, Lk: int, d: int,
                           device: torch.device) -> dict:
    """:func:`_attn_bwd_plan` for the card of ``device``."""
    _check_kernel_smem()
    return _attn_bwd_plan(G, Lq, Lk, d, kernels.sm_count(device))


def _rounded_scale(scale: float, dtype: torch.dtype) -> float:
    """The logit scale as the compute type holds it: the Pallas kernel
    multiplies LN(q) by ``asarray(scale, dtype)``, and so does the port."""
    return float(torch.tensor(scale, dtype=dtype))


def _is_dmajor(t: torch.Tensor) -> bool:
    """Whether ``t [G, L, d]`` is the d-major view of a contiguous
    ``[G, d, L]`` (per head, the NCDHW output of a pool convolution)."""
    G, L, d = t.shape
    return (L > 1 and d > 1 and t.stride()[1:] == (1, L)
            and (G == 1 or t.stride(0) == L * d))


def flash_attention_ln_plain(q, k, v, gq, bq, gk, bk, gv, bv, scale, eps,
                             flags, add_qn):
    """``softmax(LN(q)*s . LN(k)^T) . LN(v) [+ LN(q)]`` with each LN only
    where ``flags = (fq, fk, fv)`` says: f32 LN statistics, LN(q)*s rounded
    to the compute type, f32 logits and softmax, the probabilities rounded
    to the compute type for the product with V and the sum kept in f32.
    Groups are processed in chunks to bound the logits' memory."""
    fq, fk, fv = flags
    qb = layer_norm_plain(q, gq, bq, eps) if fq else q
    kb = layer_norm_plain(k, gk, bk, eps) if fk else k
    vb = layer_norm_plain(v, gv, bv, eps) if fv else v
    out = flash_attention_plain(qb, kb, vb, scale)
    return out + qb if add_qn else out


def flash_attention_ln(q, k, v, gq, bq, gk, bk, gv, bv, scale: float,
                       eps: float, flags, add_qn: bool):
    """Fused-LN attention (see :func:`flash_attention_ln_plain`).

    ``q [G, Lq, d]``, ``k``/``v [G, Lk, d]`` raw pooled tensors in the
    head-major layout. The plain version takes any strides; the kernels
    take the d-major views ``x.transpose(1, 2)`` of contiguous
    ``[G, d, L]`` tensors (what the pool convolutions leave) and read them
    as they lie. ``g*``/``b*`` are the ``[d]`` LN params (any values where
    the flag is off; their gradients are then zeros); ``flags`` the static
    (norm_q, norm_k, norm_v); ``add_qn`` adds the v2 query residual
    ``+ LN(q)``. Returns a contiguous ``[G, Lq, d]``. Where a gradient is
    needed, the forward saves the logsumexp and the attention output before
    the residual (:func:`flash_attention_ln_lse`), and the backward is
    :func:`flash_attention_ln_bwd`.
    """
    if not kernels.use_kernel(q):
        return flash_attention_ln_plain(q, k, v, gq, bq, gk, bk, gv, bv,
                                        scale, eps, flags, add_qn)
    tensors = (q, k, v, gq, bq, gk, bk, gv, bv)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _FlashAttentionLn.apply(*tensors, scale, eps, tuple(flags),
                                       add_qn)
    out, _, _ = _flash_ln_fwd(*tensors, scale, eps, flags, add_qn, False)
    flash_attention_ln.launches += 1
    return out


def _ln_operands(name, q, k, v, params):
    """The fused-LN kernels' input rules. Returns ``(G, Lq, Lk, d)`` and
    q, k, v as the contiguous ``[G, d, L]`` tensors their d-major views
    show."""
    G, Lq, d = q.shape
    Lk = k.shape[1]
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head dim "
                         f"{KERNEL_HEAD_DIM}, got {d}")
    if G > 65535:
        raise ValueError(f"{name}: {G} groups exceed the grid")
    if not all(_is_dmajor(t) for t in (q, k, v)) or Lq % 8:
        raise ValueError(f"{name}: the kernel takes q, k, v as d-major "
                         "views of [G, d, L] tensors, Lq % 8 == 0")
    dev = q.device
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    kernels.require(q, "q")
    kernels.require(k, "k", (G, d, Lk), dev)
    kernels.require(v, "v", (G, d, Lk), dev)
    for pname, t in zip(("gq", "bq", "gk", "bk", "gv", "bv"), params):
        kernels.require(t, pname, (d,), dev)
    return (G, Lq, Lk, d), (q, k, v)


def _flash_ln_fwd(q, k, v, gq, bq, gk, bk, gv, bv, scale, eps, flags,
                  add_qn, with_lse):
    """The forward kernel: ``(out [G, Lq, d], lse [G, Lq] f32, o_attn)``
    with ``with_lse``, else ``(out, None, None)``. ``o_attn`` is the
    attention output before the residual (``out`` itself without
    ``add_qn``)."""
    (G, Lq, Lk, d), (q, k, v) = _ln_operands(
        "flash_attention_ln", q, k, v, (gq, bq, gk, bk, gv, bv))
    dev = q.device
    out = torch.empty((G, Lq, d), dtype=q.dtype, device=dev)
    lse = (torch.empty((G, Lq), dtype=torch.float32, device=dev)
           if with_lse else None)
    oa = torch.empty_like(out) if with_lse and add_qn else None
    fq, fk, fv = (int(bool(f)) for f in flags)
    # scratch for the token rows of LN(k) / LN(v), made once before the
    # attention
    kn, vn = (torch.empty((G, Lk, d), dtype=k.dtype, device=dev)
              for _ in range(2))
    err = kernels.lib().aicity_flash_attention_ln(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), gq.data_ptr(),
        bq.data_ptr(), gk.data_ptr(), bk.data_ptr(), gv.data_ptr(),
        bv.data_ptr(), out.data_ptr(), kernels.ptr(lse), kernels.ptr(oa),
        kn.data_ptr(), vn.data_ptr(), G, Lq, Lk, d,
        _rounded_scale(scale, q.dtype), float(eps), fq, fk, fv,
        int(bool(add_qn)), kernels.stream())
    kernels.check(err, "flash_attention_ln")
    if with_lse and not add_qn:
        oa = out
    return out, lse, oa


def flash_attention_ln_lse(q, k, v, gq, bq, gk, bk, gv, bv, scale: float,
                           eps: float, flags, add_qn: bool):
    """The forward under autograd (replaces ``_flash_ln_fwd_lse_kernel``;
    one kernel with :func:`flash_attention_ln`): ``(out, lse, o_attn)``
    with the per-row logsumexp of the logits (f32 ``[G, Lq]``) and the
    attention output before the residual, from which the backward takes
    ``delta``. The Pallas wrapper recovers the latter as ``out - LN(q)``
    from the rounded ``out``; in bf16 that costs a rounding of ``O +
    LN(q)`` (LN(q) is of order 1, O much smaller), which shows as noise in
    gradients that cancel, such as the k norm's bias gradient (exactly
    zero: softmax ignores one shift of every key)."""
    res = _flash_ln_fwd(q, k, v, gq, bq, gk, bk, gv, bv, scale, eps, flags,
                        add_qn, True)
    flash_attention_ln_lse.launches += 1
    return res


def flash_attention_ln_bwd(q, k, v, gq, bq, gk, bk, gv, bv, o_attn, lse,
                           dout, scale: float, eps: float, flags,
                           add_qn: bool):
    """The backward kernels of :func:`flash_attention_ln` (replace
    ``_flash_ln_dqkv_kernel`` / ``_flash_ln_dqkv_chunked_kernel``):
    ``(dq, dk, dv, dgq, dbq, dgk, dbk, dgv, dbv)`` from the forward's inputs
    (q, k, v the d-major views it took), its ``lse`` and attention output
    before the residual ``o_attn`` (:func:`flash_attention_ln_lse`) and the
    output gradient ``dout [G, Lq, d]``. dq, dk, dv are the d-major views
    of contiguous ``[G, d, L]`` gradients, the layout the pool
    convolutions' backward takes; the LN parameter gradients are bf16
    ``[d]``, zeros where the flag is off. ``delta = rowsum(dout * o_attn)``
    is computed in the dq kernel, which also writes the scaled LN(q) rows
    that the dk/dv kernel reads; dk / dv are summed over query splits of
    f32 partials (:func:`_attn_bwd_plan`) before their LN backward."""
    (G, Lq, Lk, d), (q, k, v) = _ln_operands(
        "flash_attention_ln_bwd", q, k, v, (gq, bq, gk, bk, gv, bv))
    dev = q.device
    kernels.require(o_attn, "o_attn", (G, Lq, d), dev)
    kernels.require(dout, "dout", (G, Lq, d), dev)
    kernels.require(lse, "lse", (G, Lq), dev, torch.float32)
    bf = dict(dtype=q.dtype, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dgb = torch.empty((6, d), **bf)
    qn = torch.empty((G, Lq, d), **bf)
    kn, vn = (torch.empty((G, Lk, d), **bf) for _ in range(2))
    plan = _checked_attn_bwd_plan(G, Lq, Lk, d, dev)
    ld = torch.empty((G, plan["lqp"], 2), **f32)
    part_q = torch.empty((G * -(-Lq // BWD_TILE), 2, d), **f32)
    dk_part, dv_part = (torch.empty((plan["nsplit"], G, Lk, d), **f32)
                        for _ in range(2))
    part_kv = torch.empty((2, G * -(-Lk // 128), 2, d), **f32)
    fq, fk, fv = (int(bool(f)) for f in flags)
    err = kernels.lib().aicity_flash_attention_ln_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), gq.data_ptr(),
        bq.data_ptr(), gk.data_ptr(), bk.data_ptr(), gv.data_ptr(),
        bv.data_ptr(), o_attn.data_ptr(), lse.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dgb.data_ptr(),
        qn.data_ptr(), kn.data_ptr(), vn.data_ptr(), ld.data_ptr(),
        part_q.data_ptr(), dk_part.data_ptr(), dv_part.data_ptr(),
        part_kv.data_ptr(), G, Lq, Lk, d, _rounded_scale(scale, q.dtype),
        float(eps), fq, fk, fv, int(bool(add_qn)), plan["qps"],
        kernels.stream())
    kernels.check(err, "flash_attention_ln_bwd")
    flash_attention_ln_bwd.launches += 1
    return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
            *dgb.unbind(0))


for _fn in (flash_attention_ln, flash_attention_ln_lse,
            flash_attention_ln_bwd):
    _fn.launches = 0
del _fn


class _FlashAttentionLn(torch.autograd.Function):
    """The fused-LN kernels under autograd; saves ``(q, k, v, params,
    o_attn, lse)``, where the Pallas forward rule ``_flash_ln_fwd`` saves
    ``out`` for ``o_attn`` (see :func:`flash_attention_ln_lse`)."""

    @staticmethod
    def forward(ctx, q, k, v, gq, bq, gk, bk, gv, bv, scale, eps, flags,
                add_qn):
        out, lse, o_attn = flash_attention_ln_lse(
            q, k, v, gq, bq, gk, bk, gv, bv, scale, eps, flags, add_qn)
        ctx.save_for_backward(q, k, v, gq, bq, gk, bk, gv, bv, o_attn, lse)
        ctx.args = (scale, eps, flags, add_qn)
        return out

    @staticmethod
    def backward(ctx, dout):
        *inputs, o_attn, lse = ctx.saved_tensors
        grads = flash_attention_ln_bwd(*inputs, o_attn, lse,
                                       dout.contiguous(), *ctx.args)
        return (*grads, None, None, None, None)


def _attention_plain(q, k, v, scale, with_lse):
    """``softmax(bf16(q * s) . k^T) . v`` as the Pallas kernels round it:
    f32 logits and softmax, the probabilities rounded to the compute type
    for the product with V, the sum kept in f32; groups are processed in
    chunks to bound the logits' memory. Differentiable."""
    dt = q.dtype
    qs = (q.float() * _rounded_scale(scale, dt)).to(dt)
    G, Lq, _ = q.shape
    Lk = k.shape[1]
    step = max(1, _PLAIN_CHUNK // max(1, Lq * Lk))
    outs, lses = [], []
    for g0 in range(0, G, step):
        sl = slice(g0, g0 + step)
        s = qs[sl].float() @ k[sl].float().transpose(1, 2)
        m = s.amax(-1, keepdim=True).detach()
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        outs.append(((p.to(dt).float() @ v[sl].float()) / l).to(dt))
        lses.append((m + torch.log(l))[..., 0])
    out = torch.cat(outs, 0)
    return (out, torch.cat(lses, 0)) if with_lse else out


def flash_attention_plain(q, k, v, scale):
    """The plain version of :func:`flash_attention`."""
    return _attention_plain(q, k, v, scale, False)


def flash_attention_lse_plain(q, k, v, scale):
    """``(out, lse)``: the plain version of the forward that saves the
    per-row logsumexp of the logits (f32 ``[G, Lq]``)."""
    return _attention_plain(q, k, v, scale, True)


def _require_rows(name, G, d, *named):
    """Checks ``(tensor name, tensor, length)`` triples against the
    kernels' contiguous bf16 ``[G, length, 96]`` token rows."""
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head dim "
                         f"{KERNEL_HEAD_DIM}, got {d}")
    if G > 65535:
        raise ValueError(f"{name}: {G} groups exceed the grid")
    dev = named[0][1].device
    for tname, t, L in named:
        kernels.require(t, tname, (G, L, d), dev)


def _attention_fwd(q, k, v, scale: float, with_lse: bool):
    """The forward kernel on contiguous token rows ``q [G, Lq, 96]``,
    ``k, v [G, Lk, 96]`` of any lengths: ``out`` and, with ``with_lse``, the
    f32 ``lse [G, Lq]`` (one kernel; the lse store is skipped without
    it)."""
    G, Lq, d = q.shape
    Lk = k.shape[1]
    _require_rows("flash_attention", G, d, ("q", q, Lq), ("k", k, Lk),
                  ("v", v, Lk))
    out = torch.empty_like(q)
    lse = (torch.empty((G, Lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = kernels.lib().aicity_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kernels.ptr(lse), G, Lq, Lk, d, _rounded_scale(scale, q.dtype),
        kernels.stream())
    kernels.check(err, "flash_attention")
    return out, lse


def _attention_bwd(q, k, v, out, lse, dout, scale: float):
    """The backward kernels: ``(dq, dk, dv)`` from the forward's inputs,
    ``out`` and ``lse`` and the output gradient ``dout``, by the four
    launches of ``csrc/flash_attention.cu``'s backward under
    :func:`_attn_bwd_plan`: a pre-pass (``bf16(q * s)`` rows and the
    padded ``(lse, delta = rowsum(dout * out))`` rows), dq, dk / dv as f32
    partials over query splits, and their sums."""
    G, Lq, d = q.shape
    Lk = k.shape[1]
    _require_rows("flash_attention_bwd", G, d, ("q", q, Lq), ("k", k, Lk),
                  ("v", v, Lk), ("out", out, Lq), ("dout", dout, Lq))
    kernels.require(lse, "lse", (G, Lq), q.device, torch.float32)
    plan = _checked_attn_bwd_plan(G, Lq, Lk, d, q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq, dk, dv, qs = (torch.empty_like(t) for t in (q, k, v, q))
    ld = torch.empty((G, plan["lqp"], 2), **f32)
    dk_part, dv_part = (torch.empty((plan["nsplit"], G, Lk, d), **f32)
                        for _ in range(2))
    err = kernels.lib().aicity_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), qs.data_ptr(), ld.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dk_part.data_ptr(),
        dv_part.data_ptr(), G, Lq, Lk, d, _rounded_scale(scale, q.dtype),
        plan["qps"], kernels.stream())
    kernels.check(err, "flash_attention_bwd")
    return dq, dk, dv


def flash_attention_fwd(q, k, v, scale: float, with_lse: bool):
    """:func:`flash_attention`'s forward kernel (see :func:`_attention_fwd`)."""
    res = _attention_fwd(q, k, v, scale, with_lse)
    flash_attention_fwd.launches += 1
    return res


def flash_attention_bwd(q, k, v, out, lse, dout, scale: float):
    """:func:`flash_attention`'s backward kernels (see
    :func:`_attention_bwd`)."""
    res = _attention_bwd(q, k, v, out, lse, dout, scale)
    flash_attention_bwd.launches += 1
    return res


def flash_attention_padded_fwd(q, k, v, scale: float, with_lse: bool):
    """:func:`flash_attention_padded`'s forward: the same kernel at odd
    lengths, counted apart."""
    res = _attention_fwd(q, k, v, scale, with_lse)
    flash_attention_padded_fwd.launches += 1
    return res


def flash_attention_padded_bwd(q, k, v, out, lse, dout, scale: float):
    """:func:`flash_attention_padded`'s backward: the same kernels at odd
    lengths, counted apart."""
    res = _attention_bwd(q, k, v, out, lse, dout, scale)
    flash_attention_padded_bwd.launches += 1
    return res


for _fn in (flash_attention_fwd, flash_attention_bwd,
            flash_attention_padded_fwd, flash_attention_padded_bwd):
    _fn.launches = 0
del _fn


class _FlashAttention(torch.autograd.Function):
    """The kernels under autograd; saves ``(q, k, v, out, lse)`` as the
    Pallas forward rule ``_flash_fwd`` does. ``fwd`` / ``bwd`` are the
    counted launchers of the calling wrapper."""

    @staticmethod
    def forward(ctx, q, k, v, scale, fwd, bwd):
        need = any(ctx.needs_input_grad[:3])
        out, lse = fwd(q, k, v, scale, with_lse=need)
        if need:
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.bwd = scale, bwd
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, out, lse, dout.contiguous(), ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, scale: float):
    """``softmax(bf16(q * scale) . k^T) . v`` over ``q [G, Lq, d]``, ``k,
    v [G, Lk, d]``. A CPU tensor runs the plain version (autograd
    differentiates it); a CUDA tensor the kernels, which take contiguous
    bf16 token rows with d = 96, forward and backward."""
    if not kernels.use_kernel(q):
        return flash_attention_plain(q, k, v, scale)
    return _FlashAttention.apply(q, k, v, scale, flash_attention_fwd,
                                 flash_attention_bwd)


def flash_attention_padded(q, k, v, scale: float):
    """:func:`flash_attention` at any lengths, e.g. a cls token's
    ``1 + T*H*W``. A CPU tensor runs the plain version (autograd
    differentiates it); a CUDA tensor the same kernels as
    :func:`flash_attention`, whose edge masks take the place of the Pallas
    wrapper's zero padding and ``kv_valid`` mask."""
    if not kernels.use_kernel(q):
        return flash_attention_plain(q, k, v, scale)
    return _FlashAttention.apply(q, k, v, scale, flash_attention_padded_fwd,
                                 flash_attention_padded_bwd)
