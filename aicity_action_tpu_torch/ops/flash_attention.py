"""Flash attention over raw pooled q/k/v with the per-head LayerNorms and
the MViT-v2 query residual fused in: the hand-written CUDA kernel and its
plain version.

Replaces ``aicity_action_tpu/ops/pallas/flash_attention.py:
flash_attention_ln`` (``_flash_ln_fwd_kernel``), which every MViT block runs
at inference. At 448 it sees head-major ``q [B*h, Lq, 96]`` and
``k, v [B*h, Lk, 96]`` with Lq up to 100352 and Lk in {1568, 6272}:
4*Lq*Lk*d flops against 2*(Lq + 2*Lk)*d bytes, so the tensor cores (and the
softmax's exponentials) bound it. The Pallas kernel keeps a group's whole
K/V in VMEM and normalizes it once per group; GPU blocks share nothing, so
``csrc/flash_attention_ln.cu`` normalizes K and V once, into token-row
scratch the wrapper allocates, then streams 64-key tiles of them through
shared memory (cp.async, double-buffered) with the running max / sum of
online softmax. It reads q, k, v in the d-major layout the pool
convolutions leave, so no transpose goes through device memory. Forward
only (the serving path).
"""

from __future__ import annotations

import torch

from . import kernels
from .layer_norm import layer_norm_plain

# the head dim the kernel is instantiated for (every MViT-v2 block's)
KERNEL_HEAD_DIM = 96
# logits the plain version materializes at once (f32 elements)
_PLAIN_CHUNK = 1 << 28


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
    dt = q.dtype
    fq, fk, fv = flags
    qb = layer_norm_plain(q, gq, bq, eps) if fq else q
    kb = layer_norm_plain(k, gk, bk, eps) if fk else k
    vb = layer_norm_plain(v, gv, bv, eps) if fv else v
    qs = (qb.float() * _rounded_scale(scale, dt)).to(dt)
    G, Lq, _ = q.shape
    Lk = k.shape[1]
    step = max(1, _PLAIN_CHUNK // max(1, Lq * Lk))
    outs = []
    for g0 in range(0, G, step):
        sl = slice(g0, g0 + step)
        s = qs[sl].float() @ kb[sl].float().transpose(1, 2)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        acc = p.to(dt).float() @ vb[sl].float()
        outs.append((acc / l).to(dt))
    out = torch.cat(outs, 0)
    return out + qb if add_qn else out


def flash_attention_ln(q, k, v, gq, bq, gk, bk, gv, bv, scale: float,
                       eps: float, flags, add_qn: bool):
    """Fused-LN attention (see :func:`flash_attention_ln_plain`).

    ``q [G, Lq, d]``, ``k``/``v [G, Lk, d]`` raw pooled tensors in the
    head-major layout. The plain version takes any strides; the kernel
    takes the d-major views ``x.transpose(1, 2)`` of contiguous
    ``[G, d, L]`` tensors (what the pool convolutions leave) and reads them
    as they lie. ``g*``/``b*`` are the ``[d]`` LN params (any values where
    the flag is off); ``flags`` the static (norm_q, norm_k, norm_v);
    ``add_qn`` adds the v2 query residual ``+ LN(q)``. Returns a contiguous
    ``[G, Lq, d]``.
    """
    if not kernels.use_kernel(q):
        return flash_attention_ln_plain(q, k, v, gq, bq, gk, bk, gv, bv,
                                        scale, eps, flags, add_qn)
    G, Lq, d = q.shape
    Lk = k.shape[1]
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"flash_attention_ln: the kernel takes head dim "
                         f"{KERNEL_HEAD_DIM}, got {d}")
    if G > 65535:
        raise ValueError(f"flash_attention_ln: {G} groups exceed the grid")
    if not all(_is_dmajor(t) for t in (q, k, v)) or Lq % 8:
        raise ValueError("flash_attention_ln: the kernel takes q, k, v as "
                         "d-major views of [G, d, L] tensors, Lq % 8 == 0")
    dev = q.device
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # contiguous [G, d, L]
    kernels.require(q, "q")
    kernels.require(k, "k", (G, d, Lk), dev)
    kernels.require(v, "v", (G, d, Lk), dev)
    for name, t in (("gq", gq), ("bq", bq), ("gk", gk), ("bk", bk),
                    ("gv", gv), ("bv", bv)):
        kernels.require(t, name, (d,), dev)
    out = torch.empty((G, Lq, d), dtype=q.dtype, device=dev)
    fq, fk, fv = (int(bool(f)) for f in flags)
    # scratch for the token rows of LN(k) / LN(v), made once before the
    # attention
    kn, vn = (torch.empty((G, Lk, d), dtype=k.dtype, device=dev)
              for _ in range(2))
    err = kernels.lib().aicity_flash_attention_ln(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), gq.data_ptr(),
        bq.data_ptr(), gk.data_ptr(), bk.data_ptr(), gv.data_ptr(),
        bv.data_ptr(), out.data_ptr(), kn.data_ptr(), vn.data_ptr(),
        G, Lq, Lk, d,
        _rounded_scale(scale, q.dtype), float(eps), fq, fk, fv,
        int(bool(add_qn)), kernels.stream())
    kernels.check(err, "flash_attention_ln")
    flash_attention_ln.launches += 1
    return out


flash_attention_ln.launches = 0
