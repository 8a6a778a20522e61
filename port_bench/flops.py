"""Operations, bytes and peaks: the benchmark's own arithmetic, counted
from a configuration's block shapes and never read from the program.

- :func:`forward_flops`: the multiply-adds x 2 of one clip's forward in
  every convolution and product (the patch stem, qkv, the depthwise q, k, v
  pools, the attention's two products, ``proj``, ``proj_max_pool``, the
  MLP, the head). LayerNorms, softmax, GELU, pooling maxima and adds are
  not counted. A training step's model FLOPs are 3 x this (forward,
  two backward products), recompute not counted.
- :func:`attention_calls`: each block's attention of one clip, ``(heads,
  Lq, Lk, d)`` at the model's own head dim (72 at MViT-v2-L, whatever width
  a kernel pads to).
- :func:`attention_bound_s`: the least time one clip's attention launches
  of a kind could take on the card: per launch the larger of its operations
  over the bf16 tensor-core peak and its bytes over the HBM bandwidth.
  Forward: ``4 G Lq Lk d`` operations; q, k, v read and the output written
  in bf16 (with ``lse``, its float32 row log-sum-exp too). Backward: ``10 G
  Lq Lk d`` operations (the scores again, dV, dP, dQ, dK); q, k, v, the
  output, its gradient (bf16) and the log-sum-exp (float32) read, dq, dk,
  dv written. Operations and bytes both grow with the batch, so a batch of
  B clips is bounded by B times one clip's bound.

Peaks: one NVIDIA H100 SXM at its 700 W limit, dense rates (NVIDIA's data
sheet): 989 TFLOP/s bf16, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import math

from .reference.mvit import blocks, patch_thw, pooled

PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def attention_calls(cfg: dict) -> list[tuple[int, int, int, int]]:
    """``(heads, Lq, Lk, d)`` of each block's attention for one clip."""
    thw = patch_thw(cfg)
    out = []
    for b in blocks(cfg):
        tq = pooled(thw, b.kernel_q, b.stride_q)
        tk = pooled(thw, b.kernel_kv, b.stride_kv)
        out.append((b.heads, math.prod(tq), math.prod(tk), b.head_dim))
        thw = tq
    return out


def block_flops(cfg: dict) -> list[dict]:
    """Each block's FLOPs for one clip, by product."""
    thw = patch_thw(cfg)
    ratio = cfg["MVIT"]["MLP_RATIO"]
    out = []
    for b in blocks(cfg):
        L = math.prod(thw)
        tq = pooled(thw, b.kernel_q, b.stride_q)
        tk = pooled(thw, b.kernel_kv, b.stride_kv)
        Lq, Lk = math.prod(tq), math.prod(tk)
        a, h, d = b.dim_att, b.heads, b.head_dim
        taps = math.prod(b.kernel_q)
        hidden = int(a * ratio)
        f = {
            "qkv": 2 * L * b.dim * 3 * a,
            "pool": 2 * taps * a * (Lq + 2 * Lk),
            "attention": 4 * h * Lq * Lk * d,
            "proj": 2 * Lq * a * a,
            "proj_max_pool": 2 * L * b.dim * b.dim_out if b.dim != b.dim_out
            else 0,
            "mlp": 2 * Lq * a * hidden + 2 * Lq * hidden * b.dim_out,
        }
        out.append(f)
        thw = tq
    return out


def forward_flops(cfg: dict) -> float:
    """FLOPs of one clip's forward (see the module's docstring)."""
    m = cfg["MVIT"]
    T, H, W = patch_thw(cfg)
    stem = (2 * T * H * W * m["EMBED_DIM"] * cfg["DATA"]["INPUT_CHANNEL_NUM"][0]
            * math.prod(m["PATCH_KERNEL"]))
    last = blocks(cfg)[-1].dim_out
    head = 2 * last * cfg["MODEL"]["NUM_CLASSES"]
    return float(stem + head + sum(sum(f.values()) for f in block_flops(cfg)))


def attention_launch(G: int, Lq: int, Lk: int, d: int, kind: str
                     ) -> tuple[float, float]:
    """``(operations, bytes)`` of one attention launch over ``G`` groups;
    ``kind`` is ``fwd`` (no log-sum-exp), ``fwd_lse`` or ``bwd``."""
    qo, kv = G * Lq * d, G * Lk * d
    if kind == "bwd":
        return (10.0 * G * Lq * Lk * d,
                2.0 * (3 * qo + 2 * kv) + 4.0 * G * Lq + 2.0 * (qo + 2 * kv))
    ops = 4.0 * G * Lq * Lk * d
    nbytes = 2.0 * (2 * qo + 2 * kv)
    if kind == "fwd_lse":
        nbytes += 4.0 * G * Lq
    elif kind != "fwd":
        raise ValueError(f"unknown attention launch kind {kind!r}")
    return ops, nbytes


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_BF16, nbytes / PEAK_BYTES)


def attention_bound_s(cfg: dict, kind: str) -> float:
    """Seconds: the bound of one clip's attention launches of ``kind``, one
    a block."""
    return sum(bound_s(*attention_launch(h, Lq, Lk, d, kind))
               for h, Lq, Lk, d in attention_calls(cfg))
