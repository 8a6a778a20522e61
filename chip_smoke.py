#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``aicity_action_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``aicity_action_tpu_torch/csrc`` with nvcc
   (sm_90a, one process per source) and prints the card's name and power
   limit.
2. Holds each inference kernel against its plain PyTorch version at
   main-path shapes of MViT-v2-B 16x4 @ 448 (batch 8, bf16; every tile
   configuration a kernel has on the path) and times the kernel, the plain
   version and a PyTorch library yardstick with CUDA events.
3. Does the same for the training kernels (the flash attention forward
   with its logsumexp, and the backward kernels of attention, LayerNorm,
   LN+qkv and LN+MLP) at the batch-4 training shapes of blocks 0, 1 and 15.
4. Builds the full model (16 blocks, bf16, weights from a seed), runs
   batch-8 forwards, checks the kernel launches per forward, and compares a
   batch-1 forward with the same model in its plain reference mode.
5. Drives the serving path, ``WindowScorer``, over a synthetic in-memory
   I420 video, with the launch counts set to 0 just before and read just
   after; checks the windows against a direct forward and round-trips the
   pickle.
6. Drives the training path, ``make_train_step``, at batch 4 with mixup,
   activation checkpointing and AdamW (two warm-up steps, then timed
   steps; the counts set to 0 just before the timed steps and read just
   after, and held to the counts the config implies), then compares one
   batch-1 step's gradients with the model's plain reference mode.
7. Prints ``{"kernels": [...]}``, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the run exits non-zero and prints no result.
With no CUDA card, or without the package beside this file, it exits 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
BATCH = 8
TRAIN_BATCH = 4
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# kernel vs plain version in bf16: outputs are rounded to bf16 (relative
# step 2^-8) and the two may round their bf16 intermediates (LN'd operands,
# softmax weights, the MLP hidden) one ulp apart, so allow 2% of the
# output's largest magnitude
KERNEL_RTOL = 0.02

_REPO = os.path.dirname(os.path.abspath(__file__))


def _fail(msg: str) -> None:
    raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_kernels():
    from aicity_action_tpu_torch.ops import kernels

    t = time.time()
    so = kernels.build()
    kernels.lib()
    log = (kernels.BUILD_DIR / "build.log")
    usage = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    print(f"# built {so.name} in {time.time() - t:.1f} s")
    for ln in usage:
        print(f"#   {ln}")


# ------------------------------------------------------------------ kernels

def _normal(gen, shape, std=1.0, dtype=None, device="cuda"):
    import torch

    t = torch.randn(shape, generator=gen, device=device) * std
    return t.to(dtype) if dtype is not None else t


def _check_case(name, kernel_fn, plain_fn, library_fn, flops, nbytes,
                peak, iters):
    """Compare one kernel call with its plain version, time all three."""
    import torch

    out = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    if len(outs) != len(refs):
        _fail(f"{name}: {len(outs)} outputs against {len(refs)}")
    # each output within KERNEL_RTOL of its own largest magnitude
    err, tol, rel = 0.0, 0.0, 0.0
    for i, (o, r) in enumerate(zip(outs, refs)):
        if o.shape != r.shape or not torch.isfinite(o).all():
            _fail(f"{name}: output {i} non-finite or mis-shaped")
        e = (o.float() - r.float()).abs().max().item()
        t = KERNEL_RTOL * max(r.float().abs().max().item(), 1e-30)
        if not e <= t:
            _fail(f"{name}: output {i}: max |kernel - plain| {e} > {t}")
        err, tol, rel = max(err, e), max(tol, t), max(rel, e / t * KERNEL_RTOL)
    del out, ref, outs, refs
    ms = time_ms(kernel_fn, iters)
    plain_ms = time_ms(plain_fn, max(1, iters // 5))
    library_ms = time_ms(library_fn, iters) if library_fn else None
    bound_ms = max(flops / peak, nbytes / PEAK_BYTES) * 1e3
    return {
        "max_abs_err": err, "tol": tol, "max_rel_err": rel, "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if flops / peak > nbytes / PEAK_BYTES
        else "bytes",
        "library_ms": library_ms,
    }


def kernel_checks():
    """Each kernel at its main-path shapes (batch 8 unless stated)."""
    import torch
    import torch.nn.functional as F

    from aicity_action_tpu_torch.ops import flash_attention as fa
    from aicity_action_tpu_torch.ops import fused_dense as fd
    from aicity_action_tpu_torch.ops import layer_norm as ln

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}

    # fused_layer_norm: the final norm [B*1568, 768], groups 1, eps 1e-6
    cases = []
    for b in (BATCH, 1):
        M, C = b * 1568, 768
        x = _normal(gen, (M, C), 2.0, bf)
        g = _normal(gen, (C,), 0.1, bf) + 1
        bb = _normal(gen, (C,), 0.1, bf)
        r = _check_case(
            "fused_layer_norm",
            lambda: ln.fused_layer_norm(x, g, bb, 1e-6, 1),
            lambda: ln.layer_norm_plain(x, g, bb, 1e-6, 1),
            lambda: F.layer_norm(x, (C,), g, bb, 1e-6),
            flops=8 * M * C, nbytes=2 * (2 * M * C + 2 * C), peak=PEAK_F32,
            iters=50)
        r["shape"] = f"final norm x[{M},{C}] groups 1 (batch {b})"
        cases.append(r)
    results["fused_layer_norm"] = cases

    # fused_ln_qkv: block 0 (D 96 -> 3C 288 over 100352 tokens), blocks
    # 4-13 (D 384 -> 3C 1152 over 6272 tokens; the 128-column tiles) and
    # block 15 (D 768 -> 3C 2304 over 1568 tokens), writing channel-major
    # [B, C, L]
    cases = []
    for blk, L, D, C in ((0, 100352, 96, 96), (4, 6272, 384, 384),
                         (15, 1568, 768, 768)):
        M = BATCH * L
        x = _normal(gen, (M, D), 1.0, bf)
        g = _normal(gen, (D,), 0.1, bf) + 1
        bb = _normal(gen, (D,), 0.1, bf)
        w = _normal(gen, (3 * C, D), D ** -0.5, bf)
        bias = _normal(gen, (3 * C,), 0.1, bf)
        args = (x, g, bb, w, bias, 1e-6)

        def library(x=x, g=g, bb=bb, w=w, bias=bias, D=D):
            return F.linear(F.layer_norm(x, (D,), g, bb, 1e-6), w, bias)

        r = _check_case(
            "fused_ln_qkv",
            lambda args=args, L=L: fd.fused_ln_qkv(*args, tokens=L),
            lambda args=args, L=L: fd.ln_qkv_plain(*args, tokens=L),
            library,
            flops=2 * M * D * 3 * C,
            nbytes=2 * (M * D + 3 * M * C + 3 * C * D + 3 * C + 2 * D),
            peak=PEAK_BF16, iters=20)
        r["shape"] = f"block {blk} x[{M},{D}] w[{3 * C},{D}] -> [B,C,L]"
        cases.append(r)
        del x, w, args
    results["fused_ln_qkv"] = cases

    # fused_ln_mlp: one block of each tile configuration: block 0 (C 96
    # over 100352 tokens), block 1 (C 192 over 25088), block 4 (C 384 over
    # 6272) and block 15 (C 768 over 1568); H = 4C
    cases = []
    for blk, L, C in ((0, 100352, 96), (1, 25088, 192), (4, 6272, 384),
                      (15, 1568, 768)):
        M, H = BATCH * L, 4 * C
        x = _normal(gen, (M, C), 1.0, bf)
        g = _normal(gen, (C,), 0.1, bf) + 1
        bb = _normal(gen, (C,), 0.1, bf)
        w1 = _normal(gen, (H, C), C ** -0.5, bf)
        b1 = _normal(gen, (H,), 0.1, bf)
        w2 = _normal(gen, (C, H), H ** -0.5, bf)
        b2 = _normal(gen, (C,), 0.1, bf)
        args = (x, g, bb, w1, b1, w2, b2, 1e-6)

        def library(x=x, g=g, bb=bb, w1=w1, b1=b1, w2=w2, b2=b2, C=C):
            h = F.gelu(F.linear(F.layer_norm(x, (C,), g, bb, 1e-6), w1, b1))
            return F.linear(h, w2, b2)

        r = _check_case(
            "fused_ln_mlp",
            lambda args=args: fd.fused_ln_mlp(*args),
            lambda args=args: fd.ln_mlp_plain(*args),
            library,
            flops=2 * M * (C * H + H * C),
            nbytes=2 * (2 * M * C + 2 * C * H + H + 3 * C),
            peak=PEAK_BF16, iters=10)
        r["shape"] = f"block {blk} x[{M},{C}] H {H}"
        cases.append(r)
    results["fused_ln_mlp"] = cases

    # flash_attention_ln: block 0 (h 1, Lq 100352, Lk 1568) and block 1
    # (h 2, Lq 25088, Lk 6272); d 96, all three LNs and the q-residual; q,
    # k, v are the d-major views the main path passes (pool outputs
    # [G, d, L])
    cases = []
    d = 96
    for blk, h, Lq, Lk in ((0, 1, 100352, 1568), (1, 2, 25088, 6272)):
        G = BATCH * h
        q, k, v = (_normal(gen, (G, d, n), 1.0, bf).transpose(1, 2)
                   for n in (Lq, Lk, Lk))
        lnp = [t for _ in range(3) for t in (
            _normal(gen, (d,), 0.1, bf) + 1, _normal(gen, (d,), 0.1, bf))]
        args = (q, k, v, *lnp, d ** -0.5, 1e-5, (True, True, True), True)

        def library(q=q, k=k, v=v, lnp=lnp):
            qn, kn, vn = (F.layer_norm(t, (d,), lnp[2 * i], lnp[2 * i + 1],
                                       1e-5) for i, t in enumerate((q, k, v)))
            return F.scaled_dot_product_attention(qn, kn, vn) + qn

        r = _check_case(
            "flash_attention_ln",
            lambda args=args: fa.flash_attention_ln(*args),
            lambda args=args: fa.flash_attention_ln_plain(*args),
            library,
            flops=4 * G * Lq * Lk * d,
            nbytes=2 * (2 * G * Lq * d + 2 * G * Lk * d + 6 * d),
            peak=PEAK_BF16, iters=5)
        r["shape"] = (f"block {blk} q[{G},{Lq},{d}] k,v[{G},{Lk},{d}] "
                      "d-major")
        cases.append(r)
        del q, k, v, args
    results["flash_attention_ln"] = cases
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------- training kernels

def _plain_grads(fn, inputs, cotangents):
    """Gradients of the plain version ``fn`` in f32 at the kernel's bf16
    inputs: the plain forward, then autograd."""
    import torch

    ts = [t.detach().float().requires_grad_() for t in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, ts, [c.float() for c in cotangents])


def _library_grads(fn, inputs, cotangents):
    """One PyTorch library call's forward and autograd backward (the
    yardstick), in the inputs' type."""
    import torch

    ts = [t.detach().requires_grad_() for t in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, ts, cotangents)


def train_kernel_checks():
    """The training kernels at the batch-4 training shapes of blocks 0, 1
    and 15 (each kernel against its plain version, computed in f32 from
    the same bf16 inputs, differentiated by autograd; plain and library
    times are of forward + backward)."""
    import torch
    import torch.nn.functional as F

    from aicity_action_tpu_torch.ops import flash_attention as fa
    from aicity_action_tpu_torch.ops import fused_dense as fd
    from aicity_action_tpu_torch.ops import layer_norm as ln

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    B, d = TRAIN_BATCH, 96
    scale = d ** -0.5
    results = {}

    # flash attention forward (with lse) and backward: block 0 (h 1, Lq
    # 100352, Lk 1568), block 1 (h 2, Lq 25088, Lk 6272), block 15 (h 8,
    # Lq = Lk = 1568), head-major token rows
    fwd, bwd = [], []
    for blk, h, Lq, Lk in ((0, 1, 100352, 1568), (1, 2, 25088, 6272),
                           (15, 8, 1568, 1568)):
        G = B * h
        q, k, v = (_normal(gen, (G, n, d), 1.0, bf) for n in (Lq, Lk, Lk))
        shape = f"block {blk} q[{G},{Lq},{d}] k,v[{G},{Lk},{d}]"
        flops = 4 * G * Lq * Lk * d
        io = 2 * (2 * G * Lq * d + 2 * G * Lk * d)
        r = _check_case(
            "flash_attention",
            lambda q=q, k=k, v=v: fa.flash_attention_fwd(q, k, v, scale,
                                                         True),
            lambda q=q, k=k, v=v: fa.flash_attention_lse_plain(
                q.float(), k.float(), v.float(), scale),
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v),
            flops=flops, nbytes=io + 4 * G * Lq, peak=PEAK_BF16, iters=3)
        r["shape"] = shape + " (+ lse)"
        fwd.append(r)
        if blk == 0:  # the lse-free mode (inference with pool modes max/avg)
            r = _check_case(
                "flash_attention",
                lambda q=q, k=k, v=v: fa.flash_attention_fwd(
                    q, k, v, scale, False)[0],
                lambda q=q, k=k, v=v: fa.flash_attention_plain(
                    q.float(), k.float(), v.float(), scale),
                lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k,
                                                                     v),
                flops=flops, nbytes=io, peak=PEAK_BF16, iters=3)
            r["shape"] = shape + " (no lse)"
            fwd.append(r)
        out, lse = fa.flash_attention_fwd(q, k, v, scale, True)
        dout = _normal(gen, (G, Lq, d), 1.0, bf)
        r = _check_case(
            "flash_attention_bwd",
            lambda q=q, k=k, v=v, out=out, lse=lse, dout=dout:
                fa.flash_attention_bwd(q, k, v, out, lse, dout, scale),
            lambda q=q, k=k, v=v, dout=dout: _plain_grads(
                lambda a, b, c: fa.flash_attention_plain(a, b, c, scale),
                (q, k, v), (dout,)),
            lambda q=q, k=k, v=v, dout=dout: _library_grads(
                F.scaled_dot_product_attention, (q, k, v), (dout,)),
            # the five products of the backward (S recomputed once), the
            # inputs q, k, v, out, dout, lse read once, dq, dk, dv written
            flops=10 * G * Lq * Lk * d,
            nbytes=2 * (4 * G * Lq * d + 4 * G * Lk * d) + 4 * G * Lq,
            peak=PEAK_BF16, iters=2)
        r["shape"] = shape
        bwd.append(r)
        del q, k, v, out, lse, dout
        torch.cuda.empty_cache()
    results["flash_attention"] = fwd
    results["flash_attention_bwd"] = bwd

    # LayerNorm backward: block 0's q norm (per head over d 96, 401408
    # rows), block 1's k norm (50176 rows), block 15's q norm (50176 rows)
    # and the final norm [B*1568, 768]
    cases = []
    for what, M, C, eps in (("block 0 q norm", B * 100352, 96, 1e-5),
                            ("block 1 k norm", B * 2 * 6272, 96, 1e-5),
                            ("block 15 q norm", B * 8 * 1568, 96, 1e-5),
                            ("final norm", B * 1568, 768, 1e-6)):
        x = _normal(gen, (M, C), 2.0, bf)
        g = _normal(gen, (C,), 0.1, bf) + 1
        bb = _normal(gen, (C,), 0.1, bf)
        dy = _normal(gen, (M, C), 1.0, bf)
        r = _check_case(
            "fused_layer_norm_bwd",
            lambda x=x, g=g, dy=dy, eps=eps: ln.fused_layer_norm_bwd(
                x, g, dy, eps, 1),
            lambda x=x, g=g, bb=bb, dy=dy, eps=eps: _plain_grads(
                lambda a, b, c: ln.layer_norm_plain(a, b, c, eps, 1),
                (x, g, bb), (dy,)),
            lambda x=x, g=g, bb=bb, dy=dy, C=C, eps=eps: _library_grads(
                lambda a, b, c: F.layer_norm(a, (C,), b, c, eps),
                (x, g, bb), (dy,)),
            flops=20 * M * C, nbytes=2 * (3 * M * C + 3 * C),
            peak=PEAK_F32, iters=10)
        r["shape"] = f"{what} x[{M},{C}]"
        cases.append(r)
        del x, dy
    results["fused_layer_norm_bwd"] = cases

    # LN+qkv backward: block 0 (D 96, 3C 288, L 100352), block 1 (D 96,
    # 3C 576, L 100352), block 15 (D 768, 3C 2304, L 1568); the gradients
    # of q, k, v channel-major [B, C, L] as the forward wrote them
    cases = []
    for blk, L, D, C in ((0, 100352, 96, 96), (1, 100352, 96, 192),
                         (15, 1568, 768, 768)):
        M = B * L
        x = _normal(gen, (M, D), 1.0, bf)
        g = _normal(gen, (D,), 0.1, bf) + 1
        bb = _normal(gen, (D,), 0.1, bf)
        w = _normal(gen, (3 * C, D), D ** -0.5, bf)
        bias = _normal(gen, (3 * C,), 0.1, bf)
        gq, gk, gv = (_normal(gen, (B, C, L), 1.0, bf) for _ in range(3))

        def library(x=x, g=g, bb=bb, w=w, bias=bias, D=D, L=L, C=C,
                    gs=(gq, gk, gv)):
            cot = torch.cat([t.transpose(1, 2).reshape(-1, C) for t in gs],
                            1)
            return _library_grads(
                lambda a, b, c, ww, wb: F.linear(
                    F.layer_norm(a, (D,), b, c, 1e-6), ww, wb),
                (x, g, bb, w, bias), (cot,))

        r = _check_case(
            "fused_ln_qkv_bwd",
            lambda x=x, g=g, bb=bb, w=w, gs=(gq, gk, gv), L=L:
                fd.fused_ln_qkv_bwd(x, g, bb, w, *gs, 1e-6, L),
            lambda x=x, g=g, bb=bb, w=w, bias=bias, gs=(gq, gk, gv), L=L:
                _plain_grads(lambda *a: fd.ln_qkv_plain(*a, 1e-6, L),
                             (x, g, bb, w, bias), gs),
            library,
            flops=4 * M * D * 3 * C,
            nbytes=2 * (2 * M * D + 3 * M * C + 2 * 3 * C * D + 3 * C
                        + 4 * D),
            peak=PEAK_BF16, iters=5)
        r["shape"] = f"block {blk} x[{M},{D}] w[{3 * C},{D}]"
        cases.append(r)
        del x, w, gq, gk, gv
        torch.cuda.empty_cache()
    results["fused_ln_qkv_bwd"] = cases

    # LN+MLP backward: block 0 (C 96 over 401408 rows), block 1 (C 192
    # over 100352), block 15 (C 768 over 6272); H = 4C
    cases = []
    for blk, M, C in ((0, B * 100352, 96), (1, B * 25088, 192),
                      (15, B * 1568, 768)):
        H = 4 * C
        x = _normal(gen, (M, C), 1.0, bf)
        g = _normal(gen, (C,), 0.1, bf) + 1
        bb = _normal(gen, (C,), 0.1, bf)
        w1 = _normal(gen, (H, C), C ** -0.5, bf)
        b1 = _normal(gen, (H,), 0.1, bf)
        w2 = _normal(gen, (C, H), H ** -0.5, bf)
        b2 = _normal(gen, (C,), 0.1, bf)
        dout = _normal(gen, (M, C), 1.0, bf)
        args = (x, g, bb, w1, b1, w2, b2)

        def library(args=args, dout=dout, C=C):
            return _library_grads(
                lambda a, b, c, u1, c1, u2, c2: F.linear(F.gelu(F.linear(
                    F.layer_norm(a, (C,), b, c, 1e-6), u1, c1)), u2, c2),
                args, (dout,))

        r = _check_case(
            "fused_ln_mlp_bwd",
            lambda args=args, dout=dout: fd.fused_ln_mlp_bwd(
                *args[:6], dout, 1e-6),
            lambda args=args, dout=dout: _plain_grads(
                lambda *a: fd.ln_mlp_plain(*a, 1e-6), args, (dout,)),
            library,
            # fc1 recomputed, dh, dW2, dW1, dLN(x): five products
            flops=10 * M * C * H,
            nbytes=2 * (3 * M * C + 4 * C * H + 2 * H + 5 * C),
            peak=PEAK_BF16, iters=3)
        r["shape"] = f"block {blk} x[{M},{C}] H {H}"
        cases.append(r)
        del x, dout, args
        torch.cuda.empty_cache()
    results["fused_ln_mlp_bwd"] = cases
    return results


# ------------------------------------------------------------------ model

KERNEL_FNS = ("fused_ln_qkv", "flash_attention_ln", "fused_ln_mlp",
              "fused_layer_norm")
TRAIN_KERNEL_FNS = ("flash_attention", "flash_attention_bwd",
                    "fused_ln_qkv_bwd", "fused_ln_mlp_bwd",
                    "fused_layer_norm_bwd")
SOURCES = {
    "fused_ln_qkv": ("aicity_action_tpu_torch/csrc/fused_ln_qkv.cu",
                     "aicity_action_tpu/ops/pallas/fused_dense.py:74"),
    "flash_attention_ln": (
        "aicity_action_tpu_torch/csrc/flash_attention_ln.cu",
        "aicity_action_tpu/ops/pallas/flash_attention.py:805"),
    "fused_ln_mlp": ("aicity_action_tpu_torch/csrc/fused_ln_mlp.cu",
                     "aicity_action_tpu/ops/pallas/fused_dense.py:314"),
    "fused_layer_norm": ("aicity_action_tpu_torch/csrc/layer_norm.cu",
                         "aicity_action_tpu/ops/pallas/layer_norm.py:64"),
    "flash_attention": ("aicity_action_tpu_torch/csrc/flash_attention.cu",
                        "aicity_action_tpu/ops/pallas/flash_attention.py:261"),
    "flash_attention_bwd": (
        "aicity_action_tpu_torch/csrc/flash_attention.cu",
        "aicity_action_tpu/ops/pallas/flash_attention.py:550"),
    "fused_ln_qkv_bwd": ("aicity_action_tpu_torch/csrc/fused_ln_qkv_bwd.cu",
                         "aicity_action_tpu/ops/pallas/fused_dense.py:175"),
    "fused_ln_mlp_bwd": ("aicity_action_tpu_torch/csrc/fused_ln_mlp_bwd.cu",
                         "aicity_action_tpu/ops/pallas/fused_dense.py:414"),
    "fused_layer_norm_bwd": ("aicity_action_tpu_torch/csrc/layer_norm.cu",
                             "aicity_action_tpu/ops/pallas/layer_norm.py:104"),
}
PER_FORWARD = {"fused_ln_qkv": 16, "flash_attention_ln": 16,
               "fused_ln_mlp": 16, "fused_layer_norm": 1,
               **{name: 0 for name in TRAIN_KERNEL_FNS}}


def _wrappers():
    from aicity_action_tpu_torch.ops import flash_attention as fa
    from aicity_action_tpu_torch.ops import fused_dense as fd
    from aicity_action_tpu_torch.ops import layer_norm as ln

    return {"fused_ln_qkv": fd.fused_ln_qkv,
            "flash_attention_ln": fa.flash_attention_ln,
            "fused_ln_mlp": fd.fused_ln_mlp,
            "fused_layer_norm": ln.fused_layer_norm,
            "flash_attention": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "fused_ln_qkv_bwd": fd.fused_ln_qkv_bwd,
            "fused_ln_mlp_bwd": fd.fused_ln_mlp_bwd,
            "fused_layer_norm_bwd": ln.fused_layer_norm_bwd}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def model_checks(card: str):
    import torch

    from aicity_action_tpu_torch.config import mvitv2_b_16x4_448_cfg
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.ops import kernels

    cfg = mvitv2_b_16x4_448_cfg()
    model = build_model(cfg, device="cuda", seed=SEED)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = _normal(gen, (BATCH, T, S, S, 3))

    with torch.no_grad():
        reset_counts()
        out = model(x)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != PER_FORWARD:
            _fail(f"launches per forward {counts} != {PER_FORWARD}")
        if out.shape != (BATCH, cfg.MODEL.NUM_CLASSES) or \
                not torch.isfinite(out).all():
            _fail("batch-8 forward: non-finite or mis-shaped scores")
        ms = time_ms(lambda: model(x), iters=5)
        print(f"# MViT-v2-B 16x4 @448 forward, batch {BATCH} bf16: "
              f"{ms:.2f} ms, {BATCH / ms * 1e3:.2f} clips/s ({card})")

        # batch 1: kernels against the same model in plain reference mode;
        # the features entering the head are compared too, since softmax
        # scores of random weights sit near 1/num_classes
        feats = []
        hook = model.head.register_forward_hook(
            lambda mod, inp, outp: feats.append(inp[0].float()))
        x1 = x[:1]
        out_k = model(x1)
        with kernels.plain_reference():
            out_p = model(x1)
        hook.remove()
        torch.cuda.synchronize()
    feat_err = ((feats[0] - feats[1]).norm() / feats[1].norm()).item()
    score_err = (out_k - out_p).abs().max().item()
    print(f"# batch-1 forward, kernels vs plain reference: head-input "
          f"relative L2 error {feat_err:.3e} (tol 5e-2), max |score "
          f"error| {score_err:.3e} (tol 1e-2)")
    if not (feat_err <= 5e-2 and score_err <= 1e-2):
        _fail("the model's kernel path disagrees with its plain reference")
    return model, cfg, {"forward_ms": ms, "clips_per_s": BATCH / ms * 1e3,
                        "feat_rel_err": feat_err, "score_err": score_err}


# ------------------------------------------------------------------ scorer

def synthetic_i420(num_frames: int, s: int, seed: int) -> np.ndarray:
    """A video of moving gradients plus noise as I420 u8 ``[N, s*3//2, s]``,
    made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:s, 0:s]
    out = np.empty((num_frames, s * 3 // 2, s), np.uint8)
    for i in range(num_frames):
        base = (yy + 3 * i) % 220 + 16 + rng.integers(0, 8, (s, s))
        out[i, :s] = base.astype(np.uint8)
        out[i, s:] = rng.integers(64, 192, (s // 2, s), dtype=np.uint8)
    return out


def scorer_checks(model, cfg):
    import torch

    from aicity_action_tpu_torch.data.decoder import sample_indices
    from aicity_action_tpu_torch.pipeline.window_inference import (
        WindowScorer, i420_to_rgb, load_window_predictions,
        save_window_predictions, window_plans, window_spans)

    s = cfg.DATA.TEST_CROP_SIZE
    n_frames, chunk = 300, 96
    video = synthetic_i420(n_frames, s, SEED + 2)
    spans = window_spans(n_frames, 30.0, cfg.DATA.NUM_FRAMES, 4, 16, 30.0)
    plans = window_plans(spans, cfg.DATA.NUM_FRAMES, n_frames)

    def chunks():
        for c0 in range(0, 10 ** 9, chunk):
            part = video[c0:c0 + chunk]
            if len(part) < chunk:  # EOF: repeat the last frame
                pad = np.repeat(video[-1:], chunk - len(part), 0)
                part = np.concatenate([part, pad]) if len(part) else pad
            yield part

    scorer = WindowScorer(model, batch_size=BATCH, chunk_frames=chunk)
    reset_counts()
    torch.cuda.synchronize()
    t = time.time()
    preds = scorer.score_chunks(chunks(), plans, s, cfg.DATA.MEAN,
                                cfg.DATA.STD)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = read_counts()
    for name in KERNEL_FNS:
        if launches[name] == 0:
            _fail(f"{name} was not launched on the serving path")

    if [(p[0], p[1]) for p in preds] != sorted(spans):
        _fail("scorer windows differ from the enumerated spans")
    scores = np.stack([p[2] for p in preds])
    if not np.isfinite(scores).all():
        _fail("non-finite window scores")
    if not np.allclose(scores.sum(1), 1.0, atol=1e-3):
        _fail("window scores do not sum to 1")

    # windows scored directly from their sample_indices frames: the first
    # one, one whose frames straddle a chunk boundary, and the last one
    mean = torch.tensor(cfg.DATA.MEAN, device="cuda")
    std = torch.tensor(cfg.DATA.STD, device="cuda")
    straddle = next(i for i, (_, _, idx) in enumerate(plans)
                    if idx[0] // chunk != idx[-1] // chunk)
    check = [0, straddle, len(plans) - 1]
    idx = np.stack([sample_indices(plans[i][0], plans[i][1],
                                   cfg.DATA.NUM_FRAMES, n_frames)
                    for i in check])
    yuv = torch.from_numpy(video[idx]).cuda()
    with torch.no_grad():
        direct = model((i420_to_rgb(yuv, s) / 255.0 - mean) / std)
    direct = direct.float().cpu().numpy()
    gather_err = float(np.abs(direct - scores[check]).max())
    # the direct batch has 3 windows, the scorer's batches up to 8: cuDNN may
    # pick other algorithms per batch size, so allow bf16-level noise
    if not gather_err <= 1e-2:
        _fail(f"gathered windows differ from direct scoring: {gather_err}")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "video.pkl")
        save_window_predictions(preds, path)
        back = load_window_predictions(path)
    if [(a[0], a[1]) for a in back] != [(a[0], a[1]) for a in preds] or \
            not all(np.array_equal(a[2], b[2]) for a, b in zip(back, preds)):
        _fail("prediction pickle did not round-trip")
    print(f"# WindowScorer: {len(preds)} windows of {n_frames} frames "
          f"(chunks of {chunk}) in {wall:.2f} s, "
          f"{len(preds) / wall:.2f} windows/s; direct-vs-gather max error "
          f"{gather_err:.2e} (tol 1e-2); launches {launches}")
    return launches


# ------------------------------------------------------------------ train

def train_per_step(model) -> dict:
    """Kernel launches one train step implies, derived from the model: per
    block one LN+qkv, one attention and one LN+MLP, each forward run twice
    under activation checkpointing (the recompute); one pool norm per
    conv-pooled q / k / v of a block, and the final norm once."""
    remat = 2 if model.spec.act_checkpoint else 1
    depth = len(model.blocks)
    norms = sum(len(b.attn.pooled) for b in model.blocks
                if b.attn.mode == "conv")
    final = int(model.norm is not None)
    return {"fused_ln_qkv": remat * depth, "flash_attention_ln": 0,
            "fused_ln_mlp": remat * depth,
            "fused_layer_norm": remat * norms + final,
            "flash_attention": remat * depth, "flash_attention_bwd": depth,
            "fused_ln_qkv_bwd": depth, "fused_ln_mlp_bwd": depth,
            "fused_layer_norm_bwd": norms + final}


def train_checks(card: str):
    """The full MViT-v2-B 16x4 @448 train step at batch 4 (mixup, activation
    checkpointing, AdamW, bf16 compute, f32 params and optimizer state)."""
    import torch

    from aicity_action_tpu_torch.config import mvitv2_b_16x4_448_cfg
    from aicity_action_tpu_torch.data.mixup import build_mixup_from_cfg
    from aicity_action_tpu_torch.engine.steps import make_train_step
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.solver.optimizer import construct_optimizer

    cfg = mvitv2_b_16x4_448_cfg()
    cfg.MIXUP.ENABLE = True
    if not cfg.MODEL.ACT_CHECKPOINT:
        _fail("the 448 recipe is expected to checkpoint activations")
    model = build_model(cfg, device="cuda", seed=SEED)
    opt = construct_optimizer(cfg, model, steps_per_epoch=100)
    step = make_train_step(model, opt, cfg.MODEL.LOSS_FUNC,
                           mixup_fn=build_mixup_from_cfg(cfg),
                           num_classes=cfg.MODEL.NUM_CLASSES, seed=SEED)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    batch = {"inputs": _normal(gen, (TRAIN_BATCH, T, S, S, 3)),
             "labels": torch.randint(0, cfg.MODEL.NUM_CLASSES,
                                     (TRAIN_BATCH,), generator=gen,
                                     device="cuda")}
    losses = []
    for _ in range(TRAIN_WARMUP):
        losses.append(float(step(batch)[0]["loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    metrics = [step(batch)[0] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / TRAIN_STEPS
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses += [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    want = {k: TRAIN_STEPS * v for k, v in train_per_step(model).items()}
    print(f"# MViT-v2-B 16x4 @448 train step, batch {TRAIN_BATCH}, mixup, "
          f"activation checkpointing, AdamW: {ms:.2f} ms/step, "
          f"{TRAIN_BATCH / ms * 1e3:.3f} clips/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({card}); losses {losses}; grad norms "
          f"{norms}; launches over {TRAIN_STEPS} steps {launches}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        _fail("non-finite loss or gradient norm in the train step")
    if launches != want:
        _fail(f"train-step launches {launches} != {want}")
    stats = {"ms_per_step": ms, "clips_per_s": TRAIN_BATCH / ms * 1e3,
             "peak_mem_bytes": peak, "losses": losses, "grad_norms": norms,
             "launches_per_step": {k: v // TRAIN_STEPS
                                   for k, v in launches.items()}}
    del step, opt, batch
    return model, cfg, launches, stats


def train_grad_check(cfg):
    """One batch-1 step's loss and gradients (no update) with the kernels
    against the same model in its plain reference mode: the same params,
    mixup draw and DropPath / dropout masks. The model is built afresh from
    the seed: the train steps before would leave params that depend on the
    order of the convolutions' backward sums, and so a check that moves
    from run to run."""
    import torch

    from aicity_action_tpu_torch.data.mixup import build_mixup_from_cfg
    from aicity_action_tpu_torch.engine.steps import step_generators
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.models.losses import soft_cross_entropy
    from aicity_action_tpu_torch.ops import kernels
    from aicity_action_tpu_torch.solver.optimizer import global_norm

    model = build_model(cfg, device="cuda", seed=SEED)

    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = _normal(gen, (1, T, S, S, 3))
    y = torch.tensor([5], device="cuda")
    mix = build_mixup_from_cfg(cfg)
    model.train()
    params = [p for p in model.parameters()]

    def run(xx=x):
        g, rng = step_generators(SEED, 7, "cuda")
        inputs, targets = mix(xx, y, rng)
        model.zero_grad(set_to_none=True)
        loss = soft_cross_entropy(model(inputs, generator=g), targets)
        loss.backward()
        return (loss.item(), global_norm(params).item(),
                [p.grad.detach().float().clone() for p in params])

    loss_k, norm_k, grads_k = run()
    with kernels.plain_reference():
        loss_p, norm_p, grads_p = run()
        # the noise floor: the plain reference itself with its input moved
        # by a bf16 rounding (relative 2^-9); the early blocks' conv-pool
        # and qkv gradients move by 3-5e-2 under it (reported, not held)
        noise = torch.randn(x.shape, generator=gen, device="cuda")
        _, _, grads_n = run(x * (1 + 2.0 ** -9 * noise))
    torch.cuda.synchronize()
    names = [n for n, _ in model.named_parameters()]
    # the k pool norms' biases have an exact gradient of zero (softmax
    # ignores one shift of every key), so both paths hold rounding noise
    # there: those leaves are held to a norm below 1e-3 of the global one
    zero = [i for i, n in enumerate(names) if n.endswith("attn.norm_k.bias")]
    zero_max = max(max(grads_k[i].norm().item(), grads_p[i].norm().item())
                   for i in zero) if zero else 0.0
    rel = {i: ((grads_k[i] - grads_p[i]).norm()
               / grads_p[i].norm().clamp_min(1e-30)).item()
           for i in range(len(names)) if i not in zero}
    worst = max(rel, key=rel.get)
    floor = ((grads_n[worst] - grads_p[worst]).norm()
             / grads_p[worst].norm()).item()
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    norm_err = abs(norm_k - norm_p) / norm_p
    print(f"# batch-1 train step, kernels vs plain reference: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_err:.2e}, tol 1e-2), "
          f"grad_norm {norm_k:.6f} vs {norm_p:.6f} (rel {norm_err:.2e}, "
          f"tol 2e-2), worst leaf {names[worst]} relative L2 "
          f"{rel[worst]:.3e} (tol 5e-2; the plain reference moves it by "
          f"{floor:.3e} for a bf16 rounding of its input), median "
          f"{float(np.median(list(rel.values()))):.3e}; {len(zero)} "
          f"zero-gradient leaves (k-norm biases) at most {zero_max:.3e} "
          f"(tol {1e-3 * norm_p:.3e})")
    if not (loss_err <= 1e-2 and norm_err <= 2e-2 and rel[worst] <= 5e-2
            and zero_max <= 1e-3 * norm_p):
        _fail("the train step's kernel gradients disagree with the plain "
              "reference")
    del model, grads_k, grads_p, grads_n
    torch.cuda.empty_cache()
    return {"loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
            "worst_leaf": names[worst], "worst_leaf_rel_l2": rel[worst],
            "worst_leaf_plain_noise_floor": floor,
            "median_leaf_rel_l2": float(np.median(list(rel.values()))),
            "zero_grad_leaves_max_norm": zero_max}


# ------------------------------------------------------------------ main

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, _REPO)
    try:
        import aicity_action_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the aicity_action_tpu_torch package is not "
              f"beside {__file__}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"# card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    build_kernels()
    checks = kernel_checks()
    checks.update(train_kernel_checks())
    for name, cases in checks.items():
        for c in cases:
            print(f"# {name} {c['shape']}: err {c['max_abs_err']:.3e} "
                  f"(tol {c['tol']:.3e}), {c['ms']:.4f} ms, plain "
                  f"{c['plain_ms']:.4f} ms, library {c['library_ms']:.4f} "
                  f"ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
    model, cfg, model_stats = model_checks(card)
    launches = scorer_checks(model, cfg)
    del model
    torch.cuda.empty_cache()
    model, cfg, train_launches, train_stats = train_checks(card)
    del model
    torch.cuda.empty_cache()
    train_stats["grad_check"] = train_grad_check(cfg)

    kernels_line = []
    for name in KERNEL_FNS + TRAIN_KERNEL_FNS:
        first = checks[name][0]
        source, replaces = SOURCES[name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (launches if name in KERNEL_FNS
                         else train_launches)[name],
            **{k: first[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
            "shape": first["shape"],
            "train_launches_per_step": train_stats["launches_per_step"][name],
            "other_shapes": checks[name][1:],
        })
    print(json.dumps({"model": model_stats, "train": train_stats}))
    print(json.dumps({"kernels": kernels_line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
