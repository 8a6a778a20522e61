#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``aicity_action_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``aicity_action_tpu_torch/csrc`` with nvcc
   (sm_90a, one process per source) and prints the card's name and power
   limit; prints the HGMMA (wgmma) and UTMALDG (TMA load) instruction
   counts in the SASS of the LN+qkv and LN+MLP forward kernels, of the
   LN+qkv and LN+MLP backwards' GEMM kernels, of both attention forwards
   and of the attention backward's dk/dv and dq kernels, with their
   registers and spills, and fails if either count is 0, if a dense
   backward's GEMM kernel spills or has other than 168 registers, if an
   attention forward spills or has more than 168, or if an attention
   backward kernel spills or has more than 255; then holds the
   64-byte-swizzle wgmma descriptors that the attention kernels build on
   against torch on one tile.
2. Holds each inference kernel against its plain PyTorch version at
   main-path shapes of MViT-v2-B 16x4 @ 448 (batch 8, bf16: LN+qkv at
   every distinct shape of the forward, LN+MLP at every width, both also at
   batch 1, the fused-LN attention at blocks 0, 1, 4-13 and 15) and times
   the kernel, the plain version and a PyTorch library yardstick with CUDA
   events: kernel and library call as the medians of YARDSTICK_N calls
   taken in turns, printed with their interquartile ranges; each attention
   forward's comment line also with its exponential floor (PEAK_EX2), the
   K/V bytes its blocks would read from L2 at one read of their group's K
   and V a block (a model, not a reading) and its waves of blocks.
3. Does the same for the training kernels (the flash attention forward
   with its logsumexp, and the backward kernels of attention, LayerNorm,
   LN+qkv and LN+MLP) at the batch-4 training shapes of blocks 0, 1 and 15
   (the attention forward and the LN+qkv backward also at blocks 4-13,
   their ten calls a step; the attention backward also at blocks 3, 4-13
   and 14).
4. Does the same for the kernels of the cls-token MViT-v1 and the fused-LN
   training path: the padded attention (forward and backward) at the
   ragged lengths of MViT-B 16x4 @ 224, batch 8, blocks 0, 1 and 15; the
   fused-LN attention's forward with its logsumexp and its backward at the
   448 batch-4 shapes of blocks 0, 1, 4-13 and 15 (the backward also at
   blocks 3 and 14); LN+qkv forward and backward at
   the odd 25089 tokens of the v1's blocks 0 and 1 (the forward also at
   block 3; the backward also at the 1569 tokens of blocks 4-13, batch 8
   and batch 1), LN+MLP at the v1's odd row counts of blocks 1, 4 and 15, and
   the LN+MLP backward at the v1's block 1, batch 8 and batch 1.
5. Builds the full MViT-v2 (16 blocks, bf16, weights from a seed), runs
   batch-8 forwards through ``make_eval_step``, holds the kernel launches
   per forward to the counts the model implies, and compares a batch-1
   forward with the same model in its plain reference mode; then the same
   forward with ``AICITY_TPU_FUSE_ATTN_LN=0`` (the unfused eval path).
6. Drives the serving path, ``WindowScorer``, over a synthetic in-memory
   I420 video, with the launch counts set to 0 just before and read just
   after; checks the windows against a direct forward and round-trips the
   pickle.
7. Drives the training path, ``make_train_step``, at batch 4 with mixup,
   activation checkpointing and AdamW (two warm-up steps, then timed
   steps; the counts set to 0 just before the timed steps and read just
   after, and held to the counts the config implies), then the same with
   ``AICITY_TPU_FUSE_ATTN_LN=1`` (the fused-LN attention in training), and
   compares one batch-1 step's gradients with the model's plain reference
   mode, for both.
8. Drives MViT-B 16x4 @ 224 with a cls token (PySlowFast's Kinetics-400
   MViT-v1) the same way: the batch-8 eval forward and the batch-8 train
   step (mixup, AdamW), with their launch counts and batch-1 checks.
9. Prints ``{"kernels": [...]}``, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the run exits non-zero and prints no result.
With no CUDA card, or without the package beside this file, it exits 2.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
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
# exponentials a second: the SFU's ex2 at 16 a clock an SM, 132 SMs, at
# the 1.83 GHz of the bf16 peak; G*Lq*Lk of them over this rate is an
# attention forward's exponential floor, printed on its comment line beside
# bound_ms, which stays the larger of the bytes' and the products' times
PEAK_EX2 = 16 * 132 * 1.83e9
# query rows a block of the attention forward (csrc/flash_fwd.cuh:FW_ROWS),
# for the waves of blocks on the comment lines
FWD_ROWS = 128
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


# repeats of a kernel and its library call, interleaved, for their medians
YARDSTICK_N = 11
# a spin kernel ahead of each timed call (~1 ms at the H100's clocks) keeps
# the device busy while the host enqueues the call, so that its events
# time the device's work and not the host's launches
SPIN_CYCLES = 2_000_000


def _spread(times: list) -> dict:
    """Median, count, min-max and interquartile range of per-call times."""
    t = sorted(times)
    n = len(t)

    def q(f):  # linear interpolation between order statistics
        i = f * (n - 1)
        lo = int(i)
        return t[lo] + (t[min(lo + 1, n - 1)] - t[lo]) * (i - lo)

    return {"ms": q(0.5), "n": n, "min": t[0], "max": t[-1],
            "iqr": [q(0.25), q(0.75)]}


def time_interleaved(fns, n: int, warmup: int = 2) -> list:
    """Device time of each of ``fns`` as the median of ``n`` calls taken in
    turns (f0, f1, ..., f0, f1, ...), each call between its own CUDA
    events behind a spin kernel (SPIN_CYCLES), after ``warmup`` calls of
    each: a yardstick that a clock or cache state drifting during the run
    moves alike for all of them. Returns one :func:`_spread` per
    function."""
    import torch

    for f in fns:
        for _ in range(warmup):
            f()
    events = [[] for _ in fns]
    for _ in range(n):
        for i, f in enumerate(fns):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            f()
            b.record()
            events[i].append((a, b))
    torch.cuda.synchronize()
    return [_spread([a.elapsed_time(b) for a, b in ev]) for ev in events]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Median device time of ``fn()`` over ``iters`` calls."""
    return time_interleaved([fn], iters, warmup)[0]["ms"]


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


# kernel-name substrings of the kernels whose machine code must use
# Hopper's warpgroup products (HGMMA) and TMA loads (UTMALDG): the LN+qkv
# and LN+MLP forwards, every GEMM launch of the LN+qkv and LN+MLP
# backwards (their pre-passes and the LN backward over rows are plain
# loads), both attention forwards, and the attention backward's dk/dv
# kernel and both dq kernels; the dense backwards' GEMM kernels must also
# have the 168 registers setmaxnreg assumes and no spills, the attention
# forwards no spills and at most the 168 registers that three warps on an
# SM sub-partition allow, the attention backward's kernels no spills and
# at most the 255 registers that let two blocks share an SM
HOPPER_KERNELS = {"fused_ln_qkv": ("ln_qkv_kernel",),
                  "fused_ln_mlp": ("ln_mlp_kernel",),
                  "fused_ln_qkv_bwd": ("qkv_bwd_gemm_kernel",
                                       "qkv_bwd_dw_kernel"),
                  "fused_ln_mlp_bwd": ("mlp_bwd_dual_kernel",
                                       "mlp_bwd_gemm_kernel"),
                  "flash_attention": ("flash_fwd_kernel",),
                  "flash_attention_ln": ("flash_ln_kernel",),
                  "flash_attention_bwd": ("flash_bwd_dkv_kernel",
                                          "flash_bwd_dq_kernel"),
                  "flash_attention_ln_bwd": ("flash_ln_bwd_dq_kernel",)}
HOPPER_REGISTERS = 168
# kernels that must not spill: (registers, whether exactly that many or at
# most)
NO_SPILL_KERNELS = {"fused_ln_qkv_bwd": (HOPPER_REGISTERS, True),
                    "fused_ln_mlp_bwd": (HOPPER_REGISTERS, True),
                    "flash_attention": (HOPPER_REGISTERS, False),
                    "flash_attention_ln": (HOPPER_REGISTERS, False),
                    "flash_attention_bwd": (255, False),
                    "flash_attention_ln_bwd": (255, False)}


def hopper_sass_checks() -> dict:
    """Counts the HGMMA and UTMALDG instructions in the SASS of every
    instantiation of the kernels of HOPPER_KERNELS (``cuobjdump -sass`` on
    the built library) and reads their registers and spills from the build
    log; fails if any of them lacks either instruction, if ptxas serialized
    its wgmma (C7511), or if a kernel of NO_SPILL_KERNELS spills or breaks
    its register budget: exactly HOPPER_REGISTERS (168) for the dense
    backwards' GEMM kernels, whose setmaxnreg assumes it, at most 168 for
    the attention forwards and 255 for the attention backward's."""
    from aicity_action_tpu_torch.ops import kernels

    so = kernels.build()
    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            continue
        if fn and "stats" not in fn and any(
                k in fn for keys in HOPPER_KERNELS.values() for k in keys):
            c = counts.setdefault(fn, {"HGMMA": 0, "UTMALDG": 0})
            for op in c:
                c[op] += op in line
    usage, entry = {}, None
    log = (kernels.BUILD_DIR / "build.log").read_text()
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry in counts and ("spill" in line or "registers" in line):
            usage.setdefault(entry, []).append(line.strip())
    # ptxas's C7511: it serialized a kernel's wgmma (too few registers for
    # the pipeline), which loses the overlap of its products
    for line in log.splitlines():
        if ("wgmma.mma_async instructions are serialized" in line
                and any(f in line for f in counts)):
            _fail(f"ptxas serialized a Hopper kernel's wgmma: {line.strip()}")
    for name, keys in HOPPER_KERNELS.items():
        fns = [f for f in counts if any(k in f for k in keys)]
        missing = [k for k in keys if not any(k in f for f in fns)]
        if missing:
            _fail(f"{name}: no {missing} function in the library's SASS")
        for f in fns:
            lines = usage.get(f, [])
            print(f"# SASS {name} {f}: HGMMA {counts[f]['HGMMA']}, UTMALDG "
                  f"{counts[f]['UTMALDG']}; {' / '.join(lines)}")
            if not (counts[f]["HGMMA"] and counts[f]["UTMALDG"]):
                _fail(f"{name}: {f} has no HGMMA or no UTMALDG")
            text = " ".join(lines)
            if name not in NO_SPILL_KERNELS:
                continue
            regs, exact = NO_SPILL_KERNELS[name]
            used = re.search(r"Used (\d+) registers", text)
            used = int(used.group(1)) if used else None
            ok_regs = used is not None and (
                used == regs if exact else used <= regs)
            if not ok_regs or (" 0 bytes spill stores, 0 bytes spill loads"
                               not in text):
                _fail(f"{name}: {f} spills or breaks its budget of {regs} "
                      f"registers: {text}")
    return counts


def descriptor_checks() -> None:
    """The one-tile check of the 64-byte-swizzle wgmma descriptors that the
    attention backward builds on (``csrc/flash_attention.cu:
    wgmma_sw64_probe_kernel``): a b^T with A from registers and B K-major
    (the logits), and bf16(a b^T) b through an MN-major B (dq, dk, dv),
    against torch in f32 from the same bf16 inputs, within 1e-3 of each
    product's largest magnitude (f32 sums in another order; a wrong byte
    offset moves whole rows)."""
    import torch

    from aicity_action_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    a, b = (_normal(gen, (64, 96), 1.0, torch.bfloat16) for _ in range(2))
    c1 = torch.empty((64, 64), device="cuda")
    c2 = torch.empty((64, 96), device="cuda")
    kernels.check(kernels.lib().aicity_wgmma_sw64_probe(
        a.data_ptr(), b.data_ptr(), c1.data_ptr(), c2.data_ptr(),
        kernels.stream()), "wgmma_sw64_probe")
    torch.cuda.synchronize()
    for name, out, want in (
            ("A from registers, B K-major", c1, a.float() @ b.float().t()),
            ("B MN-major", c2, c1.bfloat16().float() @ b.float())):
        err = (out - want).abs().max().item()
        tol = 1e-3 * want.abs().max().item()
        print(f"# wgmma 64-byte swizzle, {name}: max err {err:.3e} "
              f"(tol {tol:.3e})")
        if not err <= tol:
            _fail(f"wgmma 64-byte swizzle descriptors, {name}: max err "
                  f"{err} > {tol}")


# ------------------------------------------------------------------ kernels

def _normal(gen, shape, std=1.0, dtype=None, device="cuda"):
    import torch

    t = torch.randn(shape, generator=gen, device=device) * std
    return t.to(dtype) if dtype is not None else t


def check_outputs(name, outs, refs, zero_grads=None):
    """Each of a kernel's outputs within KERNEL_RTOL of its plain version's
    largest magnitude, finite and of its shape; fails otherwise.
    ``zero_grads`` maps an output whose exact value is zero (a gradient
    that cancels, so both sides hold only rounding noise) to the output
    whose largest magnitude sets its tolerance instead. Returns the largest
    error, the largest tolerance and the largest error as a share of its
    tolerance times KERNEL_RTOL."""
    import torch

    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    if len(outs) != len(refs):
        _fail(f"{name}: {len(outs)} outputs against {len(refs)}")
    err, tol, rel = 0.0, 0.0, 0.0
    zero_grads = zero_grads or {}
    for i, (o, r) in enumerate(zip(outs, refs)):
        if o.shape != r.shape or not torch.isfinite(o).all():
            _fail(f"{name}: output {i} non-finite or mis-shaped")
        e = (o.float() - r.float()).abs().max().item()
        ref_i = refs[zero_grads.get(i, i)]
        t = KERNEL_RTOL * max(ref_i.float().abs().max().item(), 1e-30)
        if not e <= t:
            _fail(f"{name}: output {i}: max |kernel - plain| {e} > {t}")
        err, tol, rel = max(err, e), max(tol, t), max(rel, e / t * KERNEL_RTOL)
    return err, tol, rel


def _check_case(name, kernel_fn, plain_fn, library_fn, flops, nbytes,
                peak, iters, zero_grads=None):
    """Compare one kernel call with its plain version
    (:func:`check_outputs`), time all three: the kernel and its library
    call as medians of YARDSTICK_N calls taken in turns (``iters`` sets only
    the plain version's repeats, ``iters // 5``)."""
    import torch

    out = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    err, tol, rel = check_outputs(name, out, ref, zero_grads)
    del out, ref
    # kernel and library call in turns, medians of YARDSTICK_N each
    timed = time_interleaved(
        [kernel_fn] + ([library_fn] if library_fn else []), YARDSTICK_N)
    plain_ms = time_ms(plain_fn, max(1, iters // 5))
    bound_ms = max(flops / peak, nbytes / PEAK_BYTES) * 1e3
    kern, lib = timed[0], (timed[1] if library_fn else None)
    return {
        "max_abs_err": err, "tol": tol, "max_rel_err": rel,
        "ms": kern["ms"], "n": kern["n"],
        "ms_spread": [kern["min"], kern["max"]], "ms_iqr": kern["iqr"],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if flops / peak > nbytes / PEAK_BYTES
        else "bytes",
        "library_ms": lib["ms"] if lib else None,
        "library_spread": [lib["min"], lib["max"]] if lib else None,
        "library_iqr": lib["iqr"] if lib else None,
    }


def _sdpa(q, k, v):
    """``F.scaled_dot_product_attention`` of token rows ``[G, L, d]`` as
    the 4-D ``[1, G, L, d]`` its fused backends take, pinned to them
    (FlashAttention-2 first, else the memory-efficient kernel; never the
    math path): the attention rows' library yardstick."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        return F.scaled_dot_product_attention(q[None], k[None], v[None])[0]


def _mlp_case(gen, shape, M, C):
    """fused_ln_mlp on x [M, C] (H = 4C) against its plain version and
    LN + linear + GELU + linear."""
    import torch
    import torch.nn.functional as F

    from aicity_action_tpu_torch.ops import fused_dense as fd

    bf = torch.bfloat16
    H = 4 * C
    x = _normal(gen, (M, C), 1.0, bf)
    g = _normal(gen, (C,), 0.1, bf) + 1
    bb = _normal(gen, (C,), 0.1, bf)
    w1 = _normal(gen, (H, C), C ** -0.5, bf)
    b1 = _normal(gen, (H,), 0.1, bf)
    w2 = _normal(gen, (C, H), H ** -0.5, bf)
    b2 = _normal(gen, (C,), 0.1, bf)
    args = (x, g, bb, w1, b1, w2, b2, 1e-6)

    def library():
        h = F.gelu(F.linear(F.layer_norm(x, (C,), g, bb, 1e-6), w1, b1))
        return F.linear(h, w2, b2)

    r = _check_case(
        "fused_ln_mlp", lambda: fd.fused_ln_mlp(*args),
        lambda: fd.ln_mlp_plain(*args), library,
        flops=2 * M * (C * H + H * C),
        nbytes=2 * (2 * M * C + 2 * C * H + H + 3 * C),
        peak=PEAK_BF16, iters=10)
    r["shape"] = shape
    return r


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

    # fused_ln_qkv at every distinct shape of the batch-8 forward: blocks 0
    # (D 96 -> 3C 288 over 100352 tokens), 1 (96 -> 576), 2 (192 -> 576
    # over 25088), 3 (192 -> 1152), 4-13 (384 -> 1152 over 6272), 14 (384
    # -> 2304) and 15 (768 -> 2304 over 1568), then batch 1 at blocks 0 and
    # 15; q, k, v written channel-major [B, C, L]
    cases = []
    for blk, b, L, D, C in ((0, BATCH, 100352, 96, 96),
                            (1, BATCH, 100352, 96, 192),
                            (2, BATCH, 25088, 192, 192),
                            (3, BATCH, 25088, 192, 384),
                            (4, BATCH, 6272, 384, 384),
                            (14, BATCH, 6272, 384, 768),
                            (15, BATCH, 1568, 768, 768),
                            (0, 1, 100352, 96, 96), (15, 1, 1568, 768, 768)):
        M = b * L
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
        r["shape"] = (f"block {blk} x[{M},{D}] w[{3 * C},{D}] -> [B,C,L]"
                      + ("" if b == BATCH else f" (batch {b})"))
        cases.append(r)
        del x, w, args
    results["fused_ln_qkv"] = cases

    # fused_ln_mlp at each width: block 0 (C 96 over 100352 tokens) and
    # block 1 (C 192 over 25088), the fused kernel; block 4 (C 384 over
    # 6272) and block 15 (C 768 over 1568), two launches; then batch 1 at
    # blocks 0 and 15; H = 4C
    cases = [_mlp_case(gen, f"block {blk} x[{b * L},{C}] H {4 * C}"
                       + ("" if b == BATCH else f" (batch {b})"), b * L, C)
             for blk, b, L, C in ((0, BATCH, 100352, 96),
                                  (1, BATCH, 25088, 192),
                                  (4, BATCH, 6272, 384),
                                  (15, BATCH, 1568, 768),
                                  (0, 1, 100352, 96), (15, 1, 1568, 768))]
    results["fused_ln_mlp"] = cases

    # flash_attention_ln: block 0 (h 1, Lq 100352, Lk 1568), block 1 (h 2,
    # Lq 25088, Lk 6272), blocks 4-13 (h 4, Lq 6272, Lk 1568: ten of its 16
    # calls a forward) and block 15 (h 8, Lq = Lk = 1568); d 96, all three
    # LNs and the q-residual; q, k, v are the d-major views the main path
    # passes (pool outputs [G, d, L])
    cases = []
    d = 96
    for blk, h, Lq, Lk in ((0, 1, 100352, 1568), (1, 2, 25088, 6272),
                           ("4-13", 4, 6272, 1568), (15, 8, 1568, 1568)):
        G = BATCH * h
        q, k, v = (_normal(gen, (G, d, n), 1.0, bf).transpose(1, 2)
                   for n in (Lq, Lk, Lk))
        lnp = [t for _ in range(3) for t in (
            _normal(gen, (d,), 0.1, bf) + 1, _normal(gen, (d,), 0.1, bf))]
        args = (q, k, v, *lnp, d ** -0.5, 1e-5, (True, True, True), True)

        def library(q=q, k=k, v=v, lnp=lnp):
            qn, kn, vn = (F.layer_norm(t, (d,), lnp[2 * i], lnp[2 * i + 1],
                                       1e-5) for i, t in enumerate((q, k, v)))
            return _sdpa(qn, kn, vn) + qn

        r = _check_case(
            "flash_attention_ln",
            lambda args=args: fa.flash_attention_ln(*args),
            lambda args=args: fa.flash_attention_ln_plain(*args),
            library,
            flops=4 * G * Lq * Lk * d,
            nbytes=2 * (2 * G * Lq * d + 2 * G * Lk * d + 6 * d),
            peak=PEAK_BF16, iters=5)
        r["shape"] = (f"block{'s' if blk == '4-13' else ''} {blk} "
                      f"q[{G},{Lq},{d}] k,v[{G},{Lk},{d}] d-major"
                      + (" (10 calls a forward)" if blk == "4-13" else ""))
        # the attention alone: without the residual, whose LN(q) (of order
        # 1) sets the tolerance above, the output is held within 2% of its
        # own largest magnitude
        pre = args[:-1] + (False,)
        r["pre_residual"] = dict(zip(
            ("max_abs_err", "tol", "max_rel_err"), check_outputs(
                f"flash_attention_ln {r['shape']} before the residual",
                fa.flash_attention_ln(*pre),
                fa.flash_attention_ln_plain(*pre))))
        cases.append(_mark_fwd(r, G, Lq, Lk))
        del q, k, v, args, pre
    results["flash_attention_ln"] = cases
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------- training kernels

def _mlp_bwd_case(gen, shape, M, C):
    """fused_ln_mlp_bwd on x [M, C] (H = 4C) against autograd of the plain
    version in f32 and of LN + linear + GELU + linear."""
    import torch
    import torch.nn.functional as F

    from aicity_action_tpu_torch.ops import fused_dense as fd

    bf = torch.bfloat16
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

    def library():
        return _library_grads(
            lambda a, b, c, u1, c1, u2, c2: F.linear(F.gelu(F.linear(
                F.layer_norm(a, (C,), b, c, 1e-6), u1, c1)), u2, c2),
            args, (dout,))

    r = _check_case(
        "fused_ln_mlp_bwd",
        lambda: fd.fused_ln_mlp_bwd(*args[:6], dout, 1e-6),
        lambda: _plain_grads(lambda *a: fd.ln_mlp_plain(*a, 1e-6), args,
                             (dout,)),
        library,
        # fc1 recomputed, dh, dW2, dW1, dLN(x): five products
        flops=10 * M * C * H,
        nbytes=2 * (3 * M * C + 4 * C * H + 2 * H + 5 * C),
        peak=PEAK_BF16, iters=10)
    r["shape"] = shape
    del x, dout, args
    torch.cuda.empty_cache()
    return r


def _qkv_inputs(gen, B, L, D, C):
    """bf16 inputs of fused_ln_qkv on x [B*L, D] (x, gamma, beta, w, bias)
    and the gradients of its q, k, v, channel-major [B, C, L] as the
    forward writes them."""
    import torch

    bf = torch.bfloat16
    x = _normal(gen, (B * L, D), 1.0, bf)
    g = _normal(gen, (D,), 0.1, bf) + 1
    bb = _normal(gen, (D,), 0.1, bf)
    w = _normal(gen, (3 * C, D), D ** -0.5, bf)
    bias = _normal(gen, (3 * C,), 0.1, bf)
    gs = tuple(_normal(gen, (B, C, L), 1.0, bf) for _ in range(3))
    return x, g, bb, w, bias, gs


def _qkv_bwd_case(shape, x, g, bb, w, bias, gs, L, calls=None):
    """fused_ln_qkv_bwd (from :func:`_qkv_inputs`) against autograd of the
    plain version in f32 and of LN + linear; ``calls``, its calls a train
    step at this shape, where stated."""
    import torch
    import torch.nn.functional as F

    from aicity_action_tpu_torch.ops import fused_dense as fd

    M, D = x.shape
    C = w.shape[0] // 3

    def library():
        cot = torch.cat([t.transpose(1, 2).reshape(-1, C) for t in gs], 1)
        return _library_grads(
            lambda a, b, c, ww, wb: F.linear(
                F.layer_norm(a, (D,), b, c, 1e-6), ww, wb),
            (x, g, bb, w, bias), (cot,))

    r = _check_case(
        "fused_ln_qkv_bwd",
        lambda: fd.fused_ln_qkv_bwd(x, g, bb, w, *gs, 1e-6, L),
        lambda: _plain_grads(lambda *a: fd.ln_qkv_plain(*a, 1e-6, L),
                             (x, g, bb, w, bias), gs),
        library, flops=4 * M * D * 3 * C,
        nbytes=2 * (2 * M * D + 3 * M * C + 2 * 3 * C * D + 3 * C + 4 * D),
        peak=PEAK_BF16, iters=5)
    r["shape"] = shape
    if calls is not None:
        r["calls_a_step"] = calls
    return r


def _plain_grads(fn, inputs, cotangents):
    """Gradients of the plain version ``fn`` in f32 at the kernel's bf16
    inputs: the plain forward, then autograd (zeros for an input the
    function does not use)."""
    import torch

    ts = [t.detach().float().requires_grad_() for t in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs, ts, [c.float() for c in cotangents],
                                allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for t, g in zip(ts, grads))


def _library_grads(fn, inputs, cotangents):
    """One PyTorch library call's forward and autograd backward (the
    yardstick), in the inputs' type."""
    import torch

    ts = [t.detach().requires_grad_() for t in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, ts, cotangents)


# the attention of the batch-4 448 train step, (block, heads, Lq, Lk):
# blocks 0, 1 and 15 (forward and backward), then, for the backwards, block
# 3 (Lq = Lk = 6272), blocks 4-13 (ten calls a step, the most launched
# shape) and block 14 (the only Lq < Lk)
ATTN_TRAIN_SHAPES = ((0, 1, 100352, 1568), (1, 2, 25088, 6272),
                     (15, 8, 1568, 1568), (3, 4, 6272, 6272),
                     ("4-13", 4, 6272, 1568), (14, 8, 1568, 6272))
ATTN_FWD_BLOCKS = (0, 1, 15, "4-13")


def _mark_fwd(r, G, Lq, Lk):
    """Marks case ``r`` as an attention forward over ``G`` groups of ``Lq``
    queries and ``Lk`` keys, for its comment line (:func:`_fwd_note`); the
    mark stays off the JSON lines."""
    r["_fwd"] = (G, Lq, Lk)
    return r


def _public(case: dict) -> dict:
    """A case's result without its marks (keys starting with ``_``), for
    the JSON lines."""
    return {k: v for k, v in case.items() if not k.startswith("_")}


def _fwd_note(G, Lq, Lk) -> str:
    """An attention forward's figures computed from its shape, not read:
    its exponential floor (G Lq Lk over PEAK_EX2), the K/V bytes its blocks
    would read from L2 if each read its group's K and V once (a model) and
    its waves of FWD_ROWS-row blocks over the card's SMs."""
    import torch

    blocks = -(-Lq // FWD_ROWS) * G
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (f"; computed: exp floor {G * Lq * Lk / PEAK_EX2 * 1e3:.4f} ms, "
            f"K/V at one read a block {blocks * 2 * Lk * 96 * 2 / 1e9:.3f} "
            f"GB (model), {blocks / sms:.2f} waves")


def _attn_shape(blk, G, Lq, Lk, d=96) -> str:
    calls = " (10 calls a step)" if blk == "4-13" else ""
    kind = "blocks" if blk == "4-13" else "block"
    return f"{kind} {blk} q[{G},{Lq},{d}] k,v[{G},{Lk},{d}]{calls}"


def _train_fwd_checks(fa, fwd, q, k, v, shape, flops, io, blk, scale):
    """The flash attention forward with its lse (and, at block 0, the
    lse-free mode of inference with pool modes max / avg) against its plain
    version, appended to ``fwd``; returns the forward's ``(out, lse)``."""
    G, Lq = q.shape[:2]
    r = _check_case(
        "flash_attention",
        lambda: fa.flash_attention_fwd(q, k, v, scale, True),
        lambda: fa.flash_attention_lse_plain(q.float(), k.float(),
                                             v.float(), scale),
        lambda: _sdpa(q, k, v),
        flops=flops, nbytes=io + 4 * G * Lq, peak=PEAK_BF16, iters=3)
    r["shape"] = shape + " (+ lse)"
    fwd.append(_mark_fwd(r, G, Lq, k.shape[1]))
    if blk == 0:
        r = _check_case(
            "flash_attention",
            lambda: fa.flash_attention_fwd(q, k, v, scale, False)[0],
            lambda: fa.flash_attention_plain(q.float(), k.float(),
                                             v.float(), scale),
            lambda: _sdpa(q, k, v),
            flops=flops, nbytes=io, peak=PEAK_BF16, iters=3)
        r["shape"] = shape + " (no lse)"
        fwd.append(_mark_fwd(r, G, Lq, k.shape[1]))
    return fa.flash_attention_fwd(q, k, v, scale, True)


def train_kernel_checks():
    """The training kernels at the batch-4 training shapes of blocks 0, 1
    and 15, the attention backward also at blocks 3, 4-13 and 14 (each
    kernel against its plain version, computed in f32 from the same bf16
    inputs, differentiated by autograd; plain and library times are of
    forward + backward)."""
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

    # flash attention forward (with lse) and backward at ATTN_TRAIN_SHAPES,
    # head-major token rows (the forward at blocks 0, 1 and 15)
    fwd, bwd = [], []
    for blk, h, Lq, Lk in ATTN_TRAIN_SHAPES:
        G = B * h
        q, k, v = (_normal(gen, (G, n, d), 1.0, bf) for n in (Lq, Lk, Lk))
        shape = _attn_shape(blk, G, Lq, Lk)
        flops = 4 * G * Lq * Lk * d
        io = 2 * (2 * G * Lq * d + 2 * G * Lk * d)
        if blk not in ATTN_FWD_BLOCKS:
            out, lse = fa.flash_attention_fwd(q, k, v, scale, True)
        else:
            out, lse = _train_fwd_checks(fa, fwd, q, k, v, shape, flops,
                                         io, blk, scale)
        dout = _normal(gen, (G, Lq, d), 1.0, bf)
        r = _check_case(
            "flash_attention_bwd",
            lambda q=q, k=k, v=v, out=out, lse=lse, dout=dout:
                fa.flash_attention_bwd(q, k, v, out, lse, dout, scale),
            lambda q=q, k=k, v=v, dout=dout: _plain_grads(
                lambda a, b, c: fa.flash_attention_plain(a, b, c, scale),
                (q, k, v), (dout,)),
            lambda q=q, k=k, v=v, dout=dout: _library_grads(
                _sdpa, (q, k, v), (dout,)),
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
    # 3C 576, L 100352), block 15 (D 768, 3C 2304, L 1568), and blocks 4-13
    # (D 384, 3C 1152, L 6272: ten calls a step); the gradients of q, k, v
    # channel-major [B, C, L] as the forward wrote them
    cases = []
    for blocks, L, D, C, calls in (("block 0", 100352, 96, 96, 1),
                                   ("block 1", 100352, 96, 192, 1),
                                   ("block 15", 1568, 768, 768, 1),
                                   ("blocks 4-13", 6272, 384, 384, 10)):
        cases.append(_qkv_bwd_case(
            f"{blocks} x[{B * L},{D}] w[{3 * C},{D}]",
            *_qkv_inputs(gen, B, L, D, C), L, calls))
        torch.cuda.empty_cache()
    results["fused_ln_qkv_bwd"] = cases

    # LN+MLP backward: block 0 (C 96 over 401408 rows), block 1 (C 192
    # over 100352), block 15 (C 768 over 6272); H = 4C
    cases = [_mlp_bwd_case(gen, f"block {blk} x[{M},{C}] H {4 * C}", M, C)
             for blk, M, C in ((0, B * 100352, 96), (1, B * 25088, 192),
                               (15, B * 1568, 768))]
    results["fused_ln_mlp_bwd"] = cases
    return results


# ------------------------------------------- cls-token and fused-LN kernels

def v1_kernel_checks():
    """The kernels the cls-token MViT-v1 and the fused-LN training path
    add: the padded attention (forward with and without its lse, and
    backward) at the v1 batch-8 shapes of blocks 0, 1 and 15, where no
    length is a tile multiple (Lk 393 is six 64-key tiles and 9 keys, Lq
    25089 leaves a one-row tail); the fused-LN attention's forward with
    the lse and its backward at the 448 batch-4 training shapes of blocks
    0, 1 and 15, the backward also at blocks 3, 4-13 and 14 (d-major q, k,
    v, all three norms and the residual);
    LN+qkv forward and backward at the odd 25089 tokens of blocks 0 and 1;
    LN+MLP forward and backward at the v1's odd row counts.
    Plain versions in f32 from the same bf16 inputs; plain and library
    times of a backward are of forward + backward."""
    import torch
    import torch.nn.functional as F

    from aicity_action_tpu_torch.ops import flash_attention as fa
    from aicity_action_tpu_torch.ops import fused_dense as fd

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    d = 96
    scale = d ** -0.5
    results = {}

    # flash_attention_padded: v1 batch 8 (blocks 0, 1, 15)
    fwd, bwd = [], []
    for blk, h, Lq, Lk in ((0, 1, 25089, 393), (1, 2, 6273, 1569),
                           (15, 8, 393, 393)):
        G = BATCH * h
        q, k, v = (_normal(gen, (G, n, d), 1.0, bf) for n in (Lq, Lk, Lk))
        shape = f"v1 block {blk} q[{G},{Lq},{d}] k,v[{G},{Lk},{d}]"
        flops = 4 * G * Lq * Lk * d
        io = 2 * (2 * G * Lq * d + 2 * G * Lk * d)
        for with_lse in (True, False):
            r = _check_case(
                "flash_attention_padded",
                lambda q=q, k=k, v=v, w=with_lse: (
                    fa.flash_attention_padded_fwd(q, k, v, scale, w)
                    if w else fa.flash_attention_padded_fwd(
                        q, k, v, scale, False)[0]),
                lambda q=q, k=k, v=v, w=with_lse: (
                    fa.flash_attention_lse_plain if w
                    else fa.flash_attention_plain)(
                        q.float(), k.float(), v.float(), scale),
                lambda q=q, k=k, v=v: _sdpa(q, k, v),
                flops=flops, nbytes=io + (4 * G * Lq if with_lse else 0),
                peak=PEAK_BF16, iters=5)
            r["shape"] = shape + (" (+ lse, training)" if with_lse
                                  else " (no lse, eval)")
            fwd.append(_mark_fwd(r, G, Lq, Lk))
        out, lse = fa.flash_attention_padded_fwd(q, k, v, scale, True)
        dout = _normal(gen, (G, Lq, d), 1.0, bf)
        r = _check_case(
            "flash_attention_padded_bwd",
            lambda q=q, k=k, v=v, out=out, lse=lse, dout=dout:
                fa.flash_attention_padded_bwd(q, k, v, out, lse, dout, scale),
            lambda q=q, k=k, v=v, dout=dout: _plain_grads(
                lambda a, b, c: fa.flash_attention_plain(a, b, c, scale),
                (q, k, v), (dout,)),
            lambda q=q, k=k, v=v, dout=dout: _library_grads(
                _sdpa, (q, k, v), (dout,)),
            flops=10 * G * Lq * Lk * d,
            nbytes=2 * (4 * G * Lq * d + 4 * G * Lk * d) + 4 * G * Lq,
            peak=PEAK_BF16, iters=3)
        r["shape"] = shape
        bwd.append(r)
        del q, k, v, out, lse, dout
        torch.cuda.empty_cache()
    results["flash_attention_padded"] = fwd
    results["flash_attention_padded_bwd"] = bwd

    # flash_attention_ln_lse / _bwd: 448 batch 4 at ATTN_TRAIN_SHAPES (the
    # forward at blocks 0, 1 and 15)
    fwd, bwd = [], []
    flags = (True, True, True)
    for blk, h, Lq, Lk in ATTN_TRAIN_SHAPES:
        G = TRAIN_BATCH * h
        q, k, v = (_normal(gen, (G, d, n), 1.0, bf).transpose(1, 2)
                   for n in (Lq, Lk, Lk))
        lnp = [t for _ in range(3) for t in (
            _normal(gen, (d,), 0.1, bf) + 1, _normal(gen, (d,), 0.1, bf))]
        args = (q, k, v, *lnp, scale, 1e-5, flags, True)
        shape = f"448 {_attn_shape(blk, G, Lq, Lk)} d-major"
        flops = 4 * G * Lq * Lk * d
        io = 2 * (2 * G * Lq * d + 2 * G * Lk * d + 6 * d)

        def ln_plain(*a):
            return fa.flash_attention_ln_plain(*a, scale, 1e-5, flags, True)

        def plain_lse(q=q, k=k, v=v, lnp=lnp):
            from aicity_action_tpu_torch.ops.layer_norm import \
                layer_norm_plain
            qf, kf, vf = (t.float() for t in (q, k, v))
            p = [t.float() for t in lnp]
            qn, kn, vn = (layer_norm_plain(t, p[2 * i], p[2 * i + 1], 1e-5)
                          for i, t in enumerate((qf, kf, vf)))
            o, lse = fa.flash_attention_lse_plain(qn, kn, vn, scale)
            return o + qn, lse, o

        def library(q=q, k=k, v=v, lnp=lnp):
            qn, kn, vn = (F.layer_norm(t, (d,), lnp[2 * i], lnp[2 * i + 1],
                                       1e-5) for i, t in enumerate((q, k, v)))
            return _sdpa(qn, kn, vn) + qn

        if blk in ATTN_FWD_BLOCKS:
            r = _check_case(
                "flash_attention_ln_lse",
                lambda args=args: fa.flash_attention_ln_lse(*args),
                plain_lse, library, flops=flops,
                # out, lse and the attention output before the residual
                nbytes=io + 4 * G * Lq + 2 * G * Lq * d,
                peak=PEAK_BF16, iters=3)
            r["shape"] = shape
            fwd.append(_mark_fwd(r, G, Lq, Lk))
        out, lse, oa = fa.flash_attention_ln_lse(*args)
        dout = _normal(gen, (G, Lq, d), 1.0, bf)
        r = _check_case(
            "flash_attention_ln_bwd",
            lambda q=q, k=k, v=v, lnp=lnp, oa=oa, lse=lse, dout=dout:
                fa.flash_attention_ln_bwd(q, k, v, *lnp, oa, lse, dout,
                                          scale, 1e-5, flags, True),
            lambda q=q, k=k, v=v, lnp=lnp, dout=dout: _plain_grads(
                ln_plain, (q, k, v, *lnp), (dout,)),
            lambda q=q, k=k, v=v, lnp=lnp, dout=dout: _library_grads(
                lambda *a: library(*a[:3], a[3:]), (q, k, v, *lnp),
                (dout,)),
            flops=10 * G * Lq * Lk * d,
            nbytes=(2 * (4 * G * Lq * d + 4 * G * Lk * d + 12 * d)
                    + 4 * G * Lq),
            peak=PEAK_BF16, iters=2, zero_grads={6: 5})
        r["shape"] = shape
        bwd.append(r)
        del q, k, v, out, lse, oa, dout, args
        torch.cuda.empty_cache()
    results["flash_attention_ln_lse"] = fwd
    results["flash_attention_ln_bwd"] = bwd

    # fused_ln_qkv forward / backward at the odd 25089 tokens: v1 batch 8,
    # blocks 0 (D 96 -> 3C 288) and 1 (D 192 -> 3C 576); the forward also
    # at block 3 (6273 tokens, D 384 -> 3C 1152: statistics from global
    # memory, 2-byte stores)
    qkv_f, qkv_b = [], []
    for blk, L, D in ((0, 25089, 96), (1, 25089, 192), (3, 6273, 384)):
        C, M = D, BATCH * L
        x = _normal(gen, (M, D), 1.0, bf)
        g = _normal(gen, (D,), 0.1, bf) + 1
        bb = _normal(gen, (D,), 0.1, bf)
        w = _normal(gen, (3 * C, D), D ** -0.5, bf)
        bias = _normal(gen, (3 * C,), 0.1, bf)
        gs = tuple(_normal(gen, (BATCH, C, L), 1.0, bf) for _ in range(3))
        shape = f"v1 block {blk} x[{M},{D}] w[{3 * C},{D}] tokens {L}"

        def library(x=x, g=g, bb=bb, w=w, bias=bias, D=D):
            return F.linear(F.layer_norm(x, (D,), g, bb, 1e-6), w, bias)

        r = _check_case(
            "fused_ln_qkv",
            lambda a=(x, g, bb, w, bias, 1e-6), L=L: fd.fused_ln_qkv(
                *a, tokens=L),
            lambda a=(x, g, bb, w, bias, 1e-6), L=L: fd.ln_qkv_plain(
                *a, tokens=L),
            library, flops=2 * M * D * 3 * C,
            nbytes=2 * (M * D + 3 * M * C + 3 * C * D + 3 * C + 2 * D),
            peak=PEAK_BF16, iters=10)
        r["shape"] = shape
        qkv_f.append(r)
        if blk == 3:
            del x, w, gs
            continue
        qkv_b.append(_qkv_bwd_case(shape, x, g, bb, w, bias, gs, L, 1))
        del x, w, gs
        torch.cuda.empty_cache()
    # the LN+qkv backward's most launched v1 shape, blocks 4-13 (1569
    # tokens, D 384, 3C 1152: ten calls a step), at batch 8 and at batch 1
    # (odd M: the channel-major copies' padded stride)
    for b in (BATCH, 1):
        qkv_b.append(_qkv_bwd_case(
            f"v1 blocks 4-13 x[{b * 1569},384] w[1152,384] tokens 1569"
            + ("" if b == BATCH else f" (batch {b})"),
            *_qkv_inputs(gen, b, 1569, 384, 384), 1569, 10))
        torch.cuda.empty_cache()
    results["fused_ln_qkv odd tokens"] = qkv_f
    results["fused_ln_qkv_bwd odd tokens"] = qkv_b
    # fused_ln_mlp at the v1's odd row counts (TMA's zero fill and the
    # masked stores of a ragged last tile): block 1 (8 x 6273 rows, C 192,
    # fused), block 4 (8 x 1569, C 384) and block 15 (8 x 393, C 768)
    results["fused_ln_mlp odd tokens"] = [
        _mlp_case(gen, f"v1 block {blk} x[{BATCH * L},{C}] H {4 * C} "
                  f"tokens {L}", BATCH * L, C)
        for blk, L, C in ((1, 6273, 192), (4, 1569, 384), (15, 393, 768))]
    # fused_ln_mlp_bwd at the v1's odd row counts: block 1 at batch 8 (8 x
    # 6273 rows, C 192) and batch 1 (6273 rows: odd M, the channel-major
    # copies' padded stride); block 0 changes channels (no fused MLP)
    results["fused_ln_mlp_bwd odd tokens"] = [
        _mlp_bwd_case(gen, f"v1 block 1 x[{b * 6273},192] H 768 tokens 6273"
                      + ("" if b == BATCH else f" (batch {b})"), b * 6273,
                      192)
        for b in (BATCH, 1)]
    return results


# ------------------------------------------------------------------ model

KERNEL_FNS = ("fused_ln_qkv", "flash_attention_ln", "fused_ln_mlp",
              "fused_layer_norm")
TRAIN_KERNEL_FNS = ("flash_attention", "flash_attention_bwd",
                    "fused_ln_qkv_bwd", "fused_ln_mlp_bwd",
                    "fused_layer_norm_bwd")
V1_KERNEL_FNS = ("flash_attention_padded", "flash_attention_padded_bwd")
FUSED_KERNEL_FNS = ("flash_attention_ln_lse", "flash_attention_ln_bwd")
ALL_FNS = KERNEL_FNS + TRAIN_KERNEL_FNS + V1_KERNEL_FNS + FUSED_KERNEL_FNS
_PALLAS = "aicity_action_tpu/ops/pallas/"
SOURCES = {
    "fused_ln_qkv": ("aicity_action_tpu_torch/csrc/fused_ln_qkv.cu",
                     _PALLAS + "fused_dense.py:74"),
    "flash_attention_ln": (
        "aicity_action_tpu_torch/csrc/flash_attention_ln.cu",
        _PALLAS + "flash_attention.py:805"),
    "fused_ln_mlp": ("aicity_action_tpu_torch/csrc/fused_ln_mlp.cu",
                     _PALLAS + "fused_dense.py:314"),
    "fused_layer_norm": ("aicity_action_tpu_torch/csrc/layer_norm.cu",
                         _PALLAS + "layer_norm.py:64"),
    "flash_attention": ("aicity_action_tpu_torch/csrc/flash_attention.cu",
                        _PALLAS + "flash_attention.py:261"),
    "flash_attention_bwd": (
        "aicity_action_tpu_torch/csrc/flash_attention.cu",
        _PALLAS + "flash_attention.py:550"),
    "fused_ln_qkv_bwd": ("aicity_action_tpu_torch/csrc/fused_ln_qkv_bwd.cu",
                         _PALLAS + "fused_dense.py:175"),
    "fused_ln_mlp_bwd": ("aicity_action_tpu_torch/csrc/fused_ln_mlp_bwd.cu",
                         _PALLAS + "fused_dense.py:414"),
    "fused_layer_norm_bwd": ("aicity_action_tpu_torch/csrc/layer_norm.cu",
                             _PALLAS + "layer_norm.py:104"),
    "flash_attention_padded": (
        "aicity_action_tpu_torch/csrc/flash_attention.cu",
        _PALLAS + "flash_attention.py:718"),
    "flash_attention_padded_bwd": (
        "aicity_action_tpu_torch/csrc/flash_attention.cu",
        _PALLAS + "flash_attention.py:742"),
    "flash_attention_ln_lse": (
        "aicity_action_tpu_torch/csrc/flash_attention_ln.cu",
        _PALLAS + "flash_attention.py:918"),
    "flash_attention_ln_bwd": (
        "aicity_action_tpu_torch/csrc/flash_attention_ln_bwd.cu",
        _PALLAS + "flash_attention.py:1203"),
}


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
            "fused_layer_norm_bwd": ln.fused_layer_norm_bwd,
            "flash_attention_padded": fa.flash_attention_padded_fwd,
            "flash_attention_padded_bwd": fa.flash_attention_padded_bwd,
            "flash_attention_ln_lse": fa.flash_attention_ln_lse,
            "flash_attention_ln_bwd": fa.flash_attention_ln_bwd}


def derived_counts(model, train: bool) -> dict:
    """Kernel launches of one forward (``train`` False) or one train step
    that the model's blocks and the fused-LN switch imply. Per block: one
    LN+qkv; the fused-LN attention where the block fuses (conv pools, no
    cls token, the switch on), else one attention (the padded one with a
    cls token) and one LN per conv-pooled q / k / v; one LN+MLP, or, where
    the MLP changes the channels, a separate norm2. The final norm once.
    Training adds each backward once and, under activation checkpointing,
    runs every block's forward kernels twice (the recompute)."""
    from aicity_action_tpu_torch.models.mvit import _fuse_attn_ln_enabled

    n = dict.fromkeys(ALL_FNS, 0)
    remat = 2 if train and model.spec.act_checkpoint else 1

    def add(fwd, bwd, times=1):
        n[fwd] += remat * times
        if train:
            n[bwd] += times

    for blk in model.blocks:
        attn = blk.attn
        add("fused_ln_qkv", "fused_ln_qkv_bwd")
        if (attn.mode == "conv" and not attn.has_cls and attn.pooled
                and _fuse_attn_ln_enabled(train)):
            add("flash_attention_ln_lse" if train else "flash_attention_ln",
                "flash_attention_ln_bwd")
        else:
            attend = ("flash_attention_padded" if attn.has_cls
                      else "flash_attention")
            add(attend, attend + "_bwd")
            add("fused_layer_norm", "fused_layer_norm_bwd",
                len(attn.pooled) if attn.mode == "conv" else 0)
        if blk.proj is None:
            add("fused_ln_mlp", "fused_ln_mlp_bwd")
        else:
            add("fused_layer_norm", "fused_layer_norm_bwd")
    if model.norm is not None:
        n["fused_layer_norm"] += 1
        n["fused_layer_norm_bwd"] += int(train)
    return n


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


@contextlib.contextmanager
def fuse_switch(value: str | None):
    """``AICITY_TPU_FUSE_ATTN_LN`` set to ``value`` (None: unset, the
    default ``auto``) for the duration."""
    prev = os.environ.pop("AICITY_TPU_FUSE_ATTN_LN", None)
    if value is not None:
        os.environ["AICITY_TPU_FUSE_ATTN_LN"] = value
    try:
        yield
    finally:
        os.environ.pop("AICITY_TPU_FUSE_ATTN_LN", None)
        if prev is not None:
            os.environ["AICITY_TPU_FUSE_ATTN_LN"] = prev


def model_checks(card: str, cfg, label: str):
    """The batch-8 eval forward through ``make_eval_step``: launches held
    to the counts the model implies, its time, and a batch-1 forward
    against the same model in plain reference mode."""
    import torch

    from aicity_action_tpu_torch.engine.steps import make_eval_step
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.ops import kernels

    model = build_model(cfg, device="cuda", seed=SEED)
    eval_step = make_eval_step(model)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = _normal(gen, (BATCH, T, S, S, 3))

    reset_counts()
    out = eval_step({"inputs": x})
    torch.cuda.synchronize()
    counts = read_counts()
    want = derived_counts(model, train=False)
    if counts != want:
        _fail(f"{label}: launches per forward {counts} != {want}")
    if out.shape != (BATCH, cfg.MODEL.NUM_CLASSES) or \
            not torch.isfinite(out).all():
        _fail(f"{label} batch-8 forward: non-finite or mis-shaped scores")
    ms = time_ms(lambda: eval_step({"inputs": x}), iters=5)
    print(f"# {label} forward, batch {BATCH} bf16: {ms:.2f} ms, "
          f"{BATCH / ms * 1e3:.2f} clips/s ({card}); launches {counts}")

    # batch 1: kernels against the same model in plain reference mode; the
    # features entering the head are compared too, since softmax scores of
    # random weights sit near 1/num_classes
    feats = []
    hook = model.head.register_forward_hook(
        lambda mod, inp, outp: feats.append(inp[0].float()))
    x1 = x[:1]
    out_k = eval_step({"inputs": x1})
    with kernels.plain_reference():
        out_p = eval_step({"inputs": x1})
    hook.remove()
    torch.cuda.synchronize()
    feat_err = ((feats[0] - feats[1]).norm() / feats[1].norm()).item()
    score_err = (out_k - out_p).abs().max().item()
    print(f"# {label} batch-1 forward, kernels vs plain reference: "
          f"head-input relative L2 error {feat_err:.3e} (tol 5e-2), max "
          f"|score error| {score_err:.3e} (tol 1e-2)")
    if not (feat_err <= 5e-2 and score_err <= 1e-2):
        _fail(f"{label}: the kernel path disagrees with its plain reference")
    return model, {"forward_ms": ms, "clips_per_s": BATCH / ms * 1e3,
                   "feat_rel_err": feat_err, "score_err": score_err,
                   "launches_per_forward": counts}


def unfused_eval_checks(card: str, model, cfg, label: str):
    """The same batch-8 eval forward with ``AICITY_TPU_FUSE_ATTN_LN=0``:
    the unfused path (pool norms, then the lse-free flash attention), its
    launches held to the derived counts, its time, and its scores against
    the fused forward's."""
    import torch

    from aicity_action_tpu_torch.engine.steps import make_eval_step

    eval_step = make_eval_step(model)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = _normal(gen, (BATCH, T, S, S, 3))
    fused = eval_step({"inputs": x})
    with fuse_switch("0"):
        reset_counts()
        out = eval_step({"inputs": x})
        torch.cuda.synchronize()
        counts = read_counts()
        want = derived_counts(model, train=False)
        if counts != want:
            _fail(f"{label} unfused: launches per forward {counts} != {want}")
        ms = time_ms(lambda: eval_step({"inputs": x}), iters=5)
    err = (out - fused).abs().max().item()
    print(f"# {label} forward with AICITY_TPU_FUSE_ATTN_LN=0, batch {BATCH} "
          f"bf16: {ms:.2f} ms, {BATCH / ms * 1e3:.2f} clips/s ({card}); max "
          f"|score - fused path's| {err:.3e} (tol 1e-2); launches {counts}")
    if not err <= 1e-2:
        _fail(f"{label}: the unfused eval disagrees with the fused one")
    return {"forward_ms": ms, "clips_per_s": BATCH / ms * 1e3,
            "score_err_vs_fused": err, "launches_per_forward": counts}


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

def train_checks(card: str, cfg, label: str, batch_size: int):
    """The full model's train step through ``make_train_step`` (the
    config's mixup, activation checkpointing and optimizer; bf16 compute,
    f32 params and optimizer state): warm-up steps, then timed steps with
    the launch counts set to 0 just before and held to the counts the
    model implies just after."""
    import torch

    from aicity_action_tpu_torch.data.mixup import build_mixup_from_cfg
    from aicity_action_tpu_torch.engine.steps import make_train_step
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.solver.optimizer import construct_optimizer

    model = build_model(cfg, device="cuda", seed=SEED)
    opt = construct_optimizer(cfg, model, steps_per_epoch=100)
    step = make_train_step(model, opt, cfg.MODEL.LOSS_FUNC,
                           mixup_fn=build_mixup_from_cfg(cfg),
                           num_classes=cfg.MODEL.NUM_CLASSES, seed=SEED)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    batch = {"inputs": _normal(gen, (batch_size, T, S, S, 3)),
             "labels": torch.randint(0, cfg.MODEL.NUM_CLASSES,
                                     (batch_size,), generator=gen,
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
    want = {k: TRAIN_STEPS * v
            for k, v in derived_counts(model, train=True).items()}
    print(f"# {label} train step, batch {batch_size}: {ms:.2f} ms/step, "
          f"{batch_size / ms * 1e3:.3f} clips/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({card}); losses {losses}; grad norms "
          f"{norms}; launches over {TRAIN_STEPS} steps {launches}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        _fail(f"{label}: non-finite loss or gradient norm in the train step")
    if launches != want:
        _fail(f"{label}: train-step launches {launches} != {want}")
    del step, opt, batch, model
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "clips_per_s": batch_size / ms * 1e3,
            "peak_mem_bytes": peak, "losses": losses, "grad_norms": norms,
            "launches": launches,
            "launches_per_step": {k: v // TRAIN_STEPS
                                  for k, v in launches.items()}}


def train_grad_check(cfg, label: str):
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
    # each leaf within 5e-2 relative L2, or within what the plain reference
    # itself moves it by for one bf16 rounding of its input
    floors = {i: ((grads_n[i] - grads_p[i]).norm()
                  / grads_p[i].norm().clamp_min(1e-30)).item() for i in rel}
    bounds = {i: max(5e-2, floors[i]) for i in rel}
    worst = max(rel, key=lambda i: rel[i] / bounds[i])
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    norm_err = abs(norm_k - norm_p) / norm_p
    print(f"# {label} batch-1 train step, kernels vs plain reference: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_err:.2e}, tol 1e-2), "
          f"grad_norm {norm_k:.6f} vs {norm_p:.6f} (rel {norm_err:.2e}, "
          f"tol 2e-2), worst leaf {names[worst]} relative L2 "
          f"{rel[worst]:.3e} (tol {bounds[worst]:.3e}: 5e-2, or what the "
          f"plain reference moves it by for a bf16 rounding of its input, "
          f"{floors[worst]:.3e}), median "
          f"{float(np.median(list(rel.values()))):.3e}; {len(zero)} "
          f"zero-gradient leaves (k-norm biases) at most {zero_max:.3e} "
          f"(tol {1e-3 * norm_p:.3e})")
    if not (loss_err <= 1e-2 and norm_err <= 2e-2
            and rel[worst] <= bounds[worst] and zero_max <= 1e-3 * norm_p):
        _fail(f"{label}: the train step's kernel gradients disagree with "
              "the plain reference")
    del model, grads_k, grads_p, grads_n
    torch.cuda.empty_cache()
    return {"loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
            "worst_leaf": names[worst], "worst_leaf_rel_l2": rel[worst],
            "worst_leaf_plain_noise_floor": floors[worst],
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
    from aicity_action_tpu_torch.config import (mvit_b_16x4_224_cfg,
                                                mvitv2_b_16x4_448_cfg)

    card = card_line()
    print(f"# card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    build_kernels()
    hopper_sass_checks()
    descriptor_checks()
    checks = kernel_checks()
    checks.update(train_kernel_checks())
    checks.update(v1_kernel_checks())
    for name, cases in checks.items():
        for c in cases:
            print(f"# {name} {c['shape']}: err {c['max_abs_err']:.3e} "
                  f"(tol {c['tol']:.3e}), {c['ms']:.4f} ms (n {c['n']}, "
                  f"iqr {c['ms_iqr'][0]:.4f}-{c['ms_iqr'][1]:.4f}), plain "
                  f"{c['plain_ms']:.4f} ms, library {c['library_ms']:.4f} "
                  f"ms (iqr {c['library_iqr'][0]:.4f}-"
                  f"{c['library_iqr'][1]:.4f}), bound {c['bound_ms']:.4f} "
                  f"ms ({c['bound_by']})"
                  + (f"; before the residual err "
                     f"{c['pre_residual']['max_abs_err']:.3e} (tol "
                     f"{c['pre_residual']['tol']:.3e})"
                     if "pre_residual" in c else "")
                  + (_fwd_note(*c["_fwd"]) if "_fwd" in c else ""))
    # each path runs with the counts set to 0 just before it and read just
    # after; the default switch (auto) unless stated
    cfg = mvitv2_b_16x4_448_cfg()
    model, model_stats = model_checks(card, cfg, "MViT-v2-B 16x4 @448")
    launches = {"v2 scorer": scorer_checks(model, cfg)}
    model_stats["unfused"] = unfused_eval_checks(card, model, cfg,
                                                 "MViT-v2-B 16x4 @448")
    launches["v2 unfused eval"] = model_stats["unfused"][
        "launches_per_forward"]
    del model
    torch.cuda.empty_cache()
    cfg.MIXUP.ENABLE = True
    if not cfg.MODEL.ACT_CHECKPOINT:
        _fail("the 448 recipe is expected to checkpoint activations")
    train_stats = train_checks(card, cfg, "MViT-v2-B 16x4 @448 (mixup, "
                               "activation checkpointing, AdamW)", TRAIN_BATCH)
    launches["v2 train"] = train_stats["launches"]
    # the fused-LN attention in training, timed in the same call as the
    # default step above
    with fuse_switch("1"):
        fused_stats = train_checks(
            card, cfg, "MViT-v2-B 16x4 @448 with AICITY_TPU_FUSE_ATTN_LN=1",
            TRAIN_BATCH)
        fused_stats["grad_check"] = train_grad_check(
            cfg, "MViT-v2-B @448, AICITY_TPU_FUSE_ATTN_LN=1")
    launches["v2 fused train"] = fused_stats["launches"]
    train_stats["grad_check"] = train_grad_check(cfg, "MViT-v2-B @448")

    v1_cfg = mvit_b_16x4_224_cfg()
    model, v1_stats = model_checks(card, v1_cfg, "MViT-B 16x4 @224 (cls)")
    launches["v1 eval"] = v1_stats["launches_per_forward"]
    del model
    torch.cuda.empty_cache()
    v1_train = train_checks(card, v1_cfg, "MViT-B 16x4 @224 (cls; mixup, "
                            "AdamW)", BATCH)
    v1_train["grad_check"] = train_grad_check(v1_cfg, "MViT-B 16x4 @224")
    launches["v1 train"] = v1_train["launches"]

    # launches of each kernel in the run of the path it serves: the scorer
    # run for the inference kernels, the timed train steps for the others
    owner = {**dict.fromkeys(KERNEL_FNS, "v2 scorer"),
             **dict.fromkeys(TRAIN_KERNEL_FNS, "v2 train"),
             **dict.fromkeys(V1_KERNEL_FNS, "v1 train"),
             **dict.fromkeys(FUSED_KERNEL_FNS, "v2 fused train")}
    kernels_line = []
    for name in ALL_FNS:
        first = checks[name][0]
        source, replaces = SOURCES[name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[owner[name]][name],
            **{k: first[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
            "shape": first["shape"],
            "launches_on": owner[name],
            "launches_by_path": {path: n[name]
                                 for path, n in launches.items()},
            "other_shapes": [_public(c) for c in checks[name][1:]],
        })
    for extra in ("fused_ln_qkv odd tokens", "fused_ln_qkv_bwd odd tokens",
                  "fused_ln_mlp odd tokens", "fused_ln_mlp_bwd odd tokens"):
        base = extra.split()[0]
        next(k for k in kernels_line if k["name"] == base)[
            "odd_token_shapes"] = [_public(c) for c in checks[extra]]
    print(json.dumps({"model": model_stats, "train": train_stats,
                      "fused_train": fused_stats, "v1_model": v1_stats,
                      "v1_train": v1_train}))
    print(json.dumps({"kernels": kernels_line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
