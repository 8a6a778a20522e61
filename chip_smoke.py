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
   backward kernel spills or has more than 255; prints the registers and
   spills of the LayerNorm kernels (rows 12-13, both instances) and fails
   if one spills or if the channel-major pair has no UTMALDG; then holds
   the 64-byte-swizzle wgmma descriptors that the attention kernels build
   on against torch on one tile.
2. Holds rows 12 and 13 against their plain versions and times them: the
   channel-major instance at the v2 448 batch-4 pool norms of blocks 0 (q),
   1 (k), 4-13 (k) and 15 (q) and block 0's q at batch 8 (library:
   ``.contiguous()`` + ``F.layer_norm``), the rows instance at the final
   norm (batch 8 and 1; the backward also at 4) and the v1 224's block-1 q
   pool norm (cls token, batch 8; library ``F.layer_norm``). Then holds
   each other inference kernel against its plain PyTorch version at
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
   with its logsumexp, and the backward kernels of attention, LN+qkv and
   LN+MLP) at the batch-4 training shapes of blocks 0, 1 and 15
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
   per forward to the counts the model implies (the channel-major
   LayerNorm's launches also on their own), and compares a batch-1
   forward with the same model in its plain reference mode; then the same
   forward with ``AICITY_TPU_FUSE_ATTN_LN=0`` (the unfused eval path).
6. Drives the serving path, ``WindowScorer``, over a synthetic in-memory
   I420 video, with the launch counts set to 0 just before and read just
   after; checks the windows against a direct forward and round-trips the
   pickle.
7. Runs README's AI City chain through the port's CLIs, in process: writes
   three 960x540 YUV4MPEG2 views (one longer than the CLI's 512-frame
   chunk), decodes each sequentially and with 4 parallel decoders (equal
   bit for bit), runs ``run_temporal_inf`` (its launches held to
   ``derived_counts`` times its forwards), ``aicity_inf_graph`` and
   ``aicity_inf``, and holds the pickles to ``WindowScorer.score_video``,
   three windows to a direct forward, the exact-RGB path to the loader
   path (cv2, a short view), and the thresholds, F1 and submission to
   ``postprocess``. Decodes as a user's run does: with the port's FFmpeg
   library where ``pkg-config`` finds FFmpeg's development files, else
   with cv2 (and then checks that asking for the library raises, naming
   the missing package). Then two gloo ranks on the one card score the
   long view through ``run_temporal_inf NUM_GPUS 2`` (each rank the
   windows that start in its share of the chunks): rank 0's pickle held
   to the one-rank pickle, the ranks' launches summed to ``derived_counts``
   times their forwards.
8. Drives the training path, ``make_train_step``, at batch 4 with mixup,
   activation checkpointing and AdamW (two warm-up steps, then timed
   steps; the counts set to 0 just before the timed steps and read just
   after, and held to the counts the config implies), then the same with
   ``AICITY_TPU_FUSE_ATTN_LN=1`` (the fused-LN attention in training), and
   compares one batch-1 step's gradients with the model's plain reference
   mode, for both.
9. Drives MViT-B 16x4 @ 224 with a cls token (PySlowFast's Kinetics-400
   MViT-v1) the same way: the batch-8 eval forward and the batch-8 train
   step (mixup, AdamW), with their launch counts and batch-1 checks.
10. Runs the training loop of the main path through ``tools/run_net.py``
    in process (``train_loop_checks``): MViT-v2-B 16x4 @448 from seed 0 at
    batch 4 on 8 written 960x540 YUV4MPEG2 views, one epoch (2 steps, an
    eval, a checkpoint, the two-view test), then a second call that
    auto-resumes at epoch 1 and trains epoch 2; each call's launches held
    to ``derived_counts`` times its steps and forwards, its losses finite,
    its checkpoints and step count, the model's inputs bf16 on the card,
    the test's stats and results pickle; prints ms/step with data, the
    data-wait share, eval clips/s, peak memory and checkpoint seconds.
11. Runs the same loop under DDP (``ddp_loop_checks``): ``run_net --ddp``
    (a one-rank NCCL group, ``DistributedDataParallel``, ``zero_adamw``)
    for epoch 1, then a call without a group that resumes its checkpoint
    under ``adamw`` for epoch 2, held as phase 10; prints the DDP epoch's
    ms/step with data beside phase 10's.
12. Two gloo ranks on the one card (``two_rank_checks``), each with 2 of a
    4-clip global batch, take two SGD steps of MViT-v2-B @448 and of
    SlowFast R50 8x8 under DDP, held to one-process runs on the whole
    batch: each step's loss and grad norm against the bf16 run, every
    leaf's gradient and every BatchNorm statistic against the f32 run
    (``PERF.md`` section 2's gates), which must also reject what a rank
    computes without the cross-rank all-reduces.
13. SlowFast R50 8x8 (``slowfast_checks``; seed 0, bf16): the batch-8 eval
    forward in both conv layouts, a batch-8 train step with BatchNorm
    updates, precise BN over 2 batches, a batch-1 forward against the
    plain f32 forward on the CPU, ``run_temporal_inf`` on a written view
    through the window-streaming path, and no launch of any kernel row.
14. MViT-v2-B 16x4 @448 detection (``detection_checks``; seed 0, bf16):
    the batch-8 eval forward on 28-box slabs and a batch-4 detection train
    step (masked BCE), each with its launches held to ``derived_counts``
    and a batch-1 check against the plain reference, then
    ``run_temporal_inf`` with the detection config on a written view (one
    whole-frame box a window), its launches held to ``derived_counts``
    times its forwards.
15. SlowFast R50 32x2 on AVA (``ava_checks``): ``tools/run_net.py`` on a
    written AVA tree, one epoch, eval and test to a finite frame mAP, and
    no launch of any kernel row.
16. ActionCLIP @448 (``actionclip_checks``; the AI City MViT-v2-B video
    tower and CLIP's ViT-B text tower, seed 0, bf16): the batch-8 feature
    forward (launches held to ``derived_counts``, video features against
    the plain reference mode, text features against the plain f32 text
    tower), the batch-4 contrastive train step without and with MoCo
    (launches held to ``derived_counts``, the momentum forward's inference
    rows counted apart from the step's training rows; finite losses, the
    temperature clamped), a batch-2 step's gradients against the plain
    reference.
17. The ActionCLIP loop (``actionclip_loop_checks``):
    ``tools/run_net_contrastive.py`` in process on the train loop's 8
    written views with captions tokenized by the port's tokenizer, one
    epoch with MoCo, an eval and a checkpoint, then a call that
    auto-resumes (the momentum weights too), trains epoch 2 and writes
    the test's feature pickle; then ``inference_videotext`` with the text
    tower alone ranks the pickle as the loop's own features do.
18. The multi-head fine-tune (``multihead_checks``): ``tools/run_net.py``
    in process with MViT-v2-B 16x4 @448 and the reference's default
    multi-dataset heads (kinetics 700, mmit 292, activitynet 200), the
    cross projections and VICReg, batch 4 on clips of the loop's views,
    3 steps and an eval with TensorBoard where it imports (else a writer
    that warns and drops the scalars); launches held to
    ``derived_counts``, finite
    losses, and a batch-1 step's gradients (heads and cross projections
    included) against the plain reference. Prints whether TensorBoard
    imports.
19. The loader and decode benchmarks (``benchmark_checks``):
    ``tools/benchmark.py`` on the loop's views and
    ``tools/benchmark_decode.py --seconds 10 60 --reps 3``, printed.
20. ``VideoActionClassifier`` at @448 batch 8 (``classifier_checks``):
    eager inference (padding, splitting) with its launches held to
    ``derived_counts``, then ``export`` / ``exported_path=``: the program's
    launches of rows 5, 8, 10 and 12 equal one forward's, its scores the
    eager ones within 1e-2; both forwards timed.
21. The fire drill (``fire_drill_checks``): ``tools/fire_drill.py`` as a
    subprocess on a seed-0 @448 ``.pyth`` and two written views: a finite
    F1, a clean load, a rerun that skips scoring; and the YAML's
    ``NUM_GPUS 8`` refused before spawning on this one-card host.
22. MoE MViT-v2-B 16x4 @448 (``moe_checks``; 8 experts, top-2, capacity
    1.25, every other block a bank): the batch-8 scoring forward with its
    launches held to ``derived_counts`` (no LN+MLP in the banks), its time
    and peak memory, a batch-1 forward against the plain f32 forward
    (head input within 5e-2) and a control with every bank's experts
    rolled by one that the gate refuses, then
    ``run_net`` (2 steps at batch 4 with the load-balance loss, an eval, a
    checkpoint, the test) held as phase 10 holds its runs.
23. Long-cycle multigrid (``multigrid_checks``): ``run_net`` on SlowOnly
    R50 8x8 over the loop's views, batch 8 of 4 frames then batch 4 of 8
    frames in turn, the model rebuilt at each change with its weights, no
    kernel row launched.
24. EP, SP and TP in one ``mp.spawn`` of two gloo ranks on the one card
    (``parallel_checks``), at full width, each held to its one-process run
    in this process: the MoE model's SGD step with 4 of the 8 experts a
    rank, one clip scored with the T frames split over the ranks, the plain
    model's SGD step with its big weights split over the ranks; each
    rank's launches held to ``derived_counts``.
25. ``MViTPipeline`` (``pp_checks``): 2 stages on the one card, 4
    microbatches of a batch of 4, its gradients against the plain step,
    its launches 4 microbatches of the train-step rows with each stage's
    forward but the last run twice (the fill keeps the last stage's input
    only; the drain runs every stage under autograd).
26. MViT-v2-L widths @448 (``l_kernel_checks``, ``l_model_checks``;
    ``mvitv2_l_16x4_448_cfg``: 48 blocks, head dim 72, 144-1152
    channels, seed 0, bf16): each widened kernel at the L path's batch-8
    shapes of blocks 0, 2, 8, 44 and 47 (LN+qkv, the fused-LN attention,
    the lse-free flash attention, LN+MLP) and the rows LayerNorm at the
    final norm [B*1568, 1152] and a head-dim-72 pool norm, against its
    plain version, timed beside its bound and library call; the b8 eval
    forward with its launches held to ``derived_counts`` (rows 8 / 5 / 10
    / 12 at 48 / 48 / 48 / 1) and its scores and head input against the
    plain f32 forward; the same forward under ``AICITY_TPU_FUSE_ATTN_LN=0``
    (row 1 and the rows LayerNorm at head dim 72); ``run_temporal_inf``
    with the L widths as command-line overrides on a written view, its
    launches held to ``derived_counts`` times its forwards and its pickle
    to ``WindowScorer.score_video``. The SASS check of phase 1 holds the
    new instances (the attention forwards at head dim 72, the 144-column
    LN+qkv and LN+MLP) to no spills.
27. MViT-v2-L training @448 on both switches
    (``head_dim_72_identity_checks``, ``l_train_kernel_checks``,
    ``l_fused_kernel_checks``, ``train_checks``, ``train_grad_check``,
    ``l_fused_train_checks``, ``l_run_net_checks``): the attention forward
    with its logsumexp and its backward at head dim 72 bit-equal to the d-96
    kernels on zero-padded inputs; rows 2, 3, 9, 11 and 13 at every distinct
    call of the b4 train step (the attention with its logsumexp and its
    backward at head dim 72, the LN+qkv and LN+MLP backwards at 144-1152
    channels, the rows LayerNorm backward at the head-dim-72 pool norms and
    the final norm over 1152), each against its plain version and timed beside
    its bound and library call; the b4 train step (mixup, checkpointing,
    AdamW: warm-up, then timed steps, ms/step, peak memory) with its launches
    held to ``derived_counts``; the b1 gradient gate, every leaf against the
    plain f32 step (bf16's own distance the largest of ``L_GRAD_DRAWS``
    draws); under ``AICITY_TPU_FUSE_ATTN_LN=1``, rows 6 and 7 (the fused-LN
    attention's forward with its logsumexp and its backward) at head dim 72 at
    every distinct call of the b4 step and the row-4 backward at head dim 72
    at odd lengths, each against its plain version, the b4 step with its
    launches held to ``derived_counts`` (rows 6-7 in every block), its ms/step
    and peak memory beside the default switch's, and the same b1 gradient
    gate; on each switch one ``run_net`` epoch with the L widths as overrides
    (2 steps, eval, test, checkpoint, launches). Phase 1 holds the instances
    the L training adds (the attention backward at head dim 72, the fused-LN
    dq kernel and dk/dv LN VJP at head dim 72, the 64-wide dual GEMM, the
    1152-channel pre-passes and LN backwards, the ragged gradients' pass, the
    rows backward's wide instance) to no spills and no serialized wgmma, and
    the descriptors at head dim 72 too.
28. Prints ``{"kernels": [...]}`` (the widened rows with their L shapes
    and launches), the card line, and last ``{"ok": true, "device":
    {...}}``.

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
# most[, the instances it holds: substrings of their mangled names; else
# every instance]). The attention forwards' rows take their head-dim-72
# instances (MViT-v2-L) too; the LN+qkv and fused LN+MLP forwards hold their
# 144-column instances (MViT-v2-L's C = 144).
NO_SPILL_KERNELS = {"fused_ln_qkv_bwd": (HOPPER_REGISTERS, True),
                    "fused_ln_mlp_bwd": (HOPPER_REGISTERS, True),
                    "flash_attention": (HOPPER_REGISTERS, False),
                    "flash_attention_ln": (HOPPER_REGISTERS, False),
                    "flash_attention_bwd": (255, False),
                    "flash_attention_ln_bwd": (255, False),
                    "fused_ln_qkv": (HOPPER_REGISTERS, True,
                                     ("ln_qkv_kernelILi144E",)),
                    "fused_ln_mlp": (HOPPER_REGISTERS, True,
                                     ("ln_mlp_kernel_fusedILi144E",))}
# the head-dim-72 instances of the attention forwards, which the SASS check
# must find
L_ATTN_INSTANCES = {"flash_attention": "flash_fwd_kernelILi64ELi72E",
                    "flash_attention_ln": "flash_ln_kernelILi64ELi72E"}
# the instances the L training widths added to the training rows (the
# attention backward at head dim 72; the LN+MLP backward's 64-wide dual
# GEMM, for H = 576), which the SASS check must find and holds as their
# rows' others
L_TRAIN_INSTANCES = {"flash_attention_bwd": ("flash_bwd_dq_kernelILi72E",
                                             "flash_bwd_dkv_kernelILi3ELi72E"),
                     "fused_ln_mlp_bwd": ("mlp_bwd_dual_kernelILi64E",),
                     "flash_attention_ln_bwd": (
                         "flash_ln_bwd_dq_kernelILi72E",)}
# the plain helper kernels that the L widths added to a row (the statistics
# pre-passes at 1152 channels; for training, the dense backwards' pre-passes
# at 1152 channels and LN backwards over 1152, the LN+qkv gradients' pass
# with a ragged 96-channel chunk, the attention backward's pre-pass at head
# dim 72), and the fused-LN attention's passes around its cores at both
# head dims (the K/V LN pass of rows 5-7, the dk/dv LN VJP and the dgamma /
# dbeta sums of row 7): found in the build log and held to no spills
NO_SPILL_HELPERS = ("ln_qkv_kernel_statsILi36E", "ln_mlp_kernel_statsILi36E",
                    "qkv_bwd_prep_kernelILi36E", "mlp_bwd_prep_kernelILi36E",
                    "qkv_bwd_ln_kernelILi9E", "mlp_bwd_ln_kernelILi9E",
                    "qkv_bwd_grad_kernelILb1E", "flash_bwd_prep_kernelILi72E",
                    "kv_norm_kernelILi96E", "kv_norm_kernelILi72E",
                    "kv_vjp_kernelILi96E", "kv_vjp_kernelILi72E",
                    "flash_ln_bwd_sum_kernel")


# the LayerNorm kernels (rows 12-13): no tensor-core work, so no HGMMA;
# the channel-major pair reads its x tiles by TMA (UTMALDG), and none may
# spill
LN_KERNELS = {"fused_layer_norm": ("ln_rows_kernel", "ln_cols_kernel"),
              "fused_layer_norm_bwd": ("ln_rows_bwd_kernel",
                                       "ln_cols_bwd_kernel")}
LN_TMA_KERNELS = ("ln_cols_kernel", "ln_cols_bwd_kernel")
# the rows backward's wide instance (MViT-v2-L's final norm over 1152)
LN_WIDE_BWD = "ln_rows_bwd_kernelILi32ELi5E"


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
                k in fn for table in (HOPPER_KERNELS, LN_KERNELS)
                for keys in table.values() for k in keys):
            c = counts.setdefault(fn, {"HGMMA": 0, "UTMALDG": 0})
            for op in c:
                c[op] += op in line
    usage, entry = {}, None
    log = (kernels.BUILD_DIR / "build.log").read_text()
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("spill" in line or "registers" in line):
            usage.setdefault(entry, []).append(line.strip())
    for key in NO_SPILL_HELPERS:
        fns = [f for f in usage if key in f]
        if not fns:
            _fail(f"no {key} function in the build log")
        for f in fns:
            text = " / ".join(usage[f])
            print(f"# build {key}: {text}")
            if " 0 bytes spill stores, 0 bytes spill loads" not in text:
                _fail(f"{f} spills: {text}")
    # ptxas's C7511: it serialized a kernel's wgmma (too few registers for
    # the pipeline), which loses the overlap of its products
    for line in log.splitlines():
        if ("wgmma.mma_async instructions are serialized" in line
                and any(f in line for f in counts)):
            _fail(f"ptxas serialized a Hopper kernel's wgmma: {line.strip()}")
    for name, keys in HOPPER_KERNELS.items():
        fns = [f for f in counts if any(k in f for k in keys)]
        wanted = list(keys)
        if len(NO_SPILL_KERNELS.get(name, ())) > 2:
            wanted += NO_SPILL_KERNELS[name][2]
        if name in L_ATTN_INSTANCES:
            wanted.append(L_ATTN_INSTANCES[name])
        wanted += L_TRAIN_INSTANCES.get(name, ())
        missing = [k for k in wanted if not any(k in f for f in fns)]
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
            regs, exact, *only = NO_SPILL_KERNELS[name]
            if only and not any(k in f for k in only[0]):
                continue
            used = re.search(r"Used (\d+) registers", text)
            used = int(used.group(1)) if used else None
            ok_regs = used is not None and (
                used == regs if exact else used <= regs)
            if not ok_regs or (" 0 bytes spill stores, 0 bytes spill loads"
                               not in text):
                _fail(f"{name}: {f} spills or breaks its budget of {regs} "
                      f"registers: {text}")
    if not any(LN_WIDE_BWD in f for f in counts):
        _fail(f"fused_layer_norm_bwd: no {LN_WIDE_BWD} function in the "
              "library's SASS")
    for name, keys in LN_KERNELS.items():
        for key in keys:
            fns = [f for f in counts if key in f]
            if not fns:
                _fail(f"{name}: no {key} function in the library's SASS")
            for f in fns:
                text = " / ".join(usage.get(f, []))
                print(f"# SASS {name} {f}: UTMALDG {counts[f]['UTMALDG']}; "
                      f"{text}")
                if key in LN_TMA_KERNELS and not counts[f]["UTMALDG"]:
                    _fail(f"{name}: {f} has no UTMALDG")
                if " 0 bytes spill stores, 0 bytes spill loads" not in text:
                    _fail(f"{name}: {f} spills: {text}")
    return counts


def descriptor_checks() -> None:
    """The one-tile check of the 64-byte-swizzle wgmma descriptors that the
    attention backward builds on (``csrc/flash_attention.cu:
    wgmma_sw64_probe_kernel``): a b^T with A from registers and B K-major
    (the logits), and bf16(a b^T) b through an MN-major B (dq, dk, dv),
    against torch in f32 from the same bf16 inputs, within 1e-3 of each
    product's largest magnitude (f32 sums in another order; a wrong byte
    offset moves whole rows); at head dim 96 and at 72, whose 144-byte rows
    TMA loads into the 96-column tile with zeros past column 72."""
    import torch
    import torch.nn.functional as F

    from aicity_action_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    for d in (96, 72):
        a, b = (_normal(gen, (64, d), 1.0, torch.bfloat16) for _ in range(2))
        c1 = torch.empty((64, 64), device="cuda")
        c2 = torch.empty((64, 96), device="cuda")
        kernels.check(kernels.lib().aicity_wgmma_sw64_probe(
            a.data_ptr(), b.data_ptr(), c1.data_ptr(), c2.data_ptr(), d,
            kernels.stream()), "wgmma_sw64_probe")
        torch.cuda.synchronize()
        b96 = F.pad(b.float(), (0, 96 - d))
        for name, out, want in (
                ("A from registers, B K-major", c1, a.float() @ b.float().t()),
                ("B MN-major", c2, c1.bfloat16().float() @ b96)):
            err = (out - want).abs().max().item()
            tol = 1e-3 * want.abs().max().item()
            print(f"# wgmma 64-byte swizzle, head dim {d}, {name}: max err "
                  f"{err:.3e} (tol {tol:.3e})")
            if not err <= tol:
                _fail(f"wgmma 64-byte swizzle descriptors, head dim {d}, "
                      f"{name}: max err {err} > {tol}")


# ------------------------------------------------------------------ kernels

def _normal(gen, shape, std=1.0, dtype=None, device=None):
    """Normal draws of ``std`` from ``gen``, on its device unless given."""
    import torch

    t = torch.randn(shape, generator=gen,
                    device=gen.device if device is None else device) * std
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


def _qkv_case(gen, shape, M, L, D, C):
    """fused_ln_qkv on x [M, D] of clips of L tokens (q, k, v of C channels
    each, written channel-major [B, C, L]) against its plain version and
    LN + linear."""
    import torch
    import torch.nn.functional as F

    from aicity_action_tpu_torch.ops import fused_dense as fd

    bf = torch.bfloat16
    x = _normal(gen, (M, D), 1.0, bf)
    g = _normal(gen, (D,), 0.1, bf) + 1
    bb = _normal(gen, (D,), 0.1, bf)
    w = _normal(gen, (3 * C, D), D ** -0.5, bf)
    bias = _normal(gen, (3 * C,), 0.1, bf)
    args = (x, g, bb, w, bias, 1e-6)

    def library():
        return F.linear(F.layer_norm(x, (D,), g, bb, 1e-6), w, bias)

    r = _check_case(
        "fused_ln_qkv", lambda: fd.fused_ln_qkv(*args, tokens=L),
        lambda: fd.ln_qkv_plain(*args, tokens=L), library,
        flops=2 * M * D * 3 * C,
        nbytes=2 * (M * D + 3 * M * C + 3 * C * D + 3 * C + 2 * D),
        peak=PEAK_BF16, iters=20)
    r["shape"] = shape
    return r


def _attn_ln_case(gen, shape, G, Lq, Lk, d):
    """flash_attention_ln over G groups of Lq queries and Lk keys of head
    dim d, all three LNs and the q-residual, q, k, v the d-major views the
    main path passes (pool outputs [G, d, L]), against its plain version
    and LN + SDPA; then the attention alone (no residual) against its
    plain version."""
    import torch
    import torch.nn.functional as F

    from aicity_action_tpu_torch.ops import flash_attention as fa

    bf = torch.bfloat16
    q, k, v = (_normal(gen, (G, d, n), 1.0, bf).transpose(1, 2)
               for n in (Lq, Lk, Lk))
    lnp = [t for _ in range(3) for t in (
        _normal(gen, (d,), 0.1, bf) + 1, _normal(gen, (d,), 0.1, bf))]
    args = (q, k, v, *lnp, d ** -0.5, 1e-5, (True, True, True), True)

    def library():
        qn, kn, vn = (F.layer_norm(t, (d,), lnp[2 * i], lnp[2 * i + 1],
                                   1e-5) for i, t in enumerate((q, k, v)))
        return _sdpa(qn, kn, vn) + qn

    r = _check_case(
        "flash_attention_ln", lambda: fa.flash_attention_ln(*args),
        lambda: fa.flash_attention_ln_plain(*args), library,
        flops=4 * G * Lq * Lk * d,
        nbytes=2 * (2 * G * Lq * d + 2 * G * Lk * d + 6 * d),
        peak=PEAK_BF16, iters=5)
    r["shape"] = shape
    # the attention alone: without the residual, whose LN(q) (of order 1)
    # sets the tolerance above, the output is held within 2% of its own
    # largest magnitude
    pre = args[:-1] + (False,)
    r["pre_residual"] = dict(zip(
        ("max_abs_err", "tol", "max_rel_err"), check_outputs(
            f"flash_attention_ln {shape} before the residual",
            fa.flash_attention_ln(*pre), fa.flash_attention_ln_plain(*pre))))
    return _mark_fwd(r, G, Lq, Lk, d)


def kernel_checks():
    """Each kernel at its main-path shapes (batch 8 unless stated)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}

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
        cases.append(_qkv_case(
            gen, f"block {blk} x[{b * L},{D}] w[{3 * C},{D}] -> [B,C,L]"
            + ("" if b == BATCH else f" (batch {b})"), b * L, L, D, C))
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
    for blk, h, Lq, Lk in ((0, 1, 100352, 1568), (1, 2, 25088, 6272),
                           ("4-13", 4, 6272, 1568), (15, 8, 1568, 1568)):
        G = BATCH * h
        cases.append(_attn_ln_case(
            gen, f"block{'s' if blk == '4-13' else ''} {blk} "
            f"q[{G},{Lq},96] k,v[{G},{Lk},96] d-major"
            + (" (10 calls a forward)" if blk == "4-13" else ""),
            G, Lq, Lk, 96))
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


def _mark_fwd(r, G, Lq, Lk, d=96):
    """Marks case ``r`` as an attention forward over ``G`` groups of ``Lq``
    queries and ``Lk`` keys of head dim ``d``, for its comment line
    (:func:`_fwd_note`); the mark stays off the JSON lines."""
    r["_fwd"] = (G, Lq, Lk, d)
    return r


def _public(case: dict) -> dict:
    """A case's result without its marks (keys starting with ``_``), for
    the JSON lines."""
    return {k: v for k, v in case.items() if not k.startswith("_")}


def _fwd_note(G, Lq, Lk, d=96) -> str:
    """An attention forward's figures computed from its shape, not read:
    its exponential floor (G Lq Lk over PEAK_EX2), the K/V bytes its blocks
    would read from L2 if each read its group's K and V once (a model) and
    its waves of FWD_ROWS-row blocks over the card's SMs."""
    import torch

    blocks = -(-Lq // FWD_ROWS) * G
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (f"; computed: exp floor {G * Lq * Lk / PEAK_EX2 * 1e3:.4f} ms, "
            f"K/V at one read a block {blocks * 2 * Lk * d * 2 / 1e9:.3f} "
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

    from aicity_action_tpu_torch.ops import flash_attention as fa

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


# --------------------------------------------------------------- LayerNorm

# the pool norms of the v2 448 step (what, batch, h*d, L, heads): the
# channel-major instance; block 0 q also at batch 8 (the eval forward under
# AICITY_TPU_FUSE_ATTN_LN=0)
POOL_NORM_CASES = (("v2 block 0 q", TRAIN_BATCH, 96, 100352, 1),
                   ("v2 block 1 k", TRAIN_BATCH, 192, 6272, 2),
                   ("v2 blocks 4-13 k", TRAIN_BATCH, 384, 1568, 4),
                   ("v2 block 15 q", TRAIN_BATCH, 768, 1568, 8),
                   ("v2 block 0 q", BATCH, 96, 100352, 1))
# the rows instance (what, rows, C, eps, forward too): the final norm at
# batch 8 and 1 (eval) and 4 (the train step's backward), and the v1 224's
# largest cls-token pool norm, block 1 q over 6273 tokens, 2 heads, batch 8
ROWS_NORM_CASES = (("final norm (batch 8)", BATCH * 1568, 768, 1e-6, True),
                   ("final norm (batch 1)", 1568, 768, 1e-6, True),
                   ("final norm (batch 4)", TRAIN_BATCH * 1568, 768, 1e-6,
                    False),
                   ("v1 block 1 q pool norm (cls, batch 8)",
                    BATCH * 2 * 6273, 96, 1e-5, True))


def layer_norm_checks():
    """Rows 12 and 13, each instance at the shapes of its path: the
    channel-major pool norm (``pool_norm_rows`` and its backward, against
    the plain copy + LN and, as the library yardstick, ``.contiguous()`` +
    ``F.layer_norm``, since the kernel does both jobs) at POOL_NORM_CASES,
    the rows instance (against ``F.layer_norm``) at ROWS_NORM_CASES.
    Bounds: 4 bytes an element forward, 6 backward; backwards' plain and
    library times are of forward + backward."""
    import torch
    import torch.nn.functional as F

    from aicity_action_tpu_torch.ops import layer_norm as ln

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    fwd, bwd = [], []
    for what, B, C, L, h in POOL_NORM_CASES:
        eps, N, d = 1e-5, B * C * L, C // h
        t = _normal(gen, (B, C, L), 2.0, bf)
        g = _normal(gen, (d,), 0.1, bf) + 1
        bb = _normal(gen, (d,), 0.1, bf)
        dy = _normal(gen, (B * h, L, d), 1.0, bf)

        def rows(a, B=B, h=h, d=d, L=L):
            return (a.reshape(B, h, d, L).transpose(2, 3)
                    .reshape(B * h, L, d).contiguous())

        shape = (f"{what} norm t[{B},{C},{L}] -> rows[{B * h},{L},{d}] "
                 f"(channel-major)")
        r = _check_case(
            "fused_layer_norm",
            lambda t=t, g=g, bb=bb, h=h: ln.pool_norm_rows(t, g, bb, eps, h),
            lambda t=t, g=g, bb=bb, h=h: ln.pool_norm_rows_plain(
                t, g, bb, eps, h),
            lambda t=t, g=g, bb=bb, rows=rows: F.layer_norm(
                rows(t), (d,), g, bb, eps),
            flops=8 * N, nbytes=2 * (2 * N + 2 * d), peak=PEAK_F32, iters=10)
        r["shape"] = shape
        fwd.append(r)
        r = _check_case(
            "fused_layer_norm_bwd",
            lambda t=t, g=g, dy=dy, h=h: ln.pool_norm_rows_bwd(
                t, g, dy, eps, h),
            lambda t=t, g=g, bb=bb, dy=dy, h=h: _plain_grads(
                lambda a, b, c: ln.pool_norm_rows_plain(a, b, c, eps, h),
                (t, g, bb), (dy,)),
            lambda t=t, g=g, bb=bb, dy=dy, rows=rows: _library_grads(
                lambda a, b, c: F.layer_norm(rows(a), (d,), b, c, eps),
                (t, g, bb), (dy,)),
            flops=20 * N, nbytes=2 * (3 * N + 3 * d), peak=PEAK_F32,
            iters=5)
        r["shape"] = shape
        bwd.append(r)
        del t, dy
        torch.cuda.empty_cache()
    for what, M, C, eps, forward in ROWS_NORM_CASES:
        x = _normal(gen, (M, C), 2.0, bf)
        g = _normal(gen, (C,), 0.1, bf) + 1
        bb = _normal(gen, (C,), 0.1, bf)
        dy = _normal(gen, (M, C), 1.0, bf)
        shape = f"{what} x[{M},{C}] (rows)"
        if forward:
            r = _check_case(
                "fused_layer_norm",
                lambda x=x, g=g, bb=bb, eps=eps: ln.fused_layer_norm(
                    x, g, bb, eps, 1),
                lambda x=x, g=g, bb=bb, eps=eps: ln.layer_norm_plain(
                    x, g, bb, eps, 1),
                lambda x=x, g=g, bb=bb, C=C, eps=eps: F.layer_norm(
                    x, (C,), g, bb, eps),
                flops=8 * M * C, nbytes=2 * (2 * M * C + 2 * C),
                peak=PEAK_F32, iters=50)
            r["shape"] = shape
            fwd.append(r)
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
        r["shape"] = shape
        bwd.append(r)
        del x, dy
    return {"fused_layer_norm": fwd, "fused_layer_norm_bwd": bwd}


# ------------------------------------------- cls-token and fused-LN kernels

def _fused_ln_train_cases(gen, shape, G, Lq, Lk, d, with_fwd: bool):
    """Rows 6 and 7 over ``G`` groups of ``Lq`` queries and ``Lk`` keys of
    head dim ``d`` (d-major q, k, v, all three norms and the residual): the
    forward with its logsumexp (where ``with_fwd``) and the backward, each
    against its plain version in f32 from the same bf16 inputs and timed
    beside LN + SDPA (forward + backward for the backward; the k norm's
    bias gradient, exactly zero, held to the k norm scale's magnitude).
    Returns ``(forward case or None, backward case)``."""
    import torch
    import torch.nn.functional as F

    from aicity_action_tpu_torch.ops import flash_attention as fa
    from aicity_action_tpu_torch.ops.layer_norm import layer_norm_plain

    bf = torch.bfloat16
    scale = d ** -0.5
    flags = (True, True, True)
    q, k, v = (_normal(gen, (G, d, n), 1.0, bf).transpose(1, 2)
               for n in (Lq, Lk, Lk))
    lnp = [t for _ in range(3) for t in (
        _normal(gen, (d,), 0.1, bf) + 1, _normal(gen, (d,), 0.1, bf))]
    args = (q, k, v, *lnp, scale, 1e-5, flags, True)
    flops = 4 * G * Lq * Lk * d
    io = 2 * (2 * G * Lq * d + 2 * G * Lk * d + 6 * d)

    def ln_plain(*a):
        return fa.flash_attention_ln_plain(*a, scale, 1e-5, flags, True)

    def plain_lse():
        qf, kf, vf = (t.float() for t in (q, k, v))
        p = [t.float() for t in lnp]
        qn, kn, vn = (layer_norm_plain(t, p[2 * i], p[2 * i + 1], 1e-5)
                      for i, t in enumerate((qf, kf, vf)))
        o, lse = fa.flash_attention_lse_plain(qn, kn, vn, scale)
        return o + qn, lse, o

    def library(q, k, v, lnp):
        qn, kn, vn = (F.layer_norm(t, (d,), lnp[2 * i], lnp[2 * i + 1],
                                   1e-5) for i, t in enumerate((q, k, v)))
        return _sdpa(qn, kn, vn) + qn

    fwd = None
    if with_fwd:
        fwd = _check_case(
            "flash_attention_ln_lse",
            lambda: fa.flash_attention_ln_lse(*args), plain_lse,
            lambda: library(q, k, v, lnp), flops=flops,
            # out, lse and the attention output before the residual
            nbytes=io + 4 * G * Lq + 2 * G * Lq * d,
            peak=PEAK_BF16, iters=3)
        fwd["shape"] = shape
        _mark_fwd(fwd, G, Lq, Lk, d)
    out, lse, oa = fa.flash_attention_ln_lse(*args)
    dout = _normal(gen, (G, Lq, d), 1.0, bf)
    bwd = _check_case(
        "flash_attention_ln_bwd",
        lambda: fa.flash_attention_ln_bwd(q, k, v, *lnp, oa, lse, dout,
                                          scale, 1e-5, flags, True),
        lambda: _plain_grads(ln_plain, (q, k, v, *lnp), (dout,)),
        lambda: _library_grads(lambda *a: library(*a[:3], a[3:]),
                               (q, k, v, *lnp), (dout,)),
        flops=10 * G * Lq * Lk * d,
        nbytes=(2 * (4 * G * Lq * d + 4 * G * Lk * d + 12 * d)
                + 4 * G * Lq),
        peak=PEAK_BF16, iters=2, zero_grads={6: 5})
    bwd["shape"] = shape
    del q, k, v, out, lse, oa, dout, args
    torch.cuda.empty_cache()
    return fwd, bwd


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
    for blk, h, Lq, Lk in ATTN_TRAIN_SHAPES:
        G = TRAIN_BATCH * h
        f, b = _fused_ln_train_cases(
            gen, f"448 {_attn_shape(blk, G, Lq, Lk)} d-major", G, Lq, Lk, d,
            blk in ATTN_FWD_BLOCKS)
        fwd += [f] if f else []
        bwd.append(b)
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


def derived_counts(model, train: bool, remat: int | None = None,
                   blocks=None, final_norm: bool = True) -> dict:
    """Kernel launches of one forward (``train`` False) or one train step
    that the model's blocks and the fused-LN switch imply. Per block: one
    LN+qkv; the fused-LN attention where the block fuses (conv pools, no
    cls token, the switch on), else one attention (the padded one with a
    cls token) and one LN per conv-pooled q / k / v, the channel-major
    instance (``pool_norm_rows``, also counted on its own) where its length
    is a multiple of 8 and there is no cls token, else the rows instance;
    one LN+MLP, or, where the MLP changes the channels, a separate norm2;
    an MoE block's expert bank none. The final norm once. Training adds
    each backward once and, under activation checkpointing, runs every
    block's forward kernels twice (the recompute; ``remat`` sets that
    multiple). ``blocks`` (indices) and ``final_norm`` count a part of the
    model."""
    from aicity_action_tpu_torch.models.mvit import (_fuse_attn_ln_enabled,
                                                    pool_norm_call_shapes)
    from aicity_action_tpu_torch.ops.layer_norm import channel_major_applies

    n = dict.fromkeys(ALL_FNS + tuple(_instance_counters()), 0)
    if remat is None:
        remat = 2 if train and model.spec.act_checkpoint else 1
    pool_norms = {}  # block -> the lengths of its pool norms
    for i, _, _, _, _, L in pool_norm_call_shapes(model.spec, 1):
        pool_norms.setdefault(i, []).append(L)

    def add(fwd, bwd, times=1):
        n[fwd] += remat * times
        if train:
            n[bwd] += times

    for i, blk in enumerate(model.blocks):
        if blocks is not None and i not in blocks:
            continue
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
            for L in pool_norms.get(i, []):
                add("fused_layer_norm", "fused_layer_norm_bwd")
                if channel_major_applies(L, attn.has_cls, attn.head_dim):
                    add("pool_norm_rows", "pool_norm_rows_bwd")
        if blk.moe:  # the expert bank: plain products, no kernel row
            continue
        if blk.proj is None:
            add("fused_ln_mlp", "fused_ln_mlp_bwd")
        else:
            add("fused_layer_norm", "fused_layer_norm_bwd")
    if model.norm is not None and final_norm:
        n["fused_layer_norm"] += 1
        n["fused_layer_norm_bwd"] += int(train)
    return n


def _instance_counters():
    """The channel-major LayerNorm instance's own counts, beside rows 12
    and 13's (which count both instances)."""
    from aicity_action_tpu_torch.ops import layer_norm as ln

    return {"pool_norm_rows": ln.pool_norm_rows,
            "pool_norm_rows_bwd": ln.pool_norm_rows_bwd}


def reset_counts() -> None:
    for fn in (*_wrappers().values(), *_instance_counters().values()):
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in
            {**_wrappers(), **_instance_counters()}.items()}


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


# ------------------------------------------------------------ AI City chain

# the chain's views: AI City file names (aicity_inf_graph parses the user
# and the performance from them), 960x540 at 30 fps; the first longer than
# run_temporal_inf's 512-frame chunk, so that windows straddle a chunk
# boundary on the decoded path
CHAIN_USER = "24026"
CHAIN_VIEWS = (("Dashboard", 576), ("Rear_view", 100),
               ("Right_side_window", 90))
CHAIN_SIZE = (960, 540)
CHAIN_DECODE_CHUNK, CHAIN_DECODE_THREADS = 48, 4
# the CLI's config: the AI City recipe (the model's, from the seed)
CHAIN_CFG = os.path.join(_REPO, "configs", "AICITY_MVITV2_B_16x4_448.yaml")


def _view_frames(num_frames: int, seed: int):
    """I420 u8 frames ``[h*3//2, w]`` of ``CHAIN_SIZE``: moving gradients
    plus noise, made with numpy from ``seed``, one at a time."""
    w, h = CHAIN_SIZE
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.int32)
    cy, cx = yy[: h // 2, : w // 2], xx[: h // 2, : w // 2]
    frame = np.empty((h * 3 // 2, w), np.uint8)
    for i in range(num_frames):
        frame[:h] = (xx + 2 * yy + 7 * i) % 219 + 16 + rng.integers(
            0, 4, (h, w))
        u = (cx * 3 + 5 * i) % 128 + 64
        v = (cy * 3 + 11 * i) % 128 + 64
        frame[h:].reshape(2, h // 2, w // 2)[:] = np.stack([u, v])
        yield frame


def _decode_checks(path: str, num_frames: int, kw: dict) -> np.ndarray:
    """The view decoded by ``stream_chunks`` and by
    ``stream_chunks_parallel``, equal bit for bit through the EOF padding;
    returns the decoded frames ``[num_frames, s*3//2, s]``."""
    from aicity_action_tpu_torch.pipeline.window_inference import (
        WindowDataset)

    F = CHAIN_DECODE_CHUNK
    n = -(-num_frames // F) + 1  # every chunk and one past EOF
    seq_gen = WindowDataset(path, **kw).stream_chunks(F)
    par_gen = WindowDataset(path, **kw).stream_chunks_parallel(
        F, CHAIN_DECODE_THREADS)
    seq = [next(seq_gen) for _ in range(n)]
    par = [next(par_gen) for _ in range(n)]
    seq_gen.close()
    par_gen.close()
    for c, (a, b) in enumerate(zip(seq, par)):
        if not np.array_equal(a, b):
            _fail(f"{os.path.basename(path)}: parallel decode differs from "
                  f"the sequential one in chunk {c}")
    frames = np.concatenate(seq)
    if not (frames[num_frames:] == frames[num_frames - 1]).all():
        _fail(f"{os.path.basename(path)}: EOF padding is not the last frame")
    return frames[:num_frames]


def aicity_chain_checks(card: str, cfg, model):
    """README's AI City chain through the port's CLIs, in process, with the
    448 model from seed 0: three views written as YUV4MPEG2 files; each
    decoded sequentially and by parallel decoders (equal bit for bit);
    ``run_temporal_inf`` (4 decoders) with the kernel launches set to 0
    just before and held to ``derived_counts`` times its forwards just
    after; its pickles against ``WindowScorer.score_video`` and three
    windows of the long view against a direct forward of their decoded
    frames; the exact-RGB path against the loader path on a short view;
    ``aicity_inf_graph`` (thresholds, F1) and ``aicity_inf`` (the
    submission) against ``postprocess`` called directly. The decoder is
    the one a user's run gets: the port's FFmpeg library where
    ``pkg-config`` finds FFmpeg's development files, else cv2."""
    from aicity_action_tpu_torch import native
    from aicity_action_tpu_torch.data.decoder import write_y4m

    if native.ffmpeg_available():
        decoder, pkg = "vdec", " ".join(native.ffmpeg_flags())
    else:
        # asking for the library itself raises with pkg-config's words
        decoder = "cv2"
        try:
            native.load()
        except RuntimeError as e:
            if "libavcodec" not in str(e):
                raise
            pkg = str(e).splitlines()[-1]
        else:
            _fail("the FFmpeg library loaded although pkg-config finds no "
                  "FFmpeg")
    print(f"# AI City chain: pkg-config of FFmpeg: {pkg!r}; decoder "
          f"{decoder}")
    s = cfg.DATA.TEST_CROP_SIZE
    kw = dict(frame_length=cfg.DATA.NUM_FRAMES, frame_stride=4,
              proposal_stride=16, frame_size=s,
              target_fps=cfg.DATA.TARGET_FPS, mean=cfg.DATA.MEAN,
              std=cfg.DATA.STD)
    stems = [f"{view}_user_id_{CHAIN_USER}_NoAudio_0"
             for view, _ in CHAIN_VIEWS]
    with tempfile.TemporaryDirectory() as d:
        t = time.time()
        for i, ((_, n), stem) in enumerate(zip(CHAIN_VIEWS, stems)):
            write_y4m(os.path.join(d, f"{stem}.y4m"),
                      _view_frames(n, SEED + 10 + i))
        write_s = time.time() - t
        stats = _chain(d, stems, kw, cfg, model, decoder, s)
        stats["two_ranks"] = two_rank_video_checks(
            card, d, stems[0], stats.pop("argv"),
            os.path.join(d, "pkl", f"{stems[0]}.pkl"), model)
    stats["write_s"] = write_s
    run = stats["run_temporal_inf"]
    parts = "; ".join(
        f"{v}: {r['windows']} windows in {r['seconds']:.2f} s = "
        f"{r['windows'] / r['seconds']:.2f} windows/s (decode "
        f"{r['timers']['decode']:.2f}, upload {r['timers']['upload']:.2f}, "
        f"dispatch {r['timers']['dispatch']:.2f}, drain "
        f"{r['timers']['drain']:.2f} s; {r['timers']['calls']} calls, "
        f"{r['timers']['chunks']} chunks)" for v, r in run.items())
    print(f"# AI City chain ({card}; decoder {decoder}, "
          f"{CHAIN_DECODE_THREADS} decoders): {parts}; F1 "
          f"{stats['f1']:.6f}, {stats['submission_rows']} submission rows; "
          f"pickles vs score_video max error "
          f"{stats['pickle_vs_score_video_err']:.2e} (tol 1e-6), direct "
          f"{stats['direct_err']:.2e} (tol 1e-2), exact-RGB vs loader "
          f"{stats['cv2_paths_err']:.2e} (tol 1e-2); views "
          f"written in {stats['write_s']:.2f} s, decode checks "
          f"{stats['decode_check_s']:.2f} s; launches {stats['launches']}")
    return stats


def _chain(d, stems, kw, cfg, model, decoder, s):
    import torch

    from aicity_action_tpu_torch.data.decoder import sample_indices
    from aicity_action_tpu_torch.pipeline import postprocess as pp
    from aicity_action_tpu_torch.pipeline.window_inference import (
        WindowDataset, WindowScorer, i420_to_rgb, load_window_predictions)
    from aicity_action_tpu_torch.tools import (aicity_inf, aicity_inf_graph,
                                               run_temporal_inf)

    dev = next(model.parameters()).device
    frames = {}
    t = time.time()
    for (_, n), stem in zip(CHAIN_VIEWS, stems):
        frames[stem] = _decode_checks(os.path.join(d, f"{stem}.y4m"), n, kw)
    decode_s = time.time() - t

    lst = os.path.join(d, "videos.txt")
    with open(lst, "w") as f:
        f.write("".join(f"{stem}.y4m\n" for stem in stems))
    pkl = os.path.join(d, "pkl")
    reset_counts()
    torch.cuda.synchronize()
    argv = ["--cfg", CHAIN_CFG, "--video_lst", lst, "--video_path", d, "--out_dir", pkl,
            "--frame_length", str(kw["frame_length"]), "--frame_size",
            str(s), "--batch_size", str(BATCH), "--num_workers",
            str(CHAIN_DECODE_THREADS), "--device", dev.type, "RNG_SEED",
            str(SEED)]
    run = run_temporal_inf.main(argv + ["NUM_GPUS", "1"])
    torch.cuda.synchronize()
    launches = read_counts()
    forwards = sum(r["timers"]["calls"] for r in run.values())
    want = {k: v * forwards
            for k, v in derived_counts(model, train=False).items()}
    if launches != want:
        _fail(f"AI City chain: launches {launches} != derived_counts x "
              f"{forwards} forwards {want}")
    for name, r in run.items():
        if r["timers"]["decoder"] != decoder:
            _fail(f"{name} decoded with {r['timers']['decoder']}, not "
                  f"{decoder}")

    # the pickles against the scorer on the same datasets
    scorer = WindowScorer(model, batch_size=BATCH,
                          num_workers=CHAIN_DECODE_THREADS)
    preds = {}
    pickle_err = 0.0
    for stem in stems:
        preds[stem] = load_window_predictions(
            os.path.join(pkl, f"{stem}.pkl"))
        ds = WindowDataset(os.path.join(d, f"{stem}.y4m"), **kw)
        ref = scorer.score_video(ds)
        if [p[:2] for p in preds[stem]] != [p[:2] for p in ref] or \
                [p[:2] for p in ref] != ds.windows:
            _fail(f"{stem}: the CLI's windows differ from score_video's")
        scores = np.stack([p[2] for p in preds[stem]])
        if not np.isfinite(scores).all() or scores.shape[1] != \
                cfg.MODEL.NUM_CLASSES:
            _fail(f"{stem}: non-finite or mis-shaped window scores")
        pickle_err = max(pickle_err, float(np.abs(
            scores - np.stack([p[2] for p in ref])).max()))
    if not pickle_err <= 1e-6:
        _fail(f"the CLI's pickles differ from score_video: {pickle_err}")

    # the cv2 paths on the shortest view: exact-RGB chunks (BGR, the swap
    # in the patch-embed weight) and the loader's spawned workers see the
    # same full-chroma frames, so their scores agree to bf16 noise
    ds = WindowDataset(os.path.join(d, f"{stems[-1]}.y4m"), **kw)
    rgb = WindowScorer(model, batch_size=BATCH, num_workers=2,
                       chroma420=False).score_video(ds)
    loader = WindowScorer(model, batch_size=BATCH, num_workers=2)
    by_loader = loader.score_video(ds, streaming=False)
    if [p[:2] for p in rgb] != ds.windows or \
            [p[:2] for p in by_loader] != ds.windows:
        _fail("the cv2 paths' windows differ from the dataset's")
    cv2_err = float(np.abs(np.stack([p[2] for p in rgb])
                           - np.stack([p[2] for p in by_loader])).max())
    if not cv2_err <= 1e-2 or loader.last_timers is not None:
        _fail(f"the exact-RGB path differs from the loader path: {cv2_err}")

    # the long view's first window, one across the 512-frame chunk
    # boundary, and its last, against a direct forward of their frames
    long_stem, n = stems[0], CHAIN_VIEWS[0][1]
    plans = WindowDataset(os.path.join(d, f"{long_stem}.y4m"), **kw).plans()
    F = scorer.chunk_frames
    check = [0, next(i for i, (_, _, idx) in enumerate(plans)
                     if idx[0] // F != idx[-1] // F), len(plans) - 1]
    idx = np.stack([sample_indices(plans[i][0], plans[i][1],
                                   kw["frame_length"], n) for i in check])
    mean = torch.tensor(cfg.DATA.MEAN, device=dev)
    std = torch.tensor(cfg.DATA.STD, device=dev)
    yuv = torch.from_numpy(frames[long_stem][idx]).to(dev)
    with torch.no_grad():
        direct = model((i420_to_rgb(yuv, s) / 255.0 - mean) / std)
    direct_err = float(np.abs(direct.float().cpu().numpy() - np.stack(
        [preds[long_stem][i][2] for i in check])).max())
    if not direct_err <= 1e-2:
        _fail(f"windows {check} differ from a direct forward: {direct_err}")

    # thresholds and F1 on a labeled split of the three views: classes 1-3,
    # each in every view (seconds)
    segments = [(stem, CHAIN_USER, t0, t1, c)
                for c, (t0, t1) in ((1, (0, 1)), (2, (1, 2)), (3, (1, 3)))
                for stem in stems]
    anno = os.path.join(d, "val.csv")
    with open(anno, "w") as f:
        f.write("".join(f"{stem}.{user}.{t0}.{t1}.MP4 {c}\n"
                        for stem, user, t0, t1, c in segments))
    thr_file = os.path.join(d, "thresholds.txt")
    graph = aicity_inf_graph.main([anno, pkl, "--thres_file", thr_file])
    classes = list(range(1, cfg.MODEL.NUM_CLASSES))
    per_frame = {stem: pp.aggregate_predictions(
        preds[stem], np.mean, cfg.MODEL.NUM_CLASSES) for stem in stems}
    anno_data = {f"{CHAIN_USER}_0": segments}
    thr = pp.derive_thresholds(anno_data, per_frame, classes)
    with open(thr_file) as f:
        written = dict(line.split() for line in f if line.strip())
    if written != {str(c): f"{thr[c]:.5f}" for c in classes}:
        _fail("aicity_inf_graph's thresholds differ from postprocess's")
    f1 = pp.compute_f1(anno_data, classes,
                       {k: pp.chunks_for_video(v, thr)
                        for k, v in per_frame.items()}, return_pr=True)
    if (graph["f1"], graph["precision"], graph["recall"]) != f1:
        _fail(f"aicity_inf_graph's F1 {graph} differs from postprocess's {f1}")

    # the submission of the video that joins the three views
    vid_csv = os.path.join(d, "vid.csv")
    with open(vid_csv, "w") as f:
        f.write("video_id,view1,view2,view3\n1," + ",".join(stems) + "\n")
    sub = os.path.join(d, "submission.txt")
    rows = aicity_inf.main([pkl, thr_file, vid_csv, sub])
    with open(sub) as f:
        lines = [line.split() for line in f]
    if len(lines) != len(rows) or not all(
            len(p) == 4 and p[0] == "1" and int(p[1]) in classes
            and np.isfinite([float(p[2]), float(p[3])]).all()
            for p in lines):
        _fail(f"malformed submission rows: {lines}")
    return {"run_temporal_inf": run, "decode_check_s": decode_s,
            "argv": argv, "launches": launches, "forwards": forwards,
            "pickle_vs_score_video_err": pickle_err,
            "direct_err": direct_err, "cv2_paths_err": cv2_err,
            "f1": graph["f1"],
            "submission_rows": len(rows)}


# ------------------------------------------------------ two ranks, one video

# both ranks on the one card (NCCL refuses two ranks on one device; gloo
# gathers the host-side windows)
VIDEO_RANK_DEVICE = "cuda:0"


def _video_rank_worker(rank: int, argv: list, out: str,
                       device: str) -> None:
    """One of the phase's two ranks (spawned): ``run_temporal_inf.run`` on
    ``device`` with its launch counts set to 0 just before and written,
    with its stats and peak memory, to ``out/rank{rank}.json`` just
    after."""
    import torch

    sys.path.insert(0, _REPO)
    from aicity_action_tpu_torch.tools import run_temporal_inf

    dev = torch.device(device)
    reset_counts()  # a fresh process: its peak memory is the run's
    stats = run_temporal_inf.run(rank, argv)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"launches": read_counts(), "stats": stats,
                   "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0}, f)


def two_rank_video_checks(card: str, d: str, stem: str, argv: list,
                          one_pkl: str, model) -> dict:
    """One video's windows over two gloo ranks on the one card: the
    ``run_temporal_inf`` call of the AI City chain (``argv``, the same
    weights from the seed) on its long view alone at ``NUM_GPUS 2``, each
    rank scoring the windows that start in its share of the chunks
    (``WindowScorer._score_ranks``). Rank 0's pickle must hold the one-rank
    pickle's windows in order with every score within 1e-2; each rank must
    have windows; the two ranks' launches must sum to ``derived_counts``
    times their forwards."""
    import torch.multiprocessing as mp

    from aicity_action_tpu_torch.pipeline.window_inference import (
        load_window_predictions)

    lst = os.path.join(d, "one_video.txt")
    with open(lst, "w") as f:
        f.write(f"{stem}.y4m\n")
    out_dir = os.path.join(d, "pkl_two_ranks")
    argv = list(argv)
    for flag, value in (("--video_lst", lst), ("--out_dir", out_dir),
                        ("--device", VIDEO_RANK_DEVICE)):
        argv[argv.index(flag) + 1] = value
    argv += ["NUM_GPUS", "2", "DIST_BACKEND", "gloo", "INIT_METHOD",
             f"tcp://localhost:{_free_port()}"]
    t = time.perf_counter()
    mp.spawn(_video_rank_worker, args=(argv, d, VIDEO_RANK_DEVICE),
             nprocs=2, join=True)
    wall = time.perf_counter() - t
    ranks = []
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    timers = ranks[0]["stats"][f"{stem}.y4m"]["timers"]["ranks"]
    forwards = sum(r["calls"] for r in timers)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    want = {k: v * forwards
            for k, v in derived_counts(model, train=False).items()}
    if launches != want:
        _fail(f"two ranks, one video: launches {launches} != "
              f"derived_counts x {forwards} forwards {want}")
    if not all(r["windows"] > 0 for r in timers):
        _fail(f"two ranks, one video: a rank scored no window: {timers}")
    if os.listdir(out_dir) != [f"{stem}.pkl"]:
        _fail(f"two ranks, one video: {os.listdir(out_dir)} written")
    got = load_window_predictions(os.path.join(out_dir, f"{stem}.pkl"))
    want_preds = load_window_predictions(one_pkl)
    if [p[:2] for p in got] != [p[:2] for p in want_preds]:
        _fail("two ranks, one video: the windows differ from one rank's")
    err = float(np.abs(np.stack([p[2] for p in got])
                       - np.stack([p[2] for p in want_preds])).max())
    if not err <= 1e-2:
        _fail(f"two ranks, one video: scores off by {err} (tol 1e-2)")
    split = "; ".join(
        f"rank {i}: {r['windows']} windows, {r['chunks']} chunks, decode "
        f"{r['decode']:.2f}, upload {r['upload']:.2f}, dispatch "
        f"{r['dispatch']:.2f}, drain {r['drain']:.2f} s, peak memory "
        f"{ranks[i]['peak_mem_bytes'] / 2 ** 30:.2f} GiB"
        for i, r in enumerate(timers))
    seconds = [rk["stats"][f"{stem}.y4m"]["seconds"] for rk in ranks]
    print(f"# two ranks, one video ({card}): {len(got)} windows of the "
          f"{stem} view over 2 gloo ranks on one card, "
          f"{len(got) / max(seconds):.2f} windows/s (the slower rank's "
          f"{max(seconds):.2f} s, spawn included {wall:.1f} s); {split}; "
          f"max |score - one rank's| {err:.2e} (tol 1e-2); launches "
          f"{launches} = derived_counts x {forwards} forwards")
    return {"windows": len(got), "seconds": seconds, "spawn_s": wall,
            "windows_per_s": len(got) / max(seconds), "ranks": timers,
            "score_err": err, "launches": launches, "forwards": forwards}


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


def train_grad_check(cfg, label: str, f32_truth: bool = False,
                     draws: int = 1):
    """One batch-1 step's loss and gradients (no update) with the kernels
    against the same model in its plain reference mode: the same params,
    mixup draw and DropPath / dropout masks (``_hold_grads``' gates; under
    ``f32_truth`` each leaf against the plain reference in f32, its bf16
    floor the largest of ``draws``). The model
    is built afresh from the seed: the train steps before would leave
    params that depend on the order of the convolutions' backward sums, and
    so a check that moves from run to run."""
    import torch

    from aicity_action_tpu_torch.data.mixup import build_mixup_from_cfg
    from aicity_action_tpu_torch.engine.steps import step_generators
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.models.losses import soft_cross_entropy
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

    return _hold_grads(label, model, run, x, gen, f32_truth=f32_truth,
                       draws=draws)


def _hold_grads(label: str, model, run, x, gen, f32_truth=False,
                batch: int = 1, draws: int = 1) -> dict:
    """``run(x) -> (loss, grad norm, leaf gradients)`` of one step at
    ``batch`` (1 unless stated)
    with the kernels against the plain reference mode (the gates of
    ``train_grad_check``); frees the model. Each leaf is held within 5e-2
    relative L2 of the plain reference's gradient, or within what the
    plain reference itself moves it by for one bf16 rounding of its input;
    under ``f32_truth`` instead within 5e-2 of the plain reference's
    gradient computed in f32, or within ``F32_TRUTH_FACTOR`` times the bf16
    plain reference's own distance from it, that distance the largest of
    ``draws`` bf16 plain runs' (the input as given, then moved by bf16
    roundings: ``two_rank_checks``' rule, where one draw is as noisy as
    the error it bounds); the loss and grad norm gates stay against the
    bf16 plain reference."""
    import torch

    from aicity_action_tpu_torch.ops import kernels

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    loss_k, norm_k, grads_k = run()
    with kernels.plain_reference():
        loss_p, norm_p, grads_p = run()
        if f32_truth:
            moved = [run(x * (1 + 2.0 ** -9 * torch.randn(
                x.shape, generator=gen, device=x.device)))[2]
                for _ in range(draws - 1)]
            model.compute_dtype = torch.float32
            _, _, grads_t = run()
        else:
            # the noise floor: the plain reference itself with its input
            # moved by a bf16 rounding (relative 2^-9); the early blocks'
            # conv-pool and qkv gradients move by 3-5e-2 under it
            noise = torch.randn(x.shape, generator=gen, device=x.device)
            _, _, grads_t = run(x * (1 + 2.0 ** -9 * noise))
    torch.cuda.synchronize()
    names = [n for n, _ in model.named_parameters()]
    # the k pool norms' biases have an exact gradient of zero (softmax
    # ignores one shift of every key), so both paths hold rounding noise
    # there: those leaves are held to a norm below 1e-3 of the global one
    zero = [i for i, n in enumerate(names) if n.endswith("attn.norm_k.bias")]
    zero_max = max(max(grads_k[i].norm().item(), grads_p[i].norm().item())
                   for i in zero) if zero else 0.0
    leaves = [i for i in range(len(names)) if i not in zero]
    vs_plain = {i: rel(grads_k[i], grads_p[i]) for i in leaves}
    if f32_truth:
        err = {i: rel(grads_k[i], grads_t[i]) for i in leaves}
        floors = {i: max(rel(g[i], grads_t[i]) for g in [grads_p, *moved])
                  for i in leaves}
        bounds = {i: max(5e-2, F32_TRUTH_FACTOR * floors[i]) for i in err}
        rule = (f"5e-2 of the f32 plain reference, or {F32_TRUTH_FACTOR} x "
                f"the bf16 plain reference's own distance from it"
                + (f", the largest of {draws} draws" if draws > 1 else ""))
        del moved
    else:
        err = vs_plain
        floors = {i: rel(grads_t[i], grads_p[i]) for i in leaves}
        bounds = {i: max(5e-2, floors[i]) for i in err}
        rule = ("5e-2, or what the plain reference moves it by for a bf16 "
                "rounding of its input")
    worst = max(err, key=lambda i: err[i] / bounds[i])
    median = float(np.median(list(err.values())))
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    norm_err = abs(norm_k - norm_p) / norm_p
    print(f"# {label} batch-{batch} train step, kernels vs plain reference: "
          f"loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_err:.2e}, tol 1e-2), "
          f"grad_norm {norm_k:.6f} vs {norm_p:.6f} (rel {norm_err:.2e}, "
          f"tol 2e-2), worst leaf {names[worst]} relative L2 "
          f"{err[worst]:.3e} (tol {bounds[worst]:.3e}: {rule}, "
          f"{floors[worst]:.3e}), median {median:.3e}"
          + (f"; against the bf16 plain reference median "
             f"{float(np.median(list(vs_plain.values()))):.3e}, "
             f"{sum(v > 5e-2 for v in vs_plain.values())} of "
             f"{len(vs_plain)} leaves past 5e-2; the bf16 plain "
             f"reference's own distance from f32: median "
             f"{float(np.median(list(floors.values()))):.3e}"
             if f32_truth else "")
          + f"; {len(zero)} zero-gradient leaves (k-norm biases) at most "
          f"{zero_max:.3e} (tol {1e-3 * norm_p:.3e})")
    if not (loss_err <= 1e-2 and norm_err <= 2e-2
            and err[worst] <= bounds[worst] and zero_max <= 1e-3 * norm_p):
        _fail(f"{label}: the train step's kernel gradients disagree with "
              "the plain reference")
    del model, grads_k, grads_p, grads_t
    torch.cuda.empty_cache()
    return {"loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
            "worst_leaf": names[worst], "worst_leaf_rel_l2": err[worst],
            "worst_leaf_bound": bounds[worst],
            "worst_leaf_floor": floors[worst],
            "median_leaf_rel_l2": median,
            "median_leaf_vs_plain": float(np.median(
                list(vs_plain.values()))),
            "zero_grad_leaves_max_norm": zero_max}


# -------------------------------------------------------------- train loop

# the train loop's run: the AI City recipe's YAML (equal to
# config.mvitv2_b_16x4_448_cfg(), tests/test_torch_isolation.py) through
# tools/run_net.py on 8 views of CHAIN_SIZE at 30 fps, 72-100 frames long
LOOP_CFG = os.path.join(_REPO, "configs", "AICITY_MVITV2_B_16x4_448.yaml")
LOOP_DEVICE = "cuda"
LOOP_VIEWS = 8
LOOP_INPUT = ("torch.bfloat16", "cuda")  # what reaches the model
DDP_BACKEND = "nccl"


def _loop_opts(d: str, max_epoch: int, out: str = "out") -> list:
    return ["NUM_GPUS", "1", "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "8",
            "TRAIN.EVAL_PERIOD", "1", "TRAIN.CHECKPOINT_PERIOD", "1",
            "TEST.NUM_ENSEMBLE_VIEWS", "2", "DATA_LOADER.NUM_WORKERS", "4",
            "DATA.PATH_TO_DATA_DIR", d, "DATA.PATH_PREFIX", d,
            "OUTPUT_DIR", os.path.join(d, out), "RNG_SEED", str(SEED),
            "TEST.SAVE_RESULTS_PATH", os.path.join(d, f"{out}_results.pkl"),
            "LOG_CFG", "False", "SOLVER.MAX_EPOCH", str(max_epoch)]


def write_loop_views(d: str) -> float:
    """The loop's 8 YUV4MPEG2 views of CHAIN_SIZE (72-100 frames) and its
    train / val / test csvs over them, in ``d``; returns the seconds."""
    from aicity_action_tpu_torch.data.decoder import write_y4m

    t = time.time()
    for i in range(LOOP_VIEWS):
        write_y4m(os.path.join(d, f"v{i}.y4m"),
                  _view_frames(72 + 4 * i, SEED + 30 + i))
    for split in ("train", "val", "test"):
        with open(os.path.join(d, f"{split}.csv"), "w") as f:
            f.writelines(f"v{i}.y4m {i % 18}\n" for i in range(LOOP_VIEWS))
    return time.time() - t


@contextlib.contextmanager
def model_inputs_seen():
    """The ``(dtype, device type)`` of each MViT forward's input, while
    open."""
    import torch

    from aicity_action_tpu_torch.models.mvit import MViT

    seen = []
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda m, args: seen.append((str(args[0].dtype), args[0].device.type))
        if isinstance(m, MViT) else None)
    try:
        yield seen
    finally:
        hook.remove()


def feed_check() -> None:
    """The host-to-card feed's batches, copied on its own stream from
    pinned bf16 buffers behind a spin on that stream, equal a plain copy
    when the compute stream takes them: the compute stream waited for the
    copies. A first round fills the pinned and device caches, whose
    allocations (``cudaHostAlloc``) would synchronize the card and hide a
    missing wait."""
    import torch

    from aicity_action_tpu_torch.parallel.prefetch import DeviceFeed

    feed = DeviceFeed(torch.device("cuda"), torch.bfloat16)
    rng = np.random.default_rng(SEED + 5)
    xs = [rng.standard_normal((4, 16, 96, 96, 3), dtype=np.float32)
          for _ in range(3)]
    for spin in (False, True):
        torch.cuda.synchronize()
        if spin:
            with torch.cuda.stream(feed.stream):
                # NaN in the block the first copy will reuse, then ~0.2 s
                # that holds the copies back: a take that did not wait
                # reads NaN
                torch.full(xs[0].shape, float("nan"), dtype=torch.bfloat16,
                           device="cuda")
                torch.cuda._sleep(100 * SPIN_CYCLES)
        staged = [feed.put({"inputs": [x], "labels": np.arange(4)})
                  for x in xs]
        for i, (x, st) in enumerate(zip(xs, staged)):
            dev = feed.take(st)
            want = torch.from_numpy(x).to(torch.bfloat16).cuda()
            if not (torch.equal(dev["inputs"][0], want)
                    and dev["labels"].tolist() == [0, 1, 2, 3]):
                _fail(f"the feed's batch {i} differs from a plain copy")
        del staged, dev


def train_loop_checks(card: str, d: str, write_s: float):
    """The training loop of the main path through ``tools/run_net.py``'s
    ``main``, in process: MViT-v2-B 16x4 @448 (seed-0 weights, batch 4,
    bf16) on the 8 written YUV4MPEG2 views of ``d`` (train, val and test
    csvs over them). ``SOLVER.MAX_EPOCH 1`` (2 steps, an eval, a
    checkpoint, the two-view test), then ``MAX_EPOCH 2``, which must
    auto-resume at epoch 1 and train only epoch 2, after
    :func:`feed_check`. Each run's kernel launches (set to 0 just before,
    read just after) are held to ``derived_counts`` times the steps and
    forwards that its loaders gave; every loss finite; both checkpoints on
    disk with the step count carried over; every input to the model bf16 on
    the card; the test's stats and results pickle."""
    import pickle

    import torch

    from aicity_action_tpu_torch.tools import run_net

    feed_check()
    runs = []
    with model_inputs_seen() as seen:
        torch.cuda.reset_peak_memory_stats()
        for max_epoch in (1, 2):
            seen.clear()
            reset_counts()
            t = time.perf_counter()
            out = run_net.main(["--cfg", LOOP_CFG, "--device", LOOP_DEVICE,
                                *_loop_opts(d, max_epoch)])
            torch.cuda.synchronize()
            runs.append(_check_loop_run(out, read_counts(), list(seen),
                                        max_epoch, d))
            runs[-1]["seconds"] = time.perf_counter() - t
            del out
        peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(d, "out_results.pkl"), "rb") as f:
        video_preds, video_labels = pickle.load(f)
    if video_preds.shape != (LOOP_VIEWS, 18) or \
            not np.isfinite(video_preds).all() or \
            list(video_labels) != [i % 18 for i in range(LOOP_VIEWS)]:
        _fail("train loop: the test's results pickle is wrong")
    torch.cuda.empty_cache()
    resumed = runs[1]["epochs"][0]
    steps = len(resumed["iter_s"])
    data_share = sum(resumed["data_s"]) / resumed["wall_s"]
    ms = resumed["wall_s"] * 1e3 / steps
    test = runs[1]["test"]
    val = resumed["val"]
    print(f"# v2 train loop ({card}): the feed's staged batches equal a "
          f"plain copy; run_net MAX_EPOCH 1 then 2 "
          f"(auto-resumed at epoch 1), batch 4, 8 views of 960x540; "
          f"epoch 2: {ms:.2f} ms/step over its {steps} steps with data "
          f"(epoch wall {resumed['wall_s']:.3f} s incl. the loader's start "
          f"and the drain), step walls {resumed['iter_s']}, data waits "
          f"{resumed['data_s']}, data-wait share {data_share:.3f}; eval "
          f"(val) {val['clips'] / val['seconds']:.2f} clips/s, test "
          f"{test['clips'] / test['seconds']:.2f} clips/s (2 views a video, "
          f"batch 8, data included); peak memory {peak / 2 ** 30:.2f} GiB; "
          f"checkpoint save {runs[0]['epochs'][0]['ckpt_s']:.2f} / "
          f"{resumed['ckpt_s']:.2f} s; losses "
          f"{[e['losses'] for r in runs for e in r['epochs']]}; views "
          f"written in {write_s:.2f} s; runs {runs[0]['seconds']:.1f} / "
          f"{runs[1]['seconds']:.1f} s; launches {runs[0]['launches']} / "
          f"{runs[1]['launches']}")
    return {"ms_per_step": ms, "data_wait_share": data_share,
            "val_clips_per_s": val["clips"] / val["seconds"],
            "test_clips_per_s": test["clips"] / test["seconds"],
            "peak_mem_bytes": peak,
            "ckpt_s": [r["epochs"][0]["ckpt_s"] for r in runs],
            "runs": runs,
            "launches": {k: runs[0]["launches"][k] + runs[1]["launches"][k]
                         for k in runs[0]["launches"]}}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def ddp_loop_checks(card: str, d: str, loop_stats: dict):
    """The same loop under ``DistributedDataParallel``: ``run_net --ddp``
    joins a one-rank NCCL group and trains epoch 1 under ``zero_adamw``
    (ZeRO-1); a second call, with no group, resumes that checkpoint at
    epoch 1 under plain ``adamw`` and trains epoch 2. Held as the loop
    above (launches equal to ``derived_counts``, finite losses, the epoch
    and step carried over, bf16 inputs on the card)."""
    import torch

    from aicity_action_tpu_torch.tools import run_net

    init = f"tcp://localhost:{_free_port()}"
    runs = []
    with model_inputs_seen() as seen:
        for max_epoch, flags, method in ((1, ["--ddp"], "zero_adamw"),
                                         (2, [], "adamw")):
            seen.clear()
            reset_counts()
            t = time.perf_counter()
            out = run_net.main([
                "--cfg", LOOP_CFG, "--device", LOOP_DEVICE, *flags,
                *_loop_opts(d, max_epoch, "ddp_out"), "DIST_BACKEND",
                DDP_BACKEND, "INIT_METHOD", init,
                "SOLVER.OPTIMIZING_METHOD", method])
            torch.cuda.synchronize()
            zero = out["train"].optimizer.zero
            if zero != (method == "zero_adamw"):
                _fail(f"DDP loop: {method} ran with ZeRO {zero}")
            runs.append(_check_loop_run(out, read_counts(), list(seen),
                                        max_epoch, d, "ddp_out"))
            runs[-1]["seconds"] = time.perf_counter() - t
            del out
    if torch.distributed.is_initialized():
        _fail("DDP loop: run_net left its process group up")
    torch.cuda.empty_cache()
    ddp, plain = runs[0]["epochs"][0], runs[1]["epochs"][0]
    steps = len(ddp["iter_s"])
    ms = ddp["wall_s"] * 1e3 / steps
    ms_plain = plain["wall_s"] * 1e3 / steps
    print(f"# v2 train loop, DDP ({card}): run_net --ddp (one-rank NCCL "
          f"group, DistributedDataParallel, zero_adamw) epoch 1, then a "
          f"call without a group resuming its checkpoint under adamw for "
          f"epoch 2; batch 4 on the loop's 8 views; DDP epoch "
          f"{ms:.2f} ms/step with data over {steps} steps (step walls "
          f"{ddp['iter_s']}, data waits {ddp['data_s']}), the resumed "
          f"plain epoch {ms_plain:.2f} ms/step, the loop phase's plain "
          f"epoch 2 {loop_stats['ms_per_step']:.2f} ms/step; losses "
          f"{[e['losses'] for r in runs for e in r['epochs']]}; runs "
          f"{runs[0]['seconds']:.1f} / {runs[1]['seconds']:.1f} s; launches "
          f"{runs[0]['launches']} / {runs[1]['launches']}")
    return {"ms_per_step": ms, "resumed_ms_per_step": ms_plain,
            "loop_ms_per_step": loop_stats["ms_per_step"],
            "losses": [e["losses"] for r in runs for e in r["epochs"]],
            "launches": {k: runs[0]["launches"][k] + runs[1]["launches"][k]
                         for k in runs[0]["launches"]}}


def _check_loop_run(out: dict, launches: dict, seen: list, max_epoch: int,
                    d: str, out_dir: str = "out") -> dict:
    """One run_net call of :func:`train_loop_checks`, held to what it must
    have done; returns its record."""
    import torch

    run, test = out["train"], out["test"]
    start = max_epoch - 1
    if run is None or test is None or run.start_epoch != start or \
            [e["epoch"] for e in run.epochs] != [max_epoch]:
        _fail(f"train loop MAX_EPOCH {max_epoch}: expected to start at "
              f"epoch {start} and train epoch {max_epoch}")
    # the loaders' arithmetic: 8 views, train batch 4 (drop_last), val
    # batch 4, test 2 views a video at batch 8
    steps, val_fwd, test_fwd = LOOP_VIEWS // 4, -(-LOOP_VIEWS // 4), \
        -(-2 * LOOP_VIEWS // 8)
    epoch = run.epochs[0]
    losses = epoch["losses"]
    if len(losses) != steps or not all(np.isfinite(losses)):
        _fail(f"train loop MAX_EPOCH {max_epoch}: losses {losses}")
    if epoch["val"]["forwards"] != val_fwd or test["forwards"] != test_fwd:
        _fail(f"train loop MAX_EPOCH {max_epoch}: eval forwards "
              f"{epoch['val']['forwards']} / {test['forwards']}")
    if run.optimizer.count != steps * max_epoch:
        _fail(f"train loop: the step count {run.optimizer.count} did not "
              f"carry over ({steps * max_epoch} expected)")
    for e in range(1, max_epoch + 1):
        path = os.path.join(d, out_dir, "checkpoints",
                            f"checkpoint_epoch_{e:05d}")
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if ckpt["epoch"] != e or ckpt["step"] != steps * e:
            _fail(f"train loop: {path} holds epoch {ckpt['epoch']}, step "
                  f"{ckpt['step']}")
    want = {k: steps * v for k, v in
            derived_counts(run.model, train=True).items()}
    for k, v in derived_counts(run.model, train=False).items():
        want[k] += (val_fwd + test_fwd) * v
    if launches != want:
        _fail(f"train loop MAX_EPOCH {max_epoch}: launches {launches} != "
              f"{want}")
    if seen != [LOOP_INPUT] * (steps + val_fwd + test_fwd):
        _fail(f"train loop MAX_EPOCH {max_epoch}: the model's inputs were "
              f"{sorted(set(seen))} in {len(seen)} forwards, not "
              f"{LOOP_INPUT}")
    if "top1_acc" not in test or "top5_acc" not in test:
        _fail(f"train loop: test stats {test}")
    return {"epochs": run.epochs, "test": test, "launches": launches}


# ------------------------------------------------------- two ranks, one card

# two gloo ranks on cuda:0 (NCCL refuses two ranks on one device; gloo
# reduces and broadcasts CUDA tensors, all that DDP and the BatchNorm
# reduction take), each with half of a global batch of TWO_RANK_BATCH
TWO_RANK_BATCH = 4
TWO_RANK_STEPS = 2
TWO_RANK_DEVICE = "cuda"  # the one card both ranks share
TWO_RANK_BACKEND = "gloo"
# PERF.md section 2's train-step gates: loss, gradient norm, each leaf's
# gradient (relative L2)
GATE_LOSS, GATE_NORM, GATE_LEAF = 1e-2, 2e-2, 5e-2
# one-process bf16 runs whose largest distance from the f32 run is bf16's
# own: at SlowFast's 8-channel BatchNorms one draw ranged up to 0.57 and a
# rank's distance up to 1.46 x one draw (PERF.md section 6, PR 15)
TWO_RANK_DRAWS = 3


def _two_rank_cfgs() -> list:
    """``(label, cfg)`` of the phase: the AI City 448 model (its dropout
    and DropPath on, SGD) and SlowFast R50 8x8."""
    from aicity_action_tpu_torch.config import (mvitv2_b_16x4_448_cfg,
                                                slowfast_8x8_r50_cfg)

    out = []
    for label, make in (("MViT-v2-B 16x4 @448", mvitv2_b_16x4_448_cfg),
                        ("SlowFast R50 8x8", slowfast_8x8_r50_cfg)):
        cfg = make()
        cfg.SOLVER.OPTIMIZING_METHOD = "sgd"
        cfg.RNG_SEED = SEED
        out.append((label, cfg))
    return out


def _two_rank_batch(cfg, rows: slice, dev):
    """``rows`` of the phase's global batch, made with numpy from the seed
    (every process makes the same), on ``dev``."""
    import torch

    rng = np.random.default_rng(SEED + 70)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    fast = rng.standard_normal((TWO_RANK_BATCH, T, S, S, 3),
                               dtype=np.float32)
    if cfg.MODEL.ARCH == "slowfast":
        idx = np.linspace(0, T - 1, T // cfg.SLOWFAST.ALPHA).astype(np.int64)
        xs = [fast[:, idx], fast]
    else:
        xs = [fast]
    labels = np.arange(TWO_RANK_BATCH) % cfg.MODEL.NUM_CLASSES
    xs = [torch.from_numpy(np.ascontiguousarray(x[rows])).to(dev)
          for x in xs]
    return (xs if len(xs) > 1 else xs[0],
            torch.from_numpy(labels[rows]).to(dev))


def _sgd_steps(cfg, rows: slice, dev, perturb: int = 0) -> dict:
    """``TWO_RANK_STEPS`` train steps of ``cfg``'s seed-0 model on ``rows``
    of the global batch (under DDP where a group is up): each step's loss,
    gradient norm and gradients (DDP's average, clipped as the optimizer
    took them), and each BatchNorm statistic after, on the host in f32.
    ``perturb`` (a seed) moves the inputs by a bf16 rounding (relative
    2^-9 noise): another draw of bf16's noise. (Gradients, not the updates: at the
    recipes' warm-up LRs an O(1) scale moves by a few f32 ulps a step.)"""
    import torch

    from aicity_action_tpu_torch.engine.steps import make_train_step
    from aicity_action_tpu_torch.engine.train_loop import wrap_ddp
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.solver.optimizer import construct_optimizer

    model = build_model(cfg, device=dev, seed=SEED)
    opt = construct_optimizer(cfg, model, 100)
    step = make_train_step(wrap_ddp(model, dev), opt,
                           cfg.MODEL.LOSS_FUNC,
                           num_classes=cfg.MODEL.NUM_CLASSES, seed=SEED)
    inputs, labels = _two_rank_batch(cfg, rows, dev)
    if perturb:
        gen = torch.Generator(device=dev).manual_seed(SEED + 70 + perturb)
        inputs = [x * (1 + 2.0 ** -9 * torch.randn(
            x.shape, generator=gen, device=dev))
            for x in (inputs if isinstance(inputs, list) else [inputs])]
        inputs = inputs if len(inputs) > 1 else inputs[0]
    out = {"loss": [], "grad_norm": []}
    for i in range(TWO_RANK_STEPS):
        metrics, _ = step({"inputs": inputs, "labels": labels})
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        out[f"grad {i + 1}"] = {n: p.grad.detach().float().cpu().clone()
                                for n, p in model.named_parameters()}
    out["stats"] = {n: b.float().cpu().clone()
                    for n, b in model.named_buffers() if "running" in n}
    return out


def _two_rank_worker(rank: int, init: str, d: str, cases: list,
                     device: str, backend: str) -> None:
    """One of the phase's two ranks (spawned): both on ``device``."""
    import torch

    sys.path.insert(0, _REPO)
    from aicity_action_tpu_torch.parallel import mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
    cfg0 = cases[0][1].clone()
    cfg0.NUM_GPUS, cfg0.DIST_BACKEND, cfg0.INIT_METHOD = 2, backend, init
    mesh.init_distributed(cfg0, rank, device=dev)
    for i, (_, cfg) in enumerate(cases):
        b = TWO_RANK_BATCH // 2
        res = _sgd_steps(cfg, slice(rank * b, (rank + 1) * b), dev)
        torch.save(res, os.path.join(d, f"case{i}_rank{rank}.pt"))
        del res
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    mesh.destroy()


def _rel(a, b) -> float:
    import torch

    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def _leaf_rel(got: dict, want: dict, n: str) -> float:
    """Relative L2 of a leaf's gradient; the k pool norm's bias (zero in
    exact arithmetic, softmax ignoring a shift of every key) against its
    scale's."""
    if n.endswith("attn.norm_k.bias"):
        scale = want[n[:-len("bias")] + "weight"]
        return _rel(got[n] - want[n] + scale, scale)
    return _rel(got[n], want[n])


def two_rank_checks(card: str) -> dict:
    """Two gloo ranks on the one card, each with 2 of a 4-clip global
    batch, take two SGD steps of MViT-v2-B @448 and of SlowFast R50 8x8
    under DDP (SlowFast's BatchNorms reduce their statistics over the two
    ranks); one-process runs on the whole batch in this call are the
    references. Gates (``PERF.md`` section 2): each step's loss (1e-2) and
    gradient norm (2e-2) against the one-process bf16 run; each step's
    gradient of every leaf, and each BatchNorm statistic after, against
    the one-process run in f32 (the plain reference mode at
    ``TPU.COMPUTE_DTYPE float32``): within 5e-2 relative L2, or within
    ``F32_TRUTH_FACTOR`` times bf16's own distance from it
    (``det_grad_check``'s rule), that distance the largest of
    TWO_RANK_DRAWS one-process bf16 runs' (the batch as given, then moved
    by bf16 roundings): one draw of it is as noisy as the error it bounds
    at SlowFast's 8-channel BatchNorms (the k pool norms' biases, whose
    gradient is zero by softmax's shift invariance, against their
    scales'). A
    control: what a rank computes when the cross-rank all-reduces are
    skipped (one process on rank 0's 2 clips: its own gradient and
    BatchNorm statistics) must fail that gate."""
    import torch
    import torch.multiprocessing as mp

    from aicity_action_tpu_torch.ops import kernels

    cases = _two_rank_cfgs()
    dev = torch.device(TWO_RANK_DEVICE)
    refs, draws, truths, skips = [], [], [], []
    full = slice(0, TWO_RANK_BATCH)
    for label, cfg in cases:
        refs.append(_sgd_steps(cfg, full, dev))
        draws.append([_sgd_steps(cfg, full, dev, perturb=i)
                      for i in range(1, TWO_RANK_DRAWS)])
        f32 = cfg.clone()
        f32.TPU.COMPUTE_DTYPE = "float32"
        with kernels.plain_reference():
            truths.append(_sgd_steps(f32, full, dev))
        skips.append(_sgd_steps(cfg, slice(0, TWO_RANK_BATCH // 2), dev))
        torch.cuda.empty_cache()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_two_rank_worker,
                 args=(f"tcp://localhost:{_free_port()}", d, cases,
                       TWO_RANK_DEVICE, TWO_RANK_BACKEND), nprocs=2,
                 join=True)
        ranks = [[torch.load(os.path.join(d, f"case{i}_rank{r}.pt"))
                  for r in range(2)] for i in range(len(refs))]
    spawn_s = time.perf_counter() - t

    report = {}
    for (label, _), ref, draw, truth, skip, got in zip(
            cases, refs, draws, truths, skips, ranks):
        worst = {"loss": 0.0, "grad_norm": 0.0}
        leaf = {}  # name -> (error, bound, floor, the control's error)
        for kind in [f"grad {i + 1}" for i in range(TWO_RANK_STEPS)] + [
                "stats"]:
            for n in truth[kind]:
                fl = max(_leaf_rel(r[kind], truth[kind], n)
                         for r in [ref, *draw])
                err = max(_leaf_rel(g[kind], truth[kind], n) for g in got)
                leaf[f"{kind} {n}"] = (
                    err, max(GATE_LEAF, F32_TRUTH_FACTOR * fl), fl,
                    _leaf_rel(skip[kind], truth[kind], n))
        for g in got:
            for key, gate in (("loss", GATE_LOSS), ("grad_norm", GATE_NORM)):
                for a, b in zip(g[key], ref[key]):
                    err = abs(a - b) / abs(b)
                    worst[key] = max(worst[key], err)
                    if not (np.isfinite(a) and err <= gate):
                        _fail(f"two ranks, {label}: {key} {g[key]} vs one "
                              f"process {ref[key]}")
        name = max(leaf, key=lambda k: leaf[k][0] / leaf[k][1])
        err, bound, fl, _ = leaf[name]
        if not err <= bound:
            _fail(f"two ranks, {label}: {name} off by {err:.3e} relative "
                  f"L2 from f32 (bound {bound:.3e}; the one-process bf16 "
                  f"runs' distance {fl:.3e})")
        rejected = [k for k, (_, b, _, e) in leaf.items() if e > b]
        control = max(leaf, key=lambda k: leaf[k][3] / leaf[k][1])
        if not rejected:
            _fail(f"two ranks, {label}: the gate passes the run without "
                  f"the cross-rank all-reduce")
        over = sum(e > GATE_LEAF for e, _, _, _ in leaf.values())
        median = float(np.median([e for e, _, _, _ in leaf.values()]))
        report[label] = {"losses": ref["loss"], "grad_norms":
                         ref["grad_norm"], "worst": worst,
                         "worst_leaf": name, "worst_leaf_rel_l2": err,
                         "worst_leaf_bound": bound, "worst_leaf_floor": fl,
                         "median_leaf": median, "leaves_over_5e-2": over,
                         "bn_stats": len(ref["stats"]),
                         "control_rejected_leaves": len(rejected),
                         "control_worst_leaf": control,
                         "control_worst_ratio": leaf[control][3]
                         / leaf[control][1]}
        print(f"# two ranks, one card ({card}): {label}, gloo, 2 x 2 clips "
              f"vs one process on 4, {TWO_RANK_STEPS} SGD steps: losses "
              f"{ref['loss']}, grad norms {ref['grad_norm']}; worst "
              f"relative loss {worst['loss']:.3e} (gate {GATE_LOSS}), grad "
              f"norm {worst['grad_norm']:.3e} ({GATE_NORM}); against the "
              f"f32 one-process run: worst leaf {name} {err:.3e} relative "
              f"L2 (bound {bound:.3e}: {GATE_LEAF}, or {F32_TRUTH_FACTOR} x "
              f"bf16's own distance, the largest of {TWO_RANK_DRAWS} "
              f"one-process bf16 runs', {fl:.3e}), median "
              f"{median:.3e}, {over} of {len(leaf)} leaves and BN "
              f"statistics past {GATE_LEAF} within their bounds; the "
              f"control without the cross-rank all-reduce fails the gate "
              f"at {len(rejected)} of {len(leaf)} (worst {control}, "
              f"{leaf[control][3]:.3e} against {leaf[control][1]:.3e}); "
              f"spawned ranks {spawn_s:.1f} s")
    return report


# --------------------------------------------------------- SlowFast R50 8x8

SF_BATCH = 8
SF_VIEW_FRAMES = 160
SF_CFG = "slowfast_8x8_r50_cfg"  # the config factory of the phase
SF_DEVICE = "cuda"
# PERF.md section 2's forward gates: the head's input (relative L2) and
# the scores (max abs) of the card's bf16 forward against the plain f32
# forward on the CPU
GATE_HEAD_IN, GATE_SCORES = 5e-2, 1e-2


def _sf_inputs(cfg, batch: int, seed: int, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    fast = torch.randn((batch, T, S, S, 3), generator=gen, device=device)
    idx = torch.linspace(0, T - 1, T // cfg.SLOWFAST.ALPHA).long()
    return [fast[:, idx.to(device)].contiguous(), fast]


def slowfast_checks(card: str) -> dict:
    """SlowFast R50 8x8 at full width (``slowfast_8x8_r50_cfg()``, seed-0
    weights, bf16): a batch-8 eval forward (timed in both conv layouts), a
    batch-8 SGD train step with BatchNorm updates, precise BN over 2
    batches, ``run_temporal_inf`` scoring one written YUV4MPEG2 view through
    the window-streaming path with the model's statistics, and a batch-1
    forward against the plain f32 forward on the CPU. None of the 13
    kernel rows may launch."""
    import torch

    from aicity_action_tpu_torch import config as tconfig
    from aicity_action_tpu_torch.data.decoder import write_y4m
    from aicity_action_tpu_torch.engine.precise_bn import \
        calculate_and_update_precise_bn
    from aicity_action_tpu_torch.engine.steps import (make_eval_step,
                                                      make_train_step)
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.pipeline.window_inference import (
        WindowDataset, load_window_predictions)
    from aicity_action_tpu_torch.solver.optimizer import construct_optimizer
    from aicity_action_tpu_torch.tools import run_temporal_inf

    cfg = getattr(tconfig, SF_CFG)()
    cfg.RNG_SEED = SEED
    dev = torch.device(SF_DEVICE)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev, seed=SEED)
    xs = _sf_inputs(cfg, SF_BATCH, SEED + 80, dev)
    eval_step = make_eval_step(model)
    layouts = {}
    default = model.channels_last
    for cl in (not default, default):
        model.set_channels_last(cl)
        layouts["channels_last_3d" if cl else "ncdhw"] = time_ms(
            lambda: eval_step({"inputs": xs}), 5)
    fwd_ms = layouts["channels_last_3d" if default else "ncdhw"]
    scores = eval_step({"inputs": xs})
    if scores.shape != (SF_BATCH, cfg.MODEL.NUM_CLASSES) or \
            not torch.isfinite(scores).all():
        _fail("SlowFast: eval scores are not finite [8, 400]")

    opt = construct_optimizer(cfg, model, 100)
    step = make_train_step(model, opt, cfg.MODEL.LOSS_FUNC,
                           num_classes=cfg.MODEL.NUM_CLASSES, seed=SEED)
    labels = torch.arange(SF_BATCH, device=dev) % cfg.MODEL.NUM_CLASSES
    stats0 = {n: b.clone() for n, b in model.named_buffers()
              if "running" in n}
    losses, walls = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics, _ = step({"inputs": xs, "labels": labels})
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        losses.append(float(metrics["loss"]))
    if not all(np.isfinite(losses)):
        _fail(f"SlowFast: train losses {losses}")
    moved = sum(not torch.equal(b, stats0[n]) for n, b in
                model.named_buffers() if "running" in n)
    if moved != len(stats0):
        _fail(f"SlowFast: {len(stats0) - moved} BatchNorm statistics did "
              f"not move in training")
    step_ms = float(np.median(walls[1:]))
    peak = torch.cuda.max_memory_allocated()

    before = {n: b.clone() for n, b in model.named_buffers()
              if "running" in n}
    n_bn = calculate_and_update_precise_bn(
        model, iter([_sf_inputs(cfg, SF_BATCH, SEED + 81 + i, dev)
                     for i in range(3)]), num_batches=2)
    after = dict(model.named_buffers())
    if n_bn != 2 or any(not torch.isfinite(after[n]).all() or
                        torch.equal(after[n], b) for n, b in before.items()):
        _fail("SlowFast: precise BN did not replace every statistic")

    # the batch-1 forward against the plain f32 forward on the CPU, same
    # weights and statistics
    model.eval()
    x1 = [x[:1] for x in xs]
    heads = []
    hook = model.head.register_forward_pre_hook(
        lambda m, args: heads.append([t.float().cpu() for t in args[0]]))
    with torch.no_grad():
        card_scores = model(x1).float().cpu()
        cpu_cfg = cfg.clone()
        cpu_cfg.TPU.COMPUTE_DTYPE = "float32"
        cpu_model = build_model(cpu_cfg, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        hook2 = cpu_model.head.register_forward_pre_hook(
            lambda m, args: heads.append([t.cpu() for t in args[0]]))
        cpu_scores = cpu_model([x.cpu() for x in x1])
        hook2.remove()
    hook.remove()
    head_err = max(_rel(a, b) for a, b in zip(heads[0], heads[1]))
    score_err = float((card_scores - cpu_scores).abs().max())
    if not (head_err <= GATE_HEAD_IN and score_err <= GATE_SCORES):
        _fail(f"SlowFast: the card's forward is off the CPU's: head input "
              f"{head_err:.3e}, scores {score_err:.3e}")

    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "slowfast.pyth")
        torch.save({"model_state": {k: v.cpu() for k, v in
                                    model.state_dict().items()},
                    "epoch": 1}, ckpt)
        cfg_path = os.path.join(d, "slowfast.yaml")
        with open(cfg_path, "w") as f:
            f.write(cfg.dump())
        write_y4m(os.path.join(d, "view.y4m"),
                  _view_frames(SF_VIEW_FRAMES, SEED + 90))
        with open(os.path.join(d, "videos.txt"), "w") as f:
            f.write("view.y4m\n")
        kw = dict(frame_length=cfg.DATA.NUM_FRAMES,
                  frame_stride=cfg.DATA.SAMPLING_RATE, proposal_stride=16,
                  frame_size=cfg.DATA.TRAIN_CROP_SIZE)
        t = time.perf_counter()
        run = run_temporal_inf.main([
            "--cfg", cfg_path, "--video_lst", os.path.join(d, "videos.txt"),
            "--video_path", d, "--out_dir", os.path.join(d, "pkl"),
            "--checkpoint", ckpt, "--frame_length",
            str(kw["frame_length"]), "--frame_stride",
            str(kw["frame_stride"]), "--proposal_stride", "16",
            "--frame_size", str(kw["frame_size"]), "--batch_size",
            str(SF_BATCH), "--device", dev.type, "NUM_GPUS", "1"])
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t
        preds = load_window_predictions(os.path.join(d, "pkl", "view.pkl"))
        ds = WindowDataset(os.path.join(d, "view.y4m"), arch_pathways=2,
                           slowfast_alpha=cfg.SLOWFAST.ALPHA, **kw)
    win = np.stack([p[2] for p in preds])
    if [p[:2] for p in preds] != ds.windows or \
            run["view.y4m"]["timers"] is not None or \
            win.shape[1] != cfg.MODEL.NUM_CLASSES or \
            not np.isfinite(win).all() or \
            not np.allclose(win.sum(1), 1.0, atol=1e-3):
        _fail("SlowFast: run_temporal_inf's windows or scores are wrong")
    launches = read_counts()
    if any(launches.values()):
        _fail(f"SlowFast: kernel rows launched: {launches}")
    clips_s = SF_BATCH / (fwd_ms / 1e3)
    wins_s = len(preds) / score_s
    print(f"# SlowFast R50 8x8 ({card}): seed-0 weights, bf16; batch-8 eval "
          f"forward {fwd_ms:.2f} ms ({clips_s:.1f} clips/s; by layout "
          f"{layouts}); train step (SGD, BN updates) "
          f"{step_ms:.2f} ms/step (walls {[round(w, 2) for w in walls]}, "
          f"losses {losses}); peak memory {peak / 2 ** 30:.2f} GiB; "
          f"precise BN over {n_bn} batches; batch-1 card vs CPU f32: head "
          f"input {head_err:.3e} (gate {GATE_HEAD_IN}), scores "
          f"{score_err:.3e} ({GATE_SCORES}); run_temporal_inf (streaming "
          f"path) {len(preds)} windows of a {SF_VIEW_FRAMES}-frame view in "
          f"{score_s:.2f} s with the CLI's model build and checkpoint load "
          f"({wins_s:.2f} windows/s); kernel rows launched: 0")
    del model, cpu_model
    torch.cuda.empty_cache()
    return {"fwd_ms": fwd_ms, "clips_per_s": clips_s, "layouts_ms": layouts,
            "step_ms": step_ms, "peak_mem_bytes": peak,
            "head_in_err": head_err, "score_err": score_err,
            "windows": len(preds), "windows_per_s": wins_s,
            "launches": launches}


# ------------------------------------------------------------- detection

DET_BOXES = 28  # Ava.MAX_BOXES: the static slab of a clip's boxes
DET_CFG = "mvitv2_b_16x4_448_det_cfg"  # the config factory of the phase
DET_DEVICE = "cuda"
DET_VIEW_FRAMES = 160  # 10 windows of 64 frames every 16
AVA_CFG = "slowfast_32x2_r50_ava_cfg"  # the config factory of the phase
AVA_DEVICE = "cuda"
# the written AVA tree: two videos, keyframes at seconds 902-905 (frames
# 60-150 at 30 fps) with 32 x 2 frames around each, 400x300 JPEGs
AVA_SECS = {"ava_vid0": [902, 903, 904, 905],
            "ava_vid1": [902, 903, 904, 905]}
AVA_FRAMES, AVA_HW, AVA_BATCH = 190, (300, 400), 4
# the detection step's batch-1 leaves against the f32 plain reference: the
# RoI head's max over bins routes each channel's gradient to one bin, and a
# bf16 rounding anywhere moves that choice, so the kernel and plain bf16
# gradients differ by their own bf16 noise (on an H100, seed 0: 88 of 334
# leaves past 5e-2, median 1.38e-2, against 1.29e-2 for the plain path with
# its input rounded). Held instead: each leaf's distance from the f32
# gradient within 5e-2, or this factor times the plain bf16 path's own
# distance from it (measured: at most 1.12 times)
F32_TRUTH_FACTOR = 1.5


def det_boxes(batch: int, size: int, gen, device):
    """``[batch, DET_BOXES, 4]`` random boxes inside a ``size`` crop, the
    last third of each clip's slab all zero (padded rows), and the mask."""
    import torch

    real = DET_BOXES * 2 // 3
    xy = torch.rand((batch, DET_BOXES, 2), generator=gen,
                    device=device) * size * 0.6
    wh = 16 + torch.rand((batch, DET_BOXES, 2), generator=gen,
                         device=device) * size * 0.4
    mask = torch.zeros((batch, DET_BOXES), device=device)
    mask[:, :real] = 1.0
    boxes = torch.cat([xy, (xy + wh).clamp(max=size)], -1)
    return boxes * mask[..., None], mask


def detection_checks(card: str) -> dict:
    """MViT-v2-B 16x4 @448 with the RoI head (``mvitv2_b_16x4_448_det_cfg()``,
    seed-0 weights, bf16): a batch-8 eval forward on 28-box slabs through
    ``make_detection_eval_step`` and a batch-4 detection train step
    (activation checkpointing, AdamW), each with its launches held to
    ``derived_counts`` (the RoI head launches none) and a batch-1 check
    against the plain reference; then ``run_temporal_inf`` with the config
    on a written view (one whole-frame box a window), its launches held to
    ``derived_counts`` times its forwards and its first window to a direct
    forward."""
    import torch

    from aicity_action_tpu_torch import config as tconfig
    from aicity_action_tpu_torch.data.decoder import write_y4m
    from aicity_action_tpu_torch.engine.detection import (
        make_detection_eval_step, make_detection_train_step)
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.ops import kernels
    from aicity_action_tpu_torch.pipeline.window_inference import (
        WindowDataset, load_window_predictions)
    from aicity_action_tpu_torch.solver.optimizer import construct_optimizer
    from aicity_action_tpu_torch.tools import run_temporal_inf

    label = "MViT-v2-B 16x4 @448 detection"
    cfg = getattr(tconfig, DET_CFG)()
    C = cfg.MODEL.NUM_CLASSES
    dev = torch.device(DET_DEVICE)
    model = build_model(cfg, device=dev, seed=SEED)
    eval_step = make_detection_eval_step(model)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    x = _normal(gen, (BATCH, T, S, S, 3), device=dev)
    boxes, _ = det_boxes(BATCH, S, gen, dev)
    batch = {"inputs": x, "boxes": boxes}
    reset_counts()
    out = eval_step(batch)
    torch.cuda.synchronize()
    counts = read_counts()
    want = derived_counts(model, train=False)
    if counts != want:
        _fail(f"{label}: launches per forward {counts} != {want}")
    if out.shape != (BATCH * DET_BOXES, C) or not torch.isfinite(out).all() \
            or not ((out >= 0) & (out <= 1)).all():
        _fail(f"{label}: batch-8 scores not sigmoid [{BATCH * DET_BOXES}, "
              f"{C}]")
    ms = time_ms(lambda: eval_step(batch), iters=5)

    maps = []
    hook = model.head.register_forward_pre_hook(
        lambda m, args: maps.append(args[0][0].float()))
    b1 = {"inputs": x[:1], "boxes": boxes[:1]}
    out_k = eval_step(b1)
    with kernels.plain_reference():
        out_p = eval_step(b1)
    hook.remove()
    torch.cuda.synchronize()
    feat_err = _rel(maps[0], maps[1])
    score_err = (out_k - out_p).abs().max().item()
    print(f"# {label} forward, batch {BATCH} bf16, {DET_BOXES}-box slabs: "
          f"{ms:.2f} ms, {BATCH / ms * 1e3:.2f} clips/s ({card}); launches "
          f"{counts}; batch 1 vs plain reference: head-input map relative "
          f"L2 {feat_err:.3e} (tol 5e-2), max |score error| {score_err:.3e} "
          f"(tol 1e-2)")
    if not (feat_err <= 5e-2 and score_err <= 1e-2):
        _fail(f"{label}: the kernel path disagrees with its plain reference")
    stats = {"forward_ms": ms, "clips_per_s": BATCH / ms * 1e3,
             "feat_rel_err": feat_err, "score_err": score_err,
             "launches_per_forward": counts}

    opt = construct_optimizer(cfg, model, steps_per_epoch=100)
    step = make_detection_train_step(model, opt, cfg.MODEL.LOSS_FUNC,
                                     seed=SEED)
    tboxes, tmask = det_boxes(TRAIN_BATCH, S, gen, dev)
    tbatch = {"inputs": _normal(gen, (TRAIN_BATCH, T, S, S, 3), device=dev),
              "boxes": tboxes, "box_mask": tmask,
              "labels": (torch.rand((TRAIN_BATCH, DET_BOXES, C),
                                    generator=gen, device=dev)
                         < 0.1).float()}
    losses = [float(step(tbatch)[0]["loss"]) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    metrics = [step(tbatch)[0] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / TRAIN_STEPS
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses += [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    want = {k: TRAIN_STEPS * v
            for k, v in derived_counts(model, train=True).items()}
    print(f"# {label} train step, batch {TRAIN_BATCH} (activation "
          f"checkpointing, AdamW, masked BCE): {step_ms:.2f} ms/step, "
          f"{TRAIN_BATCH / step_ms * 1e3:.3f} clips/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({card}); losses {losses}; grad norms "
          f"{norms}; launches over {TRAIN_STEPS} steps {launches}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        _fail(f"{label}: non-finite loss or gradient norm")
    if launches != want:
        _fail(f"{label}: train-step launches {launches} != {want}")
    stats["train"] = {"ms_per_step": step_ms, "peak_mem_bytes": peak,
                      "losses": losses, "grad_norms": norms,
                      "launches": launches}
    del step, opt, tbatch
    torch.cuda.empty_cache()
    stats["train"]["grad_check"] = det_grad_check(cfg, label)

    model.eval()
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "det.pyth")
        torch.save({"model_state": {k: v.cpu() for k, v in
                                    model.state_dict().items()},
                    "epoch": 1}, ckpt)
        cfg_path = os.path.join(d, "det.yaml")
        with open(cfg_path, "w") as f:
            f.write(cfg.dump())
        view = os.path.join(d, "view.y4m")
        write_y4m(view, _view_frames(DET_VIEW_FRAMES, SEED + 61))
        with open(os.path.join(d, "videos.txt"), "w") as f:
            f.write("view.y4m\n")
        kw = dict(frame_length=T, frame_stride=cfg.DATA.SAMPLING_RATE,
                  proposal_stride=16, frame_size=S)
        reset_counts()
        t = time.perf_counter()
        run = run_temporal_inf.main([
            "--cfg", cfg_path, "--video_lst", os.path.join(d, "videos.txt"),
            "--video_path", d, "--out_dir", os.path.join(d, "pkl"),
            "--checkpoint", ckpt, "--frame_length", str(T),
            "--frame_stride", str(kw["frame_stride"]), "--proposal_stride",
            "16", "--frame_size", str(S), "--batch_size", str(BATCH),
            "--device", dev.type, "NUM_GPUS", "1"])
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t
        counts = read_counts()
        preds = load_window_predictions(os.path.join(d, "pkl", "view.pkl"))
        ds = WindowDataset(view, **kw)
        clip = torch.from_numpy(ds[0][0][0][None]).to(dev)
        with torch.no_grad():
            direct = model(clip, torch.tensor([[0.0, 0.0, 0.0, S, S]],
                                              device=dev))[0]
    forwards = -(-len(preds) // BATCH)
    want = {k: v * forwards
            for k, v in derived_counts(model, train=False).items()}
    win = np.stack([p[2] for p in preds])
    first_err = float(np.abs(win[0] - direct.float().cpu().numpy()).max())
    print(f"# {label} run_temporal_inf (window-streaming path, one "
          f"whole-frame box a window): {len(preds)} windows of a "
          f"{DET_VIEW_FRAMES}-frame {CHAIN_SIZE[0]}x{CHAIN_SIZE[1]} view in "
          f"{score_s:.2f} s with the CLI's model build and checkpoint load "
          f"({len(preds) / score_s:.2f} windows/s, {card}); {forwards} "
          f"forwards, launches {counts}; window 0 against a direct forward "
          f"{first_err:.3e} (tol 1e-2)")
    if [p[:2] for p in preds] != ds.windows or \
            run["view.y4m"]["timers"] is not None or \
            win.shape[1] != C or not np.isfinite(win).all() or \
            not ((win >= 0) & (win <= 1)).all() or not first_err <= 1e-2:
        _fail(f"{label}: run_temporal_inf's windows or scores are wrong")
    if counts != want:
        _fail(f"{label}: run_temporal_inf launches {counts} != {want}")
    stats["scorer"] = {"windows": len(preds), "seconds": score_s,
                       "forwards": forwards, "launches": counts,
                       "window0_err": first_err}
    del model
    torch.cuda.empty_cache()
    return stats


def det_grad_check(cfg, label: str) -> dict:
    """One batch-1 detection step's masked BCE and gradients (no update)
    with the kernels against the plain reference (``_hold_grads``' gates,
    the leaves against the plain reference in f32: ``F32_TRUTH_FACTOR``),
    from a model built afresh from the seed."""
    import torch

    from aicity_action_tpu_torch.engine.detection import flatten_boxes
    from aicity_action_tpu_torch.engine.steps import step_generators
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.models.losses import bce
    from aicity_action_tpu_torch.solver.optimizer import global_norm

    dev = torch.device(DET_DEVICE)
    model = build_model(cfg, device=dev, seed=SEED)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    gen = torch.Generator(device=dev).manual_seed(SEED + 62)
    x = _normal(gen, (1, T, S, S, 3), device=dev)
    boxes, mask = det_boxes(1, S, gen, dev)
    boxes5, mask = flatten_boxes(boxes), mask.reshape(-1)
    labels = (torch.rand((DET_BOXES, cfg.MODEL.NUM_CLASSES), generator=gen,
                         device=dev) < 0.1).float()
    model.train()
    params = [p for p in model.parameters()]

    def run(xx=x):
        g, _ = step_generators(SEED, 7, dev)
        model.zero_grad(set_to_none=True)
        per_box = bce(model(xx, boxes5, generator=g), labels,
                      reduction="none")
        loss = (per_box * mask).sum() / mask.sum().clamp_min(1.0)
        loss.backward()
        return (loss.item(), global_norm(params).item(),
                [p.grad.detach().float().clone() for p in params])

    return _hold_grads(label, model, run, x, gen, f32_truth=True)


def ava_checks(card: str) -> dict:
    """SlowFast R50 32x2 on AVA (``slowfast_32x2_r50_ava_cfg()``, seed-0
    weights, bf16) through ``tools/run_net.py`` on a written AVA tree
    (``data/ava.py:write_synthetic_ava``: 8 keyframes): one epoch of 2
    steps at batch 4, its eval's frame mAP, a checkpoint, and the test's
    mAP, both finite; no kernel row may launch."""
    import torch

    from aicity_action_tpu_torch import config as tconfig
    from aicity_action_tpu_torch.data.ava import write_synthetic_ava
    from aicity_action_tpu_torch.tools import run_net

    label = "SlowFast R50 32x2 AVA"
    cfg = getattr(tconfig, AVA_CFG)()
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        tree = write_synthetic_ava(os.path.join(d, "ava"), secs=AVA_SECS,
                                   num_frames=AVA_FRAMES, hw=AVA_HW,
                                   seed=SEED)
        write_s = time.perf_counter() - t
        for k, v in tree.items():
            setattr(cfg.AVA, k, v)
        cfg.NUM_GPUS = 1
        cfg.RNG_SEED = SEED
        cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = AVA_BATCH
        cfg.TRAIN.EVAL_PERIOD = cfg.TRAIN.CHECKPOINT_PERIOD = 1
        cfg.SOLVER.MAX_EPOCH = 1
        cfg.DATA_LOADER.NUM_WORKERS = 4
        cfg.OUTPUT_DIR = os.path.join(d, "out")
        cfg_path = os.path.join(d, "ava.yaml")
        with open(cfg_path, "w") as f:
            f.write(cfg.dump())
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        out = run_net.main(["--cfg", cfg_path, "--device", AVA_DEVICE])
        torch.cuda.synchronize()
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        saved = os.path.exists(os.path.join(
            cfg.OUTPUT_DIR, "checkpoints", "checkpoint_epoch_00001"))
    (epoch,) = out["train"].epochs
    val, test = epoch["val"], out["test"]
    steps = len(epoch["losses"])
    ms_step = epoch["wall_s"] / steps * 1e3
    data_share = sum(epoch["data_s"]) / epoch["wall_s"]
    n_keys = sum(len(v) for v in AVA_SECS.values())
    print(f"# {label} ({card}): seed-0 weights, bf16, batch {AVA_BATCH}, "
          f"{n_keys} keyframes of 2 written videos ({write_s:.2f} s to "
          f"write); run_net epoch of {steps} steps {ms_step:.2f} ms/step "
          f"with data (step walls {[round(w, 4) for w in epoch['iter_s']]}"
          f" s, data waits {[round(w, 4) for w in epoch['data_s']]} s, "
          f"data-wait share {data_share:.3f}, losses {epoch['losses']}); "
          f"eval frame mAP {val['map']:.4f} over "
          f"{val['clips']} clips in {val['seconds']:.2f} s; test mAP "
          f"{test['map']:.4f} in {test['seconds']:.2f} s; checkpoint "
          f"{'written' if saved else 'missing'}; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; kernel rows launched: "
          f"{sum(launches.values())}")
    if not (steps == n_keys // AVA_BATCH and np.isfinite(epoch["losses"]).all()
            and saved and val["clips"] == test["clips"] == n_keys
            and all(0.0 <= m <= 1.0 for m in (val["map"], test["map"]))):
        _fail(f"{label}: the run_net train, eval or test is wrong")
    if any(launches.values()):
        _fail(f"{label}: kernel rows launched: {launches}")
    return {"ms_per_step": ms_step, "data_wait_share": data_share,
            "step_walls_s": epoch["iter_s"], "data_waits_s": epoch["data_s"],
            "losses": epoch["losses"], "val_map": val["map"],
            "val_s": val["seconds"], "test_map": test["map"],
            "test_s": test["seconds"], "peak_mem_bytes": peak,
            "launches": launches}


# -------------------------------------------------------------- ActionCLIP

CLIP_CFG = "actionclip_mvitv2_b_16x4_448_cfg"  # the config factory
CLIP_DEVICE = "cuda"
# the b8 feature forward's gates (relative L2): the video features of the
# kernel path against the plain reference mode (3.6e-3 on an H100), and the
# bf16 text features against the plain f32 text tower: no kernel runs
# there, so that distance is bf16's own rounding through 12 layers, 1.16e-2
# on an H100 (PERF.md section 6, PR 15); a wrong mask, pooling or
# projection moves normalized features by O(1)
CLIP_VIDEO_GATE, CLIP_TEXT_GATE = 1e-2, 2e-2
# the loop's captions, tokenized by the port's tokenizer over a merges
# file written in code (CLIP's bpe_simple_vocab_16e6.txt.gz is
# user-supplied)
CLIP_CAPTIONS = ("a person drinking from a bottle", "texting on the phone",
                 "eating while driving the car", "reaching to the back seat",
                 "talking on the phone", "adjusting the control panel",
                 "drinking and then texting", "hand on the head")
CLIP_MERGES = ("h e", "he l", "hel l", "t h", "th e</w>", "i n", "in g</w>",
               "p h", "ph o", "pho n", "phon e</w>", "t e", "te x", "tex t",
               "text ing</w>", "d r", "dr i", "dri n", "drin k",
               "drink ing</w>", "c a", "ca r</w>", "e a", "ea t",
               "eat ing</w>", "a n", "an d</w>", "o n</w>", "t o</w>")


def clip_tokens(batch: int, context: int, vocab: int, seed: int, device):
    """Token rows as the tokenizer writes them, drawn with numpy from
    ``seed``: ids below the end-of-text id, the end-of-text id (the
    vocabulary's largest) at 5-76, then zero padding."""
    import torch

    rng = np.random.default_rng(seed)
    tok = rng.integers(1, vocab - 1, (batch, context))
    for i in range(batch):
        end = int(rng.integers(5, context))
        tok[i, end] = vocab - 1
        tok[i, end + 1:] = 0
    return torch.from_numpy(tok).to(device)


def actionclip_checks(card: str) -> dict:
    """ActionCLIP at full width (``actionclip_mvitv2_b_16x4_448_cfg()``:
    the AI City MViT-v2-B @448 video tower, CLIP's ViT-B text tower; seed-0
    weights, bf16): the batch-8 feature forward (8 clips, 8 captions of 77
    ids) with its launches held to ``derived_counts`` of the video tower,
    its video features against the plain reference mode and its text
    features against the plain f32 text tower; the batch-4 contrastive
    train step without and with MoCo (warm-up, then timed steps, launches
    held to ``derived_counts``: the step's training rows, and under MoCo
    the momentum forward's inference rows too), its losses finite and the
    temperature's log within [0, ln 100]; a batch-2 step's gradients
    against the plain reference (``_hold_grads``, the f32 rule)."""
    import torch

    from aicity_action_tpu_torch import config as tconfig
    from aicity_action_tpu_torch.engine import contrastive as con
    from aicity_action_tpu_torch.engine.steps import step_generators
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.ops import kernels
    from aicity_action_tpu_torch.solver.optimizer import (construct_optimizer,
                                                          global_norm)

    label = "ActionCLIP @448"
    cfg = getattr(tconfig, CLIP_CFG)()
    dev = torch.device(CLIP_DEVICE)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    L, V = cfg.CONTRA.CONTEXT_LENGTH, cfg.CONTRA.vocab_size
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    x = _normal(gen, (BATCH, T, S, S, 3), device=dev)
    tokens = clip_tokens(BATCH, L, V, SEED + 91, dev)
    batch = {"inputs": x, "tokens": tokens}

    model = build_model(cfg, device=dev, seed=SEED)
    feature_step = con.make_feature_step(model)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    v, t, scale = feature_step(batch)
    torch.cuda.synchronize()
    counts = read_counts()
    want = derived_counts(model.video_encoder, train=False)
    if counts != want:
        _fail(f"{label}: launches per feature forward {counts} != {want}")
    ones = torch.ones(BATCH, device=dev)
    if v.shape != (BATCH, cfg.CONTRA.embed_dim) or t.shape != v.shape or \
            not (torch.isfinite(v).all() and torch.isfinite(t).all()) or \
            not torch.allclose(v.norm(dim=-1), ones, atol=1e-3) or \
            not torch.allclose(t.norm(dim=-1), ones, atol=1e-3):
        _fail(f"{label}: features not finite, L2-normed [{BATCH}, "
              f"{cfg.CONTRA.embed_dim}]")
    ms = time_ms(lambda: feature_step(batch), iters=5)
    peak = torch.cuda.max_memory_allocated()
    with kernels.plain_reference():
        v_p, _, _ = feature_step(batch)
        model.compute_dtype = torch.float32
        v_f32, t_f32, _ = feature_step(batch)
        model.compute_dtype = torch.bfloat16
    torch.cuda.synchronize()
    video_err, text_err = _rel(v, v_p), _rel(t, t_f32)
    # the plain reference's own distance from f32 (what bf16 costs)
    video_floor = _rel(v_p, v_f32)
    fwd = {"ms": ms, "clips_per_s": BATCH / ms * 1e3, "peak_mem_bytes": peak,
           "launches": counts, "video_rel_err": video_err,
           "video_plain_vs_f32": video_floor, "text_rel_err": text_err}
    print(f"# {label} feature forward, batch {BATCH} bf16 (8 clips of "
          f"{T}x{S}^2, 8 captions of {L} ids): {ms:.2f} ms, "
          f"{fwd['clips_per_s']:.2f} clips/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({card}); launches {counts}; video "
          f"features vs plain reference relative L2 {video_err:.3e} (tol "
          f"{CLIP_VIDEO_GATE}; the plain reference's own distance from f32 "
          f"{video_floor:.3e}), text features vs the plain f32 text tower "
          f"{text_err:.3e} (tol {CLIP_TEXT_GATE}); temperature "
          f"{float(scale):.4f}")
    if not (video_err <= CLIP_VIDEO_GATE and text_err <= CLIP_TEXT_GATE):
        _fail(f"{label}: features disagree with the plain references")
    del model, feature_step, v_p, v_f32, t_f32
    torch.cuda.empty_cache()

    tb = TRAIN_BATCH
    train_batch = {"inputs": x[:tb], "tokens": tokens[:tb],
                   "labels": torch.arange(tb, device=dev)}
    steps = {}
    for use_moco in (False, True):
        name = "MoCo" if use_moco else "no MoCo"
        model = build_model(cfg, device=dev, seed=SEED)
        opt = construct_optimizer(cfg, model, steps_per_epoch=100)
        momentum = con.make_momentum_model(model) if use_moco else None
        step = con.make_contrastive_train_step(
            model, opt, use_moco=use_moco,
            moco_momentum=cfg.TRAIN.MOCO_MOMENTUM, momentum_model=momentum,
            seed=SEED)
        losses = [float(step(train_batch)[0]["loss"])
                  for _ in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        metrics = [step(train_batch)[0] for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
        launches = read_counts()
        step_peak = torch.cuda.max_memory_allocated()
        losses += [float(m["loss"]) for m in metrics]
        log_scale = model.logit_scale.item()
        want = {k: TRAIN_STEPS * n for k, n in
                derived_counts(model.video_encoder, train=True).items()}
        if use_moco:  # the momentum forward's inference rows, counted apart
            for k, n in derived_counts(model.video_encoder,
                                       train=False).items():
                want[k] += TRAIN_STEPS * n
        print(f"# {label} contrastive train step ({name}), batch {tb}: "
              f"{step_ms:.2f} ms/step, {tb / step_ms * 1e3:.3f} clips/s, "
              f"peak memory {step_peak / 2 ** 30:.2f} GiB ({card}); losses "
              f"{losses}; logit_scale after {log_scale:.6f}; launches over "
              f"{TRAIN_STEPS} steps {launches}")
        if not all(np.isfinite(losses)) or \
                not 0.0 <= log_scale <= con.LOGIT_SCALE_MAX:
            _fail(f"{label} ({name}): loss {losses}, logit_scale "
                  f"{log_scale}")
        if launches != want:
            _fail(f"{label} ({name}): train-step launches {launches} != "
                  f"{want}")
        steps[name] = {"ms_per_step": step_ms,
                       "clips_per_s": tb / step_ms * 1e3,
                       "peak_mem_bytes": step_peak, "losses": losses,
                       "logit_scale": log_scale, "launches": launches}
        del model, opt, momentum, step
        torch.cuda.empty_cache()

    # batch 2 (two labels: a batch of one has a constant softmax and no
    # gradient), one step's loss and gradients against the plain reference
    model = build_model(cfg, device=dev, seed=SEED)
    model.train()
    params = list(model.parameters())
    x2, tok2 = x[:2], tokens[:2]
    labels = torch.arange(2, device=dev)
    valid = torch.ones(2, dtype=torch.bool, device=dev)

    def run(xx=x2):
        g, _ = step_generators(SEED, 7, dev)
        model.zero_grad(set_to_none=True)
        v2, t2, s2 = model(xx, tok2, generator=g)
        loss = con.contrastive_loss(v2, t2, s2, labels, valid)
        loss.backward()
        return (loss.item(), global_norm(params).item(),
                [p.grad.detach().float().clone() for p in params])

    grads = _hold_grads(f"{label} contrastive", model, run, x2, gen,
                        f32_truth=True, batch=2)
    return {"forward": fwd, "train": steps, "grad_check": grads}


def _clip_loop_opts(d: str, max_epoch: int) -> list:
    return ["NUM_GPUS", "1", "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "8",
            "TRAIN.EVAL_PERIOD", "1", "TRAIN.CHECKPOINT_PERIOD", "1",
            "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "1",
            "DATA_LOADER.NUM_WORKERS", "4",
            "DATA.PATH_TO_DATA_DIR", d, "DATA.PATH_PREFIX", d,
            "OUTPUT_DIR", os.path.join(d, "clip_out"), "RNG_SEED", str(SEED),
            "TRAIN.USE_MOCO", "True", "LOG_CFG", "False",
            "SOLVER.MAX_EPOCH", str(max_epoch)]


def actionclip_loop_checks(card: str, d: str) -> dict:
    """``tools/run_net_contrastive.py`` in process on the loop's 8 written
    views of ``d`` (:func:`write_loop_views`) with ``{split}_tokenized.csv``
    of CLIP_CAPTIONS made by the port's tokenizer over CLIP_MERGES: the
    ActionCLIP config from seed 0 with MoCo at batch 4, ``MAX_EPOCH 1`` (2
    steps, an eval with finite recall@1/5/10, a checkpoint with the
    momentum weights), then ``MAX_EPOCH 2``, which must auto-resume at epoch
    1, train epoch 2 and run the test, which writes the feature pickle;
    each call's launches held to ``derived_counts`` (per step the training
    rows and the momentum forward's, per eval or test batch a forward).
    Then ``inference_videotext`` with the text tower alone, loaded from the
    last checkpoint, must rank the pickled videos as the trained model's
    own text features do."""
    import pickle

    import torch

    from aicity_action_tpu_torch import config as tconfig
    from aicity_action_tpu_torch.data.tokenizer import (SimpleTokenizer,
                                                        tokenize)
    from aicity_action_tpu_torch.engine import contrastive as con
    from aicity_action_tpu_torch.pipeline.zeroshot import filter_query
    from aicity_action_tpu_torch.tools import (inference_videotext,
                                               run_net_contrastive)

    merges = os.path.join(d, "clip_merges.txt")
    with open(merges, "w") as f:
        f.write("#version: 0.2\n" + "\n".join(CLIP_MERGES) + "\n")
    tok = SimpleTokenizer(merges)
    cfg = getattr(tconfig, CLIP_CFG)()
    L = cfg.CONTRA.CONTEXT_LENGTH
    ids = tokenize(tok, list(CLIP_CAPTIONS), L)
    for split in ("train", "val", "test"):
        with open(os.path.join(d, f"{split}_tokenized.csv"), "w") as f:
            f.writelines(f"v{i}.y4m {i % 4} "
                         f"{','.join(str(t) for t in row if t)}\n"
                         for i, row in enumerate(ids))
    cfg_path = os.path.join(d, "actionclip.yaml")
    with open(cfg_path, "w") as f:
        f.write(cfg.dump())
    pkl = os.path.join(d, "clip_features.pkl")
    steps, val_fwd, test_fwd = LOOP_VIEWS // 4, LOOP_VIEWS // 4, \
        -(-LOOP_VIEWS // 8)
    runs = []
    torch.cuda.reset_peak_memory_stats()
    for max_epoch, with_test in ((1, False), (2, True)):
        extra = (["TEST.SAVE_RESULTS_PATH", pkl] if with_test
                 else ["TEST.ENABLE", "False"])
        reset_counts()
        t0 = time.perf_counter()
        out = run_net_contrastive.main(
            ["--cfg", cfg_path, "--device", LOOP_DEVICE,
             *_clip_loop_opts(d, max_epoch), *extra])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        run = out["train"]
        if run.start_epoch != max_epoch - 1 or len(run.epochs) != 1 or \
                run.optimizer.count != steps * max_epoch:
            _fail(f"ActionCLIP loop MAX_EPOCH {max_epoch}: start "
                  f"{run.start_epoch}, {len(run.epochs)} epochs, step "
                  f"{run.optimizer.count}")
        epoch = run.epochs[0]
        recalls = {k: v for k, v in epoch["val"].items() if "recall" in k}
        if len(epoch["losses"]) != steps or \
                not np.isfinite(epoch["losses"]).all() or \
                len(recalls) != 6 or \
                not all(0.0 <= r <= 1.0 for r in recalls.values()) or \
                epoch["val"]["forwards"] != val_fwd:
            _fail(f"ActionCLIP loop MAX_EPOCH {max_epoch}: losses "
                  f"{epoch['losses']}, eval {epoch['val']}")
        ckpt = torch.load(os.path.join(d, "clip_out", "checkpoints",
                                       f"checkpoint_epoch_{max_epoch:05d}"),
                          map_location="cpu", weights_only=True)
        if ckpt["step"] != steps * max_epoch or \
                set(ckpt.get("ema_state", {})) != set(ckpt["model_state"]):
            _fail(f"ActionCLIP loop: checkpoint {max_epoch} without its "
                  f"step or momentum weights")
        tower = run.model.video_encoder
        want = {k: steps * n for k, n in
                derived_counts(tower, train=True).items()}
        fwds = steps + val_fwd + (test_fwd if with_test else 0)
        for k, n in derived_counts(tower, train=False).items():
            want[k] += fwds * n  # the momentum forwards, evals, the test
        if launches != want:
            _fail(f"ActionCLIP loop MAX_EPOCH {max_epoch}: launches "
                  f"{launches} != {want}")
        runs.append({"epoch": epoch, "seconds": seconds,
                     "launches": launches, "test": out["test"]})
    peak = torch.cuda.max_memory_allocated()
    test = runs[1]["test"]
    if test["forwards"] != test_fwd or test["clips"] != LOOP_VIEWS or \
            not all(np.isfinite(v) for k, v in test.items()
                    if "recall" in k):
        _fail(f"ActionCLIP loop: test stats {test}")
    with open(pkl, "rb") as f:
        feats, vids = pickle.load(f)
    if feats.shape != (LOOP_VIEWS, cfg.CONTRA.embed_dim) or \
            list(vids) != list(range(LOOP_VIEWS)) or \
            not np.isfinite(feats).all():
        _fail("ActionCLIP loop: the feature pickle is wrong")

    query = "the person is texting on the phone"
    ranked = inference_videotext.main([
        "--cfg", cfg_path, "--features", pkl, "--bpe_path", merges,
        "--query", query, "--top_k", str(LOOP_VIEWS), "--device",
        LOOP_DEVICE, "--checkpoint",
        os.path.join(d, "clip_out", "checkpoints",
                     "checkpoint_epoch_00002")])
    model = out["train"].model.eval()
    with torch.no_grad():
        t = model.encode_text(torch.from_numpy(tokenize(
            tok, [filter_query(query)], L)).to(LOOP_DEVICE))[0]
    t = t.float().cpu().numpy()
    v = feats / np.linalg.norm(feats, axis=1, keepdims=True)
    scores = v @ (t / np.linalg.norm(t))
    order = [int(i) for i in np.argsort(-scores)]
    got_scores = np.asarray([s for _, s in ranked])
    score_err = float(np.abs(got_scores - scores[order]).max())
    if [vid for vid, _ in ranked] != [int(vids[i]) for i in order] or \
            not score_err <= 1e-3:
        _fail(f"inference_videotext ranked {ranked}, the loop's features "
              f"{[(int(vids[i]), float(scores[i])) for i in order]}")
    r0, r1 = runs
    e1, e2 = r0["epoch"], r1["epoch"]
    ms = e2["wall_s"] * 1e3 / steps
    print(f"# ActionCLIP loop ({card}): run_net_contrastive MAX_EPOCH 1 "
          f"then 2 (auto-resumed at epoch 1, MoCo weights restored), batch "
          f"4 with MoCo, {LOOP_VIEWS} views of {CHAIN_SIZE[0]}x"
          f"{CHAIN_SIZE[1]}; epoch 2: {ms:.2f} ms/step "
          f"with data over {steps} steps (epoch wall {e2['wall_s']:.3f} s), "
          f"step walls {e2['iter_s']}, data waits {e2['data_s']}; losses "
          f"{e1['losses'] + e2['losses']}; logit scales "
          f"{e1['logit_scales'] + e2['logit_scales']}; eval recalls "
          f"{[{k: v for k, v in e['val'].items() if 'recall' in k} for e in (e1, e2)]}, "
          f"{e2['val']['clips'] / e2['val']['seconds']:.2f} clips/s with "
          f"data; test {test['clips'] / test['seconds']:.2f} clips/s; "
          f"checkpoint {e1['ckpt_s']:.2f} / {e2['ckpt_s']:.2f} s; peak "
          f"memory {peak / 2 ** 30:.2f} GiB; runs {r0['seconds']:.1f} / "
          f"{r1['seconds']:.1f} s; inference_videotext ranks as the "
          f"features (max |score diff| {score_err:.2e}); launches "
          f"{r0['launches']} / {r1['launches']}")
    return {"ms_per_step": ms, "peak_mem_bytes": peak,
            "val_clips_per_s": e2["val"]["clips"] / e2["val"]["seconds"],
            "test_clips_per_s": test["clips"] / test["seconds"],
            "losses": e1["losses"] + e2["losses"],
            "videotext_score_err": score_err,
            "launches": {k: r0["launches"][k] + r1["launches"][k]
                         for k in r0["launches"]},
            "logit_scale_max": con.LOGIT_SCALE_MAX}


# ------------------------------------------------------ multi-head fine-tune

# the reference's default multi-dataset setting (config/defaults.py:139-146)
# on the AI City backbone; each dataset's csvs over the train loop's views
MH_DATASETS = ("kinetics", "mmit", "activitynet")
MH_TRAIN_VIEWS, MH_VAL_VIEWS = 4, 2  # a dataset: 12 clips = 3 steps of 4
MH_DEVICE = "cuda"


def _mh_labels(name: str, i: int) -> str:
    """A view's label in dataset ``name``'s csv: an id of its class space
    (700 / 292 / 200), mmit's a comma-separated multi-label."""
    if name == "mmit":
        return f"{(7 * i) % 292},{(7 * i + 100) % 292}"
    return str((37 * i) % (700 if name == "kinetics" else 200))


def write_multi_dataset(d: str) -> list:
    """Each of MH_DATASETS's train and val csvs in ``d/<name>`` over the
    loop's views in ``d``; returns the config overrides of the run."""
    dirs = []
    for k, name in enumerate(MH_DATASETS):
        sub = os.path.join(d, name)
        os.makedirs(sub, exist_ok=True)
        for split, views in (("train", range(MH_TRAIN_VIEWS)),
                             ("val", range(MH_TRAIN_VIEWS,
                                           MH_TRAIN_VIEWS + MH_VAL_VIEWS))):
            with open(os.path.join(sub, f"{split}.csv"), "w") as f:
                f.writelines(f"v{(i + k) % LOOP_VIEWS}.y4m "
                             f"{_mh_labels(name, i + k)}\n" for i in views)
        dirs.append(sub)
    return ["TRAIN.DATASET", "multi_dataset_seq", "MODEL.USE_MULTI_HEAD",
            "True", "MODEL.MULTI_ADD_CROSS_PROJ", "True",
            "MODEL.USE_VICREG_LOSS", "True", "MODEL.MULTI_DATASETS",
            str(list(MH_DATASETS)), "MODEL.MULTI_PATH_TO_DATA_DIR",
            str(dirs), "MODEL.MULTI_PATH_PREFIX", str([d] * len(dirs)),
            "TEST.ENABLE", "False"]


def tensorboard_probe() -> str:
    """Whether ``torch.utils.tensorboard`` imports here, in words."""
    try:
        import torch.utils.tensorboard  # noqa: F401
    except ImportError as e:
        return f"torch.utils.tensorboard does not import ({e})"
    import tensorboard

    return f"torch.utils.tensorboard imports (tensorboard {tensorboard.__version__})"


def multihead_checks(card: str, d: str) -> dict:
    """The multi-dataset fine-tune through ``tools/run_net.py``'s ``main``,
    in process: the AI City MViT-v2-B 16x4 @448 (seed 0, bf16) with the
    reference's three default datasets' heads (kinetics 700 soft CE, mmit
    292 BCE x 10, activitynet 200 soft CE), the cross projections and
    VICReg, batch 4 on clips of the loop's views; one epoch (3 steps, an
    eval), with TensorBoard on where it imports. Launches held to
    ``derived_counts`` times the steps and eval forwards (the heads launch
    none), finite losses, each dataset's eval top-k, the event file (or,
    where TensorBoard does not import, a writer that drops the scalars);
    then a
    batch-1 step's gradients, the heads' and cross projections' leaves
    included, against the plain reference (:func:`_hold_grads`)."""
    import glob

    import torch

    from aicity_action_tpu_torch.tools import run_net

    probe = tensorboard_probe()
    has_tb = probe.startswith("torch.utils.tensorboard imports")
    out = os.path.join(d, "mh_out")
    opts = _loop_opts(d, 1, "mh_out")
    opts[opts.index("TRAIN.CHECKPOINT_PERIOD") + 1] = "10"
    opts += write_multi_dataset(d) + ["TENSORBOARD.ENABLE", str(has_tb)]
    reset_counts()
    t = time.perf_counter()
    with model_inputs_seen() as seen:
        res = run_net.main(["--cfg", LOOP_CFG, "--device", MH_DEVICE,
                            *opts])
        torch.cuda.synchronize()
        seen = list(seen)
    seconds = time.perf_counter() - t
    launches = read_counts()
    run = res["train"]
    epoch = run.epochs[0]
    steps = len(MH_DATASETS) * MH_TRAIN_VIEWS // 4
    val = epoch["val"]
    val_fwd = -(-len(MH_DATASETS) * MH_VAL_VIEWS // 4)
    if len(epoch["losses"]) != steps or not all(np.isfinite(epoch["losses"])):
        _fail(f"multi-head fine-tune: losses {epoch['losses']}")
    if val["forwards"] != val_fwd or set(val["dataset_topk"]) != \
            set(MH_DATASETS):
        _fail(f"multi-head fine-tune: eval {val}")
    want = {k: steps * v for k, v in
            derived_counts(run.model, train=True).items()}
    for k, v in derived_counts(run.model, train=False).items():
        want[k] += val_fwd * v
    if launches != want:
        _fail(f"multi-head fine-tune: launches {launches} != {want}")
    if seen != [LOOP_INPUT] * (steps + val_fwd):
        _fail(f"multi-head fine-tune: the model's inputs {sorted(set(seen))}")
    events = glob.glob(os.path.join(out, "runs-multi_dataset_seq",
                                    "events.*"))
    if has_tb:
        if len(events) != 1:
            _fail(f"multi-head fine-tune: TensorBoard wrote {events}")
        tb = f"event file {os.path.basename(events[0])}"
    else:
        from aicity_action_tpu_torch.config import load_config, parse_args
        from aicity_action_tpu_torch.visualization.tensorboard_vis import (
            TensorboardWriter)

        w = TensorboardWriter(load_config(parse_args(
            ["--cfg", LOOP_CFG, *opts])))
        if w.writer is not None:
            _fail("the TensorBoard writer built a writer without a package")
        tb = "the writer warns and drops the scalars"
    ms = epoch["wall_s"] * 1e3 / steps
    print(f"# multi-head fine-tune ({card}): MViT-v2-B 16x4 @448, heads "
          f"{dict(zip(MH_DATASETS, run.model.spec.multi_num_classes))}, "
          f"cross projections and VICReg, batch 4; {steps} steps "
          f"{ms:.2f} ms/step with data (epoch wall {epoch['wall_s']:.3f} s; "
          f"step walls {epoch['iter_s']}, data waits {epoch['data_s']}); "
          f"losses {epoch['losses']}; eval top-1 by dataset "
          f"{ {k: v['top1_acc'] for k, v in val['dataset_topk'].items()} } "
          f"({val['clips']} clips, {val['forwards']} forwards); "
          f"TensorBoard: {probe}; {tb}; run {seconds:.1f} s; launches "
          f"{launches}")
    del res, run
    torch.cuda.empty_cache()
    from aicity_action_tpu_torch.config import load_config, parse_args

    cfg = load_config(parse_args(["--cfg", LOOP_CFG, *opts]))
    grads = multihead_grad_check(cfg, "MViT-v2-B @448 multi-head")
    return {"ms_per_step": ms, "losses": epoch["losses"],
            "val": val, "tensorboard": probe, "launches": launches,
            "seconds": seconds, "grad_check": grads}


def multihead_grad_check(cfg, label: str) -> dict:
    """One batch-1 multi-head step's loss and gradients (no update): the
    train step's loss (every head's masked loss, the cross projections
    into the sample's dataset, VICReg) with the kernels against the same
    model in its plain reference mode (:func:`_hold_grads`). The sample is
    mmit's, whose class space every other head projects into, so that
    every head and the projections into mmit carry gradients; the others
    are exactly zero on both paths."""
    import torch

    from aicity_action_tpu_torch.engine.steps import (multihead_step_kwargs,
                                                      step_generators)
    from aicity_action_tpu_torch.models import losses as loss_lib
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.solver.optimizer import global_norm

    kw = multihead_step_kwargs(cfg)
    model = build_model(cfg, device=MH_DEVICE, seed=SEED)
    dev = next(model.parameters()).device
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    x = _normal(gen, (1, T, S, S, 3), device=dev)
    ds = 1  # mmit
    n_cls = dict(zip(kw["datasets"], kw["num_classes"]))
    labels = {k: torch.zeros((1, n), device=dev) for k, n in n_cls.items()}
    labels["mmit"][0, [3, 40]] = 1.0
    masks = {k: torch.tensor([float(i == ds)], device=dev)
             for i, k in enumerate(kw["datasets"])}
    model.train()
    params = list(model.parameters())

    def run(xx=x):
        g, _ = step_generators(SEED, 7, dev)
        model.zero_grad(set_to_none=True)
        preds, emb = model(xx, generator=g, run_cross_proj=True,
                           return_emb=True)
        loss = loss_lib.compute_multi_dataset_loss(
            preds, labels, masks, kw["datasets"], kw["loss_funcs"],
            dict(zip(kw["datasets"], kw["loss_weights"])),
            add_cross_proj=True, proj_loss_func=kw["proj_loss_func"],
            proj_loss_weight=kw["proj_loss_weight"])
        loss = loss + kw["vicreg_weight"] * loss_lib.compute_vicreg_loss(
            emb.float(), std_weight=1.0, cov_weight=1.0)
        loss.backward()
        return (loss.item(), global_norm(params).item(),
                [torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                 else p.grad.detach().float().clone() for p in params])

    names = [n for n, _ in model.named_parameters()]
    head = [i for i, n in enumerate(names) if n.startswith("head.")]
    out = _hold_grads(label, model, run, x, gen)
    out["head_leaves"] = len(head)
    return out


# ---------------------------------------------------- classifier and export

CLF_CFG = "mvitv2_b_16x4_448_cfg"  # the config factory of the phase
CLF_DEVICE = "cuda"


def classifier_checks(card: str, d: str) -> dict:
    """``VideoActionClassifier`` at @448 batch 8 (seed-0 weights, bf16): its
    eager ``inference`` on a short batch (padded) and a long one (split),
    the launches of one batch-8 call held to ``derived_counts``; then
    ``export`` (``torch.export``, the inference kernels as custom ops),
    ``exported_path=`` and a rerun whose launches of rows 5, 8, 10 and 12
    must equal one forward's ``derived_counts`` and whose scores must match
    the eager ones within the batch-8 forward's 1e-2. Times the model's
    eager forward and the exported program's on the same device batch."""
    import torch

    from aicity_action_tpu_torch import config as tconfig
    from aicity_action_tpu_torch.pipeline.classifier import (
        VideoActionClassifier)

    cfg = getattr(tconfig, CLF_CFG)()
    cfg.OUTPUT_DIR = os.path.join(d, "clf_out")
    clf = VideoActionClassifier(cfg, batch_size=BATCH, device=CLF_DEVICE)
    model = clf.scorer.model
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    rng = np.random.default_rng(SEED + 7)
    x = rng.standard_normal((BATCH + 3, T, S, S, 3), dtype=np.float32)
    want = derived_counts(model, train=False)
    reset_counts()
    eager = clf.inference([x[:BATCH]])
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != want:
        _fail(f"classifier: launches of one batch {counts} != {want}")
    short = clf.inference([x[:3]])
    longer = clf.inference([x])
    if eager.shape != (BATCH, cfg.MODEL.NUM_CLASSES) or \
            not np.isfinite(longer).all():
        _fail("classifier: mis-shaped or non-finite scores")
    pad_err = float(np.abs(short - eager[:3]).max())
    split_err = float(np.abs(longer[:BATCH] - eager).max())
    path = os.path.join(d, "mvitv2_b_448_b8.pt2")
    t = time.perf_counter()
    clf.export(path)
    export_s = time.perf_counter() - t
    t = time.perf_counter()
    loaded = VideoActionClassifier(cfg, batch_size=BATCH,
                                   exported_path=path, device=CLF_DEVICE)
    load_s = time.perf_counter() - t
    reset_counts()
    exported = loaded.inference([x[:BATCH]])
    torch.cuda.synchronize()
    ex_counts = read_counts()
    inference = {k: want[k] for k in KERNEL_FNS}
    if {k: ex_counts[k] for k in KERNEL_FNS} != inference or \
            sum(ex_counts.values()) != sum(want.values()):
        _fail(f"exported program: launches {ex_counts} != one forward's "
              f"{want}")
    err = float(np.abs(exported - eager).max())
    if not (err <= 1e-2 and pad_err <= 1e-2 and split_err <= 1e-2):
        _fail(f"classifier: exported {err}, padded {pad_err}, split "
              f"{split_err} from the eager scores (tol 1e-2)")
    xd = torch.from_numpy(x[:BATCH]).to(clf.device)
    program = loaded._fn
    with torch.no_grad():
        t_eager, t_prog = time_interleaved(
            [lambda: clf.scorer(xd), lambda: program(xd)], 5, warmup=1)
    size = os.path.getsize(path)
    print(f"# classifier and export ({card}): MViT-v2-B 16x4 @448, batch "
          f"{BATCH}; eager forward {t_eager['ms']:.2f} ms (iqr "
          f"{t_eager['iqr'][0]:.2f}-{t_eager['iqr'][1]:.2f}), exported "
          f"program {t_prog['ms']:.2f} ms (iqr {t_prog['iqr'][0]:.2f}-"
          f"{t_prog['iqr'][1]:.2f}); export {export_s:.1f} s, load "
          f"{load_s:.1f} s, {size / 2 ** 20:.1f} MiB; max |exported - "
          f"eager| {err:.3e}, padded batch {pad_err:.3e}, split batch "
          f"{split_err:.3e} (tol 1e-2); launches eager {counts}, exported "
          f"{ex_counts}")
    del clf, loaded, program, model, xd
    torch.cuda.empty_cache()
    return {"eager_ms": t_eager["ms"], "exported_ms": t_prog["ms"],
            "export_s": export_s, "load_s": load_s, "file_bytes": size,
            "exported_err": err, "pad_err": pad_err, "split_err": split_err,
            "launches": counts, "exported_launches": ex_counts}


# ------------------------------------------------------------ fire drill

DRILL_DEVICE = "cuda"
DRILL_CFG = CHAIN_CFG


def fire_drill_checks(card: str, d: str) -> dict:
    """``tools/fire_drill.py`` as a user runs it (a subprocess chaining
    ``run_temporal_inf``, ``aicity_inf`` and ``aicity_inf_graph``) on a
    seed-0 MViT-v2-B @448 ``.pyth`` written here, the AI City chain's two
    short views, a threshold file and an annotation csv: a finite F1, a
    clean load (0 mismatched, 0 missing), and a rerun that skips the
    scoring stage. Also ``run_temporal_inf`` on the YAML's ``NUM_GPUS 8``
    must refuse before spawning, naming the cards present."""
    import torch

    from aicity_action_tpu_torch.config import get_cfg
    from aicity_action_tpu_torch.data.decoder import write_y4m
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.tools import run_temporal_inf

    cfg = get_cfg()
    cfg.merge_from_file(DRILL_CFG)
    model = build_model(cfg, device=DRILL_DEVICE, seed=SEED)
    pyth = os.path.join(d, "released.pyth")
    torch.save({"model_state": model.state_dict(), "epoch": 1}, pyth)
    n_tensors = len(model.state_dict())
    del model
    torch.cuda.empty_cache()
    stems = []
    for i, (view, n) in enumerate(CHAIN_VIEWS[1:]):
        stem = f"{view}_user_id_{CHAIN_USER}_NoAudio_0"
        write_y4m(os.path.join(d, f"{stem}.y4m"), _view_frames(n, SEED + 20
                                                               + i))
        stems.append(stem)
    with open(os.path.join(d, "videos.lst"), "w") as f:
        f.writelines(f"{s}.y4m\n" for s in stems)
    with open(os.path.join(d, "vid.csv"), "w") as f:
        f.write("video_id,view1,view2,view3\n1," + ",".join(
            [stems[0], stems[1], stems[0]]) + "\n")
    with open(os.path.join(d, "thres.txt"), "w") as f:
        f.writelines(f"{c} 0.05\n" for c in range(1, 18))
    with open(os.path.join(d, "anno.csv"), "w") as f:
        f.writelines(f"{s}.{CHAIN_USER}.{t0}.{t1}.MP4 {c}\n" for s in stems
                     for c, (t0, t1) in ((1, (0, 1)), (2, (1, 3))))
    if DRILL_DEVICE == "cuda":
        try:
            run_temporal_inf.main([
                "--cfg", DRILL_CFG, "--video_lst",
                os.path.join(d, "videos.lst"), "--video_path", d,
                "--out_dir", os.path.join(d, "refused")])
        except RuntimeError as e:
            if f"device_count() is {torch.cuda.device_count()}" not in \
                    str(e):
                raise
            refused = str(e)
        else:
            _fail("run_temporal_inf spawned the YAML's NUM_GPUS 8 ranks")
    else:
        refused = "not checked (no card)"
    argv = [sys.executable, "-m", "aicity_action_tpu_torch.tools.fire_drill",
            "--pyth", pyth, "--cfg", DRILL_CFG, "--video_lst",
            os.path.join(d, "videos.lst"), "--video_path", d, "--vid_csv",
            os.path.join(d, "vid.csv"), "--thres_file",
            os.path.join(d, "thres.txt"), "--out_dir",
            os.path.join(d, "drill"), "--anno_csv",
            os.path.join(d, "anno.csv"), "--device", DRILL_DEVICE,
            "--frame_length", str(cfg.DATA.NUM_FRAMES), "--frame_size",
            str(cfg.DATA.TEST_CROP_SIZE), "--batch_size", str(BATCH),
            "--num_workers", "4", "NUM_GPUS", "1", "RNG_SEED", str(SEED)]
    runs = []
    for _ in range(2):
        t = time.perf_counter()
        r = subprocess.run(argv, cwd=_REPO, capture_output=True, text=True,
                           timeout=900)
        if r.returncode != 0:
            _fail(f"fire drill rc {r.returncode}: {r.stdout[-3000:]}"
                  f"{r.stderr[-3000:]}")
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("[fire_drill] {")]
        runs.append({"seconds": time.perf_counter() - t,
                     "summary": json.loads(lines[-1].split(" ", 1)[1]),
                     "skips": r.stdout.count("skipping")})
    first, second = runs
    s = first["summary"]
    if not (s["load"] == {"loaded": n_tensors, "shape_mismatched": 0,
                          "missing_in_ckpt": 0}
            and s["preds"] == len(stems) and np.isfinite(s.get("f1", np.nan))
            and second["skips"] == 1 and first["skips"] == 0
            and second["summary"] == s):
        _fail(f"fire drill: {runs}")
    print(f"# fire drill ({card}): seed-0 MViT-v2-B @448 .pyth, "
          f"{len(stems)} views; load {s['load']}, F1 {s['f1']:.6f} "
          f"(precision {s['precision']:.6f}, recall {s['recall']:.6f}), "
          f"{s['submission']['lines']} submission rows; first run "
          f"{first['seconds']:.1f} s, rerun {second['seconds']:.1f} s "
          f"(scoring skipped); NUM_GPUS 8 refused: {refused!r}")
    return {"summary": s, "seconds": [r["seconds"] for r in runs],
            "refused": refused}


# ------------------------------------------------ loader and decode benchmarks

def benchmark_checks(card: str, d: str) -> dict:
    """``tools/benchmark.py`` (the train loader alone, no model) on the
    train loop's views at batch 4 over 2 epochs, and
    ``tools/benchmark_decode.py --seconds 10 60 --reps 3`` as a
    subprocess; their numbers printed, no gate on them."""
    from aicity_action_tpu_torch.tools import benchmark

    stats = benchmark.main(["--cfg", LOOP_CFG, *_loop_opts(d, 1, "bench"),
                            "BENCHMARK.NUM_EPOCHS", "2",
                            "BENCHMARK.LOG_PERIOD", "1"])
    if stats["total_clips"] != 2 * LOOP_VIEWS or stats["batch_size"] != 4:
        _fail(f"loader benchmark: {stats}")
    t = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "aicity_action_tpu_torch.tools."
         "benchmark_decode", "--seconds", "10", "60", "--reps", "3"],
        cwd=_REPO, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        _fail(f"benchmark_decode rc {r.returncode}: {r.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    decode_s = time.perf_counter() - t
    print(f"# loader benchmark ({card}): {LOOP_VIEWS} views of "
          f"{CHAIN_SIZE[0]}x{CHAIN_SIZE[1]} y4m, batch 4, 2 epochs, 4 "
          f"workers: {stats['clips_per_sec']:.2f} clips/s, "
          f"median {stats['med_iter_sec']:.4f} s/iter, p95 "
          f"{stats['p95_iter_sec']:.4f}, {stats['total_clips']} clips in "
          f"{stats['wall_sec']:.2f} s")
    for line in lines:
        print(f"# decode benchmark ({card}): {json.dumps(line)}")
    print(f"# decode benchmark run {decode_s:.1f} s")
    return {"loader": stats, "decode": lines, "decode_run_s": decode_s}


# ------------------------------------------------------------------ main

def _factory(name: str):
    """The config factory ``name`` of this file or of the port's config."""
    import aicity_action_tpu_torch.config as configs

    return globals().get(name) or getattr(configs, name)


# ------------------------------------------------ MoE MViT-v2-B 16x4 @448

MOE_DEVICE = "cuda"
# the config factory of the phase: the AI City model with MVIT.MOE on at the
# section's defaults (8 experts, top-2, capacity 1.25, blocks 1, 3, ..., 15)
MOE_CFG = "mvitv2_b_16x4_448_moe_cfg"


def moe_checks(card: str, d: str) -> dict:
    """The MoE model at full width (seed 0, bf16): the batch-8 scoring
    forward through ``make_eval_step`` with its launches held to
    ``derived_counts`` (no LN+MLP in the 8 banks), its time and peak
    memory; a batch-1 forward's scores and head input against the same
    weights' plain f32 forward, and a control (the plain forward with every
    bank's experts rolled by one) that the head-input gate refuses; then ``run_net`` on the loop's views (MAX_
    EPOCH 1: 2 steps at batch 4 with the load-balance loss, an eval, a
    checkpoint, the test), held as the train loop phase holds its runs."""
    import torch

    from aicity_action_tpu_torch.engine.steps import make_eval_step
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.models.moe import BANK_LEAVES, MoEMlp
    from aicity_action_tpu_torch.ops import kernels
    from aicity_action_tpu_torch.tools import run_net

    cfg = _factory(MOE_CFG)()
    model = build_model(cfg, device=MOE_DEVICE, seed=SEED)
    eval_step = make_eval_step(model)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    gen = torch.Generator(device=MOE_DEVICE).manual_seed(SEED + 80)
    x = _normal(gen, (BATCH, T, S, S, 3), device=MOE_DEVICE)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = eval_step({"inputs": x})
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = derived_counts(model, train=False)
    if counts != want:
        _fail(f"MoE @448: launches per forward {counts} != {want}")
    banks = len(cfg.MVIT.MOE.LAYERS) or len(model.blocks) // 2
    if out.shape != (BATCH, cfg.MODEL.NUM_CLASSES) or \
            not torch.isfinite(out).all() or len(model.moe_aux) != banks:
        _fail("MoE @448 batch-8 forward: wrong scores or banks")
    ms = time_ms(lambda: eval_step({"inputs": x}), iters=5)

    feats = []
    hook = model.head.register_forward_hook(
        lambda mod, inp, outp: feats.append(inp[0].float()))
    out_k = eval_step({"inputs": x[:1]})
    hook.remove()
    f32 = cfg.clone()
    f32.TPU.COMPUTE_DTYPE = "float32"
    plain = build_model(f32, device=MOE_DEVICE, seed=SEED)
    hook = plain.head.register_forward_hook(
        lambda mod, inp, outp: feats.append(inp[0].float()))
    with kernels.plain_reference(), torch.no_grad():
        out_p = plain.eval()(x[:1].float())
        # the control: every bank's experts rolled by one (each token
        # routed as before, through its neighbour's weights), which the
        # head-input gate must refuse
        for blk in plain.blocks:
            if isinstance(blk.mlp, MoEMlp):
                for leaf in BANK_LEAVES:
                    w = getattr(blk.mlp, leaf)
                    w.copy_(w.roll(1, 0))
        out_c = plain(x[:1].float())
    hook.remove()
    torch.cuda.synchronize()

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    feat_err, ctrl_err = rel(feats[0], feats[1]), rel(feats[2], feats[1])
    score_err = (out_k.float() - out_p).abs().max().item()
    ctrl_score = (out_c - out_p).abs().max().item()
    del plain, hook
    m = cfg.MVIT.MOE
    print(f"# MoE MViT-v2-B 16x4 @448 ({card}; {m.NUM_EXPERTS} experts, "
          f"top-{m.TOP_K}, capacity {m.CAPACITY_FACTOR}, blocks "
          f"{list(model.spec.moe.layers)}): batch-{BATCH} forward "
          f"{ms:.2f} ms, "
          f"{BATCH / ms * 1e3:.2f} clips/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB; launches {counts}; batch-1 kernels "
          f"(bf16) vs the plain f32 forward: max |score error| "
          f"{score_err:.3e} (tol 1e-2), head-input relative L2 "
          f"{feat_err:.3e} (tol 5e-2); control (experts rolled, plain "
          f"f32): head-input relative L2 {ctrl_err:.3e} (must exceed "
          f"5e-2), max |score error| {ctrl_score:.3e}")
    if not (score_err <= 1e-2 and feat_err <= 5e-2):
        _fail("MoE @448: the kernel forward disagrees with the plain f32 "
              "forward")
    if not ctrl_err > 5e-2:
        _fail("MoE @448: the head-input gate passes a forward through the "
              "wrong experts")
    del model, eval_step, out, x
    torch.cuda.empty_cache()

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with model_inputs_seen() as seen:
        res = run_net.main(["--cfg", LOOP_CFG, "--device", LOOP_DEVICE,
                            *_loop_opts(d, 1, "moe_out"),
                            "MVIT.MOE.ENABLE", "True"])
        torch.cuda.synchronize()
        run = _check_loop_run(res, read_counts(), list(seen), 1, d,
                              "moe_out")
    wall = time.perf_counter() - t
    loop_peak = torch.cuda.max_memory_allocated()
    if len(res["train"].model.moe_aux) != banks:
        _fail("MoE run_net: the banks' load-balance losses are missing")
    epoch = run["epochs"][0]
    print(f"# MoE @448 run_net ({card}): MAX_EPOCH 1, batch 4 on the loop's "
          f"8 views, load-balance weight {cfg.MVIT.MOE.AUX_LOSS_WEIGHT}: "
          f"losses "
          f"{epoch['losses']}, step walls {epoch['iter_s']}, epoch "
          f"{epoch['wall_s']:.3f} s, peak memory {loop_peak / 2 ** 30:.2f} "
          f"GiB, run {wall:.1f} s; launches {run['launches']}")
    del res
    torch.cuda.empty_cache()
    return {"forward_ms": ms, "clips_per_s": BATCH / ms * 1e3,
            "peak_mem_bytes": peak, "score_err_f32": score_err,
            "feat_rel_err_f32": feat_err, "launches_per_forward": counts,
            "loop": {"losses": epoch["losses"], "iter_s": epoch["iter_s"],
                     "wall_s": epoch["wall_s"], "peak_mem_bytes": loop_peak,
                     "seconds": wall},
            "loop_launches": run["launches"]}


# ---------------------------------------- EP, SP and TP: two ranks, one card

PAR_DEVICE = "cuda"  # the one card both ranks share
PAR_BACKEND = "gloo"
PAR_BATCH = 2  # EP and TP global batch; SP scores one clip
PAR_MOE_CFG = "mvitv2_b_16x4_448_moe_cfg"  # the phase's config factories
PAR_CFG = "mvitv2_b_16x4_448_cfg"


def _par_cfgs():
    """``(MoE cfg, plain cfg)`` of the phase: SGD, no mixup; the MoE
    model's banks at the defaults."""
    out = []
    for name in (PAR_MOE_CFG, PAR_CFG):
        cfg = _factory(name)()
        cfg.SOLVER.OPTIMIZING_METHOD = "sgd"
        cfg.MIXUP.ENABLE = False
        cfg.RNG_SEED = SEED
        out.append(cfg)
    return out


def _par_batch(cfg, n: int, dev):
    """``n`` clips and labels of the phase, made with numpy from the seed
    (every process makes the same)."""
    import torch

    rng = np.random.default_rng(SEED + 90)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    x = rng.standard_normal((n, T, S, S, 3), dtype=np.float32)
    return (torch.from_numpy(x).to(dev),
            torch.from_numpy(np.arange(n) % cfg.MODEL.NUM_CLASSES).to(dev))


def _grads(named) -> dict:
    return {n: p.grad.detach().float().cpu().clone() for n, p in named
            if p.grad is not None}


def _ep_run(cfg, dev, m=None) -> dict:
    """The MoE model's SGD step: on the whole batch in one process
    (``m`` None), or expert-parallel over ``m``'s ``ep`` axis on this
    rank's clip."""
    import torch

    from aicity_action_tpu_torch.engine.steps import make_train_step
    from aicity_action_tpu_torch.engine.train_loop import moe_aux_weight
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.parallel import ep
    from aicity_action_tpu_torch.solver.optimizer import construct_optimizer

    model = build_model(cfg, device=dev, seed=SEED)
    x, y = _par_batch(cfg, PAR_BATCH, dev)
    kw = {}
    if m is not None:
        sharded = ep.shard_experts(model, m, "ep")
        kw["grad_sync"] = lambda: ep.ep_grad_sync(model, m, "ep", sharded)
        r = m.index("ep")
        x, y = x[r:r + 1], y[r:r + 1]
    opt = construct_optimizer(cfg, model, 100)
    if m is not None:
        opt.norm_fn = ep.ep_grad_norm(m, "ep", sharded)
    step = make_train_step(model, opt, cfg.MODEL.LOSS_FUNC,
                           num_classes=cfg.MODEL.NUM_CLASSES, seed=SEED,
                           moe_aux_weight=moe_aux_weight(cfg), **kw)
    reset_counts()
    t = time.perf_counter()
    metrics, _ = step({"inputs": x, "labels": y})
    torch.cuda.synchronize()
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "launches": read_counts(), "s": time.perf_counter() - t,
           "grads": _grads(model.named_parameters())}
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def _tp_run(cfg, dev, m=None) -> dict:
    """The plain model's SGD step on the whole batch: in one process
    (``m`` None), or with its big weights split over ``m``'s ``model``
    axis (each rank the whole batch; its pieces' gradients)."""
    import torch

    from aicity_action_tpu_torch.engine.steps import make_train_step
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.parallel import tp as ptp
    from aicity_action_tpu_torch.solver.optimizer import construct_optimizer

    model = build_model(cfg, device=dev, seed=SEED)
    x, y = _par_batch(cfg, PAR_BATCH, dev)
    kw = dict(num_classes=cfg.MODEL.NUM_CLASSES, seed=SEED)
    if m is None:
        owner = model
        opt = construct_optimizer(cfg, model, 100)
        step = make_train_step(model, opt, cfg.MODEL.LOSS_FUNC, **kw)
    else:
        owner = ptp.TensorParallel(model, m)
        opt = construct_optimizer(cfg, owner, 100)
        opt.norm_fn = owner.grad_norm
        step = ptp.make_tp_train_step(owner, opt, cfg.MODEL.LOSS_FUNC, **kw)
    reset_counts()
    t = time.perf_counter()
    metrics, _ = step({"inputs": x, "labels": y})
    torch.cuda.synchronize()
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "launches": read_counts(), "s": time.perf_counter() - t,
           "grads": _grads(owner.named_parameters())}
    if m is not None:
        out["split"] = dict(owner.dims)
        out["at_rest"] = {n: p.numel() for n, p in owner.whole.items()}
    del model, opt, step, owner
    torch.cuda.empty_cache()
    return out


def _sp_run(cfg, dev, m=None) -> dict:
    """The plain model's batch-1 eval logits: dense (``m`` None) or with
    the T frames sharded over ``m``'s ``sp`` axis."""
    import torch

    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.parallel import sp_model

    model = build_model(cfg, device=dev, seed=SEED)
    x, _ = _par_batch(cfg, 1, dev)
    reset_counts()
    t = time.perf_counter()
    with torch.no_grad():
        logits = (sp_model.sp_apply(model, x, m, "sp", shard_axis="t")
                  if m is not None else
                  sp_model.sp_forward(model, x, None, None))
    torch.cuda.synchronize()
    out = {"logits": logits.float().cpu(), "launches": read_counts(),
           "s": time.perf_counter() - t, "depth": len(model.blocks),
           "plan": sp_model.plan_sp_blocks(model.spec, 2, "t")}
    del model
    torch.cuda.empty_cache()
    return out


def _par_worker(rank: int, init: str, d: str, device: str,
                backend: str) -> None:
    """One of the phase's two ranks (spawned), both on ``device``: EP, SP
    and TP in turn, each on its own mesh, its launches counted alone."""
    import torch

    sys.path.insert(0, _REPO)
    from aicity_action_tpu_torch.parallel import mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
    moe, plain = _par_cfgs()
    cfg0 = plain.clone()
    cfg0.NUM_GPUS, cfg0.DIST_BACKEND, cfg0.INIT_METHOD = 2, backend, init
    mesh.init_distributed(cfg0, rank, device=dev)
    out = {"ep": _ep_run(moe, dev, mesh.Mesh((2,), ("ep",))),
           "sp": _sp_run(plain, dev, mesh.Mesh((2,), ("sp",))),
           "tp": _tp_run(plain, dev, mesh.Mesh((1, 2), ("data", "model")))}
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    mesh.destroy()


def _hold_step(label: str, got: dict, ref: dict, pieces=None) -> dict:
    """A parallel step against the one-process step: the loss (GATE_LOSS),
    the gradient norm (GATE_NORM) and every leaf's gradient (GATE_LEAF
    relative L2; ``pieces(name, want)`` gives the part of the
    one-process gradient this rank holds)."""
    for key, gate in (("loss", GATE_LOSS), ("grad_norm", GATE_NORM)):
        err = abs(got[key] - ref[key]) / abs(ref[key])
        if not (np.isfinite(got[key]) and err <= gate):
            _fail(f"{label}: {key} {got[key]} vs one process {ref[key]}")
    want = ref["grads"]
    if pieces is not None:
        want = {n: pieces(n, g) for n, g in want.items()}
    if set(got["grads"]) != set(want):
        _fail(f"{label}: leaves {sorted(set(got['grads']) ^ set(want))}")
    errs = {n: _leaf_rel(got["grads"], want, n) for n in want}
    worst = max(errs, key=errs.get)
    if not errs[worst] <= GATE_LEAF:
        _fail(f"{label}: {worst} off by {errs[worst]:.3e} relative L2 "
              f"(gate {GATE_LEAF})")
    return {"loss": got["loss"], "ref_loss": ref["loss"],
            "grad_norm": got["grad_norm"], "ref_grad_norm": ref["grad_norm"],
            "worst_leaf": worst, "worst_leaf_rel_l2": errs[worst],
            "median_leaf": float(np.median(list(errs.values()))),
            "leaves": len(errs)}


def parallel_checks(card: str) -> dict:
    """Two gloo ranks on the one card (one ``mp.spawn``) at full width,
    each path held to its one-process run in this process: EP, the MoE
    model's SGD step with each rank 4 of the 8 experts of every bank and 1
    of 2 clips (loss, gradient norm and every leaf, a rank's expert slices
    against the same rows of the one-process gradient; the train-step
    rows on each rank); SP, one clip scored with the T frames split 2-way
    through all 16 blocks (the logits against the dense forward's; the
    eval rows on each rank's shard); TP, the plain model's SGD step on 2
    clips with qkv / fc1 split on their outputs and the attention proj /
    fc2 on their inputs (each rank's pieces' gradients against the
    one-process gradient's; the train-step rows on the gathered weights).
    Gates of the two-rank phase: loss 1e-2, gradient norm 2e-2, each leaf
    5e-2 relative L2; logits 5e-2 relative L2 and 1e-2 on the
    softmax."""
    import torch
    import torch.multiprocessing as mp

    from aicity_action_tpu_torch.models.mvit import MViT, build_mvit_spec

    moe, plain = _par_cfgs()
    dev = torch.device(PAR_DEVICE)
    refs = {"ep": _ep_run(moe, dev), "sp": _sp_run(plain, dev),
            "tp": _tp_run(plain, dev)}
    with torch.device("meta"):  # the blocks the counts derive from
        shapes = {name: MViT(build_mvit_spec(cfg))
                  for name, cfg in (("ep", moe), ("tp", plain))}
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_par_worker, args=(f"tcp://localhost:{_free_port()}", d,
                                    PAR_DEVICE, PAR_BACKEND),
                 nprocs=2, join=True)
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"))
                 for r in range(2)]
    spawn_s = time.perf_counter() - t
    report = {"spawn_s": spawn_s}
    train_want = {k: derived_counts(shapes[k], train=True)
                  for k in ("ep", "tp")}
    eval_want = derived_counts(shapes["tp"], train=False)
    for r, res in enumerate(ranks):
        for path, want in (("ep", train_want["ep"]),
                           ("tp", train_want["tp"]), ("sp", eval_want)):
            if res[path]["launches"] != want:
                _fail(f"{path.upper()} rank {r}: launches "
                      f"{res[path]['launches']} != {want}")

        def expert_rows(n, g, r=r):
            bank = n.rsplit(".", 1)[-1] in ("fc1_weight", "fc1_bias",
                                            "fc2_weight", "fc2_bias")
            return g.chunk(2, 0)[r] if bank else g

        def tp_piece(n, g, r=r, split=res["tp"]["split"]):
            return g.chunk(2, split[n])[r] if n in split else g

        report[f"ep rank {r}"] = _hold_step(
            f"EP rank {r}", res["ep"], refs["ep"], expert_rows)
        report[f"tp rank {r}"] = _hold_step(
            f"TP rank {r}", res["tp"], refs["tp"], tp_piece)
        lg, lw = res["sp"]["logits"], refs["sp"]["logits"]
        rel = _rel(lg, lw)
        soft = (lg.softmax(-1) - lw.softmax(-1)).abs().max().item()
        if not (rel <= GATE_LEAF and soft <= 1e-2):
            _fail(f"SP rank {r}: logits {rel:.3e} relative L2, softmax "
                  f"{soft:.3e} from the dense forward's")
        report[f"sp rank {r}"] = {"logits_rel_l2": rel,
                                  "softmax_max_err": soft,
                                  "plan": res["sp"]["plan"]}
        depth = res["sp"]["depth"]
        if res["sp"]["plan"] != depth or \
                len(res["tp"]["at_rest"]) != 4 * depth or \
                any(res["tp"]["at_rest"].values()):
            _fail(f"rank {r}: SP planned {res['sp']['plan']} sharded "
                  f"blocks; TP split {len(res['tp']['at_rest'])} weights")
    report["launches"] = {path: {k: sum(rk[path]["launches"][k]
                                        for rk in ranks)
                                 for k in ranks[0][path]["launches"]}
                          for path in ("ep", "sp", "tp")}
    for path in ("ep", "tp"):
        a, b = report[f"{path} rank 0"], report[f"{path} rank 1"]
        print(f"# {path.upper()}, two gloo ranks on one card ({card}): loss "
              f"{a['loss']:.6f} / {b['loss']:.6f} vs one process "
              f"{a['ref_loss']:.6f}, grad norm {a['grad_norm']:.6f} / "
              f"{b['grad_norm']:.6f} vs {a['ref_grad_norm']:.6f}; worst "
              f"leaf {a['worst_leaf']} {a['worst_leaf_rel_l2']:.3e} / "
              f"{b['worst_leaf']} {b['worst_leaf_rel_l2']:.3e} (gate "
              f"{GATE_LEAF}), median {a['median_leaf']:.3e}; step "
              f"{ranks[0][path]['s']:.2f} / {ranks[1][path]['s']:.2f} s "
              f"(one process {refs[path]['s']:.2f} s); launches a rank "
              f"{ranks[0][path]['launches']}")
    print(f"# SP, T frames 2-way, two gloo ranks ({card}): logits "
          f"{report['sp rank 0']['logits_rel_l2']:.3e} / "
          f"{report['sp rank 1']['logits_rel_l2']:.3e} relative L2, softmax "
          f"{report['sp rank 0']['softmax_max_err']:.3e} from the dense "
          f"forward; {ranks[0]['sp']['plan']} of {ranks[0]['sp']['depth']} "
          f"blocks sharded; forward "
          f"{ranks[0]['sp']['s']:.2f} / {ranks[1]['sp']['s']:.2f} s (dense "
          f"{refs['sp']['s']:.2f} s); launches a rank "
          f"{ranks[0]['sp']['launches']}; spawned ranks {spawn_s:.1f} s")
    return report


# ------------------------------------------------------ pipeline, one card

PP_DEVICE = "cuda"
PP_CFG = "mvitv2_b_16x4_448_cfg"  # the config factory of the phase
PP_BATCH, PP_MICROBATCHES = 4, 4


def pipeline_counts(model, ranges, microbatches: int) -> dict:
    """Launches of one ``MViTPipeline.loss_and_grads`` over the stages'
    block ``ranges``: each microbatch runs every forward and backward of
    the train step once (the drain), and the forwards of every stage but
    the last once more (the fill, whose last stage's input is all it
    keeps)."""
    once = derived_counts(model, True, remat=1)
    fill = derived_counts(model, True, remat=1,
                          blocks=range(ranges[-1][0]), final_norm=False)
    return {k: microbatches * (v + (0 if k.endswith("_bwd") else fill[k]))
            for k, v in once.items()}


def pp_checks(card: str) -> dict:
    """``MViTPipeline`` at full width: MViT-v2-B @448 (seed 0, bf16, no
    DropPath or dropout, which the plain step draws otherwise) in 2
    FLOP-balanced stages on the one card, 4 microbatches of a batch of 4:
    the loss, gradient norm and every leaf's gradient against the plain
    forward and backward on the whole batch (the two-rank phase's gates);
    its launches equal 4 microbatches of the train-step rows with every
    stage's forward but the last run twice (the fill, then the recompute
    under autograd; the last stage runs in the drain alone)."""
    import torch
    import torch.nn.functional as F

    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.parallel import pp
    from aicity_action_tpu_torch.solver.optimizer import global_norm

    cfg = _factory(PP_CFG)()
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.MODEL.DROPOUT_RATE = 0.0
    dev = torch.device(PP_DEVICE)
    x, y = _par_batch(cfg, PP_BATCH, dev)
    plain = build_model(cfg, device=dev, seed=SEED).train()
    loss = F.cross_entropy(plain(x).float(), y.long())
    loss.backward()
    params = list(plain.parameters())
    ref = {"loss": loss.item(), "grad_norm": global_norm(params).item(),
           "grads": _grads(plain.named_parameters())}
    del plain, params, loss
    torch.cuda.empty_cache()
    model = build_model(cfg, device=dev, seed=SEED)
    pipe = pp.MViTPipeline(model, [dev, dev])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    loss = pipe.loss_and_grads(x, y, PP_MICROBATCHES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = pipeline_counts(model, pipe.ranges, PP_MICROBATCHES)
    if launches != want:
        _fail(f"PP: launches {launches} != {want}")
    got = {"loss": float(loss),
           "grad_norm": float(global_norm(list(model.parameters()))),
           "grads": _grads(model.named_parameters())}
    report = _hold_step("PP", got, ref)
    report.update(ranges=pipe.ranges, seconds=wall, peak_mem_bytes=peak,
                  launches=launches)
    print(f"# PP, 2 stages {pipe.ranges} on one card, {PP_MICROBATCHES} "
          f"microbatches of a batch of {PP_BATCH} ({card}): loss "
          f"{got['loss']:.6f} vs plain {ref['loss']:.6f}, grad norm "
          f"{got['grad_norm']:.6f} vs {ref['grad_norm']:.6f}; worst leaf "
          f"{report['worst_leaf']} {report['worst_leaf_rel_l2']:.3e} (gate "
          f"{GATE_LEAF}), median {report['median_leaf']:.3e}; "
          f"loss_and_grads {wall:.2f} s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB; launches {launches}")
    del model, pipe
    torch.cuda.empty_cache()
    return report


# ------------------------------------------- long-cycle multigrid, SlowOnly

MG_DEVICE = "cuda"
MG_CFG = "slow_8x8_r50_cfg"  # the config factory of the phase


def slow_8x8_r50_cfg():
    """SlowOnly R50 8x8 (PySlowFast's Kinetics-400 ``SLOW_8x8_R50.yaml``):
    the slow pathway alone, 8 frames at sampling rate 8, crop 224, DEPTH
    50, WIDTH_PER_GROUP 64, dropout 0.5, bf16."""
    from aicity_action_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME, cfg.MODEL.ARCH = "ResNet", "slow"
    cfg.MODEL.NUM_CLASSES = 400
    cfg.MODEL.LOSS_FUNC = "cross_entropy"
    cfg.MODEL.DROPOUT_RATE = 0.5
    cfg.DATA.NUM_FRAMES, cfg.DATA.SAMPLING_RATE = 8, 8
    cfg.DATA.TRAIN_JITTER_SCALES = [256, 320]
    cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.TEST_CROP_SIZE = 224, 256
    cfg.DATA.INPUT_CHANNEL_NUM = [3]
    cfg.RESNET.DEPTH, cfg.RESNET.WIDTH_PER_GROUP = 50, 64
    cfg.RESNET.ZERO_INIT_FINAL_BN = True
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[3], [4], [6], [3]]
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    return cfg


def multigrid_checks(card: str, d: str) -> dict:
    """Long-cycle multigrid through ``run_net`` on SlowOnly R50 8x8 over
    the loop's views, the factors of the JAX package's driver test
    ((T/2, S) then (T, S) a step, BN_BASE_SIZE 4): batch 8 of 4 frames
    (sub-BatchNorm of 2 splits) then batch 4 of 8 frames (BatchNorm), the
    model rebuilt at the change with its weights carried and the step
    count kept; finite losses, no kernel row launched."""
    import torch

    from aicity_action_tpu_torch.engine import train_loop
    from aicity_action_tpu_torch.tools import run_net
    from aicity_action_tpu_torch.utils.multigrid import MultigridSchedule

    cfg = _factory(MG_CFG)()
    cfg.NUM_GPUS = 1
    cfg.TRAIN.BATCH_SIZE, cfg.TEST.BATCH_SIZE = 4, 8
    cfg.DATA.PATH_TO_DATA_DIR = cfg.DATA.PATH_PREFIX = d
    cfg.OUTPUT_DIR = os.path.join(d, "mg_out")
    cfg.TRAIN.EVAL_PERIOD = cfg.TRAIN.CHECKPOINT_PERIOD = 100
    cfg.TRAIN.AUTO_RESUME, cfg.TEST.ENABLE = False, False
    cfg.BN.USE_PRECISE_STATS = False
    cfg.DATA_LOADER.NUM_WORKERS = 4
    cfg.SOLVER.OPTIMIZING_METHOD, cfg.SOLVER.MOMENTUM = "sgd", 0.9
    cfg.SOLVER.BASE_LR, cfg.SOLVER.LR_POLICY = 0.01, "steps_with_relative_lrs"
    cfg.SOLVER.STEPS, cfg.SOLVER.LRS = [0, 2, 4], [1.0, 0.1]
    cfg.SOLVER.GAMMA = 0.1
    cfg.SOLVER.MAX_EPOCH, cfg.SOLVER.WARMUP_EPOCHS = 4, 0.0
    cfg.MULTIGRID.LONG_CYCLE, cfg.MULTIGRID.EPOCH_FACTOR = True, 1.0
    cfg.MULTIGRID.LONG_CYCLE_FACTORS = [[0.5, 1.0], [1.0, 1.0]]
    cfg.MULTIGRID.BN_BASE_SIZE = 4
    cfg.RNG_SEED, cfg.LOG_CFG = SEED, False
    path = os.path.join(d, "slow_8x8_r50_multigrid.yaml")
    with open(path, "w") as f:
        f.write(cfg.dump())
    sched, c = MultigridSchedule(), cfg.clone()
    c = sched.init_multigrid(c)
    c, _ = sched.update_long_cycle(c, 0)
    first = (c.TRAIN.BATCH_SIZE, c.DATA.NUM_FRAMES, c.BN.NORM_TYPE)
    want = []  # the schedule's shape changes
    for epoch in range(c.SOLVER.MAX_EPOCH):
        c, changed = sched.update_long_cycle(c, epoch)
        if changed:
            want.append((c.TRAIN.BATCH_SIZE, c.DATA.NUM_FRAMES,
                         c.BN.NORM_TYPE))
    shapes = []
    real = train_loop._long_cycle_rebuild

    def rebuild(c, old_model, old_opt, dev):
        before = {k: v.float().clone() for k, v in
                  old_model.state_dict().items()}
        count = old_opt.count
        model, opt, loader = real(c, old_model, old_opt, dev)
        after = model.state_dict()
        kept = sum(1 for k, v in before.items() if k in after and
                   after[k].shape == v.shape and
                   torch.equal(after[k].float(), v))
        shapes.append({"batch": loader.batch_size,
                       "frames": c.DATA.NUM_FRAMES, "norm": c.BN.NORM_TYPE,
                       "splits": c.BN.NUM_SPLITS,
                       "steps": (count, opt.count), "kept": kept,
                       "params": len(list(model.parameters()))})
        return model, opt, loader

    train_loop._long_cycle_rebuild = rebuild
    reset_counts()
    t = time.perf_counter()
    try:
        res = run_net.main(["--cfg", path, "--device", MG_DEVICE])
    finally:
        train_loop._long_cycle_rebuild = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_counts()
    run = res["train"]
    losses = [e["losses"] for e in run.epochs]
    steps = [len(e) for e in losses]
    if any(launches.values()):
        _fail(f"multigrid: a kernel row launched on SlowOnly: {launches}")
    if [(s["batch"], s["frames"], s["norm"]) for s in shapes] != want or \
            len({(s["batch"], s["frames"]) for s in shapes} | {first[:2]}) \
            != 2 or any(s["steps"][0] != s["steps"][1] or
                        s["kept"] < s["params"] for s in shapes) or \
            not np.isfinite(sum(losses, [])).all() or \
            len(steps) != c.SOLVER.MAX_EPOCH or \
            run.optimizer.count != sum(steps):
        _fail(f"multigrid: shape changes {shapes} (the schedule's {want}), "
              f"steps {steps}, losses {losses}")
    print(f"# long-cycle multigrid, SlowOnly R50 8x8 via run_net ({card}): "
          f"epochs {len(run.epochs)} (MAX_EPOCH from the schedule), steps "
          f"per epoch {steps}, start {first}, rebuilds {shapes}; losses "
          f"{losses}; epoch walls "
          f"{[round(e['wall_s'], 3) for e in run.epochs]} s; run "
          f"{wall:.1f} s; no kernel row launched")
    del res, run
    torch.cuda.empty_cache()
    return {"steps_per_epoch": steps, "rebuilds": shapes, "losses": losses,
            "seconds": wall}


# ------------------------------------------------ MViT-v2-L widths @448

L_CFG = "mvitv2_l_16x4_448_cfg"  # the config factory of the phase
L_DEVICE = "cuda"
# the blocks whose calls the kernel checks take: the first, the three where
# the widths double and the last
L_BLOCKS = (0, 2, 8, 44, 47)
L_VIEW_FRAMES = 96  # the phase's written view: three windows, one forward
# the wrappers whose kernels this phase widens (PERF.md rows 8, 5, 10, 12
# and 1)
L_FNS = ("fused_ln_qkv", "flash_attention_ln", "fused_ln_mlp",
         "fused_layer_norm", "flash_attention")


def l_overrides() -> list:
    """The command-line overrides that make the AI City YAML the L config
    (``config.defaults.MVITV2_L_TRUNK``)."""
    from aicity_action_tpu_torch.config.defaults import MVITV2_L_TRUNK

    return [a for key, value in MVITV2_L_TRUNK.items()
            for a in (f"MVIT.{key}", str(value))]


def _l_block_calls(cfg, batch: int) -> dict:
    """Block -> (its fused_ln_qkv call, its attention call, its LN+MLP call
    or None), from the call-shape functions, for each of L_BLOCKS."""
    from aicity_action_tpu_torch.models.mvit import (attention_call_shapes,
                                                    dense_call_shapes)

    per_block = []
    for call in dense_call_shapes(cfg, batch):
        if call[0] == "qkv":
            per_block.append([call, None])
        else:
            per_block[-1][1] = call
    att = attention_call_shapes(cfg, batch)
    return {i: (per_block[i][0], att[i], per_block[i][1]) for i in L_BLOCKS}


def l_kernel_checks(cfg) -> dict:
    """The widened kernels at the L path's batch-8 shapes, each against its
    plain version and timed beside its library yardstick: at the blocks of
    L_BLOCKS, LN+qkv (row 8; each distinct shape once), the fused-LN
    attention (row 5, head dim 72), the lse-free flash attention of the
    unfused path (row 1, token rows, the plain version in f32) and LN+MLP
    (row 10; each width once); the rows LayerNorm (row 12) at the final
    norm [B*1568, 1152] and at block 0's q pool norm of the unfused path
    (head dim 72)."""
    import torch
    import torch.nn.functional as F

    from aicity_action_tpu_torch.ops import flash_attention as fa
    from aicity_action_tpu_torch.ops import layer_norm as ln

    bf = torch.bfloat16
    gen = torch.Generator(device=L_DEVICE).manual_seed(SEED + 90)
    res = {name: [] for name in L_FNS}
    seen = set()
    for blk, (qkv, (G, Lq, Lk, d), mlp) in _l_block_calls(
            cfg, BATCH).items():
        _, M, L, D, C = qkv
        if qkv not in seen:
            seen.add(qkv)
            res["fused_ln_qkv"].append(_qkv_case(
                gen, f"L block {blk} x[{M},{D}] w[{3 * C},{D}] -> [B,C,L]",
                M, L, D, C))
        shape = f"L block {blk} q[{G},{Lq},{d}] k,v[{G},{Lk},{d}]"
        res["flash_attention_ln"].append(_attn_ln_case(
            gen, shape + " d-major", G, Lq, Lk, d))
        q, k, v = (_normal(gen, (G, n, d), 1.0, bf) for n in (Lq, Lk, Lk))
        scale = d ** -0.5
        r = _check_case(
            "flash_attention",
            lambda: fa.flash_attention_fwd(q, k, v, scale, False)[0],
            lambda: fa.flash_attention_plain(q.float(), k.float(),
                                             v.float(), scale),
            lambda: _sdpa(q, k, v),
            flops=4 * G * Lq * Lk * d,
            nbytes=2 * (2 * G * Lq * d + 2 * G * Lk * d),
            peak=PEAK_BF16, iters=3)
        r["shape"] = shape + " (no lse)"
        res["flash_attention"].append(_mark_fwd(r, G, Lq, Lk, d))
        del q, k, v
        if mlp is not None and mlp not in seen:
            seen.add(mlp)
            _, Mm, Cm, H = mlp
            res["fused_ln_mlp"].append(_mlp_case(
                gen, f"L block {blk} x[{Mm},{Cm}] H {H}", Mm, Cm))
        torch.cuda.empty_cache()
    h0, L0 = cfg.MVIT.NUM_HEADS, _l_block_calls(cfg, 1)[0][1][1]
    for what, M, C, eps in (
            ("L final norm (batch 8)", BATCH * 1568, 1152, 1e-6),
            ("L block 0 q pool norm, head dim 72 (unfused path)",
             BATCH * h0 * L0, 72, 1e-5)):
        x = _normal(gen, (M, C), 2.0, bf)
        g = _normal(gen, (C,), 0.1, bf) + 1
        bb = _normal(gen, (C,), 0.1, bf)
        r = _check_case(
            "fused_layer_norm",
            lambda: ln.fused_layer_norm(x, g, bb, eps, 1),
            lambda: ln.layer_norm_plain(x, g, bb, eps, 1),
            lambda: F.layer_norm(x, (C,), g, bb, eps),
            flops=8 * M * C, nbytes=2 * (2 * M * C + 2 * C),
            peak=PEAK_F32, iters=50)
        r["shape"] = f"{what} x[{M},{C}] (rows)"
        res["fused_layer_norm"].append(r)
        del x
    torch.cuda.empty_cache()
    return res


def l_model_checks(card: str, d: str) -> dict:
    """The L model at full width and depth (48 blocks, seed 0, bf16): the
    batch-8 eval forward through ``make_eval_step`` with its launches held
    to ``derived_counts`` (rows 8, 5 and 10 once a block, row 12 once), its
    time and peak memory, its scores and head input against the same
    weights' plain f32 forward on the card (batch 8); the same forward
    with ``AICITY_TPU_FUSE_ATTN_LN=0`` (row 1 and the head-dim-72 pool
    norms) with its launches and its scores against the fused path's;
    then ``run_temporal_inf`` with the L overrides on the command line on
    a short written view, its launches held to ``derived_counts`` times
    its forwards and its pickle to ``WindowScorer.score_video`` of the
    same weights."""
    import torch

    from aicity_action_tpu_torch.data.decoder import write_y4m
    from aicity_action_tpu_torch.engine.steps import make_eval_step
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.ops import kernels
    from aicity_action_tpu_torch.pipeline.window_inference import (
        WindowDataset, WindowScorer, load_window_predictions)
    from aicity_action_tpu_torch.tools import run_temporal_inf

    cfg = _factory(L_CFG)()
    model = build_model(cfg, device=L_DEVICE, seed=SEED)
    params = sum(p.numel() for p in model.parameters())
    depth = len(model.blocks)
    eval_step = make_eval_step(model)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    gen = torch.Generator(device=L_DEVICE).manual_seed(SEED + 91)
    x = _normal(gen, (BATCH, T, S, S, 3), device=L_DEVICE)
    feats = []
    hook = model.head.register_forward_hook(
        lambda mod, inp, outp: feats.append(inp[0].float()))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = eval_step({"inputs": x})
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    hook.remove()
    want = derived_counts(model, train=False)
    rows = {"fused_ln_qkv": depth, "flash_attention_ln": depth,
            "fused_ln_mlp": depth, "fused_layer_norm": 1}
    if counts != want or any(want[k] != n for k, n in rows.items()):
        _fail(f"MViT-v2-L @448: launches per forward {counts} != {want} "
              f"(rows 8 / 5 / 10 / 12 must be {rows})")
    if out.shape != (BATCH, cfg.MODEL.NUM_CLASSES) or \
            not torch.isfinite(out).all():
        _fail("MViT-v2-L @448 batch-8 forward: non-finite or mis-shaped "
              "scores")
    ms = time_ms(lambda: eval_step({"inputs": x}), iters=5)

    f32 = cfg.clone()
    f32.TPU.COMPUTE_DTYPE = "float32"
    plain = build_model(f32, device=L_DEVICE, seed=SEED)
    hook = plain.head.register_forward_hook(
        lambda mod, inp, outp: feats.append(inp[0].float()))
    t = time.perf_counter()
    with kernels.plain_reference(), torch.no_grad():
        out_p = plain.eval()(x.float())
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    hook.remove()
    del plain
    feat_err = ((feats[0] - feats[1]).norm() / feats[1].norm()).item()
    score_err = (out.float() - out_p).abs().max().item()
    print(f"# MViT-v2-L 16x4 @448 ({card}; {depth} blocks, {params} "
          f"parameters, seed {SEED}): batch-{BATCH} forward {ms:.2f} ms, "
          f"{BATCH / ms * 1e3:.2f} clips/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB; launches {counts}; kernels (bf16) vs "
          f"the plain f32 forward (batch {BATCH}, {plain_s:.1f} s): max "
          f"|score error| {score_err:.3e} (tol 1e-2), head-input relative "
          f"L2 {feat_err:.3e} (tol 5e-2)")
    if not (score_err <= 1e-2 and feat_err <= 5e-2):
        _fail("MViT-v2-L @448: the kernel forward disagrees with the plain "
              "f32 forward")

    with fuse_switch("0"):
        reset_counts()
        out0 = eval_step({"inputs": x})
        torch.cuda.synchronize()
        counts0 = read_counts()
        want0 = derived_counts(model, train=False)
        if counts0 != want0 or want0["flash_attention"] != depth:
            _fail(f"MViT-v2-L unfused: launches per forward {counts0} != "
                  f"{want0}")
        ms0 = time_ms(lambda: eval_step({"inputs": x}), iters=3)
    err0 = (out0 - out).abs().max().item()
    print(f"# MViT-v2-L 16x4 @448 with AICITY_TPU_FUSE_ATTN_LN=0 ({card}): "
          f"batch-{BATCH} forward {ms0:.2f} ms, "
          f"{BATCH / ms0 * 1e3:.2f} clips/s; max |score - fused path's| "
          f"{err0:.3e} (tol 1e-2); launches {counts0}")
    if not err0 <= 1e-2:
        _fail("MViT-v2-L: the unfused eval disagrees with the fused one")
    del x, out, out0, out_p, feats
    torch.cuda.empty_cache()

    stem = f"Dashboard_user_id_{CHAIN_USER}_NoAudio_0"
    path = os.path.join(d, f"{stem}.y4m")
    write_y4m(path, _view_frames(L_VIEW_FRAMES, SEED + 92))
    lst = os.path.join(d, "videos.txt")
    with open(lst, "w") as f:
        f.write(f"{stem}.y4m\n")
    pkl = os.path.join(d, "pkl")
    argv = ["--cfg", CHAIN_CFG, "--video_lst", lst, "--video_path", d,
            "--out_dir", pkl, "--frame_length", str(T), "--frame_size",
            str(S), "--batch_size", str(BATCH), "--num_workers", "2",
            "--device", L_DEVICE, "RNG_SEED", str(SEED), "NUM_GPUS", "1",
            *l_overrides()]
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run = run_temporal_inf.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_counts()
    forwards = sum(r["timers"]["calls"] for r in run.values())
    want = {k: v * forwards for k, v in derived_counts(model, False).items()}
    if not forwards or launches != want:
        _fail(f"MViT-v2-L run_temporal_inf: launches {launches} != "
              f"derived_counts x {forwards} forwards {want}")
    kw = dict(frame_length=T, frame_stride=4, proposal_stride=16,
              frame_size=S, target_fps=cfg.DATA.TARGET_FPS,
              mean=cfg.DATA.MEAN, std=cfg.DATA.STD)
    preds = load_window_predictions(os.path.join(pkl, f"{stem}.pkl"))
    ds = WindowDataset(path, **kw)
    ref = WindowScorer(model, batch_size=BATCH,
                       num_workers=2).score_video(ds)
    scores = np.stack([p[2] for p in preds])
    if [p[:2] for p in preds] != [p[:2] for p in ref] or \
            not np.isfinite(scores).all() or \
            scores.shape != (len(ds.windows), cfg.MODEL.NUM_CLASSES):
        _fail("MViT-v2-L run_temporal_inf: wrong windows or scores")
    pickle_err = float(np.abs(scores - np.stack([p[2] for p in ref])).max())
    print(f"# MViT-v2-L run_temporal_inf ({card}): {len(preds)} windows of "
          f"a {L_VIEW_FRAMES}-frame 960x540 view in {wall:.2f} s "
          f"({forwards} forwards), pickle vs score_video max error "
          f"{pickle_err:.2e} (tol 1e-6); launches {launches}")
    if not pickle_err <= 1e-6:
        _fail(f"MViT-v2-L: the CLI's pickle differs from score_video: "
              f"{pickle_err}")
    del model, eval_step
    torch.cuda.empty_cache()
    return {"params": params, "forward_ms": ms,
            "clips_per_s": BATCH / ms * 1e3, "peak_mem_bytes": peak,
            "score_err_f32": score_err, "feat_rel_err_f32": feat_err,
            "plain_f32_s": plain_s, "launches_per_forward": counts,
            "unfused": {"forward_ms": ms0, "clips_per_s": BATCH / ms0 * 1e3,
                        "score_err_vs_fused": err0,
                        "launches_per_forward": counts0},
            "run_temporal_inf": {"windows": len(preds), "seconds": wall,
                                 "forwards": forwards,
                                 "pickle_err": pickle_err,
                                 "launches": launches}}


# ------------------------------------------- MViT-v2-L training @448

# the L train step's kernel rows that this phase holds at its shapes (PERF.md
# rows 2 and 3, the attention with its logsumexp and its backward at head
# dim 72; 9 and 11, the LN+qkv and LN+MLP backwards at 144-1152 channels;
# 13, the rows LayerNorm backward over 72 and 1152 channels)
L_TRAIN_FNS = ("flash_attention", "flash_attention_bwd", "fused_ln_qkv_bwd",
               "fused_ln_mlp_bwd", "fused_layer_norm_bwd")
# the L b1 gradient gate holds every leaf against the plain f32 step, with
# bf16's own distance from it the largest of this many plain bf16 draws
# (two_rank_checks' rule). Through 48 blocks one draw is as noisy as the
# error it bounds (batch 1, seed 0, NVIDIA H100 80GB HBM3, 700 W, PERF.md
# PR 19): under the bf16-rounding rule block 1's q pool norm scale sat at
# 1.006-1.057 of its bound (6.08e-2 against the plain reference's own
# 6.05e-2), under the f32 rule with one draw block 35's k pool norm scale
# at 0.97-1.02 (5.0e-2 from f32 against 1.5 x 3.3-3.5e-2), the draw moving
# from call to call with the convolutions' unordered backward sums; the
# d-72 kernels give the d-96 kernels' results on zero-padded inputs bit
# for bit, and the median leaf sits as far from f32 as the plain bf16
# reference's (9.5e-3 against 9.8e-3)
L_GRAD_DRAWS = 3
# the row-4 backward's head-dim-72 case: G = 16 groups (L at batch 8, two
# heads) at the odd lengths 1 + T*H*W of a cls-token model's block
L_PADDED_SHAPE = (16, 6273, 1569, 72)


def _distinct(calls) -> dict:
    """``(call, block)`` pairs -> call: (its first block, its calls a
    step), in block order."""
    out: dict = {}
    for call, i in calls:
        blk, n = out.get(call, (i, 0))
        out[call] = (blk, n + 1)
    return out


def _blocks(blk: int, calls: int) -> str:
    return (f"block {blk}" if calls == 1 else
            f"blocks from {blk} ({calls} calls a step)")


def head_dim_72_identity_checks(cfg) -> None:
    """The attention forward with its logsumexp and the backward at head
    dim 72 against the d-96 kernels on the same inputs zero-padded to 96
    columns, at the L b4 step's first and most-launched shapes: the d-72
    kernels run the d-96 tiles over columns TMA fills with zeros, so out,
    lse, dq, dk and dv must equal the d-96 kernels' first 72 columns bit
    for bit (and the d-96 kernels' padded columns be zero)."""
    import torch
    import torch.nn.functional as F

    from aicity_action_tpu_torch.models.mvit import attention_call_shapes
    from aicity_action_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=L_DEVICE).manual_seed(SEED + 95)
    calls = _distinct((c, i) for i, c in enumerate(
        attention_call_shapes(cfg, TRAIN_BATCH)))
    shapes = [next(iter(calls)), max(calls, key=lambda c: calls[c][1])]
    for G, Lq, Lk, d in shapes:
        q, k, v, dout = (_normal(gen, (G, n, d), 1.0, torch.bfloat16)
                         for n in (Lq, Lk, Lk, Lq))
        s = d ** -0.5

        def pad(t):
            return F.pad(t, (0, fa.KERNEL_HEAD_DIM - d)).contiguous()

        o, lse = fa.flash_attention_fwd(q, k, v, s, True)
        o96, lse96 = fa.flash_attention_fwd(pad(q), pad(k), pad(v), s, True)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, dout, s)
        grads96 = fa.flash_attention_bwd(pad(q), pad(k), pad(v), o96, lse96,
                                         pad(dout), s)
        torch.cuda.synchronize()
        same = torch.equal(lse, lse96) and all(
            torch.equal(a, b[..., :d]) and not b[..., d:].any()
            for a, b in zip((o, *grads), (o96, *grads96)))
        print(f"# head dim {d} against the d-96 kernels on zero-padded "
              f"inputs, q[{G},{Lq},{d}] k,v[{G},{Lk},{d}]: out, lse, dq, "
              f"dk, dv bit-equal {same}")
        if not same:
            _fail(f"the attention kernels at head dim {d} differ from the "
                  f"d-96 kernels on zero-padded inputs at q[{G},{Lq},{d}]")
        del q, k, v, dout, o, lse, o96, lse96, grads, grads96
    torch.cuda.empty_cache()


def l_train_kernel_checks(cfg) -> dict:
    """Rows 2, 3, 9, 11 and 13 at every distinct call of the L batch-4
    train step on the default switch (the unfused attention), each against
    its plain version computed in f32 from the same bf16 inputs and
    differentiated by autograd, and timed beside its library yardstick
    (plain and library times of forward + backward for the backwards): the
    attention forward with its logsumexp and its backward on head-major
    token rows of head dim 72 (``attention_call_shapes``), the LN+qkv and
    LN+MLP backwards (``dense_call_shapes``: D 144-1152, C 144-1152, H
    576-4608), the rows LayerNorm backward at each pool norm's rows (head
    dim 72; ``pool_norm_call_shapes``) and the final norm [B*1568, 1152]."""
    import torch
    import torch.nn.functional as F

    from aicity_action_tpu_torch.models.mvit import (attention_call_shapes,
                                                    build_mvit_spec,
                                                    dense_call_shapes,
                                                    pool_norm_call_shapes)
    from aicity_action_tpu_torch.ops import flash_attention as fa
    from aicity_action_tpu_torch.ops import layer_norm as ln

    bf = torch.bfloat16
    gen = torch.Generator(device=L_DEVICE).manual_seed(SEED + 93)
    B = TRAIN_BATCH
    res = {name: [] for name in L_TRAIN_FNS}
    attn = attention_call_shapes(cfg, B)
    for (G, Lq, Lk, d), (blk, calls) in _distinct(
            (c, i) for i, c in enumerate(attn)).items():
        q, k, v = (_normal(gen, (G, n, d), 1.0, bf) for n in (Lq, Lk, Lk))
        scale = d ** -0.5
        shape = f"L {_blocks(blk, calls)} q[{G},{Lq},{d}] k,v[{G},{Lk},{d}]"
        flops, io = 4 * G * Lq * Lk * d, 2 * (2 * G * Lq * d + 2 * G * Lk * d)
        r = _check_case(
            "flash_attention",
            lambda: fa.flash_attention_fwd(q, k, v, scale, True),
            lambda: fa.flash_attention_lse_plain(q.float(), k.float(),
                                                 v.float(), scale),
            lambda: _sdpa(q, k, v),
            flops=flops, nbytes=io + 4 * G * Lq, peak=PEAK_BF16, iters=3)
        r["shape"] = shape + " (+ lse)"
        res["flash_attention"].append(_mark_fwd(r, G, Lq, Lk, d))
        out, lse = fa.flash_attention_fwd(q, k, v, scale, True)
        dout = _normal(gen, (G, Lq, d), 1.0, bf)
        r = _check_case(
            "flash_attention_bwd",
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, scale),
            lambda: _plain_grads(
                lambda a, b, c: fa.flash_attention_plain(a, b, c, scale),
                (q, k, v), (dout,)),
            lambda: _library_grads(_sdpa, (q, k, v), (dout,)),
            flops=10 * G * Lq * Lk * d,
            nbytes=2 * (4 * G * Lq * d + 4 * G * Lk * d) + 4 * G * Lq,
            peak=PEAK_BF16, iters=2)
        r["shape"] = shape
        res["flash_attention_bwd"].append(r)
        del q, k, v, out, lse, dout
        torch.cuda.empty_cache()
    # one LN+qkv a block, and one LN+MLP (no MoE bank in the L trunk)
    dense = dense_call_shapes(cfg, B)
    for (_, M, L, D, C), (blk, calls) in _distinct(
            (c, i) for i, c in enumerate(
                c for c in dense if c[0] == "qkv")).items():
        res["fused_ln_qkv_bwd"].append(_qkv_bwd_case(
            f"L {_blocks(blk, calls)} x[{M},{D}] w[{3 * C},{D}]",
            *_qkv_inputs(gen, B, L, D, C), L, calls))
        torch.cuda.empty_cache()
    for (_, M, C, H), (blk, calls) in _distinct(
            (c, i) for i, c in enumerate(
                c for c in dense if c[0] == "mlp")).items():
        r = _mlp_bwd_case(gen, f"L {_blocks(blk, calls)} x[{M},{C}] H {H}",
                          M, C)
        r["calls_a_step"] = calls
        res["fused_ln_mlp_bwd"].append(r)
    sp = build_mvit_spec(cfg)
    rows = _distinct(((B * h * L, d), i) for i, _, _, h, d, L in
                     pool_norm_call_shapes(sp, 1))
    cases = [(f"L pool norms, head dim {d}, {_blocks(blk, n)}", M, d, 1e-5)
             for (M, d), (blk, n) in rows.items()]
    # the final norm over the last block's tokens and channels
    cases.append(("L final norm", B * attention_call_shapes(cfg, 1)[-1][1],
                  sp.blocks[-1].dim_out, 1e-6))
    for what, M, C, eps in cases:
        x = _normal(gen, (M, C), 2.0, bf)
        g = _normal(gen, (C,), 0.1, bf) + 1
        bb = _normal(gen, (C,), 0.1, bf)
        dy = _normal(gen, (M, C), 1.0, bf)
        r = _check_case(
            "fused_layer_norm_bwd",
            lambda: ln.fused_layer_norm_bwd(x, g, dy, eps, 1),
            lambda: _plain_grads(
                lambda a, b, c: ln.layer_norm_plain(a, b, c, eps, 1),
                (x, g, bb), (dy,)),
            lambda: _library_grads(
                lambda a, b, c: F.layer_norm(a, (C,), b, c, eps),
                (x, g, bb), (dy,)),
            flops=20 * M * C, nbytes=2 * (3 * M * C + 3 * C),
            peak=PEAK_F32, iters=10)
        r["shape"] = f"{what} x[{M},{C}] (rows)"
        res["fused_layer_norm_bwd"].append(r)
        del x, dy
    torch.cuda.empty_cache()
    return res


def l_fused_kernel_checks(cfg) -> dict:
    """Rows 6 and 7 at head dim 72 at every distinct call of the L batch-4
    train step under ``AICITY_TPU_FUSE_ATTN_LN=1`` (``attention_call_shapes``:
    each block's pooled q against its pooled k, v; d-major, all three norms
    and the residual), each against its plain version and timed beside its
    bound and LN + SDPA (``_fused_ln_train_cases``); and the row-4
    backward (``flash_attention_padded_bwd``) at head dim 72 at the odd
    lengths of L_PADDED_SHAPE."""
    import torch

    from aicity_action_tpu_torch.models.mvit import attention_call_shapes
    from aicity_action_tpu_torch.ops import flash_attention as fa

    bf = torch.bfloat16
    gen = torch.Generator(device=L_DEVICE).manual_seed(SEED + 96)
    res = {name: [] for name in (*FUSED_KERNEL_FNS,
                                 "flash_attention_padded_bwd")}
    for (G, Lq, Lk, d), (blk, calls) in _distinct(
            (c, i) for i, c in enumerate(
                attention_call_shapes(cfg, TRAIN_BATCH))).items():
        cases = _fused_ln_train_cases(
            gen, f"L {_blocks(blk, calls)} q[{G},{Lq},{d}] k,v[{G},{Lk},{d}] "
            "d-major", G, Lq, Lk, d, True)
        for name, c in zip(FUSED_KERNEL_FNS, cases):
            c["calls_a_step"] = calls
            res[name].append(c)
    G, Lq, Lk, d = L_PADDED_SHAPE
    scale = d ** -0.5
    q, k, v = (_normal(gen, (G, n, d), 1.0, bf) for n in (Lq, Lk, Lk))
    out, lse = fa.flash_attention_padded_fwd(q, k, v, scale, True)
    dout = _normal(gen, (G, Lq, d), 1.0, bf)
    r = _check_case(
        "flash_attention_padded_bwd",
        lambda: fa.flash_attention_padded_bwd(q, k, v, out, lse, dout, scale),
        lambda: _plain_grads(
            lambda a, b, c: fa.flash_attention_plain(a, b, c, scale),
            (q, k, v), (dout,)),
        lambda: _library_grads(_sdpa, (q, k, v), (dout,)),
        flops=10 * G * Lq * Lk * d,
        nbytes=2 * (4 * G * Lq * d + 4 * G * Lk * d) + 4 * G * Lq,
        peak=PEAK_BF16, iters=3)
    r["shape"] = f"head dim {d}, odd lengths q[{G},{Lq},{d}] k,v[{G},{Lk},{d}]"
    res["flash_attention_padded_bwd"].append(r)
    del q, k, v, out, lse, dout
    torch.cuda.empty_cache()
    return res


def l_fused_train_checks(card: str, cfg, default: dict) -> dict:
    """The L batch-4 train step under ``AICITY_TPU_FUSE_ATTN_LN=1``
    (``train_checks``: launches held to ``derived_counts``, rows 6 and 7 in
    every block, rows 2-3 and the pool norms' LayerNorms in none), its
    ms/step and peak memory beside ``default``'s (the default switch's
    step, timed in the same call), and the b1 gradient gate under the
    switch (every leaf against the plain f32 step, bf16's own distance
    the largest of ``L_GRAD_DRAWS`` draws)."""
    with fuse_switch("1"):
        stats = train_checks(card, cfg, "MViT-v2-L 16x4 @448 with "
                             "AICITY_TPU_FUSE_ATTN_LN=1", TRAIN_BATCH)
        per_step = stats["launches_per_step"]
        if not all(per_step[n] for n in FUSED_KERNEL_FNS) or any(
                per_step[n] for n in ("flash_attention",
                                      "flash_attention_bwd",
                                      "pool_norm_rows")):
            _fail(f"MViT-v2-L under AICITY_TPU_FUSE_ATTN_LN=1: the step did "
                  f"not run rows 6-7 alone: {per_step}")
        stats["grad_check"] = train_grad_check(
            cfg, "MViT-v2-L @448, AICITY_TPU_FUSE_ATTN_LN=1", f32_truth=True,
            draws=L_GRAD_DRAWS)
    print(f"# MViT-v2-L b{TRAIN_BATCH} train step ({card}): "
          f"AICITY_TPU_FUSE_ATTN_LN=1 {stats['ms_per_step']:.2f} ms/step, "
          f"peak {stats['peak_mem_bytes'] / 2 ** 30:.2f} GiB; default switch "
          f"{default['ms_per_step']:.2f} ms/step, peak "
          f"{default['peak_mem_bytes'] / 2 ** 30:.2f} GiB; =1 / default "
          f"{stats['ms_per_step'] / default['ms_per_step']:.3f} in time, "
          f"{stats['peak_mem_bytes'] / default['peak_mem_bytes']:.3f} in "
          f"memory")
    return stats


def l_run_net_checks(card: str, d: str, switch: str | None = None) -> dict:
    """``tools/run_net.py``'s ``main`` on the AI City YAML with the L widths
    as overrides (``l_overrides()``): one epoch of 2 steps at batch 4 on the
    8 written views of ``d``, its eval and two-view test, and its
    checkpoint, held as the B loop's run is (``_check_loop_run``: finite
    losses, the checkpoint on disk, launches equal to ``derived_counts``
    times the steps and forwards, bf16 inputs on the card), with
    ``AICITY_TPU_FUSE_ATTN_LN`` at ``switch`` (None: the default)."""
    import torch

    from aicity_action_tpu_torch.tools import run_net

    out_dir = "l_out" if switch is None else f"l_out_{switch}"
    with model_inputs_seen() as seen, fuse_switch(switch):
        reset_counts()
        t = time.perf_counter()
        out = run_net.main(["--cfg", LOOP_CFG, "--device", L_DEVICE,
                            *_loop_opts(d, 1, out_dir), *l_overrides()])
        torch.cuda.synchronize()
        run = _check_loop_run(out, read_counts(), list(seen), 1, d, out_dir)
        wall = time.perf_counter() - t
    epoch = run["epochs"][0]
    blocks = len(out["train"].model.blocks)
    del out
    torch.cuda.empty_cache()
    print(f"# MViT-v2-L run_net ({card}): the AI City YAML with the L "
          f"overrides ({blocks} blocks), AICITY_TPU_FUSE_ATTN_LN "
          f"{switch or 'default'}, MAX_EPOCH 1 on 8 views of 960x540 "
          f"at batch 4: losses {epoch['losses']}, step walls "
          f"{epoch['iter_s']}, checkpoint save {epoch['ckpt_s']:.2f} s; run "
          f"{wall:.1f} s; launches {run['launches']}")
    return {"losses": epoch["losses"], "iter_s": epoch["iter_s"],
            "ckpt_s": epoch["ckpt_s"], "seconds": wall,
            "launches": run["launches"]}


def _print_case(name: str, c: dict) -> None:
    """A kernel case's comment line: error and tolerance, the kernel's,
    plain version's and library call's times, the bound."""
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
    checks = layer_norm_checks()
    checks.update(kernel_checks())
    checks.update(train_kernel_checks())
    checks.update(v1_kernel_checks())
    for name, cases in checks.items():
        for c in cases:
            _print_case(name, c)
    # each path runs with the counts set to 0 just before it and read just
    # after; the default switch (auto) unless stated
    cfg = mvitv2_b_16x4_448_cfg()
    model, model_stats = model_checks(card, cfg, "MViT-v2-B 16x4 @448")
    launches = {"v2 scorer": scorer_checks(model, cfg)}
    model_stats["aicity_chain"] = aicity_chain_checks(card, cfg, model)
    launches["v2 AI City chain"] = model_stats["aicity_chain"]["launches"]
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

    with tempfile.TemporaryDirectory() as loop_dir:
        write_s = write_loop_views(loop_dir)
        loop_stats = train_loop_checks(card, loop_dir, write_s)
        launches["v2 train loop"] = loop_stats["launches"]
        ddp_stats = ddp_loop_checks(card, loop_dir, loop_stats)
        launches["v2 train loop, DDP"] = ddp_stats["launches"]
    two_rank = two_rank_checks(card)
    sf_stats = slowfast_checks(card)
    launches["SlowFast R50 8x8"] = sf_stats["launches"]
    det_stats = detection_checks(card)
    launches["v2 detection eval"] = det_stats["launches_per_forward"]
    launches["v2 detection train"] = det_stats["train"]["launches"]
    launches["v2 detection run_temporal_inf"] = det_stats["scorer"][
        "launches"]
    ava_stats = ava_checks(card)
    launches["SlowFast R50 32x2 AVA"] = ava_stats["launches"]
    clip_stats = actionclip_checks(card)
    launches["ActionCLIP feature forward"] = clip_stats["forward"][
        "launches"]
    launches["ActionCLIP train"] = clip_stats["train"]["no MoCo"]["launches"]
    launches["ActionCLIP MoCo train"] = clip_stats["train"]["MoCo"][
        "launches"]
    with tempfile.TemporaryDirectory() as clip_dir:
        write_loop_views(clip_dir)
        clip_stats["loop"] = actionclip_loop_checks(card, clip_dir)
    launches["ActionCLIP loop"] = clip_stats["loop"]["launches"]
    launches["two ranks, one video"] = model_stats["aicity_chain"][
        "two_ranks"]["launches"]
    with tempfile.TemporaryDirectory() as slice_dir:
        t = time.perf_counter()
        write_loop_views(slice_dir)
        mh_stats = multihead_checks(card, slice_dir)
        print(f"# multi-head fine-tune phase: {time.perf_counter() - t:.1f} s")
        launches["v2 multi-head train loop"] = mh_stats["launches"]
        t = time.perf_counter()
        bench_stats = benchmark_checks(card, slice_dir)
        print(f"# benchmarks phase: {time.perf_counter() - t:.1f} s")
    with tempfile.TemporaryDirectory() as clf_dir:
        t = time.perf_counter()
        clf_stats = classifier_checks(card, clf_dir)
        print(f"# classifier and export phase: {time.perf_counter() - t:.1f} "
              f"s")
    launches["v2 classifier"] = clf_stats["launches"]
    launches["v2 exported program"] = clf_stats["exported_launches"]
    with tempfile.TemporaryDirectory() as drill_dir:
        t = time.perf_counter()
        drill_stats = fire_drill_checks(card, drill_dir)
        print(f"# fire drill phase: {time.perf_counter() - t:.1f} s")
    with tempfile.TemporaryDirectory() as moe_dir:
        write_loop_views(moe_dir)
        t = time.perf_counter()
        moe_stats = moe_checks(card, moe_dir)
        print(f"# MoE phase: {time.perf_counter() - t:.1f} s")
        launches["v2 MoE eval"] = moe_stats["launches_per_forward"]
        launches["v2 MoE train loop"] = moe_stats["loop_launches"]
        t = time.perf_counter()
        mg_stats = multigrid_checks(card, moe_dir)
        print(f"# multigrid phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    par_stats = parallel_checks(card)
    print(f"# EP / SP / TP phase: {time.perf_counter() - t:.1f} s")
    for path in ("ep", "sp", "tp"):
        launches[f"{path.upper()}, two ranks"] = par_stats["launches"][path]
    t = time.perf_counter()
    pp_stats = pp_checks(card)
    print(f"# PP phase: {time.perf_counter() - t:.1f} s")
    launches["PP, 4 microbatches"] = pp_stats["launches"]
    t = time.perf_counter()
    l_checks = l_kernel_checks(_factory(L_CFG)())
    for name, cases in l_checks.items():
        for c in cases:
            _print_case(name, c)
    with tempfile.TemporaryDirectory() as l_dir:
        l_stats = l_model_checks(card, l_dir)
    print(f"# MViT-v2-L phase: {time.perf_counter() - t:.1f} s")
    launches["L eval"] = l_stats["launches_per_forward"]
    launches["L unfused eval"] = l_stats["unfused"]["launches_per_forward"]
    launches["L run_temporal_inf"] = l_stats["run_temporal_inf"]["launches"]
    # MViT-v2-L training: the widened training rows at every distinct call
    # of its b4 step on each switch, the step itself on each switch (timed
    # in this call), the b1 gradient gate on each and one run_net epoch
    t = time.perf_counter()
    l_cfg = _factory(L_CFG)()
    head_dim_72_identity_checks(l_cfg)
    l_train_cases = l_train_kernel_checks(l_cfg)
    l_fused_cases = l_fused_kernel_checks(l_cfg)
    for name, cases in (*l_train_cases.items(), *l_fused_cases.items()):
        for c in cases:
            _print_case(name, c)
    l_cfg.MIXUP.ENABLE = True
    if not l_cfg.MODEL.ACT_CHECKPOINT:
        _fail("the L recipe is expected to checkpoint activations")
    l_train = train_checks(card, l_cfg, "MViT-v2-L 16x4 @448 (mixup, "
                           "activation checkpointing, AdamW)", TRAIN_BATCH)
    launches["L train"] = l_train["launches"]
    # every leaf against the plain f32 step, with the bf16 floor the
    # largest of L_GRAD_DRAWS draws
    l_train["grad_check"] = train_grad_check(
        l_cfg, "MViT-v2-L @448", f32_truth=True, draws=L_GRAD_DRAWS)
    t1 = time.perf_counter()
    l_train["fuse_switch_1"] = l_fused_train_checks(card, l_cfg, l_train)
    launches["L fused train"] = l_train["fuse_switch_1"]["launches"]
    print(f"# MViT-v2-L AICITY_TPU_FUSE_ATTN_LN=1 step and gradient gate: "
          f"{time.perf_counter() - t1:.1f} s")
    with tempfile.TemporaryDirectory() as l_dir:
        write_loop_views(l_dir)
        l_train["run_net"] = l_run_net_checks(card, l_dir)
        l_train["fuse_switch_1"]["run_net"] = l_run_net_checks(card, l_dir,
                                                               "1")
    launches["L run_net"] = l_train["run_net"]["launches"]
    launches["L fused run_net"] = l_train["fuse_switch_1"]["run_net"][
        "launches"]
    print(f"# MViT-v2-L training phase: {time.perf_counter() - t:.1f} s")

    # launches of each kernel in the run of the path it serves: the AI City
    # chain's run_temporal_inf for the inference kernels, the timed train
    # steps for the others
    owner = {**dict.fromkeys(KERNEL_FNS, "v2 AI City chain"),
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
        if name in L_FNS:
            # the L path's shapes and launches (flash_attention's on the
            # unfused eval, the others' on run_temporal_inf)
            l_path = ("L unfused eval" if name == "flash_attention"
                      else "L run_temporal_inf")
            kernels_line[-1].update(
                l_shapes=[_public(c) for c in l_checks[name]],
                l_launches=launches[l_path][name], l_launches_on=l_path)
        if name in L_TRAIN_FNS:
            # the L train step's shapes (flash_attention's: with the
            # logsumexp) and launches: its timed steps, its run_net epoch
            kernels_line[-1].update(
                l_train_shapes=[_public(c) for c in l_train_cases[name]],
                l_train_launches=launches["L train"][name],
                l_train_launches_on="L train",
                l_run_net_launches=launches["L run_net"][name])
        if name in l_fused_cases:
            # the L shapes under AICITY_TPU_FUSE_ATTN_LN=1 (rows 6-7) and
            # the row-4 backward at head dim 72; rows 6-7's launches on the
            # =1 step
            kernels_line[-1]["l_train_shapes"] = [
                _public(c) for c in l_fused_cases[name]]
        if name in FUSED_KERNEL_FNS:
            kernels_line[-1].update(
                l_train_launches=launches["L fused train"][name],
                l_train_launches_on="L fused train",
                l_run_net_launches=launches["L fused run_net"][name])
        if name in ("fused_layer_norm", "fused_layer_norm_bwd"):
            cm = ("pool_norm_rows" if name == "fused_layer_norm"
                  else "pool_norm_rows_bwd")
            kernels_line[-1]["instances_by_path"] = {
                path: {"channel_major": n[cm], "rows": n[name] - n[cm]}
                for path, n in launches.items()}
    for extra in ("fused_ln_qkv odd tokens", "fused_ln_qkv_bwd odd tokens",
                  "fused_ln_mlp odd tokens", "fused_ln_mlp_bwd odd tokens"):
        base = extra.split()[0]
        next(k for k in kernels_line if k["name"] == base)[
            "odd_token_shapes"] = [_public(c) for c in checks[extra]]
    print(json.dumps({"model": model_stats, "train": train_stats,
                      "fused_train": fused_stats, "v1_model": v1_stats,
                      "v1_train": v1_train,
                      "train_loop": {k: v for k, v in loop_stats.items()
                                     if k != "runs"},
                      "train_loop_ddp": ddp_stats,
                      "two_ranks": two_rank, "slowfast": sf_stats,
                      "detection": det_stats, "ava": ava_stats,
                      "actionclip": clip_stats, "multihead": mh_stats,
                      "classifier": clf_stats, "fire_drill": drill_stats,
                      "benchmarks": bench_stats, "moe": moe_stats,
                      "multigrid": mg_stats, "parallel": par_stats,
                      "pp": pp_stats, "mvit_l": l_stats,
                      "mvit_l_train": l_train}, default=str))
    print(json.dumps({"kernels": kernels_line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
