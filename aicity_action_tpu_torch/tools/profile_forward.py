"""Where the time of one MViT forward, or train step, goes on the card.

    python -m aicity_action_tpu_torch.tools.profile_forward [--batch 8]
        [--config v2_448|v1_224|moe_448|l_448] [--fuse-attn-ln auto|0|1]
        [--iters 3] [--out FILE.json]
    python -m aicity_action_tpu_torch.tools.profile_forward --train
        [--batch 4] [--config ...] [--fuse-attn-ln ...] [--iters 3]
        [--out FILE.json]

``--config`` picks MViT-v2-B 16x4 @ 448 (the default, the AI City model),
MViT-B 16x4 @ 224 with a cls token (PySlowFast's Kinetics-400 MViT-v1),
the 448 model with its MoE banks (``mvitv2_b_16x4_448_moe_cfg``) or with
the MViT-v2-L trunk (``mvitv2_l_16x4_448_cfg``: 48 blocks, head dim 72;
with ``--train`` on either switch);
``--fuse-attn-ln`` sets ``AICITY_TPU_FUSE_ATTN_LN`` for the run (``1``: the
fused-LN attention in training too). Builds the model at full width and
depth on weights from ``--seed``, warms
up, then traces ``--iters`` forwards with ``torch.profiler`` (CPU and CUDA
activities). Prints, and writes to ``--out`` as JSON: the forward's host
wall time, the device time summed over kernels, the device's busy and idle
share of the wall time, and the device time by kernel name, largest first,
each with the group it belongs to (one of the port's kernels, the
attention backward split by launch: its pre-pass, dk/dv, dq and sums; the
depthwise pool convolutions, other convolutions, GEMMs, or elementwise and
copy work). A card is required; nothing runs on the CPU.

With ``--train`` it profiles the training step of the recipe (mixup,
activation checkpointing, AdamW) instead: the same figures per step, and
the device time by group split into the forward, the recompute (kernels of
the backward pass that the forward also ran: activation checkpointing) and
the rest of the backward, plus the optimizer; the phases are separated by
synchronizing between them in extra profiled steps (generic kernels of the
backward that share a name with one of the forward's, such as elementwise
adds, count as recompute). It times the steps with activation
checkpointing off too, with their peak memory. It also times the
layout copies the training path still pays per step (a q, k, v to
head-major token rows in the forward and its recompute and its gradient
back, wherever its pool norm does not read the pool convolution's layout
itself, and the attention output to token-major), at each block's shapes
with CUDA events.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import time

# kernel-name substrings -> group, first match wins (the fused-LN
# attention's passes also under the names older checkouts gave them:
# kv_rows_kernel, kv_ln_bwd_kernel, reduce_splits_kernel)
_FUSED_LN_SUMS = "attention bwd: fused-LN dgamma/dbeta sums (port)"
_GROUPS = (
    ("flash_ln_kernel", "flash_attention_ln (port)"),
    ("flash_ln_bwd_dq", "attention bwd: fused-LN dq + LN VJP (port)"),
    ("kv_vjp_kernel", "attention bwd: fused-LN dk/dv sums + LN VJP (port)"),
    ("kv_ln_bwd", "attention bwd: fused-LN dk/dv sums + LN VJP (port)"),
    ("flash_ln_bwd_sum", _FUSED_LN_SUMS),
    ("reduce_splits_kernel", _FUSED_LN_SUMS),
    ("kv_norm_kernel", "flash_attention_ln K/V LN pass (port)"),
    ("kv_rows_kernel", "flash_attention_ln K/V LN pass (port)"),
    ("flash_fwd_kernel", "flash_attention fwd (port)"),
    ("flash_bwd_prep", "attention bwd: pre-pass (port)"),
    ("flash_bwd_dkv", "attention bwd: dk/dv (port)"),
    ("flash_bwd_dq", "attention bwd: dq (port)"),
    ("flash_bwd_sum", "attention bwd: dk/dv sums (port)"),
    ("qkv_bwd_", "fused_ln_qkv bwd (port)"),
    ("mlp_bwd_", "fused_ln_mlp bwd (port)"),
    ("ln_cols_bwd_kernel", "pool norm bwd, channel-major (port)"),
    ("ln_rows_bwd_kernel", "fused_layer_norm bwd, rows (port)"),
    ("ln_qkv_kernel", "fused_ln_qkv (port)"),
    ("ln_mlp_kernel", "fused_ln_mlp (port)"),
    ("ln_cols_kernel", "pool norm, channel-major (port)"),
    ("ln_rows_kernel", "fused_layer_norm, rows (port)"),
    ("depthwise", "depthwise pool conv"),
    ("dgrad", "conv backward"),
    ("wgrad", "conv backward"),
    ("multi_tensor_apply", "optimizer"),
    ("fprop", "patch-embed conv"),
    ("implicit_convolve", "conv"),
    ("nchwtonhwc", "layout change"),
    ("nhwctonchw", "layout change"),
    ("max_pool", "max pool (skip path)"),
    ("nvjet", "gemm (proj, proj_max_pool, head)"),
    ("gemm", "gemm (proj, proj_max_pool, head)"),
    ("elementwise", "elementwise / copy"),
    ("copy", "elementwise / copy"),
    ("reduce", "reduction"),
)


# record_function names the profiler mirrors onto the device track
_ANNOTATIONS = ("train_phase:", "Optimizer.", "ProfilerStep")


def group_of(name: str) -> str:
    low = name.lower()
    for key, group in _GROUPS:
        if key in low:
            return group
    return "other"


def _device_kernels(prof):
    """``[(name, start_us, end_us)]`` of the device kernels in a trace; a
    kernel the trace reports twice (same name, same start) is counted once.
    Returns the list and the number of duplicates dropped."""
    import torch

    out, seen, dupes = [], set(), 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        # ranges of record_function (the optimizer's step, this tool's
        # phases) are mirrored on the device track; they are not kernels
        if getattr(ev, "is_user_annotation", False) or ev.name.startswith(
                _ANNOTATIONS):
            continue
        ident = (ev.name, ev.time_range.start, ev.device_index)
        if ident in seen:
            dupes += 1
            continue
        seen.add(ident)
        out.append((ev.name, ev.time_range.start, ev.time_range.end))
    if not out:
        raise SystemExit("profile_forward: the profiler saw no device time")
    return out, dupes


def _busy_us(spans) -> float:
    """The union of the kernel intervals (overlaps counted once)."""
    busy, cur_start, cur_end = 0.0, None, None
    for _, s, e in sorted(spans, key=lambda k: k[1]):
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    return busy + (cur_end - cur_start)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _summary(kernels, iters, wall_ms):
    by_name: dict[str, float] = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    per = {k: v / 1e3 / iters for k, v in by_name.items()}
    device_ms = sum(per.values())
    busy_ms = _busy_us(kernels) / 1e3 / iters
    groups: dict[str, float] = {}
    for k, ms in per.items():
        groups[group_of(k)] = groups.get(group_of(k), 0.0) + ms
    return per, device_ms, busy_ms, groups


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--train", action="store_true")
    p.add_argument("--config", choices=sorted(CONFIGS), default="v2_448")
    p.add_argument("--fuse-attn-ln", choices=("auto", "0", "1"),
                   default="auto")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    os.environ["AICITY_TPU_FUSE_ATTN_LN"] = args.fuse_attn_ln
    if args.batch is None:
        args.batch = 4 if args.train else 8
    result = train_profile(args) if args.train else forward_profile(args)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


def _config(name: str):
    from .. import config

    return getattr(config, CONFIGS[name])()


CONFIGS = {"v2_448": "mvitv2_b_16x4_448_cfg", "v1_224": "mvit_b_16x4_224_cfg",
           "moe_448": "mvitv2_b_16x4_448_moe_cfg",
           "l_448": "mvitv2_l_16x4_448_cfg"}


def forward_profile(args) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..models.build import build_model

    cfg = _config(args.config)
    model = build_model(cfg, device="cuda", seed=args.seed)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.randn((args.batch, T, S, S, 3), generator=gen, device="cuda")
    card = _card()

    with torch.no_grad():
        for _ in range(2):
            model(x)
        # forward time on the card's clock, outside the profiler
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            model(x)
        end.record()
        torch.cuda.synchronize()
        event_ms = start.elapsed_time(end) / args.iters
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(args.iters):
                model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3 / args.iters

    kernels, dupes = _device_kernels(prof)
    per_fwd, device_ms, busy_ms, groups = _summary(kernels, args.iters,
                                                   wall_ms)
    result = {
        "card": card, "config": args.config,
        "fuse_attn_ln": args.fuse_attn_ln, "batch": args.batch,
        "iters": args.iters, "event_ms_per_forward": event_ms,
        "wall_ms_per_forward": wall_ms,
        "duplicate_kernel_records": dupes,
        "device_ms_per_forward": device_ms,
        "device_busy_ms_per_forward": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "clips_per_s": args.batch / event_ms * 1e3,
        "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "kernels_ms": [
            {"name": k[:160], "group": group_of(k), "ms": ms}
            for k, ms in sorted(per_fwd.items(), key=lambda kv: -kv[1])
        ][:args.top],
    }
    print(f"# {card}: {args.config}, AICITY_TPU_FUSE_ATTN_LN="
          f"{args.fuse_attn_ln}, batch {args.batch}, {event_ms:.2f} ms/forward "
          f"(events), {wall_ms:.2f} ms wall under the profiler, "
          f"{device_ms:.2f} ms of kernels ({dupes} duplicate records "
          f"dropped), idle share {result['device_idle_share']:.3f}")
    for g, ms in result["groups_ms"].items():
        print(f"#   {ms:9.3f} ms  {ms / device_ms:6.1%}  {g}")
    for k in result["kernels_ms"]:
        print(f"#   {k['ms']:9.3f} ms  {k['group']:<34} {k['name'][:90]}")
    print(json.dumps({k: result[k] for k in (
        "event_ms_per_forward", "wall_ms_per_forward",
        "device_ms_per_forward", "device_idle_share", "clips_per_s",
        "groups_ms")}))
    return result


def layout_copy_ms(model, batch: int, remat: int) -> dict:
    """Device time per train step of the layout copies the unfused training
    path still makes, at each block's shapes (CUDA events over repeated
    copies): per q, k, v whose pool norm does not take the channel-major
    instance (``ops/layer_norm.py:channel_major_applies``, which reads the
    pool convolution's layout and writes the rows itself) the ``[B, h*d, L]
    -> [B*h, L, d]`` transpose, ``remat`` times in the forward and once back
    for its gradient, and the attention output's ``[B*h, Lq, d] -> [B, Lq,
    h*d]`` once forward and once back."""
    import torch

    from ..ops.layer_norm import channel_major_applies

    sp = model.spec
    T, H, W = sp.patch_dims
    per = {"qkv_to_rows": 0.0, "grads_back": 0.0, "out_to_tokens": 0.0}

    def timed(fn, n=10):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    thw = (T, H, W)
    cls = int(sp.cls_embed)
    for bs, blk in zip(sp.blocks, model.blocks):
        a = blk.attn
        h, d = a.num_heads, a.head_dim
        L = math.prod(thw)
        lens = {}
        for name in "qkv":
            kernel, stride = ((bs.kernel_q, bs.stride_q) if name == "q"
                              else (bs.kernel_kv, bs.stride_kv))
            lens[name] = (pooled_len(thw, kernel, stride)
                          if name in a.pooled else (L, thw))
        for name, (n, _) in lens.items():
            n += cls
            if (a.mode == "conv" and name in a.pooled
                    and channel_major_applies(n, bool(cls), d)):
                continue  # the pool norm reads its layout: no copy
            t = torch.empty((batch, h * d, n), dtype=torch.bfloat16,
                            device="cuda")
            r = torch.empty((batch * h, n, d), dtype=torch.bfloat16,
                            device="cuda")
            # .contiguous(): the model makes the rows contiguous for the
            # kernels even where (one head) the reshapes alone are views;
            # the gradients' way back is timed the same way
            per["qkv_to_rows"] += remat * timed(
                lambda t=t, n=n: t.reshape(batch, h, d, n).transpose(2, 3)
                .reshape(batch * h, n, d).contiguous())
            per["grads_back"] += timed(
                lambda r=r, n=n: r.reshape(batch, h, n, d).transpose(2, 3)
                .reshape(batch, h * d, n).contiguous())
        Lq, new_thw = lens["q"]
        Lq += cls
        o = torch.empty((batch * h, Lq, d), dtype=torch.bfloat16,
                        device="cuda")
        per["out_to_tokens"] += (remat + 1) * timed(
            lambda o=o, Lq=Lq: o.reshape(batch, h, Lq, d).transpose(1, 2)
            .reshape(batch, Lq, h * d))
        thw = new_thw
    per["total"] = sum(per.values())
    return per


def pooled_len(thw, kernel, stride):
    """Token count and (T, H, W) after pooling with padding kernel // 2."""
    out = tuple((n + 2 * (k // 2) - k) // s + 1
                for n, k, s in zip(thw, kernel, stride))
    return math.prod(out), out


def train_profile(args) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..data.mixup import build_mixup_from_cfg
    from ..engine.steps import make_train_step, step_generators
    from ..models.build import build_model
    from ..models.losses import get_loss_func
    from ..models.mvit import _fuse_attn_ln_enabled
    from ..solver.optimizer import construct_optimizer

    cfg = _config(args.config)
    cfg.MIXUP.ENABLE = True
    model = build_model(cfg, device="cuda", seed=args.seed)
    opt = construct_optimizer(cfg, model, steps_per_epoch=100)
    mix = build_mixup_from_cfg(cfg)
    step = make_train_step(model, opt, cfg.MODEL.LOSS_FUNC, mixup_fn=mix,
                           num_classes=cfg.MODEL.NUM_CLASSES, seed=args.seed)
    loss_fn = get_loss_func(cfg.MODEL.LOSS_FUNC)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    batch = {"inputs": torch.randn((args.batch, T, S, S, 3), generator=gen,
                                   device="cuda"),
             "labels": torch.randint(0, cfg.MODEL.NUM_CLASSES, (args.batch,),
                                     generator=gen, device="cuda")}
    card = _card()
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(args.iters):
        step(batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / args.iters

    # whole steps, unsynchronized: device time by group and idle share
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(args.iters):
            step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / args.iters
    kernels, dupes = _device_kernels(prof)
    per_step, device_ms, busy_ms, groups = _summary(kernels, args.iters,
                                                    wall_ms)

    # phases: the same step by hand, synchronized at the end of each
    # phase inside its profiler range, so every kernel of a phase runs
    # within the range's host interval
    def phased(k):
        g, rng = step_generators(args.seed, 1000 + k, "cuda")
        inputs, targets = mix(batch["inputs"], batch["labels"], rng)
        model.train()
        opt.zero_grad()
        torch.cuda.synchronize()
        with record_function("train_phase:forward"):
            loss = loss_fn(model(inputs, generator=g), targets)
            torch.cuda.synchronize()
        with record_function("train_phase:backward"):
            loss.backward()
            torch.cuda.synchronize()
        with record_function("train_phase:optimizer"):
            opt.step()
            torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof2:
        for k in range(args.iters):
            phased(k)
    pk, _ = _device_kernels(prof2)
    ranges = sorted((ev.time_range.start, ev.time_range.end,
                     ev.name.split(":", 1)[1]) for ev in prof2.events()
                    if ev.name.startswith("train_phase:"))
    fwd_names = set()
    phase_ms = {"forward": {}, "recompute": {}, "backward": {},
                "optimizer": {}}
    for name, s, e in sorted(pk, key=lambda k: k[1]):
        phase = next((ph for r0, r1, ph in ranges if r0 <= s < r1), None)
        if phase is None:
            continue
        if phase == "forward":
            fwd_names.add(name)
        elif phase == "backward" and name in fwd_names:
            phase = "recompute"
        d = phase_ms[phase]
        d[group_of(name)] = d.get(group_of(name), 0.0) + (
            e - s) / 1e3 / args.iters
    phases = {ph: {"ms": sum(d.values()),
                   "groups_ms": dict(sorted(d.items(), key=lambda kv: -kv[1]))}
              for ph, d in phase_ms.items()}
    # the unfused path's layout copies (the fused-LN one reads and writes
    # the pool convolutions' layout)
    copies = (layout_copy_ms(model, args.batch,
                             2 if cfg.MODEL.ACT_CHECKPOINT else 1)
              if not _fuse_attn_ln_enabled(True) else {"total": 0.0})

    # what the recompute costs and saves: the same steps with activation
    # checkpointing off (peak memory of the steps alone)
    def timed_steps(remat):
        model.spec = dataclasses.replace(model.spec, act_checkpoint=remat)
        step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for _ in range(args.iters):
            step(batch)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t) * 1e3 / args.iters,
                torch.cuda.max_memory_allocated())

    remat_ms, remat_peak = timed_steps(True)
    plain_ms, plain_peak = timed_steps(False)
    model.spec = dataclasses.replace(model.spec,
                                     act_checkpoint=cfg.MODEL.ACT_CHECKPOINT)
    result = {
        "card": card, "config": args.config,
        "fuse_attn_ln": args.fuse_attn_ln, "batch": args.batch,
        "iters": args.iters, "ms_per_step": step_ms, "clips_per_s": args.batch / step_ms * 1e3,
        "wall_ms_per_step_profiled": wall_ms,
        "duplicate_kernel_records": dupes,
        "device_ms_per_step": device_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_idle_share_unprofiled": max(0.0, 1.0 - busy_ms / step_ms),
        "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "phases": phases,
        "layout_copies_ms_per_step": copies,
        "checkpointing": {"on_ms_per_step": remat_ms,
                          "on_peak_mem_bytes": remat_peak,
                          "off_ms_per_step": plain_ms,
                          "off_peak_mem_bytes": plain_peak},
        "kernels_ms": [
            {"name": k[:160], "group": group_of(k), "ms": ms}
            for k, ms in sorted(per_step.items(), key=lambda kv: -kv[1])
        ][:args.top],
    }
    print(f"# {card}: {args.config}, AICITY_TPU_FUSE_ATTN_LN="
          f"{args.fuse_attn_ln}, train step batch {args.batch}, "
          f"{step_ms:.2f} ms/step, "
          f"{wall_ms:.2f} ms wall under the profiler, {device_ms:.2f} ms of "
          f"kernels, idle share {result['device_idle_share']:.3f} of the "
          f"profiled wall, {result['device_idle_share_unprofiled']:.3f} of "
          f"the unprofiled step")
    for g, ms in result["groups_ms"].items():
        print(f"#   {ms:9.3f} ms  {ms / device_ms:6.1%}  {g}")
    for ph, v in phases.items():
        print(f"# phase {ph}: {v['ms']:.3f} ms  {json.dumps(v['groups_ms'])}")
    print(f"# layout copies per step: {json.dumps(copies)}")
    print(f"# activation checkpointing on: {remat_ms:.2f} ms/step, peak "
          f"{remat_peak / 2 ** 30:.2f} GiB; off: {plain_ms:.2f} ms/step, "
          f"peak {plain_peak / 2 ** 30:.2f} GiB")
    for k in result["kernels_ms"]:
        print(f"#   {k['ms']:9.3f} ms  {k['group']:<34} {k['name'][:90]}")
    print(json.dumps({k: result[k] for k in (
        "ms_per_step", "clips_per_s", "device_ms_per_step",
        "device_idle_share", "device_idle_share_unprofiled", "groups_ms",
        "layout_copies_ms_per_step", "checkpointing")}))
    return result


if __name__ == "__main__":
    raise SystemExit(main())
