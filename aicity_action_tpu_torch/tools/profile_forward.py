"""Where the time of one MViT-v2-B 16x4 @ 448 forward goes on the card.

    python -m aicity_action_tpu_torch.tools.profile_forward [--batch 8]
        [--iters 3] [--out FILE.json]

Builds the model at full width and depth on weights from ``--seed``, warms
up, then traces ``--iters`` forwards with ``torch.profiler`` (CPU and CUDA
activities). Prints, and writes to ``--out`` as JSON: the forward's host
wall time, the device time summed over kernels, the device's busy and idle
share of the wall time, and the device time by kernel name, largest first,
each with the group it belongs to (one of the port's four kernels, the
depthwise pool convolutions, other convolutions, GEMMs, or elementwise and
copy work). A card is required; nothing runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

# kernel-name substrings -> group, first match wins
_GROUPS = (
    ("flash_ln_kernel", "flash_attention_ln (port)"),
    ("ln_qkv_kernel", "fused_ln_qkv (port)"),
    ("ln_mlp_kernel", "fused_ln_mlp (port)"),
    ("layer_norm_kernel", "fused_layer_norm (port)"),
    ("depthwise", "depthwise pool conv"),
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


def group_of(name: str) -> str:
    low = name.lower()
    for key, group in _GROUPS:
        if key in low:
            return group
    return "other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..config import mvitv2_b_16x4_448_cfg
    from ..models.build import build_model

    cfg = mvitv2_b_16x4_448_cfg()
    model = build_model(cfg, device="cuda", seed=args.seed)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.randn((args.batch, T, S, S, 3), generator=gen, device="cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

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

    # device kernels from the raw events; a kernel the trace reports twice
    # (same name, same start) is counted once
    by_name: dict[str, float] = {}
    seen, dupes, spans = set(), 0, []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ident = (ev.name, ev.time_range.start, ev.device_index)
        if ident in seen:
            dupes += 1
            continue
        seen.add(ident)
        spans.append((ev.time_range.start, ev.time_range.end))
        by_name[ev.name] = (by_name.get(ev.name, 0.0)
                            + ev.time_range.elapsed_us())
    if not by_name:
        raise SystemExit("profile_forward: the profiler saw no device time")
    per_fwd = {k: v / 1e3 / args.iters for k, v in by_name.items()}
    device_ms = sum(per_fwd.values())
    # busy time = union of the kernel intervals (overlaps counted once)
    busy_us, cur_start, cur_end = 0.0, None, None
    for s, e in sorted(spans):
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    busy_us += cur_end - cur_start
    busy_ms = busy_us / 1e3 / args.iters
    groups: dict[str, float] = {}
    for k, ms in per_fwd.items():
        g = group_of(k)
        groups[g] = groups.get(g, 0.0) + ms
    result = {
        "card": card, "batch": args.batch, "iters": args.iters,
        "event_ms_per_forward": event_ms,
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
    print(f"# {card}: batch {args.batch}, {event_ms:.2f} ms/forward "
          f"(events), {wall_ms:.2f} ms wall under the profiler, "
          f"{device_ms:.2f} ms of kernels ({dupes} duplicate records "
          f"dropped), idle share {result['device_idle_share']:.3f}")
    for g, ms in result["groups_ms"].items():
        print(f"#   {ms:9.3f} ms  {ms / device_ms:6.1%}  {g}")
    for k in result["kernels_ms"]:
        print(f"#   {k['ms']:9.3f} ms  {k['group']:<34} {k['name'][:90]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in (
        "event_ms_per_forward", "wall_ms_per_forward",
        "device_ms_per_forward", "device_idle_share", "clips_per_s",
        "groups_ms")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
