"""Reading a ``torch.profiler`` trace of the measured window.

The kernel-to-group table and the first readers (device kernels, the union
of their intervals) are copied from the port's
``tools/profile_forward.py`` and frozen here, so that a change to the
program cannot move what the benchmark reads. A kernel is grouped by the
first key that its lower-cased name contains.
"""

from __future__ import annotations

import bisect

_FUSED_LN_SUMS = "attention bwd: fused-LN dgamma/dbeta sums (port)"
GROUPS = (
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

# the groups of the attention's launches (forward, its K/V LN pass, every
# backward pass) and of the convolutions (forward and backward)
ATTENTION_GROUPS = frozenset(g for _, g in GROUPS
                             if g.startswith(("flash_attention",
                                              "attention bwd")))
CONV_GROUPS = frozenset({"depthwise pool conv", "conv backward",
                         "patch-embed conv", "conv"})

# record_function names the profiler mirrors onto the device track
_ANNOTATIONS = ("train_phase:", "Optimizer.", "ProfilerStep", "bench:")


def group_of(name: str) -> str:
    low = name.lower()
    for key, group in GROUPS:
        if key in low:
            return group
    return "other"


def read_profile(prof) -> tuple[list, list]:
    """``(kernels, host)``: the device kernels ``[(name, start_us,
    end_us)]`` (a kernel reported twice, same name and start, counted once;
    annotations mirrored on the device track dropped) and the host events
    ``[(name, start_us, end_us)]`` of one profile, on one clock. Reads the
    profiler's raw events (``kineto_results``): building its event tree
    (``prof.events()``) takes a minute at a window's event count."""
    import torch

    kernels, host, seen = [], [], set()
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        span = (name, ev.start_ns() / 1e3, ev.end_ns() / 1e3)
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(span)
            continue
        if ev.is_user_annotation() or name.startswith(_ANNOTATIONS):
            continue
        ident = (name, span[1], ev.device_index())
        if ident in seen:
            continue
        seen.add(ident)
        kernels.append(span)
    return kernels, host


def busy_intervals(kernels) -> list[tuple[float, float]]:
    """The union of the kernel intervals, as sorted disjoint intervals."""
    out: list = []
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(i) for i in out]


def busy_us(kernels) -> float:
    return sum(e - s for s, e in busy_intervals(kernels))


def by_name_us(kernels) -> dict[str, float]:
    out: dict[str, float] = {}
    for name, s, e in kernels:
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def by_group_us(kernels) -> dict[str, float]:
    out: dict[str, float] = {}
    for name, us in by_name_us(kernels).items():
        g = group_of(name)
        out[g] = out.get(g, 0.0) + us
    return out


def top_ops(kernels, n: int = 10) -> list:
    """``[[name, seconds], ...]``: the ``n`` kernel names that took most
    device time."""
    ranked = sorted(by_name_us(kernels).items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], us / 1e6] for name, us in ranked]


def idle_gaps(kernels, host, start_us: float, end_us: float,
              n: int = 10) -> list:
    """``[[host activity, seconds], ...]``: the ``n`` longest stretches of
    ``[start_us, end_us]`` in which no kernel or copy ran, each named by
    the innermost host event (a CUDA call) under way at its middle, or else
    ``after <the last one to end before it>``: the host was busy with work
    of its own."""
    gaps, t = [], start_us
    for s, e in busy_intervals(kernels):
        if s > t:
            gaps.append((t, min(s, end_us)))
        t = max(t, e)
    if end_us > t:
        gaps.append((t, end_us))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:n]
    events = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in events]
    out = []
    for s, e in gaps:
        mid = (s + e) / 2
        inner = last = None
        for name, hs, he in events[:bisect.bisect_right(starts, mid)]:
            if he >= mid:
                if inner is None or he - hs < inner[1]:
                    inner = (name, he - hs)
            elif last is None or he > last[1]:
                last = (name, he)
        label = (inner[0] if inner else f"after {last[0]}" if last
                 else "before any CUDA call")
        out.append([label[:160], (e - s) / 1e6])
    return out
