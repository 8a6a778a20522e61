"""Where the time of the LN+MLP backward (``fused_ln_mlp_bwd``, the
default) or of the LN+qkv backward (``fused_ln_qkv_bwd``, ``--kernel qkv``)
goes on the card, launch by launch, at the shapes a train step gives it;
likewise the fused-LN attention's backward (``flash_attention_ln_bwd``,
``--kernel attn_ln``: its K/V LN pass, dq, dk/dv, the dk/dv LN VJP and the
dgamma / dbeta sums) and its forward (``flash_attention_ln``, ``--kernel
attn_ln_fwd``: the K/V LN pass and the attention).

    python -m aicity_action_tpu_torch.tools.profile_mlp_bwd
        [--kernel mlp|qkv|attn_ln|attn_ln_fwd] [--config v2_448|v1_224|l_448]
        [--batch N] [--shapes M,C,H ... | M,tokens,D,C ... | G,Lq,Lk,d ...]
        [--iters 11] [--out FILE.json]

For every distinct call of the kernel in the config's train step at
``--batch`` (4 for v2_448 and l_448, MViT-v2-L's trunk, 8 for v1_224 by
default; from the model's block
schedule, no model is built), or for each ``--shapes`` tuple (``M,C,H`` for
the MLP, ``M,tokens,D,C`` for the qkv, ``G,Lq,Lk,d`` for the attention:
d-major q, k, v, all three norms and the residual), it draws bf16 inputs
from
``--seed``, times the call's device work with CUDA events (median and
interquartile range of ``--iters`` calls, each behind a spin kernel that
hides the host's launches, after a warm-up), traces ``--iters`` calls
with ``torch.profiler`` and sums the device time by launch (the labels of
``LAUNCHES``; a GEMM kernel launched more than once a call is told apart
by its order in the call). It also reads the call's peak of device memory
above its inputs. Prints one line per shape, the card's name and power
limit, and one JSON object (written to ``--out`` too). A card is required.
With ``--shapes`` it uses no more of the package than the backward's
wrapper and ``tools/profile_forward.py``, so run as a file with another
checkout first on ``PYTHONPATH`` it times that checkout's backward in the
same way (kernels this tool has no label for count as "other").
"""

from __future__ import annotations

import argparse
import json

from aicity_action_tpu_torch.tools.profile_forward import (_card, _config,
                                                           _device_kernels)

# a spin kernel (~1 ms) ahead of each timed call, so that its events time
# the device's work and not the host's launches
SPIN_CYCLES = 2_000_000
# the H100 SXM's memory rate (NVIDIA's data sheet), for the fused-LN
# attention's passes' byte bounds
PEAK_BYTES = 3.35e12

# per backward: kernel-name substrings -> launch labels, first match wins;
# a kernel launched several times a call takes its labels in turn
LAUNCHES = {
    "mlp": (
        ("mlp_bwd_transpose", ("0 weight transposes",)),
        ("mlp_bwd_prep", ("1 pre-pass",)),
        ("mlp_bwd_dual", ("2 dual GEMM",)),
        ("mlp_bwd_gemm_kernel", ("3 dxn GEMM", "5 dW1 GEMM", "5 dW2 GEMM")),
        ("mlp_bwd_ln", ("4 LN backward",)),
        ("mlp_bwd_reduce", ("partial sums",)),
        ("reduce_splits", ("partial sums",)),
    ),
    "qkv": (
        ("qkv_bwd_prep", ("1 x pre-pass, weight transpose",)),
        ("qkv_bwd_grad", ("1 gradients' pass",)),
        ("qkv_bwd_gemm_kernel", ("2 dxn GEMM", "4 dW GEMM")),
        ("qkv_bwd_dw_kernel", ("4 dW GEMM",)),
        ("qkv_bwd_ln", ("3 LN backward",)),
        ("qkv_bwd_reduce", ("partial sums",)),
        ("reduce_splits", ("partial sums",)),
    ),
    # older checkouts' names of the passes too: kv_rows_kernel,
    # kv_ln_bwd_kernel, reduce_splits_kernel
    "attn_ln": (
        ("kv_norm_kernel", ("1 K/V LN pass",)),
        ("kv_rows_kernel", ("1 K/V LN pass",)),
        ("flash_ln_bwd_dq", ("2 dq + LN VJP",)),
        ("flash_bwd_dkv", ("3 dk/dv",)),
        ("kv_vjp_kernel", ("4 dk/dv LN VJP",)),
        ("kv_ln_bwd_kernel", ("4 dk/dv LN VJP",)),
        ("flash_ln_bwd_sum", ("5 dgamma/dbeta sums",)),
        ("reduce_splits", ("5 dgamma/dbeta sums",)),
    ),
    "attn_ln_fwd": (
        ("kv_norm_kernel", ("1 K/V LN pass",)),
        ("kv_rows_kernel", ("1 K/V LN pass",)),
        ("flash_ln_kernel", ("2 attention",)),
    ),
}


def _label_launches(kernel: str, kernels: list, calls: int) -> dict:
    """Device ms a call by launch label, from ``[(name, start, end)]`` of
    ``calls`` calls (a call starts with the first entry's kernel)."""
    seen: dict = {}
    out: dict = {}
    for name, s, e in sorted(kernels, key=lambda k: k[1]):
        label = "other"
        for i, (key, labels) in enumerate(LAUNCHES[kernel]):
            if key in name:
                if i == 0:
                    seen.clear()
                n = seen.get(key, 0)
                seen[key] = n + 1
                label = labels[min(n, len(labels) - 1)]
                break
        out[label] = out.get(label, 0.0) + (e - s) / 1e3 / calls
    return dict(sorted(out.items()))


def _shapes(kernel: str, config: str, batch: int) -> list:
    """``[(shape, calls a step)]`` of the config's calls of the kernel:
    ``(M, C, H)`` for the MLP, ``(M, tokens, D, C)`` for the qkv, ``(G,
    Lq, Lk, d)`` for the attention."""
    from aicity_action_tpu_torch.models.mvit import (attention_call_shapes,
                                                    dense_call_shapes)

    cfg = _config(config)
    counts: dict = {}
    if kernel.startswith("attn"):
        for call in attention_call_shapes(cfg, batch):
            counts[call] = counts.get(call, 0) + 1
        return sorted(counts.items(), key=lambda kv: -kv[0][0] * kv[0][1])
    for call in dense_call_shapes(cfg, batch):
        if call[0] == kernel:
            counts[call[1:]] = counts.get(call[1:], 0) + 1
    return sorted(counts.items(), key=lambda kv: -kv[0][0] * kv[0][-1])


def _call(kernel: str, shape: tuple, seed: int):
    """The backward's wrapper on bf16 inputs from ``seed`` at ``shape``,
    as a closure."""
    import torch

    from aicity_action_tpu_torch.ops import fused_dense as fd

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(torch.bfloat16)

    if kernel.startswith("attn"):
        from aicity_action_tpu_torch.ops import flash_attention as fa

        G, Lq, Lk, d = shape
        q, k, v = (normal((G, d, n), 1.0).transpose(1, 2)
                   for n in (Lq, Lk, Lk))
        lnp = [t for _ in range(3)
               for t in (normal((d,), 0.1) + 1, normal((d,), 0.1))]
        args = (q, k, v, *lnp, d ** -0.5, 1e-5, (True, True, True), True)
        if kernel == "attn_ln_fwd":
            return lambda: fa.flash_attention_ln(*args)
        _, lse, oa = fa.flash_attention_ln_lse(*args)
        dout = normal((G, Lq, d), 1.0)
        return lambda: fa.flash_attention_ln_bwd(q, k, v, *lnp, oa, lse, dout,
                                                 *args[9:])
    if kernel == "qkv":
        M, L, D, C = shape
        x, w = normal((M, D), 1.0), normal((3 * C, D), D ** -0.5)
        g, bb = normal((D,), 0.1) + 1, normal((D,), 0.1)
        grads = [normal((M // L, C, L), 1.0) for _ in range(3)]
        return lambda: fd.fused_ln_qkv_bwd(x, g, bb, w, *grads, 1e-6, L)
    M, C, H = shape
    x, dout = normal((M, C), 1.0), normal((M, C), 1.0)
    g, bb = normal((C,), 0.1) + 1, normal((C,), 0.1)
    w1, b1, w2 = normal((H, C), C ** -0.5), normal((H,), 0.1), normal(
        (C, H), H ** -0.5)
    return lambda: fd.fused_ln_mlp_bwd(x, g, bb, w1, b1, w2, dout, 1e-6)


def _pass_bounds(kernel: str, shape: tuple) -> dict:
    """The byte bounds (ms at PEAK_BYTES) of the fused-LN attention's passes
    around its cores at ``(G, Lq, Lk, d)``, each input read once and each
    output written once: the K/V pass reads k, v and writes their LN rows;
    the VJP reads the dk/dv kernel's f32 partials of its query splits and
    k, v, and writes dk, dv and a (dgamma, dbeta) slab a 64-key tile of
    each; the sums read the slabs of q (one a 64-row query tile), k and v
    and write the six bf16 vectors."""
    import torch

    from aicity_action_tpu_torch.ops import flash_attention as fa

    G, Lq, Lk, d = shape
    bounds = {"1 K/V LN pass": 8 * G * Lk * d}
    if kernel == "attn_ln":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        nsplit = fa._attn_bwd_plan(G, Lq, Lk, d, sms)["nsplit"]
        slabs = G * -(-Lq // 64) + 2 * G * -(-Lk // 64)
        bounds["4 dk/dv LN VJP"] = (8 * nsplit + 8) * G * Lk * d + (
            2 * G * -(-Lk // 64) * 8 * d)
        bounds["5 dgamma/dbeta sums"] = slabs * 8 * d + 12 * d
    return {k: v / PEAK_BYTES * 1e3 for k, v in bounds.items()}


def profile_shape(kernel: str, shape: tuple, iters: int, seed: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    call = _call(kernel, shape, seed)
    call()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)  # the host enqueues behind it
        a.record()
        call()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in times)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    kernels, _ = _device_kernels(prof)
    n = len(ms)
    out = {"shape": list(shape), "ms": ms[n // 2],
           "ms_iqr": [ms[n // 4], ms[(3 * n) // 4]],
           "launches_ms": _label_launches(kernel, kernels, iters),
           "peak_bytes_above_inputs": peak}
    if kernel.startswith("attn"):
        out["bound_ms"] = _pass_bounds(kernel, shape)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--kernel", choices=sorted(LAUNCHES), default="mlp")
    p.add_argument("--config", choices=("v2_448", "v1_224", "l_448"),
                   default="v2_448")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--shapes", nargs="*", default=None,
                   help="M,C,H (mlp), M,tokens,D,C (qkv) or G,Lq,Lk,d "
                   "(attn_ln, attn_ln_fwd) tuples in place of the config's "
                   "calls")
    p.add_argument("--iters", type=int, default=11)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_mlp_bwd: needs a CUDA card")
    batch = args.batch or (8 if args.config == "v1_224" else 4)
    shapes = ([(tuple(int(v) for v in t.split(",")), 1) for t in args.shapes]
              if args.shapes else _shapes(args.kernel, args.config, batch))
    names = {"mlp": ("LN+MLP backward", "x[{0},{1}] H {2}"),
             "qkv": ("LN+qkv backward", "x[{0},{2}] 3C {3} tokens {1}"),
             "attn_ln": ("fused-LN attention backward",
                         "q[{0},{1},{3}] k,v[{0},{2},{3}]"),
             "attn_ln_fwd": ("fused-LN attention forward",
                             "q[{0},{1},{3}] k,v[{0},{2},{3}]")}
    what, fmt = names[args.kernel]
    rows = []
    for shape, calls in shapes:
        r = profile_shape(args.kernel, shape, args.iters, args.seed)
        r["calls_per_step"] = calls
        rows.append(r)
        bound = r.get("bound_ms", {})
        parts = ", ".join(
            f"{k} {v:.4f}" + (f" (bound {bound[k]:.4f})" if k in bound else "")
            for k, v in r["launches_ms"].items())
        label = fmt.format(*shape[:3], (shape[3] if args.kernel.startswith(
            "attn") else 3 * shape[3]) if len(shape) > 3 else 0)
        print(f"{label} (x{calls} a step): {r['ms']:.4f} ms "
              f"(iqr {r['ms_iqr'][0]:.4f}-{r['ms_iqr'][1]:.4f}); {parts}; "
              f"peak {r['peak_bytes_above_inputs'] / 2 ** 20:.1f} MiB")
    total = sum(r["ms"] * r["calls_per_step"] for r in rows)
    card = _card()
    where = "the shapes given" if args.shapes else (
        f"{args.config} batch {batch}: a train step")
    print(f"{total:.3f} ms of {what} for {where} ({card})")
    out = {"kernel": args.kernel,
           "config": None if args.shapes else args.config, "batch": batch,
           "card": card, "ms_total": total, "shapes": rows}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
