"""Where the time of the LN+MLP backward (``fused_ln_mlp_bwd``, the
default) or of the LN+qkv backward (``fused_ln_qkv_bwd``, ``--kernel qkv``)
goes on the card, launch by launch, at the shapes a train step gives it.

    python -m aicity_action_tpu_torch.tools.profile_mlp_bwd
        [--kernel mlp|qkv] [--config v2_448|v1_224|l_448] [--batch N]
        [--shapes M,C,H ... | M,tokens,D,C ...] [--iters 11] [--out FILE.json]

For every distinct call of the kernel in the config's train step at
``--batch`` (4 for v2_448 and l_448, MViT-v2-L's trunk, 8 for v1_224 by
default; from the model's block
schedule, no model is built), or for each ``--shapes`` tuple (``M,C,H`` for
the MLP, ``M,tokens,D,C`` for the qkv), it draws bf16 inputs from
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
    ``(M, C, H)`` for the MLP, ``(M, tokens, D, C)`` for the qkv."""
    from aicity_action_tpu_torch.models.mvit import dense_call_shapes

    cfg = _config(config)
    counts: dict = {}
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
    return {"shape": list(shape), "ms": ms[n // 2],
            "ms_iqr": [ms[n // 4], ms[(3 * n) // 4]],
            "launches_ms": _label_launches(kernel, kernels, iters),
            "peak_bytes_above_inputs": peak}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--kernel", choices=sorted(LAUNCHES), default="mlp")
    p.add_argument("--config", choices=("v2_448", "v1_224", "l_448"),
                   default="v2_448")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--shapes", nargs="*", default=None,
                   help="M,C,H (mlp) or M,tokens,D,C (qkv) tuples in place "
                   "of the config's calls")
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
    names = {"mlp": ("LN+MLP", "x[{0},{1}] H {2}"),
             "qkv": ("LN+qkv", "x[{0},{2}] 3C {3} tokens {1}")}
    what, fmt = names[args.kernel]
    rows = []
    for shape, calls in shapes:
        r = profile_shape(args.kernel, shape, args.iters, args.seed)
        r["calls_per_step"] = calls
        rows.append(r)
        parts = ", ".join(f"{k} {v:.4f}" for k, v in r["launches_ms"].items())
        label = fmt.format(*shape[:3], 3 * shape[3] if len(shape) > 3 else 0)
        print(f"{label} (x{calls} a step): {r['ms']:.4f} ms "
              f"(iqr {r['ms_iqr'][0]:.4f}-{r['ms_iqr'][1]:.4f}); {parts}; "
              f"peak {r['peak_bytes_above_inputs'] / 2 ** 20:.1f} MiB")
    total = sum(r["ms"] * r["calls_per_step"] for r in rows)
    card = _card()
    where = "the shapes given" if args.shapes else (
        f"{args.config} batch {batch}: a train step")
    print(f"{total:.3f} ms of {what} backward for {where} ({card})")
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
