"""Time the convolutions of MViT-v2-B 16x4 @ 448 on the card, by layout.

    python -m aicity_action_tpu_torch.tools.bench_convs [--batch 8]

The convolutions are the ones the JAX package leaves to XLA and the port to
cuDNN / PyTorch: the patch-embed stem (3 -> 96 channels, kernel 3x7x7) and
the depthwise 3x3x3 pool convolutions of q, k and v in every block (k and v
share a shape). For each, on a bf16 input of the main path's shape, it
times with CUDA events:

- ``channels_last_view``: ``F.conv3d`` on a channels-last ``[B, T, H, W,
  C]`` tensor viewed as NCDHW (no copy), output made channels-last;
- ``ncdhw_copy``: the input copied to contiguous NCDHW and the output back
  to channels-last (``ops/pooling.py:depthwise_conv3d`` plus that copy);
- ``ncdhw``: an input already contiguous NCDHW, output left NCDHW;

and checks each against the first. The model runs the stem as
``channels_last_view`` and the pools as ``ncdhw`` (``fused_ln_qkv`` writes
q, k, v channel-major); ``model`` sums those. A card is required. Prints
one line per shape and one JSON object with the sums over a forward.
"""

from __future__ import annotations

import argparse
import json
import subprocess


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def conv_shapes(batch: int):
    """(label, [B, T, H, W, C_in], C_out, kernel, stride, padding, count)
    of every convolution in one forward."""
    from ..config import mvitv2_b_16x4_448_cfg
    from ..models.mvit import _pool_active, build_mvit_spec

    cfg = mvitv2_b_16x4_448_cfg()
    spec = build_mvit_spec(cfg)
    S = cfg.DATA.TEST_CROP_SIZE
    out = [("stem", (batch, cfg.DATA.NUM_FRAMES, S, S, 3), spec.embed_dim,
            spec.patch_kernel, spec.patch_stride, spec.patch_padding, 1)]
    thw = spec.patch_dims
    for i, b in enumerate(spec.blocks):
        shape = (batch, *thw, b.dim_out)
        for name, kernel, stride, count in (
                ("q", b.kernel_q, b.stride_q, 1),
                ("kv", b.kernel_kv, b.stride_kv, 2)):
            if _pool_active(kernel, stride):
                out.append((f"block {i} {name}", shape, b.dim_out,
                            tuple(kernel), tuple(stride),
                            tuple(k // 2 for k in kernel), count))
        if b.stride_q:
            thw = tuple((n + 2 - 3) // s + 1 for n, s in zip(thw, b.stride_q))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from ..ops.pooling import depthwise_conv3d

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    bf = torch.bfloat16

    names = ("channels_last_view", "ncdhw_copy", "ncdhw")
    totals = {n: 0.0 for n in (*names, "model")}
    rows = []
    for label, shape, c_out, k, s, pad, count in conv_shapes(args.batch):
        c_in = shape[-1]
        groups = 1 if label == "stem" else c_in
        x = torch.randn(shape, generator=gen, device="cuda").to(bf)
        x_ncdhw = x.permute(0, 4, 1, 2, 3).contiguous()
        w = (torch.randn((c_out, c_in // groups, *k), generator=gen,
                         device="cuda") * 0.2).to(bf)

        def view(x=x, w=w, s=s, pad=pad, groups=groups):
            return F.conv3d(x.permute(0, 4, 1, 2, 3), w, None, s, pad, 1,
                            groups).permute(0, 2, 3, 4, 1).contiguous()

        def copy(x=x, w=w, s=s, pad=pad, groups=groups):
            if groups > 1:
                return depthwise_conv3d(x, w, s, pad).contiguous()
            y = F.conv3d(x.permute(0, 4, 1, 2, 3).contiguous(), w, None, s,
                         pad, 1, groups)
            return y.permute(0, 2, 3, 4, 1).contiguous()

        def ncdhw(x=x_ncdhw, w=w, s=s, pad=pad, groups=groups):
            return F.conv3d(x, w, None, s, pad, 1, groups)

        ref = view().float()
        row = {"conv": label, "shape": list(shape), "c_out": c_out,
               "stride": list(s), "count": count,
               "model_layout": "channels_last_view" if label == "stem"
               else "ncdhw"}
        for name, fn in zip(names, (view, copy, ncdhw)):
            out = fn().float()
            if name == "ncdhw":
                out = out.permute(0, 2, 3, 4, 1)
            err = (out - ref).abs().max().item()
            if not err <= 0.05 * max(1.0, ref.abs().max().item()):
                raise SystemExit(f"{name} disagrees at {label}: {err}")
            row[name] = _time_ms(fn, args.iters)
            totals[name] += row[name] * count
        totals["model"] += row[row["model_layout"]] * count
        rows.append(row)
        print(f"# {label:11s} x{list(shape)} -> {c_out} stride {list(s)} "
              f"x{count}: " + ", ".join(f"{n} {row[n]:.3f} ms"
                                        for n in names))
        del x, x_ncdhw, w, ref, out
    print(f"# per forward ({card}): " + ", ".join(
        f"{n} {v:.3f} ms" for n, v in totals.items()))
    print(json.dumps({"card": card, "batch": args.batch,
                      "per_forward_ms": totals, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
