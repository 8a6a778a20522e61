"""Time the serving path's kernels (rows 1, 5, 8, 10 and 12) at the
MViT-v2-B 16x4 @448 batch-8 shapes, each call first held against its plain
version.

    python -m aicity_action_tpu_torch.tools.time_serving_rows [--iters 11]
        [--seed 0] [--out FILE.json]

Row 8 (``fused_ln_qkv``) at blocks 0, 1, 4-13 and 15; row 5
(``flash_attention_ln``: d-major q, k, v, all three LNs and the residual)
at blocks 0, 1, 4-13 and 15; row 10 (``fused_ln_mlp``) at C 96, 192, 384
and 768; row 1 (``flash_attention_fwd`` without its logsumexp, the unfused
eval path) at blocks 0 and 15; row 12's rows instance at the final norm
``[B*1568, 768]`` and the v1 224's cls-token pool norm ``[B*2*6273, 96]``.
Each call is held to its plain version and timed by ``chip_smoke.py``'s
own means (``check_outputs``: within 2% of the plain version's largest
magnitude; ``time_interleaved``: the median, with the interquartile range,
of ``--iters`` calls between CUDA events, each behind a spin kernel).
Prints one line per case, the card's name and power limit, and one JSON
object (written to ``--out`` too). A card is required. It uses no more of
the package than the wrappers in ``ops/``, so run as a file with another
checkout first on ``PYTHONPATH`` it times that checkout's kernels the same
way: how two versions are compared in one call (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BATCH = 8
# (block, tokens, D, C)
QKV = (("0", 100352, 96, 96), ("1", 100352, 96, 192),
       ("4-13", 6272, 384, 384), ("15", 1568, 768, 768))
# (block, heads, Lq, Lk)
ATTN = (("0", 1, 100352, 1568), ("1", 2, 25088, 6272),
        ("4-13", 4, 6272, 1568), ("15", 8, 1568, 1568))
# (block, rows a clip, C)
MLP = (("0", 100352, 96), ("1", 25088, 192), ("4", 6272, 384),
       ("15", 1568, 768))
# (block, heads, Lq, Lk): the unfused path's attention without lse
ROW1 = (("0", 1, 100352, 1568), ("15", 8, 1568, 1568))
# (what, rows, channels, eps)
ROWS_NORMS = (("final norm", BATCH * 1568, 768, 1e-6),
              ("v1 block 1 q pool norm", BATCH * 2 * 6273, 96, 1e-5))
D = 96


def _smoke():
    """The repo's ``chip_smoke.py``, for its output check and its timer
    (the repo root goes last on the path, so that a checkout first on
    ``PYTHONPATH`` still supplies the package)."""
    root = str(Path(__file__).resolve().parents[2])
    if root not in sys.path:
        sys.path.append(root)
    import chip_smoke

    return chip_smoke


def _measure(name: str, fn, plain, iters: int) -> dict:
    """``fn()`` held against ``plain()``, then timed: its error as a share
    of the 2% allowed, and its median and interquartile range (ms)."""
    smoke = _smoke()
    _, _, rel = smoke.check_outputs(name, fn(), plain())
    t = smoke.time_interleaved([fn], iters)[0]
    return {"err_share": rel / smoke.KERNEL_RTOL, "ms": t["ms"],
            "ms_iqr": t["iqr"]}


def cases(gen):
    """``(row, label, kernel call, plain call)`` of every timed shape, the
    inputs drawn from ``gen`` as each case is reached."""
    import torch

    from aicity_action_tpu_torch.ops import flash_attention as fa
    from aicity_action_tpu_torch.ops import fused_dense as fd
    from aicity_action_tpu_torch.ops import layer_norm as ln

    bf = torch.bfloat16

    def normal(shape, std=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std
                + shift).to(bf)

    for blk, L, Din, C in QKV:
        M = BATCH * L
        args = (normal((M, Din)), normal((Din,), 0.1, 1.0),
                normal((Din,), 0.1), normal((3 * C, Din), Din ** -0.5),
                normal((3 * C,), 0.1), 1e-6)
        yield (8, f"block {blk} x[{M},{Din}] w[{3 * C},{Din}]",
               lambda a=args, L=L: fd.fused_ln_qkv(*a, tokens=L),
               lambda a=args, L=L: fd.ln_qkv_plain(*a, tokens=L))
    for blk, h, Lq, Lk in ATTN:
        G = BATCH * h
        q, k, v = (normal((G, D, n)).transpose(1, 2) for n in (Lq, Lk, Lk))
        lnp = [normal((D,), 0.1, 1 - i % 2) for i in range(6)]
        args = (q, k, v, *lnp, D ** -0.5, 1e-5, (True, True, True), True)
        yield (5, f"block {blk} q[{G},{Lq},{D}] k,v[{G},{Lk},{D}] d-major",
               lambda a=args: fa.flash_attention_ln(*a),
               lambda a=args: fa.flash_attention_ln_plain(*a))
    for blk, L, C in MLP:
        M, H = BATCH * L, 4 * C
        args = (normal((M, C)), normal((C,), 0.1, 1.0), normal((C,), 0.1),
                normal((H, C), C ** -0.5), normal((H,), 0.1),
                normal((C, H), H ** -0.5), normal((C,), 0.1), 1e-6)
        yield (10, f"block {blk} x[{M},{C}] H {H}",
               lambda a=args: fd.fused_ln_mlp(*a),
               lambda a=args: fd.ln_mlp_plain(*a))
    for blk, h, Lq, Lk in ROW1:
        G = BATCH * h
        q, k, v = (normal((G, n, D)) for n in (Lq, Lk, Lk))
        s = D ** -0.5
        yield (1, f"block {blk} q[{G},{Lq},{D}] k,v[{G},{Lk},{D}] (no lse)",
               lambda q=q, k=k, v=v: fa.flash_attention_fwd(q, k, v, s,
                                                            False)[0],
               lambda q=q, k=k, v=v: fa.flash_attention_plain(
                   q.float(), k.float(), v.float(), s))
    for what, M, C, eps in ROWS_NORMS:
        args = (normal((M, C), 2.0), normal((C,), 0.1, 1.0),
                normal((C,), 0.1), eps, 1)
        yield (12, f"{what} x[{M},{C}] (rows)",
               lambda a=args: ln.fused_layer_norm(*a),
               lambda a=args: ln.layer_norm_plain(*a))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=11)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    from aicity_action_tpu_torch.tools.profile_forward import _card

    if not torch.cuda.is_available():
        raise SystemExit("time_serving_rows: needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for row, label, fn, plain in cases(gen):
        r = {"row": row, "shape": label,
             **_measure(f"row {row} {label}", fn, plain, args.iters)}
        rows.append(r)
        torch.cuda.empty_cache()
        print(f"row {row} {label}: {r['ms']:.4f} ms (iqr "
              f"{r['ms_iqr'][0]:.4f}-{r['ms_iqr'][1]:.4f}), error "
              f"{r['err_share']:.3f} of the 2% allowed", flush=True)
    card = _card()
    print(card)
    out = {"card": card, "shapes": rows}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
