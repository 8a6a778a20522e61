"""Time the grouped LayerNorm (rows 12 and 13) at the shapes of the MViT-v2
448 pool norms and of the final norm, each call first held against its
plain version.

    python -m aicity_action_tpu_torch.tools.time_layer_norm [--iters 11]
        [--seed 0] [--out FILE.json]

Per pool norm of the batch-4 train step (blocks 0 q, 1 k, 4-13 k, 15 q)
and block 0 q at batch 8: the pool convolution's output ``t [B, h*96, L]``
normalized per head into rows ``[B*h, L, 96]``, forward and backward (the
backward's dx back in t's layout), timed three ways where the package has
them: ``copy+rows`` (the transpose to contiguous rows, ``fused_layer_norm``
on them and, backward, ``fused_layer_norm_bwd`` and the transpose of dx
back: what the model ran before the channel-major instance), ``rows`` (the
rows kernel alone on the contiguous rows) and ``channel-major``
(``pool_norm_rows`` / ``pool_norm_rows_bwd``, one launch each). The final
norm ``[B*1568, 768]`` at batch 8 and 1 (forward) and 4 (backward) by the
rows kernel. Every timed call is held to its plain version and timed by
``chip_smoke.py``'s own means (``check_outputs``: within 2% of the plain
version's largest magnitude; ``time_interleaved``: the median, with the
interquartile range, of ``--iters`` calls between CUDA events, each behind
a spin kernel). Prints one line per case, the card's name and power limit,
and one JSON object (written to ``--out`` too). A card is required. It
uses no more of the package than ``ops/layer_norm.py``, so run as a file
with another checkout first on ``PYTHONPATH`` it times that checkout's
kernels the same way: how two versions are compared in one call (A, B, B,
A).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# (what, batch, channels h * 96, tokens, heads)
POOL_NORMS = (("block 0 q", 4, 96, 100352, 1),
              ("block 1 k", 4, 192, 6272, 2),
              ("blocks 4-13 k", 4, 384, 1568, 4),
              ("block 15 q", 4, 768, 1568, 8),
              ("block 0 q (batch 8)", 8, 96, 100352, 1))
# (what, rows, forward or backward)
FINAL_NORMS = (("final norm (batch 8)", 8 * 1568, "fwd"),
               ("final norm (batch 1)", 1568, "fwd"),
               ("final norm (batch 4)", 4 * 1568, "bwd"))
D, EPS_POOL, EPS_FINAL = 96, 1e-5, 1e-6


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


def time_pool_norm(what, B, C, L, h, iters, gen) -> list:
    import torch

    from aicity_action_tpu_torch.ops import layer_norm as ln

    smoke = _smoke()
    t = torch.randn((B, C, L), generator=gen, device="cuda").bfloat16() * 2
    g = (torch.randn((D,), generator=gen, device="cuda") * 0.1 + 1).bfloat16()
    b = (torch.randn((D,), generator=gen, device="cuda") * 0.1).bfloat16()
    dy = torch.randn((B * h, L, D), generator=gen, device="cuda").bfloat16()

    def to_rows(a):
        return (a.reshape(B, h, D, L).transpose(2, 3).reshape(B * h, L, D)
                .contiguous())

    def to_cols(r):
        return (r.reshape(B, h, L, D).transpose(2, 3).reshape(B, C, L)
                .contiguous())

    def plain_fwd():
        return ln.layer_norm_plain(to_rows(t).float(), g.float(), b.float(),
                                   EPS_POOL)

    def plain_bwd():
        return smoke._plain_grads(
            lambda a, c, e: ln.layer_norm_plain(to_rows(a), c, e, EPS_POOL),
            (t, g, b), (dy,))

    def copy_rows_bwd():
        dx, dg, db = ln.fused_layer_norm_bwd(to_rows(t), g, dy, EPS_POOL)
        return to_cols(dx), dg, db

    r = to_rows(t)

    def plain_rows_bwd():
        return smoke._plain_grads(
            lambda a, c, e: ln.layer_norm_plain(a, c, e, EPS_POOL),
            (r, g, b), (dy,))

    ways = [("copy+rows", "fwd",
             lambda: ln.fused_layer_norm(to_rows(t), g, b, EPS_POOL),
             plain_fwd),
            ("copy+rows", "bwd", copy_rows_bwd, plain_bwd),
            ("rows", "fwd", lambda: ln.fused_layer_norm(r, g, b, EPS_POOL),
             plain_fwd),
            ("rows", "bwd",
             lambda: ln.fused_layer_norm_bwd(r, g, dy, EPS_POOL),
             plain_rows_bwd)]
    if hasattr(ln, "pool_norm_rows"):
        ways += [("channel-major", "fwd",
                  lambda: ln.pool_norm_rows(t, g, b, EPS_POOL, h), plain_fwd),
                 ("channel-major", "bwd",
                  lambda: ln.pool_norm_rows_bwd(t, g, dy, EPS_POOL, h),
                  plain_bwd)]
    out = []
    for way, direction, fn, plain in ways:
        m = _measure(f"{what} {way} {direction}", fn, plain, iters)
        out.append({"case": what, "shape": [B, C, L], "heads": h,
                    "way": way, "direction": direction, **m})
    return out


def time_final_norm(what, M, direction, iters, gen) -> dict:
    import torch

    from aicity_action_tpu_torch.ops import layer_norm as ln

    smoke = _smoke()
    C = 768
    x = torch.randn((M, C), generator=gen, device="cuda").bfloat16() * 2
    g = (torch.randn((C,), generator=gen, device="cuda") * 0.1 + 1).bfloat16()
    b = (torch.randn((C,), generator=gen, device="cuda") * 0.1).bfloat16()
    dy = torch.randn((M, C), generator=gen, device="cuda").bfloat16()
    if direction == "fwd":
        m = _measure(what, lambda: ln.fused_layer_norm(x, g, b, EPS_FINAL),
                     lambda: ln.layer_norm_plain(x.float(), g.float(),
                                                 b.float(), EPS_FINAL),
                     iters)
    else:
        m = _measure(
            what, lambda: ln.fused_layer_norm_bwd(x, g, dy, EPS_FINAL),
            lambda: smoke._plain_grads(
                lambda a, c, e: ln.layer_norm_plain(a, c, e, EPS_FINAL),
                (x, g, b), (dy,)), iters)
    return {"case": what, "shape": [M, C], "heads": 1, "way": "rows",
            "direction": direction, **m}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=11)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_layer_norm: needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for case in POOL_NORMS:
        rows += time_pool_norm(*case, args.iters, gen)
        torch.cuda.empty_cache()
    for case in FINAL_NORMS:
        rows.append(time_final_norm(*case, args.iters, gen))
    for r in rows:
        print(f"{r['case']} {r['shape']} {r['way']} {r['direction']}: "
              f"{r['ms']:.4f} ms (iqr {r['ms_iqr'][0]:.4f}-"
              f"{r['ms_iqr'][1]:.4f}), error {r['err_share']:.3f} of the 2% "
              "allowed", flush=True)
    card = _smoke().card_line()
    print(card)
    out = {"card": card, "cases": rows}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
