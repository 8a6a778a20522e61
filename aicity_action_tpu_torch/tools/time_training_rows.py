"""Time the training path's kernels (rows 2, 3, 9, 11 and 13; with
``--rows``, also 6 and 7, the fused-LN attention's of
``AICITY_TPU_FUSE_ATTN_LN=1``) at the MViT-v2-B 16x4 @448 batch-4
train-step shapes, each call first held against its plain version.

    python -m aicity_action_tpu_torch.tools.time_training_rows [--iters 11]
        [--seed 0] [--rows 2,3,9,11,13] [--out FILE.json]

Row 2 (``flash_attention_fwd`` with its logsumexp) at blocks 0, 1, 4-13 and
15; row 3 (``flash_attention_bwd``) at blocks 0, 1, 3, 4-13, 14 and 15;
rows 6 (``flash_attention_ln_lse``) and 7 (``flash_attention_ln_bwd``) at
the same blocks as rows 2 and 3 (d-major q, k, v, all three pool norms and
the residual);
row 9 (``fused_ln_qkv_bwd``) at blocks 0, 1, 4-13 and 15; row 11
(``fused_ln_mlp_bwd``) at C 96, 192, 384 and 768; row 13 at the final norm
``[B*1568, 768]`` (the rows instance) and block 0's q pool norm (the
channel-major one). Each call is held to its plain version (the
backwards': autograd of the plain forward in f32 from the same bf16
inputs) and timed by ``chip_smoke.py``'s own means, as
``time_serving_rows.py`` times the serving rows (``check_outputs``: within
2% of the plain version's largest magnitude; ``time_interleaved``: the
median, with the interquartile range, of ``--iters`` calls between CUDA
events, each behind a spin kernel). Prints one line per case, the card's
name and power limit, and one JSON object (written to ``--out`` too). A
card is required. It uses no more of the package than the wrappers in
``ops/``, so run as a file with another checkout first on ``PYTHONPATH``
it times that checkout's kernels the same way: how two versions are
compared in one call (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BATCH = 4
D = 96
# (block, heads, Lq, Lk): the forward with lse, then the backward also at
# blocks 3 and 14
ATTN_FWD = (("0", 1, 100352, 1568), ("1", 2, 25088, 6272),
            ("4-13", 4, 6272, 1568), ("15", 8, 1568, 1568))
ATTN_BWD = ATTN_FWD[:2] + (("3", 4, 6272, 6272),) + ATTN_FWD[2:3] + (
    ("14", 8, 1568, 6272),) + ATTN_FWD[3:]
# (block, tokens, D, C)
QKV = (("0", 100352, 96, 96), ("1", 100352, 96, 192),
       ("4-13", 6272, 384, 384), ("15", 1568, 768, 768))
# (block, rows a clip, C)
MLP = (("0", 100352, 96), ("1", 25088, 192), ("4", 6272, 384),
       ("15", 1568, 768))


def _smoke():
    """This tree's ``chip_smoke.py``, for its output check, timer and plain
    gradients (the tree's root goes last on the path, so that a checkout
    first on ``PYTHONPATH`` still supplies the package; the same helper as
    ``time_serving_rows.py``'s, kept here so that the other checkout's copy
    of that tool is not the one imported)."""
    root = str(Path(__file__).resolve().parents[2])
    if root not in sys.path:
        sys.path.append(root)
    import chip_smoke

    return chip_smoke


# outputs whose exact value is zero, held to another's magnitude
# (check_outputs' zero_grads): row 7's k norm bias gradient (softmax
# ignores one shift of every key) to the k norm scale's
ZERO_GRADS = {7: {6: 5}}


def _measure(name: str, fn, plain, iters: int, zero_grads=None) -> dict:
    """``fn()`` held against ``plain()``, then timed: its error as a share
    of the 2% allowed, and its median and interquartile range (ms)."""
    smoke = _smoke()
    _, _, rel = smoke.check_outputs(name, fn(), plain(), zero_grads)
    t = smoke.time_interleaved([fn], iters)[0]
    return {"err_share": rel / smoke.KERNEL_RTOL, "ms": t["ms"],
            "ms_iqr": t["iqr"]}


def _ln_inputs(normal, G, Lq, Lk):
    """Rows 6-7's inputs: d-major q, k, v and the three norms' gamma /
    beta."""
    q, k, v = (normal((G, D, n)).transpose(1, 2) for n in (Lq, Lk, Lk))
    lnp = [t for _ in range(3) for t in (normal((D,), 0.1, 1.0),
                                         normal((D,), 0.1))]
    return q, k, v, lnp


def cases(gen, rows=(2, 3, 9, 11, 13)):
    """``(row, label, kernel call, plain call)`` of every timed shape of
    ``rows``, the inputs drawn from ``gen`` as each case is reached."""
    import torch

    from aicity_action_tpu_torch.ops import flash_attention as fa
    from aicity_action_tpu_torch.ops import fused_dense as fd
    from aicity_action_tpu_torch.ops import layer_norm as ln

    grads = _smoke()._plain_grads
    bf = torch.bfloat16

    def normal(shape, std=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std
                + shift).to(bf)

    s = D ** -0.5
    flags = (True, True, True)

    def ln_plain(*a):
        return fa.flash_attention_ln_plain(*a, s, 1e-5, flags, True)

    for blk, h, Lq, Lk in ATTN_FWD if 6 in rows else ():
        q, k, v, lnp = _ln_inputs(normal, BATCH * h, Lq, Lk)
        yield (6, f"block {blk} q[{BATCH * h},{Lq},{D}] k,v[{BATCH * h},"
                  f"{Lk},{D}] d-major (+ lse)",
               lambda a=(q, k, v, *lnp): fa.flash_attention_ln_lse(
                   *a, s, 1e-5, flags, True)[0],
               lambda a=(q, k, v, *lnp): ln_plain(*(t.float() for t in a)))
    for blk, h, Lq, Lk in ATTN_BWD if 7 in rows else ():
        q, k, v, lnp = _ln_inputs(normal, BATCH * h, Lq, Lk)
        _, lse, oa = fa.flash_attention_ln_lse(q, k, v, *lnp, s, 1e-5, flags,
                                               True)
        dout = normal((BATCH * h, Lq, D))
        yield (7, f"block {blk} q[{BATCH * h},{Lq},{D}] k,v[{BATCH * h},"
                  f"{Lk},{D}] d-major",
               lambda a=(q, k, v, *lnp, oa, lse, dout):
                   fa.flash_attention_ln_bwd(*a, s, 1e-5, flags, True),
               lambda a=(q, k, v, *lnp), dout=dout: grads(ln_plain, a,
                                                          (dout,)))
    for blk, h, Lq, Lk in ATTN_FWD if 2 in rows else ():
        q, k, v = (normal((BATCH * h, n, D)) for n in (Lq, Lk, Lk))
        yield (2, f"block {blk} q[{BATCH * h},{Lq},{D}] k,v[{BATCH * h},"
                  f"{Lk},{D}] (+ lse)",
               lambda q=q, k=k, v=v: fa.flash_attention_fwd(q, k, v, s, True),
               lambda q=q, k=k, v=v: fa.flash_attention_lse_plain(
                   q.float(), k.float(), v.float(), s))
    for blk, h, Lq, Lk in ATTN_BWD if 3 in rows else ():
        q, k, v = (normal((BATCH * h, n, D)) for n in (Lq, Lk, Lk))
        out, lse = fa.flash_attention_fwd(q, k, v, s, True)
        dout = normal((BATCH * h, Lq, D))
        yield (3, f"block {blk} q[{BATCH * h},{Lq},{D}] k,v[{BATCH * h},"
                  f"{Lk},{D}]",
               lambda a=(q, k, v, out, lse, dout): fa.flash_attention_bwd(
                   *a, s),
               lambda a=(q, k, v), dout=dout: grads(
                   lambda x, y, z: fa.flash_attention_plain(x, y, z, s), a,
                   (dout,)))
    for blk, L, Din, C in QKV if 9 in rows else ():
        M = BATCH * L
        args = (normal((M, Din)), normal((Din,), 0.1, 1.0),
                normal((Din,), 0.1), normal((3 * C, Din), Din ** -0.5))
        bias = normal((3 * C,), 0.1)
        gs = tuple(normal((BATCH, C, L)) for _ in range(3))
        yield (9, f"block {blk} x[{M},{Din}] w[{3 * C},{Din}]",
               lambda a=args, gs=gs, L=L: fd.fused_ln_qkv_bwd(
                   *a, *gs, 1e-6, L),
               lambda a=args + (bias,), gs=gs, L=L: grads(
                   lambda *t: fd.ln_qkv_plain(*t, 1e-6, L), a, gs))
    for blk, L, C in MLP if 11 in rows else ():
        M, H = BATCH * L, 4 * C
        args = (normal((M, C)), normal((C,), 0.1, 1.0), normal((C,), 0.1),
                normal((H, C), C ** -0.5), normal((H,), 0.1),
                normal((C, H), H ** -0.5))
        b2, dout = normal((C,), 0.1), normal((M, C))
        yield (11, f"block {blk} x[{M},{C}] H {H}",
               lambda a=args, dout=dout: fd.fused_ln_mlp_bwd(*a, dout, 1e-6),
               lambda a=args + (b2,), dout=dout: grads(
                   lambda *t: fd.ln_mlp_plain(*t, 1e-6), a, (dout,)))
    if 13 not in rows:
        return
    M, C = BATCH * 1568, 768
    x, g, b, dy = (normal((M, C), 2.0), normal((C,), 0.1, 1.0),
                   normal((C,), 0.1), normal((M, C)))
    yield (13, f"final norm x[{M},{C}] (rows)",
           lambda: ln.fused_layer_norm_bwd(x, g, dy, 1e-6, 1),
           lambda: grads(lambda *t: ln.layer_norm_plain(*t, 1e-6, 1),
                         (x, g, b), (dy,)))
    L = 100352
    t, gq, bq, dyq = (normal((BATCH, D, L), 2.0), normal((D,), 0.1, 1.0),
                      normal((D,), 0.1), normal((BATCH, L, D)))
    yield (13, f"block 0 q pool norm t[{BATCH},{D},{L}] (channel-major)",
           lambda: ln.pool_norm_rows_bwd(t, gq, dyq, 1e-5, 1),
           lambda: grads(lambda *a: ln.pool_norm_rows_plain(*a, 1e-5, 1),
                         (t, gq, bq), (dyq,)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=11)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rows", default="2,3,9,11,13",
                   help="the rows to time, of 2, 3, 6, 7, 9, 11, 13")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    from aicity_action_tpu_torch.tools.profile_forward import _card

    if not torch.cuda.is_available():
        raise SystemExit("time_training_rows: needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    rows_asked = tuple(int(r) for r in args.rows.split(","))
    for row, label, fn, plain in cases(gen, rows_asked):
        r = {"row": row, "shape": label,
             **_measure(f"row {row} {label}", fn, plain, args.iters,
                        ZERO_GRADS.get(row))}
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
