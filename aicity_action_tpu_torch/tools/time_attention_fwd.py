"""Time the attention forwards at the 448 shapes that carry most of their
launches, each call first held against its plain version.

    python -m aicity_action_tpu_torch.tools.time_attention_fwd [--iters 11]
        [--seed 0] [--out FILE.json]

Row 2 (``flash_attention_fwd`` with its logsumexp; q [G, Lq, 96], k, v
[G, Lk, 96] token rows) at the batch-4 train step's blocks 0, 1, 4-13 and
15, row 4 (``flash_attention_padded_fwd`` with its logsumexp) at the
cls-token MViT-v1 224's batch-8 blocks 0, 1 and 15, and row 5
(``flash_attention_ln``: d-major q, k, v, all three LNs and the residual)
at the v2 batch-8 forward's blocks 0, 1, 4-13 and 15. Each call is held
against the plain version, computed in f32 from the same bf16 inputs, and
timed by ``chip_smoke.py``'s own means: ``check_outputs`` (every output
within 2% of the plain one's largest magnitude) and ``time_interleaved``
(the median, with the interquartile range, of ``--iters`` calls between
CUDA events, each behind a spin kernel that hides the host's launches).
Prints one line per shape, the card's name and power limit, and one JSON
object (written to ``--out`` too). A card is required. It uses no more of
the package than the two wrappers and ``tools/profile_forward.py``, so run
as a file with another checkout first on ``PYTHONPATH`` it times that
checkout's kernels the same way: how two versions of a kernel are compared
in one call (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from aicity_action_tpu_torch.tools.profile_forward import _card

# (block, groups, Lq, Lk): row 2 at the v2 batch-4 train step, row 5 at
# the v2 batch-8 forward (blocks 4-13: ten calls each)
ROW2_SHAPES = (("0", 4, 100352, 1568), ("1", 8, 25088, 6272),
               ("4-13", 16, 6272, 1568), ("15", 32, 1568, 1568))
ROW4_SHAPES = (("0", 8, 25089, 393), ("1", 16, 6273, 1569),
               ("15", 64, 393, 393))
ROW5_SHAPES = (("0", 8, 100352, 1568), ("1", 16, 25088, 6272),
               ("4-13", 32, 6272, 1568), ("15", 64, 1568, 1568))
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


def _time_rows(row: int, blk: str, G: int, Lq: int, Lk: int, iters: int,
               gen) -> dict:
    import torch

    from aicity_action_tpu_torch.ops import flash_attention as fa

    fwd = fa.flash_attention_fwd if row == 2 else fa.flash_attention_padded_fwd
    q, k, v = (torch.randn((G, n, D), generator=gen, device="cuda")
               .bfloat16() for n in (Lq, Lk, Lk))
    s = D ** -0.5
    r = _measure(f"row {row} block {blk}", lambda: fwd(q, k, v, s, True),
                 lambda: fa.flash_attention_lse_plain(q.float(), k.float(),
                                                      v.float(), s), iters)
    return {"row": row, "block": blk, "shape": [G, Lq, Lk], **r}


def time_row2(blk: str, G: int, Lq: int, Lk: int, iters: int, gen) -> dict:
    return _time_rows(2, blk, G, Lq, Lk, iters, gen)


def time_row4(blk: str, G: int, Lq: int, Lk: int, iters: int, gen) -> dict:
    return _time_rows(4, blk, G, Lq, Lk, iters, gen)


def time_row5(blk: str, G: int, Lq: int, Lk: int, iters: int, gen) -> dict:
    import torch

    from aicity_action_tpu_torch.ops import flash_attention as fa

    q, k, v = (torch.randn((G, D, n), generator=gen, device="cuda")
               .bfloat16().transpose(1, 2) for n in (Lq, Lk, Lk))
    # (gamma, beta) of q, k, v: around 1 and around 0
    lnp = [(torch.randn(D, generator=gen, device="cuda") * 0.1
            + (1 - i % 2)).bfloat16() for i in range(6)]
    args = (q, k, v, *lnp, D ** -0.5, 1e-5, (True, True, True), True)
    r = _measure(f"row 5 block {blk}", lambda: fa.flash_attention_ln(*args),
                 lambda: fa.flash_attention_ln_plain(
                     *(t.float() for t in (q, k, v, *lnp)), *args[9:]),
                 iters)
    return {"row": 5, "block": blk, "shape": [G, Lq, Lk], **r}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=11)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_attention_fwd: needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for fn, shapes in ((time_row2, ROW2_SHAPES), (time_row4, ROW4_SHAPES),
                       (time_row5, ROW5_SHAPES)):
        for shape in shapes:
            r = fn(*shape, args.iters, gen)
            rows.append(r)
            torch.cuda.empty_cache()
            G, Lq, Lk = r["shape"]
            print(f"row {r['row']} block {r['block']} q[{G},{Lq},{D}] "
                  f"k,v[{G},{Lk},{D}]: {r['ms']:.4f} ms (iqr "
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
