"""The readings that a cell's limits are set from, apart from the program's
own (which the benchmark's runs print).

    python -m port_bench.control --workload <cell> --seeds 1,2,3
        [--fault half_batch]

For each seed, at the cell's own sizes, the float32 reference against

- the control: the same reference computed in float8 at every product's
  inputs (:func:`port_bench.reference.quant.fp8`; the configuration states
  bfloat16), put in the program's place; or
- with ``--fault half_batch`` (training cells): the float32 reference
  that leaves out half of each batch and takes the mean over the rest.

A score cell compares the sample of windows that a run's first view would
(``score_gap``); a training cell the checked steps (``loss_gap``,
``grad_gap``, ``change_gap``). Prints one JSON line a seed. The
benchmark's runs never run this; a card is required.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from port_bench import compare, reference, traffic as tr, weights
from port_bench.reference.i420 import i420_to_rgb, normalise
from port_bench.reference.mvit import MViTReference
from port_bench.reference.quant import fp8
from port_bench.reference.train import follow


def score_readings(ctx) -> dict:
    from port_bench.drivers.score import sample

    t, c, dev = ctx.traffic, ctx.config["cfg"], ctx.device
    s, D = c["DATA"]["TEST_CROP_SIZE"], c["DATA"]
    plans = tr.view_windows(t)
    pool = tr.i420_pool(t, s, ctx.seed, dev)
    order = tr.chunk_order(t, ctx.seed, 0, tr.n_chunks(t))
    picks = sample(t, ctx.seed, 1, plans)
    with reference.exact():
        params = weights.make(c, ctx.seed, dev)
        ref, low = MViTReference(c, params), MViTReference(c, params, fp8)
        out_ref, out_low = [], []
        for i in range(0, len(picks), t["reference_batch"]):
            frames = np.stack([tr.window_frames(t, pool, order, plans[w][2])
                               for _, w in picks[i:i + t["reference_batch"]]])
            x = normalise(i420_to_rgb(torch.from_numpy(frames).to(dev), s),
                          D["MEAN"], D["STD"])
            out_ref.append(ref.scores(x).cpu())
            out_low.append(low.scores(x).cpu())
    return {"score_gap": compare.score_gap(torch.cat(out_low),
                                           torch.cat(out_ref))}


def train_readings(ctx, fault: str | None) -> dict:
    from port_bench.drivers.train import checks

    t, c, dev = ctx.traffic, ctx.config["cfg"], ctx.device
    D = c["DATA"]

    def side(**kw):
        with reference.exact():
            return follow(c, weights.make(c, ctx.seed, dev),
                          tr.clip_batches(t, D["NUM_FRAMES"],
                                          D["TRAIN_CROP_SIZE"],
                                          c["MODEL"]["NUM_CLASSES"],
                                          ctx.seed, dev),
                          ctx.seed, t["checked_steps"], t["steps_per_epoch"],
                          **kw)

    ref = side()
    other = side(half_batch=True) if fault == "half_batch" else side(
        quant=fp8)
    limits = {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
    return {ch["name"]: ch["value"] for ch in checks(other, ref, limits)}


def readings(ctx, fault: str | None = None) -> dict:
    if ctx.traffic["driver"] == "score":
        if fault:
            raise ValueError(f"no fault {fault!r} for a score cell")
        return score_readings(ctx)
    return train_readings(ctx, fault)


def main(argv=None) -> int:
    import time

    from port_bench import run
    from port_bench.registry import Registry

    p = argparse.ArgumentParser(prog="python -m port_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", choices=("half_batch",), default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA card", file=sys.stderr)
        return 2
    registry = Registry(Path.cwd())
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = run.context(registry, args.workload, argparse.Namespace(
            seed=seed, seconds=0.0, trace=0), torch.device("cuda", 0), t0)
        out = readings(ctx, args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault or "control", **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
