"""Driver ``score``: whole views scored back to back through the port's
``WindowScorer.score_chunks``, as a caller that has decoded chunks does.

Set-up: the port's model with the seed's weights, the mix's windows of one
view, a pool of I420 chunks on the host, then every batch size up to the
mix's through the model and one chunk's windows through the scorer. The
window (``port_bench/window.py:run_units``): views until another would
end past ``--seconds``; each view's chunks are pool chunks in an order
drawn from the seed, handed unpinned; a view ends when its scores are on
the host.

Correctness, once the window has closed and the program is freed: every
view holds every window once, in order, with finite scores summing to 1
(``failed`` counts the windows that do not); and a sample of windows drawn
from the seed, the first, the last and one that spans two chunks among
them, is scored again by the float32 reference from the same I420 frames
(``score_gap``, :func:`port_bench.compare.score_gap`).
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from port_bench import compare, reference, traffic as tr, weights, window
from port_bench.profiling import window_profile
from port_bench.program import port_cfg, port_model
from port_bench.reference.i420 import i420_to_rgb, normalise
from port_bench.reference.mvit import MViTReference


def sample(t: dict, seed: int, views: int, plans: list) -> list:
    """``(view, window)`` pairs to compare: ``check_windows`` of them."""
    F = t["chunk_frames"]
    straddle = next(w for w, p in enumerate(plans)
                    if p[2][0] // F != p[2][-1] // F)
    picks = [(0, 0), (views - 1, len(plans) - 1), (0, straddle)]
    rng = np.random.default_rng([weights.seed_of(seed, weights.INPUTS), 1])
    while len(picks) < t["check_windows"]:
        pick = (int(rng.integers(views)), int(rng.integers(len(plans))))
        if pick not in picks:
            picks.append(pick)
    return picks


def structural(preds: list, plans: list) -> int:
    """Windows of one view missing, out of place, or with scores that are
    not finite or do not sum to 1."""
    bad = max(0, len(plans) - len(preds))
    for (t0, t1, _), p in zip(plans, preds):
        s = np.asarray(p[2], np.float64)
        if (p[0], p[1]) != (t0, t1) or not np.isfinite(s).all() or abs(
                s.sum() - 1.0) > 1e-3:
            bad += 1
    return bad


def run(ctx):
    from aicity_action_tpu_torch.pipeline.window_inference import WindowScorer

    t, c, dev = ctx.traffic, ctx.config["cfg"], ctx.device
    s, T = c["DATA"]["TEST_CROP_SIZE"], c["DATA"]["NUM_FRAMES"]
    mean, std = c["DATA"]["MEAN"], c["DATA"]["STD"]
    B, F = t["batch_size"], t["chunk_frames"]
    ctx.mark("imports")
    model = port_model(port_cfg(ctx.config), weights.make(c, ctx.seed, dev),
                       dev).eval()
    plans = tr.view_windows(t)
    ctx.mark("model")
    pool = tr.i420_pool(t, s, ctx.seed, dev)
    ctx.mark("chunk pool")
    nck = tr.n_chunks(t)
    scorer = WindowScorer(model, batch_size=B, num_workers=1,
                          chunk_frames=F, chroma420=True)
    with torch.no_grad():
        for b in range(1, B + 1):
            model(torch.zeros((b, T, s, s, 3), device=dev))
    ctx.mark("batch sizes")
    # the first chunks' windows: the scorer's gather and conversion, and
    # the pinned host buffers that a view keeps in flight
    warm = t["warmup_chunks"]
    scorer.score_chunks(iter(pool * warm),
                        [p for p in plans if p[2][-1] < warm * F], s,
                        mean, std)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.mark("warm-up")
    rec = types.SimpleNamespace(kind="score", cfg=c, traffic=t,
                                setup_s=time.perf_counter() - ctx.t_start)
    orders, preds, timers, spans = [], [], [], []

    def view(v):
        t0 = time.perf_counter()
        order = tr.chunk_order(t, ctx.seed, v, nck)
        orders.append(order)
        preds.append(scorer.score_chunks((pool[j] for j in order), plans, s,
                                         mean, std))
        timers.append(dict(scorer.last_timers))
        spans.append(time.perf_counter() - t0)

    with window_profile(ctx.trace, rec):
        views, rec.window_s = window.run_units(view, ctx.seconds)
    rec.views, rec.windows = views, views * len(plans)
    rec.unit_s = spans
    rec.timers = {k: sum(tm[k] for tm in timers)
                  for k in ("upload", "dispatch", "drain")}
    rec.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
    del scorer, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rec.attempted = rec.windows
    rec.failed = sum(structural(p, plans) for p in preds)
    picks = sample(t, ctx.seed, views, plans)
    nan = np.full(c["MODEL"]["NUM_CLASSES"], np.nan)
    prog = torch.tensor(np.stack([preds[v][w][2] if w < len(preds[v])
                                  else nan for v, w in picks]))
    with reference.exact():
        ref = MViTReference(c, weights.make(c, ctx.seed, dev))
        out = []
        for i in range(0, len(picks), t["reference_batch"]):
            frames = np.stack([
                tr.window_frames(t, pool, orders[v], plans[w][2])
                for v, w in picks[i:i + t["reference_batch"]]])
            x = normalise(i420_to_rgb(torch.from_numpy(frames).to(dev), s),
                          mean, std)
            out.append(ref.scores(x).cpu())
    rec.checks = [
        compare.check("score_gap", compare.score_gap(prog, torch.cat(out)),
                      ctx.limits["score_gap"]),
        compare.check("bad_windows", float(rec.failed), 0.0)]
    return rec
