#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``aicity_action_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

1. Builds the four CUDA kernels from ``aicity_action_tpu_torch/csrc`` with
   nvcc (sm_90a) and prints the card's name and power limit.
2. Holds each kernel against its plain PyTorch version at main-path
   shapes of MViT-v2-B 16x4 @ 448 (batch 8, bf16; every tile
   configuration a kernel has on the path) and times the kernel, the plain
   version and a PyTorch library yardstick with CUDA events.
3. Builds the full model (16 blocks, bf16, weights from a seed), runs
   batch-8 forwards, checks the kernel launches per forward, and compares a
   batch-1 forward with the same model in its plain reference mode.
4. Drives the main path, ``WindowScorer``, over a synthetic in-memory I420
   video, with the launch counts set to 0 just before and read just after;
   checks the windows against a direct forward and round-trips the pickle.
5. Prints ``{"kernels": [...]}``, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the run exits non-zero and prints no result.
With no CUDA card, or without the package beside this file, it exits 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
BATCH = 8
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# kernel vs plain version in bf16: outputs are rounded to bf16 (relative
# step 2^-8) and the two may round their bf16 intermediates (LN'd operands,
# softmax weights, the MLP hidden) one ulp apart, so allow 2% of the
# output's largest magnitude
KERNEL_RTOL = 0.02

_REPO = os.path.dirname(os.path.abspath(__file__))


def _fail(msg: str) -> None:
    raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_kernels():
    from aicity_action_tpu_torch.ops import kernels

    t = time.time()
    so = kernels.build()
    kernels.lib()
    log = (kernels.BUILD_DIR / "build.log")
    usage = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    print(f"# built {so.name} in {time.time() - t:.1f} s")
    for ln in usage:
        print(f"#   {ln}")


# ------------------------------------------------------------------ kernels

def _normal(gen, shape, std=1.0, dtype=None, device="cuda"):
    import torch

    t = torch.randn(shape, generator=gen, device=device) * std
    return t.to(dtype) if dtype is not None else t


def _check_case(name, kernel_fn, plain_fn, library_fn, flops, nbytes,
                peak, iters):
    """Compare one kernel call with its plain version, time all three."""
    import torch

    out = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err, scale = 0.0, 1.0
    for o, r in zip(outs, refs):
        if o.shape != r.shape or not torch.isfinite(o).all():
            _fail(f"{name}: non-finite or mis-shaped output")
        err = max(err, (o.float() - r.float()).abs().max().item())
        scale = max(scale, r.float().abs().max().item())
    tol = KERNEL_RTOL * scale
    if not err <= tol:
        _fail(f"{name}: max |kernel - plain| {err} > {tol}")
    del out, ref, outs, refs
    ms = time_ms(kernel_fn, iters)
    plain_ms = time_ms(plain_fn, max(1, iters // 5))
    library_ms = time_ms(library_fn, iters) if library_fn else None
    bound_ms = max(flops / peak, nbytes / PEAK_BYTES) * 1e3
    return {
        "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if flops / peak > nbytes / PEAK_BYTES
        else "bytes",
        "library_ms": library_ms,
    }


def kernel_checks():
    """Each kernel at its main-path shapes (batch 8 unless stated)."""
    import torch
    import torch.nn.functional as F

    from aicity_action_tpu_torch.ops import flash_attention as fa
    from aicity_action_tpu_torch.ops import fused_dense as fd
    from aicity_action_tpu_torch.ops import layer_norm as ln

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}

    # fused_layer_norm: the final norm [B*1568, 768], groups 1, eps 1e-6
    cases = []
    for b in (BATCH, 1):
        M, C = b * 1568, 768
        x = _normal(gen, (M, C), 2.0, bf)
        g = _normal(gen, (C,), 0.1, bf) + 1
        bb = _normal(gen, (C,), 0.1, bf)
        r = _check_case(
            "fused_layer_norm",
            lambda: ln.fused_layer_norm(x, g, bb, 1e-6, 1),
            lambda: ln.layer_norm_plain(x, g, bb, 1e-6, 1),
            lambda: F.layer_norm(x, (C,), g, bb, 1e-6),
            flops=8 * M * C, nbytes=2 * (2 * M * C + 2 * C), peak=PEAK_F32,
            iters=50)
        r["shape"] = f"final norm x[{M},{C}] groups 1 (batch {b})"
        cases.append(r)
    results["fused_layer_norm"] = cases

    # fused_ln_qkv: block 0 (D 96 -> 3C 288 over 100352 tokens), blocks
    # 4-13 (D 384 -> 3C 1152 over 6272 tokens; the 128-column tiles) and
    # block 15 (D 768 -> 3C 2304 over 1568 tokens), writing channel-major
    # [B, C, L]
    cases = []
    for blk, L, D, C in ((0, 100352, 96, 96), (4, 6272, 384, 384),
                         (15, 1568, 768, 768)):
        M = BATCH * L
        x = _normal(gen, (M, D), 1.0, bf)
        g = _normal(gen, (D,), 0.1, bf) + 1
        bb = _normal(gen, (D,), 0.1, bf)
        w = _normal(gen, (3 * C, D), D ** -0.5, bf)
        bias = _normal(gen, (3 * C,), 0.1, bf)
        args = (x, g, bb, w, bias, 1e-6)

        def library(x=x, g=g, bb=bb, w=w, bias=bias, D=D):
            return F.linear(F.layer_norm(x, (D,), g, bb, 1e-6), w, bias)

        r = _check_case(
            "fused_ln_qkv",
            lambda args=args, L=L: fd.fused_ln_qkv(*args, tokens=L),
            lambda args=args, L=L: fd.ln_qkv_plain(*args, tokens=L),
            library,
            flops=2 * M * D * 3 * C,
            nbytes=2 * (M * D + 3 * M * C + 3 * C * D + 3 * C + 2 * D),
            peak=PEAK_BF16, iters=20)
        r["shape"] = f"block {blk} x[{M},{D}] w[{3 * C},{D}] -> [B,C,L]"
        cases.append(r)
        del x, w, args
    results["fused_ln_qkv"] = cases

    # fused_ln_mlp: one block of each tile configuration: block 0 (C 96
    # over 100352 tokens), block 1 (C 192 over 25088), block 4 (C 384 over
    # 6272) and block 15 (C 768 over 1568); H = 4C
    cases = []
    for blk, L, C in ((0, 100352, 96), (1, 25088, 192), (4, 6272, 384),
                      (15, 1568, 768)):
        M, H = BATCH * L, 4 * C
        x = _normal(gen, (M, C), 1.0, bf)
        g = _normal(gen, (C,), 0.1, bf) + 1
        bb = _normal(gen, (C,), 0.1, bf)
        w1 = _normal(gen, (H, C), C ** -0.5, bf)
        b1 = _normal(gen, (H,), 0.1, bf)
        w2 = _normal(gen, (C, H), H ** -0.5, bf)
        b2 = _normal(gen, (C,), 0.1, bf)
        args = (x, g, bb, w1, b1, w2, b2, 1e-6)

        def library(x=x, g=g, bb=bb, w1=w1, b1=b1, w2=w2, b2=b2, C=C):
            h = F.gelu(F.linear(F.layer_norm(x, (C,), g, bb, 1e-6), w1, b1))
            return F.linear(h, w2, b2)

        r = _check_case(
            "fused_ln_mlp",
            lambda args=args: fd.fused_ln_mlp(*args),
            lambda args=args: fd.ln_mlp_plain(*args),
            library,
            flops=2 * M * (C * H + H * C),
            nbytes=2 * (2 * M * C + 2 * C * H + H + 3 * C),
            peak=PEAK_BF16, iters=10)
        r["shape"] = f"block {blk} x[{M},{C}] H {H}"
        cases.append(r)
    results["fused_ln_mlp"] = cases

    # flash_attention_ln: block 0 (h 1, Lq 100352, Lk 1568) and block 1
    # (h 2, Lq 25088, Lk 6272); d 96, all three LNs and the q-residual; q,
    # k, v are the d-major views the main path passes (pool outputs
    # [G, d, L])
    cases = []
    d = 96
    for blk, h, Lq, Lk in ((0, 1, 100352, 1568), (1, 2, 25088, 6272)):
        G = BATCH * h
        q, k, v = (_normal(gen, (G, d, n), 1.0, bf).transpose(1, 2)
                   for n in (Lq, Lk, Lk))
        lnp = [t for _ in range(3) for t in (
            _normal(gen, (d,), 0.1, bf) + 1, _normal(gen, (d,), 0.1, bf))]
        args = (q, k, v, *lnp, d ** -0.5, 1e-5, (True, True, True), True)

        def library(q=q, k=k, v=v, lnp=lnp):
            qn, kn, vn = (F.layer_norm(t, (d,), lnp[2 * i], lnp[2 * i + 1],
                                       1e-5) for i, t in enumerate((q, k, v)))
            return F.scaled_dot_product_attention(qn, kn, vn) + qn

        r = _check_case(
            "flash_attention_ln",
            lambda args=args: fa.flash_attention_ln(*args),
            lambda args=args: fa.flash_attention_ln_plain(*args),
            library,
            flops=4 * G * Lq * Lk * d,
            nbytes=2 * (2 * G * Lq * d + 2 * G * Lk * d + 6 * d),
            peak=PEAK_BF16, iters=5)
        r["shape"] = (f"block {blk} q[{G},{Lq},{d}] k,v[{G},{Lk},{d}] "
                      "d-major")
        cases.append(r)
        del q, k, v, args
    results["flash_attention_ln"] = cases
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------------ model

KERNEL_FNS = ("fused_ln_qkv", "flash_attention_ln", "fused_ln_mlp",
              "fused_layer_norm")
SOURCES = {
    "fused_ln_qkv": ("aicity_action_tpu_torch/csrc/fused_ln_qkv.cu",
                     "aicity_action_tpu/ops/pallas/fused_dense.py:74"),
    "flash_attention_ln": (
        "aicity_action_tpu_torch/csrc/flash_attention_ln.cu",
        "aicity_action_tpu/ops/pallas/flash_attention.py:805"),
    "fused_ln_mlp": ("aicity_action_tpu_torch/csrc/fused_ln_mlp.cu",
                     "aicity_action_tpu/ops/pallas/fused_dense.py:314"),
    "fused_layer_norm": ("aicity_action_tpu_torch/csrc/layer_norm.cu",
                         "aicity_action_tpu/ops/pallas/layer_norm.py:64"),
}
PER_FORWARD = {"fused_ln_qkv": 16, "flash_attention_ln": 16,
               "fused_ln_mlp": 16, "fused_layer_norm": 1}


def _wrappers():
    from aicity_action_tpu_torch.ops import flash_attention as fa
    from aicity_action_tpu_torch.ops import fused_dense as fd
    from aicity_action_tpu_torch.ops import layer_norm as ln

    return {"fused_ln_qkv": fd.fused_ln_qkv,
            "flash_attention_ln": fa.flash_attention_ln,
            "fused_ln_mlp": fd.fused_ln_mlp,
            "fused_layer_norm": ln.fused_layer_norm}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def model_checks(card: str):
    import torch

    from aicity_action_tpu_torch.config import mvitv2_b_16x4_448_cfg
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.ops import kernels

    cfg = mvitv2_b_16x4_448_cfg()
    model = build_model(cfg, device="cuda", seed=SEED)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = _normal(gen, (BATCH, T, S, S, 3))

    with torch.no_grad():
        reset_counts()
        out = model(x)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != PER_FORWARD:
            _fail(f"launches per forward {counts} != {PER_FORWARD}")
        if out.shape != (BATCH, cfg.MODEL.NUM_CLASSES) or \
                not torch.isfinite(out).all():
            _fail("batch-8 forward: non-finite or mis-shaped scores")
        ms = time_ms(lambda: model(x), iters=5)
        print(f"# MViT-v2-B 16x4 @448 forward, batch {BATCH} bf16: "
              f"{ms:.2f} ms, {BATCH / ms * 1e3:.2f} clips/s ({card})")

        # batch 1: kernels against the same model in plain reference mode;
        # the features entering the head are compared too, since softmax
        # scores of random weights sit near 1/num_classes
        feats = []
        hook = model.head.register_forward_hook(
            lambda mod, inp, outp: feats.append(inp[0].float()))
        x1 = x[:1]
        out_k = model(x1)
        with kernels.plain_reference():
            out_p = model(x1)
        hook.remove()
        torch.cuda.synchronize()
    feat_err = ((feats[0] - feats[1]).norm() / feats[1].norm()).item()
    score_err = (out_k - out_p).abs().max().item()
    print(f"# batch-1 forward, kernels vs plain reference: head-input "
          f"relative L2 error {feat_err:.3e} (tol 5e-2), max |score "
          f"error| {score_err:.3e} (tol 1e-2)")
    if not (feat_err <= 5e-2 and score_err <= 1e-2):
        _fail("the model's kernel path disagrees with its plain reference")
    return model, cfg, {"forward_ms": ms, "clips_per_s": BATCH / ms * 1e3,
                        "feat_rel_err": feat_err, "score_err": score_err}


# ------------------------------------------------------------------ scorer

def synthetic_i420(num_frames: int, s: int, seed: int) -> np.ndarray:
    """A video of moving gradients plus noise as I420 u8 ``[N, s*3//2, s]``,
    made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:s, 0:s]
    out = np.empty((num_frames, s * 3 // 2, s), np.uint8)
    for i in range(num_frames):
        base = (yy + 3 * i) % 220 + 16 + rng.integers(0, 8, (s, s))
        out[i, :s] = base.astype(np.uint8)
        out[i, s:] = rng.integers(64, 192, (s // 2, s), dtype=np.uint8)
    return out


def scorer_checks(model, cfg):
    import torch

    from aicity_action_tpu_torch.data.decoder import sample_indices
    from aicity_action_tpu_torch.pipeline.window_inference import (
        WindowScorer, i420_to_rgb, load_window_predictions,
        save_window_predictions, window_plans, window_spans)

    s = cfg.DATA.TEST_CROP_SIZE
    n_frames, chunk = 300, 96
    video = synthetic_i420(n_frames, s, SEED + 2)
    spans = window_spans(n_frames, 30.0, cfg.DATA.NUM_FRAMES, 4, 16, 30.0)
    plans = window_plans(spans, cfg.DATA.NUM_FRAMES, n_frames)

    def chunks():
        for c0 in range(0, 10 ** 9, chunk):
            part = video[c0:c0 + chunk]
            if len(part) < chunk:  # EOF: repeat the last frame
                pad = np.repeat(video[-1:], chunk - len(part), 0)
                part = np.concatenate([part, pad]) if len(part) else pad
            yield part

    scorer = WindowScorer(model, batch_size=BATCH, chunk_frames=chunk)
    reset_counts()
    torch.cuda.synchronize()
    t = time.time()
    preds = scorer.score_chunks(chunks(), plans, s, cfg.DATA.MEAN,
                                cfg.DATA.STD)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = read_counts()
    for name, n in launches.items():
        if n == 0:
            _fail(f"{name} was not launched on the main path")

    if [(p[0], p[1]) for p in preds] != sorted(spans):
        _fail("scorer windows differ from the enumerated spans")
    scores = np.stack([p[2] for p in preds])
    if not np.isfinite(scores).all():
        _fail("non-finite window scores")
    if not np.allclose(scores.sum(1), 1.0, atol=1e-3):
        _fail("window scores do not sum to 1")

    # windows scored directly from their sample_indices frames: the first
    # one, one whose frames straddle a chunk boundary, and the last one
    mean = torch.tensor(cfg.DATA.MEAN, device="cuda")
    std = torch.tensor(cfg.DATA.STD, device="cuda")
    straddle = next(i for i, (_, _, idx) in enumerate(plans)
                    if idx[0] // chunk != idx[-1] // chunk)
    check = [0, straddle, len(plans) - 1]
    idx = np.stack([sample_indices(plans[i][0], plans[i][1],
                                   cfg.DATA.NUM_FRAMES, n_frames)
                    for i in check])
    yuv = torch.from_numpy(video[idx]).cuda()
    with torch.no_grad():
        direct = model((i420_to_rgb(yuv, s) / 255.0 - mean) / std)
    direct = direct.float().cpu().numpy()
    gather_err = float(np.abs(direct - scores[check]).max())
    # the direct batch has 3 windows, the scorer's batches up to 8: cuDNN may
    # pick other algorithms per batch size, so allow bf16-level noise
    if not gather_err <= 1e-2:
        _fail(f"gathered windows differ from direct scoring: {gather_err}")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "video.pkl")
        save_window_predictions(preds, path)
        back = load_window_predictions(path)
    if [(a[0], a[1]) for a in back] != [(a[0], a[1]) for a in preds] or \
            not all(np.array_equal(a[2], b[2]) for a, b in zip(back, preds)):
        _fail("prediction pickle did not round-trip")
    print(f"# WindowScorer: {len(preds)} windows of {n_frames} frames "
          f"(chunks of {chunk}) in {wall:.2f} s, "
          f"{len(preds) / wall:.2f} windows/s; direct-vs-gather max error "
          f"{gather_err:.2e} (tol 1e-2); launches {launches}")
    return launches


# ------------------------------------------------------------------ main

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, _REPO)
    try:
        import aicity_action_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the aicity_action_tpu_torch package is not "
              f"beside {__file__}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"# card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    build_kernels()
    checks = kernel_checks()
    for name, cases in checks.items():
        for c in cases:
            print(f"# {name} {c['shape']}: err {c['max_abs_err']:.3e} "
                  f"(tol {c['tol']:.3e}), {c['ms']:.4f} ms, plain "
                  f"{c['plain_ms']:.4f} ms, library {c['library_ms']:.4f} "
                  f"ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
    model, cfg, model_stats = model_checks(card)
    launches = scorer_checks(model, cfg)

    kernels_line = []
    for name in KERNEL_FNS:
        first = checks[name][0]
        source, replaces = SOURCES[name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            **{k: first[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
            "shape": first["shape"],
            "other_shapes": checks[name][1:],
        })
    print(json.dumps({"model": model_stats}))
    print(json.dumps({"kernels": kernels_line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
