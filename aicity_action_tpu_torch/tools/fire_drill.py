"""One-command released-checkpoint fire drill on the card (port of
``tools/fire_drill.py``).

Chains the port's own CLIs, each a subprocess (the drill runs exactly what
a user runs), for the moment the released ``.pyth`` and the A2 views are at
hand (the reference's public-leaderboard F1 is 0.3295):

  1. ``run_temporal_inf``: sliding-window scoring of every listed view
     with the ``.pyth`` (read directly: the port needs no conversion
     stage, where the JAX drill converts to orbax first);
  2. ``aicity_inf``: thresholds -> chunks -> per-view top-1 -> cross-view
     merge -> the submission file;
  3. where ``--anno_csv`` is given, the +-1 s boundary-match F1 of
     ``aicity_inf_graph`` against it, gated by ``--expect_f1``.

Usage:
    python -m aicity_action_tpu_torch.tools.fire_drill --pyth CKPT.pyth \
        --cfg configs/AICITY_MVITV2_B_16x4_448.yaml --video_lst A2.lst \
        --video_path DIR --vid_csv A2_video_ids.csv \
        --thres_file public_leaderboard_thres.txt --out_dir drill/ \
        [--anno_csv GT.csv --expect_f1 0.3295] [--device cuda] \
        [--frame_length ...] [KEY VALUE ...]

The summary (the last ``[fire_drill] {...}`` line) reports the partial
load's counts where the JAX drill reports its conversion's: ``loaded``,
``shape_mismatched`` and ``missing_in_ckpt`` tensors (a nonzero count is
warned about), then the pickles, the submission and the F1. A finished
scoring stage is skipped on a rerun (``preds/.done``, which holds the load
counts), so an interrupted drill resumes where it stopped.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

PKG = __package__ or "aicity_action_tpu_torch.tools"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
INF_FLAGS = ("frame_length", "frame_stride", "proposal_stride",
             "frame_size", "batch_size", "num_workers", "chunk_frames")
_LOAD = re.compile(r"torch load: (\d+) loaded, (\d+) shape-mismatched, "
                   r"(\d+) missing")


def _run(tag: str, module: str, args: list[str]) -> str:
    """``python -m PKG.module args`` from the repository's root; echoes its
    output, exits with its code on failure, returns stdout + stderr."""
    cmd = [sys.executable, "-m", f"{PKG}.{module}", *args]
    print(f"[fire_drill] {tag}: {' '.join(cmd[1:])}", flush=True)
    t0 = time.time()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    sys.stdout.write(r.stdout)
    sys.stderr.write(r.stderr)
    dt = time.time() - t0
    if r.returncode != 0:
        print(f"[fire_drill] {tag} FAILED (rc={r.returncode}, {dt:.0f}s)",
              file=sys.stderr)
        sys.exit(r.returncode)
    print(f"[fire_drill] {tag} done in {dt:.0f}s", flush=True)
    return r.stdout + r.stderr


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pyth", required=True, help="released torch checkpoint")
    p.add_argument("--cfg", required=True)
    p.add_argument("--video_lst", required=True)
    p.add_argument("--video_path", required=True)
    p.add_argument("--vid_csv", required=True,
                   help="video_id -> 3 view files csv (A2_video_ids.csv)")
    p.add_argument("--thres_file", required=True,
                   help="per-class thresholds (public_leaderboard_thres.txt)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--anno_csv", default="",
                   help="labeled split for a local F1 (the A2 ground truth "
                        "is not public)")
    p.add_argument("--expect_f1", type=float, default=None,
                   help="fail unless F1 >= this")
    p.add_argument("--device", default="cuda",
                   help="run_temporal_inf's device; 'cpu' runs the plain "
                        "PyTorch path")
    for flag in INF_FLAGS:
        p.add_argument(f"--{flag}", default=None,
                       help="forwarded to run_temporal_inf")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="KEY VALUE config overrides for run_temporal_inf")
    args = p.parse_args(argv)
    if args.expect_f1 is not None and not args.anno_csv:
        p.error("--expect_f1 requires --anno_csv (the F1 is computed "
                "against a labeled split)")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = os.path.abspath(args.out_dir)
    os.makedirs(out, exist_ok=True)
    preds = os.path.join(out, "preds")
    submission = os.path.join(out, "submission.txt")
    summary: dict = {"pyth": args.pyth, "cfg": args.cfg}

    # 1. sliding-window scoring, the checkpoint loaded by shape
    done = os.path.join(preds, ".done")
    if os.path.exists(done):
        print(f"[fire_drill] temporal_inf: {preds} complete, skipping")
        with open(done) as f:
            summary["load"] = json.load(f)
    else:
        flags = []
        for flag in INF_FLAGS:
            if getattr(args, flag) is not None:
                flags += [f"--{flag}", str(getattr(args, flag))]
        log = _run("temporal_inf", "run_temporal_inf", [
            "--cfg", args.cfg, "--video_lst", args.video_lst,
            "--video_path", args.video_path, "--out_dir", preds,
            "--checkpoint", os.path.abspath(args.pyth), "--device",
            args.device, *flags, *args.opts])
        m = _LOAD.search(log)
        if m is None:
            print("[fire_drill] FAILED: run_temporal_inf reported no "
                  "checkpoint load", file=sys.stderr)
            sys.exit(3)
        summary["load"] = dict(zip(
            ("loaded", "shape_mismatched", "missing_in_ckpt"),
            map(int, m.groups())))
        with open(done, "w") as f:
            json.dump(summary["load"], f)
    bad = (summary["load"]["shape_mismatched"]
           + summary["load"]["missing_in_ckpt"])
    if bad:
        print(f"[fire_drill] WARNING: {bad} tensors did not load cleanly",
              file=sys.stderr)
    summary["preds"] = sum(f.endswith(".pkl") for f in os.listdir(preds))

    # 2. the submission under the released thresholds
    _run("submission", "aicity_inf",
         [preds, args.thres_file, args.vid_csv, submission])
    with open(submission) as f:
        summary["submission"] = {"path": submission,
                                 "lines": sum(1 for _ in f)}

    # 3. the local F1 where a labeled split is given
    if args.anno_csv:
        log = _run("f1", "aicity_inf_graph", [
            args.anno_csv, preds, "--replace_thres_file", args.thres_file])
        for line in log.splitlines():
            if line.startswith("F1, precision, recall:"):
                f1, prec, rec = map(float, line.split(":")[1].split())
                summary.update(f1=f1, precision=prec, recall=rec)

    print("[fire_drill] " + json.dumps(summary), flush=True)
    if args.expect_f1 is not None:
        if summary.get("f1") is None:
            print("[fire_drill] --expect_f1 given but no F1 was computed",
                  file=sys.stderr)
            sys.exit(2)
        if summary["f1"] < args.expect_f1:
            print(f"[fire_drill] F1 {summary['f1']} < expected "
                  f"{args.expect_f1}", file=sys.stderr)
            sys.exit(2)
    return summary


if __name__ == "__main__":
    main()
