"""Sliding-window scoring of full videos -> per-video prediction pickles, on
the card (port of ``tools/run_temporal_inf.py``).

Windows of ``frame_length x frame_stride`` source frames every
``proposal_stride`` frames are scored by the classifier; the pickle per
video is the sorted list of ``(t0, t1, scores[num_class])`` that the JAX
package's ``tools/aicity_inf.py`` reads.

Usage:
    python -m aicity_action_tpu_torch.tools.run_temporal_inf --cfg CFG \
        --video_lst FILE --video_path DIR --out_dir DIR \
        [--checkpoint CKPT] [--device cuda] [opts...]

Without ``--checkpoint`` (or ``TEST.CHECKPOINT_FILE_PATH``) the model keeps
the weights drawn from ``RNG_SEED``.
"""

from __future__ import annotations

import argparse
import logging
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", required=True)
    p.add_argument("--video_lst", required=True,
                   help="file with one video filename per line")
    p.add_argument("--video_path", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--checkpoint", default="",
                   help="overrides TEST.CHECKPOINT_FILE_PATH")
    p.add_argument("--frame_length", type=int, default=16)
    p.add_argument("--frame_stride", type=int, default=4)
    p.add_argument("--proposal_stride", type=int, default=16)
    p.add_argument("--frame_size", type=int, default=448)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=8,
                   help="accepted for CLI parity; decode is sequential")
    p.add_argument("--roi", type=float, nargs=4, default=[0.0, 0.0, 1.0, 1.0])
    p.add_argument("--exact_rgb", action="store_true",
                   help="ship RGB chunks instead of I420; not ported yet, "
                        "so it is refused")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.exact_rgb:
        raise SystemExit("--exact_rgb: the RGB-chunk scorer is not ported "
                         "yet; the port scores I420 chunks")

    from ..config import assert_and_infer_cfg, get_cfg
    from ..models.build import build_model
    from ..pipeline.window_inference import (
        WindowDataset, WindowScorer, save_window_predictions,
    )
    from ..utils.convert import load_pyth

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    logger = logging.getLogger("run_temporal_inf")

    cfg = get_cfg()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.checkpoint:
        cfg.TEST.CHECKPOINT_FILE_PATH = args.checkpoint
    cfg.DATA.TRAIN_CROP_SIZE = args.frame_size
    cfg.DATA.TEST_CROP_SIZE = args.frame_size
    cfg = assert_and_infer_cfg(cfg)

    model = build_model(cfg, device=args.device)
    if cfg.TEST.CHECKPOINT_FILE_PATH:
        model.load_state_dict(load_pyth(cfg.TEST.CHECKPOINT_FILE_PATH))
        logger.info("loaded %s", cfg.TEST.CHECKPOINT_FILE_PATH)
    scorer = WindowScorer(model, batch_size=args.batch_size)
    os.makedirs(args.out_dir, exist_ok=True)

    with open(args.video_lst) as f:
        videos = [ln.strip() for ln in f if ln.strip()]
    for name in videos:
        stem = os.path.splitext(name)[0]
        out_pkl = os.path.join(args.out_dir, f"{stem}.pkl")
        if os.path.exists(out_pkl):  # per-video resume (saves are atomic)
            logger.info("%s: %s exists, skipping", name, out_pkl)
            continue
        t0 = time.time()
        ds = WindowDataset(
            os.path.join(args.video_path, name),
            frame_length=args.frame_length,
            frame_stride=args.frame_stride,
            proposal_stride=args.proposal_stride,
            frame_size=args.frame_size,
            target_fps=cfg.DATA.TARGET_FPS,
            roi=tuple(args.roi),
            mean=cfg.DATA.MEAN,
            std=cfg.DATA.STD,
        )
        preds = scorer.score_video(ds)
        save_window_predictions(preds, out_pkl)
        dt = time.time() - t0
        logger.info("%s: %d windows in %.1fs (%.2f win/s)",
                    name, len(preds), dt, len(preds) / max(dt, 1e-9))


if __name__ == "__main__":
    main()
