"""Sliding-window scoring of full videos -> per-video prediction pickles, on
the card (port of ``tools/run_temporal_inf.py``).

Windows of ``frame_length x frame_stride`` source frames every
``proposal_stride`` frames are scored by the classifier; the pickle per
video is the sorted list of ``(t0, t1, scores[num_class])`` that
``aicity_inf`` and ``aicity_inf_graph`` read. Videos decode to I420 chunks
with the port's FFmpeg library where it applies (FFmpeg's development
files found by ``pkg-config``, ``AICITY_VDEC`` not 0), else with cv2, in
``--num_workers`` parallel decoders; ``--exact_rgb`` ships BGR chunks
decoded by cv2 instead.

Usage:
    python -m aicity_action_tpu_torch.tools.run_temporal_inf --cfg CFG \
        --video_lst FILE --video_path DIR --out_dir DIR \
        [--checkpoint CKPT] [--device cuda] [opts...]

``NUM_GPUS N`` (N > 1) among the opts spawns N ranks on this host, one a
card (rank i on ``cuda:i``), in a process group on ``DIST_BACKEND``
(``nccl``; ``gloo`` for ``--device cpu``) at ``INIT_METHOD``, as
``tools/run_net.py`` does: each video's windows are split over the ranks
(``WindowScorer``), and rank 0 alone writes the pickle, the same file a
one-card run writes.

A two-pathway model (``MODEL.ARCH slowfast``, e.g. SlowFast R50 8x8) is
scored through the window-streaming path with its slow and fast clips; its
BatchNorm statistics come with the checkpoint's ``model_state``.

Without ``--checkpoint`` (or ``TEST.CHECKPOINT_FILE_PATH``) the model keeps
the weights drawn from ``RNG_SEED``; a torch checkpoint (or a Caffe2
``.pkl``) loads by shape (``utils/checkpoint.py``).
"""

from __future__ import annotations

import argparse
import importlib.util
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
                   help="parallel decoders (at most one fewer than the "
                        "host's cores)")
    p.add_argument("--chunk_frames", type=int, default=512,
                   help="source frames decoded and shipped to the card at "
                        "a time (at least a window's span)")
    p.add_argument("--roi", type=float, nargs=4, default=[0.0, 0.0, 1.0, 1.0])
    p.add_argument("--exact_rgb", action="store_true",
                   help="ship exact BGR chunks decoded by cv2 instead of "
                        "I420 (twice the bytes to the card)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def _config(args):
    from ..config import assert_and_infer_cfg, get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.checkpoint:
        cfg.TEST.CHECKPOINT_FILE_PATH = args.checkpoint
    cfg.DATA.TRAIN_CROP_SIZE = args.frame_size
    cfg.DATA.TEST_CROP_SIZE = args.frame_size
    return assert_and_infer_cfg(cfg)


def run(local_rank: int, argv=None) -> dict:
    """One rank (the only one at ``NUM_GPUS`` 1): scores every listed video
    that had no pickle when the run began; returns ``{video: {"windows",
    "seconds", "timers"}}`` for the videos it scored. Rank 0 writes the
    pickles."""
    import torch

    from ..device import resolve_device
    from ..parallel import mesh

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = _config(args)
    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None and mesh.world_size(cfg) > 1:
        dev = torch.device("cuda", local_rank)
    dev = resolve_device(dev)
    grouped = mesh.init_distributed(cfg, local_rank, device=dev)
    try:
        return _score_videos(args, cfg, dev)
    finally:
        if grouped:
            mesh.destroy()


def _score_videos(args, cfg, dev) -> dict:
    from ..models.build import build_model
    from ..parallel import mesh
    from ..pipeline.window_inference import (
        WindowDataset, WindowScorer, save_window_predictions,
    )
    from ..utils.checkpoint import load_test_checkpoint

    logger = logging.getLogger("run_temporal_inf")
    model = build_model(cfg, device=dev)
    load_test_checkpoint(cfg, model)
    scorer = WindowScorer(model, batch_size=args.batch_size,
                          num_workers=args.num_workers,
                          chunk_frames=args.chunk_frames,
                          detection=cfg.DETECTION.ENABLE,
                          chroma420=not args.exact_rgb)
    n_path = 2 if cfg.MODEL.ARCH in cfg.MODEL.MULTI_PATHWAY_ARCH else 1

    with open(args.video_lst) as f:
        videos = [ln.strip() for ln in f if ln.strip()]
    todo = []
    for name in videos:
        stem = os.path.splitext(name)[0]
        out_pkl = os.path.join(args.out_dir, f"{stem}.pkl")
        if os.path.exists(out_pkl):  # per-video resume (saves are atomic)
            logger.info("%s: %s exists, skipping", name, out_pkl)
        else:
            todo.append((name, out_pkl))
    # every rank has its list before rank 0 writes a pickle
    mesh.barrier()
    if mesh.is_main_process():
        os.makedirs(args.out_dir, exist_ok=True)
    stats = {}
    for name, out_pkl in todo:
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
            arch_pathways=n_path,
            slowfast_alpha=cfg.SLOWFAST.ALPHA,
            backend=cfg.DATA.DECODING_BACKEND,
        )
        preds = scorer.score_video(ds)
        if mesh.is_main_process():
            save_window_predictions(preds, out_pkl)
        dt = time.time() - t0
        stats[name] = {"windows": len(preds), "seconds": dt,
                       "timers": scorer.last_timers}
        logger.info("%s: %d windows in %.1fs (%.2f win/s); timers %s",
                    name, len(preds), dt, len(preds) / max(dt, 1e-9),
                    scorer.last_timers)
    return stats


def _spawned(local_rank: int, argv) -> None:
    run(local_rank, argv)


def main(argv=None) -> dict:
    """Runs :func:`run` in this process, or at ``NUM_GPUS`` > 1 in that many
    spawned ranks (then returns ``{}``: the pickles are the result)."""
    args = parse_args(argv)
    if args.exact_rgb and importlib.util.find_spec("cv2") is None:
        raise SystemExit("--exact_rgb: the RGB chunk path decodes with cv2, "
                         "which is not installed")
    from ..device import resolve_device
    from ..parallel import mesh

    resolve_device(args.device)  # no card and no --device cpu: raise here
    cfg = _config(args)
    mesh.check_card_count(cfg, args.device)
    if cfg.NUM_GPUS > 1:
        import torch.multiprocessing as mp

        mp.spawn(_spawned, args=(argv,), nprocs=cfg.NUM_GPUS, join=True)
        return {}
    return run(0, argv)


if __name__ == "__main__":
    main()
