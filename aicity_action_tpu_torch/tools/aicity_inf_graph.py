"""Threshold derivation + F1 evaluation on a labeled split (port of
``tools/aicity_inf_graph.py``): per-class thresholds as the mean
ground-truth-segment score (min / max / mean reduced), then the split's
+-1 s boundary-match F1.

Usage:
    python -m aicity_action_tpu_torch.tools.aicity_inf_graph ANNO_CSV \
        PRED_PICKLE_PATH [--thres_file OUT] [--graph_path DIR] ...

``--graph_path`` draws score curves with matplotlib, imported only then;
without it the flag raises.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("anno_csv", help="val.csv with clip rows (clip_id label)")
    p.add_argument("pred_pickle_path")
    p.add_argument("--appendix", default="")
    p.add_argument("--num_class", type=int, default=18)
    p.add_argument("--agg_method", default="avg", choices=["avg", "max"])
    p.add_argument("--thres_take", default="mean",
                   choices=["min", "max", "mean"])
    p.add_argument("--thres_file", default=None)
    p.add_argument("--replace_thres_file", default=None)
    p.add_argument("--use_num_chunk", type=int, default=1)
    p.add_argument("--chunk_sort_base", default="length",
                   choices=["length", "score"])
    p.add_argument("--use_tight_times", action="store_true")
    p.add_argument("--graph_path", default=None,
                   help="write per-(video, class) score-curve PNGs "
                        "(needs matplotlib)")
    return p.parse_args(argv)


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("--graph_path draws with matplotlib, which is not "
                           "installed; run without --graph_path") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _plot_curves(plt, anno_data, per_frame, classes, graph_path,
                 video_fps=30.0):
    """Score curves with the ground-truth boundaries, one figure of the 3
    views per (video, class) (reference: aicity_inf_graph.py's plotting
    branch)."""
    os.makedirs(graph_path, exist_ok=True)
    for vid, annos in anno_data.items():
        for action_id in classes:
            anno = [o for o in annos if o[-1] == action_id]
            if not anno:
                continue
            fig, axes = plt.subplots(1, max(len(anno[:3]), 1),
                                     figsize=(20, 9), squeeze=False)
            for i, (file_id, _, t0, t1, _) in enumerate(anno[:3]):
                if file_id not in per_frame:
                    continue
                scores = per_frame[file_id][:, action_id]
                ax = axes[0][i]
                ax.plot(range(len(scores)), scores)
                ax.axvline(x=int(t0 * video_fps), color="orange",
                           linestyle="dashed")
                ax.axvline(x=int(t1 * video_fps), color="orange",
                           linestyle="dashed")
                ax.set_title(f"{file_id} (action {action_id})")
            fig.savefig(os.path.join(
                graph_path, f"{vid}.action_{action_id}.png"))
            plt.close(fig)


def read_clip_annotations(path: str):
    """``file_id.user_id.t0.t1.MP4 label`` rows -> ``{video id: [(file_id,
    user_id, t0, t1, label)]}`` (video id ``<user_id>_<file_id[-1]>``) and
    the file ids in order."""
    anno_data = defaultdict(list)
    files = {}
    with open(path) as f:
        for line in f:
            video_file, action_class = line.strip().split()
            file_id, user_id, t0, t1, _ = video_file.split(".")
            anno_data[f"{user_id}_{file_id[-1]}"].append(
                (file_id, user_id, int(t0), int(t1), int(action_class)))
            files[file_id] = 1
    return anno_data, list(files)


def main(argv=None) -> dict:
    """Prints ``F1, precision, recall``; writes ``--thres_file``. Returns
    ``{"thresholds", "f1", "precision", "recall"}``."""
    args = parse_args(argv)
    from ..pipeline import postprocess as pp
    from ..pipeline.window_inference import load_window_predictions

    plt = _pyplot() if args.graph_path else None
    agg = np.mean if args.agg_method == "avg" else np.max
    classes = list(range(1, args.num_class))
    anno_data, files = read_clip_annotations(args.anno_csv)

    per_frame = {}
    suffix = f".{args.appendix}.pkl" if args.appendix else ".pkl"
    for file_id in files:
        preds = load_window_predictions(
            os.path.join(args.pred_pickle_path, f"{file_id}{suffix}"))
        per_frame[file_id] = pp.aggregate_predictions(
            preds, agg, args.num_class)

    thresholds = pp.derive_thresholds(
        anno_data, per_frame, classes, thres_take=args.thres_take)

    if plt is not None:
        _plot_curves(plt, anno_data, per_frame, classes, args.graph_path)

    if args.replace_thres_file:
        with open(args.replace_thres_file) as f:
            for line in f:
                action_id, score = line.strip().split()
                thresholds[int(action_id)] = float(score)

    if args.thres_file:
        with open(args.thres_file, "w") as f:
            for c in classes:
                f.write(f"{c} {thresholds[c]:.5f}\n")

    action_chunks = {
        file_id: pp.chunks_for_video(
            scores, thresholds,
            use_num_chunk=args.use_num_chunk,
            sort_base=args.chunk_sort_base,
        )
        for file_id, scores in per_frame.items()
    }
    f1, precision, recall = pp.compute_f1(
        anno_data, classes, action_chunks,
        use_num_chunk=args.use_num_chunk,
        chunk_sort_base=args.chunk_sort_base,
        use_tight_times=args.use_tight_times,
        return_pr=True,
    )
    print(f"F1, precision, recall: {f1:.6f} {precision:.6f} {recall:.6f}")
    return {"thresholds": thresholds, "f1": f1, "precision": precision,
            "recall": recall}


if __name__ == "__main__":
    main()
