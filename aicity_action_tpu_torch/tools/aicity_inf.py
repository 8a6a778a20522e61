"""Window-prediction pickles + thresholds -> challenge submission (port of
``tools/aicity_inf.py``): per-frame score aggregation over overlapping
windows, per-class threshold -> contiguous chunks, the top chunk per view,
the top chunk across a video's views, +-1 s boundary tightening.

Usage:
    python -m aicity_action_tpu_torch.tools.aicity_inf PRED_PICKLE_PATH \
        THRES_FILE VID_CSV OUTPUT_FILE [--num_class 18] [--agg_method avg]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("pred_pickle_path")
    p.add_argument("thres_file")
    p.add_argument("vid_csv", help="video_id -> 3 view files csv")
    p.add_argument("output_file")
    p.add_argument("--num_class", type=int, default=18)
    p.add_argument("--agg_method", default="avg", choices=["avg", "max"])
    p.add_argument("--use_num_chunk", type=int, default=1)
    p.add_argument("--chunk_sort_base_single_vid", default="length",
                   choices=["length", "score"])
    p.add_argument("--chunk_sort_base_multi_vid", default="length",
                   choices=["length", "score"])
    return p.parse_args(argv)


def read_thresholds(path: str) -> dict[int, float]:
    """``action_id threshold`` lines -> ``{action_id: threshold}``."""
    out = {}
    with open(path) as f:
        for line in f:
            action_id, thres = line.strip().split()
            out[int(action_id)] = float(thres)
    return out


def main(argv=None) -> list:
    """Writes the submission; returns its rows ``(video_id, action_id,
    start_s, end_s)``."""
    args = parse_args(argv)
    from ..pipeline import postprocess as pp
    from ..pipeline.window_inference import load_window_predictions

    agg = np.mean if args.agg_method == "avg" else np.max
    thresholds = read_thresholds(args.thres_file)

    video_views = {}
    all_videos = []
    with open(args.vid_csv) as f:
        for line in f.readlines()[1:]:
            vid, f1, f2, f3 = line.strip().split(",")
            video_views[vid] = [f1, f2, f3]
            all_videos += [f1, f2, f3]

    view_chunks = {}
    for file_id in all_videos:
        preds = load_window_predictions(
            os.path.join(args.pred_pickle_path, f"{file_id}.pkl"))
        per_frame = pp.aggregate_predictions(preds, agg, args.num_class)
        view_chunks[file_id] = pp.chunks_for_video(
            per_frame, thresholds,
            use_num_chunk=args.use_num_chunk,
            sort_base=args.chunk_sort_base_single_vid,
        )

    rows = pp.merge_views_to_submission(
        video_views, view_chunks, thresholds,
        use_num_chunk=args.use_num_chunk,
        sort_base=args.chunk_sort_base_multi_vid,
    )
    print(f"total pred {len(rows)}")
    pp.write_submission(rows, args.output_file)
    return rows


if __name__ == "__main__":
    main()
