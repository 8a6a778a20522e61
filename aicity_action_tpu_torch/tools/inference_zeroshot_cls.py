"""Zero-shot classification over saved multi-dataset predictions (port of
``tools/inference_zeroshot_cls.py``; pure numpy, no model).

Usage:
    python -m aicity_action_tpu_torch.tools.inference_zeroshot_cls QUERY \
        DATASET_CONFIG PRED_PATH CLS_EMB_PATH WORD_EMB_FILE VOCAB_PATH \
        ANNO_PATH OUTPUT_FILE [--emb_dim 300] [--min_simi 0.6] \
        [--top_k_cls 10] [--top_k_videos 20]

``DATASET_CONFIG`` is a json with ``dataset_class_embeddings``,
``dataset_vocab_files`` and ``dataset_pred_files`` (per dataset: its class
embeddings ``.npy`` under ``CLS_EMB_PATH``, its class names one a line
under ``VOCAB_PATH``, its predictions ``[videos, classes]`` ``.npy`` under
``PRED_PATH``); ``WORD_EMB_FILE`` holds GloVe-style ``word v1 v2 ...``
lines (user-supplied). The query's mean word vector picks the classes whose
embeddings it is near (at least ``min_simi``, the ``top_k_cls`` nearest),
their predictions are fused with those similarities as weights, and the
``top_k_videos`` best videos (ids one a line in ``ANNO_PATH``) are written
to ``OUTPUT_FILE`` as ``id score`` lines.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("query")
    p.add_argument("dataset_config", help="json with dataset_class_embeddings,"
                   " dataset_vocab_files, dataset_pred_files")
    p.add_argument("pred_path")
    p.add_argument("cls_emb_path")
    p.add_argument("word_emb_file")
    p.add_argument("vocab_path")
    p.add_argument("anno_path", help="file with one video id per line")
    p.add_argument("output_file")
    p.add_argument("--emb_dim", default=300, type=int)
    p.add_argument("--min_simi", default=0.6, type=float)
    p.add_argument("--top_k_cls", default=10, type=int)
    p.add_argument("--top_k_videos", default=20, type=int)
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Writes the ranked videos; returns ``[(video id, score)]``."""
    args = parse_args(argv)

    from ..pipeline import zeroshot as zs

    with open(args.dataset_config) as f:
        cfg = json.load(f)
    word_emb = zs.load_word_embeddings(args.word_emb_file)
    q_emb = zs.embed_query(zs.query_words(args.query), word_emb, args.emb_dim)

    class_embs, class_names, preds = {}, {}, {}
    for ds, emb_file in cfg["dataset_class_embeddings"].items():
        class_embs[ds] = np.load(os.path.join(args.cls_emb_path, emb_file))
        vocab_file = os.path.join(args.vocab_path,
                                  cfg["dataset_vocab_files"][ds])
        with open(vocab_file) as f:
            class_names[ds] = [ln.strip() for ln in f]
        preds[ds] = np.load(
            os.path.join(args.pred_path, cfg["dataset_pred_files"][ds]))

    kept, weights = zs.class_weights_for_query(
        q_emb, class_embs, class_names,
        min_simi=args.min_simi, top_k_cls=args.top_k_cls)
    print("matched classes:")
    for cid, simi, name, ds, _ in kept:
        print(f"  {cid} ({name}, {ds}): {simi:.3f}")

    fused = zs.fuse_predictions(preds, weights)
    with open(args.anno_path) as f:
        video_ids = [ln.strip() for ln in f if ln.strip()]
    ranked = zs.rank_videos(fused, video_ids, args.top_k_videos)
    with open(args.output_file, "w") as f:
        for vid, score in ranked:
            f.write(f"{vid} {score:.6f}\n")
    print(f"wrote top-{len(ranked)} videos to {args.output_file}")
    return ranked


if __name__ == "__main__":
    main()
