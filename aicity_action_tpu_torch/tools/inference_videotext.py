"""Text-to-video retrieval over saved ActionCLIP features (port of
``tools/inference_videotext.py``).

Usage:
    python -m aicity_action_tpu_torch.tools.inference_videotext --cfg CFG \
        --features FEATS.pkl --bpe_path MERGES --query "a person texting" \
        [--checkpoint CKPT] [--top_k 20] [--device cuda] [KEY VALUE ...]

``FEATS.pkl`` holds ``(video features [N, D], video ids [N])``, as
``tools/run_net_contrastive.py`` writes with ``TEST.SAVE_RESULTS_PATH``;
``MERGES`` is CLIP's BPE merges file (``bpe_simple_vocab_16e6.txt.gz``,
user-supplied). The query loses its stop words, is tokenized, and is
encoded by the text tower alone (``MODEL.LOAD_VISUAL False``) on the card,
its weights the text half of ``--checkpoint`` (``TEST.CHECKPOINT_FILE_PATH``,
else the last checkpoint of ``OUTPUT_DIR``); the videos are ranked by
cosine similarity and printed ``id<TAB>score``, best first.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", required=True)
    p.add_argument("--features", required=True,
                   help="pickle of (video_features [N, D], video_ids [N])")
    p.add_argument("--bpe_path", required=True)
    p.add_argument("--query", required=True)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--top_k", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Prints and returns the ranked ``[(video id, score)]``."""
    args = parse_args(argv)

    import torch

    from ..config import assert_and_infer_cfg, get_cfg
    from ..data.tokenizer import SimpleTokenizer, tokenize
    from ..models.build import build_model
    from ..pipeline.zeroshot import retrieve_videos_by_text
    from ..utils.checkpoint import load_test_checkpoint

    cfg = get_cfg()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.checkpoint:
        cfg.TEST.CHECKPOINT_FILE_PATH = args.checkpoint
    cfg.MODEL.LOAD_VISUAL = False  # the text tower only
    cfg = assert_and_infer_cfg(cfg)

    model = build_model(cfg, device=args.device)
    load_test_checkpoint(cfg, model)
    tok = SimpleTokenizer(args.bpe_path)
    dev = next(model.parameters()).device

    def encode_text_fn(text):
        ids = tokenize(tok, [text], cfg.CONTRA.CONTEXT_LENGTH)
        with torch.no_grad():
            t = model.encode_text(torch.from_numpy(ids).to(dev))
        return t[0].cpu().numpy()

    with open(args.features, "rb") as f:
        video_features, video_ids = pickle.load(f)
    ranked = retrieve_videos_by_text(
        args.query, np.asarray(video_features), video_ids, encode_text_fn,
        args.top_k)
    for vid, score in ranked:
        print(f"{vid}\t{score:.4f}")
    return ranked


if __name__ == "__main__":
    main()
