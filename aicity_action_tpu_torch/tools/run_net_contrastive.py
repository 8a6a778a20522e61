"""Contrastive (ActionCLIP) training, then the retrieval test, on the card
(port of ``tools/run_net_contrastive.py``).

Usage:
    python -m aicity_action_tpu_torch.tools.run_net_contrastive --cfg CFG \
        [--device cuda] [--ddp] [--init_method tcp://HOST:PORT] \
        [--shard_id I --num_shards N] [KEY VALUE ...]

The config is an ActionCLIP one (``MODEL.MODEL_NAME ActionCLIP``,
``CONTRA.ENABLE True``, ``TRAIN.DATASET web_video_text``; in code,
``config.actionclip_mvitv2_b_16x4_448_cfg()``), the data a directory of
``{train,val,test}_tokenized.csv`` rows ``path label id,id,...`` (the
captions' BPE ids, e.g. from ``data/tokenizer.py:tokenize``). Where
``TRAIN.ENABLE``, :func:`~aicity_action_tpu_torch.engine.contrastive_loop.
train_contrastive` trains, evaluates recall@1/5/10, checkpoints under
``OUTPUT_DIR`` and auto-resumes (MoCo's momentum weights included); where
``TEST.ENABLE``, :func:`~aicity_action_tpu_torch.engine.contrastive_loop.
test_contrastive` runs the retrieval test and, with
``TEST.SAVE_RESULTS_PATH``, writes the ``(features, ids)`` pickle that
``tools/inference_videotext.py`` queries.

The ranks, devices and process group are ``tools/run_net.py``'s:
``NUM_GPUS`` > 1 spawns that many ranks on this host, one a card, under
``DistributedDataParallel`` on ``DIST_BACKEND`` (``nccl``; ``gloo`` with
``--device cpu``); the similarity matrix is the global batch's.
"""

from __future__ import annotations

from . import run_net


def main(argv=None) -> dict:
    """``tools/run_net.py``'s ``main`` with the contrastive loops: returns
    ``{"train": ContrastiveRun or None, "test": stats or None}``."""
    from ..engine.contrastive_loop import test_contrastive, train_contrastive

    return run_net.main(argv, train_contrastive, test_contrastive)


if __name__ == "__main__":
    main()
