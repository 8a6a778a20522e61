"""Train, then test, per config on the card (port of ``tools/run_net.py``).

Usage:
    python -m aicity_action_tpu_torch.tools.run_net --cfg CFG \
        [--device cuda] [KEY VALUE ...]

For example, the AI City fine-tune on one H100 (the YAML's global batch of
64 is for 8 cards):

    python -m aicity_action_tpu_torch.tools.run_net \
        --cfg configs/AICITY_MVITV2_B_16x4_448.yaml TRAIN.BATCH_SIZE 4 \
        DATA.PATH_TO_DATA_DIR DIR DATA.PATH_PREFIX DIR OUTPUT_DIR OUT

``--device cpu`` runs the plain PyTorch path; without a card the default
``cuda`` raises. ``NUM_GPUS`` is read and ignored, as in the JAX package:
one process drives one card.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg", dest="cfg_file", required=True,
                   help="path to the config file")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--shard_id", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                   help="KEY VALUE overrides of the config")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Runs ``train`` where ``TRAIN.ENABLE``, then ``test`` where
    ``TEST.ENABLE``; returns ``{"train": TrainRun or None, "test": stats or
    None}``."""
    from ..config import assert_and_infer_cfg, load_config
    from ..device import resolve_device
    from ..engine.test_loop import test
    from ..engine.train_loop import train

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = assert_and_infer_cfg(load_config(args))
    out = {"train": None, "test": None}
    if cfg.TRAIN.ENABLE:
        out["train"] = train(cfg, device=device)
    if cfg.TEST.ENABLE:
        out["test"] = test(cfg, device=device)
    return out


if __name__ == "__main__":
    main()
