"""Train, then test, per config on the card (port of ``tools/run_net.py``).

Usage:
    python -m aicity_action_tpu_torch.tools.run_net --cfg CFG \
        [--device cuda] [--ddp] [--init_method tcp://HOST:PORT] \
        [--shard_id I --num_shards N] [KEY VALUE ...]

For example, the AI City fine-tune on one H100 (the YAML's global batch of
64 is for 8 cards):

    python -m aicity_action_tpu_torch.tools.run_net \
        --cfg configs/AICITY_MVITV2_B_16x4_448.yaml NUM_GPUS 1 \
        TRAIN.BATCH_SIZE 4 DATA.PATH_TO_DATA_DIR DIR DATA.PATH_PREFIX DIR \
        OUTPUT_DIR OUT

and the leaderboard recipe itself on a host of eight:

    python -m aicity_action_tpu_torch.tools.run_net \
        --cfg configs/AICITY_MVITV2_B_16x4_448.yaml NUM_GPUS 8 ...

One process drives one card (PyTorch's idiom; the reference's
``launch_job``). ``NUM_GPUS`` > 1 spawns that many processes on this host,
process ``i`` on ``cuda:i``; ``NUM_SHARDS`` hosts run one command each
with ``--shard_id`` and a common ``--init_method``. The ranks join a
process group on ``DIST_BACKEND`` (``nccl``; ``gloo`` where named) and
train under ``DistributedDataParallel``. ``--ddp`` takes that path at one
rank too. ``--device cpu`` runs the plain PyTorch path, its ranks CPU
processes (``DIST_BACKEND gloo``); without a card the default ``cuda``
raises.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg", dest="cfg_file", required=True,
                   help="path to the config file")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--ddp", action="store_true",
                   help="join a process group and train under DDP even at "
                        "one rank")
    p.add_argument("--shard_id", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--init_method", default=None,
                   help="the process group's rendezvous, tcp://host:port "
                        "(INIT_METHOD)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                   help="KEY VALUE overrides of the config")
    return p.parse_args(argv)


def run(local_rank: int, cfg, device: str, ddp: bool, train=None,
        test=None) -> dict:
    """One rank: joins the group where the config or ``ddp`` asks for one,
    then ``train(cfg, device=...)`` where ``TRAIN.ENABLE`` and ``test(cfg,
    device=...)`` where ``TEST.ENABLE`` (by default the classification
    loops', ``engine/{train_loop,test_loop}.py``). Returns ``{"train": what
    train returned or None, "test": stats or None}``."""
    import torch

    from ..device import resolve_device
    from ..parallel import mesh

    if train is None:
        from ..engine.train_loop import train
    if test is None:
        from ..engine.test_loop import test

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and (
            mesh.world_size(cfg) > 1 or ddp):
        dev = torch.device("cuda", local_rank)
    dev = resolve_device(dev)
    grouped = mesh.init_distributed(cfg, local_rank, device=dev, force=ddp)
    out = {"train": None, "test": None}
    try:
        if cfg.TRAIN.ENABLE:
            out["train"] = train(cfg, device=dev)
        if cfg.TEST.ENABLE:
            out["test"] = test(cfg, device=dev)
    finally:
        if grouped:
            mesh.destroy()
    return out


def _spawned(local_rank: int, cfg, device: str, ddp: bool, train,
             test) -> None:
    run(local_rank, cfg, device, ddp, train, test)


def main(argv=None, train=None, test=None) -> dict:
    """Runs :func:`run` (with ``train`` and ``test`` where given) in this
    process, or, at ``NUM_GPUS`` > 1, in that many spawned processes (then
    returns ``{"train": None, "test": None}``: the ranks' results stay in
    ``OUTPUT_DIR``)."""
    from ..config import assert_and_infer_cfg, load_config
    from ..device import resolve_device
    from ..parallel import mesh

    args = parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: raise here
    cfg = assert_and_infer_cfg(load_config(args))
    mesh.check_card_count(cfg, args.device)
    if cfg.NUM_GPUS > 1:
        import torch.multiprocessing as mp

        mp.spawn(_spawned, args=(cfg, args.device, args.ddp, train, test),
                 nprocs=cfg.NUM_GPUS, join=True)
        return {"train": None, "test": None}
    return run(0, cfg, args.device, args.ddp, train, test)


if __name__ == "__main__":
    main()
