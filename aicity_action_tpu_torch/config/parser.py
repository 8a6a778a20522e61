"""CLI argument parsing.

Parity with the reference parser (`slowfast/utils/parser.py:28-98`):
``--cfg FILE`` plus a trailing ``KEY VALUE ...`` override list, and the
multi-host flags. ``--init_method`` is accepted for CLI compatibility but
unused by the single-card serving path.
"""

import argparse
import sys

from .defaults import get_cfg


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="PyTorch/CUDA video understanding framework"
    )
    parser.add_argument(
        "--shard_id", type=int, default=0,
        help="The shard id (host index) of current node",
    )
    parser.add_argument(
        "--num_shards", type=int, default=1,
        help="Number of hosts using this job",
    )
    parser.add_argument(
        "--init_method", type=str, default="tcp://localhost:9999",
        help="Coordinator address for multi-host init",
    )
    parser.add_argument(
        "--cfg", dest="cfg_file", type=str, default=None,
        help="Path to the config file",
    )
    parser.add_argument(
        "opts", nargs=argparse.REMAINDER, default=None,
        help="See aicity_action_tpu_torch/config/defaults.py for all options",
    )
    if argv is None:
        argv = sys.argv[1:]
    if len(argv) == 0:
        parser.print_help()
    return parser.parse_args(argv)


def load_config(args):
    """Build a config from defaults, the YAML file, and CLI overrides."""
    cfg = get_cfg()
    if getattr(args, "cfg_file", None):
        cfg.merge_from_file(args.cfg_file)
    if getattr(args, "opts", None):
        cfg.merge_from_list(args.opts)

    if hasattr(args, "num_shards") and hasattr(args, "shard_id"):
        cfg.NUM_SHARDS = args.num_shards
        cfg.SHARD_ID = args.shard_id
    return cfg
