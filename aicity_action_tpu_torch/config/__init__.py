from .node import CfgNode
from .defaults import (assert_and_infer_cfg, get_cfg, mvit_b_16x4_224_cfg,
                       mvitv2_b_16x4_448_cfg)
from .parser import parse_args, load_config

__all__ = ["CfgNode", "get_cfg", "assert_and_infer_cfg",
           "mvit_b_16x4_224_cfg", "mvitv2_b_16x4_448_cfg", "parse_args",
           "load_config"]
