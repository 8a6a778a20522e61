from .node import CfgNode
from .defaults import (actionclip_mvitv2_b_16x4_448_cfg, assert_and_infer_cfg,
                       get_cfg, mvit_b_16x4_224_cfg, mvitv2_b_16x4_448_cfg,
                       mvitv2_b_16x4_448_det_cfg, mvitv2_b_16x4_448_moe_cfg,
                       mvitv2_l_16x4_448_cfg, slowfast_8x8_r50_cfg,
                       slowfast_32x2_r50_ava_cfg)
from .parser import parse_args, load_config

__all__ = ["CfgNode", "get_cfg", "assert_and_infer_cfg",
           "actionclip_mvitv2_b_16x4_448_cfg",
           "mvit_b_16x4_224_cfg", "mvitv2_b_16x4_448_cfg",
           "mvitv2_b_16x4_448_det_cfg", "mvitv2_b_16x4_448_moe_cfg",
           "mvitv2_l_16x4_448_cfg",
           "slowfast_8x8_r50_cfg",
           "slowfast_32x2_r50_ava_cfg", "parse_args",
           "load_config"]
