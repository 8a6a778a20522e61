"""Shared set-up of the tests that hold the PyTorch port against the JAX
package: the tiny MViT-v2 config and numpy-made parameter noise."""

import jax
import numpy as np

YAML = "configs/AICITY_MVITV2_B_16x4_448.yaml"


def tiny_cfg(get):
    """The tiny MViT-v2 of the JAX package's entry point (depth 4, crop 32,
    4 frames, embed 32, f32), built on the repo's 448 config. ``get`` is
    either package's ``get_cfg``."""
    cfg = get()
    cfg.merge_from_file(YAML)
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.DEPTH = 4
    cfg.MVIT.DIM_MUL = [[1, 2.0], [3, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0], [3, 2.0]]
    cfg.MVIT.POOL_Q_STRIDE = [[1, 1, 2, 2], [3, 1, 2, 2]]
    cfg.MVIT.EMBED_DIM = 32
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def perturb(params, seed, std=0.05):
    """Every leaf of a JAX param tree plus numpy noise of ``std``, as numpy
    (so that LN scales and biases, initialized to 1 and 0, matter)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + std * rng.standard_normal(a.shape).astype(np.float32), params)
