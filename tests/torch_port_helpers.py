"""Shared set-up of the tests that hold the PyTorch port against the JAX
package: the tiny MViT-v2 and MViT-v1 configs, the JAX models built once
per process, numpy-made parameter noise, and the one-thread fixture each
port test module imports."""

import functools

import jax
import numpy as np
import pytest
import torch

YAML = "configs/AICITY_MVITV2_B_16x4_448.yaml"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Runs a test module's torch work on one thread (restored after): the
    port's test files share the CPU with the suite's other workers, and
    their small tensors gain nothing from torch's thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@functools.lru_cache(maxsize=None)
def jax_tiny_model():
    """``(module, params)`` of the JAX package's tiny MViT-v2 without
    activation checkpointing (its jit of a remat'ed block traces the static
    (T, H, W), and the callers run eval forwards), built once per process.
    The params are the ones ``build_model`` makes (its ``lazy_init`` from
    ``RNG_SEED``, the XLA attention path), with the initializers run as one
    jitted program rather than op by op, which is ~4x faster on a CPU.
    Callers must not mutate ``params``."""
    from aicity_action_tpu.config import get_cfg
    from aicity_action_tpu.models.build import build_module
    from aicity_action_tpu.ops.pallas import flash_attention as fa

    cfg = tiny_cfg(get_cfg)
    cfg.MODEL.ACT_CHECKPOINT = False
    module, example = build_module(cfg)
    with fa.disabled():
        variables = jax.jit(lambda rng: module.lazy_init(
            {"params": rng}, example))(jax.random.PRNGKey(cfg.RNG_SEED))
    return module, variables["params"]


@functools.lru_cache(maxsize=None)
def jax_tiny_v1_model():
    """``(module, params)`` of the JAX package's tiny cls-token MViT-v1
    (:func:`tiny_v1_cfg`, no activation checkpointing), built once per
    process. The params are the port's model drawn from seed 0, carried
    over by the JAX package's own converter (no JAX init runs: it costs
    seconds on a CPU). Callers must not mutate ``params``."""
    from aicity_action_tpu.config import get_cfg
    from aicity_action_tpu.models.build import build_module

    module, _ = build_module(tiny_v1_cfg(get_cfg))
    return module, jax_tiny_params_from_port(make_cfg=tiny_v1_cfg)


def jax_tiny_params_from_port(seed=0, make_cfg=tiny_cfg):
    """A tiny MViT's params for the JAX package (the v2 of ``tiny_cfg``
    unless ``make_cfg`` says otherwise) made without building the JAX
    model: the port's model drawn from ``seed``, its ``state_dict`` through
    the JAX package's own converter (``convert_mvit_state_dict``, held
    exact by test_torch_modules). Numpy leaves."""
    from aicity_action_tpu.utils.convert import convert_mvit_state_dict
    from aicity_action_tpu_torch.config import get_cfg
    from aicity_action_tpu_torch.models.build import build_model

    model = build_model(make_cfg(get_cfg), device="cpu", seed=seed)
    params, skipped = convert_mvit_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    if skipped:
        raise ValueError(f"unconverted port parameters: {skipped}")
    return params


def tiny_v1_cfg(get):
    """A tiny MViT-v1 with a cls token (depth 4, crop 32, 4 frames, embed
    32, f32, no activation checkpointing): the MVIT and SOLVER sections of
    the port's ``mvit_b_16x4_224_cfg`` (PySlowFast's K400
    MVIT_B_16x4_CONV), the model cut to depth 4, so that blocks 0 and 2 change the channels in the MLP. ``get``
    is either package's ``get_cfg``."""
    from aicity_action_tpu_torch.config.defaults import _MVIT_B_16x4_224

    cfg = get()
    for section in ("MVIT", "SOLVER"):
        for key, value in _MVIT_B_16x4_224[section].items():
            setattr(getattr(cfg, section), key, value)
    cfg.MODEL.MODEL_NAME = "MViT"
    cfg.MODEL.ARCH = "mvit"
    cfg.MODEL.NUM_CLASSES = 18
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.DEPTH = 4
    cfg.MVIT.DIM_MUL = [[1, 2.0], [3, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0], [3, 2.0]]
    cfg.MVIT.POOL_Q_STRIDE = [[1, 1, 2, 2], [3, 1, 2, 2]]
    cfg.MVIT.EMBED_DIM = 32
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def dense_call_shapes(cfg, batch):
    """The ``fused_ln_qkv`` and ``fused_ln_mlp`` calls of the port's forward
    at ``batch``, from the model's block schedule (no model is built):
    ``("qkv", M, tokens, D, C)`` per block (x ``[M, D]`` -> q, k, v of C
    channels) and ``("mlp", M, C, H)`` per block whose MLP keeps its
    channels (the others run a separate norm2 and plain products)."""
    from aicity_action_tpu_torch.models.mvit import build_mvit_spec

    sp = build_mvit_spec(cfg)
    thw, cls = list(sp.patch_dims), int(sp.cls_embed)
    calls = []
    for b in sp.blocks:
        att = (b.dim_out if sp.channel_expand_front and b.dim != b.dim_out
               else b.dim)
        tokens = int(np.prod(thw)) + cls
        calls.append(("qkv", batch * tokens, tokens, b.dim, att))
        if b.stride_q and b.kernel_q:  # the conv q pool, padding k // 2
            thw = [(n + 2 * (k // 2) - k) // s + 1
                   for n, k, s in zip(thw, b.kernel_q, b.stride_q)]
        if att == b.dim_out:
            calls.append(("mlp", batch * (int(np.prod(thw)) + cls), att,
                          int(att * sp.mlp_ratio)))
    return calls
