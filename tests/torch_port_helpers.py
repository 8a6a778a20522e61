"""Shared set-up of the tests that hold the PyTorch port against the JAX
package: the tiny MViT-v2 and MViT-v1 configs, the JAX models built once
per process, numpy-made parameter noise, and the one-thread fixture each
port test module imports."""

import functools
import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

YAML = "configs/AICITY_MVITV2_B_16x4_448.yaml"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2  # ranks of the data-parallel tests


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


def l_tiny_cfg(get):
    """``tiny_cfg`` at the MViT-v2-L trunk's embedding and heads (EMBED_DIM
    144, NUM_HEADS 2: head dim 72, channels 144 -> 288 -> 576)."""
    cfg = tiny_cfg(get)
    cfg.MVIT.EMBED_DIM = 144
    cfg.MVIT.NUM_HEADS = 2
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


def scorer_models(seed):
    """``(module, params, mesh, model)``: the JAX package's tiny MViT-v2
    (no activation checkpointing; its initializers never run) on a
    one-device mesh, and the port's tiny model with the same weights: the
    port's draw from ``seed`` plus numpy noise (so that LN scales and
    biases matter), carried to the JAX package by its own converter."""
    from aicity_action_tpu.config import get_cfg as jax_get_cfg
    from aicity_action_tpu.models.build import build_module
    from aicity_action_tpu.parallel.mesh import make_mesh
    from aicity_action_tpu_torch.config import get_cfg
    from aicity_action_tpu_torch.models.build import build_model
    from aicity_action_tpu_torch.utils.convert import jax_params_to_state_dict

    cfg = tiny_cfg(jax_get_cfg)
    cfg.MODEL.ACT_CHECKPOINT = False
    module, _ = build_module(cfg)
    params = perturb(jax_tiny_params_from_port(seed), seed + 1)
    model = build_model(tiny_cfg(get_cfg), device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return module, params, make_mesh(cfg, devices=jax.devices()[:1]), model


def synthetic_i420(num_frames, w=64, h=48, seed=0):
    """Moving gradients with noisy chroma as planar I420 u8 ``[N, h*3//2,
    w]``, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.empty((num_frames, h * 3 // 2, w), np.uint8)
    for i in range(num_frames):
        out[i, :h] = (xx * 3 + yy * 2 + 5 * i) % 220 + 16
        out[i, h:] = rng.integers(64, 192, (h // 2, w))
    return out


def write_mp4(path, num_frames=90, fps=30, size=(64, 48), seed=1):
    """A ``size`` mp4v video of moving gradients and a noise channel,
    written by cv2."""
    import cv2

    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    yy, xx = np.mgrid[0:size[1], 0:size[0]]
    for i in range(num_frames):
        w.write(np.stack([(xx * 4 + i * 5) % 256, (yy * 5 + i * 3) % 256,
                          rng.integers(0, 256, xx.shape)], -1)
                .astype(np.uint8))
    w.release()


def free_init_method() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def start_ranks(job: dict, out):
    """Starts ``job`` on ``WORLD`` gloo ranks (one process that spawns
    them); :func:`collect_ranks` waits for them."""
    os.makedirs(out, exist_ok=True)
    job = dict(job, world=WORLD, out=str(out),
               init_method=free_init_method())
    path = os.path.join(out, "job.pkl")
    with open(path, "wb") as f:
        pickle.dump(job, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_dp_worker.py"),
         path], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, str(out)


def collect_ranks(handle) -> list:
    """Each rank's results of a :func:`start_ranks`."""
    proc, out = handle
    try:
        log, _ = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, log[-8000:]
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def tiny_clip_cfg(get, use_mlp=False):
    """The tiny ActionCLIP of the JAX package's contrastive tests
    (``tests/test_contrastive.py:_tiny_clip_cfg``): a depth-2 MViT-v2 of
    width 16 at crop 32 and 4 frames, a text tower of width 32, 2 layers, 2
    heads, context 8, vocabulary 64, embedding 16; dropout and DropPath 0,
    f32. ``get`` is either package's ``get_cfg``."""
    cfg = get()
    cfg.CONTRA.ENABLE = True
    cfg.CONTRA.transformer_width = 32
    cfg.CONTRA.transformer_layers = 2
    cfg.CONTRA.transformer_heads = 2
    cfg.CONTRA.CONTEXT_LENGTH = 8
    cfg.CONTRA.vocab_size = 64
    cfg.CONTRA.embed_dim = 16
    cfg.CONTRA.use_MLP = use_mlp
    cfg.MODEL.MODEL_NAME = "ActionCLIP"
    cfg.MODEL.ARCH = "mvit"
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.MODEL.ACT_CHECKPOINT = False
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.INPUT_CHANNEL_NUM = [3]
    m = cfg.MVIT
    m.EMBED_DIM = 16
    m.DEPTH = 2
    m.PATCH_PADDING = (1, 3, 3)
    m.DIM_MUL = [[1, 2.0]]
    m.HEAD_MUL = [[1, 2.0]]
    m.POOL_KVQ_KERNEL = [3, 3, 3]
    m.POOL_KV_STRIDE_ADAPTIVE = [1, 2, 2]
    m.POOL_Q_STRIDE = [[1, 1, 2, 2]]
    m.CLS_EMBED_ON = False
    m.SEP_POS_EMBED = True
    m.CHANNEL_EXPAND_FRONT = True
    m.Q_POOL_ALL = True
    m.Q_POOL_RESIDUAL = True
    m.DROPPATH_RATE = 0.0
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def clip_params_to_jax(state_dict) -> dict:
    """The port's ActionCLIP ``state_dict`` as JAX ActionCLIP params (numpy
    leaves): the video tower through the JAX package's own converter
    (``convert_mvit_state_dict``), the text tower by CLIP's names (the
    mapping of ``tests/test_contrastive.py:_convert_text_weights``)."""
    from aicity_action_tpu.utils.convert import convert_mvit_state_dict

    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    out = {"logit_scale": sd["logit_scale"]}
    video = {k[len("video_encoder."):]: v for k, v in sd.items()
             if k.startswith("video_encoder.")}
    if video:
        out["video_encoder"], skipped = convert_mvit_state_dict(video)
        if skipped:
            raise ValueError(f"unconverted port parameters: {skipped}")
    t = {k[len("text_encoder."):]: v for k, v in sd.items()
         if k.startswith("text_encoder.")}

    def ln(name):
        return {"scale": t[name + ".weight"], "bias": t[name + ".bias"]}

    def dense(name):
        return {"kernel": t[name + ".weight"].T, "bias": t[name + ".bias"]}

    text = {"token_embedding": {"embedding": t["token_embedding.weight"]},
            "positional_embedding": t["positional_embedding"],
            "ln_final": ln("ln_final")}
    if "text_projection" in t:
        text["text_projection"] = t["text_projection"]
    else:
        text["text_projection"] = {"fc1": dense("text_projection.fc1"),
                                   "fc2": dense("text_projection.fc2")}
    i = 0
    while f"resblocks.{i}.ln_1.weight" in t:
        r = f"resblocks.{i}"
        text[f"resblocks_{i}"] = {
            "ln_1": ln(r + ".ln_1"), "ln_2": ln(r + ".ln_2"),
            "attn": {"in_proj_kernel": t[r + ".attn.in_proj_weight"].T,
                     "in_proj_bias": t[r + ".attn.in_proj_bias"],
                     "out_proj": dense(r + ".attn.out_proj")},
            "c_fc": dense(r + ".mlp.c_fc"),
            "c_proj": dense(r + ".mlp.c_proj")}
        i += 1
    out["text_encoder"] = text
    return out


def write_merges(path) -> str:
    """A small CLIP merges file (the version line, then merges) written in
    code: the real ``bpe_simple_vocab_16e6.txt.gz`` is user-supplied."""
    merges = ["h e", "he l", "hel l", "hell o</w>", "w o", "wo r", "wor l",
              "worl d</w>", "t h", "th e</w>", "i n", "in g</w>", "a n",
              "an d</w>", "p e", "pe r", "per s", "pers o", "perso n</w>",
              "d r", "dr i", "dri n", "drin k", "drink ing</w>", "p h",
              "ph o", "pho n", "phon e</w>", "t e", "te x", "tex t",
              "text ing</w>", "c a", "ca r</w>", "e a", "ea t", "eat ing</w>",
              "r e", "re a", "rea ch", "o f</w>", "a </w>", "s </w>"]
    with open(path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(path)


def multihead_cfg(get, use_mlp=False):
    """The tiny MViT-v2 (``tiny_cfg``) with the multi-dataset heads of the
    reference's default datasets at tiny class counts (7, 5, 4), the cross
    projections and VICReg on, no dropout or DropPath, SGD. ``get`` is
    either package's ``get_cfg``."""
    cfg = tiny_cfg(get)
    cfg.MODEL.ACT_CHECKPOINT = False
    cfg.MODEL.USE_MULTI_HEAD = True
    cfg.MODEL.MULTI_NUM_CLASSES = [7, 5, 4]
    cfg.MODEL.MULTI_USE_MLP = use_mlp
    cfg.MODEL.MULTI_ADD_CROSS_PROJ = True
    cfg.MODEL.USE_VICREG_LOSS = True
    cfg.MODEL.VICREG_LOSS_WEIGHT = 0.5
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.SOLVER.OPTIMIZING_METHOD = "sgd"
    return cfg


def multihead_params_to_jax(state_dict) -> dict:
    """A port multi-head MViT's ``state_dict`` as JAX params (numpy
    leaves): the trunk through the JAX package's own converter, the heads'
    leaves (which it does not map) by the port's one-to-one names:
    ``head.head_{ds}[.fcN].{weight,bias}`` -> ``head/head_{ds}[/fcN]/
    {kernel,bias}``, ``head.cross_{src}_{dst}.weight`` -> ``head/
    cross_{src}_{dst}/kernel``."""
    from aicity_action_tpu.utils.convert import convert_mvit_state_dict

    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    params, skipped = convert_mvit_state_dict(sd)
    head = params.setdefault("head", {})
    for name in skipped:
        parts = name.split(".")
        if parts[0] != "head":
            raise ValueError(f"unconverted port parameter: {name}")
        node = head
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        w = sd[name]
        if parts[-1] == "weight":
            node["kernel"] = w.T
        else:
            node["bias"] = w
    return params


def moe_cfg(get, num_experts=4, top_k=2, capacity_factor=1.25):
    """:func:`tiny_cfg` with ``MVIT.MOE`` on (every other block an expert
    bank: blocks 1 and 3), no activation checkpointing."""
    cfg = tiny_cfg(get)
    cfg.MODEL.ACT_CHECKPOINT = False
    m = cfg.MVIT.MOE
    m.ENABLE, m.NUM_EXPERTS, m.TOP_K = True, num_experts, top_k
    m.CAPACITY_FACTOR = capacity_factor
    return cfg


def moe_params_to_jax(state_dict) -> dict:
    """A port MoE MViT's ``state_dict`` as the JAX package's params: the
    JAX converter for every dense leaf, the expert banks by hand
    (``router [E, D]`` -> ``[D, E]``, ``fc*_weight [E, out, in]`` ->
    ``fc*_kernel [E, in, out]``). Numpy leaves."""
    from aicity_action_tpu.utils.convert import convert_mvit_state_dict

    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    bank = {k: v for k, v in sd.items() if ".mlp.router" in k
            or ".mlp.fc1_" in k or ".mlp.fc2_" in k}
    params, skipped = convert_mvit_state_dict(
        {k: v for k, v in sd.items() if k not in bank})
    if skipped:
        raise ValueError(f"unconverted port parameters: {skipped}")
    for k, v in bank.items():
        _, i, _, leaf = k.split(".")
        if leaf == "router":
            v = v.T
        elif leaf.endswith("_weight"):
            leaf, v = leaf[:3] + "_kernel", v.transpose(0, 2, 1)
        params[f"blocks_{i}"].setdefault("mlp", {})[leaf] = np.array(v)
    return params
