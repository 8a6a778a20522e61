"""Weights across packages and from reference checkpoints.

- :func:`jax_params_to_state_dict` is the inverse of ``aicity_action_tpu/
  utils/convert.py:convert_mvit_state_dict``: a JAX MViT param tree (numpy
  leaves) becomes this port's ``state_dict``, whose names are the reference
  PySlowFast ones. Layout rules: dense ``kernel [in, out]`` -> ``weight
  [out, in]``; conv ``kernel [kT, kH, kW, in, out]`` and depthwise pool
  weights ``[kT, kH, kW, 1, C]`` -> ``[out, in, kT, kH, kW]``; LN ``scale``
  -> ``weight``.
- :func:`jax_tree_to_named` applies the same mapping to any tree of the
  params' structure (a gradient tree, an optimizer moment) and keeps numpy
  leaves, so that tests compare the two packages leaf by leaf. The
  multi-dataset head's leaves map by the same rules: ``head/head_{ds}/
  {kernel,bias}`` -> ``head.head_{ds}.{weight,bias}`` (its MLP variant's
  ``head/head_{ds}/fc{1,2}/...`` -> ``head.head_{ds}.fc{1,2}.*``) and
  ``head/cross_{src}_{dst}/kernel`` -> ``head.cross_{src}_{dst}.weight``.
  An MoE block's bank: ``blocks_{i}/mlp/router [D, E]`` -> ``blocks.{i}.
  mlp.router [E, D]``, ``fc1_kernel [E, D, H]`` / ``fc2_kernel [E, H, O]``
  -> ``fc1_weight [E, H, D]`` / ``fc2_weight [E, O, H]``, the ``fc*_bias``
  leaves unchanged.
- :func:`load_cross_proj_weight` sets the cross-dataset projections from
  word-embedding similarity ``.npy`` files.
- :func:`jax_actionclip_to_state_dict` / :func:`jax_actionclip_tree_to_named`
  carry a JAX ActionCLIP tree (``video_encoder``, ``text_encoder``,
  ``logit_scale``) over: the video tower by the MViT map (its contrastive
  head's ``norm`` and ``projection`` included), the text tower to CLIP's
  names (``resblocks_{i}`` -> ``resblocks.{i}``, ``in_proj_kernel [D,
  3D]`` -> ``attn.in_proj_weight [3D, D]``, ``c_fc`` / ``c_proj`` ->
  ``mlp.c_fc`` / ``mlp.c_proj``, ``token_embedding.embedding`` ->
  ``token_embedding.weight``; ``positional_embedding`` and a matrix
  ``text_projection`` keep their layout).
- :func:`jax_convnet_to_state_dict` is the inverse of ``convert_convnet_
  state_dict`` (``aicity_action_tpu/utils/convert.py:162``): JAX conv-net
  ``params`` and ``batch_stats`` become the port's ``state_dict``. DHWIO
  kernels become OIDHW, BatchNorm ``scale`` / ``mean`` / ``var`` become
  ``weight`` / ``running_mean`` / ``running_var``, flax's ``<name>/bn``
  wrappers and the stems' ``norm`` become the reference's ``<name>`` and
  ``bn``, and ``sN_pathwayP_stem`` becomes ``sN.pathwayP_stem``.
- :func:`load_pyth` reads a reference ``.pyth`` checkpoint's
  ``model_state``; :func:`load_c2_checkpoint` a Caffe2 ``.pkl`` through
  the reference's name chain (:func:`get_c2_name_convert_func`);
  :func:`inflate_2d_to_3d` repeats a 2-D kernel over time.
"""

from __future__ import annotations

import pickle
import re
from typing import Mapping

import numpy as np
import torch

_POOLS = ("pool_q", "pool_k", "pool_v")


def _conv_to_torch(w: np.ndarray) -> np.ndarray:
    return w.transpose(4, 3, 0, 1, 2)


def jax_params_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX MViT params (nested mappings of arrays) -> port ``state_dict``."""
    return {k: torch.from_numpy(v) for k, v in jax_tree_to_named(params).items()}


def jax_tree_to_named(tree: Mapping) -> dict[str, np.ndarray]:
    """A tree shaped like the JAX MViT params (params, gradients, ...) ->
    ``{port parameter name: numpy array in the port's layout}``."""
    sd: dict[str, np.ndarray] = {}

    def emit(path: list[str], leaf: str, w: np.ndarray) -> None:
        mods = ["blocks." + p[len("blocks_"):] if p.startswith("blocks_")
                else p for p in path]
        if mods == ["patch_embed"]:
            mods = ["patch_embed", "proj"]
        if leaf in _POOLS:
            mods, leaf, w = mods + [leaf], "weight", _conv_to_torch(w)
        elif leaf == "router":
            w = w.T
        elif leaf in ("fc1_kernel", "fc2_kernel"):
            leaf, w = leaf[:3] + "_weight", w.transpose(0, 2, 1)
        elif leaf == "kernel":
            leaf = "weight"
            w = w.T if w.ndim == 2 else _conv_to_torch(w)
        elif leaf == "scale":
            leaf = "weight"
        sd[".".join(mods + [leaf])] = np.array(w)

    def walk(node: Mapping, path: list[str]) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + [k])
            else:
                emit(path, k, np.asarray(v))

    walk(tree, [])
    return sd


def load_cross_proj_weight(cfg, model: torch.nn.Module) -> int:
    """Sets the multi-dataset head's cross projections of ``model`` from
    ``MODEL.LOAD_MULTI_PROJ_INIT_FILE``, a directory of ``{src}_{dst}.npy``
    files of torch-layout ``[classes of dst, classes of src]`` weights
    (``kinetics`` named ``kinetics{its classes}``; the JAX ``utils/
    convert.py:255``, reference train_net.py:567-617). Returns how many it
    set; a file of another shape raises."""
    import os

    datasets = list(cfg.MODEL.MULTI_DATASETS)
    num_classes = list(cfg.MODEL.MULTI_NUM_CLASSES)

    def fname(ds):
        if ds == "kinetics":
            return f"kinetics{num_classes[datasets.index(ds)]}"
        return ds

    head = getattr(model, "module", model).head
    n_loaded = 0
    for src in datasets:
        for dst in datasets:
            layer = getattr(head, f"cross_{src}_{dst}", None)
            if src == dst or layer is None:
                continue
            path = os.path.join(cfg.MODEL.LOAD_MULTI_PROJ_INIT_FILE,
                                f"{fname(src)}_{fname(dst)}.npy")
            w = np.load(path)
            if w.shape != tuple(layer.weight.shape):
                raise ValueError(f"{path}: shape {w.shape}, the projection "
                                 f"takes {tuple(layer.weight.shape)}")
            with torch.no_grad():
                layer.weight.copy_(torch.from_numpy(w))
            n_loaded += 1
    return n_loaded


def _text_tree_to_named(tree: Mapping) -> dict[str, np.ndarray]:
    """The JAX text tower's tree -> ``{CLIP name: numpy array}``."""
    sd: dict[str, np.ndarray] = {}

    def emit(path: list[str], leaf: str, w: np.ndarray) -> None:
        mods = []
        for p in path:
            if p.startswith("resblocks_"):
                mods += ["resblocks", p[len("resblocks_"):]]
            elif p in ("c_fc", "c_proj"):
                mods += ["mlp", p]
            else:
                mods.append(p)
        if leaf == "in_proj_kernel":
            leaf, w = "in_proj_weight", w.T
        elif leaf == "kernel":
            leaf, w = "weight", w.T
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        sd[".".join(mods + [leaf])] = np.array(w)

    def walk(node: Mapping, path: list[str]) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + [k])
            else:
                emit(path, k, np.asarray(v))

    walk(tree, [])
    return sd


def jax_actionclip_tree_to_named(tree: Mapping) -> dict[str, np.ndarray]:
    """A tree shaped like the JAX ActionCLIP params -> ``{port name: numpy
    array in the port's layout}``."""
    sd: dict[str, np.ndarray] = {}
    if "video_encoder" in tree:
        sd.update(("video_encoder." + k, v) for k, v in
                  jax_tree_to_named(tree["video_encoder"]).items())
    sd.update(("text_encoder." + k, v) for k, v in
              _text_tree_to_named(tree["text_encoder"]).items())
    sd["logit_scale"] = np.array(np.asarray(tree["logit_scale"]))
    return sd


def jax_actionclip_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX ActionCLIP params -> the port's ActionCLIP ``state_dict``."""
    return {k: torch.from_numpy(v)
            for k, v in jax_actionclip_tree_to_named(params).items()}


def load_pyth(path: str) -> dict[str, torch.Tensor]:
    """The ``model_state`` of a reference ``.pyth`` checkpoint
    (``slowfast/utils/checkpoint.py:107-139`` format), with any DDP
    ``module.`` prefix stripped. Loads tensors and plain containers only
    (``weights_only``), on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model_state", ckpt)
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state.items()}


_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}
_STEM = re.compile(r"(s\d+)_(pathway\d+_stem)")


def _is_bn_wrapper(name: str) -> bool:
    return name in ("bn", "norm") or name.endswith("_bn")


def jax_convnet_to_state_dict(params: Mapping,
                              batch_stats: Mapping | None = None
                              ) -> dict[str, torch.Tensor]:
    """JAX conv-net (ResNet / SlowFast / X3D) ``params`` and
    ``batch_stats`` (nested mappings of arrays) -> port ``state_dict``."""
    sd: dict[str, torch.Tensor] = {}

    def emit(path: list[str], leaf: str, w: np.ndarray) -> None:
        mods = list(path)
        m = _STEM.fullmatch(mods[0])
        if m:
            mods = [m.group(1), m.group(2)] + mods[1:]
        if len(mods) >= 2 and mods[-1] == "bn" and _is_bn_wrapper(mods[-2]):
            mods = mods[:-1]  # flax's BatchNorm inside the wrapper
        if mods[-1] == "norm":
            mods[-1] = "bn"  # a stem's norm
        if leaf == "kernel":
            w = w.T if w.ndim == 2 else _conv_to_torch(w)
            leaf = "weight"
        else:
            leaf = _BN_LEAVES.get(leaf, leaf)
        sd[".".join(mods + [leaf])] = torch.from_numpy(np.array(w))

    def walk(node: Mapping, path: list[str]) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + [k])
            else:
                emit(path, k, np.asarray(v))

    walk(params, [])
    walk(batch_stats or {}, [])
    return sd


def inflate_2d_to_3d(weight_2d, time_dim: int):
    """A 2-D conv kernel ``[O, I, H, W]`` repeated over ``time_dim`` and
    divided by it: ``[O, I, T, H, W]`` (reference checkpoint.py:142-179)."""
    if weight_2d.ndim != 4:
        raise ValueError(f"not a 2-D kernel: {tuple(weight_2d.shape)}")
    w = torch.as_tensor(np.asarray(weight_2d))
    return w.unsqueeze(2).repeat(1, 1, time_dim, 1, 1) / float(time_dim)


def get_c2_name_convert_func():
    """Caffe2 -> PyTorch layer names: the reference's whole rule chain
    (c2_model_loading.py:9-120), every substitution applied in order (the
    generic suffix rules last finish the names the structural rules
    made)."""
    chain = [
        # non-local blocks: nonlocal_convS_N_* -> sS.pathway0_nonlocalN_*
        (r"^nonlocal_conv([0-9]+)_([0-9]+)_(.*)",
         r"s\1.pathway0_nonlocal\2_\3"),
        (r"^(.*)_nonlocal([0-9]+)_(theta)(.*)", r"\1_nonlocal\2.conv_\3\4"),
        (r"^(.*)_nonlocal([0-9]+)_(g)(.*)", r"\1_nonlocal\2.conv_\3\4"),
        (r"^(.*)_nonlocal([0-9]+)_(phi)(.*)", r"\1_nonlocal\2.conv_\3\4"),
        (r"^(.*)_nonlocal([0-9]+)_(out)(.*)", r"\1_nonlocal\2.conv_\3\4"),
        (r"^(.*)_nonlocal([0-9]+)_(bn)_(.*)", r"\1_nonlocal\2.\3.\4"),
        # SlowFast lateral fusion
        (r"^t_pool1_subsample_bn_(.*)", r"s1_fuse.bn.\1"),
        (r"^t_pool1_subsample_(.*)", r"s1_fuse.conv_f2s.\1"),
        (r"^t_res([0-9]+)_([0-9]+)_branch2c_bn_subsample_bn_(.*)",
         r"s\1_fuse.bn.\3"),
        (r"^t_res([0-9]+)_([0-9]+)_branch2c_bn_subsample_(.*)",
         r"s\1_fuse.conv_f2s.\3"),
        # slow-pathway residual blocks and stem
        (r"^res([0-9]+)_([0-9]+)_branch([0-9]+)([a-z])_(.*)",
         r"s\1.pathway0_res\2.branch\3.\4_\5"),
        (r"^res_conv1_bn_(.*)", r"s1.pathway0_stem.bn.\1"),
        (r"^conv1_xy(.*)", r"s1.pathway0_stem.conv_xy\1"),
        (r"^conv1_(.*)", r"s1.pathway0_stem.conv.\1"),
        (r"^res([0-9]+)_([0-9]+)_branch([0-9]+)_(.*)",
         r"s\1.pathway0_res\2.branch\3_\4"),
        (r"^res_conv1_(.*)", r"s1.pathway0_stem.conv.\1"),
        # fast-pathway (t_-prefixed) residual blocks and stem
        (r"^t_res([0-9]+)_([0-9]+)_branch([0-9]+)([a-z])_(.*)",
         r"s\1.pathway1_res\2.branch\3.\4_\5"),
        (r"^t_res_conv1_bn_(.*)", r"s1.pathway1_stem.bn.\1"),
        (r"^t_conv1_(.*)", r"s1.pathway1_stem.conv.\1"),
        (r"^t_res([0-9]+)_([0-9]+)_branch([0-9]+)_(.*)",
         r"s\1.pathway1_res\2.branch\3_\4"),
        (r"^t_res_conv1_(.*)", r"s1.pathway1_stem.conv.\1"),
        # heads (X3D's conv_5 / lin_5 and the SE blocks too)
        (r"pred_(.*)", r"head.projection.\1"),
        (r"(.*)b_bn_fc(.*)", r"\1se.fc\2"),
        (r"conv_5(.*)", r"head.conv_5\1"),
        (r"lin_5(.*)", r"head.lin_5\1"),
        # generic BN / weight / bias suffixes, last
        (r"(.*)bn.b\Z", r"\1bn.bias"),
        (r"(.*)bn.s\Z", r"\1bn.weight"),
        (r"(.*)bn.rm\Z", r"\1bn.running_mean"),
        (r"(.*)bn.riv\Z", r"\1bn.running_var"),
        (r"(.*)[\._]b\Z", r"\1.bias"),
        (r"(.*)[\._]w\Z", r"\1.weight"),
    ]

    def convert(name: str) -> str:
        for pat, repl in chain:
            name = re.sub(pat, repl, name)
        return name

    return convert


def load_c2_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A Caffe2 ``.pkl`` checkpoint as ``{PyTorch name: tensor}``
    (reference checkpoint.py:219-287): its ``blobs`` without the momentum
    and iteration blobs, each name through the c2 chain."""
    with open(path, "rb") as f:
        ckpt = pickle.load(f, encoding="latin1")
    blobs = ckpt.get("blobs", ckpt)
    convert = get_c2_name_convert_func()
    return {convert(name): torch.from_numpy(np.array(blob))
            for name, blob in blobs.items()
            if "momentum" not in name and name not in ("model_iter", "lr")
            and isinstance(blob, np.ndarray)}
