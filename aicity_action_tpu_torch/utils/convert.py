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
  leaves, so that tests compare the two packages leaf by leaf.
- :func:`load_pyth` reads a reference ``.pyth`` checkpoint's
  ``model_state``.
"""

from __future__ import annotations

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


def load_pyth(path: str) -> dict[str, torch.Tensor]:
    """The ``model_state`` of a reference ``.pyth`` checkpoint
    (``slowfast/utils/checkpoint.py:107-139`` format), with any DDP
    ``module.`` prefix stripped. Loads tensors and plain containers only
    (``weights_only``), on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model_state", ckpt)
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state.items()}
