"""Test-time weights from torch checkpoints (the torch branch of
``aicity_action_tpu/utils/checkpoint.py:load_checkpoint`` and its
``load_test_checkpoint``).

A reference ``.pyth`` / ``.pth`` / ``.pt`` checkpoint's ``model_state``
(or a bare state dict) is merged into the model by shape: a key whose
shape matches the model's parameter is loaded, a key whose shape differs or
that the model lacks is skipped, and a parameter the checkpoint lacks keeps
the model's own value (the reference's fine-tuning load,
``checkpoint.py:322-347``). The port keeps the reference's parameter names,
so the only rename is DDP's ``module.`` prefix. Caffe2 ``.pkl`` checkpoints
and the port's own training checkpoints are not ported (ROADMAP Queue 1
item 6).
"""

from __future__ import annotations

import logging

import torch

from .convert import load_pyth

logger = logging.getLogger(__name__)

TORCH_SUFFIXES = (".pyth", ".pth", ".pt")


def merge_state_dict(model: torch.nn.Module, state: dict):
    """Load the entries of ``state`` whose shapes match ``model``'s, cast
    to the model's dtypes; the model keeps its own value elsewhere. Returns
    ``(loaded, mismatched, missing)``: keys loaded, ``(key, checkpoint
    shape, model shape or None)`` of the keys skipped, and the model's keys
    the checkpoint lacks."""
    own = model.state_dict()
    merged = dict(own)
    loaded, mismatched = [], []
    for k, v in state.items():
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(v)
        if k not in own:
            mismatched.append((k, tuple(v.shape), None))
        elif tuple(v.shape) != tuple(own[k].shape):
            mismatched.append((k, tuple(v.shape), tuple(own[k].shape)))
        else:
            merged[k] = v.to(own[k].dtype)
            loaded.append(k)
    missing = [k for k in own if k not in state]
    model.load_state_dict(merged)
    return loaded, mismatched, missing


def load_torch_checkpoint(path: str, model: torch.nn.Module):
    """Merge a torch checkpoint's weights (:func:`~aicity_action_tpu_torch.
    utils.convert.load_pyth`) into ``model`` by shape
    (:func:`merge_state_dict`); logs ``torch load: N loaded, N
    shape-mismatched, N missing`` and up to 10 mismatches. Returns what
    :func:`merge_state_dict` returns."""
    if not path.endswith(TORCH_SUFFIXES):
        raise NotImplementedError(
            f"{path}: only torch checkpoints ({', '.join(TORCH_SUFFIXES)}) "
            f"are ported; Caffe2 .pkl and training checkpoints wait for "
            f"ROADMAP Queue 1 item 6")
    loaded, mismatched, missing = merge_state_dict(model, load_pyth(path))
    logger.info("torch load: %d loaded, %d shape-mismatched, %d missing",
                len(loaded), len(mismatched), len(missing))
    for k, got, want in mismatched[:10]:
        logger.info("  mismatch %s: ckpt %s vs model %s", k, got, want)
    return loaded, mismatched, missing


def load_test_checkpoint(cfg, model: torch.nn.Module) -> None:
    """``TEST.CHECKPOINT_FILE_PATH``, else ``TRAIN.CHECKPOINT_FILE_PATH``,
    into ``model`` (the JAX package's order, without its training-run
    directory, whose checkpoints the port cannot read yet); else the
    model keeps its initialization."""
    path = cfg.TEST.CHECKPOINT_FILE_PATH or cfg.TRAIN.CHECKPOINT_FILE_PATH
    if path:
        load_torch_checkpoint(path, model)
    else:
        logger.info("Testing with random initialization (no checkpoint "
                    "found)")
