"""Checkpoints: training save / resume and test-time weights (port of
``aicity_action_tpu/utils/checkpoint.py``; reference:
slowfast/utils/checkpoint.py).

- Saves every ``TRAIN.CHECKPOINT_PERIOD`` epochs (and after the last) to
  ``OUTPUT_DIR/checkpoints/checkpoint_epoch_{N:05d}``, the JAX package's
  names, so that "the last checkpoint" (the largest epoch by name) is the
  same epoch in both. Where the JAX package writes an orbax directory, the
  port writes one ``torch.save`` file in the reference ``.pyth`` format:
  ``epoch``, ``model_state`` (the reference parameter names),
  ``optimizer_state`` and ``cfg``, plus ``step``, the optimizer's step
  count, on which the LR schedule and the step's random draws key, and
  under MoCo ``ema_state``, the momentum model's ``state_dict`` (the JAX
  package's ``ema_params``, ``checkpoint.py:123-124``). The run's
  ``config.yaml`` goes beside them.
- ``TPU.ASYNC_CHECKPOINT``: the copy to the host stays on the training
  thread; only the file write moves to a writer thread, one in flight at a
  time. Every checkpoint scan or load drains it first
  (:func:`wait_for_pending_saves`), and a failed write raises there.
- :func:`load_train_checkpoint`: the last checkpoint of ``OUTPUT_DIR``
  (``TRAIN.AUTO_RESUME``), else ``TRAIN.CHECKPOINT_FILE_PATH`` (a partial
  load by shape, ``CHECKPOINT_CLEAR_NAME_PATTERN`` stripped from the names,
  the epoch kept unless ``CHECKPOINT_EPOCH_RESET``), else epoch 0.
  Auto-resume restores the momentum weights too (``checkpoint.py:
  219-222``).
- :func:`load_test_checkpoint`: ``TEST.CHECKPOINT_FILE_PATH``, else the
  last checkpoint, else ``TRAIN.CHECKPOINT_FILE_PATH``. Into a text-only
  ActionCLIP (``MODEL.LOAD_VISUAL False``) this loads the text tower and
  ``logit_scale``: the video tower's keys are skipped as the model lacks
  them.

A torch checkpoint's ``model_state`` (or a bare state dict) is merged into
the model by shape: a key whose shape matches the model's parameter is
loaded, a key whose shape differs or that the model lacks is skipped, and a
parameter the checkpoint lacks keeps the model's own value (the reference's
fine-tuning load, ``checkpoint.py:322-347``). The port keeps the
reference's parameter names, so the only rename is DDP's ``module.``
prefix. A 2-D kernel ``[O, I, H, W]`` loads into a 3-D one by temporal
inflation, and a plain BatchNorm's ``[C]`` statistics into a SubBatchNorm's
``[splits, C]`` by repetition, as the JAX package's loader does. Caffe2
``.pkl`` checkpoints go through the reference's name chain
(``utils/convert.py:load_c2_checkpoint``). A conv net's ``model_state``
holds its BatchNorm statistics (``running_mean`` / ``running_var``), which
the JAX package's converter carries to its ``batch_stats``.

Data parallelism: only rank 0 writes; under ZeRO every rank first hands
its optimizer shard to rank 0, so that the file has the plain optimizer's
format (a run saved under ``zero_adamw`` resumes under ``adamw`` and back).
Every load starts with a barrier, so that no rank reads before rank 0's
writes are done.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from typing import Optional

import torch

from ..parallel import mesh
from .convert import inflate_2d_to_3d, load_c2_checkpoint, load_pyth

logger = logging.getLogger(__name__)

_NAME_RE = re.compile(r"checkpoint_epoch_(\d+)")


def checkpoint_dir(output_dir: str) -> str:
    return os.path.join(output_dir, "checkpoints")


def checkpoint_path(output_dir: str, epoch: int) -> str:
    return os.path.join(
        checkpoint_dir(output_dir), f"checkpoint_epoch_{epoch:05d}")


class _Writer:
    """The one checkpoint write in flight and the error it left."""

    def __init__(self):
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None


_writer = _Writer()


def wait_for_pending_saves() -> None:
    """Join the in-flight checkpoint write, re-raising its error."""
    t = _writer.thread
    if t is not None:
        t.join()
        _writer.thread = None
    if _writer.error is not None:
        err, _writer.error = _writer.error, None
        raise err


def get_last_checkpoint(output_dir: str) -> Optional[str]:
    wait_for_pending_saves()
    d = checkpoint_dir(output_dir)
    if not os.path.isdir(d):
        return None
    names = [n for n in os.listdir(d) if _NAME_RE.fullmatch(n)]
    if not names:
        return None
    return os.path.join(d, max(names))


def has_checkpoint(output_dir: str) -> bool:
    return get_last_checkpoint(output_dir) is not None


def is_checkpoint_epoch(cfg, cur_epoch: int) -> bool:
    return (cur_epoch + 1) % cfg.TRAIN.CHECKPOINT_PERIOD == 0 or (
        cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH)


def _to_host(obj):
    """A copy of ``obj`` with every tensor on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write(payload: dict, path: str) -> None:
    t = time.perf_counter()
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    logger.info("Saved checkpoint to %s (%.2f s)", path,
                time.perf_counter() - t)


def save_checkpoint(output_dir: str, model: torch.nn.Module, optimizer,
                    epoch: int, cfg=None, *, async_write: bool = False,
                    momentum_model: Optional[torch.nn.Module] = None) -> str:
    """Save epoch ``epoch + 1``: the model's ``state_dict``, the torch
    optimizer's and ``optimizer.count`` (a :class:`~aicity_action_tpu_torch.
    solver.optimizer.TrainOptimizer`), and MoCo's ``momentum_model``'s
    ``state_dict`` where given, copied to the host here; the file is
    written here or, with ``async_write``, on the writer thread. Every rank
    calls it (ZeRO's shards gather here); rank 0 writes."""
    path = checkpoint_path(output_dir, epoch + 1)
    opt_state = optimizer.state_dict()
    if not mesh.is_main_process():
        return path
    wait_for_pending_saves()
    os.makedirs(checkpoint_dir(output_dir), exist_ok=True)
    payload = {
        "epoch": epoch + 1,
        "step": int(optimizer.count),
        "model_state": _to_host(model.state_dict()),
        "optimizer_state": _to_host(opt_state),
        "cfg": cfg.dump() if cfg is not None else "",
    }
    if momentum_model is not None:
        payload["ema_state"] = _to_host(momentum_model.state_dict())
    if cfg is not None:
        with open(os.path.join(checkpoint_dir(output_dir),
                               "config.yaml"), "w") as f:
            f.write(cfg.dump())
    if not async_write:
        _write(payload, path)
        return path

    def write():
        try:
            _write(payload, path)
        except Exception as e:  # raised at the next drain
            _writer.error = e

    _writer.thread = threading.Thread(target=write, name="ckpt-writer")
    _writer.thread.start()
    return path


def merge_state_dict(model: torch.nn.Module, state: dict):
    """Load the entries of ``state`` whose shapes match ``model``'s, cast
    to the model's dtypes; the model keeps its own value elsewhere. A 2-D
    conv kernel is inflated to the model's 3-D one, and a ``[C]`` BatchNorm
    statistic is repeated into a SubBatchNorm's ``[splits, C]``. Returns ``(loaded, mismatched,
    missing)``: keys loaded, ``(key, checkpoint shape, model shape or
    None)`` of the keys skipped, and the model's keys the checkpoint
    lacks."""
    own = model.state_dict()
    merged = dict(own)
    loaded, mismatched = [], []
    for k, v in state.items():
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(v)
        want = tuple(own[k].shape) if k in own else None
        if want and v.dim() == 4 and len(want) == 5 and \
                tuple(v.shape) == want[:2] + want[3:]:
            v = inflate_2d_to_3d(v, want[2])
        elif want and k.endswith(("running_mean", "running_var")) and \
                len(want) == v.dim() + 1 and want[1:] == v.shape:
            v = v[None].repeat(want[0], *([1] * v.dim()))
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


def _check_torch_path(path: str) -> None:
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: a directory (the JAX package's orbax layout); the port "
            f"reads torch checkpoint files")


def load_torch_checkpoint(path: str, model: torch.nn.Module,
                          clear_name_pattern=()):
    """Merge a torch checkpoint's weights (:func:`~aicity_action_tpu_torch.
    utils.convert.load_pyth`) into ``model`` by shape
    (:func:`merge_state_dict`), each of ``clear_name_pattern`` removed from
    the names first; logs ``torch load: N loaded, N shape-mismatched, N
    missing`` and up to 10 mismatches. Returns what
    :func:`merge_state_dict` returns."""
    _check_torch_path(path)
    state = load_c2_checkpoint(path) if path.endswith(".pkl") \
        else load_pyth(path)
    for p in clear_name_pattern:
        state = {k.replace(p, ""): v for k, v in state.items()}
    loaded, mismatched, missing = merge_state_dict(model, state)
    logger.info("torch load: %d loaded, %d shape-mismatched, %d missing",
                len(loaded), len(mismatched), len(missing))
    for k, got, want in mismatched[:10]:
        logger.info("  mismatch %s: ckpt %s vs model %s", k, got, want)
    return loaded, mismatched, missing


def _load_epoch(path: str) -> int:
    if path.endswith(".pkl"):
        return 0
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return int(ckpt.get("epoch", 0)) if isinstance(ckpt, dict) else 0


def resume_checkpoint(path: str, model: torch.nn.Module, optimizer,
                      momentum_model: Optional[torch.nn.Module] = None) -> int:
    """Restore a training checkpoint of :func:`save_checkpoint` whole: the
    model (strictly), the torch optimizer's state and its step count, and
    the momentum weights into ``momentum_model`` where the checkpoint has
    them (else it keeps its own, as the JAX package's resume does).
    Returns the checkpoint's epoch."""
    _check_torch_path(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["model_state"])
    if momentum_model is not None and "ema_state" in ckpt:
        momentum_model.load_state_dict(ckpt["ema_state"])
    optimizer.opt.load_state_dict(ckpt["optimizer_state"])
    optimizer.count = int(ckpt["step"])
    return int(ckpt["epoch"])


def load_train_checkpoint(cfg, model: torch.nn.Module, optimizer,
                          momentum_model: Optional[torch.nn.Module] = None
                          ) -> int:
    """Auto-resume from the last checkpoint (MoCo's momentum weights
    included) > ``TRAIN.CHECKPOINT_FILE_PATH`` (weights only) > fresh.
    Returns the epoch to start from."""
    mesh.barrier()
    if cfg.TRAIN.AUTO_RESUME and has_checkpoint(cfg.OUTPUT_DIR):
        last = get_last_checkpoint(cfg.OUTPUT_DIR)
        logger.info("Auto-resuming from %s", last)
        return resume_checkpoint(last, model, optimizer, momentum_model)
    path = cfg.TRAIN.CHECKPOINT_FILE_PATH
    if path:
        load_torch_checkpoint(path, model,
                              cfg.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN)
        return 0 if cfg.TRAIN.CHECKPOINT_EPOCH_RESET else _load_epoch(path)
    return 0


def load_test_checkpoint(cfg, model: torch.nn.Module) -> None:
    """``TEST.CHECKPOINT_FILE_PATH`` > the last checkpoint of
    ``OUTPUT_DIR`` > ``TRAIN.CHECKPOINT_FILE_PATH`` into ``model``, by
    shape (``checkpoint.py:466-501``); else the model keeps its
    initialization."""
    mesh.barrier()
    if cfg.TEST.CHECKPOINT_FILE_PATH:
        load_torch_checkpoint(cfg.TEST.CHECKPOINT_FILE_PATH, model)
    elif has_checkpoint(cfg.OUTPUT_DIR):
        load_torch_checkpoint(get_last_checkpoint(cfg.OUTPUT_DIR), model)
    elif cfg.TRAIN.CHECKPOINT_FILE_PATH:
        load_torch_checkpoint(cfg.TRAIN.CHECKPOINT_FILE_PATH, model)
    else:
        logger.info("Testing with random initialization (no checkpoint "
                    "found)")
