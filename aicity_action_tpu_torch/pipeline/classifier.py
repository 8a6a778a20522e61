"""Deployable video action classifier (port of ``aicity_action_tpu/
pipeline/classifier.py``; reference: scripts/module_wrapper.py:403-611,
which dispatches between PyTorch eager, ONNX Runtime / TensorRT and
TorchScript).

- The eager model is the port's, on the card; a checkpoint loads through
  ``utils/checkpoint.py:load_test_checkpoint`` (by shape).
- The deployment artifact is a ``torch.export`` program (where the JAX
  package exports StableHLO): :meth:`VideoActionClassifier.export` traces
  the scorer at the fixed batch and writes it with ``torch.export.save``;
  :func:`load_exported` (or ``exported_path=``) loads it with
  ``torch.export.load(...).module()``, no model-building code needed. The
  inference kernels trace as the custom ops ``aicity::*``
  (``ops/kernels/__init__.py:export_op``), so the loaded program launches
  the hand-written kernels on the card; the ops module must be imported
  before a program is loaded, which :func:`load_exported` does.
- Batches are padded to ``batch_size`` (the last clip repeated) and longer
  ones split, so that one traced shape serves every call (the reference's
  ONNX fixed-batch workaround, module_wrapper.py:580-596).
- A detection checkpoint scores whole clips through its RoI head on one
  whole-frame box a sample (module_wrapper.py:558-576).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn


class _Scorer(nn.Module):
    """The model on its pathways' clips ``[B, T, H, W, C]``: the eval
    scores in f32, a detection model's through one ``[i, 0, 0, W, H]`` box
    a clip."""

    def __init__(self, model: nn.Module, detection: bool):
        super().__init__()
        self.model = model
        self.detection = detection

    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        if not self.detection:
            return self.model(list(xs)).float()
        b, _, h, w, _ = xs[0].shape
        boxes = torch.zeros((b, 5), dtype=torch.float32, device=xs[0].device)
        boxes[:, 0] = torch.arange(b, device=xs[0].device)
        boxes[:, 3] = float(w)
        boxes[:, 4] = float(h)
        return self.model(list(xs), boxes).float()


class VideoActionClassifier:
    """Batched clip scorer with a stable ``inference(frames) -> scores``
    API, on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg, checkpoint_path: str = "", *,
                 batch_size: int = 8, exported_path: str = "",
                 device: str | torch.device = "cuda"):
        from ..device import resolve_device

        self.cfg = cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        if exported_path:
            self._fn = load_exported(exported_path)
            self.scorer = None
            return
        from ..models.build import build_model
        from ..utils.checkpoint import load_test_checkpoint

        model = build_model(cfg, device=self.device)
        if checkpoint_path:
            cfg.TEST.CHECKPOINT_FILE_PATH = checkpoint_path
        load_test_checkpoint(cfg, model)
        self.scorer = _Scorer(model.eval(), bool(cfg.DETECTION.ENABLE))
        self._fn = self.scorer

    def _shapes(self) -> list[tuple]:
        """The pathways' clip shapes at the fixed batch."""
        cfg = self.cfg
        T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
        if cfg.MODEL.ARCH in cfg.MODEL.MULTI_PATHWAY_ARCH:
            return [(self.batch_size, T // cfg.SLOWFAST.ALPHA, S, S, 3),
                    (self.batch_size, T, S, S, 3)]
        return [(self.batch_size, T, S, S, 3)]

    @torch.no_grad()
    def inference(self, frames: Sequence[np.ndarray]) -> np.ndarray:
        """``frames``: the pathways' clips ``[B, T, H, W, C]`` (numpy f32,
        normalized). Returns the ``[B, classes]`` scores (the eval head's
        activation), f32 numpy."""
        b = frames[0].shape[0]
        if b > self.batch_size:
            return np.concatenate([
                self.inference([x[i:i + self.batch_size] for x in frames])
                for i in range(0, b, self.batch_size)])
        xs = list(frames)
        if b < self.batch_size:
            pad = self.batch_size - b
            xs = [np.concatenate([x, np.repeat(x[-1:], pad, 0)]) for x in xs]
        xs = [torch.from_numpy(np.ascontiguousarray(x, np.float32))
              .to(self.device) for x in xs]
        return self._fn(*xs).float().cpu().numpy()[:b]

    def export(self, path: str) -> str:
        """Writes the classifier as a ``torch.export`` program at the fixed
        batch (the ONNX export's counterpart, module_wrapper.py:414-426);
        returns ``path``."""
        if self.scorer is None:
            raise ValueError("a classifier loaded from an exported program "
                             "cannot export again")
        args = tuple(torch.zeros(s, dtype=torch.float32, device=self.device)
                     for s in self._shapes())
        with torch.no_grad():
            program = torch.export.export(self.scorer, args, strict=False)
        torch.export.save(program, path)
        return path


def load_exported(path: str) -> nn.Module:
    """The callable module of a program :meth:`VideoActionClassifier.export`
    wrote: ``module(*pathway clips) -> scores``."""
    from ..ops import flash_attention, fused_dense, layer_norm  # noqa: F401

    return torch.export.load(path).module()
