"""TensorBoard writer (port of ``aicity_action_tpu/visualization/
tensorboard_vis.py``: the interface of the module the reference imports
but does not ship, recovered from its call sites: ``TensorboardWriter(cfg)``,
``add_scalars(dict, step)``, ``plot_eval(preds, labels, step)``,
``close()``).

Where neither ``torch.utils.tensorboard`` nor ``tensorboardX`` imports,
the writer warns once, naming both packages, and drops what it is given,
as the JAX writer does: a run with ``TENSORBOARD.ENABLE`` trains on.
matplotlib (the confusion matrix of :meth:`plot_eval`) is imported where
it is drawn.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils.logging import get_logger

logger = get_logger(__name__)


def _summary_writer_class():
    """``SummaryWriter`` of ``torch.utils.tensorboard``, else of
    ``tensorboardX``; None, with a warning naming both, where neither
    imports."""
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter
    except ImportError as first:
        try:
            from tensorboardX import SummaryWriter
            return SummaryWriter
        except ImportError:
            logger.warning(
                "TENSORBOARD.ENABLE: neither torch.utils.tensorboard (the "
                "tensorboard package) nor tensorboardX imports (%s); "
                "scalars will be dropped", first)
            return None


class TensorboardWriter:
    """Scalars (and the eval's confusion matrix) into an event file under
    ``TENSORBOARD.LOG_DIR``, or ``OUTPUT_DIR/runs-{TRAIN.DATASET}``;
    ``writer`` is None, and every call a no-op, where no TensorBoard
    package imports."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.log_dir = cfg.TENSORBOARD.LOG_DIR or os.path.join(
            cfg.OUTPUT_DIR, f"runs-{cfg.TRAIN.DATASET}")
        summary_writer = _summary_writer_class()
        self.writer = (None if summary_writer is None
                       else summary_writer(log_dir=self.log_dir))
        self.class_names = None
        if cfg.TENSORBOARD.CLASS_NAMES_PATH:
            with open(cfg.TENSORBOARD.CLASS_NAMES_PATH) as f:
                self.class_names = list(json.load(f).keys())
        logger.info("Tensorboard logging to %s", self.log_dir)

    def add_scalars(self, data_dict: dict, global_step: int | None = None):
        if self.writer is None:
            return
        for key, item in data_dict.items():
            self.writer.add_scalar(key, float(item), global_step)

    def plot_eval(self, preds, labels, global_step: int | None = None):
        """The top-1 confusion matrix of ``preds [N, classes]`` against int
        ``labels`` as a figure, where ``TENSORBOARD.CONFUSION_MATRIX.
        ENABLE``."""
        preds = np.asarray(preds)
        if self.writer is None or not (
                self.cfg.TENSORBOARD.CONFUSION_MATRIX.ENABLE
                and preds.ndim == 2):
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        n = preds.shape[1]
        cm = np.zeros((n, n), np.int64)
        for t, p in zip(np.asarray(labels).astype(int), preds.argmax(1)):
            cm[t, p] += 1
        fig, ax = plt.subplots(
            figsize=self.cfg.TENSORBOARD.CONFUSION_MATRIX.FIGSIZE)
        ax.imshow(cm, cmap="Blues")
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        self.writer.add_figure("confusion_matrix", fig,
                               global_step=global_step)
        plt.close(fig)

    def add_video(self, tensor, tag="video", global_step=None, fps=4):
        if self.writer is not None:
            self.writer.add_video(tag, tensor, global_step=global_step,
                                  fps=fps)

    def flush(self):
        if self.writer is not None:
            self.writer.flush()

    def close(self):
        if self.writer is not None:
            self.writer.flush()
            self.writer.close()
