"""The port's TensorBoard writer against the JAX package's where no
TensorBoard package imports: both warn and drop the scalars, so a run with
``TENSORBOARD.ENABLE`` trains on (the JAX writer's
``aicity_action_tpu/visualization/tensorboard_vis.py`` behaviour)."""

import sys

import numpy as np
import pytest

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.visualization import tensorboard_vis as jtb
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.visualization import tensorboard_vis as ttb
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("hidden", [("torch.utils.tensorboard",
                                     "tensorboardX")])
def test_writer_drops_scalars_like_the_jax_writer(hidden, tmp_path,
                                                  monkeypatch):
    for name in hidden:
        monkeypatch.setitem(sys.modules, name, None)
    writers = []
    for get, module in ((jax_get_cfg, jtb), (get_cfg, ttb)):
        cfg = get()
        cfg.OUTPUT_DIR = str(tmp_path / module.__name__)
        cfg.TENSORBOARD.ENABLE = True
        cfg.TENSORBOARD.CONFUSION_MATRIX.ENABLE = True
        w = module.TensorboardWriter(cfg)
        w.add_scalars({"Train/loss": 1.5, "Train/lr": 0.1}, 3)
        w.plot_eval(np.eye(4), np.arange(4), 3)
        w.close()
        writers.append(w)
    assert [w.writer for w in writers] == [None, None]
    assert not any((tmp_path / d).exists() and any((tmp_path / d).rglob(
        "events.*")) for d in (jtb.__name__, ttb.__name__))
