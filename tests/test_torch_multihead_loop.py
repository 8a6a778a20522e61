"""The multi-dataset data, meter and loops of the port, on the CPU:
``Multi_dataset_seq`` items and order and ``MultiDatasetValMeter`` stats
equal to the JAX package's; the multi-dataset epoch driver (the JAX
``tests/test_engine_e2e.py::test_multidataset_epoch_driver``: a two-dataset
multi-head model trained two epochs, evaluated per dataset, then tested on
one dataset's head), with its TensorBoard scalars; and the writer's named
error where no TensorBoard package imports."""

import glob
import os
import sys

import numpy as np
import pytest

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.data import frame_datasets as jframe
from aicity_action_tpu.utils import meters as jmeters
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.data import frame_datasets as tframe
from aicity_action_tpu_torch.data.datasets import build_dataset
from aicity_action_tpu_torch.engine import test_loop as ttest_loop
from aicity_action_tpu_torch.engine.train_loop import train
from aicity_action_tpu_torch.utils import meters as tmeters
from aicity_action_tpu_torch.visualization import tensorboard_vis
from torch_port_helpers import write_mp4
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

NUM_VIDEOS = 8


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("multi")
    vdir = d / "videos"
    vdir.mkdir()
    for i in range(NUM_VIDEOS):
        write_mp4(str(vdir / f"v{i}.mp4"), num_frames=8, size=(32, 32),
                  seed=40 + i)
    for split in ("train", "val", "test"):
        with open(vdir / f"{split}.csv", "w") as f:
            for i in range(NUM_VIDEOS):
                f.write(f"v{i}.mp4 {i % 3}\n")
    return d


def _multi_cfg(get, workdir, out="out"):
    """The JAX e2e test's two-dataset multi-head run: kinetics (3 classes)
    and aicity (4, replicated twice in training) over the same 8 views,
    a depth-2 MViT-v2 of width 16 at crop 32, batch 8."""
    cfg = get()
    cfg.OUTPUT_DIR = str(workdir / out)
    vdir = str(workdir / "videos")
    cfg.DATA.PATH_TO_DATA_DIR = vdir
    cfg.DATA.PATH_PREFIX = vdir
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.SAMPLING_RATE = 2
    cfg.DATA.TRAIN_JITTER_SCALES = [32, 32]
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.TEST_CROP_SIZE = 32
    cfg.MODEL.MODEL_NAME = "MViT"
    cfg.MODEL.ARCH = "mvit"
    cfg.MODEL.NUM_CLASSES = 3
    cfg.MODEL.DROPOUT_RATE = 0.0
    m = cfg.MVIT
    m.EMBED_DIM = 16
    m.DEPTH = 2
    m.PATCH_KERNEL = (3, 7, 7)
    m.PATCH_STRIDE = (2, 4, 4)
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
    cfg.TRAIN.DATASET = "multi_dataset_seq"
    cfg.TEST.DATASET = "kinetics"
    cfg.TRAIN.BATCH_SIZE = 8
    cfg.TEST.BATCH_SIZE = 8
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    cfg.TEST.NUM_SPATIAL_CROPS = 1
    cfg.SOLVER.MAX_EPOCH = 2
    cfg.SOLVER.BASE_LR = 0.001
    cfg.SOLVER.WARMUP_EPOCHS = 0.0
    cfg.SOLVER.OPTIMIZING_METHOD = "adamw"
    cfg.TRAIN.EVAL_PERIOD = 1
    cfg.TRAIN.CHECKPOINT_PERIOD = 10
    cfg.DATA_LOADER.NUM_WORKERS = 2
    cfg.LOG_CFG = False
    cfg.MIXUP.ENABLE = False
    cfg.MODEL.USE_MULTI_HEAD = True
    cfg.MODEL.MULTI_DATASETS = ["kinetics", "aicity"]
    cfg.MODEL.MULTI_REPLICAS = [1, 2]
    cfg.MODEL.MULTI_NUM_CLASSES = [3, 4]
    cfg.MODEL.MULTI_LOSS_FUNCS = ["soft_cross_entropy", "soft_cross_entropy"]
    cfg.MODEL.MULTI_HEAD_ACT = ["softmax", "softmax"]
    cfg.MODEL.MULTI_LOSS_WEIGHTS = [1.0, 1.0]
    cfg.MODEL.MULTI_PATH_TO_DATA_DIR = [vdir] * 2
    cfg.MODEL.MULTI_PATH_PREFIX = [vdir] * 2
    return cfg


def test_multi_dataset_seq_matches_jax(workdir):
    """The training order (kinetics once, aicity twice) and every val item:
    clip, label one-hot in the 4-class space, index, ``dataset_idx``."""
    jcfg, cfg = _multi_cfg(jax_get_cfg, workdir), _multi_cfg(get_cfg, workdir)
    got = build_dataset("multi_dataset_seq", cfg, "train")
    want = jframe.MultiDatasetSeq(jcfg, "train")
    assert type(got) is tframe.MultiDatasetSeq
    assert got._index_map == want._index_map and len(got) == 24
    got = tframe.MultiDatasetSeq(cfg, "val")
    want = jframe.MultiDatasetSeq(jcfg, "val")
    assert len(got) == len(want) == 16
    for i in (0, 5, 8, 15):
        (gx,), gy, gi, gm = got[i]
        (wx,), wy, wi, wm = want[i]
        np.testing.assert_allclose(gx, wx, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(gy, wy)
        assert gy.shape == (4,) and gi == wi == i
        assert gm == wm == {"dataset_idx": i // 8}


def test_multi_dataset_meter_matches_jax():
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.MODEL.MULTI_DATASETS = ["kinetics", "mmit", "activitynet"]
        c.MODEL.MULTI_NUM_CLASSES = [6, 5, 4]
    rng = np.random.default_rng(2)
    got, want = tmeters.MultiDatasetValMeter(2, cfg), \
        jmeters.MultiDatasetValMeter(2, jcfg)
    for _ in range(2):
        preds = {ds: rng.random((7, n)).astype(np.float32)
                 for ds, n in zip(cfg.MODEL.MULTI_DATASETS, [6, 5, 4])}
        labels = (rng.random((7, 6)) < 0.3).astype(np.float32)
        idx = rng.integers(0, 2, 7)  # activitynet never comes
        got.update_stats(preds, labels, idx)
        want.update_stats(preds, labels, idx)
    assert got.log_epoch_stats(0) == want.log_epoch_stats(0)


def test_multidataset_epoch_driver(workdir):
    """24 training items at batch 8: 3 steps an epoch over 2 epochs, an
    eval per epoch with each dataset's top-k, the TensorBoard scalars of
    every step, then the test on the kinetics head."""
    cfg = _multi_cfg(get_cfg, workdir)
    cfg.TENSORBOARD.ENABLE = True
    run = train(cfg, device="cpu")
    assert run.optimizer.count == 6
    assert [len(e["losses"]) for e in run.epochs] == [3, 3]
    assert all(np.isfinite(e["losses"]).all() for e in run.epochs)
    val = run.epochs[-1]["val"]
    assert set(val["dataset_topk"]) == {"kinetics", "aicity"}
    assert val["clips"] == 16 and val["forwards"] == 2
    events = glob.glob(os.path.join(cfg.OUTPUT_DIR,
                                    "runs-multi_dataset_seq", "events.*"))
    assert len(events) == 1
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    acc = EventAccumulator(events[0])
    acc.Reload()
    assert [e.step for e in acc.Scalars("Train/loss")] == list(range(6))
    cfg.TRAIN.ENABLE = False
    stats = ttest_loop.test(cfg, device="cpu")
    assert "top1_acc" in stats and stats["clips"] == 16


def test_tensorboard_writer_names_both_packages(workdir, tmp_path,
                                                monkeypatch):
    """Where neither package imports, the writer warns once, naming both,
    and drops what it is given (the JAX writer's behaviour): no event
    file, and the run is not stopped."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    warned = []
    monkeypatch.setattr(tensorboard_vis.logger, "warning",
                        lambda msg, *args: warned.append(msg % args))
    cfg = _multi_cfg(get_cfg, workdir)
    cfg.TENSORBOARD.LOG_DIR = str(tmp_path / "tb")
    w = tensorboard_vis.TensorboardWriter(cfg)
    assert w.writer is None
    assert len(warned) == 1
    assert "tensorboardX" in warned[0]
    assert "torch.utils.tensorboard" in warned[0]
    w.add_scalars({"Train/loss": 1.0}, 0)
    w.plot_eval(np.eye(3), np.arange(3), 0)
    w.close()
    assert not glob.glob(os.path.join(w.log_dir, "events.*"))
