"""Multigrid in the port (``utils/multigrid.py``, the long-cycle branch of
``engine/train_loop.py``) against the JAX package: the schedules and the
solver settings they derive, each epoch's shape and BatchNorm kind, the
short-cycle crops, and a tiny SlowOnly run through ``run_net`` across
the long cycle's shape changes, which carries its weights."""

import numpy as np
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.utils import multigrid as jmg
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.utils import multigrid as tmg
from torch_port_helpers import write_mp4
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _schedule_cfg(get, long_cycle, short_cycle):
    cfg = get()
    cfg.TRAIN.BATCH_SIZE = 16
    cfg.NUM_GPUS = 2
    cfg.DATA.NUM_FRAMES = 16
    cfg.DATA.TRAIN_CROP_SIZE = 224
    cfg.DATA.SAMPLING_RATE = 4
    cfg.SOLVER.STEPS = [0, 44, 88, 118]
    cfg.SOLVER.MAX_EPOCH = 196
    cfg.SOLVER.GAMMA = 0.1
    cfg.MULTIGRID.LONG_CYCLE = long_cycle
    cfg.MULTIGRID.SHORT_CYCLE = short_cycle
    return cfg


def _epoch_state(cfg):
    return (cfg.TRAIN.BATCH_SIZE, cfg.DATA.NUM_FRAMES,
            cfg.DATA.TRAIN_CROP_SIZE, cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS,
            cfg.BN.NUM_SYNC_DEVICES, cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE)


@pytest.mark.parametrize("long_cycle,short_cycle",
                         [(True, False), (True, True), (False, True)])
def test_schedule_and_solver_settings_match_jax(long_cycle, short_cycle):
    got, want = (_schedule_cfg(g, long_cycle, short_cycle)
                 for g in (get_cfg, jax_get_cfg))
    ts, js = tmg.MultigridSchedule(), jmg.MultigridSchedule()
    got, want = ts.init_multigrid(got), js.init_multigrid(want)
    assert ts.schedule == js.schedule
    for key in ("STEPS", "LRS", "MAX_EPOCH"):
        assert getattr(got.SOLVER, key) == getattr(want.SOLVER, key), key
    assert got.MULTIGRID.DEFAULT_S == want.MULTIGRID.DEFAULT_S == 224
    if long_cycle:
        shapes = set()
        for epoch in range(got.SOLVER.MAX_EPOCH):
            got, changed = ts.update_long_cycle(got, epoch)
            want, jchanged = js.update_long_cycle(want, epoch)
            assert changed == jchanged, epoch
            assert _epoch_state(got) == _epoch_state(want), epoch
            shapes.add(_epoch_state(got)[:3])
            assert tmg.get_current_long_cycle_shape(ts.schedule, epoch) == \
                jmg.get_current_long_cycle_shape(js.schedule, epoch)
        assert len(shapes) >= 4
    for idx in range(6):
        assert tmg.short_cycle_crop_size(idx, got) == \
            jmg.short_cycle_crop_size(idx, want)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mgrid")
    vdir = d / "videos"
    vdir.mkdir()
    for i in range(16):
        write_mp4(str(vdir / f"v{i}.mp4"), num_frames=40 + 2 * i,
                  seed=i)
    for split in ("train", "val", "test"):
        with open(vdir / f"{split}.csv", "w") as f:
            for i in range(16):
                f.write(f"v{i}.mp4 {i % 3}\n")
    return d


def _run_cfg(get, infer, workdir):
    """The JAX driver test's config (``tests/test_multigrid_driver.py:
    _cfg``): a tiny SlowOnly R50 (8 channels a group), 4 frames at 32,
    batch 8, two long-cycle phases a step, (T/2, S) then (T, S). ``get``
    and ``infer`` are one package's ``get_cfg`` and
    ``assert_and_infer_cfg``."""
    cfg = get()
    cfg.OUTPUT_DIR = str(workdir / "out")
    cfg.DATA.PATH_TO_DATA_DIR = str(workdir / "videos")
    cfg.DATA.PATH_PREFIX = str(workdir / "videos")
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.SAMPLING_RATE = 2
    cfg.DATA.TRAIN_JITTER_SCALES = [40, 48]
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.INPUT_CHANNEL_NUM = [3]
    cfg.MODEL.MODEL_NAME = "ResNet"
    cfg.MODEL.ARCH = "slow"
    cfg.MODEL.NUM_CLASSES = 3
    cfg.MODEL.LOSS_FUNC = "cross_entropy"
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.RESNET.WIDTH_PER_GROUP = 8
    cfg.TRAIN.DATASET = "kinetics"
    cfg.TEST.DATASET = "kinetics"
    cfg.TRAIN.BATCH_SIZE = 8
    cfg.TEST.BATCH_SIZE = 8
    cfg.TRAIN.EVAL_PERIOD = 100
    cfg.TRAIN.CHECKPOINT_PERIOD = 100
    cfg.TRAIN.AUTO_RESUME = False
    cfg.SOLVER.MAX_EPOCH = 4
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.LR_POLICY = "steps_with_relative_lrs"
    cfg.SOLVER.STEPS = [0, 2, 4]
    cfg.SOLVER.LRS = [1.0, 0.1]
    cfg.SOLVER.GAMMA = 0.1
    cfg.SOLVER.WARMUP_EPOCHS = 0.0
    cfg.SOLVER.OPTIMIZING_METHOD = "sgd"
    cfg.SOLVER.MOMENTUM = 0.9
    cfg.MULTIGRID.LONG_CYCLE = True
    cfg.MULTIGRID.EPOCH_FACTOR = 1.0
    cfg.MULTIGRID.LONG_CYCLE_FACTORS = [[0.5, 1.0], [1.0, 1.0]]
    cfg.MULTIGRID.BN_BASE_SIZE = 4
    cfg.DATA_LOADER.NUM_WORKERS = 0
    cfg.MIXUP.ENABLE = False
    cfg.NUM_GPUS = 1
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return infer(cfg)


def test_long_cycle_run_changes_shape_and_keeps_training(workdir,
                                                         monkeypatch):
    """``run_net`` across the schedule: each epoch's batch and clip length
    follow the JAX schedule, the model is rebuilt at each shape change
    (sub-BatchNorm of 4 splits at batch 16, of 2 at batch 8) with the
    weights of the model before it, the step count runs on, and every loss
    is finite."""
    from aicity_action_tpu.config import assert_and_infer_cfg as jinfer
    from aicity_action_tpu_torch.config import assert_and_infer_cfg
    from aicity_action_tpu_torch.engine import train_loop
    from aicity_action_tpu_torch.tools import run_net

    jmg_sched = jmg.MultigridSchedule()
    jcfg = jmg_sched.init_multigrid(_run_cfg(jax_get_cfg, jinfer, workdir))
    jcfg, _ = jmg_sched.update_long_cycle(jcfg, 0)
    want = []  # the JAX schedule's shape changes after epoch 0
    for epoch in range(jcfg.SOLVER.MAX_EPOCH):
        jcfg, changed = jmg_sched.update_long_cycle(jcfg, epoch)
        if changed:
            want.append((jcfg.TRAIN.BATCH_SIZE, jcfg.DATA.NUM_FRAMES,
                         jcfg.BN.NORM_TYPE, jcfg.BN.NUM_SPLITS))
    rebuilds = []
    real = train_loop._long_cycle_rebuild

    def spy(cfg, old_model, old_optimizer, dev):
        before = {k: v.clone() for k, v in old_model.state_dict().items()}
        count = old_optimizer.count
        model, opt, loader = real(cfg, old_model, old_optimizer, dev)
        after = model.state_dict()
        kept = [k for k, v in before.items() if k in after
                and after[k].shape == v.shape and torch.equal(after[k], v)]
        rebuilds.append({"count": (count, opt.count),
                         "steps_cfg": list(cfg.SOLVER.STEPS),
                         "batch": loader.batch_size,
                         "frames": cfg.DATA.NUM_FRAMES,
                         "norm": (cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS),
                         "kept": len(kept),
                         "weights": sum(1 for k in before
                                        if not k.endswith(("running_mean",
                                                           "running_var")))})
        return model, opt, loader

    monkeypatch.setattr(train_loop, "_long_cycle_rebuild", spy)
    cfg = _run_cfg(get_cfg, assert_and_infer_cfg, workdir)
    cfg.TEST.ENABLE = False
    path = workdir / "slow_multigrid.yaml"
    path.write_text(cfg.dump())
    run = run_net.main(["--cfg", str(path), "--device", "cpu"])["train"]
    assert len(run.epochs) == jcfg.SOLVER.MAX_EPOCH
    assert rebuilds and all(rb["steps_cfg"] == jcfg.SOLVER.STEPS
                            for rb in rebuilds)
    losses = [x for e in run.epochs for x in e["losses"]]
    assert losses and np.isfinite(losses).all()
    for rb in rebuilds:
        assert rb["count"][0] == rb["count"][1] > 0
        assert rb["kept"] >= rb["weights"]  # every weight carried over
    assert [(rb["batch"], rb["frames"], *rb["norm"]) for rb in rebuilds] \
        == want
    assert {rb["frames"] for rb in rebuilds} == {2, 4}  # both shapes
    assert run.optimizer.count == sum(len(e["losses"]) for e in run.epochs)

