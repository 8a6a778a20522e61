"""The port's training loop as a whole against the JAX package's, on the
CPU: ``train`` (one epoch of two steps, a checkpoint, an eval) and the
multi-view ``test``, each package from the same ``.pyth`` written by the
port, on the same csv of videos written in code; then auto-resume and the
asynchronous checkpoint writer (port only) and ``run_net``'s device rule.

The config is the JAX package's ``tests/test_engine_e2e.py:_tiny_cfg``
pattern: a v2 MViT of embed 16 and depth 2, f32, SGD, with DropPath,
dropout and mixup off. The views are 32x32 and exactly one clip long
(4 frames at stride 2 of 30 fps), the scale jitter is [32, 32] and the
crop 32, with no flip, so a train draw has one outcome in both packages
(the JAX dataset draws train clips from an unseeded ``random.Random()``).
The JAX loops run on a one-device mesh. Tolerances (f32, sums in other
orders): losses rtol 1e-4, parameters rtol 1e-4 / atol 1e-5, the val and
test top-1 / top-5 errors equal.
"""

import glob
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.engine import test_loop as jtest_loop
from aicity_action_tpu.engine import train_loop as jtrain_loop
from aicity_action_tpu.parallel.mesh import make_mesh
from aicity_action_tpu.utils import meters as jmeters
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.engine import test_loop as ttest_loop
from aicity_action_tpu_torch.engine import train_loop as ttrain_loop
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.tools import run_net
from aicity_action_tpu_torch.utils import checkpoint as tcu
from aicity_action_tpu_torch.utils.convert import jax_tree_to_named
from torch_port_helpers import write_mp4
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

NUM_VIDEOS, NUM_CLASSES = 8, 4
CLIP_FRAMES = 8  # SAMPLING_RATE x NUM_FRAMES at TARGET_FPS == fps


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Eight 32x32 views of one clip each, the three csvs, and a ``.pyth``
    of the port's tiny model drawn from seed 3."""
    d = tmp_path_factory.mktemp("loop")
    vdir = d / "videos"
    vdir.mkdir()
    for i in range(NUM_VIDEOS):
        write_mp4(str(vdir / f"v{i}.mp4"), num_frames=CLIP_FRAMES,
                  size=(32, 32), seed=20 + i)
    for split in ("train", "val", "test"):
        with open(vdir / f"{split}.csv", "w") as f:
            for i in range(NUM_VIDEOS):
                f.write(f"v{i}.mp4 {i % NUM_CLASSES}\n")
    model = build_model(_tiny_cfg(get_cfg, d, "unused"), device="cpu",
                        seed=3)
    torch.save({"model_state": model.state_dict(), "epoch": 0},
               str(d / "init.pyth"))
    return d


def _tiny_cfg(get, workdir, out):
    cfg = get()
    cfg.OUTPUT_DIR = str(workdir / out)
    cfg.DATA.PATH_TO_DATA_DIR = str(workdir / "videos")
    cfg.DATA.PATH_PREFIX = str(workdir / "videos")
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.SAMPLING_RATE = 2
    cfg.DATA.TRAIN_JITTER_SCALES = [32, 32]
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.RANDOM_FLIP = False
    cfg.MODEL.MODEL_NAME = "MViT"
    cfg.MODEL.ARCH = "mvit"
    cfg.MODEL.NUM_CLASSES = NUM_CLASSES
    cfg.MODEL.LOSS_FUNC = "cross_entropy"
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
    cfg.TRAIN.DATASET = "aicity"
    cfg.TEST.DATASET = "aicity"
    cfg.TRAIN.BATCH_SIZE = 4
    cfg.TEST.BATCH_SIZE = 8
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    cfg.TEST.NUM_SPATIAL_CROPS = 1
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.SOLVER.BASE_LR = 0.5
    cfg.SOLVER.WARMUP_EPOCHS = 0.0
    cfg.SOLVER.COSINE_END_LR = 0.0
    cfg.SOLVER.OPTIMIZING_METHOD = "sgd"
    cfg.SOLVER.MOMENTUM = 0.9
    cfg.SOLVER.ZERO_WD_1D_PARAM = True
    cfg.SOLVER.CLIP_GRAD_L2NORM = 1.0
    cfg.TRAIN.EVAL_PERIOD = 1
    cfg.TRAIN.CHECKPOINT_PERIOD = 1
    cfg.TRAIN.CHECKPOINT_FILE_PATH = str(workdir / "init.pyth")
    cfg.TRAIN.CHECKPOINT_TYPE = "pytorch"
    cfg.DATA_LOADER.NUM_WORKERS = 2
    cfg.LOG_CFG = False
    cfg.MIXUP.ENABLE = False
    return cfg


def _checkpoint_names(out):
    return sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(out, "checkpoints", "checkpoint_epoch_*"))
        if not p.endswith(".tmp"))


@pytest.fixture(scope="module")
def jax_run(workdir):
    """The JAX package's train + test on a one-device mesh, with the
    per-step losses and the val stats its meters saw."""
    losses, val = [], []
    mp = pytest.MonkeyPatch()
    one = lambda cfg: make_mesh(cfg, devices=jax.devices()[:1])  # noqa: E731
    mp.setattr(jtrain_loop, "make_mesh", one)
    mp.setattr(jtest_loop, "make_mesh", one)
    update = jmeters.TrainMeter.update_stats
    log_val = jmeters.ValMeter.log_epoch_stats

    def record_update(self, top1, top5, loss, lr, mb):
        losses.append(loss)
        return update(self, top1, top5, loss, lr, mb)

    def record_val(self, cur_epoch):
        val.append(log_val(self, cur_epoch))
        return val[-1]

    mp.setattr(jmeters.TrainMeter, "update_stats", record_update)
    mp.setattr(jmeters.ValMeter, "log_epoch_stats", record_val)
    try:
        cfg = _tiny_cfg(jax_get_cfg, workdir, "jax")
        state = jtrain_loop.train(cfg)
        stats = jtest_loop.test(cfg)
    finally:
        mp.undo()
    params = jax_tree_to_named(jax.tree_util.tree_map(np.asarray,
                                                      state.params))
    return dict(losses=losses, val=val, params=params, test=stats,
                step=int(np.asarray(state.step)), out=cfg.OUTPUT_DIR)


@pytest.fixture(scope="module")
def port_run(workdir):
    cfg = _tiny_cfg(get_cfg, workdir, "port")
    run = ttrain_loop.train(cfg, device="cpu")
    return dict(run=run, test=ttest_loop.test(cfg, device="cpu"),
                out=cfg.OUTPUT_DIR)


def test_train_losses_and_params_match_jax(jax_run, port_run):
    run = port_run["run"]
    assert run.start_epoch == 0 and len(run.epochs) == 1
    assert len(jax_run["losses"]) == 2
    np.testing.assert_allclose(run.epochs[0]["losses"], jax_run["losses"],
                               rtol=1e-4)
    assert run.optimizer.count == jax_run["step"] == 2
    named = dict(run.model.named_parameters())
    assert set(named) == set(jax_run["params"])
    init = torch.load(os.path.join(os.path.dirname(port_run["out"]),
                                   "init.pyth"))["model_state"]
    moved = max((named[k].detach() - init[k]).abs().max().item()
                for k in named)
    assert moved > 1e-2  # the two steps moved the weights
    for name, p in jax_run["params"].items():
        np.testing.assert_allclose(named[name].detach().numpy(), p,
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_val_and_test_errors_match_jax(jax_run, port_run):
    (jval,) = jax_run["val"]
    tval = port_run["run"].epochs[0]["val"]
    for k in ("top1_err", "top5_err"):
        assert tval[k] == jval[k], k
    assert tval["forwards"] == 2 and tval["clips"] == NUM_VIDEOS
    for k in ("top1_acc", "top5_acc"):
        assert port_run["test"][k] == jax_run["test"][k], k
    assert port_run["test"]["clips"] == NUM_VIDEOS * 2


def test_checkpoint_names_and_epochs_match_jax(jax_run, port_run):
    names = _checkpoint_names(port_run["out"])
    assert names == _checkpoint_names(jax_run["out"]) == [
        "checkpoint_epoch_00001"]
    ckpt = torch.load(os.path.join(port_run["out"], "checkpoints", names[0]),
                      weights_only=True)
    assert ckpt["epoch"] == 1 and ckpt["step"] == 2
    assert os.path.exists(os.path.join(port_run["out"], "checkpoints",
                                       "config.yaml"))


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_two_epochs_equal_one_plus_an_auto_resumed_one(workdir, async_ckpt):
    """A run of two epochs, and a run that auto-resumes from the first
    run's epoch-1 checkpoint alone (as after a job stopped there): the
    resumed epoch leaves the same parameters, optimizer state and losses.
    One of the two cases writes its checkpoints on the writer thread."""
    cfg = _tiny_cfg(get_cfg, workdir, f"two_{async_ckpt}")
    cfg.SOLVER.MAX_EPOCH = 2
    cfg.TRAIN.EVAL_PERIOD = 2
    cfg.TPU.ASYNC_CHECKPOINT = async_ckpt
    whole = ttrain_loop.train(cfg, device="cpu")
    assert tcu._writer.thread is None
    assert _checkpoint_names(cfg.OUTPUT_DIR) == [
        "checkpoint_epoch_00001", "checkpoint_epoch_00002"]

    out = workdir / f"resumed_{async_ckpt}"
    os.makedirs(out / "checkpoints")
    shutil.copy(os.path.join(cfg.OUTPUT_DIR, "checkpoints",
                             "checkpoint_epoch_00001"), out / "checkpoints")
    cfg.OUTPUT_DIR = str(out)
    resumed = ttrain_loop.train(cfg, device="cpu")

    assert resumed.start_epoch == 1 and len(resumed.epochs) == 1
    assert resumed.optimizer.count == whole.optimizer.count == 4
    assert resumed.epochs[0]["losses"] == whole.epochs[1]["losses"]
    assert resumed.epochs[0]["val"]["top1_err"] == \
        whole.epochs[1]["val"]["top1_err"]
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa = whole.optimizer.opt.state_dict()["state"]
    sb = resumed.optimizer.opt.state_dict()["state"]
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[i]["momentum_buffer"],
                           sb[i]["momentum_buffer"]) for i in sa)
    assert _checkpoint_names(out) == [
        "checkpoint_epoch_00001", "checkpoint_epoch_00002"]


def test_profile_dir_traces_the_chosen_steps(workdir):
    """``TPU.PROFILE_DIR``: ``torch.profiler`` over the steps from
    ``PROFILE_START_STEP`` to ``PROFILE_START_STEP + PROFILE_NUM_STEPS``,
    as the JAX loop's trace."""
    cfg = _tiny_cfg(get_cfg, workdir, "profiled")
    cfg.TPU.PROFILE_DIR = str(workdir / "profile")
    cfg.TPU.PROFILE_START_STEP = 0
    cfg.TPU.PROFILE_NUM_STEPS = 1
    cfg.TRAIN.CHECKPOINT_PERIOD = 5
    cfg.TRAIN.EVAL_PERIOD = 5
    cfg.SOLVER.MAX_EPOCH = 1
    ttrain_loop.train(cfg, device="cpu")
    (trace,) = os.listdir(cfg.TPU.PROFILE_DIR)
    assert trace == "train_steps_0_1.json"
    with open(os.path.join(cfg.TPU.PROFILE_DIR, trace)) as f:
        assert "traceEvents" in f.read()


def test_async_write_error_raises_at_the_next_drain(workdir, monkeypatch):
    model = build_model(_tiny_cfg(get_cfg, workdir, "x"), device="cpu")
    from aicity_action_tpu_torch.solver.optimizer import construct_optimizer

    opt = construct_optimizer(_tiny_cfg(get_cfg, workdir, "x"), model, 2)

    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", fail)
    tcu.save_checkpoint(str(workdir / "fail"), model, opt, 0,
                        async_write=True)
    with pytest.raises(OSError, match="disk full"):
        tcu.wait_for_pending_saves()
    tcu.wait_for_pending_saves()  # the error is raised once


def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu(
        workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_cfg(get_cfg, workdir, "nocard")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_net.main(["--cfg", "configs/AICITY_MVITV2_B_16x4_448.yaml"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain_loop.train(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttest_loop.test(cfg)
    assert not os.path.exists(cfg.OUTPUT_DIR)
