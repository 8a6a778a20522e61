"""The port's AVA stack against the JAX package, on the CPU, on a small AVA
tree written in code (``data/ava.py:write_synthetic_ava``: two videos of
JPEG frames, five keyframes): ``Ava`` items (val and test exactly equal;
train items equal under the same draw), ``evaluate_ava`` and the
``AVAMeter`` (1e-9), a detection ``run_net`` (train, eval, test) whose test
mAP equals the JAX meter's over the same model's scores of the JAX
package's test items, and the test mAP of two gloo ranks equal to one
process's (the ranks' slabs gathered once, the last batch's padded rows
dropped).
"""

import os
import random

import numpy as np
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.data import ava as jax_ava
from aicity_action_tpu.evaluation import ava_eval as jax_eval
from aicity_action_tpu.utils.meters import AVAMeter as JaxAVAMeter
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.data import ava as tava
from aicity_action_tpu_torch.evaluation import ava_eval as teval
from aicity_action_tpu_torch.utils.meters import AVAMeter
from test_torch_convnets import tiny_conv_cfg
from torch_port_helpers import WORLD, collect_ranks, start_ranks
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

cv2 = pytest.importorskip("cv2")

SECS = {"vidA": [902, 903, 904], "vidB": [902, 903]}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tava.write_synthetic_ava(
        str(tmp_path_factory.mktemp("ava")), secs=SECS, num_frames=130,
        hw=(64, 80), seed=0)


def ava_cfg(get, tree, out_dir=""):
    """The tiny Slow ResNet of the conv tests with the RoI head on the
    tree: 8 frames at rate 2, crop 64, 80 classes, sigmoid, BCE; train
    batch 2, test batch 4 (five keyframes: the last batch is padded)."""
    cfg = tiny_conv_cfg(get, "ResNet", "slow")
    cfg.DETECTION.ENABLE = True
    cfg.DETECTION.SPATIAL_SCALE_FACTOR = 32
    cfg.MODEL.NUM_CLASSES = 80
    cfg.MODEL.HEAD_ACT = "sigmoid"
    cfg.MODEL.LOSS_FUNC = "bce"
    cfg.DATA.SAMPLING_RATE = 2
    cfg.DATA.TRAIN_JITTER_SCALES = [64, 72]
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "ava"
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.TEST.BATCH_SIZE = 4
    cfg.AVA.DETECTION_SCORE_THRESH = 0.9
    for k, v in tree.items():
        setattr(cfg.AVA, k, v)
    cfg.NUM_GPUS = 1
    cfg.DATA_LOADER.NUM_WORKERS = 1
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.SOLVER.OPTIMIZING_METHOD = "sgd"
    cfg.SOLVER.BASE_LR = 0.1
    cfg.TRAIN.CHECKPOINT_PERIOD = 1
    cfg.TRAIN.EVAL_PERIOD = 1
    cfg.OUTPUT_DIR = out_dir
    return cfg


@pytest.fixture(scope="module")
def two_ranks(tree, tmp_path_factory):
    """Started first, so that the gloo ranks overlap the JAX work: the test
    of a seed-0 model (no training) on two ranks."""
    cfg = ava_cfg(get_cfg, tree, str(tmp_path_factory.mktemp("ranks_out")))
    cfg.TRAIN.ENABLE = False
    cfg.NUM_GPUS = WORLD  # each rank loads its half of a batch
    handle = start_ranks({"kind": "loop", "runs": [("ava", cfg)],
                          "loaders": []},
                         tmp_path_factory.mktemp("ava_ranks"))
    yield handle, cfg
    handle[0].kill()


def _assert_items_equal(got, want):
    (gx, gl, gi, gm), (wx, wl, wi, wm) = got, want
    assert len(gx) == len(wx) and gi == wi
    for a, b in zip(gx, wx):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gl, wl)
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_array_equal(gm[k], wm[k], err_msg=k)


@pytest.mark.parametrize("mode", ["val", "test"])
def test_val_and_test_items_equal_jax(two_ranks, tree, mode):
    ds = tava.Ava(ava_cfg(get_cfg, tree), mode)
    ref = jax_ava.Ava(ava_cfg(jax_get_cfg, tree), mode)
    assert len(ds) == len(ref) == 5
    assert ds.video_idx_to_name == ref.video_idx_to_name
    for i in range(len(ds)):
        _assert_items_equal(ds[i], ref[i])


def test_train_items_equal_jax_under_the_same_draw(tree, monkeypatch):
    """The JAX package draws a train item from an unseeded
    ``random.Random()``; given the port's draw for (seed, epoch, index) it
    makes the same item. The port's draws repeat and move with the
    epoch."""
    cfg = ava_cfg(get_cfg, tree)
    cfg.DATA.RANDOM_FLIP = True
    ds = tava.Ava(cfg, "train")
    jcfg = ava_cfg(jax_get_cfg, tree)
    jcfg.DATA.RANDOM_FLIP = True
    ref = jax_ava.Ava(jcfg, "train")
    real = random.Random
    for epoch in (0, 3):
        ds.set_epoch(epoch)
        for i in range(len(ds)):
            state = ds._rng(i).getstate()

            def seeded(*args, _state=state):
                if args:
                    return real(*args)
                r = real()
                r.setstate(_state)
                return r

            monkeypatch.setattr(random, "Random", seeded)
            want = ref[i]
            monkeypatch.setattr(random, "Random", real)
            _assert_items_equal(ds[i], want)
    ds.set_epoch(0)
    first = ds[0][3]["boxes"]
    np.testing.assert_array_equal(ds[0][3]["boxes"], first)


def _random_detections(seed, n=40):
    rng = np.random.default_rng(seed)
    preds = rng.uniform(size=(n, 80)).astype(np.float32)
    xy = rng.uniform(0, 0.5, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.2, 0.5, (n, 2))], 1)
    meta = np.stack([rng.integers(0, 2, n), rng.choice([902, 903, 904], n)],
                    1).astype(np.float32)
    return preds, boxes.astype(np.float32), meta


def test_evaluate_ava_and_meter_match_jax(tree):
    """Random scored boxes against the tree's ground truth, exclusions and
    label map: ``evaluate_ava`` and the meters' mAP within 1e-9."""
    anno = tree["ANNOTATION_DIR"]
    _, classes = teval.read_labelmap(os.path.join(anno, "labelmap.pbtxt"))
    assert classes == jax_eval.read_labelmap(
        os.path.join(anno, "labelmap.pbtxt"))[1]
    gt_file = os.path.join(anno, "val_gt.csv")
    excl = teval.read_exclusions(os.path.join(anno, "exclusions.csv"))
    assert excl == jax_eval.read_exclusions(
        os.path.join(anno, "exclusions.csv"))
    preds, boxes, meta = _random_detections(1)
    full = np.concatenate([np.zeros((len(boxes), 1), np.float32), boxes], 1)
    names = list(SECS)
    got = teval.evaluate_ava(preds, full, meta, excl, classes,
                             teval.read_csv(gt_file, classes), names)
    want = jax_eval.evaluate_ava(preds, full, meta, excl, classes,
                                 jax_eval.read_csv(gt_file, classes), names)
    assert 0.0 < got < 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)

    maps = []
    for meter_cls, get in ((AVAMeter, get_cfg), (JaxAVAMeter, jax_get_cfg)):
        meter = meter_cls(1, ava_cfg(get, tree), "test")
        meter.video_idx_to_name = names
        for part in np.array_split(np.arange(len(preds)), 3):
            meter.update_stats(preds[part], boxes[part], meta[part])
        maps.append(meter.finalize_metrics(log=False))
    np.testing.assert_allclose(maps[0], maps[1], rtol=0, atol=1e-9)


def _jax_meter_map(cfg, jcfg, model):
    """The JAX package's AVAMeter over ``model``'s scores of the JAX
    package's test items: its eval's masking and normalization."""
    from aicity_action_tpu_torch.engine.detection import \
        make_detection_eval_step

    ds = jax_ava.Ava(jcfg, "test")
    meter = JaxAVAMeter(1, jcfg, "test")
    meter.video_idx_to_name = ds.video_idx_to_name
    step = make_detection_eval_step(model)
    for i in range(len(ds)):
        inputs, _, _, meta = ds[i]
        preds = step({"inputs": [torch.from_numpy(x[None]) for x in inputs],
                      "boxes": torch.from_numpy(meta["boxes"][None])})
        keep = meta["box_mask"].astype(bool)
        h, w = meta["orig_hw"]
        meter.update_stats(preds.numpy()[keep], meta["ori_boxes"][keep]
                           / np.asarray([w, h, w, h], np.float32),
                           meta["metadata"][keep])
    return meter.finalize_metrics(log=False)


def test_detection_run_net_trains_evaluates_and_tests(tree, tmp_path):
    """``run_net`` on the AVA tree: one epoch (2 steps), precise BN over 2
    batches, its eval's frame mAP, a checkpoint, and the test's mAP equal
    to the JAX meter's over the trained model's scores."""
    from aicity_action_tpu_torch.tools import run_net

    cfg = ava_cfg(get_cfg, tree, str(tmp_path / "out"))
    cfg.BN.USE_PRECISE_STATS = True  # its forwards take the boxes too
    cfg.BN.NUM_BATCHES_PRECISE = 2
    path = str(tmp_path / "ava.yaml")
    with open(path, "w") as f:
        f.write(cfg.dump())
    out = run_net.main(["--cfg", path, "--device", "cpu"])
    run = out["train"]
    (epoch,) = run.epochs
    assert len(epoch["losses"]) == 2 and np.isfinite(epoch["losses"]).all()
    assert epoch["precise_bn_batches"] == 2
    assert 0.0 <= epoch["val"]["map"] <= 1.0
    # val batches are of TRAIN.BATCH_SIZE (2): the last one padded
    assert epoch["val"]["clips"] == 5 and epoch["val"]["forwards"] == 3
    assert os.path.exists(tmp_path / "out" / "checkpoints" /
                          "checkpoint_epoch_00001")
    test = out["test"]
    assert test["clips"] == 5
    want = _jax_meter_map(cfg, ava_cfg(jax_get_cfg, tree),
                          run.model.eval())
    np.testing.assert_allclose(test["map"], want, rtol=0, atol=1e-9)


def test_two_ranks_test_map_equals_one_process(two_ranks):
    from aicity_action_tpu_torch.engine.test_loop import test

    handle, cfg = two_ranks
    cfg = cfg.clone()
    cfg.NUM_GPUS = 1
    want = test(cfg, device="cpu")
    ranks = collect_ranks(handle)
    for r in ranks:
        got = r["runs"]["ava"]["test"]
        assert got["clips"] == want["clips"] == 5
        np.testing.assert_allclose(got["map"], want["map"], rtol=0,
                                   atol=1e-9)
