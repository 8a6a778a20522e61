"""The port's contrastive loop against the JAX package's, on the CPU in f32:
``tools/run_net_contrastive`` (one epoch with MoCo, an eval and a
checkpoint; then a second call that auto-resumes, momentum weights
included, trains epoch 2 and runs the retrieval test, which writes the
feature pickle) against the JAX ``train_contrastive`` over both epochs and
its ``test_contrastive``; two gloo ranks against one process on the same
global batch; and the text-query CLI on the feature pickle.

The config is the tiny one of ``tests/test_contrastive_loop.py:34-82``
(ActionCLIP with a depth-2 MViT-v2 of width 16 and a 2-layer text tower),
made deterministic as ``tests/test_torch_train_loop.py`` makes its loop:
views of exactly one clip (4 frames at stride 2 of 30 fps) at 32x32, scale
jitter [32, 32], crop 32, no flip, so a train draw has one outcome in both
packages (the JAX dataset draws train clips from an unseeded
``random.Random()``); plain SGD at a constant LR; the vocabulary is that of
a merges file written in code, and the captions' ids come from the port's
tokenizer. Both start from the port's draw from seed 0 (the JAX
``build_model`` is patched to take it). Tolerances: losses rtol 1e-4,
parameters and momentum weights rtol 1e-4 / atol 1e-5, recalls equal,
features atol 1e-5.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.engine import contrastive_loop as jloop
from aicity_action_tpu.models.build import build_module
from aicity_action_tpu.parallel.mesh import make_mesh
from aicity_action_tpu.utils import meters as jmeters
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.data.tokenizer import SimpleTokenizer, tokenize
from aicity_action_tpu_torch.engine import contrastive as tcon
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.pipeline.zeroshot import filter_query
from aicity_action_tpu_torch.solver.optimizer import TrainOptimizer
from aicity_action_tpu_torch.tools import (inference_videotext,
                                           run_net_contrastive)
from aicity_action_tpu_torch.utils.convert import jax_actionclip_tree_to_named
from torch_port_helpers import (clip_params_to_jax, collect_ranks,
                                start_ranks, tiny_clip_cfg, write_merges,
                                write_mp4)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-4, 1e-5
CAPTIONS = ["a person drinking", "the person texting on the phone",
            "eating in the car", "reaching and drinking", "hello world",
            "texting and eating", "a car", "the phone"]
CLIP_FRAMES = 8  # SAMPLING_RATE x NUM_FRAMES at TARGET_FPS == fps
VOCAB = 600  # covers the merges file's vocabulary (557 ids)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Eight 32x32 views of one clip, the merges file, and the three
    ``{split}_tokenized.csv`` of the captions (labels: 4 classes)."""
    d = tmp_path_factory.mktemp("clip_loop")
    vdir = d / "videos"
    vdir.mkdir()
    for i in range(len(CAPTIONS)):
        write_mp4(str(vdir / f"v{i}.mp4"), num_frames=CLIP_FRAMES,
                  size=(32, 32), seed=40 + i)
    merges = write_merges(d / "merges.txt")
    ids = tokenize(SimpleTokenizer(merges), CAPTIONS, 8)
    for split in ("train", "val", "test"):
        with open(vdir / f"{split}_tokenized.csv", "w") as f:
            for i, row in enumerate(ids):
                f.write(f"v{i}.mp4 {i % 4} "
                        f"{','.join(str(t) for t in row if t)}\n")
    return d


def _cfg(get, workdir, out, max_epoch=2):
    cfg = tiny_clip_cfg(get)
    cfg.OUTPUT_DIR = str(workdir / out)
    cfg.DATA.PATH_TO_DATA_DIR = str(workdir / "videos")
    cfg.DATA.PATH_PREFIX = str(workdir / "videos")
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.SAMPLING_RATE = 2
    cfg.DATA.TRAIN_JITTER_SCALES = [32, 32]
    cfg.DATA.RANDOM_FLIP = False
    cfg.CONTRA.vocab_size = VOCAB
    cfg.TRAIN.DATASET = "web_video_text"
    cfg.TEST.DATASET = "web_video_text"
    cfg.TRAIN.USE_MOCO = True
    cfg.TRAIN.MOCO_MOMENTUM = 0.9
    cfg.TRAIN.BATCH_SIZE = 4
    cfg.TEST.BATCH_SIZE = 6  # a short, padded last batch
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 1
    cfg.TEST.NUM_SPATIAL_CROPS = 1
    cfg.SOLVER.MAX_EPOCH = max_epoch
    cfg.SOLVER.BASE_LR = 0.5
    cfg.SOLVER.LR_POLICY = "steps_with_relative_lrs"
    cfg.SOLVER.STEPS = [0]
    cfg.SOLVER.LRS = [1.0]
    cfg.SOLVER.WARMUP_EPOCHS = 0.0
    cfg.SOLVER.OPTIMIZING_METHOD = "sgd"
    cfg.SOLVER.MOMENTUM = 0.9
    cfg.TRAIN.EVAL_PERIOD = 1
    cfg.TRAIN.CHECKPOINT_PERIOD = 1
    cfg.DATA_LOADER.NUM_WORKERS = 2
    cfg.LOG_CFG = False
    cfg.MIXUP.ENABLE = False
    cfg.NUM_GPUS = 1
    return cfg


@pytest.fixture(scope="module")
def ddp_ranks(workdir):
    """Two gloo ranks (started first: they run beside the JAX loop) of two
    MoCo steps on a global batch of 4 clips with one padded row."""
    cfg = _cfg(get_cfg, workdir, "unused")
    state = build_model(cfg, device="cpu", seed=5).state_dict()
    rng = np.random.default_rng(11)
    tokens = rng.integers(1, VOCAB - 1, (4, 8))
    tokens[:, 6] = VOCAB - 1
    tokens[:, 7] = 0
    batch = {"inputs": rng.standard_normal((4, 4, 32, 32, 3),
                                           dtype=np.float32),
             "tokens": tokens, "labels": np.asarray([0, 1, 0, 2]),
             "n_valid": 3}
    job = {"kind": "contrastive", "cfg": cfg, "state": state, "lr": 0.5,
           "steps": 2, "batch": batch}
    return job, start_ranks(job, workdir / "ddp")


@pytest.fixture(scope="module")
def jax_run(workdir, ddp_ranks):
    """The JAX package's two epochs and retrieval test on a one-device
    mesh from the port's seed-0 weights: per-step losses, the evals, the
    final state, the test stats and the feature pickle."""
    cfg = _cfg(jax_get_cfg, workdir, "jax")
    port = build_model(_cfg(get_cfg, workdir, "unused"), device="cpu")
    params = clip_params_to_jax(port.state_dict())
    losses, evals = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(jloop, "make_mesh",
               lambda cfg: make_mesh(cfg, devices=jax.devices()[:1]))
    mp.setattr(jloop, "build_model",
               lambda cfg: (build_module(cfg)[0], params))
    update = jmeters.TrainMeter.update_stats
    mp.setattr(jmeters.TrainMeter, "update_stats",
               lambda self, t1, t5, loss, lr, n: (losses.append(loss),
                                                  update(self, t1, t5, loss,
                                                         lr, n)))
    evaluate = jloop.eval_contrastive_epoch
    mp.setattr(jloop, "eval_contrastive_epoch",
               lambda *a: evals.append(evaluate(*a)) or evals[-1])
    try:
        state = jloop.train_contrastive(cfg)
        pkl = str(workdir / "jax_features.pkl")
        test = jloop.test_contrastive(cfg, pkl)
    finally:
        mp.undo()
    with open(pkl, "rb") as f:
        feats = pickle.load(f)
    return {"losses": losses, "evals": evals, "state": state, "test": test,
            "features": feats}


@pytest.fixture(scope="module")
def port_run(workdir):
    """``run_net_contrastive`` twice on the CPU: epoch 1, then an
    auto-resumed epoch 2 and the test, which writes the feature pickle."""
    cfg_path = str(workdir / "clip.yaml")
    with open(cfg_path, "w") as f:
        f.write(_cfg(get_cfg, workdir, "port").dump())
    pkl = str(workdir / "port_features.pkl")
    first = run_net_contrastive.main([
        "--cfg", cfg_path, "--device", "cpu", "SOLVER.MAX_EPOCH", "1",
        "TEST.ENABLE", "False"])
    second = run_net_contrastive.main([
        "--cfg", cfg_path, "--device", "cpu", "TEST.SAVE_RESULTS_PATH",
        pkl])
    with open(pkl, "rb") as f:
        feats = pickle.load(f)
    return {"first": first, "second": second, "features": feats,
            "cfg_path": cfg_path}


def _hold(tree, named_params):
    want = jax_actionclip_tree_to_named(
        jax.tree_util.tree_map(np.asarray, tree))
    got = dict(named_params)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_train_resume_and_test_match_jax(jax_run, port_run, workdir):
    first, second = port_run["first"]["train"], port_run["second"]["train"]
    assert first.start_epoch == 0 and second.start_epoch == 1
    assert len(first.epochs) == len(second.epochs) == 1
    got = first.epochs[0]["losses"] + second.epochs[0]["losses"]
    assert len(got) == 4 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, jax_run["losses"], rtol=RTOL)
    assert all(0.0 < s <= 100.0 for e in first.epochs + second.epochs
               for s in e["logit_scales"])
    # the evals: recall@1/5/10 both ways over the 8 val clips, equal
    for record, want in zip(first.epochs + second.epochs, jax_run["evals"]):
        stats = {k: v for k, v in record["val"].items()
                 if "recall" in k}
        assert stats == {k: v for k, v in want.items() if "recall" in k}
        assert record["val"]["clips"] == 8
    # resumed weights and momentum weights ran on: both end at JAX's
    _hold(jax_run["state"].params, second.model.named_parameters())
    _hold(jax_run["state"].ema_params,
          second.momentum_model.named_parameters())
    ckpt = torch.load(os.path.join(workdir, "port", "checkpoints",
                                   "checkpoint_epoch_00002"),
                      map_location="cpu", weights_only=True)
    assert set(ckpt["ema_state"]) == set(ckpt["model_state"])
    # the test: recalls equal, the pickle's features and ids
    test = port_run["second"]["test"]
    assert {k: v for k, v in test.items() if "recall" in k} == \
        {k: v for k, v in jax_run["test"].items() if "recall" in k}
    assert test["clips"] == 8 and test["forwards"] == 2
    (v, ids), (jv, jids) = port_run["features"], jax_run["features"]
    assert v.dtype == np.float32 and v.shape == (8, 16)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(v, jv, atol=ATOL, rtol=0)


def test_two_ranks_match_one_process(ddp_ranks):
    job, handle = ddp_ranks
    ranks = collect_ranks(handle)
    model = build_model(job["cfg"], device="cpu")
    model.load_state_dict(job["state"])
    momentum = tcon.make_momentum_model(model)
    opt = TrainOptimizer(torch.optim.SGD(model.parameters(), lr=job["lr"]),
                         lambda step: job["lr"])
    step = tcon.make_contrastive_train_step(
        model, opt, use_moco=True, moco_momentum=0.9,
        momentum_model=momentum)
    b = job["batch"]
    want = []
    for _ in range(job["steps"]):
        metrics, _ = step({"inputs": torch.from_numpy(b["inputs"]),
                           "tokens": torch.from_numpy(b["tokens"]),
                           "labels": torch.from_numpy(b["labels"]),
                           "n_valid": b["n_valid"]})
        want.append(float(metrics["loss"]))
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want, rtol=RTOL)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(r["params"][name],
                                       p.detach().numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=name)
        for name, p in momentum.named_parameters():
            np.testing.assert_allclose(r["ema"][name], p.detach().numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


def test_videotext_cli_ranks_as_the_features_say(port_run, workdir,
                                                  capsys):
    """``inference_videotext`` with the text tower alone, loaded from the
    last checkpoint, ranks the pickled videos as the trained model's own
    text features do."""
    query = "the person is texting in the car"
    ranked = inference_videotext.main([
        "--cfg", port_run["cfg_path"], "--features",
        str(workdir / "port_features.pkl"), "--bpe_path",
        str(workdir / "merges.txt"), "--query", query, "--top_k", "5",
        "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(ranked) == len(printed) == 5
    model = port_run["second"]["train"].model
    tok = SimpleTokenizer(str(workdir / "merges.txt"))
    with torch.no_grad():
        t = model.encode_text(torch.from_numpy(
            tokenize(tok, [filter_query(query)], 8)))[0].numpy()
    v, ids = port_run["features"]
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    scores = v @ (t / np.linalg.norm(t))
    order = np.argsort(-scores)[:5]
    assert [vid for vid, _ in ranked] == [ids[i] for i in order]
    np.testing.assert_allclose([s for _, s in ranked], scores[order],
                               atol=ATOL)
    assert printed[0].split("\t")[0] == str(ids[order[0]])
