"""The port's data parallelism against the JAX package's, on the CPU: two
gloo ranks (``tests/torch_dp_worker.py``, one ``torch.multiprocessing.
spawn``) of the train-loop test's tiny v2, against the JAX loops on a
2-device mesh over the same global batch.

One spawn runs, on each rank: an SGD ``train`` + ``test`` (held against
JAX: losses rtol 1e-4, parameters rtol 1e-4 / atol 1e-5, val and test
errors equal); ``zero_adamw`` for two epochs and ``adamw`` for one (ZeRO
against the plain optimizer, rtol 1e-6); ``zero_adamw`` resuming a
world-1 ``adamw`` checkpoint; a ragged ``process_allgather``; and each
rank's train loader at ``NUM_GPUS 2`` and at ``NUM_SHARDS 2``. This
process runs the world-1 ``adamw`` runs, one of them resuming the world-2
``zero_adamw`` checkpoint.

Across world sizes AdamW turns the f32 noise of exactly-zero gradients
into LR-sized steps: the keys' biases (the qkv bias's key third and the k
pool norm's bias) shift every logit of a query alike, so softmax gives
them no gradient. The resume checks hold every other leaf, and the losses
(which those biases cannot move), to the SGD tolerances.
"""

import os
import shutil

import jax
import numpy as np
import pytest

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.data import loader as jloader
from aicity_action_tpu.engine import test_loop as jtest_loop
from aicity_action_tpu.engine import train_loop as jtrain_loop
from aicity_action_tpu.parallel.mesh import make_mesh
from aicity_action_tpu.utils import meters as jmeters
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.engine import train_loop as ttrain_loop
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.utils.convert import jax_tree_to_named
from test_torch_train_loop import CLIP_FRAMES, NUM_CLASSES, NUM_VIDEOS
from test_torch_train_loop import _tiny_cfg
from torch_port_helpers import WORLD, collect_ranks, start_ranks, write_mp4
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

import torch

ADAMW_LR = 1e-3
# leaves whose gradient is exactly zero (see the module's docstring)
SHIFT_INVARIANT = ("attn.qkv.bias", "attn.norm_k.bias")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The train-loop test's eight one-clip views and csvs, and a
    ``.pyth`` of the port's tiny model drawn from seed 3."""
    d = tmp_path_factory.mktemp("dp")
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


def _port_cfg(workdir, out, method="sgd", epochs=1, world=WORLD):
    cfg = _tiny_cfg(get_cfg, workdir, out)
    cfg.NUM_GPUS = world
    cfg.SOLVER.OPTIMIZING_METHOD = method
    cfg.SOLVER.MAX_EPOCH = epochs
    if method != "sgd":  # a constant LR: runs of 1 and 2 epochs agree
        cfg.SOLVER.LR_POLICY = "steps_with_relative_lrs"
        cfg.SOLVER.STEPS, cfg.SOLVER.LRS = [0], [1.0]
        cfg.SOLVER.BASE_LR = ADAMW_LR
        cfg.SOLVER.WEIGHT_DECAY = 0.05
        cfg.TEST.ENABLE = False
    return cfg


@pytest.fixture(scope="module")
def world1(workdir):
    """World-1 ``adamw`` for two epochs here, with a checkpoint an epoch
    (its epoch-1 checkpoint is copied for the ranks to resume)."""
    cfg = _port_cfg(workdir, "w1_adamw", "adamw", epochs=2, world=1)
    run = ttrain_loop.train(cfg, device="cpu")
    resume = workdir / "zero_resumes_adamw" / "checkpoints"
    os.makedirs(resume)
    shutil.copy(os.path.join(cfg.OUTPUT_DIR, "checkpoints",
                             "checkpoint_epoch_00001"), resume)
    return run


@pytest.fixture(scope="module")
def launched(workdir, world1):
    """The ranks' runs, started before the JAX run so that the two
    overlap."""
    runs = [("sgd", _port_cfg(workdir, "sgd")),
            ("zero2", _port_cfg(workdir, "zero2", "zero_adamw", epochs=2)),
            ("adamw1", _port_cfg(workdir, "adamw1", "adamw")),
            ("zero_resumes_adamw",
             _port_cfg(workdir, "zero_resumes_adamw", "zero_adamw",
                       epochs=2))]
    loaders = []
    for shards in (1, 2):
        cfg = _port_cfg(workdir, "loader")
        cfg.NUM_SHARDS, cfg.NUM_GPUS = shards, WORLD // shards
        loaders.append(cfg)
    handle = start_ranks({"kind": "loop", "runs": runs, "loaders": loaders},
                         workdir / "spawn")
    yield handle
    handle[0].kill()


@pytest.fixture(scope="module")
def ranks(launched, jax_run):
    return collect_ranks(launched)


@pytest.fixture(scope="module")
def jax_run(workdir, launched):
    """The JAX package's SGD train + test on a 2-device mesh, with the
    per-step losses and the val stats its meters saw."""
    losses, val = [], []
    mp = pytest.MonkeyPatch()
    two = lambda cfg: make_mesh(cfg, devices=jax.devices()[:2])  # noqa: E731
    mp.setattr(jtrain_loop, "make_mesh", two)
    mp.setattr(jtest_loop, "make_mesh", two)
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
    return dict(losses=losses, val=val, params=params, test=stats)


def _assert_params(got: dict, want: dict, skip=(), **tol):
    assert set(got) == set(want)
    for name, p in want.items():
        if not any(s in name for s in skip):
            np.testing.assert_allclose(got[name], p, err_msg=name, **tol)


def test_two_rank_sgd_steps_match_jax_on_two_devices(ranks, jax_run):
    run = ranks[0]["runs"]["sgd"]
    assert run["count"] == len(jax_run["losses"]) == 2
    np.testing.assert_allclose(run["losses"][0], jax_run["losses"],
                               rtol=1e-4)
    _assert_params(run["params"], jax_run["params"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["sgd", "zero2", "adamw1",
                                  "zero_resumes_adamw"])
def test_ranks_agree(ranks, name):
    """Every rank logs the global batch's losses and ends with the same
    parameters (DDP's averaged gradients; ZeRO's broadcast shares)."""
    a, b = ranks[0]["runs"][name], ranks[1]["runs"][name]
    assert a["losses"] == b["losses"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])


def test_two_rank_val_and_test_errors_match_jax(ranks, jax_run):
    run = ranks[0]["runs"]["sgd"]
    (jval,) = jax_run["val"]
    (tval,) = run["val"]
    for k in ("top1_err", "top5_err"):
        assert tval[k] == jval[k], k
    assert tval["clips"] == NUM_VIDEOS  # the global batch's, gathered
    for r in ranks:  # one gather an epoch gives every rank the whole set
        for k in ("top1_acc", "top5_acc"):
            assert r["runs"]["sgd"]["test"][k] == jax_run["test"][k], k


def _ckpt(workdir, name, epoch):
    return os.path.join(workdir, name, "checkpoints",
                        f"checkpoint_epoch_{epoch:05d}")


def test_zero_adamw_steps_as_adamw(ranks, workdir):
    zero, plain = ranks[0]["runs"]["zero2"], ranks[0]["runs"]["adamw1"]
    assert zero["zero"] and not plain["zero"]
    np.testing.assert_allclose(zero["losses"][0], plain["losses"][0],
                               rtol=1e-6)
    # zero2's first epoch is adamw1's whole run
    state = torch.load(_ckpt(workdir, "zero2", 1),
                       weights_only=True)["model_state"]
    _assert_params({k: state[k].numpy() for k in plain["params"]},
                   plain["params"], rtol=1e-6)


def test_zero_checkpoint_has_the_plain_optimizer_format(ranks, workdir):
    """Rank 0 alone wrote the file, with every rank's moments in it: a
    plain AdamW of the same groups loads it whole."""
    from aicity_action_tpu_torch.solver.optimizer import construct_optimizer

    ckpt = torch.load(_ckpt(workdir, "zero2", 1), weights_only=True)
    cfg = _port_cfg(workdir, "unused", "adamw", world=1)
    model = build_model(cfg, device="cpu")
    opt = construct_optimizer(cfg, model, 2)
    assert not opt.zero
    opt.opt.load_state_dict(ckpt["optimizer_state"])
    params = opt.params
    assert len(opt.opt.state) == len(params)
    for p in params:
        assert opt.opt.state[p]["exp_avg"].shape == p.shape
    assert ckpt["step"] == 2 and ckpt["epoch"] == 1


@pytest.fixture(scope="module")
def adamw_resumes_zero(workdir, ranks):
    """World-1 ``adamw`` auto-resuming the world-2 ``zero_adamw`` epoch-1
    checkpoint, for the second epoch."""
    out = workdir / "adamw_resumes_zero" / "checkpoints"
    os.makedirs(out)
    shutil.copy(_ckpt(workdir, "zero2", 1), out)
    cfg = _port_cfg(workdir, "adamw_resumes_zero", "adamw", epochs=2,
                    world=1)
    return ttrain_loop.train(cfg, device="cpu")


def test_zero_checkpoint_resumes_at_world_one_under_adamw(
        ranks, adamw_resumes_zero):
    zero, run = ranks[0]["runs"]["zero2"], adamw_resumes_zero
    assert run.start_epoch == 1 and len(run.epochs) == 1
    assert run.optimizer.count == zero["count"] == 4
    np.testing.assert_allclose(run.epochs[0]["losses"], zero["losses"][1],
                               rtol=1e-4)
    _assert_params({k: v.detach().numpy()
                    for k, v in run.model.named_parameters()},
                   zero["params"], SHIFT_INVARIANT, rtol=1e-4, atol=1e-5)


def test_adamw_checkpoint_resumes_at_world_two_under_zero(ranks, world1):
    got = ranks[0]["runs"]["zero_resumes_adamw"]
    assert got["zero"] and got["start_epoch"] == 1 and got["count"] == 4
    np.testing.assert_allclose(got["losses"][0], world1.epochs[1]["losses"],
                               rtol=1e-4)
    _assert_params(got["params"], {
        k: v.detach().numpy() for k, v in world1.model.named_parameters()},
        SHIFT_INVARIANT, rtol=1e-4, atol=1e-5)


def test_process_allgather_is_ragged(ranks):
    for r in ranks:
        assert [a.tolist() for a in r["allgather"]] == [[0], [10, 11]]


@pytest.mark.parametrize("shards", [1, 2])
def test_each_rank_loads_its_slice_of_the_jax_host_batch(ranks, workdir,
                                                         shards):
    """At ``NUM_GPUS 2`` the two ranks split the one JAX host's batches
    (its chips' rows); at ``NUM_SHARDS 2`` rank r loads JAX host r's."""
    gpus = WORLD // shards
    for rank, r in enumerate(ranks):
        cfg = _tiny_cfg(jax_get_cfg, workdir, "loader")
        cfg.NUM_SHARDS, cfg.SHARD_ID = shards, rank // gpus
        loader = jloader.construct_loader(cfg, "train")
        jloader.shuffle_dataset(loader, 1)
        host = [b["index"].tolist() for b in loader]
        b = len(host[0]) // gpus
        lo = (rank % gpus) * b
        want = [h[lo:lo + b] for h in host]
        assert r["loaders"][shards - 1] == want
        assert len(want) and all(len(w) == b for w in want)


def test_group_rules_without_spawning(workdir):
    """One process: world 1 joins no group unless asked; a CPU run takes
    only gloo (nccl is never swapped for it); the loops refuse a config of
    several ranks in a process that is not one of them; a global batch
    the ranks do not divide is refused."""
    from aicity_action_tpu_torch.config import assert_and_infer_cfg
    from aicity_action_tpu_torch.parallel import mesh

    cfg = _port_cfg(workdir, "rules", world=1)
    assert mesh.init_distributed(cfg, device="cpu") is False
    assert not mesh.is_initialized() and mesh.get_world_size() == 1
    cfg.DIST_BACKEND = "nccl"
    with pytest.raises(ValueError, match="gloo"):
        mesh.init_distributed(cfg, device="cpu", force=True)
    cfg = _port_cfg(workdir, "rules")  # NUM_GPUS 2
    with pytest.raises(RuntimeError, match="2 ranks"):
        ttrain_loop.train(cfg, device="cpu")
    cfg.NUM_SHARDS, cfg.TRAIN.BATCH_SIZE = 3, 8  # 8 % NUM_GPUS == 0
    with pytest.raises(ValueError, match="6 ranks"):
        assert_and_infer_cfg(cfg)
