"""The port's losses, optimizer methods, meters and misc utilities against
the JAX package's on the same arrays: the seven soft-target and ranking
losses under ``mean`` and ``none`` (rtol 1e-5); ``adam``, ``sgd_8bit`` and
``adam_8bit`` over five steps against optax (rtol 1e-5, atol 1e-7),
``adam`` without weight decay as in the JAX package; the train, val and
test meters, ``topks_correct_full_label`` and ``get_map`` (equal, or 1e-6
for float sums)."""

import json
import logging

import jax
import numpy as np
import optax
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.models import losses as jlosses
from aicity_action_tpu.solver import optimizer as jopt
from aicity_action_tpu.utils import logging as jlogging
from aicity_action_tpu.utils import meters as jmeters
from aicity_action_tpu.utils import misc as jmisc
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.models import losses as tlosses
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.solver import optimizer as topt
from aicity_action_tpu_torch.utils import logging as tlogging
from aicity_action_tpu_torch.utils import meters as tmeters
from aicity_action_tpu_torch.utils import misc as tmisc
from torch_port_helpers import tiny_cfg
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

NEW_LOSSES = ("bce", "bce_logit", "mean_absolute_error",
              "reverse_soft_cross_entropy", "normalized_soft_cross_entropy",
              "nce_and_rce", "lsep")


@pytest.mark.parametrize("reduction", ["mean", "none"])
@pytest.mark.parametrize("name", NEW_LOSSES)
def test_losses_match_jax(name, reduction):
    rng = np.random.default_rng(len(name))
    logits = (rng.standard_normal((5, 7)) * 2).astype(np.float32)
    soft = rng.random((5, 7)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    multi_hot = (rng.random((5, 7)) < 0.3).astype(np.float32)
    x = 1 / (1 + np.exp(-logits)) if name == "bce" else logits
    t = multi_hot if name in ("bce", "bce_logit", "lsep") else soft
    got = tlosses.get_loss_func(name)(torch.from_numpy(x),
                                      torch.from_numpy(t), reduction)
    want = np.asarray(jlosses.get_loss_func(name)(x, t, reduction))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    assert tlosses._LOSSES.keys() == jlosses._LOSSES.keys()


def _opt_cfgs(method):
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_file("configs/AICITY_MVITV2_B_16x4_448.yaml")
        cfg.SOLVER.OPTIMIZING_METHOD = method
        cfg.SOLVER.WEIGHT_DECAY = 0.05
        cfg.SOLVER.BASE_LR = 0.1
        cfg.SOLVER.WARMUP_START_LR = 0.05
        cfg.SOLVER.MOMENTUM = 0.9
    return jcfg, pcfg


@pytest.mark.parametrize("method", ["adam", "sgd_8bit", "adam_8bit"])
def test_optimizer_methods_match_optax(method):
    """Five steps of clipping and the update on the same params, grads and
    schedule; ``adam`` (and so ``adam_8bit``) decays no weight, whatever
    ``WEIGHT_DECAY`` says."""
    jcfg, pcfg = _opt_cfgs(method)
    rng = np.random.default_rng(41)
    params = {"fc": {"kernel": rng.standard_normal((4, 3)).astype(np.float32),
                     "bias": rng.standard_normal(3).astype(np.float32)}}
    tx, _ = jopt.construct_optimizer(jcfg, params, 2)
    state = tx.init(params)
    model = torch.nn.Module()
    model.fc = torch.nn.Linear(4, 3)
    with torch.no_grad():
        model.fc.weight.copy_(torch.from_numpy(params["fc"]["kernel"].T))
        model.fc.bias.copy_(torch.from_numpy(params["fc"]["bias"]))
    opt = topt.construct_optimizer(pcfg, model, 2)
    decays = [g["weight_decay"] for g in opt.opt.param_groups]
    assert decays == ([0.05, 0.0] if "sgd" in method else [0.0, 0.0])
    jp = params
    for i in range(5):
        g = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * (2.0 if i == 0 else 0.1))
            .astype(np.float32), params)
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        model.fc.weight.grad = torch.tensor(g["fc"]["kernel"].T)
        model.fc.bias.grad = torch.tensor(g["fc"]["bias"])
        opt.step()
        np.testing.assert_allclose(model.fc.weight.detach().numpy(),
                                   np.asarray(jp["fc"]["kernel"]).T,
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(model.fc.bias.detach().numpy(),
                                   np.asarray(jp["fc"]["bias"]),
                                   rtol=1e-5, atol=1e-7)


def test_zero_methods_raise_naming_their_item():
    """The ZeRO methods are ported: without a process group (one rank)
    they are the plain optimizers; a method nobody knows still raises."""
    for zero, plain in (("zero_adamw", torch.optim.AdamW),
                        ("zero_sgd", torch.optim.SGD)):
        _, pcfg = _opt_cfgs(zero)
        opt = topt.construct_optimizer(pcfg, torch.nn.Linear(2, 2), 2)
        assert type(opt.opt) is plain and not opt.zero
    _, pcfg = _opt_cfgs("zero_adamw")
    pcfg.SOLVER.OPTIMIZING_METHOD = "zero_lamb"
    with pytest.raises(NotImplementedError, match="zero_lamb"):
        topt.construct_optimizer(pcfg, torch.nn.Linear(2, 2), 2)


def _meter_cfg(get, multi_label=False):
    cfg = get()
    cfg.LOG_PERIOD = 2
    cfg.SOLVER.MAX_EPOCH = 3
    cfg.DATA.MULTI_LABEL = multi_label
    return cfg


def test_train_meter_matches_jax():
    rng = np.random.default_rng(42)
    meters = [tmeters.TrainMeter(4, _meter_cfg(get_cfg)),
              jmeters.TrainMeter(4, _meter_cfg(jax_get_cfg))]
    for it in range(4):
        top1, top5, loss, lr = (float(v) for v in rng.random(4) * 50)
        mb = int(rng.integers(1, 5))
        for m in meters:
            m.iter_tic()
            m.data_toc()
            m.update_stats(top1, top5, loss, lr, mb)
            m.update_stats(None, None, loss, lr, 1)
            m.iter_toc()
    t, j = meters
    for attr in ("loss_total", "lr", "num_top1_mis", "num_top5_mis",
                 "num_samples"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for attr in ("loss", "mb_top1_err", "mb_top5_err"):
        a, b = getattr(t, attr), getattr(j, attr)
        assert a.get_win_median() == b.get_win_median()
        assert a.get_win_avg() == b.get_win_avg()
        assert a.get_global_avg() == b.get_global_avg()
    assert len(t.iter_times) == len(t.data_times) == 4
    assert all(0 <= d <= s for d, s in zip(t.data_times, t.iter_times))
    t.reset()
    assert t.iter_times == [] and t.num_samples == 0


@pytest.mark.parametrize("multi_label", [False, True])
def test_val_meter_matches_jax(multi_label):
    rng = np.random.default_rng(43)
    meters = [tmeters.ValMeter(2, _meter_cfg(get_cfg, multi_label)),
              jmeters.ValMeter(2, _meter_cfg(jax_get_cfg, multi_label))]
    for epoch in range(2):
        for m in meters:
            m.reset()
        for _ in range(3):
            preds = rng.random((4, 6)).astype(np.float32)
            labels = (rng.random((4, 6)) < 0.4).astype(np.float32)
            top1, top5 = (float(v) for v in rng.random(2) * 100)
            for m in meters:
                m.update_stats(top1, top5, 4)
                m.update_predictions(preds, labels)
        got, want = (m.log_epoch_stats(epoch) for m in meters)
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], float):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
            else:
                assert got[k] == want[k], k


@pytest.mark.parametrize("method", ["sum", "max"])
@pytest.mark.parametrize("multi_label", [False, True])
def test_test_meter_matches_jax(method, multi_label):
    rng = np.random.default_rng(44)
    num_videos, num_clips, num_cls = 5, 3, 7
    kw = dict(num_videos=num_videos, num_clips=num_clips, num_cls=num_cls,
              multi_label=multi_label, ensemble_method=method)
    meters = [tmeters.TestMeter(**kw), jmeters.TestMeter(**kw)]
    ids = rng.permutation(num_videos * num_clips)
    preds = rng.standard_normal((len(ids), num_cls)).astype(np.float32)
    if multi_label:
        vid_labels = (rng.random((num_videos, num_cls)) < 0.4).astype(
            np.float32)
    else:
        vid_labels = rng.integers(0, num_cls, num_videos)
    labels = vid_labels[ids // num_clips]
    for m in meters:
        m.update_stats(preds[:8], labels[:8], ids[:8])
        m.update_stats(preds[8:], labels[8:], ids[8:])
    got, want = (m.finalize_metrics() for m in meters)
    assert got == want
    np.testing.assert_array_equal(meters[0].video_preds,
                                  meters[1].video_preds)
    np.testing.assert_array_equal(meters[0].video_labels,
                                  meters[1].video_labels)


def test_topk_full_label_and_map_match_jax():
    rng = np.random.default_rng(45)
    preds = rng.random((9, 6)).astype(np.float32)
    labels = (rng.random((9, 6)) < 0.3).astype(np.float32)
    labels[2] = 0.0  # a sample with no positive label is left out of mAP
    for ks in ((1, 5), (1, 3, 10)):
        assert tmeters.topks_correct_full_label(preds, labels, ks) == \
            jmeters.topks_correct_full_label(preds, labels, ks)
    assert tmeters.get_map(preds, labels) == jmeters.get_map(preds, labels)
    timer = [tmeters.EpochTimer(), jmeters.EpochTimer()]
    for e in timer:
        e.epoch_tic()
        e.epoch_toc()
        assert len(e.epoch_times) == 1


def test_misc_matches_jax(tmp_path, caplog):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.SOLVER.MAX_EPOCH = 12
        c.TRAIN.EVAL_PERIOD = 5
        c.MULTIGRID.EVAL_FREQ = 2
    schedule = [[0, 0, 0, 4], [0, 0, 0, 9], [0, 0, 0, 12]]
    for e in range(12):
        for sched in (None, schedule):
            assert tmisc.is_eval_epoch(cfg, e, sched) == \
                jmisc.is_eval_epoch(jcfg, e, sched)
    names = tmp_path / "names.json"
    names.write_text(json.dumps({"a": 1, "b": 0, "c": 3}))
    parents = tmp_path / "parents.json"
    parents.write_text(json.dumps({"p": ["a", "c", "z"]}))
    subset = tmp_path / "subset.txt"
    subset.write_text("c\nb\nz")
    assert tmisc.get_class_names(str(names), str(parents), str(subset)) == \
        jmisc.get_class_names(str(names), str(parents), str(subset))
    with pytest.raises(RuntimeError, match="NaN"):
        tmisc.check_nan_losses(float("nan"))
    tmisc.check_nan_losses(1.0)
    used, total = tmisc.cpu_mem_usage()
    assert 0 < used < total
    assert tmisc.gpu_mem_usage() == 0.0  # no card here

    model = build_model(tiny_cfg(get_cfg), device="cpu")
    assert tmisc.params_count(model) == sum(
        p.numel() for p in model.parameters())
    gflops = tmisc.get_flop_stats(model, torch.zeros(1, 4, 32, 32, 3))
    # the stem's conv alone: 2 x out elements x (in channels x kernel)
    stem = 2 * (2 * 8 * 8 * 32) * (3 * 3 * 7 * 7) / 1e9
    assert gflops > stem and not model.training

    with caplog.at_level(logging.INFO):
        stats = {"_type": "x", "loss": 1 / 3, "n": 4, "s": "a"}
        tlogging.log_json_stats(stats)
        jlogging.log_json_stats(stats)
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("json_stats")]
    assert len(lines) == 2 and lines[0] == lines[1]
