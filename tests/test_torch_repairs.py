"""Three faults of the port against the JAX package, each held here on the
CPU: ranks beyond the host's cards (``run_net``, ``run_net_contrastive``
and ``run_temporal_inf`` raise before spawning, with a faked
``torch.cuda.device_count``), mixup of a multi-pathway input (every
pathway mixed with the JAX mixup's draw, inside the port's train step),
and one video's windows over two gloo ranks on the window-streaming and
loader paths (the union of the ranks' windows equal to one process's bit
for bit, each rank running only its share of the forwards)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aicity_action_tpu.data import mixup as jmix
from aicity_action_tpu_torch import device as tdevice
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.data import mixup as tmix
from aicity_action_tpu_torch.engine import steps as tsteps
from aicity_action_tpu_torch.parallel import mesh
from aicity_action_tpu_torch.solver.optimizer import TrainOptimizer
from aicity_action_tpu_torch.tools import (run_net, run_net_contrastive,
                                           run_temporal_inf)
from torch_dp_worker import score_cases
from torch_port_helpers import (YAML, collect_ranks, start_ranks, tiny_cfg,
                                write_mp4)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


# --------------------------------------------------- ranks beyond the cards

@pytest.fixture
def one_card(monkeypatch):
    """A host that reports one card, whose CUDA device resolves, and on
    which a spawn fails the test."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(tdevice, "resolve_device",
                        lambda d="cuda": torch.device(d))

    def no_spawn(*a, **k):
        raise AssertionError("ranks were spawned")

    monkeypatch.setattr(torch.multiprocessing, "spawn", no_spawn)


def test_card_count_check_names_both_numbers(one_card):
    cfg = get_cfg()
    cfg.NUM_GPUS = 2
    with pytest.raises(RuntimeError) as e:
        mesh.check_card_count(cfg, "cuda")
    msg = str(e.value)
    assert "NUM_GPUS=2" in msg and "device_count() is 1" in msg
    assert "NUM_GPUS 1" in msg
    mesh.check_card_count(cfg, "cpu")  # gloo ranks on the CPU: no limit
    cfg.NUM_GPUS = 1
    mesh.check_card_count(cfg, "cuda")


@pytest.mark.parametrize("cli", [run_net, run_net_contrastive])
def test_run_net_raises_before_spawning_past_the_cards(one_card, cli):
    # the YAML asks for the 8-card recipe
    with pytest.raises(RuntimeError, match="device_count"):
        cli.main(["--cfg", YAML])


def test_run_temporal_inf_raises_before_spawning_past_the_cards(
        one_card, tmp_path):
    (tmp_path / "v.txt").write_text("a.mp4\n")
    with pytest.raises(RuntimeError, match="NUM_GPUS=8"):
        run_temporal_inf.main(["--cfg", YAML, "--video_lst",
                               str(tmp_path / "v.txt"), "--video_path",
                               str(tmp_path), "--out_dir",
                               str(tmp_path / "o")])


# ----------------------------------------------- mixup of several pathways

def _replay_mixup_draw(cfg, key, hw):
    """The draw the JAX mixup makes from ``key`` (aicity_action_tpu/data/
    mixup.py:78-93), as the port's MixupDraw."""
    m = cfg.MIXUP
    r_apply, r_switch, r_lam_m, r_lam_c, r_box = jax.random.split(key, 5)
    ry, rx = jax.random.split(r_box)
    return tmix.MixupDraw(
        apply=bool(jax.random.bernoulli(r_apply, m.PROB)),
        use_cutmix=bool(jax.random.bernoulli(r_switch, m.SWITCH_PROB)),
        lam_mix=float(jmix._beta_sample(r_lam_m, m.ALPHA)),
        lam_cut=float(jmix._beta_sample(r_lam_c, m.CUTMIX_ALPHA)),
        cy=int(jax.random.randint(ry, (), 0, hw[0])),
        cx=int(jax.random.randint(rx, (), 0, hw[1])))


class _Recorder(torch.nn.Module):
    """Keeps the pathways it is given; its logits are a parameter."""

    def __init__(self, classes):
        super().__init__()
        self.logits = torch.nn.Parameter(
            torch.linspace(-1.0, 1.0, classes))
        self.seen = None

    def forward(self, xs, generator=None):
        self.seen = [x.detach().clone() for x in xs]
        return self.logits.expand(xs[0].shape[0], -1) + 0.0 * xs[0].mean()


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_train_step_mixes_every_pathway_with_the_jax_draw(seed):
    """A slow and a fast pathway through the port's train step, against
    the JAX mixup of the same list for the draw its key makes (the seeds
    cover MixUp and CutMix): each pathway and the soft-target loss."""
    cfg = get_cfg()
    cfg.MIXUP.ENABLE = True
    cfg.TPU.BF16_HOST_TRANSFER = False
    cfg.MODEL.NUM_CLASSES = 10
    rng = np.random.default_rng(40 + seed)
    slow = rng.standard_normal((4, 2, 12, 10, 3)).astype(np.float32)
    fast = rng.standard_normal((4, 8, 12, 10, 3)).astype(np.float32)
    y = np.array([1, 7, 9, 0], np.int32)
    key = jax.random.PRNGKey(seed)
    ref_xs, ref_t = jmix.build_mixup_from_cfg(cfg)(
        key, [jnp.asarray(slow), jnp.asarray(fast)], jnp.asarray(y))
    model = _Recorder(10)
    opt = TrainOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                         lambda step: 0.1)
    step = tsteps.make_train_step(
        model, opt, "soft_cross_entropy",
        mixup_fn=tmix.build_mixup_from_cfg(cfg), num_classes=10)
    metrics, _ = step({"inputs": [torch.from_numpy(slow),
                                  torch.from_numpy(fast)],
                       "labels": torch.from_numpy(y)},
                      mixup_draw=_replay_mixup_draw(cfg, key, (12, 10)))
    for got, want in zip(model.seen, ref_xs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    logp = jax.nn.log_softmax(jnp.linspace(-1.0, 1.0, 10))
    want_loss = float(jnp.mean(jnp.sum(-ref_t * logp, -1)))
    assert float(metrics["loss"]) == pytest.approx(want_loss, abs=1e-6)


# ---------------------------------------- one video over ranks, every path

CHUNK = 24  # windows start every 16 frames: first chunks 0, 0, 1, 2, 2, 3


def _scoring_cases():
    cls = tiny_cfg(get_cfg)
    cls.MODEL.ACT_CHECKPOINT = False
    det = cls.clone()
    det.MODEL.HEAD_ACT = "sigmoid"
    det.DETECTION.ENABLE = True
    det.DETECTION.SPATIAL_SCALE_FACTOR = 16
    return [("loader", cls, False), ("streaming", det, True)]


def test_two_ranks_split_the_streaming_and_loader_paths(tmp_path):
    """Two gloo ranks score a 90-frame view of six windows through the
    window-streaming path (the whole-frame detection model's) and the
    loader path: each rank runs one forward of its three windows, where
    one process runs two of the six, and every rank returns the
    one-process windows bit for bit."""
    video = str(tmp_path / "v.mp4")
    write_mp4(video, num_frames=90, seed=7)
    cases = _scoring_cases()
    handle = start_ranks({"kind": "scoring", "cases": cases,
                          "video": video, "chunk": CHUNK},
                         tmp_path / "ranks")
    one = score_cases(cases, video, CHUNK)
    ranks = collect_ranks(handle)
    for name, _, _ in cases:
        want = one[name]["preds"]
        assert len(want) == 6 and one[name]["forwards"] == 2
        for rank in ranks:
            got = rank[name]
            assert got["forwards"] == 1, name
            assert [w["windows"] for w in got["timers"]["ranks"]] == [3, 3]
            assert [p[:2] for p in got["preds"]] == [p[:2] for p in want]
            for (_, _, a), (_, _, b) in zip(got["preds"], want):
                np.testing.assert_array_equal(a, b, err_msg=name)
