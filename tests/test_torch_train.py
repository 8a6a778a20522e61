"""The PyTorch port's training step against the JAX package's, on the CPU
in f32, and its pieces: losses, LR schedule, AdamW against optax, mixup,
DropPath, and activation checkpointing with DropPath on.

The whole-step tests use the tiny MViT-v2 (depth 4, crop 32, 4 frames,
embed 32) and the tiny cls-token MViT-v1 of the same sizes, with DropPath
and head dropout off and mixup on; the v2 also with the fused-LN attention
switched on for training (``AICITY_TPU_FUSE_ATTN_LN=1``) on both sides. The JAX model's
params (perturbed with numpy noise) go into the port through
``jax_params_to_state_dict``; the JAX step runs with ``ACT_CHECKPOINT
False`` (its remat traces the block's (T, H, W)), the port's with
checkpointing on. The JAX step's mixup draws are replayed from its key
and passed to the port. Tolerances (f32, sums in different orders): loss
and grad_norm rtol 1e-5; every gradient leaf and every parameter after
each step rtol 1e-4 / atol 1e-5. The step uses SGD with momentum, not the
recipe's AdamW (see _train_cfg for why).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.data import mixup as jmix
from aicity_action_tpu.engine import steps as jsteps
from aicity_action_tpu.models import losses as jlosses
from aicity_action_tpu.models import mvit as jmvit
from aicity_action_tpu.ops.pallas import flash_attention as jfa
from aicity_action_tpu.solver import lr_policy as jlr
from aicity_action_tpu.solver import optimizer as jopt
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.data import mixup as tmix
from aicity_action_tpu_torch.engine import steps as tsteps
from aicity_action_tpu_torch.models import losses as tlosses
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.models.common import drop_path, drop_path_mask
from aicity_action_tpu_torch.solver import lr_policy as tlr
from aicity_action_tpu_torch.solver import optimizer as topt
from aicity_action_tpu_torch.utils.convert import (jax_params_to_state_dict,
                                                   jax_tree_to_named)
from aicity_action_tpu_torch.models import mvit as tmvit
from torch_port_helpers import (jax_tiny_params_from_port, jax_tiny_v1_model,
                                perturb, tiny_cfg, tiny_v1_cfg)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

B = 2
STEPS_PER_EPOCH = 2


def _train_cfg(get, act_checkpoint, make_cfg=tiny_cfg):
    cfg = make_cfg(get)
    cfg.MODEL.ACT_CHECKPOINT = act_checkpoint
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.MIXUP.ENABLE = True
    cfg.TPU.BF16_HOST_TRANSFER = False
    # SGD, at an LR that moves the params measurably within two steps:
    # AdamW divides each gradient element by its own running magnitude, so
    # f32 noise in a near-zero gradient (the k pool norm's bias has an
    # exact gradient of 0: softmax ignores one shift of every key) becomes
    # a step of up to the LR, and params after AdamW steps cannot be held
    # elementwise; test_optimizer_step_matches_optax holds AdamW to optax
    cfg.SOLVER.OPTIMIZING_METHOD = "sgd"
    cfg.SOLVER.WARMUP_START_LR = 0.25
    cfg.SOLVER.BASE_LR = 0.5
    cfg.SOLVER.WARMUP_EPOCHS = 1.0
    return cfg


def _replay_mixup_draw(cfg, mixup_rng, hw):
    """The draw the JAX mixup makes from ``mixup_rng``, as the port's
    MixupDraw (aicity_action_tpu/data/mixup.py:78-93)."""
    m = cfg.MIXUP
    r_apply, r_switch, r_lam_m, r_lam_c, r_box = jax.random.split(mixup_rng, 5)
    ry, rx = jax.random.split(r_box)
    return tmix.MixupDraw(
        apply=bool(jax.random.bernoulli(r_apply, m.PROB)),
        use_cutmix=bool(jax.random.bernoulli(r_switch, m.SWITCH_PROB)),
        lam_mix=float(jmix._beta_sample(r_lam_m, m.ALPHA)),
        lam_cut=float(jmix._beta_sample(r_lam_c, m.CUTMIX_ALPHA)),
        cy=int(jax.random.randint(ry, (), 0, hw[0])),
        cx=int(jax.random.randint(rx, (), 0, hw[1])))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX module (DropPath off) and perturbed params."""
    params = jax_tiny_params_from_port()
    jcfg = _train_cfg(jax_get_cfg, False)
    module = jmvit.MViT(spec=jmvit.build_mvit_spec(jcfg), dtype=jnp.float32)
    return jcfg, module, perturb(params, 7)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 4, 32, 32, 3)).astype(np.float32)
    return x, np.array([3, 11], np.int32)


def _stash_grads():
    """An optax stage that passes the updates on and keeps them as its
    state: chained first, it leaves each step's raw gradients in the JAX
    TrainState, so one jitted make_train_step gives them."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


def _jax_steps(jcfg, module, params, x, y, nsteps):
    """``nsteps`` JAX train steps; per step the metrics, the gradients
    (clipped as the optimizer clips them), the params after the step and
    the mixup draw."""
    tx, _ = jopt.construct_optimizer(jcfg, params, STEPS_PER_EPOCH)
    tx = optax.chain(_stash_grads(), tx)
    step = jax.jit(jsteps.make_train_step(
        module, tx, "soft_cross_entropy",
        mixup_fn=jmix.build_mixup_from_cfg(jcfg)))
    state = jsteps.TrainState.create(params, tx)
    key = jax.random.PRNGKey(0)
    out = []
    for i in range(nsteps):
        mixup_rng = jax.random.split(jax.random.fold_in(key, i), 3)[2]
        state, metrics, _ = step(state, {"inputs": jnp.asarray(x),
                                         "labels": jnp.asarray(y)}, key)
        norm = float(metrics["grad_norm"])
        clip = min(1.0, jcfg.SOLVER.CLIP_GRAD_L2NORM / norm)
        out.append(dict(
            loss=float(metrics["loss"]), grad_norm=norm,
            grads=jax_tree_to_named(jax.tree_util.tree_map(
                lambda a: np.asarray(a) * clip, state.opt_state[0])),
            params=jax_tree_to_named(jax.tree_util.tree_map(
                np.asarray, state.params)),
            draw=_replay_mixup_draw(jcfg, mixup_rng, x.shape[2:4])))
    return out


def _port_model(params, act_checkpoint, droppath=0.0, dropout=0.0,
                make_cfg=tiny_cfg):
    pcfg = _train_cfg(get_cfg, act_checkpoint, make_cfg)
    pcfg.MVIT.DROPPATH_RATE = droppath
    pcfg.MODEL.DROPOUT_RATE = dropout
    model = build_model(pcfg, device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return pcfg, model


def _check_steps(model, pcfg, x, y, ref, nsteps):
    opt = topt.construct_optimizer(pcfg, model, STEPS_PER_EPOCH)
    step = tsteps.make_train_step(
        model, opt, "soft_cross_entropy",
        mixup_fn=tmix.build_mixup_from_cfg(pcfg), num_classes=18)
    named = dict(model.named_parameters())
    for i in range(nsteps):
        metrics, preds = step({"inputs": torch.from_numpy(x),
                               "labels": torch.from_numpy(y)},
                              mixup_draw=ref[i]["draw"])
        assert preds.shape == (B, 18) and not bool(metrics["loss_is_nan"])
        np.testing.assert_allclose(float(metrics["loss"]), ref[i]["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   ref[i]["grad_norm"], rtol=1e-5)
        assert set(ref[i]["grads"]) == set(named)
        for name, g in ref[i]["grads"].items():
            np.testing.assert_allclose(named[name].grad.numpy(), g,
                                       rtol=1e-4, atol=1e-5, err_msg=name)
        for name, p in ref[i]["params"].items():
            np.testing.assert_allclose(named[name].detach().numpy(), p,
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_two_train_steps_match_jax(jax_side, batch):
    """Loss, grad_norm, every gradient and every parameter after each of
    two steps; the port checkpoints every block, the JAX step does not."""
    jcfg, module, params = jax_side
    x, y = batch
    ref = _jax_steps(jcfg, module, params, x, y, 2)
    pcfg, model = _port_model(params, act_checkpoint=True)
    _check_steps(model, pcfg, x, y, ref, 2)


def test_train_step_matches_jax_pallas_backwards(jax_side, batch,
                                                 monkeypatch):
    """One step against the JAX step on its Pallas path (interpret mode):
    fused LN+qkv, flash attention and fused LN+MLP with their Pallas
    backward kernels."""
    monkeypatch.setattr(jfa, "INTERPRET", True)
    monkeypatch.setattr(jmvit, "_use_pallas", lambda: True)
    jcfg, module, params = jax_side
    x, y = batch
    ref = _jax_steps(jcfg, module, params, x, y, 1)
    pcfg, model = _port_model(params, act_checkpoint=False)
    _check_steps(model, pcfg, x, y, ref, 1)


def test_two_v1_train_steps_match_jax(batch):
    """The cls-token MViT-v1 (no activation checkpointing, as its recipe):
    two steps' loss, grad_norm, gradients (cls_token, pos_embed_class and
    the channel-change blocks' proj included) and params."""
    params = perturb(jax_tiny_v1_model()[1], 9)
    jcfg = _train_cfg(jax_get_cfg, False, tiny_v1_cfg)
    module = jmvit.MViT(spec=jmvit.build_mvit_spec(jcfg), dtype=jnp.float32)
    x, y = batch
    ref = _jax_steps(jcfg, module, params, x, y, 2)
    assert {"cls_token", "pos_embed_class", "blocks.0.proj.weight"} <= set(
        ref[0]["grads"])
    pcfg, model = _port_model(params, act_checkpoint=False,
                              make_cfg=tiny_v1_cfg)
    _check_steps(model, pcfg, x, y, ref, 2)


def test_fused_ln_train_steps_match_jax_pallas(jax_side, batch,
                                               monkeypatch):
    """Two steps with ``AICITY_TPU_FUSE_ATTN_LN=1`` on both sides: the JAX
    step through its interpret-mode Pallas kernels, the fused-LN attention
    with its Pallas backward included; the port (checkpointing on) through
    flash_attention_ln under autograd. Both take KV strides of (1, 2, 2),
    at which the JAX package's fused-LN kernels take every block."""
    monkeypatch.setenv("AICITY_TPU_FUSE_ATTN_LN", "1")
    monkeypatch.setattr(jfa, "INTERPRET", True)
    monkeypatch.setattr(jmvit, "_use_pallas", lambda: True)
    jcfg, _, params = jax_side
    jcfg = jcfg.clone()
    jcfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 2, 2]
    module = jmvit.MViT(spec=jmvit.build_mvit_spec(jcfg), dtype=jnp.float32)
    for b in module.spec.blocks:
        d = b.dim_out // b.num_heads
        assert jfa.flash_attention_ln_supported(32, 32, d)
    x, y = batch
    ref = _jax_steps(jcfg, module, params, x, y, 2)
    pcfg, model = _port_model(params, act_checkpoint=True)
    pcfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 2, 2]
    model = build_model(pcfg, device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    calls = []
    fused = tmvit.flash_attention_ln
    monkeypatch.setattr(tmvit, "flash_attention_ln",
                        lambda *a: calls.append(1) or fused(*a))
    _check_steps(model, pcfg, x, y, ref, 2)
    # forward and recompute of every block, two steps
    assert len(calls) == 2 * 2 * len(model.blocks)


@pytest.mark.parametrize("switch,training,fused", [
    ("auto", False, True), ("auto", True, False), ("0", False, False),
    ("1", True, True)])
def test_fuse_switch_picks_the_attention_path(switch, training, fused,
                                              monkeypatch):
    """``AICITY_TPU_FUSE_ATTN_LN`` as the JAX package reads it: ``auto``
    fuses at eval only, ``0`` nowhere (the eval then launches the plain
    flash attention), ``1`` in training too."""
    monkeypatch.setenv("AICITY_TPU_FUSE_ATTN_LN", switch)
    calls = {"flash_attention": 0, "flash_attention_ln": 0}
    for name in calls:
        fn = getattr(tmvit, name)

        def counted(*a, name=name, fn=fn):
            calls[name] += 1
            return fn(*a)
        monkeypatch.setattr(tmvit, name, counted)
    model = build_model(_train_cfg(get_cfg, False), device="cpu")
    model.train(training)
    with torch.set_grad_enabled(training):
        model(torch.zeros(1, 4, 32, 32, 3))
    depth = len(model.blocks)
    assert calls == {"flash_attention": 0 if fused else depth,
                     "flash_attention_ln": depth if fused else 0}


def test_checkpointing_keeps_the_gradients_with_droppath_on(jax_side, batch):
    """DropPath masks are drawn before each checkpointed block, so the
    recompute applies the same masks: checkpoint on and off give the same
    loss and gradients for the same step seed, with DropPath at 0.4 and
    head dropout at 0.5."""
    _, _, params = jax_side
    x, y = batch
    grads = []
    for remat in (True, False):
        pcfg, model = _port_model(params, remat, droppath=0.4, dropout=0.5)
        assert model.blocks[-1].drop_rate == pytest.approx(0.4)
        opt = topt.construct_optimizer(pcfg, model, STEPS_PER_EPOCH)
        step = tsteps.make_train_step(model, opt, "cross_entropy", seed=3)
        metrics, _ = step({"inputs": torch.from_numpy(x),
                           "labels": torch.from_numpy(y).long()})
        grads.append((float(metrics["loss"]),
                      {n: p.grad.clone()
                       for n, p in model.named_parameters()}))
    (l_on, g_on), (l_off, g_off) = grads
    assert l_on == pytest.approx(l_off, rel=1e-6)
    for name in g_on:
        torch.testing.assert_close(g_on[name], g_off[name], rtol=1e-5,
                                   atol=1e-7)


def test_eval_step_scores_in_eval_mode(jax_side, batch):
    """The eval step switches a model left in training mode to eval and
    returns its softmax scores (their parity with JAX: test_torch_mvit)."""
    _, _, params = jax_side
    x, _ = batch
    _, model = _port_model(params, act_checkpoint=True)
    model.train()
    out = tsteps.make_eval_step(model)({"inputs": torch.from_numpy(x)})
    assert not model.training
    with torch.no_grad():
        torch.testing.assert_close(out, model(torch.from_numpy(x)))
    torch.testing.assert_close(out.sum(-1), torch.ones(B))


# ------------------------------------------------------------------ pieces

def test_losses_match_jax():
    rng = np.random.default_rng(30)
    logits = rng.standard_normal((5, 18)).astype(np.float32) * 3
    labels = rng.integers(0, 18, 5).astype(np.int32)
    soft = rng.random((5, 18)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    for red in ("mean", "none"):
        np.testing.assert_allclose(
            tlosses.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels), red).numpy(),
            np.asarray(jlosses.cross_entropy(logits, labels, red)),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            tlosses.soft_cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(soft), red).numpy(),
            np.asarray(jlosses.soft_cross_entropy(logits, soft, red)),
            rtol=1e-6, atol=1e-6)
    assert tlosses._SOFT_TARGET_LOSSES == jlosses._SOFT_TARGET_LOSSES
    with pytest.raises(NotImplementedError):
        tlosses.get_loss_func("lsep")


@pytest.mark.parametrize("policy", ["cosine", "steps_with_relative_lrs"])
def test_lr_schedule_matches_jax(policy):
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_file("configs/AICITY_MVITV2_B_16x4_448.yaml")
        cfg.SOLVER.LR_POLICY = policy
        cfg.SOLVER.STEPS = [0, 30, 60]
        cfg.SOLVER.LRS = [1.0, 0.1, 0.01]
    jsched = jlr.make_lr_schedule(jcfg.SOLVER, 50)
    psched = tlr.make_lr_schedule(pcfg.SOLVER, 50)
    # over the warmup (15 epochs), the cosine / steps and past MAX_EPOCH
    for step in (0, 1, 100, 749, 750, 751, 1500, 3000, 4999, 5000, 5200):
        np.testing.assert_allclose(psched(step), float(jsched(step)),
                                   rtol=1e-6, err_msg=str(step))
        assert tlr.get_lr_at_epoch(pcfg.SOLVER, step / 50) == \
            pytest.approx(jlr.get_lr_at_epoch(jcfg.SOLVER, step / 50),
                          rel=1e-12)


@pytest.mark.parametrize("method", ["adamw", "sgd"])
def test_optimizer_step_matches_optax(method):
    """Clip by global norm, then AdamW (decoupled decay scaled by the LR)
    or SGD with nesterov momentum; zero decay for 1-D params and biases."""
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_file("configs/AICITY_MVITV2_B_16x4_448.yaml")
        cfg.SOLVER.OPTIMIZING_METHOD = method
        cfg.SOLVER.WEIGHT_DECAY = 0.05
        cfg.SOLVER.BASE_LR = 0.1
        cfg.SOLVER.WARMUP_START_LR = 0.05
    rng = np.random.default_rng(31)
    params = {"fc": {"kernel": rng.standard_normal((4, 3)).astype(np.float32),
                     "bias": rng.standard_normal(3).astype(np.float32)},
              "norm": {"scale": rng.standard_normal(3).astype(np.float32)}}
    tx, _ = jopt.construct_optimizer(jcfg, params, 2)
    state = tx.init(params)
    model = torch.nn.Module()
    model.fc = torch.nn.Linear(4, 3)
    model.norm = torch.nn.Module()
    model.norm.weight = torch.nn.Parameter(torch.zeros(3))
    with torch.no_grad():
        model.fc.weight.copy_(torch.from_numpy(params["fc"]["kernel"].T))
        model.fc.bias.copy_(torch.from_numpy(params["fc"]["bias"]))
        model.norm.weight.copy_(torch.from_numpy(params["norm"]["scale"]))
    opt = topt.construct_optimizer(pcfg, model, 2)
    assert [len(g["params"]) for g in opt.opt.param_groups] == [1, 2]
    jp = params
    for i in range(3):
        g = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * (2.0 if i == 0 else 0.1))
            .astype(np.float32), params)
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        model.fc.weight.grad = torch.tensor(g["fc"]["kernel"].T)
        model.fc.bias.grad = torch.tensor(g["fc"]["bias"])
        model.norm.weight.grad = torch.tensor(g["norm"]["scale"])
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)),
                                   rtol=1e-6)
        np.testing.assert_allclose(model.fc.weight.detach().numpy(),
                                   np.asarray(jp["fc"]["kernel"]).T,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(model.fc.bias.detach().numpy(),
                                   np.asarray(jp["fc"]["bias"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(model.norm.weight.detach().numpy(),
                                   np.asarray(jp["norm"]["scale"]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_mixup_matches_jax_for_its_draw(seed):
    """The mixed clip and soft targets for the draw the JAX mixup makes
    from a key (the seeds cover both branches and a clipped box)."""
    kw = dict(num_classes=18, mixup_alpha=0.8, cutmix_alpha=1.0,
              mix_prob=1.0, switch_prob=0.5, label_smoothing=0.1)
    rng = np.random.default_rng(32)
    x = rng.standard_normal((3, 2, 12, 10, 3)).astype(np.float32)
    y = np.array([1, 7, 17], np.int32)
    key = jax.random.PRNGKey(seed)
    ref_x, ref_t = jmix.make_mixup_fn(**kw)(key, jnp.asarray(x),
                                             jnp.asarray(y))
    cfg = get_cfg()
    draw = _replay_mixup_draw(cfg, key, (12, 10))
    out_x, out_t = tmix.make_mixup_fn(**kw)(torch.from_numpy(x),
                                            torch.from_numpy(y), draw=draw)
    np.testing.assert_allclose(out_x.numpy(), np.asarray(ref_x), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_t), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("lam", [0.3, 0.9, 0.05])
def test_cutmix_box_matches_jax(lam):
    """The box and the area-corrected lambda for the centre JAX draws."""
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ry, rx = jax.random.split(key)
        cy = int(jax.random.randint(ry, (), 0, 12))
        cx = int(jax.random.randint(rx, (), 0, 10))
        mask, lam_corr = jmix._cutmix_mask_and_lam(key, (12, 10),
                                                   jnp.float32(lam))
        (yl, yh, xl, xh), plam = tmix.cutmix_box((12, 10), lam, cy, cx)
        ours = np.zeros((12, 10), bool)
        ours[yl:yh, xl:xh] = True
        np.testing.assert_array_equal(ours, np.asarray(mask))
        assert plam == pytest.approx(float(lam_corr), abs=1e-6)


def test_mixup_draws_come_from_the_generator():
    fn = tmix.make_mixup_fn(num_classes=4)
    a = fn.draw(np.random.default_rng([0, 3]), (8, 8))
    b = fn.draw(np.random.default_rng([0, 3]), (8, 8))
    c = fn.draw(np.random.default_rng([0, 4]), (8, 8))
    assert a == b and a != c
    assert dataclasses.asdict(a).keys() == {
        "apply", "use_cutmix", "lam_mix", "lam_cut", "cy", "cx"}


def test_drop_path_scales_kept_samples_by_one_over_keep():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(4000, 2, 3)
    mask = drop_path_mask(4000, 0.25, gen, "cpu", torch.float32)
    out = drop_path(x, mask, 0.25)
    kept = out[:, 0, 0] != 0
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    assert drop_path_mask(4, 0.0, gen, "cpu", torch.float32) is None
    assert drop_path(x, None, 0.25) is x


def test_training_path_feeds_the_kernels_contiguous_rows(monkeypatch):
    """The kernels take contiguous token rows; the training path makes the
    pooled q, k, v contiguous head-major rows even for one head, where a
    reshape alone would return a strided view."""
    from aicity_action_tpu_torch.models import mvit as tmvit

    seen = []

    def checking(fn):
        def wrapped(*args, **kw):
            seen.append(all(a.is_contiguous() for a in args
                            if isinstance(a, torch.Tensor)))
            return fn(*args, **kw)
        return wrapped

    for name in ("flash_attention", "fused_layer_norm"):
        monkeypatch.setattr(tmvit, name, checking(getattr(tmvit, name)))
    cfg = _train_cfg(get_cfg, act_checkpoint=False)
    model = build_model(cfg, device="cpu").train()
    assert model.blocks[0].attn.num_heads == 1
    model(torch.zeros(1, 4, 32, 32, 3)).sum().backward()
    assert len(seen) == 4 * 4 and all(seen)
