"""Pipeline parallelism of the port (``parallel/pp.py``): the block
schedule, FLOP counts and stage split against the JAX package's, the
stages' parameters, and ``MViTPipeline``'s inference and GPipe training
against the JAX package's plain forward and step (f64), with the
gradients invariant to the number of microbatches under DropPath."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.engine import steps as jsteps
from aicity_action_tpu.models import mvit as jmvit
from aicity_action_tpu.parallel import pp as jpp
from aicity_action_tpu.utils.convert import convert_mvit_state_dict
from aicity_action_tpu_torch.config import get_cfg, mvitv2_b_16x4_448_cfg
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.models.mvit import build_mvit_spec
from aicity_action_tpu_torch.parallel import pp
from aicity_action_tpu_torch.utils.convert import jax_tree_to_named
from torch_port_helpers import YAML, moe_cfg, tiny_cfg, tiny_v1_cfg
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _specs():
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(YAML)
    out = [(build_mvit_spec(mvitv2_b_16x4_448_cfg()),
            jmvit.build_mvit_spec(jcfg))]
    for make in (tiny_cfg, tiny_v1_cfg):
        out.append((build_mvit_spec(make(get_cfg)),
                    jmvit.build_mvit_spec(make(jax_get_cfg))))
    return out


def test_schedule_flops_and_split_match_jax():
    for ps, js in _specs():
        sched = pp.thw_schedule(ps)
        assert sched == jpp.thw_schedule(js)
        for i in range(len(ps.blocks)):
            assert pp.block_flops(ps, i, sched[i]) == jpp.block_flops(
                js, i, sched[i])
        for n in range(1, min(len(ps.blocks), 5) + 1):
            assert pp.split_pp_stages(ps, n) == jpp.split_pp_stages(js, n)


def _cfg(droppath=0.0, make=tiny_cfg, get=get_cfg):
    cfg = make(get)
    cfg.MODEL.ACT_CHECKPOINT = False
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.MVIT.DROPPATH_RATE = droppath
    return cfg


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _stash_grads():
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


def _f64_model(make, seed):
    model = build_model(_cfg(make=make), device="cpu", seed=seed).double()
    model.compute_dtype = torch.float64
    return model


def _jax_reference(make, model, x, y, lr):
    """The JAX package's f64 MViT on ``model``'s weights: the eval head's
    probabilities on ``x``, and one SGD(``lr``) step's loss, gradients
    and parameters after it, by name."""
    params, skipped = convert_mvit_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    assert not skipped
    params = jax.tree_util.tree_map(jnp.asarray, params)
    module = jmvit.MViT(
        spec=jmvit.build_mvit_spec(_cfg(make=make, get=jax_get_cfg)),
        dtype=jnp.float64, param_dtype=jnp.float64)
    probs = jax.jit(lambda p, clip: module.apply({"params": p}, [clip],
                                                 train=False))(params, x)
    tx = optax.chain(_stash_grads(), optax.sgd(lr))
    step = jax.jit(jsteps.make_train_step(module, tx, "cross_entropy"))
    state, metrics, _ = step(jsteps.TrainState.create(params, tx),
                             {"inputs": jnp.asarray(x),
                              "labels": jnp.asarray(y)},
                             jax.random.PRNGKey(0))

    def named(tree):
        return jax_tree_to_named(jax.tree_util.tree_map(np.asarray, tree))

    return (np.asarray(probs), float(metrics["loss"]),
            named(state.opt_state[0]), named(state.params))


def _batch(b=4):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((b, 4, 32, 32, 3))
                         .astype(np.float32))
    return x, torch.tensor([1, 7, 3, 11][:b])


def test_stage_params_split_the_model():
    model = build_model(_cfg(), device="cpu")
    spec = model.spec
    ranges = pp.split_pp_stages(spec, 2)
    state = model.state_dict()
    parts = pp.split_stage_params(state, spec, ranges)
    assert sum(len(p) for p in parts) == len(state)
    assert pp.merge_stage_params(parts).keys() == state.keys()
    assert "patch_embed.proj.weight" in parts[0]
    assert "head.projection.weight" in parts[1]
    assert all(k.startswith(tuple(f"blocks.{i}." for i in range(*ranges[s])))
               or not k.startswith("blocks.")
               for s, p in enumerate(parts) for k in p)


@pytest.mark.parametrize("make", [tiny_cfg, tiny_v1_cfg])
def test_pipeline_matches_the_plain_forward_and_step(make, x64):
    """Two stages, two microbatches, f64, against the JAX package's plain
    model on the same weights: the logits against its eval forward's (the
    head's softmax), the loss and every gradient against its train step
    on the whole batch."""
    model = _f64_model(make, seed=1)
    x, y = _batch()
    x = x.double()
    probs, ref_loss, ref_grads, _ = _jax_reference(make, model, x.numpy(),
                                                   y.numpy(), 0.5)
    pipe = pp.MViTPipeline(model, ["cpu", "cpu"])
    got = pipe.apply(x, n_microbatches=2)
    np.testing.assert_allclose(torch.softmax(got, -1).numpy(), probs,
                               rtol=0, atol=1e-6)
    loss = pipe.loss_and_grads(x, y, n_microbatches=2)
    assert float(loss) == pytest.approx(ref_loss, rel=1e-6)
    named = dict(model.named_parameters())
    assert set(named) == set(ref_grads)
    for name, g in ref_grads.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g, rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert np.abs(ref_grads["blocks.0.attn.qkv.weight"]).max() > 1e-4


def test_gradients_do_not_depend_on_microbatches_under_droppath():
    out = {}
    for M in (1, 2, 4):
        model = build_model(_cfg(droppath=0.4), device="cpu", seed=2)
        pipe = pp.MViTPipeline(model, ["cpu", "cpu", "cpu"])
        x, y = _batch()
        loss = pipe.loss_and_grads(x, y, M, torch.Generator().manual_seed(9))
        out[M] = (float(loss), {n: p.grad.clone()
                                for n, p in model.named_parameters()})
    model = build_model(_cfg(droppath=0.4), device="cpu", seed=2)
    nodrop = float(pp.MViTPipeline(model, ["cpu"]).loss_and_grads(*_batch()))
    assert out[1][0] != pytest.approx(nodrop, rel=1e-4)  # masks acted
    for M in (2, 4):
        assert out[M][0] == pytest.approx(out[1][0], rel=1e-5)
        for name, g in out[1][1].items():
            torch.testing.assert_close(out[M][1][name], g, rtol=1e-4,
                                       atol=1e-6, msg=name)


def test_opt_step_steps_each_stage(x64):
    """Each stage's own SGD over its parameters, f64: the merged
    parameters after one step against the JAX package's plain step."""
    model = _f64_model(tiny_cfg, seed=4)
    x, y = _batch()
    x = x.double()
    *_, after = _jax_reference(tiny_cfg, model, x.numpy(), y.numpy(), 0.5)
    pipe = pp.MViTPipeline(model, ["cpu", "cpu"])
    pipe.init_optimizer(lambda ps: torch.optim.SGD(ps, lr=0.5))
    assert [len(o.param_groups[0]["params"]) for o in pipe.optimizers] == [
        len(p) for p in pipe.stage_params]
    pipe.opt_step(x, y, n_microbatches=2)
    merged = pipe.merged_params()
    assert set(merged) == set(after)
    for name, p in after.items():
        np.testing.assert_allclose(merged[name].numpy(), p, rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_moe_is_refused():
    model = build_model(moe_cfg(get_cfg), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        pp.MViTPipeline(model, ["cpu", "cpu"])
