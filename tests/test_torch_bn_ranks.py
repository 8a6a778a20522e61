"""The BatchNorm conv nets' train step at one and two ranks, and precise BN,
against the JAX package on a 2-device mesh, whose BatchNorm statistics are
the global batch's (``models/convnets.py:1-13``).

Cases: a SlowFast with plain BatchNorm (global batch 4), and a Slow ResNet
with SubBatchNorm of 3 splits over a global batch of 6, so that split 1
(rows 2-3) spans the two ranks' rows (0-2 and 3-5). The two ranks are one
``torch.multiprocessing.spawn`` of gloo processes
(``tests/torch_dp_worker.py``), started before the JAX compile so that the
two overlap.

These run in f64 on both sides. At the JAX package's tiny widths (a fast
pathway of one channel, BatchNorms over two clips) two correct f32
programs differ by up to 1e-1 relative in some gradients; in f64 the port
and the JAX package agree within 1e-6. Tolerances: loss rtol 1e-6,
gradients, gradient norm and running statistics rtol 1e-5 / atol 1e-6
(both packages take the loss in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.engine.precise_bn import \
    calculate_and_update_precise_bn as jax_precise_bn
from aicity_action_tpu.engine.steps import TrainState
from aicity_action_tpu.engine.steps import make_train_step as jax_train_step
from aicity_action_tpu.models import resnet_models as jmodels
from aicity_action_tpu.parallel.mesh import (batch_sharding, make_mesh,
                                             replicated)
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.engine.precise_bn import \
    calculate_and_update_precise_bn
from aicity_action_tpu_torch.engine.steps import make_train_step
from aicity_action_tpu_torch.solver.optimizer import TrainOptimizer
from aicity_action_tpu_torch.utils import convert as tconvert
from test_torch_convnets import (_assert_tree, inputs, jax_variables,
                                 port_model, tiny_conv_cfg)
from torch_port_helpers import collect_ranks, start_ranks
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

# (name, arch, norm, splits, global batch)
CASES = [("SlowFast", "slowfast", "batchnorm", 2, 4),
         ("ResNet", "slow", "sub_batchnorm", 3, 6)]
IDS = ["slowfast_bn", "slow_sub_bn"]
LR = 1.0
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def f64_model(name, arch, norm, splits):
    model = port_model(name, arch, norm=norm, splits=splits).double()
    model.compute_dtype = torch.float64
    return model


def jax_f64_module(name, arch, norm, splits):
    cls = getattr(jmodels, name)
    cfg = tiny_conv_cfg(jax_get_cfg, name, arch, norm, splits)
    return cls(cfg_frozen=cfg.to_dict(), dtype=jnp.float64)


def f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def case_batch(name, batch):
    xs = [x.astype(np.float64) for x in inputs(name, batch)]
    return xs, np.arange(batch, dtype=np.int64) % 5


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    cases = []
    for name, arch, norm, splits, batch in CASES:
        cases.append({
            "cfg": tiny_conv_cfg(get_cfg, name, arch, norm, splits),
            "state": f64_model(name, arch, norm, splits).state_dict(),
            "lr": LR, "batch": case_batch(name, batch)})
    handle = start_ranks({"kind": "step", "cases": cases},
                         tmp_path_factory.mktemp("bn_ranks"))
    yield handle
    handle[0].kill()


@pytest.fixture(scope="module")
def jax_steps(launched):
    """Each case's JAX SGD step on a 2-device mesh: loss, gradient norm,
    gradients (from the update) and the new ``batch_stats``, as port
    names."""
    mesh = make_mesh(devices=jax.devices()[:2])
    out = []
    for name, arch, norm, splits, batch in CASES:
        v = f64(jax_variables(f64_model(name, arch, norm, splits),
                              sub_bn=norm == "sub_batchnorm"))
        tx = optax.sgd(LR)
        state = jax.device_put(TrainState.create(
            v["params"], tx, {"batch_stats": v["batch_stats"]}),
            replicated(mesh))
        xs, labels = case_batch(name, batch)
        dev = {"inputs": [jax.device_put(x, batch_sharding(mesh))
                          for x in xs],
               "labels": jax.device_put(labels, batch_sharding(mesh))}
        step = jax.jit(jax_train_step(
            jax_f64_module(name, arch, norm, splits), tx, "cross_entropy"))
        with mesh:
            new, metrics, _ = step(state, dev, jax.random.PRNGKey(0))
        grads = jax.tree_util.tree_map(
            lambda a, b: (np.asarray(a) - np.asarray(b)) / LR,
            v["params"], new.params)
        named = tconvert.jax_convnet_to_state_dict(
            grads, f64(new.model_state["batch_stats"]))
        out.append({"loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "named": {k: t.numpy() for k, t in named.items()}})
    return out


@pytest.fixture(scope="module")
def ranks(launched, jax_steps):
    return collect_ranks(launched)


def _check(got_loss, got_norm, grads, stats, want):
    np.testing.assert_allclose(got_loss, want["loss"], rtol=1e-6)
    np.testing.assert_allclose(got_norm, want["grad_norm"], **TOL)
    _assert_tree(grads, {k: want["named"][k] for k in grads}, **TOL)
    assert stats and set(stats) <= set(want["named"])
    _assert_tree(stats, {k: want["named"][k] for k in stats}, **TOL)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_one_rank_step_matches_jax_two_devices(jax_steps, i):
    name, arch, norm, splits, batch = CASES[i]
    model = f64_model(name, arch, norm, splits)
    opt = TrainOptimizer(torch.optim.SGD(model.parameters(), lr=LR),
                         lambda step: LR)
    xs, labels = case_batch(name, batch)
    metrics, _ = make_train_step(model, opt, "cross_entropy")(
        {"inputs": [torch.from_numpy(x) for x in xs],
         "labels": torch.from_numpy(labels)})
    _check(float(metrics["loss"]), float(metrics["grad_norm"]),
           {n: p.grad.numpy() for n, p in model.named_parameters()},
           {k: v.numpy() for k, v in model.state_dict().items()
            if "running" in k}, jax_steps[i])


@pytest.mark.parametrize("rank", range(2))
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_two_rank_step_matches_jax_two_devices(ranks, jax_steps, i, rank):
    """Each rank holds half the global batch; its BatchNorm statistics
    (the SubBatchNorm's split spanning both ranks included), logged loss,
    gradients and running statistics are the global batch's."""
    got = ranks[rank][i]
    _check(got["loss"], got["grad_norm"], got["grads"],
           {k: v for k, v in got["state"].items() if "running" in k},
           jax_steps[i])


def test_precise_bn_matches_jax():
    """Precise BN over 2 of 3 batches: the plain average of each batch's
    statistics (f64)."""
    name, arch, norm, splits, _ = CASES[1]
    model = f64_model(name, arch, norm, splits)
    v = f64(jax_variables(model, sub_bn=True))
    batches = [case_batch(name, 6)[0] for _ in range(3)]
    batches = [[x + s for x in b] for s, b in enumerate(batches)]
    want = jax_precise_bn(
        jax_f64_module(name, arch, norm, splits), v["params"],
        {"batch_stats": v["batch_stats"]},
        iter([[jnp.asarray(x) for x in b] for b in batches]), num_batches=2)
    n = calculate_and_update_precise_bn(
        model, iter([[torch.from_numpy(x) for x in b] for b in batches]),
        num_batches=2)
    assert n == 2 and not model.training
    back = tconvert.jax_convnet_to_state_dict({}, f64(want["batch_stats"]))
    stats = {k: v.numpy() for k, v in model.state_dict().items()
             if "running" in k}
    _assert_tree(stats, {k: v.numpy() for k, v in back.items()}, **TOL)
