"""The port's MoE MViT (``aicity_action_tpu_torch/models/moe.py``) against
the JAX package's (``aicity_action_tpu/models/moe.py``): the index-form
routing expanded to the JAX one-hots, the MoE MLP, the tiny MoE MViT's
forward, the SGD step with the load-balance loss, the loss under
activation checkpointing, and the build-time refusal."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.engine import steps as jsteps
from aicity_action_tpu.models import moe as jmoe
from aicity_action_tpu.models import mvit as jmvit
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.engine import steps as tsteps
from aicity_action_tpu_torch.models import moe as tmoe
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.solver import optimizer as topt
from aicity_action_tpu_torch.utils.convert import jax_tree_to_named
from torch_port_helpers import moe_cfg, moe_params_to_jax, perturb
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _layer(rng, D, H, E, O=None, scale=0.5):
    """One bank's params, numpy: the port's names and layout."""
    O = O or D
    n = rng.standard_normal
    return {"ln_weight": (1.0 + 0.1 * n(D)).astype(np.float32),
            "ln_bias": (0.1 * n(D)).astype(np.float32),
            "router": (scale * n((E, D))).astype(np.float32),
            "fc1_weight": (scale * n((E, H, D))).astype(np.float32),
            "fc1_bias": (0.1 * n((E, H))).astype(np.float32),
            "fc2_weight": (scale * n((E, O, H))).astype(np.float32),
            "fc2_bias": (0.1 * n((E, O))).astype(np.float32)}


def _to_jax(p):
    return {"ln_scale": jnp.asarray(p["ln_weight"]),
            "ln_bias": jnp.asarray(p["ln_bias"]),
            "router": jnp.asarray(p["router"].T),
            "fc1": {"kernel": jnp.asarray(p["fc1_weight"].transpose(0, 2, 1)),
                    "bias": jnp.asarray(p["fc1_bias"])},
            "fc2": {"kernel": jnp.asarray(p["fc2_weight"].transpose(0, 2, 1)),
                    "bias": jnp.asarray(p["fc2_bias"])}}


@pytest.mark.parametrize("cf", [0.5, 1.25, 2.0])
@pytest.mark.parametrize("top_k", [1, 2])
def test_index_routing_expands_to_the_jax_one_hots(top_k, cf):
    """Dispatch exactly, combine and the load-balance loss within 1e-6,
    dropped (token, slot)s included (capacity factor 0.5 drops)."""
    rng = np.random.default_rng(10 * top_k + int(4 * cf))
    B, L, D, E = 3, 40, 8, 4
    xn = rng.standard_normal((B, L, D)).astype(np.float32)
    wr = rng.standard_normal((E, D)).astype(np.float32)
    C = tmoe.MoESpec(E, top_k, cf).capacity(L)
    r = tmoe.route(torch.from_numpy(xn), torch.from_numpy(wr), top_k, C)
    disp, comb = tmoe.dense_routing(r)
    jd, jc, jaux = jax.vmap(lambda t: jmoe.router_dispatch(
        t, jnp.asarray(wr.T), top_k=top_k, capacity=C))(jnp.asarray(xn))
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jd))
    np.testing.assert_allclose(comb.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(float(r.aux), float(np.asarray(jaux).mean()),
                               atol=1e-6)
    kept = int(r.keep.sum())
    assert kept == int(np.asarray(jd).sum())
    if cf == 0.5:
        assert kept < B * L * top_k  # some (token, slot)s dropped
    assert C == jmoe.MoESpec(num_experts=E, top_k=top_k,
                             capacity_factor=cf).capacity(L)


@pytest.mark.parametrize("top_k,cf", [(1, 1.0), (2, 1.25), (2, 0.4)])
def test_moe_apply_matches_jax(top_k, cf):
    rng = np.random.default_rng(3)
    B, L, D, H, E = 2, 24, 8, 16, 4
    p = _layer(rng, D, H, E)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    y, aux = tmoe.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), top_k=top_k,
                            capacity_factor=cf)
    jy, jaux = jmoe.moe_apply(_to_jax(p), jnp.asarray(x), top_k=top_k,
                              capacity_factor=cf)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    """The tiny MoE MViT-v2 of both packages on one set of weights: the
    port's draw from seed 0 plus numpy noise (so that norms matter)."""
    model = build_model(moe_cfg(get_cfg), device="cpu")
    params = perturb(moe_params_to_jax(model.state_dict()), 1)
    named = jax_tree_to_named(params)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in named.items()},
                          strict=True)
    jcfg = moe_cfg(jax_get_cfg)
    return jcfg, params, model


def _clip(seed, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, 4, 32, 32, 3)).astype(np.float32)


def test_moe_mvit_forward_matches_jax(pair):
    jcfg, params, model = pair
    assert [b.moe for b in jmvit.build_mvit_spec(jcfg).blocks] == [
        False, True, False, True]
    module = jmvit.MViT(spec=jmvit.build_mvit_spec(jcfg))
    x = _clip(4)
    want = np.asarray(jax.jit(lambda p, t: module.apply(
        {"params": p}, t, train=False))(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    assert len(model.moe_aux) == 2


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _stash_grads():
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


def _deterministic(cfg):
    """No DropPath, no head dropout: the packages draw different masks."""
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.MODEL.DROPOUT_RATE = 0.0
    return cfg


@pytest.mark.parametrize("weight", [0.0, 10.0])
def test_sgd_step_with_the_load_balance_loss_matches_jax(pair, x64, weight):
    """One SGD step in f64 on both sides (the routing and its pre-LN in
    f32, as both packages compute them): the loss (cross entropy plus
    ``weight`` x the mean of the two banks' losses) and every gradient,
    the routers' included."""
    jcfg, params, _ = pair
    jcfg = _deterministic(jcfg.clone())
    spec = jmvit.build_mvit_spec(jcfg)
    module = jmvit.MViT(spec=spec, dtype=jnp.float64,
                        param_dtype=jnp.float64)
    p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
    x = _clip(5).astype(np.float64)
    y = np.array([3, 11], np.int32)
    tx = optax.chain(_stash_grads(), optax.sgd(0.1))
    step = jax.jit(jsteps.make_train_step(module, tx, "cross_entropy",
                                          moe_aux_weight=weight))
    state = jsteps.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, p64), tx)
    state, metrics, _ = step(state, {"inputs": jnp.asarray(x),
                                     "labels": jnp.asarray(y)},
                             jax.random.PRNGKey(0))
    want = jax_tree_to_named(jax.tree_util.tree_map(np.asarray,
                                                    state.opt_state[0]))
    pcfg = _deterministic(moe_cfg(get_cfg))
    model = build_model(pcfg, device="cpu").double()
    model.compute_dtype = torch.float64
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           jax_tree_to_named(p64).items()})
    opt = topt.TrainOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                              lambda s: 0.1)
    pstep = tsteps.make_train_step(model, opt, "cross_entropy",
                                   moe_aux_weight=weight)
    got, _ = pstep({"inputs": torch.from_numpy(x),
                    "labels": torch.from_numpy(y)})
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]),
                               rtol=1e-6)
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g, rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    router = np.abs(want["blocks.1.mlp.router"]).max()
    assert router > 1e-6


def test_checkpointed_step_counts_the_load_balance_loss_once():
    """Under ``MODEL.ACT_CHECKPOINT`` the recompute runs each bank's
    forward again in the backward: the loss holds each bank's term once,
    the routers get the gradient they get without checkpointing, and that
    gradient is not zero."""
    x = torch.from_numpy(_clip(6))
    y = torch.tensor([1, 7])
    out = {}
    for remat in (False, True):
        cfg = moe_cfg(get_cfg)
        cfg.MODEL.ACT_CHECKPOINT = remat
        model = build_model(cfg, device="cpu", seed=2)
        opt = topt.TrainOptimizer(torch.optim.SGD(model.parameters(), lr=0.),
                                  lambda s: 0.0)
        step = tsteps.make_train_step(model, opt, "cross_entropy",
                                      moe_aux_weight=5.0)
        metrics, _ = step({"inputs": x, "labels": y})
        assert len(model.moe_aux) == 2
        out[remat] = (float(metrics["loss"]),
                      {n: p.grad.clone() for n, p in model.named_parameters()
                       if n.endswith("mlp.router")})
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    for name, g in out[False][1].items():
        assert float(g.abs().max()) > 0.0, name
        torch.testing.assert_close(out[True][1][name], g, rtol=1e-5,
                                   atol=1e-7)


def test_moe_on_a_block_that_changes_channels_is_refused():
    """The JAX rule (``mvit.py:214-222``): without channel expansion in
    front, a block whose MLP changes the width keeps its dense MLP."""
    from aicity_action_tpu_torch.models.mvit import build_mvit_spec

    for get in (get_cfg, jax_get_cfg):
        cfg = moe_cfg(get)
        cfg.MVIT.CHANNEL_EXPAND_FRONT = False
        cfg.MVIT.MOE.LAYERS = [0]
        build = (build_mvit_spec if get is get_cfg
                 else jmvit.build_mvit_spec)
        with pytest.raises(ValueError, match="changes channels"):
            build(cfg)
        cfg.MVIT.MOE.LAYERS = [1]
        assert build(cfg).blocks[1].moe


def test_the_spec_reads_the_moe_section():
    from aicity_action_tpu_torch.models.mvit import build_mvit_spec

    for depth in (4, 16):
        cfg, jcfg = moe_cfg(get_cfg), moe_cfg(jax_get_cfg)
        for c in (cfg, jcfg):
            c.MVIT.DEPTH = depth
            c.MVIT.MOE.CAPACITY_FACTOR = 2.0
        ps, js = build_mvit_spec(cfg), jmvit.build_mvit_spec(jcfg)
        assert [b.moe for b in ps.blocks] == [b.moe for b in js.blocks]
        assert ps.moe.layers == js.moe.layers == tuple(range(1, depth, 2))
        assert (ps.moe.num_experts, ps.moe.top_k, ps.moe.capacity_factor) \
            == (js.moe.num_experts, js.moe.top_k, js.moe.capacity_factor)


def test_run_temporal_inf_scores_with_the_moe_override(tmp_path):
    """``run_temporal_inf ... MVIT.MOE.ENABLE True`` builds the MoE model
    and writes the windows that ``WindowScorer`` gives with it."""
    from aicity_action_tpu_torch.data.decoder import write_y4m
    from aicity_action_tpu_torch.pipeline import window_inference as twi
    from aicity_action_tpu_torch.tools import run_temporal_inf
    from torch_port_helpers import YAML, synthetic_i420

    write_y4m(str(tmp_path / "clip.y4m"), synthetic_i420(40))
    (tmp_path / "videos.txt").write_text("clip.y4m\n")
    opts = ["DATA.NUM_FRAMES", "4", "MVIT.DEPTH", "4", "MVIT.EMBED_DIM",
            "32", "MVIT.DIM_MUL", "[[1, 2.0], [3, 2.0]]", "MVIT.HEAD_MUL",
            "[[1, 2.0], [3, 2.0]]", "MVIT.POOL_Q_STRIDE",
            "[[1, 1, 2, 2], [3, 1, 2, 2]]", "TPU.COMPUTE_DTYPE", "float32",
            "NUM_GPUS", "1", "MVIT.MOE.ENABLE", "True",
            "MVIT.MOE.NUM_EXPERTS", "4"]
    run_temporal_inf.main([
        "--cfg", YAML, "--video_lst", str(tmp_path / "videos.txt"),
        "--video_path", str(tmp_path), "--out_dir", str(tmp_path / "out"),
        "--frame_length", "4", "--frame_size", "32", "--batch_size", "4",
        "--num_workers", "0", "--device", "cpu", *opts])
    cfg = moe_cfg(get_cfg)
    cfg.MODEL.ACT_CHECKPOINT = True  # the YAML's; eval does not remat
    model = build_model(cfg, device="cpu")
    assert sum(b.moe for b in model.blocks) == 2
    want = twi.WindowScorer(model, batch_size=4).score_video(
        twi.WindowDataset(str(tmp_path / "clip.y4m"), frame_length=4,
                          frame_stride=4, proposal_stride=16,
                          frame_size=32))
    got = twi.load_window_predictions(str(tmp_path / "out" / "clip.pkl"))
    assert len(got) == len(want) > 0
    assert [p[:2] for p in got] == [p[:2] for p in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[2], w[2], atol=1e-6)
