"""Expert and tensor parallelism of the port (``parallel/{ep,tp}.py``,
``parallel/mesh.py``'s named axes) on two gloo ranks, against the JAX
package computed in this process: ``ep_moe_apply`` against the dense
``moe_apply`` (outputs and gradients), the expert-parallel SGD step
against the JAX step on the global batch, the Megatron placements against
``mvit_param_shardings``, and the dp x tp AdamW step at MViT-B's stage-4
geometry against the JAX step."""

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
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.parallel import tp as ptp
from aicity_action_tpu_torch.utils.convert import jax_tree_to_named
from torch_port_helpers import (WORLD, collect_ranks, moe_cfg,
                                moe_params_to_jax, perturb, start_ranks)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

TOP_K, CF, LR, CLIP, AUX = 2, 1.0, 0.1, 0.5, 10.0


def _layer(rng, D=8, H=16, E=4):
    n = rng.standard_normal
    return {"ln_weight": (1.0 + 0.1 * n(D)).astype(np.float32),
            "ln_bias": (0.1 * n(D)).astype(np.float32),
            "router": (0.5 * n((E, D))).astype(np.float32),
            "fc1_weight": (0.5 * n((E, H, D))).astype(np.float32),
            "fc1_bias": (0.1 * n((E, H))).astype(np.float32),
            "fc2_weight": (0.5 * n((E, D, H))).astype(np.float32),
            "fc2_bias": (0.1 * n((E, D))).astype(np.float32)}


def stage4_cfg(get):
    """MViT-B's stage-4 geometry (``tests/test_tp_realistic.py``): dim
    768, 8 heads, thw (8, 14, 14), depth 2, AdamW; no DropPath."""
    cfg = get()
    cfg.MODEL.MODEL_NAME = "MViT"
    cfg.MODEL.NUM_CLASSES = 18
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.MODEL.ACT_CHECKPOINT = False
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.DATA.NUM_FRAMES = 16
    cfg.DATA.INPUT_CHANNEL_NUM = [3]
    m = cfg.MVIT
    m.EMBED_DIM, m.NUM_HEADS, m.DEPTH = 768, 8, 2
    m.PATCH_PADDING = (1, 3, 3)
    m.DIM_MUL, m.HEAD_MUL, m.POOL_Q_STRIDE = [], [], []
    m.POOL_KVQ_KERNEL = [3, 3, 3]
    m.POOL_KV_STRIDE_ADAPTIVE = [1, 2, 2]
    m.CLS_EMBED_ON, m.SEP_POS_EMBED = False, True
    m.DROPPATH_RATE = 0.0
    cfg.MIXUP.ENABLE = False
    cfg.SOLVER.OPTIMIZING_METHOD = "adamw"
    cfg.SOLVER.BASE_LR = 1e-3
    cfg.SOLVER.WARMUP_EPOCHS = 0.0
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def _ep_cfg(get):
    cfg = moe_cfg(get)
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.MODEL.DROPOUT_RATE = 0.0
    return cfg


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One two-rank job for every case of the file, started before the JAX
    oracles are computed so that the two overlap."""
    rng = np.random.default_rng(0)
    layer = _layer(rng)
    x = rng.standard_normal((4, 24, 8)).astype(np.float32)
    cot = rng.standard_normal((4, 24, 8)).astype(np.float32)
    model = build_model(_ep_cfg(get_cfg), device="cpu")
    params = perturb(moe_params_to_jax(model.state_dict()), 1)
    state = {k: torch.from_numpy(v.astype(np.float64))
             for k, v in jax_tree_to_named(params).items()}
    clip = np.random.default_rng(2).standard_normal(
        (4, 4, 32, 32, 3))
    labels = np.array([3, 11, 0, 7], np.int32)
    scfg = stage4_cfg(get_cfg)
    smodel = build_model(scfg, device="cpu", seed=5)
    sclip = np.random.default_rng(3).standard_normal(
        (2, 16, 56, 56, 3)).astype(np.float32)
    slabels = np.array([4, 9], np.int32)
    job = {"kind": "ep_tp", "cfg": _ep_cfg(get_cfg),
           "moe": {"params": layer, "x": x, "cot": cot, "top_k": TOP_K,
                   "cf": CF},
           "ep_step": {"cfg": _ep_cfg(get_cfg), "state": state, "lr": LR,
                       "clip": CLIP, "aux_weight": AUX,
                       "batch": (clip, labels)},
           "tp_step": {"cfg": scfg, "steps_per_epoch": 10,
                       "state": smodel.state_dict(),
                       "batch": (sclip, slabels)},
           "half": {"x": rng.standard_normal((4, 6, 3)).astype(np.float32)}}
    handle = start_ranks(job, tmp_path_factory.mktemp("ep_tp"))
    return {"handle": handle, "half": job["half"]["x"], "layer": layer,
            "x": x, "cot": cot,
            "params": params, "clip": clip, "labels": labels,
            "scfg": scfg, "smodel": smodel, "sclip": sclip,
            "slabels": slabels}


@pytest.fixture(scope="module")
def results(ranks):
    return collect_ranks(ranks["handle"])


def _jax_layer(p):
    return {"ln_scale": jnp.asarray(p["ln_weight"]),
            "ln_bias": jnp.asarray(p["ln_bias"]),
            "router": jnp.asarray(p["router"].T),
            "fc1": {"kernel": jnp.asarray(p["fc1_weight"].transpose(0, 2, 1)),
                    "bias": jnp.asarray(p["fc1_bias"])},
            "fc2": {"kernel": jnp.asarray(p["fc2_weight"].transpose(0, 2, 1)),
                    "bias": jnp.asarray(p["fc2_bias"])}}


def test_ep_moe_apply_matches_the_dense_layer(ranks, results):
    """Each rank's rows of the output, the load-balance loss (the mean
    over ranks), the input's gradient, and every leaf's gradient summed
    over ranks (a bank leaf's only in the rank's own slice),
    against the JAX dense layer under ``sum(y cot) + WORLD x aux`` (the
    sum of the ranks' losses)."""
    layer, x, cot = ranks["layer"], ranks["x"], ranks["cot"]

    def loss(p, t):
        y, aux = jmoe.moe_apply(p, t, top_k=TOP_K, capacity_factor=CF)
        return (y * cot).sum() + WORLD * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(_jax_layer(layer),
                                            jnp.asarray(x))
    outs = [r["moe"] for r in results]
    np.testing.assert_allclose(np.concatenate([o["y"] for o in outs]),
                               np.asarray(y), rtol=1e-5, atol=1e-5)
    for o in outs:
        assert o["aux"] == pytest.approx(float(aux), abs=1e-6)
    np.testing.assert_allclose(np.concatenate([o["dx"] for o in outs]),
                               np.asarray(gx), rtol=1e-4, atol=1e-5)
    want = {"ln_weight": gp["ln_scale"], "ln_bias": gp["ln_bias"],
            "router": np.asarray(gp["router"]).T,
            "fc1_weight": np.asarray(gp["fc1"]["kernel"]).transpose(0, 2, 1),
            "fc1_bias": gp["fc1"]["bias"],
            "fc2_weight": np.asarray(gp["fc2"]["kernel"]).transpose(0, 2, 1),
            "fc2_bias": gp["fc2"]["bias"]}
    for k, w in want.items():
        # a bank leaf's gradient is zero outside the rank's slice
        got = sum(o["grads"][k] for o in outs)
        if k.startswith("fc"):
            for r, o in enumerate(outs):
                other = np.delete(np.arange(4), np.arange(2 * r, 2 * r + 2))
                assert not np.abs(o["grads"][k][other]).any(), k
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        assert np.abs(np.asarray(w)).max() > 1e-4, k


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _stash_grads():
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


def test_ep_step_matches_the_jax_step_on_the_global_batch(ranks, results,
                                                          x64):
    """One f64 SGD step (momentum, clipping by the global norm, the
    load-balance loss at weight 10) with each rank holding 2 of the 4
    experts of each bank and 2 of the 4 clips: the loss, the gradient
    norm, each rank's expert slices' gradients and the replicated
    gradients against the JAX step, and the optimizer's state placed with
    its parameters."""
    jcfg = _ep_cfg(jax_get_cfg)
    module = jmvit.MViT(spec=jmvit.build_mvit_spec(jcfg), dtype=jnp.float64,
                        param_dtype=jnp.float64)
    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                 ranks["params"])
    tx = optax.chain(_stash_grads(), optax.clip_by_global_norm(CLIP),
                     optax.sgd(LR, momentum=0.9))
    step = jax.jit(jsteps.make_train_step(module, tx, "cross_entropy",
                                          moe_aux_weight=AUX))
    state, metrics, _ = step(
        jsteps.TrainState.create(p64, tx),
        {"inputs": jnp.asarray(ranks["clip"]),
         "labels": jnp.asarray(ranks["labels"])}, jax.random.PRNGKey(0))
    grads = jax_tree_to_named(jax.tree_util.tree_map(np.asarray,
                                                     state.opt_state[0]))
    after = jax_tree_to_named(jax.tree_util.tree_map(np.asarray,
                                                     state.params))
    outs = [r["ep_step"] for r in results]
    for o in outs:
        assert o["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-6)
        assert o["grad_norm"] == pytest.approx(float(metrics["grad_norm"]),
                                               rel=1e-6)
        assert o["grad_norm"] > CLIP  # the clip acted
    clip = min(1.0, CLIP / float(metrics["grad_norm"]))  # port: clipped
    for name, g in grads.items():
        g = g * clip
        bank = name.rsplit(".", 1)[-1] in ("fc1_weight", "fc1_bias",
                                           "fc2_weight", "fc2_bias")
        for r, o in enumerate(outs):
            want = (np.split(g, WORLD)[r] if bank else g)
            np.testing.assert_allclose(o["grads"][name], want, rtol=1e-4,
                                       atol=1e-7, err_msg=name)
            pw = (np.split(after[name], WORLD)[r] if bank else after[name])
            np.testing.assert_allclose(o["params"][name], pw, rtol=1e-6,
                                       atol=1e-7, err_msg=name)
            assert o["placements"][name] == (0 if bank else None), name
            assert set(o["state"][name].values()) == {
                "expert slice" if bank else "replicated"}, name
    assert np.abs(grads["blocks.1.mlp.router"]).max() > 1e-6


def test_tp_placements_hit_the_jax_sharded_names():
    """At dim 768 the split weights are exactly the leaves the JAX
    ``mvit_param_shardings`` shards, on the same features: output features
    (torch dim 0) where JAX shards a kernel's columns, input features
    (dim 1) where it shards its rows."""
    from jax.sharding import Mesh, PartitionSpec as P

    from aicity_action_tpu.parallel.tp import mvit_param_shardings
    from aicity_action_tpu_torch.models.mvit import MViT, build_mvit_spec

    cfg = stage4_cfg(jax_get_cfg)
    module = jmvit.MViT(spec=jmvit.build_mvit_spec(cfg))
    shapes = jax.eval_shape(
        lambda k: module.init(k, jnp.zeros((1, 16, 56, 56, 3)))["params"],
        jax.random.PRNGKey(0))
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    specs = jax.tree_util.tree_leaves(
        mvit_param_shardings(mesh, shapes),
        is_leaf=lambda s: hasattr(s, "spec"))
    dims = {(None, "model"): 0, ("model", None): 1}
    by_jax = {}
    for (path, leaf), sh in zip(
            jax.tree_util.tree_flatten_with_path(shapes)[0], specs):
        one = node = {}
        keys = [str(getattr(k, "key", k)) for k in path]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.zeros((1,) * len(leaf.shape))
        (name,) = jax_tree_to_named(one)
        by_jax[name] = dims.get(tuple(sh.spec))
        assert isinstance(sh.spec, P)
    with torch.device("meta"):
        model = MViT(build_mvit_spec(stage4_cfg(get_cfg)))
    got = ptp.tp_placements(model)
    assert got == by_jax
    assert sorted(k for k, v in got.items() if v is not None) == sorted(
        f"blocks.{i}.{leaf}" for i in range(2) for leaf in (
            "attn.qkv.weight", "attn.proj.weight", "mlp.fc1.weight",
            "mlp.fc2.weight"))


def test_dp_tp_step_at_stage4_geometry_matches_the_plain_step(ranks,
                                                               results):
    """One AdamW step on a (1 data x 2 model) mesh against the JAX
    package's plain (one-device) step on the same weights and clips: the
    loss, the global gradient norm (each piece counted once) and each
    rank's pieces of the gradients; each rank's pieces of the parameters
    after the step against the JAX AdamW (``construct_optimizer``) applied
    to the ranks' gradients (a first Adam step is ``lr g / (|g| + eps)``,
    which a gradient's last bits move where ``|g|`` is near ``eps``). The
    split weights lie empty between steps and their moments are split as
    they are."""
    from aicity_action_tpu.models.build import build_module
    from aicity_action_tpu.solver import optimizer as jopt
    from aicity_action_tpu.utils.convert import convert_mvit_state_dict

    def jax_tree(named):
        tree, skipped = convert_mvit_state_dict(named)
        assert not skipped
        return jax.tree_util.tree_map(jnp.asarray, tree)

    jcfg = stage4_cfg(jax_get_cfg)
    module, _ = build_module(jcfg)
    params = jax_tree({k: v.numpy() for k, v in
                       ranks["smodel"].state_dict().items()})
    tx, _ = jopt.construct_optimizer(jcfg, params, 10)
    step = jax.jit(jsteps.make_train_step(
        module, optax.chain(_stash_grads(), tx), jcfg.MODEL.LOSS_FUNC,
        num_classes=jcfg.MODEL.NUM_CLASSES))
    state, metrics, _ = step(
        jsteps.TrainState.create(params, optax.chain(_stash_grads(), tx)),
        {"inputs": jnp.asarray(ranks["sclip"]),
         "labels": jnp.asarray(ranks["slabels"])}, jax.random.PRNGKey(0))
    grads = jax_tree_to_named(jax.tree_util.tree_map(np.asarray,
                                                     state.opt_state[0]))
    named = dict(ranks["smodel"].named_parameters())
    dims = {n: ptp.placement(n, p) for n, p in named.items()}
    outs = [res["tp_step"] for res in results]
    # the ranks' gradients whole, through the JAX AdamW
    port_grads = {n: (np.concatenate([o["grads"][n] for o in outs], d)
                      if d is not None else outs[0]["grads"][n])
                  for n, d in dims.items()}
    updates, _ = tx.update(jax_tree(port_grads), tx.init(params), params)
    after = jax_tree_to_named(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, updates)))
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["loss"], float(metrics["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(o["grad_norm"],
                                   float(metrics["grad_norm"]), rtol=1e-4)
        assert set(o["params"]) == set(o["grads"]) == set(grads) == set(dims)
        for name, d in dims.items():
            g, want = grads[name], after[name]
            if d is not None:
                g = np.split(g, WORLD, axis=d)[r]
                want = np.split(want, WORLD, axis=d)[r]
            np.testing.assert_allclose(o["grads"][name], g, rtol=1e-4,
                                       atol=1e-6, err_msg=name)
            np.testing.assert_allclose(o["params"][name], want, rtol=1e-6,
                                       atol=1e-7, err_msg=name)
        assert set(o["whole_at_rest"].values()) == {(0,)}
        assert len(o["whole_at_rest"]) == 8
        for name, st in o["state"].items():
            assert set(st.values()) == {dims[name]}, name
    for name in ("blocks.0.attn.qkv.weight", "blocks.1.mlp.fc2.weight"):
        assert np.abs(grads[name]).max() > 1e-6, name  # the split ones act


def test_bf16_goes_through_the_collectives_exactly(ranks, results):
    """The gather, the all-to-all and the halo exchange of bf16 rows (the
    card's activations) equal the same moves of the rounded values: the
    one collective form reduces them as f32, exactly."""
    x = torch.from_numpy(ranks["half"]).to(torch.bfloat16).float().numpy()
    rows = [x[r::WORLD] for r in range(WORLD)]
    for r, res in enumerate(results):
        got = res["half"]
        np.testing.assert_array_equal(got["gather"], np.concatenate(rows))
        np.testing.assert_array_equal(  # split dim 1, stack dim 0
            got["all_to_all"],
            np.concatenate([np.split(p, WORLD, 1)[r] for p in rows], 0))
        edge = np.full_like(rows[r][:1], -np.inf)
        np.testing.assert_array_equal(
            got["above"], rows[r - 1][-1:] if r > 0 else edge)
        np.testing.assert_array_equal(
            got["below"], rows[r + 1][:1] if r < WORLD - 1 else edge)


def test_draws_cover_the_data_ranks_alone():
    """A step's dropout draws (``dp_rand``) with its generator's data
    ranks: rank ``i`` of a 2-rank data axis keeps rows ``[3i, 3i + 3)`` of
    the axis's 6-row draw, whatever the group's size; without ranks, the
    group's (one process here) rows."""
    from aicity_action_tpu_torch.parallel import mesh

    def draw(data, rows=3):
        g = mesh.RowGenerator(data=data)
        g.manual_seed(4)
        return mesh.dp_rand((rows, 2), g, "cpu")

    def plain(rows):
        return torch.rand((rows, 2), generator=torch.Generator().manual_seed(4))

    for i in range(2):
        got = draw(mesh.DataRanks(None, 2, i))
        torch.testing.assert_close(got, plain(6)[3 * i:3 * i + 3], rtol=0,
                                   atol=0)
        x = torch.arange(6.0)
        assert mesh.local_rows(x, mesh.DataRanks(None, 2, i)).tolist() == \
            x[3 * i:3 * i + 3].tolist()
    torch.testing.assert_close(draw(None), plain(3), rtol=0, atol=0)
    assert mesh.data_ranks() == (None, 1, 0)
