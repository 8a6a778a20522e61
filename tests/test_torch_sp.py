"""Sequence parallelism of the port (``parallel/{sp,sp_model}.py``) on two
gloo ranks against the JAX package computed in this process: the halo
pools against the dense pools (both grid axes, every pool mode), the
one-block pooled attention, ``plan_sp_blocks`` against the JAX plan, and
the whole sharded forward (H and T axes, cls token on and off, the
hand-off to dense blocks, the fallback where the grid does not divide)
against the JAX ``MViT.apply`` logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.models import mvit as jmvit
from aicity_action_tpu.parallel import sp as jsp
from aicity_action_tpu.parallel import sp_model as jsp_model
from aicity_action_tpu_torch.config import get_cfg, mvitv2_b_16x4_448_cfg
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.models.mvit import build_mvit_spec
from aicity_action_tpu_torch.parallel import sp_model
from aicity_action_tpu_torch.utils.convert import jax_params_to_state_dict
from torch_port_helpers import (WORLD, collect_ranks,
                                jax_tiny_params_from_port, moe_cfg, perturb,
                                start_ranks, tiny_cfg, tiny_v1_cfg, YAML)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

# (mode, kernel, stride) of the JAX package's tests/test_sequence_parallel.py
POOLS = [("conv", (3, 5, 5), (1, 2, 2)), ("conv", (5, 3, 3), (1, 1, 1)),
         ("max", (3, 3, 3), (2, 2, 2)), ("avg", (3, 3, 3), (1, 1, 1))]
# (name, cls token, channel expansion in front, crop, shard axis)
MODELS = [("h", False, True, 32, "h"), ("h hand-off", False, True, 48, "h"),
          ("h no fit", False, True, 36, "h"), ("h cls", True, False, 32, "h"),
          ("t", False, True, 32, "t"), ("t cls", True, False, 32, "t")]


def sp_cfg(get, cls_on=False, expand_front=True, crop=32):
    """The JAX package's full-model SP test config
    (``tests/test_sp_full_model.py:_cfg``): embed 16, 2 heads, 8 frames,
    q pooling at blocks 1 and 2, adaptive kv strides; logits in f32."""
    cfg = get()
    cfg.MODEL.MODEL_NAME = "MViT"
    cfg.MODEL.ARCH = "mvit"
    cfg.MODEL.NUM_CLASSES = 5
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.MODEL.ACT_CHECKPOINT = False
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = crop
    cfg.DATA.NUM_FRAMES = 8
    cfg.DATA.INPUT_CHANNEL_NUM = [3]
    m = cfg.MVIT
    m.EMBED_DIM, m.DEPTH, m.NUM_HEADS = 16, 4, 2
    m.PATCH_PADDING = (1, 3, 3)
    m.DIM_MUL, m.HEAD_MUL = [[1, 2.0]], [[1, 2.0]]
    m.POOL_KVQ_KERNEL = [3, 3, 3]
    m.POOL_KV_STRIDE_ADAPTIVE = [1, 2, 2]
    m.POOL_Q_STRIDE = [[1, 1, 2, 2], [2, 1, 2, 2]]
    m.CLS_EMBED_ON = cls_on
    m.SEP_POS_EMBED = True
    m.CHANNEL_EXPAND_FRONT = expand_front
    m.Q_POOL_ALL = True
    m.Q_POOL_RESIDUAL = True
    m.DROPPATH_RATE = 0.0
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def _model_case(i, cls_on, expand_front, crop):
    def make(get):
        return sp_cfg(get, cls_on, expand_front, crop)

    params = perturb(jax_tiny_params_from_port(i, make), i + 10)
    clip = np.random.default_rng(i).standard_normal(
        (2, 8, crop, crop, 3)).astype(np.float32)
    return make, params, clip


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One two-rank job for every case of the file, started before the JAX
    oracles are computed."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 16, 8)).astype(np.float32)  # NCTHW
    pools = []
    for dim in (2, 3):
        for mode, kernel, stride in POOLS:
            w = (rng.standard_normal((8, 1, *kernel)).astype(np.float32)
                 if mode == "conv" else None)
            pools.append((mode, kernel, stride, dim, x, w))
    ax = rng.standard_normal((2, 2, 16, 8, 8)).astype(np.float32)
    r = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)  # noqa
    ap = {"ln_weight": 1 + r(8), "ln_bias": r(8), "qkv_weight": r(24, 8),
          "qkv_bias": r(24), "proj_weight": r(8, 8), "proj_bias": r(8),
          **{f"pool_{n}": r(8, 1, 3, 3, 3) for n in "qkv"},
          **{f"norm_{n}_{k}": (1 + r(8) if k == "weight" else r(8))
             for n in "qkv" for k in ("weight", "bias")}}
    cases, models = {}, []
    for i, (name, cls_on, front, crop, axis) in enumerate(MODELS):
        key = (cls_on, front, crop)
        if key not in cases:
            cases[key] = _model_case(len(cases), *key)
        make, params, clip = cases[key]
        models.append((name, make(get_cfg), jax_params_to_state_dict(params),
                       clip, axis))
    job = {"kind": "sp", "pools": pools, "attention": (ax, ap),
           "models": models}
    handle = start_ranks(job, tmp_path_factory.mktemp("sp"))
    return {"handle": handle, "pools": pools, "attention": (ax, ap),
            "cases": cases, "logits": {}}


@pytest.fixture(scope="module")
def results(ranks):
    return collect_ranks(ranks["handle"])


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("case", range(len(POOLS)))
def test_halo_pools_match_the_dense_pools(ranks, results, case, dim):
    """Each pool of a volume sharded on T (dim 2) or H (dim 3) against the
    JAX dense op on the whole volume: the ranks' shards concatenate to
    it (halos of 1 and 2, zero and ``-inf`` fills, the average counting
    its padding)."""
    from aicity_action_tpu.ops.pooling import depthwise_conv3d, pool3d

    i = case + (len(POOLS) if dim == 3 else 0)
    mode, kernel, stride, _, x, w = ranks["pools"][i]
    xj = jnp.asarray(x.transpose(0, 2, 3, 4, 1))
    pad = tuple(k // 2 for k in kernel)
    if mode == "conv":
        want = depthwise_conv3d(xj, jnp.asarray(w.transpose(2, 3, 4, 1, 0)),
                                stride, pad)
    else:
        want = pool3d(xj, mode, kernel, stride, pad)
    got = np.concatenate([r["pools"][i] for r in results], axis=dim)
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 4, 1, 2, 3),
                               atol=1e-5, rtol=1e-5)


def test_pooled_attention_matches_the_jax_sharded_block(ranks, results):
    """``sp_pooled_attention`` on two H shards against the JAX function
    under ``shard_map`` on two devices."""
    from jax.sharding import Mesh, PartitionSpec as P

    try:
        from jax.experimental.shard_map import shard_map
    except ImportError:
        from jax.sharding import shard_map
    x, p = ranks["attention"]
    jp = {"ln_scale": p["ln_weight"], "ln_bias": p["ln_bias"],
          "qkv_w": p["qkv_weight"].T, "qkv_b": p["qkv_bias"],
          "proj_w": p["proj_weight"].T, "proj_b": p["proj_bias"],
          **{f"pool_{n}_w": p[f"pool_{n}"].transpose(2, 3, 4, 1, 0)
             for n in "qkv"},
          **{f"norm_{n}_{'scale' if k == 'weight' else k}":
             p[f"norm_{n}_{k}"] for n in "qkv" for k in ("weight", "bias")}}
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("seq",))
    f = shard_map(lambda xl, pp: jsp.sp_pooled_attention(
        xl, (2, 8, 8), pp, axis_name="seq", stride_q=1, stride_kv=4),
        mesh=mesh, in_specs=(P(None, None, "seq"), P()),
        out_specs=P(None, None, "seq"))
    want = np.asarray(jax.jit(f)(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, jp)))
    got = np.concatenate([r["attention"] for r in results], axis=2)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("shard_axis", ["h", "t"])
def test_plan_matches_jax(shard_axis):
    """The blocks that run sharded, for the tiny specs of this file and
    the tests' helpers, and for MViT-v2-B @448, over 2, 4 and 8 shards."""
    from aicity_action_tpu.config import get_cfg as jget

    makes = [lambda g: sp_cfg(g), lambda g: sp_cfg(g, crop=48),
             lambda g: sp_cfg(g, True, False), tiny_cfg, tiny_v1_cfg]
    plans = []
    for make in makes:
        ps, js = build_mvit_spec(make(get_cfg)), jmvit.build_mvit_spec(
            make(jget))
        for n in (2, 4, 8):
            assert sp_model.plan_sp_blocks(ps, n, shard_axis) == \
                jsp_model.plan_sp_blocks(js, n, shard_axis), (make, n)
    jcfg = jget()
    jcfg.merge_from_file(YAML)
    ps = build_mvit_spec(mvitv2_b_16x4_448_cfg())
    js = jmvit.build_mvit_spec(jcfg)
    for n in (2, 4, 8):
        got = sp_model.plan_sp_blocks(ps, n, shard_axis)
        assert got == jsp_model.plan_sp_blocks(js, n, shard_axis)
        plans.append(got)
    if shard_axis == "t":
        assert plans == [16, 16, 16]  # T frames: every block sharded
    else:
        assert plans[0] == 16 and plans[1] < 16  # H: 2-way only


def _jax_logits(make, params, clip):
    """The JAX ``MViT.apply`` logits (training mode without DropPath or
    dropout: the head's activation applies at eval only)."""
    module = jmvit.MViT(spec=jmvit.build_mvit_spec(make(jax_get_cfg)))
    fn = jax.jit(lambda p, x: module.apply(
        {"params": p}, x, train=True,
        rngs={"dropout": jax.random.PRNGKey(0),
              "droppath": jax.random.PRNGKey(1)}))
    return np.asarray(fn(params, jnp.asarray(clip)))


@pytest.mark.parametrize("case", [m[0] for m in MODELS])
def test_sharded_forward_matches_jax_logits(ranks, results, case):
    name, cls_on, front, crop, axis = next(m for m in MODELS
                                           if m[0] == case)
    make, params, clip = ranks["cases"][(cls_on, front, crop)]
    plan = sp_model.plan_sp_blocks(build_mvit_spec(make(get_cfg)), WORLD,
                                   axis)
    assert plan == {"h hand-off": 2, "h no fit": 0}.get(name, 4)
    key = (cls_on, front, crop)  # the H and T cases share the JAX model
    if key not in ranks["logits"]:
        ranks["logits"][key] = _jax_logits(make, params, clip)
    want = ranks["logits"][key]
    for r in results:
        np.testing.assert_allclose(r["models"][name], want, atol=2e-5,
                                   rtol=1e-4)


def test_moe_is_refused():
    model = build_model(moe_cfg(get_cfg), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        sp_model.sp_apply(model, torch.zeros(1, 4, 32, 32, 3), None)


@pytest.mark.parametrize("cls_on", [False, True])
def test_dense_embed_matches_jax(ranks, cls_on):
    """The patch embed and position embeddings the sharded forward slices
    (the cls token's row apart), against the JAX ``dense_embed``."""
    make, params, clip = ranks["cases"][(cls_on, not cls_on, 32)]
    model = build_model(make(get_cfg), device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params))
    with torch.no_grad():
        grid, cls = sp_model.dense_embed(model, torch.from_numpy(clip))
    jgrid, jcls = jsp_model.dense_embed(
        params, jmvit.build_mvit_spec(make(jax_get_cfg)), jnp.asarray(clip))
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), atol=2e-5,
                               rtol=1e-5)
    assert (cls is None) == (jcls is None) == (not cls_on)
    if cls_on:
        np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=2e-5)
