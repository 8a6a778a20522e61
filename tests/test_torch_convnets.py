"""The port's BatchNorm conv nets (``models/{convnets,resnet_models}.py``)
against the JAX package's, on the CPU, at the JAX package's own tiny conv
configs (``tests/test_convnets.py:_tiny_cfg``: R50 depths at width 8, 8
frames, crop 64, X3D of C1 8 / C5 32).

Weights cross as they do for MViT: the port model's ``state_dict`` (seeded
numpy noise on every BatchNorm's affine and running statistics) goes
through the JAX package's ``convert_convnet_state_dict`` into the JAX
model, which is built and jitted but never initialized. Tolerances (f32):
eval scores 2e-5. The train steps, at one and two ranks, and precise BN
are in ``test_torch_bn_ranks.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.models.build import build_module
from aicity_action_tpu.utils import convert as jconvert
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.models.convnets import BatchNorm, SubBatchNorm
from aicity_action_tpu_torch.utils import checkpoint as tcu
from aicity_action_tpu_torch.utils import convert as tconvert
from aicity_action_tpu_torch.utils.misc import frozen_bn_stats
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

ARCHS = [("ResNet", "slow"), ("ResNet", "i3d"), ("ResNet", "c2d"),
         ("SlowFast", "slowfast"), ("X3D", "x3d")]
B, T, S = 2, 8, 64


def tiny_conv_cfg(get, name, arch, norm="batchnorm", splits=2):
    """``tests/test_convnets.py:_tiny_cfg`` for either package."""
    cfg = get()
    cfg.MODEL.MODEL_NAME = name
    cfg.MODEL.ARCH = arch
    cfg.MODEL.NUM_CLASSES = 5
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.MODEL.LOSS_FUNC = "cross_entropy"
    cfg.RESNET.DEPTH = 50
    cfg.RESNET.WIDTH_PER_GROUP = 8
    cfg.DATA.NUM_FRAMES = T
    cfg.DATA.TRAIN_CROP_SIZE = S
    cfg.DATA.TEST_CROP_SIZE = S
    cfg.DATA.INPUT_CHANNEL_NUM = [3, 3] if name == "SlowFast" else [3]
    cfg.SLOWFAST.ALPHA = 4
    cfg.SLOWFAST.BETA_INV = 8
    cfg.X3D.DIM_C1 = 8
    cfg.X3D.DIM_C5 = 32
    cfg.BN.NORM_TYPE = norm
    cfg.BN.NUM_SPLITS = splits
    return cfg


def port_model(name, arch, seed=0, norm="batchnorm", splits=2):
    """The port's tiny model, every BatchNorm's scale, bias and running
    statistics drawn from numpy noise."""
    model = build_model(tiny_conv_cfg(get_cfg, name, arch, norm, splits),
                        device="cpu", seed=seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (BatchNorm, SubBatchNorm)):
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -0.2, 0.2),
                                  (m.running_mean, -0.2, 0.2),
                                  (m.running_var, 0.5, 1.5)):
                    t.copy_(torch.from_numpy(
                        rng.uniform(lo, hi, t.shape).astype(np.float32)))
    return model


def _unwrap_sub_bn(tree):
    """The converter's ``<name>/bn/{scale,...}`` -> ``<name>/{scale,...}``:
    a SubBatchNorm keeps its parameters itself."""
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"bn"} and not isinstance(
            next(iter(tree["bn"].values())), dict):
        return tree["bn"]
    return {k: _unwrap_sub_bn(v) for k, v in tree.items()}


def jax_variables(model, sub_bn=False):
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats, skipped = jconvert.convert_convnet_state_dict(sd)
    assert skipped == []
    if sub_bn:
        params, stats = _unwrap_sub_bn(params), _unwrap_sub_bn(stats)
    return {"params": params, "batch_stats": stats}


def inputs(name, batch=B, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (batch, T, S, S, 3)).astype(np.float32)
    if name != "SlowFast":
        return [x]
    return [x[:, np.linspace(0, T - 1, T // 4).astype(np.int64)], x]


def jax_module(name, arch, norm="batchnorm"):
    module, _ = build_module(tiny_conv_cfg(jax_get_cfg, name, arch, norm))
    return module


@pytest.mark.parametrize("name,arch,norm", [
    *((n, a, "batchnorm") for n, a in ARCHS),
    ("ResNet", "c2d", "sub_batchnorm")])
def test_eval_forward_matches_jax(name, arch, norm):
    """Every arch; and a SubBatchNorm of 2 splits, which normalizes with
    its splits' statistics aggregated (mean of the means, mean of the
    variances plus the spread of the means)."""
    model = port_model(name, arch, norm=norm)
    xs = inputs(name)
    module = jax_module(name, arch, norm)
    want = jax.jit(lambda v, x: module.apply(v, x, train=False))(
        jax_variables(model, sub_bn=norm == "sub_batchnorm"),
        [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got = model([torch.from_numpy(x) for x in xs])
    assert got.shape == (B, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def _assert_tree(port_named: dict, jax_named: dict, **tol):
    assert set(port_named) == set(jax_named)
    for k, v in jax_named.items():
        np.testing.assert_allclose(port_named[k], v, err_msg=k, **tol)


def test_batchnorm_keeps_flax_biased_running_variance():
    bn = BatchNorm(3).train()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 2, 3, 3)).astype(np.float32))
    bn(x)
    var = x.transpose(0, 1).reshape(3, -1).var(dim=1, unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(bn.running_mean,
                               0.1 * x.mean(dim=(0, 2, 3, 4)))
    before = bn.running_var.clone()
    frozen_bn_stats(torch.nn.Sequential(bn))(x)
    assert not bn.training and torch.equal(bn.running_var, before)


@pytest.mark.parametrize("name,arch,norm", [
    ("SlowFast", "slowfast", "batchnorm"), ("X3D", "x3d", "batchnorm"),
    ("ResNet", "i3d", "sub_batchnorm")])
def test_state_dict_round_trips_through_the_jax_names(name, arch, norm):
    """PySlowFast names (``s1.pathway0_stem.conv.weight``, ...): the JAX
    converter's trees come back as the port's ``state_dict`` exactly."""
    model = port_model(name, arch, norm=norm)
    sd = model.state_dict()
    assert "s1.pathway0_stem.bn.running_var" in sd
    v = jax_variables(model, sub_bn=norm == "sub_batchnorm")
    back = tconvert.jax_convnet_to_state_dict(v["params"], v["batch_stats"])
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def _c2_name(name: str) -> str:
    """The Caffe2 blob name of a ResNet's port name (the inverse of the
    reference's chain, for the blobs these tests write)."""
    leaf = {"weight": "w", "bias": "b"}
    bn_leaf = {"weight": "s", "bias": "b", "running_mean": "rm",
               "running_var": "riv"}
    parts = name.split(".")
    if parts[:3] == ["s1", "pathway0_stem", "conv"]:
        return "conv1_" + leaf[parts[-1]]
    if parts[:3] == ["s1", "pathway0_stem", "bn"]:
        return "res_conv1_bn_" + bn_leaf[parts[-1]]
    if parts[0] == "head":
        return "pred_" + leaf[parts[-1]]
    stage, res = parts[0][1:], parts[1].split("res")[1]
    mod = parts[2] if parts[2] != "branch2" else "branch2" + parts[3]
    if mod.endswith("_bn"):
        return f"res{stage}_{res}_{mod}_{bn_leaf[parts[-1]]}"
    return f"res{stage}_{res}_{mod}_{leaf[parts[-1]]}"


@pytest.mark.parametrize("kind", ["c2_pkl", "pyth_2d"])
def test_2d_checkpoints_load_as_the_jax_loader_reads_them(kind, tmp_path):
    """A Caffe2 ``.pkl`` (momentum and iteration blobs included) and a 2-D
    ``.pyth`` of the stem, stage s2 and the head, written here: the port
    loads each by shape, inflating the 2-D kernels to the I3D's temporal
    extents, to the values the JAX package's loader converts them to."""
    import pickle

    model = port_model("ResNet", "i3d", seed=4)
    own = model.state_dict()
    rng = np.random.default_rng(9)
    sd2 = {}
    for k, v in own.items():
        if not (k.startswith(("s1.", "s2.", "head.")) and "num_b" not in k):
            continue
        shape = v.shape if v.dim() != 5 else v.shape[:2] + v.shape[3:]
        sd2[k] = rng.standard_normal(shape).astype(np.float32)
    path = str(tmp_path / ("w.pkl" if kind == "c2_pkl" else "w.pyth"))
    if kind == "c2_pkl":
        blobs = {_c2_name(k): v for k, v in sd2.items()}
        blobs.update(model_iter=np.int64(5), lr=np.float32(0.1))
        blobs["conv1_w_momentum"] = np.zeros(1, np.float32)
        with open(path, "wb") as f:
            pickle.dump({"blobs": blobs}, f)
        want_sd = jconvert.load_c2_checkpoint(path)
        assert set(tconvert.load_c2_checkpoint(path)) == set(want_sd)
    else:
        torch.save({"model_state": {k: torch.from_numpy(v)
                                    for k, v in sd2.items()}}, path)
        want_sd = sd2
    shapes = jconvert.flatten_shapes(jax_variables(model)["params"])
    jparams, jstats, _ = jconvert.convert_convnet_state_dict(
        want_sd, model_shapes=shapes)
    loaded, mismatched, _ = tcu.load_torch_checkpoint(path, model)
    assert sorted(loaded) == sorted(sd2) and mismatched == []
    got = jax_variables(model)
    for tree, want in (("params", jparams), ("batch_stats", jstats)):
        flat = jconvert._flatten(got[tree])
        for k, v in jconvert._flatten(want).items():
            np.testing.assert_allclose(flat[k], v, rtol=1e-6, atol=1e-7,
                                       err_msg=str(k))


def test_two_pathway_window_scorer_matches_jax_streaming(tmp_path):
    """A SlowFast scores a written view through the window-streaming path
    (slow and fast clips of every window), as the JAX ``score_video``
    routes a two-pathway model; scores within 2e-5 (f32)."""
    from aicity_action_tpu.parallel.mesh import make_mesh
    from aicity_action_tpu.pipeline import window_inference as jwi
    from aicity_action_tpu_torch.pipeline import window_inference as twi
    from torch_port_helpers import write_mp4

    path = str(tmp_path / "view.mp4")
    write_mp4(path, num_frames=40, size=(64, 48), seed=3)
    args = dict(frame_length=T, frame_stride=2, proposal_stride=8,
                frame_size=S, arch_pathways=2, slowfast_alpha=4)
    model = port_model("SlowFast", "slowfast")
    v = jax_variables(model)
    ref = jwi.WindowScorer(
        jax_module("SlowFast", "slowfast"), v["params"],
        make_mesh(devices=jax.devices()[:1]), batch_size=3, num_workers=1,
        model_state={"batch_stats": v["batch_stats"]},
    ).score_video(jwi.WindowDataset(path, **args))
    ds = twi.WindowDataset(path, **args)
    preds = twi.WindowScorer(model, batch_size=3).score_video(ds)
    assert [p[:2] for p in preds] == [p[:2] for p in ref] == ds.windows
    assert len(preds) == 5 and ds.last_decode_backend is None
    for a, b in zip(preds, ref):
        assert a[2].dtype == np.float32 and a[2].shape == (5,)
        np.testing.assert_allclose(a[2], b[2], rtol=0, atol=2e-5)
