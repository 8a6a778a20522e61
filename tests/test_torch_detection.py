"""The port's detection models and steps against the JAX package, on the
CPU: the RoI head (``models/roi_head.py``), the RoI heads of the tiny Slow
ResNet and SlowFast (f64 on both sides, 1e-9: the JAX package's conv
tests' widths, where f32 programs differ by far more than their error),
the tiny MViT-v2's RoI head and spatial-maxpool head (f32, 2e-5), the
detection train step against ``make_detection_train_step`` (SGD; loss rtol
1e-4, parameters rtol 1e-4 / atol 1e-5), ``WindowScorer(detection=True)``
against the JAX scorer on a written view (2e-5), the detection models'
names through both converters and the zoo's example inputs. Weights cross
as in the other port tests: the port model's ``state_dict`` through the
JAX package's converters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.models import mvit as jmvit
from aicity_action_tpu.models import resnet_models as jconv
from aicity_action_tpu.models.roi_head import ResNetRoIHead as JaxRoIHead
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.engine.detection import (
    flatten_boxes, make_detection_eval_step, make_detection_train_step)
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.models.roi_head import ResNetRoIHead
from aicity_action_tpu_torch.solver import optimizer as topt
from aicity_action_tpu_torch.utils.convert import (jax_params_to_state_dict,
                                                   jax_tree_to_named)
from test_torch_convnets import inputs, jax_variables, tiny_conv_cfg
from torch_port_helpers import (jax_tiny_params_from_port, perturb,
                                tiny_cfg)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

M = 3  # boxes a clip's slab in these tests
CLASSES = 18


def _boxes(batch, size, seed):
    """``[batch, M, 4]`` boxes inside a ``size`` crop, the last of each
    clip's slab all zero (a padded row), and its mask."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, size * 0.6, (batch, M, 2))
    wh = rng.uniform(2, size * 0.4, (batch, M, 2))
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes[:, -1] = 0.0
    mask = np.ones((batch, M), np.float32)
    mask[:, -1] = 0.0
    return boxes, mask


def test_roi_head_matches_jax():
    """Two pathways of different frame counts and widths, boxes partly past
    the map and a zero box; the activation in training mode too."""
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((2, 3, 4, 4, 6)).astype(np.float32),
          rng.standard_normal((2, 5, 4, 4, 2)).astype(np.float32)]
    boxes = np.array([[0, 2, 3, 40, 50], [1, 0, 0, 64, 64],
                      [0, 10, 10, 30, 20], [1, 0, 0, 0, 0]], np.float32)
    head = ResNetRoIHead([6, 2], 5, [7, 7], [16, 16])
    with torch.no_grad():
        head.projection.weight.normal_(generator=torch.Generator()
                                       .manual_seed(1))
        head.projection.bias.uniform_(-1, 1)
    v = {"params": {"projection": {
        "kernel": head.projection.weight.detach().numpy().T,
        "bias": head.projection.bias.detach().numpy()}}}
    jhead = JaxRoIHead(num_classes=5, pool_size=((3, 1, 1), (5, 1, 1)),
                       resolution=(7, 7), scale_factor=(16, 16))
    want = np.asarray(jax.jit(lambda v, x, b: jhead.apply(v, x, b))(
        v, [jnp.asarray(x) for x in xs], jnp.asarray(boxes)))
    for train in (False, True):
        got = head.train(train)([torch.from_numpy(x) for x in xs],
                                torch.from_numpy(boxes))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=2e-6)


def _det_conv_cfg(get, name, arch):
    cfg = tiny_conv_cfg(get, name, arch)
    cfg.DETECTION.ENABLE = True
    cfg.DETECTION.SPATIAL_SCALE_FACTOR = 32  # the tiny nets' 2x2 res5 map
    cfg.MODEL.HEAD_ACT = "sigmoid"
    cfg.MODEL.LOSS_FUNC = "bce"
    return cfg


@pytest.mark.parametrize("name,arch", [("ResNet", "slow"),
                                       ("SlowFast", "slowfast")])
def test_conv_net_roi_heads_match_jax(name, arch):
    """The Slow ResNet's and SlowFast's detection forwards, f64 on both
    sides (both RoIAligns then run in f64)."""
    model = build_model(_det_conv_cfg(get_cfg, name, arch), device="cpu",
                        seed=3).double()
    model.compute_dtype = torch.float64
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                               jax_variables(model))
    xs = [x.astype(np.float64) for x in inputs(name)]
    boxes, _ = _boxes(2, 64, 4)
    boxes5 = flatten_boxes(torch.from_numpy(boxes))
    with jax.enable_x64(True):
        module = getattr(jconv, name)(
            cfg_frozen=_det_conv_cfg(jax_get_cfg, name, arch).to_dict(),
            dtype=jnp.float64)
        want = np.asarray(jax.jit(
            lambda v, x, b: module.apply(v, x, b, train=False))(
                v, [jnp.asarray(x) for x in xs], boxes5.numpy()))
    with torch.no_grad():
        got = model([torch.from_numpy(x) for x in xs], boxes5)
    assert got.shape == (2 * M, 5) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


def _det_mvit_cfg(get, maxpool=False, resolution=7):
    """The tiny MViT-v2 (``tiny_cfg``) with the RoI head (its final 2x2 map
    is at stride 16) or the spatial-maxpool head, sigmoid scores, BCE, no
    DropPath or dropout, SGD as in test_torch_train.py."""
    cfg = tiny_cfg(get)
    cfg.MODEL.ACT_CHECKPOINT = False
    cfg.MODEL.HEAD_ACT = "sigmoid"
    cfg.MODEL.LOSS_FUNC = "bce"
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.DETECTION.ENABLE = not maxpool
    cfg.DETECTION.USE_SPATIAL_MAXPOOL_BEFORE_PROJ = maxpool
    cfg.DETECTION.SPATIAL_SCALE_FACTOR = 16
    cfg.DETECTION.ROI_XFORM_RESOLUTION = resolution
    cfg.SOLVER.OPTIMIZING_METHOD = "sgd"
    cfg.SOLVER.WARMUP_START_LR = 0.25
    cfg.SOLVER.BASE_LR = 0.5
    cfg.SOLVER.WARMUP_EPOCHS = 1.0
    return cfg


def _mvit_pair(seed=0, **kw):
    """The JAX module and numpy params, and the port model with the same
    weights (the port's draw from ``seed`` plus noise)."""
    params = perturb(jax_tiny_params_from_port(
        seed, make_cfg=lambda get: _det_mvit_cfg(get, **kw)), seed + 7)
    module = jmvit.MViT(spec=jmvit.build_mvit_spec(
        _det_mvit_cfg(jax_get_cfg, **kw)), dtype=jnp.float32)
    model = build_model(_det_mvit_cfg(get_cfg, **kw), device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return module, params, model


def _clips(batch, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch, 4, 32, 32, 3)).astype(np.float32)


def test_mvit_roi_head_matches_jax():
    module, params, model = _mvit_pair()
    x = _clips(2, 5)
    boxes, _ = _boxes(2, 32, 6)
    boxes5 = flatten_boxes(torch.from_numpy(boxes).float())
    want = np.asarray(jax.jit(lambda p, x, b: module.apply(
        {"params": p}, x, b, train=False))(params, x, boxes5.numpy()))
    got = make_detection_eval_step(model)({
        "inputs": torch.from_numpy(x), "boxes": torch.from_numpy(boxes)})
    assert got.shape == (2 * M, CLASSES)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("resolution", [1, 7])
def test_mvit_spatial_maxpool_head_matches_jax(resolution):
    """The whole-frame head: the 2x2 map shrunk to 1x1 (``jax.image.
    resize`` antialiases) or grown to 7x7."""
    module, params, model = _mvit_pair(maxpool=True, resolution=resolution)
    x = _clips(2, 7)
    want = np.asarray(jax.jit(lambda p, x: module.apply(
        {"params": p}, x, train=False))(params, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_antialiased_resize_matches_jax_at_448_shapes():
    """The spatial-maxpool head's resize at the 448 model's 14 -> 7."""
    import torch.nn.functional as F

    fm = np.random.default_rng(8).standard_normal((2, 14, 14, 5)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(fm, (2, 7, 7, 5), method="bilinear"))
    got = F.interpolate(torch.from_numpy(fm).permute(0, 3, 1, 2), size=(7, 7),
                        mode="bilinear", align_corners=False, antialias=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


def test_cls_token_detection_raises():
    from torch_port_helpers import tiny_v1_cfg

    cfg = tiny_v1_cfg(get_cfg)
    cfg.DETECTION.ENABLE = True
    with pytest.raises(ValueError, match="cls-token"):
        build_model(cfg, device="cpu")


def test_detection_train_steps_match_jax():
    """Two SGD steps on 2 clips of 3 boxes (one padded) with multi-hot
    labels: the masked BCE on the head's probabilities, clipping and the
    update."""
    from aicity_action_tpu.engine.detection import \
        make_detection_train_step as jax_step
    from aicity_action_tpu.engine.steps import TrainState
    from aicity_action_tpu.solver import optimizer as jopt

    module, params, model = _mvit_pair(seed=1)
    x = _clips(2, 9)
    boxes, mask = _boxes(2, 32, 10)
    labels = (np.random.default_rng(11).uniform(size=(2, M, CLASSES))
              < 0.2).astype(np.float32)
    batch = {"inputs": x, "boxes": boxes.astype(np.float32),
             "box_mask": mask, "labels": labels}
    jcfg = _det_mvit_cfg(jax_get_cfg)
    tx, _ = jopt.construct_optimizer(jcfg, params, 2)
    state = TrainState.create(params, tx)
    step = jax.jit(jax_step(module, tx, "bce"))
    ref = []
    for _ in range(2):
        state, metrics, _ = step(state, jax.tree_util.tree_map(
            jnp.asarray, batch), jax.random.PRNGKey(0))
        ref.append((float(metrics["loss"]), jax_tree_to_named(
            jax.tree_util.tree_map(np.asarray, state.params))))

    opt = topt.construct_optimizer(_det_mvit_cfg(get_cfg), model, 2)
    tstep = make_detection_train_step(model, opt, "bce")
    named = dict(model.named_parameters())
    for loss, want in ref:
        metrics, preds = tstep({k: torch.from_numpy(v)
                                for k, v in batch.items()})
        assert preds.shape == (2 * M, CLASSES)
        assert not bool(metrics["loss_is_nan"])
        np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=1e-4)
        assert set(want) == set(named)
        for name, p in want.items():
            np.testing.assert_allclose(named[name].detach().numpy(), p,
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_detection_scorer_matches_jax(tmp_path):
    """``WindowScorer(detection=True)`` scores one whole-frame box a window
    through the window-streaming path, u8 frames normalized on the device,
    as the JAX scorer does; the loader path gives the same scores."""
    from aicity_action_tpu.parallel.mesh import make_mesh
    from aicity_action_tpu.pipeline import window_inference as jwi
    from aicity_action_tpu_torch.pipeline import window_inference as twi
    from torch_port_helpers import write_mp4

    module, params, model = _mvit_pair(seed=2)
    path = str(tmp_path / "view.mp4")
    write_mp4(path, num_frames=40, size=(64, 48), seed=3)
    args = dict(frame_length=4, frame_stride=2, proposal_stride=8,
                frame_size=32)
    ref = jwi.WindowScorer(
        module, params, make_mesh(devices=jax.devices()[:1]), batch_size=3,
        num_workers=1, detection=True,
    ).score_video(jwi.WindowDataset(path, **args))
    ds = twi.WindowDataset(path, **args)
    scorer = twi.WindowScorer(model, batch_size=3, detection=True)
    preds = scorer.score_video(ds)
    assert scorer.last_timers is None  # not the device-gather path
    assert [p[:2] for p in preds] == [p[:2] for p in ref] == ds.windows
    # the loader path (window by window) scores the same boxes
    loaded = twi.WindowScorer(model, batch_size=3, num_workers=0,
                              detection=True).score_video(ds, streaming=False)
    for a, b, c in zip(preds, ref, loaded):
        assert a[2].dtype == np.float32 and a[2].shape == (CLASSES,)
        np.testing.assert_allclose(a[2], b[2], rtol=0, atol=2e-5)
        np.testing.assert_allclose(c[2], b[2], rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", ["ResNet", "SlowFast", "MViT"])
def test_detection_state_dicts_round_trip_through_the_jax_names(name):
    """The RoI head's ``head.projection`` crosses both converters, so one
    init drives both packages (and a JAX checkpoint loads into the
    port)."""
    from aicity_action_tpu.utils import convert as jconvert
    from aicity_action_tpu_torch.utils import convert as tconvert

    if name == "MViT":
        model = build_model(_det_mvit_cfg(get_cfg), device="cpu")
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        params, skipped = jconvert.convert_mvit_state_dict(sd)
        back = tconvert.jax_params_to_state_dict(params)
    else:
        arch = "slow" if name == "ResNet" else "slowfast"
        model = build_model(_det_conv_cfg(get_cfg, name, arch), device="cpu")
        v = jax_variables(model)
        skipped = []
        back = tconvert.jax_convnet_to_state_dict(v["params"],
                                                  v["batch_stats"])
    ref = model.state_dict()
    assert skipped == [] and set(back) == set(ref)
    assert "head.projection.weight" in ref
    for k, t in ref.items():
        np.testing.assert_array_equal(back[k].numpy(), t.numpy(), err_msg=k)


@pytest.mark.parametrize("name", ["ResNet", "SlowFast", "MViT"])
def test_example_inputs_match_the_jax_zoo(name):
    """``models/build.py:example_inputs`` gives the JAX zoo's example
    shapes (the clip or pathway clips, then one box row), and a detection
    model's FLOPs count runs on them."""
    from aicity_action_tpu.models.build import build_module
    from aicity_action_tpu_torch.models.build import example_inputs
    from aicity_action_tpu_torch.utils.misc import get_flop_stats

    if name == "MViT":
        make = _det_mvit_cfg
    else:
        arch = "slow" if name == "ResNet" else "slowfast"

        def make(get):
            return _det_conv_cfg(get, name, arch)
    args = example_inputs(make(get_cfg))
    _, want = build_module(make(jax_get_cfg))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), want)
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), args,
                                 is_leaf=torch.is_tensor)
    assert jax.tree_util.tree_leaves(got) == jax.tree_util.tree_leaves(shapes)
    model = build_model(make(get_cfg), device="cpu")
    assert get_flop_stats(model, args) > 0
