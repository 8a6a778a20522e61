"""``VideoActionClassifier`` of the port against the JAX package's, in f32
on the CPU, on the same ``.pyth`` weights: scores, padding of a short
batch and splitting of a long one within 2e-5, the detection variant's
whole-frame boxes; and the ``torch.export`` round trip (the JAX package's
StableHLO one, ``tests/test_classifier_export.py``) within 1e-5, the
program calling the inference kernels as the ``aicity::*`` custom ops."""

import jax
import numpy as np
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.models import build as jbuild
from aicity_action_tpu.pipeline.classifier import (
    VideoActionClassifier as JaxClassifier)
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.pipeline.classifier import (
    VideoActionClassifier, load_exported)
from torch_port_helpers import tiny_cfg
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _cfg(get, tmp_path, detection=False):
    """The JAX classifier test's depth-2 MViT-v2 of width 16 at crop 32
    (the RoI head on its 4x4 map at stride 8), f32."""
    cfg = tiny_cfg(get)
    m = cfg.MVIT
    m.EMBED_DIM = 16
    m.DEPTH = 2
    m.DIM_MUL = [[1, 2.0]]
    m.HEAD_MUL = [[1, 2.0]]
    m.POOL_Q_STRIDE = [[1, 1, 2, 2]]
    cfg.MODEL.ACT_CHECKPOINT = False
    cfg.MODEL.NUM_CLASSES = 5
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.TRAIN.AUTO_RESUME = False
    cfg.TEST.CHECKPOINT_TYPE = "pytorch"
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    if detection:
        cfg.MODEL.HEAD_ACT = "sigmoid"
        cfg.DETECTION.ENABLE = True
        cfg.DETECTION.SPATIAL_SCALE_FACTOR = 8
    return cfg


def _pyth(tmp_path, detection=False):
    """A ``.pyth`` of the port's tiny model drawn from seed 5."""
    model = build_model(_cfg(get_cfg, tmp_path, detection), device="cpu",
                        seed=5)
    path = str(tmp_path / f"tiny{int(detection)}.pyth")
    torch.save({"model_state": model.state_dict(), "epoch": 1}, path)
    return path


def _jitted_build(cfg, rng=None):
    """The JAX ``build_model_with_state`` with its initializers run as one
    jitted program (op by op they take ~25 s on a CPU); the classifier
    then loads the ``.pyth`` over them as it does."""
    from aicity_action_tpu.models.build import build_module
    from aicity_action_tpu.ops.pallas import flash_attention as fa

    module, example = build_module(cfg)
    args = example if isinstance(example, tuple) else (example,)
    with fa.disabled():
        variables = dict(jax.jit(lambda r: module.lazy_init(
            {"params": r}, *args))(jax.random.PRNGKey(cfg.RNG_SEED)))
    return module, variables.pop("params"), variables


@pytest.mark.parametrize("detection", [False, True])
def test_inference_and_padding_match_jax(tmp_path, detection, monkeypatch):
    monkeypatch.setattr(jbuild, "build_model_with_state", _jitted_build)
    path = _pyth(tmp_path, detection)
    want_clf = JaxClassifier(_cfg(jax_get_cfg, tmp_path, detection), path,
                             batch_size=4)
    clf = VideoActionClassifier(_cfg(get_cfg, tmp_path, detection), path,
                                batch_size=4, device="cpu")
    rs = np.random.RandomState(0)
    x3 = rs.randn(3, 4, 32, 32, 3).astype(np.float32)
    got = clf.inference([x3])
    assert got.shape == (3, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_clf.inference([x3]), rtol=2e-5,
                               atol=2e-5)
    if not detection:
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    # a batch past the fixed size splits; a short one pads
    x9 = rs.randn(9, 4, 32, 32, 3).astype(np.float32)
    got9 = clf.inference([x9])
    assert got9.shape == (9, 5)
    np.testing.assert_allclose(got9, want_clf.inference([x9]), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got9[:3], clf.inference([x9[:3]]), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("detection", [False, True])
def test_export_roundtrip(tmp_path, detection):
    """``export`` then ``exported_path=``: the loaded program's scores
    within 1e-5 of the eager model's, and its graph calls the LN+qkv,
    fused-LN attention, LN+MLP and LayerNorm ops."""
    cfg = _cfg(get_cfg, tmp_path, detection)
    clf = VideoActionClassifier(cfg, _pyth(tmp_path, detection),
                                batch_size=2, device="cpu")
    path = clf.export(str(tmp_path / "model.pt2"))
    x = np.random.RandomState(1).randn(2, 4, 32, 32, 3).astype(np.float32)
    want = clf.inference([x])
    loaded = VideoActionClassifier(cfg, batch_size=2, exported_path=path,
                                   device="cpu")
    np.testing.assert_allclose(loaded.inference([x]), want, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(loaded.inference([x[:1]]), want[:1], rtol=0,
                               atol=1e-5)
    ops = {str(n.target) for n in torch.export.load(path).graph.nodes}
    assert {f"aicity.{name}.default" for name in (
        "ln_qkv", "flash_attention_ln", "ln_mlp", "layer_norm")} <= ops
    with pytest.raises(ValueError, match="cannot export"):
        loaded.export(str(tmp_path / "again.pt2"))
    assert callable(load_exported(path))


class _EveryOp(torch.nn.Module):
    """One call of each wrapper that traces as an ``aicity::*`` op: LN+qkv,
    LN+MLP, both LayerNorm instances, the fused-LN attention (d-major
    views, as the model passes them) and the attention of the unfused
    eval path."""

    def forward(self, x, t, g, b):
        from aicity_action_tpu_torch.ops import flash_attention as fa
        from aicity_action_tpu_torch.ops import fused_dense as fd
        from aicity_action_tpu_torch.ops import layer_norm as ln

        D = x.shape[1]
        q, k, v = fd.fused_ln_qkv(x, g, b, torch.ones(3 * D, D) * 0.01,
                                  None, 1e-6, 16)
        h = fd.fused_ln_mlp(x, g, b, torch.ones(2 * D, D) * 0.01,
                            torch.zeros(2 * D), torch.ones(D, 2 * D) * 0.01,
                            torch.zeros(D), 1e-6)
        rows = ln.pool_norm_rows(t, g[:8], b[:8], 1e-5, 2)
        qd, kd, vd = (a.transpose(1, 2) for a in (q, k, v))
        att = fa.flash_attention_ln(qd, kd, vd, g, b, g, b, g, b, 0.25,
                                    1e-5, (True, True, False), True)
        plain = fa.flash_attention(rows, rows, rows, 0.35)
        return ln.fused_layer_norm(h, g, b, 1e-6), att, plain


def test_every_export_op_traces_and_runs_as_eager(tmp_path):
    """Each custom op's fake gives the shapes its wrapper returns: the
    exported module of one call of each runs to the eager outputs, and its
    graph holds the six ops."""
    rng = np.random.default_rng(4)
    args = (torch.from_numpy(rng.standard_normal((32, 16), np.float32)),
            torch.from_numpy(rng.standard_normal((2, 16, 24), np.float32)),
            torch.ones(16) + 0.1, torch.zeros(16) + 0.2)
    mod = _EveryOp()
    want = mod(*args)
    path = str(tmp_path / "ops.pt2")
    torch.export.save(torch.export.export(mod, args, strict=False), path)
    got = load_exported(path)(*args)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    ops = {str(n.target) for n in torch.export.load(path).graph.nodes}
    assert {f"aicity.{n}.default" for n in (
        "ln_qkv", "ln_mlp", "layer_norm", "pool_norm_rows",
        "flash_attention_ln", "flash_attention")} <= ops
