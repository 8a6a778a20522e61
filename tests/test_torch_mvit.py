"""The whole PyTorch MViT against the JAX package's, on the CPU in f32.

The tiny MViT-v2 (depth 4, crop 32, 4 frames, embed 32) is built in code on
``configs/AICITY_MVITV2_B_16x4_448.yaml``; the tiny cls-token MViT-v1 of the
same sizes on the port's ``mvit_b_16x4_224_cfg`` (PySlowFast's K400
MViT-B), with channel changes in the MLPs of blocks 0 and 2. The JAX
model's params (perturbed with numpy noise) go into the port through
``jax_params_to_state_dict``, and both score the same numpy clip at eval. Tolerance: max abs error 2e-5 on the
softmax scores and on the centered log-scores (the logits up to their
per-clip constant), the bound PARITY.md holds the JAX package to. The JAX
side runs twice: on its XLA path, and with its Pallas kernels forced on in
interpret mode (the path it takes on the TPU at inference).
"""

import jax
import numpy as np
import pytest
import torch

from aicity_action_tpu.models import mvit as jmvit
from aicity_action_tpu.ops.pallas import flash_attention as jfa
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.models import mvit as tmvit
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.utils.convert import jax_params_to_state_dict
from torch_port_helpers import (jax_tiny_model, jax_tiny_v1_model, perturb,
                                tiny_cfg, tiny_v1_cfg)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = 2e-5


@pytest.fixture(scope="module")
def pair():
    # remat changes nothing at eval; the build is shared with the other
    # port tests of the process
    module, params = jax_tiny_model()
    params = perturb(params, 0)
    model = build_model(tiny_cfg(get_cfg), device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    x = np.random.default_rng(1).standard_normal(
        (2, 4, 32, 32, 3)).astype(np.float32)
    return module, params, model, x


@pytest.fixture(scope="module")
def v1_pair():
    module, params = jax_tiny_v1_model()
    params = perturb(params, 2)
    model = build_model(tiny_v1_cfg(get_cfg), device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    x = np.random.default_rng(3).standard_normal(
        (2, 4, 32, 32, 3)).astype(np.float32)
    return module, params, model, x


def _centered_log(p):
    lp = np.log(np.asarray(p, np.float64))
    return lp - lp.mean(-1, keepdims=True)


@pytest.mark.parametrize("jax_path", ["xla", "pallas_interpret"])
def test_tiny_mvit_eval_matches_jax(pair, jax_path, monkeypatch):
    module, params, model, x = pair
    if jax_path == "pallas_interpret":
        monkeypatch.setattr(jfa, "INTERPRET", True)
        monkeypatch.setattr(jmvit, "_use_pallas", lambda: True)
        monkeypatch.setenv("AICITY_TPU_FUSE_ATTN_LN", "1")
    ref = np.asarray(module.apply({"params": params}, [x], train=False))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 18)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(_centered_log(out), _centered_log(ref),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("jax_path", ["xla", "pallas_interpret"])
def test_tiny_v1_mvit_eval_matches_jax(v1_pair, jax_path, monkeypatch):
    """The cls-token MViT-v1: odd lengths 1 + T*H*W through the padded
    attention (on the JAX Pallas path, flash_attention_padded), the cls
    column re-attached before the pool norms, channel changes in the MLP
    with the residual proj(norm2(x)), and the head on the cls row."""
    module, params, model, x = v1_pair
    if jax_path == "pallas_interpret":
        monkeypatch.setattr(jfa, "INTERPRET", True)
        monkeypatch.setattr(jmvit, "_use_pallas", lambda: True)
    assert model.spec.cls_embed and not model.spec.channel_expand_front
    assert [b.proj is not None for b in model.blocks] == [
        True, False, True, False]
    # jitted: on a CPU one compile beats the eager path's op-by-op one
    apply = jax.jit(lambda p, clip: module.apply({"params": p}, [clip],
                                                 train=False))
    ref = np.asarray(apply(params, x))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 18)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(_centered_log(out), _centered_log(ref),
                               rtol=0, atol=TOL)


def test_v1_forward_goes_through_the_padded_attention(v1_pair, monkeypatch):
    """A cls-token model takes the unfused path at eval (mvit.py:543-548):
    per block one norm1+qkv and one padded attention; the conv-pooled
    tensors' norms, norm2 of the channel-change blocks and the final norm
    through fused_layer_norm; the fused LN+MLP where the channels stay."""
    from aicity_action_tpu_torch.models import common as tcommon

    _, _, model, x = v1_pair
    calls = {}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped

    for mod, name in ((tmvit, "fused_ln_qkv"),
                      (tmvit, "flash_attention_padded"),
                      (tmvit, "flash_attention"), (tmvit, "fused_ln_mlp"),
                      (tmvit, "fused_layer_norm"),
                      (tcommon, "fused_layer_norm")):
        monkeypatch.setattr(mod, name, counting(
            f"{mod.__name__}.{name}", getattr(mod, name)))
    with torch.no_grad():
        model(torch.from_numpy(x[:1]))
    pooled = sum(len(b.attn.pooled) for b in model.blocks)
    changes = sum(b.proj is not None for b in model.blocks)
    m, c = tmvit.__name__, tcommon.__name__
    assert calls == {f"{m}.fused_ln_qkv": 4,
                     f"{m}.flash_attention_padded": 4,
                     f"{m}.fused_ln_mlp": 4 - changes,
                     f"{m}.fused_layer_norm": pooled,
                     f"{c}.fused_layer_norm": changes + 1}


def test_forward_goes_through_the_four_kernel_functions(pair, monkeypatch):
    """Each block calls norm1+qkv, fused-LN attention and norm2+MLP once,
    and the final norm runs once: the calls the card's kernels serve."""
    from aicity_action_tpu_torch.models import common as tcommon

    _, _, model, x = pair
    calls = {}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped

    for mod, name in ((tmvit, "fused_ln_qkv"), (tmvit, "flash_attention_ln"),
                      (tmvit, "fused_ln_mlp"), (tcommon, "fused_layer_norm")):
        monkeypatch.setattr(mod, name, counting(name, getattr(mod, name)))
    with torch.no_grad():
        model(torch.from_numpy(x[:1]))
    depth = len(model.blocks)
    assert calls == {"fused_ln_qkv": depth, "flash_attention_ln": depth,
                     "fused_ln_mlp": depth, "fused_layer_norm": 1}


def test_forward_takes_a_pathway_list_and_is_batch_independent(pair):
    _, _, model, x = pair
    with torch.no_grad():
        both = model([torch.from_numpy(x)])
        one = model(torch.from_numpy(x[1:]))
    torch.testing.assert_close(both[1:], one, rtol=0, atol=1e-6)


def test_unported_branches_raise():
    cfg = tiny_cfg(get_cfg)
    cfg.MVIT.MODE = "max"  # ported: builds
    assert build_model(cfg, device="cpu").blocks[0].attn.mode == "max"
    cfg.MVIT.CLS_EMBED_ON = True  # ported: builds
    assert build_model(cfg, device="cpu").cls_token.shape == (1, 1, 32)
    cfg.DETECTION.ENABLE = True
    with pytest.raises(NotImplementedError):
        build_model(cfg, device="cpu")
    cfg = tiny_cfg(get_cfg)
    cfg.MODEL.MODEL_NAME = "SlowFast"
    with pytest.raises(NotImplementedError):
        build_model(cfg, device="cpu")
