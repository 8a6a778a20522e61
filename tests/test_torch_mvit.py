"""The whole PyTorch MViT-v2 against the JAX package's, on the CPU in f32.

The tiny config (depth 4, crop 32, 4 frames, embed 32) is built in code on
``configs/AICITY_MVITV2_B_16x4_448.yaml``. The JAX model's params (perturbed
with numpy noise) go into the port through ``jax_params_to_state_dict``, and
both score the same numpy clip at eval. Tolerance: max abs error 2e-5 on the
softmax scores and on the centered log-scores (the logits up to their
per-clip constant), the bound PARITY.md holds the JAX package to. The JAX
side runs twice: on its XLA path, and with its Pallas kernels forced on in
interpret mode (the path it takes on the TPU at inference).
"""

import jax
import numpy as np
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.models import mvit as jmvit
from aicity_action_tpu.models.build import build_model as jax_build_model
from aicity_action_tpu.ops.pallas import flash_attention as jfa
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.models import mvit as tmvit
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.utils.convert import jax_params_to_state_dict
from torch_port_helpers import perturb, tiny_cfg

TOL = 2e-5


@pytest.fixture(scope="module")
def pair():
    module, params = jax_build_model(tiny_cfg(jax_get_cfg))
    params = perturb(params, 0)
    model = build_model(tiny_cfg(get_cfg), device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    x = np.random.default_rng(1).standard_normal(
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
    cfg.MVIT.CLS_EMBED_ON = True
    with pytest.raises(NotImplementedError):
        build_model(cfg, device="cpu")
    cfg = tiny_cfg(get_cfg)
    cfg.MODEL.MODEL_NAME = "SlowFast"
    with pytest.raises(NotImplementedError):
        build_model(cfg, device="cpu")
