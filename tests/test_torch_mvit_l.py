"""A tiny MViT-v2 at MViT-v2-L's widths (``EMBED_DIM`` 144, ``NUM_HEADS``
2: head dim 72; 4 blocks, the widths doubling at blocks 1 and 3; 4 frames
at 32x32) in the port against the JAX package's, on the CPU in f32.

One random init of the JAX model (perturbed with numpy noise) goes into
the port through ``jax_params_to_state_dict``, which must take the L tree
as it is (a strict load), and both score the same numpy clip at eval.
Tolerance: max abs error 2e-5 on the softmax scores, as
``test_torch_mvit.py`` holds the B widths. The JAX side runs on its XLA
path and with its Pallas kernels forced on in interpret mode (its path on
the TPU); the port's on its default (fused) path and under
``AICITY_TPU_FUSE_ATTN_LN=0``."""

import jax
import numpy as np
import pytest
import torch

from aicity_action_tpu.models import mvit as jmvit
from aicity_action_tpu.ops.pallas import flash_attention as jfa
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.utils.convert import jax_params_to_state_dict
from torch_port_helpers import l_tiny_cfg, perturb
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = 2e-5


@pytest.fixture(scope="module")
def pair():
    from aicity_action_tpu.config import get_cfg as jax_get_cfg
    from aicity_action_tpu.models.build import build_module

    cfg = l_tiny_cfg(jax_get_cfg)
    cfg.MODEL.ACT_CHECKPOINT = False
    module, example = build_module(cfg)
    with jfa.disabled():
        variables = jax.jit(lambda rng: module.lazy_init(
            {"params": rng}, example))(jax.random.PRNGKey(cfg.RNG_SEED))
    params = perturb(variables["params"], 5)
    model = build_model(l_tiny_cfg(get_cfg), device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    x = np.random.default_rng(6).standard_normal(
        (2, 4, 32, 32, 3)).astype(np.float32)
    return module, params, model, x


@pytest.fixture(scope="module")
def jax_scores(pair):
    """The JAX model's eval scores on both of its paths, once."""
    module, params, _, x = pair
    scores = {"xla": np.asarray(module.apply({"params": params}, [x],
                                             train=False))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfa, "INTERPRET", True)
        mp.setattr(jmvit, "_use_pallas", lambda: True)
        mp.setenv("AICITY_TPU_FUSE_ATTN_LN", "1")
        scores["pallas_interpret"] = np.asarray(
            module.apply({"params": params}, [x], train=False))
    return scores


def test_the_l_tree_carries_across(pair):
    """Every leaf of the JAX L tree lands in the port's model unchanged:
    head dim 72 in every block, the channels 144 -> 288 -> 576."""
    _, params, model, _ = pair
    sd = jax_params_to_state_dict(params)
    assert set(sd) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert torch.equal(t, sd[name]), name
    assert {blk.attn.head_dim for blk in model.blocks} == {72}
    assert [blk.attn.qkv.out_features // 3 for blk in model.blocks] == [
        144, 288, 288, 576]


@pytest.mark.parametrize("jax_path", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("port_path", ["fused", "unfused"])
def test_tiny_l_mvit_eval_matches_jax(pair, jax_scores, jax_path, port_path,
                                      monkeypatch):
    _, _, model, x = pair
    ref = jax_scores[jax_path]
    monkeypatch.setenv("AICITY_TPU_FUSE_ATTN_LN",
                       "auto" if port_path == "fused" else "0")
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 18)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=0, atol=1e-5)
