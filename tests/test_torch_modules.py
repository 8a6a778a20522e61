"""The PyTorch port's modules against the JAX package's, on the CPU in f32.

Weights come from the JAX module's init (perturbed with numpy noise so that
every LayerNorm scale and bias matters) and are carried into the port with
``jax_params_to_state_dict``; inputs are made with numpy from a seed. On the
CPU the JAX modules take their plain XLA path (separate LNs and einsum
attention) and the port its kernels' plain versions, so the two agree up to
f32 summation order: max abs error 2e-5 (the bound PARITY.md holds the JAX
package to).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.models import mvit as jmvit
from aicity_action_tpu.ops import pooling as jpool
from aicity_action_tpu.utils.convert import convert_mvit_state_dict
from aicity_action_tpu_torch.config import get_cfg, mvitv2_b_16x4_448_cfg
from aicity_action_tpu_torch.models import mvit as tmvit
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.models.common import FusedLayerNorm
from aicity_action_tpu_torch.ops import pooling as tpool
from aicity_action_tpu_torch.utils.convert import jax_params_to_state_dict
from torch_port_helpers import YAML, jax_tiny_model, perturb, tiny_cfg

TOL = 2e-5


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=tol)


# ------------------------------------------------------------------ pooling

@pytest.mark.parametrize("mode,has_cls,rank", [
    ("conv", False, 4), ("conv", False, 3), ("conv", True, 4),
    ("max", False, 3), ("max", True, 4), ("avg", False, 4)])
def test_attention_pool_matches_jax(mode, has_cls, rank):
    rng = np.random.default_rng(10)
    B, N, d, thw = 2, 2, 8, (4, 6, 5)
    L = int(np.prod(thw)) + int(has_cls)
    shape = (B, N, L, d) if rank == 4 else (B, L, d)
    x = rng.standard_normal(shape).astype(np.float32)
    kernel, stride = (3, 3, 3), (1, 2, 2)
    w = rng.standard_normal((*kernel, 1, d)).astype(np.float32) * 0.2
    ref, ref_thw = jpool.attention_pool(
        jnp.asarray(x), thw, mode=mode, kernel=kernel, stride=stride,
        conv_weights=jnp.asarray(w) if mode == "conv" else None,
        has_cls=has_cls)
    out, out_thw = tpool.attention_pool(
        torch.from_numpy(x), thw, mode=mode, kernel=kernel, stride=stride,
        conv_weights=(torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy())
                      if mode == "conv" else None),
        has_cls=has_cls)
    assert out_thw == ref_thw
    _close(out, ref)


def test_attention_pool_identity_and_pooled_hw():
    x = torch.ones(1, 8, 4)
    out, thw = tpool.attention_pool(x, (2, 2, 2), mode="max", kernel=(),
                                    stride=None)
    assert out is x and thw == (2, 2, 2)
    for n, k, s, p in ((56, 3, 2, 1), (8, 3, 1, 1), (7, 2, 2, 0)):
        assert tpool.pooled_hw(n, k, s, p) == jpool.pooled_hw(n, k, s, p)


# ------------------------------------------------------------------ modules

def test_patch_embed_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 4, 32, 32, 3)).astype(np.float32)
    jmod = jmvit.PatchEmbed(features=16, kernel_size=(3, 7, 7),
                            strides=(2, 4, 4), padding=(1, 3, 3))
    params = perturb(jmod.init(jax.random.PRNGKey(0), x)["params"], 1)
    ref = np.asarray(jmod.apply({"params": params}, x))
    mod = tmvit.PatchEmbed(3, 16, (3, 7, 7), (2, 4, 4), (1, 3, 3))
    sd = jax_params_to_state_dict({"patch_embed": params})
    mod.load_state_dict({k[len("patch_embed."):]: v for k, v in sd.items()})
    with torch.no_grad():
        tokens, thw = mod(torch.from_numpy(x))
    assert thw == ref.shape[1:4]
    _close(tokens, ref.reshape(2, -1, 16))


# (dim, dim_out, heads, kernel_q, kernel_kv, stride_q, stride_kv, thw)
ATTN_CASES = {
    "expand_q_stride": (16, 32, 2, (3, 3, 3), (3, 3, 3), (1, 2, 2),
                        (1, 2, 2), (2, 8, 8)),
    "q_pool_all": (32, 32, 2, (3, 3, 3), (3, 3, 3), (1, 1, 1), (1, 2, 2),
                   (2, 4, 4)),
    "one_head": (16, 16, 1, (3, 3, 3), (3, 3, 3), (1, 1, 1), (1, 4, 4),
                 (2, 8, 8)),
    "kv_only": (16, 16, 2, (), (3, 3, 3), (), (1, 2, 2), (2, 4, 4)),
}


@pytest.mark.parametrize("q_residual", [True, False])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_multiscale_attention_matches_jax(case, q_residual):
    dim, dim_out, h, kq, kkv, sq, skv, thw = ATTN_CASES[case]
    rng = np.random.default_rng(12)
    B, L = 2, int(np.prod(thw))
    x = rng.standard_normal((B, L, dim)).astype(np.float32)
    n1 = (1 + 0.1 * rng.standard_normal(dim)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(dim)).astype(np.float32)
    jmod = jmvit.MultiScaleAttention(
        dim=dim, dim_out=dim_out, num_heads=h, kernel_q=kq, kernel_kv=kkv,
        stride_q=sq, stride_kv=skv, mode="conv", qkv_bias=True,
        has_cls=False, q_pool_residual=q_residual)
    params = perturb(jmod.init(jax.random.PRNGKey(1), x, thw, ln_scale=n1,
                               ln_bias=b1)["params"], 2)
    ref, ref_thw = jmod.apply({"params": params}, x, thw, ln_scale=n1,
                              ln_bias=b1, ln_eps=1e-6)
    mod = tmvit.MultiScaleAttention(dim, dim_out, h, kq, kkv, sq, skv,
                                    "conv", True, False, q_residual)
    mod.load_state_dict(jax_params_to_state_dict(params))
    norm1 = FusedLayerNorm(dim, eps=1e-6)
    norm1.load_state_dict({"weight": torch.from_numpy(n1),
                           "bias": torch.from_numpy(b1)})
    with torch.no_grad():
        out, out_thw = mod(torch.from_numpy(x), thw, norm1)
    assert out_thw == ref_thw
    _close(out, ref)


@pytest.mark.parametrize("dim,dim_out,heads,stride_q", [
    (16, 32, 2, (1, 2, 2)),    # expand block: proj_max_pool + skip pool
    (32, 32, 2, (1, 1, 1)),    # Q_POOL_ALL block: no skip pool
])
def test_multiscale_block_matches_jax(dim, dim_out, heads, stride_q):
    rng = np.random.default_rng(13)
    thw = (2, 8, 8)
    x = rng.standard_normal((2, int(np.prod(thw)), dim)).astype(np.float32)
    fields = dict(dim=dim, dim_out=dim_out, num_heads=heads,
                  kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3), stride_q=stride_q,
                  stride_kv=(1, 4, 4), drop_path=0.1)
    kw = dict(mode="conv", qkv_bias=True, has_cls=False,
              q_pool_residual=True, channel_expand_front=True,
              mlp_ratio=4.0)
    jmod = jmvit.MultiScaleBlock(spec=jmvit.BlockSpec(**fields), **kw)
    params = perturb(jmod.init(jax.random.PRNGKey(2), x, thw)["params"], 3)
    ref, ref_thw = jmod.apply({"params": params}, x, thw)
    mod = tmvit.MultiScaleBlock(tmvit.BlockSpec(**fields), **kw).eval()
    mod.load_state_dict(jax_params_to_state_dict(params))
    with torch.no_grad():
        out, out_thw = mod(torch.from_numpy(x), thw)
    assert out_thw == ref_thw
    _close(out, ref)


@pytest.mark.parametrize("mode", ["max", "avg"])
def test_pool_mode_block_matches_jax(mode):
    """A max / avg pool block: no pool convs and no pool norms; its
    attention goes through flash_attention (mvit.py:565-589, 647-669)."""
    rng = np.random.default_rng(14)
    thw = (2, 8, 8)
    x = rng.standard_normal((2, int(np.prod(thw)), 16)).astype(np.float32)
    fields = dict(dim=16, dim_out=32, num_heads=2, kernel_q=(3, 3, 3),
                  kernel_kv=(3, 3, 3), stride_q=(1, 2, 2),
                  stride_kv=(1, 4, 4), drop_path=0.1)
    kw = dict(mode=mode, qkv_bias=True, has_cls=False, q_pool_residual=True,
              channel_expand_front=True, mlp_ratio=4.0)
    jmod = jmvit.MultiScaleBlock(spec=jmvit.BlockSpec(**fields), **kw)
    params = perturb(jmod.init(jax.random.PRNGKey(4), x, thw)["params"], 5)
    ref, ref_thw = jmod.apply({"params": params}, x, thw)
    mod = tmvit.MultiScaleBlock(tmvit.BlockSpec(**fields), **kw).eval()
    mod.load_state_dict(jax_params_to_state_dict(params))
    with torch.no_grad():
        out, out_thw = mod(torch.from_numpy(x), thw)
    assert out_thw == ref_thw
    _close(out, ref)


# ------------------------------------------------------------------ spec

@pytest.mark.parametrize("which", ["448", "tiny"])
def test_build_mvit_spec_matches_jax(which):
    if which == "448":
        jcfg = jax_get_cfg()
        jcfg.merge_from_file(YAML)
        pcfg = mvitv2_b_16x4_448_cfg()
    else:
        jcfg, pcfg = tiny_cfg(jax_get_cfg), tiny_cfg(get_cfg)
    jspec = jmvit.build_mvit_spec(jcfg)
    pspec = tmvit.build_mvit_spec(pcfg)
    assert dataclasses.asdict(pspec) == dataclasses.asdict(jspec)
    if which == "448":
        # the 448 block schedule (head dim d = 96 in every block)
        assert [(b.dim, b.dim_out, b.num_heads) for b in pspec.blocks] == (
            [(96, 96, 1), (96, 192, 2), (192, 192, 2), (192, 384, 4)]
            + [(384, 384, 4)] * 10 + [(384, 768, 8), (768, 768, 8)])


def test_state_dict_round_trips_through_the_jax_converter():
    """jax params -> port state_dict -> convert_mvit_state_dict gives the
    JAX params back exactly, and every port parameter is named."""
    _, params = jax_tiny_model()
    params = jax.tree_util.tree_map(np.asarray, params)
    model = build_model(tiny_cfg(get_cfg), device="cpu")
    sd = jax_params_to_state_dict(params)
    model.load_state_dict(sd, strict=True)
    back, skipped = convert_mvit_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    assert skipped == []
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_b[path], leaf)
