"""MViT-v2-L's training path (head dim 72, 144-1152 channels) in the port
against the JAX package, on the CPU in f32, where each wrapper runs its
plain version.

- The VJP of each kernel row the L train step widens: the attention with its
  logsumexp and its backward at head dim 72 (the JAX Pallas kernels in
  interpret mode, at lengths whose last key tile of the port's kernel is
  ragged), the same for the fused-LN attention of
  ``AICITY_TPU_FUSE_ATTN_LN=1`` (every flag pattern, both Pallas backward
  variants; the forward and logsumexp within 2e-5 of each output's scale, the
  gradients within rtol 1e-4 / atol 1e-5, as ``test_torch_kernels.py``'s),
  LN+qkv and LN+MLP at 144 channels (hidden 576) and at 1152 (hidden 4608),
  each through whichever branch the JAX package's gates take (its Pallas
  backward in interpret mode, or the XLA VJP of its reference), and the
  LayerNorm at 1152 channels and over 72-channel groups. Inputs are made with
  numpy from a seed. Tolerance: max abs error 2e-5 of each output's scale, the
  larger of 1 and its largest magnitude (f32; the two sum in different orders,
  and the weight and bias gradients sum up to 64 rows into magnitudes of ~30).
- Two train steps of a tiny L-shaped MViT (``l_tiny_cfg``: EMBED_DIM 144, 2
  heads, 4 blocks) against the JAX ``make_train_step``, on its XLA path and
  with its Pallas kernels forced on in interpret mode, the port on its default
  switch (the unfused attention in training); and both sides under
  ``AICITY_TPU_FUSE_ATTN_LN=1`` (the fused-LN attention and its backward in
  every block); the port with activation checkpointing. SGD and the tolerances
  of ``test_torch_train.py``, whose step helpers these are (see its
  ``_train_cfg`` for why SGD).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.models import mvit as jmvit
from aicity_action_tpu.ops.pallas import flash_attention as jfa
from aicity_action_tpu.ops.pallas import fused_dense as jfd
from aicity_action_tpu.ops.pallas import layer_norm as jln
from aicity_action_tpu_torch.ops import flash_attention as tfa
from aicity_action_tpu_torch.ops import fused_dense as tfd
from aicity_action_tpu_torch.models import mvit as tmvit
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.ops import layer_norm as tln
from aicity_action_tpu_torch.utils.convert import jax_params_to_state_dict
from test_torch_train import _check_steps, _jax_steps, _port_model, _train_cfg
from torch_port_helpers import l_tiny_cfg, perturb
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = 2e-5
D_L = 72  # MViT-v2-L's head dim


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfa, "INTERPRET", True)


def _arr(rng, shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _close(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.detach().numpy(), ref, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(ref).max())))


def _grads(fn, inputs, cotangents):
    """Autograd of the port's (plain) ``fn`` at numpy ``inputs``."""
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, ts, [torch.from_numpy(c)
                                          for c in cotangents])


# ------------------------------------------- the kernel rows' VJPs at L widths

@pytest.mark.parametrize("Lq,Lk", [(64, 80), (128, 98), (32, 32)])
def test_flash_attention_vjp_at_head_dim_72_matches_pallas(Lq, Lk,
                                                           interpret):
    """Rows 2 and 3: the output, the saved logsumexp and dq, dk, dv against
    the JAX custom VJP (its Pallas forward with the logsumexp and its
    Pallas backward, interpret mode). Lk 80 and 98 leave the port kernel's
    last 64-key tile ragged (16 and 34 keys)."""
    G = 2
    assert jfa.flash_attention_supported(Lq, Lk, D_L)
    rng = np.random.default_rng(60)
    q, k, v = (_arr(rng, (G, n, D_L), 1.5, 0.3) for n in (Lq, Lk, Lk))
    dout = _arr(rng, (G, Lq, D_L))
    scale = D_L ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out_ref, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c,
                                                               scale),
                           jq, jk, jv)
    ref = vjp(jnp.asarray(dout))
    _, (*_, lse_ref) = jfa._flash_fwd(jq, jk, jv, scale)
    out, lse = tfa.flash_attention_lse_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), scale)
    _close(out, out_ref)
    _close(lse, np.asarray(lse_ref).reshape(G, Lq))
    grads = _grads(lambda *a: tfa.flash_attention(*a, scale), (q, k, v),
                   (dout,))
    for o, r in zip(grads, ref):
        _close(o, r)


def _close_grad(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


# every (norm_q, norm_k, norm_v) on the merged Pallas backward, add_qn
# alternating, the port kernel's last 64-key tile ragged (Lk 80: 16 keys,
# 98: 34) in turns; the K-chunked Pallas backward with all three norms
_LN_72_CASES = (
    [("merged", f, sum(f) % 2 == 1, (64, 80) if i % 2 else (64, 98))
     for i, f in enumerate(itertools.product((True, False), repeat=3))]
    + [("chunked", (True, True, True), True, (64, 80))])


@pytest.mark.parametrize("variant,flags,add_qn,lengths", _LN_72_CASES)
def test_flash_attention_ln_vjp_at_head_dim_72_matches_pallas(
        variant, flags, add_qn, lengths, interpret, monkeypatch):
    """Rows 6 and 7 at head dim 72 (the fused-LN attention under
    ``AICITY_TPU_FUSE_ATTN_LN=1``): the output and the logsumexp against
    the JAX forward with its logsumexp (``_flash_ln_fwd``), and all nine
    gradients (q, k, v and the three pool norms' gamma / beta; zeros where
    a flag is off) against its custom VJP through each Pallas backward.
    In f32 the JAX wrapper's recovery of the attention output before the
    residual (out - LN(q)) is exact to f32 rounding; the k norm's bias
    gradient, exactly zero, is held at the same atol."""
    if variant == "chunked":
        # K/V past the cap, one 16-key chunk under it
        monkeypatch.setattr(jfa, "_BWD_KV_RESIDENT_CAP", 32 * 1024)
    G, (Lq, Lk) = 2, lengths
    assert (jfa._ln_bwd_fused_tile(Lq, Lk, D_L, flags) is None) == (
        variant == "chunked")
    rng = np.random.default_rng(65)
    q, k, v = (_arr(rng, (G, n, D_L), 1.5, 0.3) for n in (Lq, Lk, Lk))
    lnp = [a for _ in range(3)
           for a in (_arr(rng, (D_L,), 0.1, 1.0), _arr(rng, (D_L,), 0.1))]
    dout = _arr(rng, (G, Lq, D_L))
    scale = D_L ** -0.5
    jargs = [jnp.asarray(a) for a in (q, k, v, *lnp)]
    _, (*_, out_ref, lse_ref) = jfa._flash_ln_fwd(*jargs, scale, 1e-5, flags,
                                                  add_qn)
    _, vjp = jax.vjp(
        lambda *a: jfa.flash_attention_ln(*a, scale, 1e-5, flags, add_qn),
        *jargs)
    ref = vjp(jnp.asarray(dout))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, *lnp)]
    out = tfa.flash_attention_ln(*ts, scale, 1e-5, flags, add_qn)
    _close(out, out_ref)
    normed = [tln.layer_norm_plain(t, ts[3 + 2 * i], ts[4 + 2 * i], 1e-5)
              if flags[i] else t for i, t in enumerate(ts[:3])]
    _, lse = tfa.flash_attention_lse_plain(*normed, scale)
    _close(lse, np.asarray(lse_ref).reshape(G, Lq))
    grads = torch.autograd.grad(out, ts, torch.from_numpy(dout),
                                allow_unused=True)
    for i, (o, r) in enumerate(zip(grads, ref)):
        if o is None:  # a parameter whose flag is off
            assert i >= 3 and not flags[(i - 3) // 2]
            o = torch.zeros(D_L)
        _close_grad(o, r)


@pytest.mark.parametrize("d,c,m,tokens", [(144, 144, 64, 32),
                                          (144, 288, 64, 32),
                                          (1152, 1152, 32, 16)])
def test_fused_ln_qkv_vjp_at_l_widths_matches_jax(d, c, m, tokens,
                                                  interpret):
    """Row 9: dx, dgamma, dbeta, dW, db at D 144 (3C 432 and 864) through
    the JAX Pallas backward, and at D = C = 1152 through the XLA VJP that
    the JAX gate takes there (its weights pass the VMEM budget); the port's
    gradients of q, k, v arrive channel-major, [B, C, L]."""
    assert jfd.ln_qkv_bwd_supported(m, d, 3 * c) == (d < 1152)
    rng = np.random.default_rng(61)
    x = _arr(rng, (m, d))
    g, b = _arr(rng, (d,), 0.1, 1.0), _arr(rng, (d,), 0.1)
    w = _arr(rng, (d, 3 * c), d ** -0.5)
    bb = _arr(rng, (3 * c,), 0.1)
    cts = [_arr(rng, (m, c)) for _ in range(3)]
    _, vjp = jax.vjp(lambda *a: jfd.fused_ln_qkv(*a, 1e-6),
                     *(jnp.asarray(a) for a in (x, g, b, w, bb)))
    dx, dg, db_, dw, dbias = vjp(tuple(jnp.asarray(t) for t in cts))
    cm = [t.reshape(m // tokens, tokens, c).transpose(0, 2, 1).copy()
          for t in cts]
    out = _grads(lambda x_, g_, b_, w_, bb_: tfd.fused_ln_qkv(
        x_, g_, b_, w_, bb_, 1e-6, tokens), (x, g, b, w.T.copy(), bb), cm)
    for o, r in zip(out, (dx, dg, db_, np.asarray(dw).T, dbias)):
        _close(o, r)


@pytest.mark.parametrize("c,m", [(144, 64), (1152, 16)])
def test_fused_ln_mlp_vjp_at_l_widths_matches_jax(c, m, interpret):
    """Row 11: dx, dgamma, dbeta, dW1, db1, dW2, db2 at C 144 (hidden 576:
    the port's 64-wide dual-GEMM tile) through the JAX Pallas backward, and
    at C 1152 (hidden 4608) through the XLA VJP that the JAX gates take
    there (the forward's too)."""
    h = 4 * c
    assert jfd.ln_mlp_bwd_supported(m, c, h, c) == (c < 1152)
    rng = np.random.default_rng(62)
    x = _arr(rng, (m, c))
    g, b = _arr(rng, (c,), 0.1, 1.0), _arr(rng, (c,), 0.1)
    w1, b1 = _arr(rng, (c, h), c ** -0.5), _arr(rng, (h,), 0.1)
    w2, b2 = _arr(rng, (h, c), h ** -0.5), _arr(rng, (c,), 0.1)
    dout = _arr(rng, (m, c))
    _, vjp = jax.vjp(lambda *a: jfd.fused_ln_mlp(*a, 1e-6),
                     *(jnp.asarray(a) for a in (x, g, b, w1, b1, w2, b2)))
    ref = list(vjp(jnp.asarray(dout)))
    ref[3], ref[5] = np.asarray(ref[3]).T, np.asarray(ref[5]).T
    out = _grads(lambda *a: tfd.fused_ln_mlp(*a, 1e-6),
                 (x, g, b, w1.T.copy(), b1, w2.T.copy(), b2), (dout,))
    for o, r in zip(out, ref):
        _close(o, r)


@pytest.mark.parametrize("rows,channels,groups", [(32, 1152, 1),
                                                  (48, 144, 2)])
def test_fused_layer_norm_vjp_at_l_widths_matches_pallas(rows, channels,
                                                         groups, interpret):
    """Row 13: dx, dgamma, dbeta of the final norm's 1152 channels (the
    rows backward's wide instance on the card) and of the pool norms' 72
    channels a head."""
    rng = np.random.default_rng(63)
    x = _arr(rng, (rows, channels), 2.0, 0.5)
    dg = channels // groups
    g, b = _arr(rng, (dg,), 0.1, 1.0), _arr(rng, (dg,), 0.1)
    dy = _arr(rng, (rows, channels))
    _, vjp = jax.vjp(lambda *a: jln.fused_layer_norm(*a, 1e-6, groups),
                     *(jnp.asarray(a) for a in (x, g, b)))
    ref = vjp(jnp.asarray(dy))
    out = _grads(lambda *a: tln.fused_layer_norm(*a, 1e-6, groups),
                 (x, g, b), (dy,))
    for o, r in zip(out, ref):
        _close(o, r)


# ------------------------------------------------ the tiny L model's steps

@pytest.fixture(scope="module")
def jax_l():
    """The JAX tiny L model (DropPath and dropout off, no checkpointing)
    and its params (its own init from ``RNG_SEED``, run as one jitted
    program on the XLA path, perturbed with numpy noise), made once."""
    from aicity_action_tpu.models.build import build_module

    jcfg = _train_cfg(jax_get_cfg, False, l_tiny_cfg)
    init_module, example = build_module(jcfg)
    with jfa.disabled():
        variables = jax.jit(lambda rng: init_module.lazy_init(
            {"params": rng}, example))(jax.random.PRNGKey(jcfg.RNG_SEED))
    module = jmvit.MViT(spec=jmvit.build_mvit_spec(jcfg), dtype=jnp.float32)
    return jcfg, module, perturb(variables["params"], 12)


@pytest.fixture(scope="module")
def l_batch():
    rng = np.random.default_rng(64)
    x = rng.standard_normal((2, 4, 32, 32, 3)).astype(np.float32)
    return x, np.array([4, 13], np.int32)


@pytest.mark.parametrize("jax_path", ["xla", "pallas_interpret",
                                      "fused_ln_pallas_interpret"])
def test_two_tiny_l_train_steps_match_jax(jax_l, l_batch, jax_path,
                                          monkeypatch):
    """Loss, grad_norm, every gradient and every parameter after each of
    two SGD steps; the JAX step on its XLA path, or with its Pallas kernels
    (forward and backward: LN+qkv, the attention at head dim 72, LN+MLP,
    the LayerNorms) forced on in interpret mode; the port on the default
    switch with every block checkpointed, its model at head dim 72 in
    every block. ``fused_ln_pallas_interpret``: ``AICITY_TPU_FUSE_ATTN_LN=1``
    on both sides, the JAX step through its interpret-mode Pallas kernels
    (the fused-LN attention with its Pallas backward at head dim 72
    included), the port through flash_attention_ln under autograd in every
    block; both at KV strides of (1, 2, 2), at which the JAX package's
    fused-LN kernels take every block (as ``test_torch_train.py``'s B
    case)."""
    monkeypatch.delenv("AICITY_TPU_FUSE_ATTN_LN", raising=False)
    fused = jax_path == "fused_ln_pallas_interpret"
    if jax_path != "xla":
        monkeypatch.setattr(jfa, "INTERPRET", True)
        monkeypatch.setattr(jmvit, "_use_pallas", lambda: True)
    jcfg, module, params = jax_l
    if fused:
        monkeypatch.setenv("AICITY_TPU_FUSE_ATTN_LN", "1")
        jcfg = jcfg.clone()
        jcfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 2, 2]
        module = jmvit.MViT(spec=jmvit.build_mvit_spec(jcfg),
                            dtype=jnp.float32)
        for b in module.spec.blocks:
            assert b.dim_out // b.num_heads == D_L
    x, y = l_batch
    ref = _jax_steps(jcfg, module, params, x, y, 2)
    pcfg, model = _port_model(params, act_checkpoint=True,
                              make_cfg=l_tiny_cfg)
    if fused:
        pcfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 2, 2]
        model = build_model(pcfg, device="cpu")
        model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    assert {blk.attn.head_dim for blk in model.blocks} == {D_L}
    assert [blk.attn.qkv.out_features // 3 for blk in model.blocks] == [
        144, 288, 288, 576]
    calls = []
    attend = tmvit.flash_attention_ln
    monkeypatch.setattr(tmvit, "flash_attention_ln",
                        lambda *a: calls.append(1) or attend(*a))
    _check_steps(model, pcfg, x, y, ref, 2)
    # under the switch: forward and recompute of every block, two steps
    assert len(calls) == (2 * 2 * len(model.blocks) if fused else 0)
