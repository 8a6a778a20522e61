"""The PyTorch port's kernel functions on the CPU, where each runs its
plain version, against the JAX package's Pallas kernels in interpret mode.

Inputs are made with numpy from a seed and fed to both in f32. Forwards:
max abs error 2e-5 (f32 arithmetic; the two sum in different orders, and
the Pallas MLP's erf polynomial is within 1.5e-7 of the exact erf).
Backwards: the plain version differentiated by autograd against the JAX
custom VJP through its Pallas backward kernel, rtol 1e-4 / atol 1e-5 (f32;
row sums over up to 16384 keys or 64 rows taken in different orders)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicity_action_tpu.ops.pallas import flash_attention as jfa
from aicity_action_tpu.ops.pallas import fused_dense as jfd
from aicity_action_tpu.ops.pallas import layer_norm as jln
from aicity_action_tpu_torch.config import (mvit_b_16x4_224_cfg,
                                            mvitv2_b_16x4_448_cfg)
from aicity_action_tpu_torch.models.mvit import (attention_call_shapes,
                                                dense_call_shapes)
from aicity_action_tpu_torch.ops import flash_attention as tfa
from aicity_action_tpu_torch.ops import fused_dense as tfd
from aicity_action_tpu_torch.ops import kernels
from aicity_action_tpu_torch.ops import layer_norm as tln
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret_mode():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _arr(rng, shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("rows,channels,groups", [
    (64, 96, 1), (48, 192, 2), (32, 768, 8)])
def test_fused_layer_norm_matches_pallas(rows, channels, groups):
    rng = np.random.default_rng(0)
    x = _arr(rng, (rows, channels), 2.0, 0.5)
    dg = channels // groups
    g, b = _arr(rng, (dg,), 0.1, 1.0), _arr(rng, (dg,), 0.1)
    ref = jln.fused_layer_norm(jnp.asarray(x), jnp.asarray(g),
                               jnp.asarray(b), 1e-6, groups)
    out = tln.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(b), 1e-6, groups)
    _close(out, ref)


@pytest.mark.parametrize("tokens", [64, 16])
@pytest.mark.parametrize("d,c,bias", [(96, 96, True), (96, 192, True),
                                      (32, 64, False)])
def test_fused_ln_qkv_matches_pallas(d, c, bias, tokens):
    """q, k, v come channel-major, [B, C, L], as the pool convs take."""
    rng = np.random.default_rng(1)
    m = 64
    x = _arr(rng, (m, d))
    g, b = _arr(rng, (d,), 0.1, 1.0), _arr(rng, (d,), 0.1)
    w = _arr(rng, (d, 3 * c), d ** -0.5)  # JAX layout [D, 3C]
    bb = _arr(rng, (3 * c,), 0.1) if bias else None
    ref = jfd.fused_ln_qkv(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                           jnp.asarray(w),
                           None if bb is None else jnp.asarray(bb), 1e-6)
    out = tfd.fused_ln_qkv(torch.from_numpy(x), torch.from_numpy(g),
                           torch.from_numpy(b), torch.from_numpy(w.T.copy()),
                           None if bb is None else torch.from_numpy(bb), 1e-6,
                           tokens=tokens)
    for o, r in zip(out, ref):
        assert o.shape == (m // tokens, c, tokens) and o.is_contiguous()
        _close(o.transpose(1, 2).reshape(m, c), r)


@pytest.mark.parametrize("d,c", [(96, 96), (192, 192)])
def test_fused_ln_mlp_matches_pallas(d, c):
    rng = np.random.default_rng(2)
    m, h = 64, 4 * d
    x = _arr(rng, (m, d))
    g, b = _arr(rng, (d,), 0.1, 1.0), _arr(rng, (d,), 0.1)
    w1, b1 = _arr(rng, (d, h), d ** -0.5), _arr(rng, (h,), 0.1)
    w2, b2 = _arr(rng, (h, c), h ** -0.5), _arr(rng, (c,), 0.1)
    ref = jfd.fused_ln_mlp(*(jnp.asarray(a) for a in (x, g, b, w1, b1, w2,
                                                      b2)), 1e-6)
    out = tfd.fused_ln_mlp(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b),
        torch.from_numpy(w1.T.copy()), torch.from_numpy(b1),
        torch.from_numpy(w2.T.copy()), torch.from_numpy(b2), 1e-6)
    _close(out, ref)


@pytest.mark.parametrize(
    "flags,add_qn",
    [(f, a) for f in itertools.product((True, False), repeat=3)
     for a in (True, False)])
def test_flash_attention_ln_matches_pallas(flags, add_qn):
    rng = np.random.default_rng(3)
    G, Lq, Lk, d = 2, 32, 16, 96
    q, k, v = (_arr(rng, (G, n, d), 1.5, 0.3) for n in (Lq, Lk, Lk))
    lnp = [a for _ in range(3)
           for a in (_arr(rng, (d,), 0.1, 1.0), _arr(rng, (d,), 0.1))]
    scale = d ** -0.5
    ref = jfa.flash_attention_ln(*(jnp.asarray(a) for a in (q, k, v, *lnp)),
                                 scale, 1e-5, flags, add_qn)
    out = tfa.flash_attention_ln(*(torch.from_numpy(a)
                                   for a in (q, k, v, *lnp)),
                                 scale, 1e-5, flags, add_qn)
    _close(out, ref)


@pytest.mark.parametrize("flags", [(True, True, True), (False, True, False)])
def test_flash_attention_ln_takes_the_d_major_view(flags):
    """q/k/v as the d-major views of [G, d, L] tensors (what the pool
    convolutions leave) give the token-row result."""
    rng = np.random.default_rng(5)
    G, d = 2, 96
    q, k, v = (_arr(rng, (G, d, n), 1.5, 0.3) for n in (32, 16, 16))
    lnp = [torch.from_numpy(a) for _ in range(3)
           for a in (_arr(rng, (d,), 0.1, 1.0), _arr(rng, (d,), 0.1))]
    views = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
    assert all(tfa._is_dmajor(t) for t in views)
    # one group: the stride of the size-1 dim does not matter
    one = torch.from_numpy(q[:1]).reshape(1, 1, d, 32).transpose(2, 3)
    assert tfa._is_dmajor(one.reshape(1, 32, d))
    rows = [t.contiguous() for t in views]
    assert not any(tfa._is_dmajor(t) for t in rows)
    out = tfa.flash_attention_ln(*views, *lnp, 0.1, 1e-5, flags, True)
    ref = tfa.flash_attention_ln(*rows, *lnp, 0.1, 1e-5, flags, True)
    assert out.is_contiguous()
    torch.testing.assert_close(out, ref, rtol=0, atol=TOL)


def test_flash_attention_ln_plain_chunks_groups(monkeypatch):
    """The plain version's group chunking (which bounds the logits' memory
    at the 448 shapes) does not change its result."""
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(_arr(rng, (5, n, 32))) for n in (24, 8, 8)]
    args += [torch.from_numpy(_arr(rng, (32,), 0.1, 1.0)) for _ in range(6)]
    whole = tfa.flash_attention_ln_plain(*args, 0.2, 1e-5,
                                         (True, False, True), True)
    monkeypatch.setattr(tfa, "_PLAIN_CHUNK", 2 * 24 * 8)
    chunked = tfa.flash_attention_ln_plain(*args, 0.2, 1e-5,
                                           (True, False, True), True)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


def test_wrappers_take_the_plain_version_on_cpu_only():
    """A CPU tensor runs the plain version and counts no launch; a device
    the port has no path for raises instead of falling back."""
    x = torch.ones(4, 8)
    g, b = torch.ones(8), torch.zeros(8)
    before = tln.fused_layer_norm.launches
    tln.fused_layer_norm(x, g, b, 1e-6)
    assert tln.fused_layer_norm.launches == before
    assert kernels.use_kernel(x) is False
    with pytest.raises(ValueError):
        kernels.use_kernel(torch.ones(2, device="meta"))


# ------------------------------------------------------------- backwards

def _close_grad(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def _grads(fn, inputs, cotangents):
    """Autograd of the port's (plain) ``fn`` at numpy ``inputs``."""
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, ts, [torch.from_numpy(c)
                                          for c in cotangents])


@pytest.mark.parametrize("groups", [1, 4])
def test_fused_layer_norm_backward_matches_pallas(groups):
    rng = np.random.default_rng(20)
    M, C = 64, 192
    x = _arr(rng, (M, C), 2.0, 0.5)
    g, b = _arr(rng, (C // groups,), 0.1, 1.0), _arr(rng, (C // groups,), 0.1)
    dy = _arr(rng, (M, C))
    _, vjp = jax.vjp(lambda *a: jln.fused_layer_norm(*a, 1e-5, groups),
                     *(jnp.asarray(a) for a in (x, g, b)))
    ref = vjp(jnp.asarray(dy))
    out = _grads(lambda *a: tln.fused_layer_norm(*a, 1e-5, groups),
                 (x, g, b), (dy,))
    for o, r in zip(out, ref):
        _close_grad(o, r)


@pytest.mark.parametrize("Lq,Lk,variant", [
    (64, 32, "merged"), (32, 4096, "k-chunked"), (16, 16384, "split")])
def test_flash_attention_backward_matches_pallas(Lq, Lk, variant):
    """dq, dk, dv and the saved lse against the JAX custom VJP, at shapes
    that reach each of the three Pallas backward variants."""
    G, d = 2, 96
    assert (jfa._bwd_fused_tile(Lq, Lk, d) is not None) == (
        variant == "merged")
    assert (jfa._bwd_chunked_tiles(Lq, Lk, d) is not None) == (
        variant != "split")
    rng = np.random.default_rng(21)
    q, k, v = (_arr(rng, (G, n, d), 1.5, 0.3) for n in (Lq, Lk, Lk))
    dout = _arr(rng, (G, Lq, d))
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out_ref, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, scale),
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
        _close_grad(o, r)


@pytest.mark.parametrize("d,c,tokens", [(96, 96, 32), (64, 192, 16)])
def test_fused_ln_qkv_backward_matches_pallas(d, c, tokens):
    """dx, dgamma, dbeta, dW, db; the port's gradients of q, k, v arrive
    channel-major, [B, C, L], as its forward wrote them."""
    rng = np.random.default_rng(22)
    m = 64
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
        _close_grad(o, r)


def _ln_qkv_bwd_staged(x, gamma, beta, w, dq, dk, dv, eps):
    """The launches of ``csrc/fused_ln_qkv_bwd.cu`` written out in plain
    torch, with the kernel's rounding points to ``x.dtype`` (none in f32):
    the pre-pass (f32 statistics, ``xn`` rounded, the gradients of q, k, v
    as they arrive, channel-major ``[B, C, L]``, copied token-major, ``g
    [M, 3C]``, and with the clips side by side, ``gT [3C, M]``, and db their
    column sums), ``dxn = g W`` in f32, the LN backward, ``dW = gT xn``;
    every sum in f32, the gradients rounded at the end. The weight in the
    torch layout ``[3C, D]``; returns ``(dx, dgamma, dbeta, dw, db)``."""
    dt = x.dtype
    M = x.shape[0]
    xf, g = x.float(), gamma.float()
    xc = xf - xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    xn = (xhat * g + beta.float()).to(dt)
    gtok = torch.cat([t.transpose(1, 2).reshape(M, -1) for t in (dq, dk, dv)],
                     1)
    gT = torch.cat([t.transpose(0, 1).reshape(t.shape[1], M)
                    for t in (dq, dk, dv)], 0)
    dxn = gtok.float() @ w.float()
    e = dxn * g
    m1 = e.mean(-1, keepdim=True)
    m2 = (e * xhat).mean(-1, keepdim=True)
    dx = rstd * (e - m1 - xhat * m2)
    grads = (dx, (dxn * xhat).sum(0), dxn.sum(0), gT.float() @ xn.float(),
             gT.float().sum(1))
    return tuple(t.to(dt) for t in grads)


def _channel_major(rows, tokens):
    """Token rows ``[M, C]`` as the port's channel-major ``[B, C, L]``."""
    m, c = rows.shape
    return rows.reshape(m // tokens, tokens, c).transpose(0, 2, 1).copy()


@pytest.mark.parametrize("m,d,c,tokens", [(64, 96, 96, 32), (72, 64, 32, 9)])
def test_ln_qkv_backward_staged_matches_pallas(m, d, c, tokens):
    """The CUDA backward's launches written out in plain torch
    (``_ln_qkv_bwd_staged``) against the JAX custom VJP through its Pallas
    backward kernel, in f32: at 32 tokens a clip, and at 9 (the odd token
    counts of a cls-token model, element-wise gradient reads)."""
    rng = np.random.default_rng(27)
    x = _arr(rng, (m, d))
    g, b = _arr(rng, (d,), 0.1, 1.0), _arr(rng, (d,), 0.1)
    w = _arr(rng, (d, 3 * c), d ** -0.5)
    bb = _arr(rng, (3 * c,), 0.1)
    cts = [_arr(rng, (m, c)) for _ in range(3)]
    _, vjp = jax.vjp(lambda *a: jfd.fused_ln_qkv(*a, 1e-6),
                     *(jnp.asarray(a) for a in (x, g, b, w, bb)))
    dx, dg, db_, dw, dbias = vjp(tuple(jnp.asarray(t) for t in cts))
    out = _ln_qkv_bwd_staged(
        *(torch.from_numpy(a) for a in (x, g, b, w.T.copy())),
        *(torch.from_numpy(_channel_major(t, tokens)) for t in cts), 1e-6)
    for o, r in zip(out, (dx, dg, db_, np.asarray(dw).T, dbias)):
        _close_grad(o, r)


@pytest.mark.parametrize("m,d,c,tokens", [(64, 96, 96, 32), (45, 64, 32, 9)])
def test_ln_qkv_backward_rounding_points_in_bf16(m, d, c, tokens):
    """In bf16, the staged backward (the CUDA kernel's rounding points)
    against autograd of the plain version in f32 at the same bf16 inputs,
    within 2% of each gradient's largest magnitude: the tolerance
    chip_smoke.py holds the kernel to on the card."""
    rng = np.random.default_rng(28)
    x = _arr(rng, (m, d))
    g, b = _arr(rng, (d,), 0.1, 1.0), _arr(rng, (d,), 0.1)
    w, bb = _arr(rng, (3 * c, d), d ** -0.5), _arr(rng, (3 * c,), 0.1)
    bf = [torch.from_numpy(a).bfloat16() for a in (x, g, b, w, bb)]
    grads = [torch.from_numpy(_arr(rng, (m // tokens, c, tokens))).bfloat16()
             for _ in range(3)]
    staged = _ln_qkv_bwd_staged(*bf[:4], *grads, 1e-6)
    ts = [t.float().requires_grad_() for t in bf]
    ref = torch.autograd.grad(tfd.ln_qkv_plain(*ts, 1e-6, tokens), ts,
                              [t.float() for t in grads])
    for i, (o, r) in enumerate(zip(staged, ref)):
        assert o.dtype == torch.bfloat16 and o.shape == r.shape
        err = (o.float() - r).abs().max().item()
        assert err <= 0.02 * r.abs().max().item(), (i, err)


def _ln_mlp_bwd_staged(x, gamma, beta, w1, b1, w2, dout, eps):
    """The launches of ``csrc/fused_ln_mlp_bwd.cu`` written out in plain
    torch, with the kernel's rounding points to ``x.dtype`` (none in f32):
    the pre-pass (f32 statistics, ``xn`` rounded), the dual GEMM (``h_pre``
    and ``dh`` in f32, ``h`` and ``dhp`` rounded, db1 from the f32
    ``dh_pre``), ``dxn = dhp W1`` in f32, the LN backward, the weight
    gradients from the rounded operands; every sum in f32, the gradients
    rounded at the end. Weights in the torch layout; returns ``(dx, dgamma,
    dbeta, dw1, db1, dw2, db2)``."""
    dt = x.dtype
    xf, g, dof = x.float(), gamma.float(), dout.float()
    xc = xf - xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    xn = (xhat * g + beta.float()).to(dt)
    h_pre = xn.float() @ w1.float().t() + b1.float()
    dh = dof @ w2.float()
    cdf = 0.5 * (1.0 + torch.erf(h_pre * 0.7071067811865476))
    dh_pre = dh * (cdf + h_pre * torch.exp(-0.5 * h_pre * h_pre)
                   * 0.3989422804014327)
    h, dhp = (h_pre * cdf).to(dt), dh_pre.to(dt)
    dxn = dhp.float() @ w1.float()
    e = dxn * g
    m1 = e.mean(-1, keepdim=True)
    m2 = (e * xhat).mean(-1, keepdim=True)
    dx = rstd * (e - m1 - xhat * m2)
    grads = (dx, (dxn * xhat).sum(0), dxn.sum(0),
             dhp.float().t() @ xn.float(), dh_pre.sum(0),
             dof.t() @ h.float(), dof.sum(0))
    return tuple(t.to(dt) for t in grads)


@pytest.mark.parametrize("m,d,variant", [(64, 96, "whole"),
                                         (16, 512, "hsplit"),
                                         (64, 96, "staged")])
def test_fused_ln_mlp_backward_matches_pallas(m, d, variant):
    """Both Pallas backward variants: whole weights, and the hidden-split
    one the JAX package takes when the weights do not fit (C = 768 at 448;
    reached here at C = 512); and the CUDA backward's launches written out
    in plain torch (``_ln_mlp_bwd_staged``) against the whole-weights
    one."""
    h = 4 * d
    assert jfd.ln_mlp_bwd_supported(m, d, h, d) == (variant != "hsplit")
    assert jfd.ln_mlp_bwd_hsplit_supported(m, d, h, d)
    rng = np.random.default_rng(23)
    x = _arr(rng, (m, d))
    g, b = _arr(rng, (d,), 0.1, 1.0), _arr(rng, (d,), 0.1)
    w1, b1 = _arr(rng, (d, h), d ** -0.5), _arr(rng, (h,), 0.1)
    w2, b2 = _arr(rng, (h, d), h ** -0.5), _arr(rng, (d,), 0.1)
    dout = _arr(rng, (m, d))
    _, vjp = jax.vjp(lambda *a: jfd.fused_ln_mlp(*a, 1e-6),
                     *(jnp.asarray(a) for a in (x, g, b, w1, b1, w2, b2)))
    ref = list(vjp(jnp.asarray(dout)))
    ref[3], ref[5] = np.asarray(ref[3]).T, np.asarray(ref[5]).T
    if variant == "staged":
        out = _ln_mlp_bwd_staged(*(torch.from_numpy(a) for a in (
            x, g, b, w1.T.copy(), b1, w2.T.copy(), dout)), 1e-6)
    else:
        out = _grads(lambda *a: tfd.fused_ln_mlp(*a, 1e-6),
                     (x, g, b, w1.T.copy(), b1, w2.T.copy(), b2), (dout,))
    for o, r in zip(out, ref):
        _close_grad(o, r)


@pytest.mark.parametrize("m,d", [(64, 96), (40, 64)])
def test_ln_mlp_backward_rounding_points_in_bf16(m, d):
    """In bf16, the staged backward (the CUDA kernel's rounding points)
    against autograd of the plain version in f32 at the same bf16 inputs,
    within 2% of each gradient's largest magnitude: the tolerance
    chip_smoke.py holds the kernel to on the card."""
    h = 4 * d
    rng = np.random.default_rng(26)
    x = _arr(rng, (m, d))
    g, b = _arr(rng, (d,), 0.1, 1.0), _arr(rng, (d,), 0.1)
    w1, b1 = _arr(rng, (h, d), d ** -0.5), _arr(rng, (h,), 0.1)
    w2, b2 = _arr(rng, (d, h), h ** -0.5), _arr(rng, (d,), 0.1)
    dout = _arr(rng, (m, d))
    bf = [torch.from_numpy(a).bfloat16() for a in (x, g, b, w1, b1, w2, b2,
                                                    dout)]
    staged = _ln_mlp_bwd_staged(*bf[:6], bf[7], 1e-6)
    ts = [t.float().requires_grad_() for t in bf[:7]]
    ref = torch.autograd.grad(tfd.ln_mlp_plain(*ts, 1e-6), ts,
                              bf[7].float())
    for i, (o, r) in enumerate(zip(staged, ref)):
        assert o.dtype == torch.bfloat16 and o.shape == r.shape
        err = (o.float() - r).abs().max().item()
        assert err <= 0.02 * r.abs().max().item(), (i, err)


@pytest.mark.parametrize("Lq,Lk,d", [(1 + 4 * 4 * 4, 1 + 2 * 2 * 2, 16),
                                     (1 + 2 * 2 * 2, 1 + 4 * 4 * 4, 16),
                                     (1 + 4 * 4 * 4, 1 + 2 * 4 * 2, 72)],
                         ids=["65-9", "9-65", "65-17-d72"])
def test_flash_attention_padded_matches_pallas(Lq, Lk, d):
    """A cls token's odd lengths 1 + T*H*W: the port's padded attention
    (its plain version here; on the card the kernels' edge masks) against
    the JAX wrapper that zero-pads q, k, v and masks the padded keys,
    forward and VJP; also at MViT-v2-L's head dim 72 (row 4's backward
    takes it through the kernels of :func:`flash_attention`)."""
    G = 2
    rng = np.random.default_rng(24)
    q, k, v = (_arr(rng, (G, n, d), 1.5, 0.3) for n in (Lq, Lk, Lk))
    dout = _arr(rng, (G, Lq, d))
    scale = d ** -0.5
    out_ref, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention_padded(a, b, c, scale),
        *(jnp.asarray(a) for a in (q, k, v)))
    ref = vjp(jnp.asarray(dout))
    with torch.no_grad():
        out = tfa.flash_attention_padded(
            *(torch.from_numpy(a) for a in (q, k, v)), scale)
    _close(out, out_ref)
    grads = _grads(lambda *a: tfa.flash_attention_padded(*a, scale),
                   (q, k, v), (dout,))
    for o, r in zip(grads, ref):
        _close_grad(o, r)


# every (norm_q, norm_k, norm_v) on the merged Pallas backward, add_qn
# alternating; the K-chunked one (its q-side LN VJP runs in the wrapper)
# with and without the q norm and the residual
_LN_VJP_CASES = (
    [("merged", f, sum(f) % 2 == 1)
     for f in itertools.product((True, False), repeat=3)]
    + [("chunked", (True, True, True), True),
       ("chunked", (False, True, True), False)])


@pytest.mark.parametrize("variant,flags,add_qn", _LN_VJP_CASES)
def test_flash_attention_ln_backward_matches_pallas(variant, flags, add_qn,
                                                    monkeypatch):
    """All nine gradients of the fused-LN attention (q, k, v and the three
    pool norms' gamma / beta; zeros where a flag is off): the port's plain
    version under autograd against the JAX custom VJP through each Pallas
    backward kernel, selected as tests/test_flash_ln.py selects them. In
    f32 the JAX wrapper's recovery of the pure attention output (out -
    LN(q), a bf16 rounding on the card) is exact to f32 rounding."""
    if variant == "chunked":
        monkeypatch.setattr(jfa, "_BWD_KV_RESIDENT_CAP", 8 * 1024)
    G, Lq, Lk, d = 2, 64, 64, 16
    assert (jfa._ln_bwd_fused_tile(Lq, Lk, d, flags) is None) == (
        variant == "chunked")
    rng = np.random.default_rng(25)
    q, k, v = (_arr(rng, (G, n, d), 1.5, 0.3) for n in (Lq, Lk, Lk))
    lnp = [a for _ in range(3)
           for a in (_arr(rng, (d,), 0.1, 1.0), _arr(rng, (d,), 0.1))]
    dout = _arr(rng, (G, Lq, d))
    scale = d ** -0.5
    _, vjp = jax.vjp(
        lambda *a: jfa.flash_attention_ln(*a, scale, 1e-5, flags, add_qn),
        *(jnp.asarray(a) for a in (q, k, v, *lnp)))
    ref = vjp(jnp.asarray(dout))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, *lnp)]
    out = tfa.flash_attention_ln(*ts, scale, 1e-5, flags, add_qn)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(dout),
                                allow_unused=True)
    for i, (o, r) in enumerate(zip(grads, ref)):
        if o is None:  # a parameter whose flag is off
            assert i >= 3 and not flags[(i - 3) // 2]
            o = torch.zeros(d)
        _close_grad(o, r)


def _flash_bwd_staged(q, k, v, out, lse, dout, scale, qps, qs=None):
    """The launches of the attention backward (``csrc/flash_attention.cu``
    and ``csrc/flash_bwd.cuh``) written out in plain torch, with the
    kernels' rounding points to ``q.dtype`` (none in f32): the pre-pass
    (``qs = bf16(q * s)``, ``delta = rowsum(dout * out)`` in f32), dq from
    dS as the pair hi + lo scaled by s in f32, dk / dv as f32 partials
    over query splits of ``qps`` rows (P and dS rounded) summed in split
    order. ``qs``: the scaled query rows where the caller made them (the
    fused-LN dq kernel's), else the pre-pass's from ``q``. Returns ``(dq,
    dk, dv)``."""
    dt = q.dtype
    s = tfa._rounded_scale(scale, dt)
    qs = ((q.float() * s).to(dt) if qs is None else qs).float()
    delta = (dout.float() * out.float()).sum(-1, keepdim=True)
    kf, vf, dof = k.float(), v.float(), dout.float()
    p = torch.exp(qs @ kf.transpose(1, 2) - lse.float()[..., None])
    ds = p * (dof @ vf.transpose(1, 2) - delta)
    hi = ds.to(dt).float()
    lo = (ds - hi).to(dt).float()
    dq = ((hi @ kf + lo @ kf) * s).to(dt)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, q.shape[1], qps):
        rows = slice(q0, q0 + qps)
        dv = dv + p[:, rows].to(dt).float().transpose(1, 2) @ dof[:, rows]
        dk = dk + ds[:, rows].to(dt).float().transpose(1, 2) @ qs[:, rows]
    return dq, dk.to(dt), dv.to(dt)


@pytest.mark.parametrize("Lq,Lk", [(130, 70), (129, 65)])
def test_flash_backward_staged_matches_pallas(Lq, Lk):
    """The staged backward (``_flash_bwd_staged``, query splits of 64
    rows) against the JAX custom VJP through its padded Pallas backward,
    in f32, at lengths no tile divides (even and odd)."""
    G, d = 2, 16
    rng = np.random.default_rng(29)
    q, k, v = (_arr(rng, (G, n, d), 1.5, 0.3) for n in (Lq, Lk, Lk))
    dout = _arr(rng, (G, Lq, d))
    scale = d ** -0.5
    _, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention_padded(a, b, c, scale),
        *(jnp.asarray(a) for a in (q, k, v)))
    ref = vjp(jnp.asarray(dout))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out, lse = tfa.flash_attention_lse_plain(tq, tk, tv, scale)
    for o, r in zip(_flash_bwd_staged(tq, tk, tv, out, lse, tdo, scale, 64),
                    ref):
        _close_grad(o, r)


@pytest.mark.parametrize("Lq,Lk", [(130, 70), (129, 65)])
def test_flash_backward_rounding_points_in_bf16(Lq, Lk):
    """In bf16, the staged backward against autograd of the plain version
    in f32 at the same bf16 inputs (its out and lse from the plain forward
    in bf16, as the kernel's forward saves them), within 2% of each
    gradient's largest magnitude: the tolerance chip_smoke.py holds the
    kernels to on the card."""
    G, d = 2, 96
    rng = np.random.default_rng(30)
    q, k, v = (torch.from_numpy(_arr(rng, (G, n, d))).bfloat16()
               for n in (Lq, Lk, Lk))
    dout = torch.from_numpy(_arr(rng, (G, Lq, d))).bfloat16()
    scale = d ** -0.5
    out, lse = tfa.flash_attention_lse_plain(q, k, v, scale)
    staged = _flash_bwd_staged(q, k, v, out, lse, dout, scale, 64)
    ts = [t.float().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(tfa.flash_attention_plain(*ts, scale), ts,
                              dout.float())
    for i, (o, r) in enumerate(zip(staged, ref)):
        assert o.dtype == torch.bfloat16 and o.shape == r.shape
        err = (o.float() - r).abs().max().item()
        assert err <= 0.02 * r.abs().max().item(), (i, err)


# the forward kernel's tiles (csrc/flash_fwd.cuh: FW_ROWS query rows a
# block, K/V tiles of BW_T keys)
FWD_ROWS, FWD_KEY_TILE = 128, 64


def _flash_fwd_staged(q, k, v, scale, rows=FWD_ROWS, key_tile=FWD_KEY_TILE,
                      qs=None):
    """The attention forward kernel (``csrc/flash_fwd.cuh``) written out in
    plain torch with its schedule and its rounding points to ``q.dtype``
    (none in f32): query tiles of ``rows`` rows (rows past Lq as zeros,
    never returned), K/V tiles of ``key_tile`` keys (keys past Lk as zeros,
    their logits masked to -inf), the running max and row sum of online
    softmax with exp as ``2^(S log2e - m log2e)``, the output rows rescaled
    before each tile's ``P V``, P rounded for that product while l stays
    f32, ``out = acc / l`` rounded, ``lse = m + log l``. ``qs``: the scaled
    query rows where the caller made them (the fused-LN kernel's), else
    ``bf16(q * s)``. Returns ``(out, lse)``."""
    dt = q.dtype
    G, Lq, d = q.shape
    Lk = k.shape[1]
    qs = ((q.float() * tfa._rounded_scale(scale, dt)).to(dt)
          if qs is None else qs).float()
    nq, nk = -(-Lq // rows) * rows, -(-Lk // key_tile) * key_tile
    qp = torch.zeros(G, nq, d)
    qp[:, :Lq] = qs
    kp, vp = torch.zeros(G, nk, d), torch.zeros(G, nk, d)
    kp[:, :Lk], vp[:, :Lk] = k.float(), v.float()
    out, lse = torch.empty(G, nq, d), torch.empty(G, nq)
    log2e = 1.4426950408889634
    for q0 in range(0, nq, rows):
        m = torch.full((G, rows), -torch.inf)
        l, acc = torch.zeros(G, rows), torch.zeros(G, rows, d)
        for k0 in range(0, nk, key_tile):
            s = qp[:, q0:q0 + rows] @ kp[:, k0:k0 + key_tile].transpose(1, 2)
            s[..., torch.arange(k0, k0 + key_tile) >= Lk] = -torch.inf
            mn = torch.maximum(m, s.amax(-1))
            al = torch.exp2((m - mn) * log2e)
            p = torch.exp2(s * log2e - (mn * log2e)[..., None])
            l = l * al + p.sum(-1)
            acc = (acc * al[..., None]
                   + p.to(dt).float() @ vp[:, k0:k0 + key_tile])
            m = mn
        out[:, q0:q0 + rows] = acc / l[..., None]
        lse[:, q0:q0 + rows] = m + torch.log(l)
    return out[:, :Lq].to(dt), lse[:, :Lq]


def _flash_ln_fwd_staged(q, k, v, lnp, scale, eps, flags, add_qn, **tiles):
    """The fused-LN forward (``csrc/flash_attention_ln.cu``) staged in plain
    torch: LN(q), LN(k), LN(v) rows in f32 statistics rounded to
    ``q.dtype`` where ``flags`` says, the query rows ``bf16(bf16(LN q) *
    s)``, the forward core (:func:`_flash_fwd_staged`), then ``out =
    bf16(out + LN q)`` under ``add_qn``. Returns ``(out, lse, o_attn)``."""
    dt = q.dtype
    qn, kn, vn = (tln.layer_norm_plain(x.float(), g.float(), b.float(),
                                       eps).to(dt) if on else x
                  for x, g, b, on in zip((q, k, v), lnp[0::2], lnp[1::2],
                                         flags))
    qs = (qn.float() * tfa._rounded_scale(scale, dt)).to(dt)
    o_attn, lse = _flash_fwd_staged(qn, kn, vn, scale, qs=qs, **tiles)
    out = (o_attn.float() + qn.float()).to(dt) if add_qn else o_attn
    return out, lse, o_attn


# the kernel's tiles, and small ones that give the shapes below several
# query and key tiles (the running max moving, a ragged last tile of each)
_FWD_TILES = [pytest.param({}, id="kernel-tiles"),
              pytest.param({"rows": 32, "key_tile": 16}, id="small-tiles")]


# (Lq, Lk): lengths no tile divides (even and odd), more keys than
# queries, and a single query row
_FWD_LENGTHS = [(130, 70), (129, 65), (64, 130), (1, 65)]


@pytest.mark.parametrize("tiles", _FWD_TILES)
@pytest.mark.parametrize("Lq,Lk", _FWD_LENGTHS)
def test_flash_forward_staged_matches_pallas(Lq, Lk, tiles):
    """The staged forward (``_flash_fwd_staged``) against the JAX padded
    forward and its forward-with-lse (``_flash_fwd_with_lse`` on the
    zero-padded tensors, the padded keys masked) through Pallas in interpret
    mode, in f32, at lengths no tile divides (even and odd), with more keys
    than queries and with one query row."""
    G, d = 2, 16
    rng = np.random.default_rng(32)
    q, k, v = (_arr(rng, (G, n, d), 1.5, 0.3) for n in (Lq, Lk, Lk))
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref = jfa.flash_attention_padded(jq, jk, jv, scale)
    ref_lse_out, res = jfa._flash_padded_fwd(jq, jk, jv, scale)
    ref_lse = np.asarray(res[4]).reshape(G, -1)[:, :Lq]
    out, lse = _flash_fwd_staged(*(torch.from_numpy(a) for a in (q, k, v)),
                                 scale, **tiles)
    _close(out, ref)
    _close(out, ref_lse_out)
    _close(lse, ref_lse)


@pytest.mark.parametrize("add_qn", [True, False])
@pytest.mark.parametrize("tiles", _FWD_TILES)
@pytest.mark.parametrize("flags", [(True, True, True), (False, True, False)])
def test_flash_ln_forward_staged_matches_pallas(flags, tiles, add_qn):
    """The staged fused-LN forward (``_flash_ln_fwd_staged``, with and
    without the v2 residual) against the JAX ``flash_attention_ln`` and its
    forward with lse through Pallas in interpret mode, in f32, at lengths
    no 128-row or 128-key tile divides."""
    G, Lq, Lk, d = 2, 136, 72, 96
    eps = 1e-5
    rng = np.random.default_rng(33)
    q, k, v = (_arr(rng, (G, n, d), 1.5, 0.3) for n in (Lq, Lk, Lk))
    lnp = [a for _ in range(3)
           for a in (_arr(rng, (d,), 0.1, 1.0), _arr(rng, (d,), 0.1))]
    scale = d ** -0.5
    jargs = [jnp.asarray(a) for a in (q, k, v, *lnp)]
    ref = jfa.flash_attention_ln(*jargs, scale, eps, flags, add_qn)
    _, res = jfa._flash_ln_fwd(*jargs, scale, eps, flags, add_qn)
    out, lse, _ = _flash_ln_fwd_staged(
        *(torch.from_numpy(a) for a in (q, k, v)),
        [torch.from_numpy(a) for a in lnp], scale, eps, flags, add_qn,
        **tiles)
    _close(out, ref)
    _close(lse, np.asarray(res[-1]).reshape(G, Lq))


def _within_2pct(got, want):
    """Each output within 2% of its plain version's largest magnitude:
    chip_smoke.py's tolerance for a kernel against its plain version."""
    for i, (o, r) in enumerate(zip(got, want)):
        assert o.shape == r.shape and torch.isfinite(o.float()).all()
        err = (o.float() - r.float()).abs().max().item()
        assert err <= 0.02 * r.float().abs().max().item(), (i, err)


@pytest.mark.parametrize("Lq,Lk", _FWD_LENGTHS)
def test_flash_forward_rounding_points_in_bf16(Lq, Lk):
    """In bf16, the staged forward against the plain version in f32 at the
    same bf16 inputs: out (bf16) and lse within 2%."""
    G, d = 2, 96
    rng = np.random.default_rng(34)
    q, k, v = (torch.from_numpy(_arr(rng, (G, n, d))).bfloat16()
               for n in (Lq, Lk, Lk))
    scale = d ** -0.5
    out, lse = _flash_fwd_staged(q, k, v, scale)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _within_2pct((out, lse), tfa.flash_attention_lse_plain(
        q.float(), k.float(), v.float(), scale))


@pytest.mark.parametrize("flags", [(True, True, True), (False, True, False),
                                   (True, False, True)])
def test_flash_ln_forward_rounding_points_in_bf16(flags):
    """In bf16, the staged fused-LN forward (with the residual) against the
    plain version in f32 at the same bf16 inputs within 2%; the output
    before the residual and lse against the plain forward with lse of the
    rounded LN rows."""
    G, Lq, Lk, d = 2, 136, 72, 96
    eps = 1e-5
    rng = np.random.default_rng(35)
    q, k, v = (torch.from_numpy(_arr(rng, (G, n, d))).bfloat16()
               for n in (Lq, Lk, Lk))
    lnp = [torch.from_numpy(a).bfloat16() for _ in range(3)
           for a in (_arr(rng, (d,), 0.1, 1.0), _arr(rng, (d,), 0.1))]
    scale = d ** -0.5
    out, lse, o_attn = _flash_ln_fwd_staged(q, k, v, lnp, scale, eps, flags,
                                            True)
    ref = tfa.flash_attention_ln_plain(
        *(t.float() for t in (q, k, v, *lnp)), scale, eps, flags, True)
    rows = [tln.layer_norm_plain(x.float(), g.float(), b.float(),
                                 eps).bfloat16() if on else x
            for x, g, b, on in zip((q, k, v), lnp[0::2], lnp[1::2], flags)]
    ref_o, ref_lse = tfa.flash_attention_lse_plain(
        *(t.float() for t in rows), scale)
    _within_2pct((out, lse, o_attn), (ref, ref_lse, ref_o))


def _flash_ln_bwd_staged(q, k, v, lnp, dout, scale, eps, flags, add_qn,
                         qps):
    """The fused-LN backward (``csrc/flash_attention_ln_bwd.cu``) staged in
    plain torch: LN(q), LN(k), LN(v) rows rounded to ``q.dtype`` (f32
    statistics) where ``flags`` says; the dq kernel's query rows written
    already scaled, ``bf16(bf16(LN q) * s)``, and handed to the shared core
    (:func:`_flash_bwd_staged`); the residual's ``dout`` added to LN(q)'s
    gradient under ``add_qn``; then each norm's VJP in f32. Returns the nine
    gradients of :func:`tfa.flash_attention_ln`, zeros where a flag is
    off, and the scaled query rows."""
    dt = q.dtype
    rows, vjps = [], []
    for x, g, b, on in zip((q, k, v), lnp[0::2], lnp[1::2], flags):
        if not on:
            rows.append(x)
            vjps.append(None)
            continue
        xs = [t.float().requires_grad_() for t in (x, g, b)]
        y = tln.layer_norm_plain(*xs, eps)
        rows.append(y.detach().to(dt))
        vjps.append((y, xs))
    qn, kn, vn = rows
    qs = (qn.float() * tfa._rounded_scale(scale, dt)).to(dt)
    o_attn, lse = tfa.flash_attention_lse_plain(qn, kn, vn, scale)
    grads = list(_flash_bwd_staged(qn, kn, vn, o_attn, lse, dout, scale, qps,
                                   qs))
    if add_qn:
        grads[0] = grads[0].float() + dout.float()
    out, params = [], []
    for gr, vjp in zip(grads, vjps):
        if vjp is None:
            out.append(gr)
            params += [torch.zeros(q.shape[-1])] * 2
            continue
        y, xs = vjp
        dx, dg, db = torch.autograd.grad(y, xs, gr.float())
        out.append(dx.to(dt))
        params += [dg, db]
    return (*out, *params), qs


def test_fused_ln_backward_scales_q_rows_once():
    """The fused-LN backward's dq kernel writes the LN(q) rows already
    scaled, and the shared dk/dv core no longer rescales them: staged so,
    the nine gradients against the JAX custom VJP through its Pallas
    backward in f32 (two query splits of 64 rows); in bf16, dk and dv from
    the pre-scaled rows bit for bit what the core gives when it scales the
    unscaled LN(q) rows itself."""
    G, Lq, Lk, d = 2, 128, 64, 16
    flags, add_qn, eps = (True, True, True), True, 1e-5
    rng = np.random.default_rng(31)
    q, k, v = (_arr(rng, (G, n, d), 1.5, 0.3) for n in (Lq, Lk, Lk))
    lnp = [a for _ in range(3)
           for a in (_arr(rng, (d,), 0.1, 1.0), _arr(rng, (d,), 0.1))]
    dout = _arr(rng, (G, Lq, d))
    scale = d ** -0.5
    _, vjp = jax.vjp(
        lambda *a: jfa.flash_attention_ln(*a, scale, eps, flags, add_qn),
        *(jnp.asarray(a) for a in (q, k, v, *lnp)))
    ref = vjp(jnp.asarray(dout))
    staged, _ = _flash_ln_bwd_staged(
        *(torch.from_numpy(a) for a in (q, k, v)),
        [torch.from_numpy(a) for a in lnp], torch.from_numpy(dout), scale,
        eps, flags, add_qn, 64)
    for o, r in zip(staged, ref):
        _close_grad(o, r)

    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16()
                       for a in (q, k, v, dout))
    tlnp = [torch.from_numpy(a).bfloat16() for a in lnp]
    _, qs = _flash_ln_bwd_staged(tq, tk, tv, tlnp, tdo, scale, eps, flags,
                                 False, 64)
    qn, kn, vn = (tln.layer_norm_plain(x.float(), g.float(), b.float(),
                                       eps).bfloat16()
                  for x, g, b in zip((tq, tk, tv), tlnp[0::2], tlnp[1::2]))
    o_attn, lse = tfa.flash_attention_lse_plain(qn, kn, vn, scale)
    pre = _flash_bwd_staged(qn, kn, vn, o_attn, lse, tdo, scale, 64, qs)
    own = _flash_bwd_staged(qn, kn, vn, o_attn, lse, tdo, scale, 64)
    assert qs.dtype == torch.bfloat16
    for got, want in zip(pre[1:], own[1:]):
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def _attn_bwd_cases(steps=(("v2_448", 4), ("v1_224", 8))):
    """Every distinct attention of the given train steps (the MViT-v2 448
    at batch 4 and the cls-token MViT-v1 224 at batch 8 by default):
    ``(G, Lq, Lk, d)``."""
    cfgs = {"v2_448": mvitv2_b_16x4_448_cfg, "v1_224": mvit_b_16x4_224_cfg}
    cases = {}
    for name, batch in steps:
        for call in attention_call_shapes(cfgs[name](), batch):
            cases.setdefault(call, f"{name}-b{batch}")
    return [pytest.param(call, id=f"{name}-" + "-".join(map(str, call)))
            for call, name in cases.items()]


@pytest.mark.parametrize("call", _attn_bwd_cases())
def test_attention_backward_plans_fit_the_card(call):
    """The attention backward's plan at every shape the train steps give
    it: query splits of whole 64-row tiles that cover Lq with no empty
    split, the padded (lse, delta) rows covering them, a dq grid that gives
    every one of the 132 SMs blocks, and each kernel's shared memory
    within a block's 232,448 bytes and low enough for two blocks an SM."""
    G, Lq, Lk, d = call
    p = tfa._attn_bwd_plan(G, Lq, Lk, d, H100_SMS)
    tile = tfa.BWD_TILE
    assert p["qps"] % tile == 0 and p["lqp"] % tile == 0
    assert p["lqp"] - tile < Lq <= p["lqp"]
    assert (p["nsplit"] - 1) * p["qps"] < Lq <= p["nsplit"] * p["qps"]
    assert G * p["lqp"] // tile >= H100_SMS
    for smem in tfa._bwd_smem().values():
        assert smem <= kernels.MAX_SMEM_BYTES
        assert tfa.BWD_BLOCKS_PER_SM * (smem + 1024) <= tfa.SM_SMEM_BYTES


@pytest.mark.parametrize("call", _attn_bwd_cases(
    (("v2_448", 4), ("v1_224", 8), ("v2_448", 1), ("v1_224", 1))))
def test_kernel_splits_fill_the_card_in_whole_steps(call):
    """The dk/dv kernel's query splits at every attention of the v2 and v1
    train steps, batch 1 too: each split a whole number of 64-row tiles,
    and enough splits that the grid (key tiles x G x splits) takes every
    block slot of the card (two an SM), wherever Lq has the tiles for it
    (at most _MAX_SPLITS splits of whole tiles)."""
    G, Lq, Lk, d = call
    p = tfa._attn_bwd_plan(G, Lq, Lk, d, H100_SMS)
    tile = tfa.BWD_TILE
    ntq, nkt = -(-Lq // tile), -(-Lk // tile)
    assert p["qps"] % tile == 0 and p["nsplit"] == -(-Lq // p["qps"])
    most = max(-(-ntq // -(-ntq // n))
               for n in range(1, min(ntq, tfa._MAX_SPLITS) + 1))
    slots = tfa.BWD_BLOCKS_PER_SM * H100_SMS
    assert G * nkt * p["nsplit"] >= min(slots, G * nkt * most)


def test_attention_backward_plan_refuses_what_no_kernel_takes():
    for args in ((4, 1568, 1568, 64), (4, 1568, 1568, 128),
                 (70000, 64, 64, 96), (4, 0, 64, 96)):
        with pytest.raises(ValueError):
            tfa._attn_bwd_plan(*args, H100_SMS)


# ------------------------------------------------ plans of the dense kernels

H100_SMS = 132  # the persistent grids' size on an H100 SXM


def _plan_cases():
    """Every distinct fused_ln_qkv / fused_ln_mlp call of the MViT-v2 448
    forward at batch 8, 4 (training) and 1, and of the cls-token MViT-v1
    224 at batch 8 and 1, with whether the batch is full width."""
    cases = {}
    for name, cfg, batches in (("v2_448", mvitv2_b_16x4_448_cfg(), (8, 4, 1)),
                               ("v1_224", mvit_b_16x4_224_cfg(), (8, 1))):
        for batch in batches:
            for call in dense_call_shapes(cfg, batch):
                cases.setdefault(call, (name, batch))
    return [pytest.param(call, batch > 1, id=f"{name}-b{batch}-" + "-".join(
        map(str, call))) for call, (name, batch) in cases.items()]


def _check_dense_plan(p, full_width):
    assert tfd.MIN_STAGES <= p["stages"] <= 8
    assert p["smem"] <= kernels.MAX_SMEM_BYTES
    if "tn" in p:
        assert p["tn"] % 8 == 0 and p["tn"] <= 256
    assert p["grid"] == min(p["tiles"], H100_SMS)
    if full_width:  # every SM gets tiles
        assert p["tiles"] >= H100_SMS


@pytest.mark.parametrize("call,full_width", _plan_cases())
def test_dense_kernel_plans_fit_the_card(call, full_width):
    """The launch plans of the LN+qkv and LN+MLP kernels at every shape the
    forwards give them: shared memory within a block's 232,448 bytes,
    column tiles a multiple of 8 up to 256, TMA strides of 16 bytes and
    boxes of at most 256 rows, TMA stores of q/k/v only where a consumer's
    64 rows lie in one clip and 16-byte stores only where every run of
    tokens is 16-byte aligned, the persistent grid filling the 132 SMs at
    full width, the fused MLP exactly for C <= 192."""
    if call[0] == "qkv":
        _, M, tokens, D, C = call
        p = tfd._qkv_plan(M, D, C, tokens, H100_SMS)
        _check_dense_plan(p, full_width)
        assert p["store"] == ("tma" if tokens % 64 == 0 else
                              "vec16" if tokens % 8 == 0 else "scalar")
        assert C % p["tn"] == 0  # a tile writes one of q, k, v
        assert p["smem"] == tfd._dense_smem(p["tn"], p["stages"], D, True)
    else:
        _, M, C, H = call
        p = tfd._mlp_plan(M, C, H, C, H100_SMS)
        assert p["fused"] == (C <= 192)
        for sub in ((p,) if p["fused"] else (p["fc1"], p["fc2"])):
            _check_dense_plan(sub, full_width)
    for d in p["tma"]:
        assert d["stride_bytes"] % 16 == 0 and 0 < d["box"][0] <= 256
        assert d["box"][1] * 2 == 128  # the 128-byte swizzle


def test_dense_kernel_plans_refuse_what_no_kernel_takes():
    with pytest.raises(ValueError):
        tfd._qkv_plan(64, 100, 96, 64, 132)  # D % 16
    with pytest.raises(ValueError):
        tfd._qkv_plan(64, 96, 96, 48, 132)  # rows not whole clips
    with pytest.raises(ValueError):
        tfd._mlp_plan(64, 96, 384, 192, 132)  # D != C
    with pytest.raises(ValueError):
        tfd._mlp_plan(64, 128, 512, 128, 132)  # no fused kernel for C 128


def _mlp_bwd_cases():
    """Every LN+MLP backward call of the MViT-v2 448 train step at batch 4
    and 1 and of the cls-token MViT-v1 224 train step at batch 8 and 1
    (the forward's LN+MLP shapes), with whether the batch is full width."""
    cases = {}
    for name, cfg, batches in (("v2_448", mvitv2_b_16x4_448_cfg(), (4, 1)),
                               ("v1_224", mvit_b_16x4_224_cfg(), (8, 1))):
        for batch in batches:
            for call in dense_call_shapes(cfg, batch):
                if call[0] == "mlp":
                    cases.setdefault(call, (name, batch))
    return [pytest.param(call, batch > 1, id=f"{name}-b{batch}-" + "-".join(
        map(str, call))) for call, (name, batch) in cases.items()]


@pytest.mark.parametrize("call,full_width", _mlp_bwd_cases())
def test_mlp_backward_plans_fit_the_card(call, full_width):
    """The LN+MLP backward's launch plan at every shape the train steps
    give it: shared memory within a block's 232,448 bytes (the dual GEMM
    on a ring of at least 3 stages), TMA strides of 16 bytes and boxes of
    at most 256 rows, the channel-major copies' row stride M rounded up to
    8 (odd M at batch 1), the weight gradients' split-K runs in whole
    64-deep chunks covering M with no empty split, the LN backward's blocks covering M, and the
    persistent grids filling the 132 SMs at full width, and the scratch
    laid out in one workspace."""
    _, M, C, H = call
    p = tfd._mlp_bwd_plan(M, C, H, H100_SMS)
    assert p["ld"] % 8 == 0 and M <= p["ld"] < M + 8
    dual = p["dual"]
    assert dual["tn"] == tfd.MLP_BWD_TN and H % dual["tn"] == 0
    assert tfd.MLP_BWD_MIN_STAGES <= dual["stages"] <= 8
    assert dual["smem"] <= kernels.MAX_SMEM_BYTES
    assert dual["smem"] == tfd._dual_smem(dual["tn"], dual["stages"])
    assert dual["grid"] == min(dual["tiles"], H100_SMS)
    assert p["prep"]["smem"] <= kernels.MAX_SMEM_BYTES
    for k in ("dxn", "dw1", "dw2"):
        _check_dense_plan(p[k], full_width)
    for k, K in (("dw1", M), ("dw2", M)):
        q = p[k]
        assert q["split_rows"] == 64 * q["chunks"]
        assert q["split_rows"] >= min(tfd.SPLIT_MIN_ROWS, 64 * -(-K // 64))
        assert (q["splits"] - 1) * q["split_rows"] < K <= (
            q["splits"] * q["split_rows"])
    ln = p["ln"]
    assert (ln["blocks"] - 1) * ln["rows"] < M <= ln["blocks"] * ln["rows"]
    if full_width:
        assert dual["tiles"] >= H100_SMS
    for d in p["tma"]:
        assert d["stride_bytes"] % 16 == 0 and 0 < d["box"][0] <= 256
    # the workspace: 14 scratch tensors, 256-byte aligned, none overlapping
    ws = p["scratch"]
    assert len(ws["offsets"]) == len(ws["sizes"]) == 14
    ends = [o + n for o, n in zip(ws["offsets"], ws["sizes"])]
    assert all(o % 256 == 0 for o in ws["offsets"])
    assert all(e <= o for e, o in zip(ends, ws["offsets"][1:]))
    assert ends[-1] <= ws["bytes"]
    assert len(p["ints"]) == 18


def test_mlp_backward_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        tfd._mlp_bwd_plan(64, 100, 400, 132)  # C % 8
    with pytest.raises(ValueError):
        tfd._mlp_bwd_plan(64, 96, 352, 132)  # H not whole hidden tiles
    with pytest.raises(ValueError):
        tfd._mlp_bwd_plan(64, 1280, 5120, 132)  # C > 1152
    with pytest.raises(ValueError):
        tfd._mlp_bwd_plan(0, 96, 384, 132)  # no rows


def _qkv_bwd_cases():
    """Every LN+qkv backward call of the MViT-v2 448 train step at batch 4
    and 1 and of the cls-token MViT-v1 224 train step at batch 8 and 1
    (the forward's LN+qkv shapes), with whether the batch is full width."""
    cases = {}
    for name, cfg, batches in (("v2_448", mvitv2_b_16x4_448_cfg(), (4, 1)),
                               ("v1_224", mvit_b_16x4_224_cfg(), (8, 1))):
        for batch in batches:
            for call in dense_call_shapes(cfg, batch):
                if call[0] == "qkv":
                    cases.setdefault(call, (name, batch))
    return [pytest.param(call, batch > 1, id=f"{name}-b{batch}-" + "-".join(
        map(str, call))) for call, (name, batch) in cases.items()]


@pytest.mark.parametrize("call,full_width", _qkv_bwd_cases())
def test_qkv_backward_plans_fit_the_card(call, full_width):
    """The LN+qkv backward's launch plan at every shape the train steps
    give it: shared memory within a block's 232,448 bytes, TMA strides of
    16 bytes and boxes of at most 256 rows, the channel-major copies' row
    stride M rounded up to 8 (odd M at batch 1), dW's split-K runs in whole
    64-deep chunks covering M with no empty split, the pre-pass's and the
    LN backward's blocks covering M, the GEMMs' persistent grids filling
    the 132 SMs at full width, and the scratch laid out in one workspace
    with no overlaps."""
    _, M, tokens, D, C = call
    p = tfd._qkv_bwd_plan(M, D, C, tokens, H100_SMS)
    assert p["ld"] % 8 == 0 and M <= p["ld"] < M + 8
    prep, grad = p["prep"], p["grad"]
    assert prep["smem"] <= kernels.MAX_SMEM_BYTES
    assert prep["blocks"] * tfd.PREP_ROWS >= M
    # the gradients' pass: whole 96-channel chunks, at least one 64-token
    # tile a block, about QKV_GRAD_BLOCKS_PER_SM blocks a SM in all
    assert grad["chunks"] * tfd.QKV_GRAD_GC == 3 * C
    assert 1 <= grad["blocks"] <= -(-M // tfd.QKV_GRAD_TOKENS)
    assert grad["blocks"] * grad["chunks"] <= max(
        grad["chunks"], tfd.QKV_GRAD_BLOCKS_PER_SM * H100_SMS)
    assert grad["smem"] <= kernels.MAX_SMEM_BYTES
    for k in ("dxn", "dw"):
        _check_dense_plan(p[k], full_width)
    q = p["dw"]
    assert q["split_rows"] == 64 * q["chunks"]
    assert q["split_rows"] >= min(tfd.SPLIT_MIN_ROWS, 64 * -(-M // 64))
    assert (q["splits"] - 1) * q["split_rows"] < M <= (
        q["splits"] * q["split_rows"])
    ln = p["ln"]
    assert (ln["blocks"] - 1) * ln["rows"] < M <= ln["blocks"] * ln["rows"]
    for d in p["tma"]:
        assert d["stride_bytes"] % 16 == 0 and 0 < d["box"][0] <= 256
        # loads in the 128-byte swizzle; g's stores from dense boxes
        assert d["box"][1] * 2 == 128 or (
            d["tensor"] == "g store" and d["swizzle"] == 0)
    # dW reads q, k, v in place where a 64-token chunk lies in one clip
    # (in boxes that lie in one of them), else a packed copy g^T (the fifth
    # scratch tensor)
    in_place = tokens % 64 == 0
    assert (p["tma"][2]["tensor"] == "q, k, v") == in_place
    if in_place:
        assert C % p["tma"][2]["box"][0] == 0
    # the workspace: 9 scratch tensors, 256-byte aligned, none overlapping
    ws = p["scratch"]
    assert (ws["sizes"][4] == 0) == in_place
    assert len(ws["offsets"]) == len(ws["sizes"]) == 9
    ends = [o + n for o, n in zip(ws["offsets"], ws["sizes"])]
    assert all(o % 256 == 0 for o in ws["offsets"])
    assert all(e <= o for e, o in zip(ends, ws["offsets"][1:]))
    assert ends[-1] <= ws["bytes"]
    assert len(p["ints"]) == 13 and p["ints"][-1] == (
        p["tma"][2]["box"][0] if in_place else 0)


def test_qkv_backward_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        tfd._qkv_bwd_plan(64, 100, 96, 64, 132)  # D % 8
    with pytest.raises(ValueError):
        tfd._qkv_bwd_plan(64, 1280, 96, 64, 132)  # D > 1152
    with pytest.raises(ValueError):
        tfd._qkv_bwd_plan(64, 96, 44, 64, 132)  # C % 8
    with pytest.raises(ValueError):
        tfd._qkv_bwd_plan(64, 96, 96, 48, 132)  # rows not whole clips
    with pytest.raises(ValueError):
        tfd._qkv_bwd_plan(0, 96, 96, 1, 132)  # no rows
