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
from aicity_action_tpu_torch.ops import flash_attention as tfa
from aicity_action_tpu_torch.ops import fused_dense as tfd
from aicity_action_tpu_torch.ops import kernels
from aicity_action_tpu_torch.ops import layer_norm as tln
from torch_port_helpers import dense_call_shapes
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


@pytest.mark.parametrize("m,d,variant", [(64, 96, "whole"),
                                         (16, 512, "hsplit")])
def test_fused_ln_mlp_backward_matches_pallas(m, d, variant):
    """Both Pallas backward variants: whole weights, and the hidden-split
    one the JAX package takes when the weights do not fit (C = 768 at 448;
    reached here at C = 512)."""
    h = 4 * d
    assert jfd.ln_mlp_bwd_supported(m, d, h, d) == (variant == "whole")
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
    out = _grads(lambda *a: tfd.fused_ln_mlp(*a, 1e-6),
                 (x, g, b, w1.T.copy(), b1, w2.T.copy(), b2), (dout,))
    for o, r in zip(out, ref):
        _close_grad(o, r)


@pytest.mark.parametrize("Lq,Lk", [(1 + 4 * 4 * 4, 1 + 2 * 2 * 2),
                                   (1 + 2 * 2 * 2, 1 + 4 * 4 * 4)])
def test_flash_attention_padded_matches_pallas(Lq, Lk):
    """A cls token's odd lengths 1 + T*H*W: the port's padded attention
    (its plain version here; on the card the kernels' edge masks) against
    the JAX wrapper that zero-pads q, k, v and masks the padded keys,
    forward and VJP."""
    G, d = 2, 16
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


def test_kernel_splits_fill_the_card_in_whole_steps():
    """Rows per split of the backward kernels: multiples of the step, at
    least min_rows, and splits x tiles within 5% of the target block count
    (rounding the rows up to whole steps loses a few splits)."""
    for rows, tiles, step in ((401408, 3, 32), (6272, 192, 32),
                              (100352, 100, 64), (100, 1, 64)):
        rps = kernels.splits(rows, tiles, step)
        n = -(-rows // rps)
        assert rps % step == 0 and rps >= 256
        assert (n == 1 or n * tiles >= 0.95 * kernels.SPLIT_TARGET_BLOCKS
                or rps == 256)


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
