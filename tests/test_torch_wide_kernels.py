"""The kernels widened to MViT-v2-L's widths (head dim 72, 144-1152
channels), on the CPU, where each wrapper runs its plain version, against
the JAX package's Pallas kernels in interpret mode; and their launch plans
at every call of the L model's forward and, for the backwards, of its
batch-4 train step.

Inputs are made with numpy from a seed and fed to both in f32. Tolerance:
max abs error 2e-5, as ``test_torch_kernels.py`` holds the B widths (f32
arithmetic; the two sum in different orders, and the Pallas MLP's erf
polynomial is within 1.5e-7 of the exact erf)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicity_action_tpu.ops.pallas import flash_attention as jfa
from aicity_action_tpu.ops.pallas import fused_dense as jfd
from aicity_action_tpu.ops.pallas import layer_norm as jln
from aicity_action_tpu_torch.config import mvitv2_l_16x4_448_cfg
from aicity_action_tpu_torch.models.mvit import (attention_call_shapes,
                                                build_mvit_spec,
                                                dense_call_shapes,
                                                pool_norm_call_shapes)
from aicity_action_tpu_torch.ops import flash_attention as tfa
from aicity_action_tpu_torch.ops import fused_dense as tfd
from aicity_action_tpu_torch.ops import kernels
from aicity_action_tpu_torch.ops import layer_norm as tln
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = 2e-5
H100_SMS = 132  # the persistent grids' size on an H100 SXM
D_L = 72  # MViT-v2-L's head dim


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


# ------------------------------------------------------ kernels at L widths

@pytest.mark.parametrize("flags,add_qn", [
    ((True, True, True), True), ((True, True, True), False),
    ((False, True, False), True), ((True, False, True), False)])
def test_flash_attention_ln_head_dim_72_matches_pallas(flags, add_qn):
    rng = np.random.default_rng(40)
    G, Lq, Lk = 2, 64, 16
    q, k, v = (_arr(rng, (G, n, D_L), 1.5, 0.3) for n in (Lq, Lk, Lk))
    lnp = [a for _ in range(3)
           for a in (_arr(rng, (D_L,), 0.1, 1.0), _arr(rng, (D_L,), 0.1))]
    scale = D_L ** -0.5
    ref = jfa.flash_attention_ln(*(jnp.asarray(a) for a in (q, k, v, *lnp)),
                                 scale, 1e-5, flags, add_qn)
    out = tfa.flash_attention_ln(*(torch.from_numpy(a)
                                   for a in (q, k, v, *lnp)),
                                 scale, 1e-5, flags, add_qn)
    assert out.shape == (G, Lq, D_L)
    _close(out, ref)


@pytest.mark.parametrize("Lq,Lk", [(64, 16), (128, 80)])
def test_flash_attention_head_dim_72_matches_pallas(Lq, Lk):
    rng = np.random.default_rng(41)
    q, k, v = (_arr(rng, (2, n, D_L)) for n in (Lq, Lk, Lk))
    scale = D_L ** -0.5
    ref = jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), scale)
    out = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              scale)
    _close(out, ref)


@pytest.mark.parametrize("d,c", [(144, 144), (1152, 1152)])
def test_fused_ln_qkv_at_l_widths_matches_pallas(d, c):
    """q, k, v come channel-major, [B, C, L], as the pool convs take."""
    rng = np.random.default_rng(42)
    m, tokens = 64, 32
    x = _arr(rng, (m, d))
    g, b = _arr(rng, (d,), 0.1, 1.0), _arr(rng, (d,), 0.1)
    w = _arr(rng, (d, 3 * c), d ** -0.5)  # JAX layout [D, 3C]
    bb = _arr(rng, (3 * c,), 0.1)
    ref = jfd.fused_ln_qkv(*(jnp.asarray(a) for a in (x, g, b, w, bb)),
                           1e-6)
    out = tfd.fused_ln_qkv(torch.from_numpy(x), torch.from_numpy(g),
                           torch.from_numpy(b), torch.from_numpy(w.T.copy()),
                           torch.from_numpy(bb), 1e-6, tokens=tokens)
    for o, r in zip(out, ref):
        assert o.shape == (m // tokens, c, tokens) and o.is_contiguous()
        _close(o.transpose(1, 2).reshape(m, c), r)


def test_fused_ln_mlp_at_144_matches_pallas():
    rng = np.random.default_rng(43)
    m, c, h = 64, 144, 576
    x = _arr(rng, (m, c))
    g, b = _arr(rng, (c,), 0.1, 1.0), _arr(rng, (c,), 0.1)
    w1, b1 = _arr(rng, (c, h), c ** -0.5), _arr(rng, (h,), 0.1)
    w2, b2 = _arr(rng, (h, c), h ** -0.5), _arr(rng, (c,), 0.1)
    ref = jfd.fused_ln_mlp(*(jnp.asarray(a) for a in (x, g, b, w1, b1, w2,
                                                      b2)), 1e-6)
    out = tfd.fused_ln_mlp(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b),
        torch.from_numpy(w1.T.copy()), torch.from_numpy(b1),
        torch.from_numpy(w2.T.copy()), torch.from_numpy(b2), 1e-6)
    _close(out, ref)


@pytest.mark.parametrize("rows,channels,groups", [(32, 1152, 1),
                                                  (48, 144, 2)])
def test_fused_layer_norm_at_l_widths_matches_pallas(rows, channels, groups):
    """The final norm's 1152 channels, and the pool norm's 72 a head."""
    rng = np.random.default_rng(44)
    x = _arr(rng, (rows, channels), 2.0, 0.5)
    dg = channels // groups
    g, b = _arr(rng, (dg,), 0.1, 1.0), _arr(rng, (dg,), 0.1)
    ref = jln.fused_layer_norm(jnp.asarray(x), jnp.asarray(g),
                               jnp.asarray(b), 1e-6, groups)
    out = tln.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(b), 1e-6, groups)
    _close(out, ref)


# ------------------------------------------------- plans of the L forward

def _l_calls(batches=(8, 1)):
    """Every distinct kernel call of the MViT-v2-L @448 forward at
    ``batches`` (8 and 1: the eval paths; 4: the train step, whose
    backwards take the same shapes): LN+qkv and LN+MLP
    (``dense_call_shapes``), the attention of both paths
    (``attention_call_shapes``), the unfused path's pool norms
    (``pool_norm_call_shapes``, the rows instance over head dim 72) and the
    final norm."""
    cfg = mvitv2_l_16x4_448_cfg()
    sp = build_mvit_spec(cfg)
    calls = {}
    for batch in batches:
        for call in dense_call_shapes(cfg, batch):
            calls.setdefault(call, batch)
        for G, Lq, Lk, d in attention_call_shapes(cfg, batch):
            calls.setdefault(("attn", G, Lq, Lk, d), batch)
        for _, _, b, h, d, L in pool_norm_call_shapes(sp, batch):
            calls.setdefault(("ln", b, L, h * d, h), batch)
        calls.setdefault(("ln", batch, 1568, sp.blocks[-1].dim_out, 1),
                         batch)
    return [pytest.param(call, id=f"b{batch}-" + "-".join(map(str, call)))
            for call, batch in calls.items()]


@pytest.mark.parametrize("call", _l_calls())
def test_every_l_call_has_a_launch_plan(call):
    """Every call of the L forward gets a launch plan on an H100 (132
    SMs), so no call raises on the card; among them every call where the
    JAX package's predicate sends the call to a Pallas kernel, which is
    every call but the LN+MLP at 1152 channels (XLA there: its weights
    pass the predicate's VMEM budget; the port runs its kernel all the
    same). The dense plans fit a block's shared memory and write one of
    q, k, v a tile."""
    kind = call[0]
    if kind == "qkv":
        _, M, tokens, D, C = call
        p = tfd._qkv_plan(M, D, C, tokens, H100_SMS)
        assert C % p["tn"] == 0 and p["smem"] <= kernels.MAX_SMEM_BYTES
        jax_pallas = jfd.ln_qkv_supported(M, D, 3 * C)
    elif kind == "mlp":
        _, M, C, H = call
        p = tfd._mlp_plan(M, C, H, C, H100_SMS)
        assert p["fused"] == (C in tfd.FUSED_MLP_WIDTHS)
        for sub in ((p,) if p["fused"] else (p["fc1"], p["fc2"])):
            assert sub["smem"] <= kernels.MAX_SMEM_BYTES
        jax_pallas = jfd.ln_mlp_supported(M, C, H, C)
    elif kind == "attn":
        _, G, Lq, Lk, d = call
        assert d == D_L
        p = tfa._attn_fwd_plan(G, Lq, Lk, d, False)
        assert p["grid"] == (-(-Lq // 128), G) and Lq % 8 == 0
        assert p["last"] in (16, 32, 64)
        jax_pallas = (jfa.flash_attention_ln_supported(Lq, Lk, d)
                      and jfa.flash_attention_supported(Lq, Lk, d))
    else:
        _, B, L, C, groups = call
        p = tln._ln_plan("rows", (B * L, C, groups), H100_SMS)
        dg = C // groups
        assert p["lanes"] * p["vpl"] * 8 >= dg
        assert p["blocks"] * (p["threads"] // p["lanes"]) >= B * L * groups
        jax_pallas = jln.layer_norm_supported((B, L, C), groups)
    assert jax_pallas == (call[:1] + call[2:3] != ("mlp", 1152))


@pytest.mark.parametrize("call", _l_calls((4,)))
def test_every_l_train_call_has_a_backward_plan(call):
    """Every kernel-row call of the L batch-4 train step on either switch
    gets a backward launch plan on an H100 (132 SMs) that fits a block's
    shared memory: the attention with its logsumexp forward and backward
    at head dim 72 (the default switch's rows 2-3, and under
    ``AICITY_TPU_FUSE_ATTN_LN=1`` the fused-LN rows 6-7 on the same grids,
    whose dq kernel's shared memory at head dim 72 leaves room for two
    blocks an SM), the LN+qkv backward at
    D 144-1152 (its gradients' pass ragged where 96 does not divide 3C),
    the LN+MLP backward at C 144-1152 (a 64-wide dual-GEMM tile where 128
    does not divide H) and the rows LayerNorm backward (the pool norms over
    72, the final norm over 1152: the wide instance)."""
    kind = call[0]
    smem = kernels.MAX_SMEM_BYTES
    if kind == "qkv":
        _, M, tokens, D, C = call
        p = tfd._qkv_bwd_plan(M, D, C, tokens, H100_SMS)
        assert p["grad"]["chunks"] == -(-3 * C // 96)
        for sub in (p["dxn"], p["dw"]):
            assert sub["smem"] <= smem
        assert p["prep"]["smem"] <= smem and p["grad"]["smem"] <= smem
        box = p["ints"][-1]  # dW's A in place where tokens % 64 == 0
        assert bool(box) == (tokens % 64 == 0)
        assert not box or (C % box == 0 and 128 % box == 0 and box % 8 == 0)
    elif kind == "mlp":
        _, M, C, H = call
        p = tfd._mlp_bwd_plan(M, C, H, H100_SMS)
        assert p["dual"]["tn"] == (128 if H % 128 == 0 else 64)
        assert H % p["dual"]["tn"] == 0
        for sub in (p["dual"], p["dxn"], p["dw1"], p["dw2"]):
            assert sub["smem"] <= smem
        assert p["prep"]["smem"] <= smem
    elif kind == "attn":
        _, G, Lq, Lk, d = call
        assert d == D_L
        tfa._attn_fwd_plan(G, Lq, Lk, d, True)
        tfa.require_ln_training_head_dim(d)
        p = tfa._attn_bwd_plan(G, Lq, Lk, d, H100_SMS)
        assert p["qps"] % tfa.BWD_TILE == 0 and p["lqp"] >= Lq
        assert Lq % 8 == 0  # the fused-LN kernels' d-major q
        for width in (96, d):
            for n in tfa._bwd_smem(width).values():
                assert n <= smem
                assert tfa.BWD_BLOCKS_PER_SM * (n + 1024) <= tfa.SM_SMEM_BYTES
        assert tfa._bwd_smem(d)["ln_dq"] < tfa._bwd_smem()["ln_dq"]
    else:
        _, B, L, C, groups = call
        p = tln._ln_plan("rows_bwd", (B * L, C, groups), H100_SMS)
        dg = C // groups
        assert p["lanes"] * p["vpl"] * 8 >= dg and p["smem"] <= smem
        assert p["vpl"] == (tln.LN_WIDE_VPL if dg > 768 else tln.LN_VPL)


def test_l_width_training_kernels_still_raise():
    """What the training kernels take and what they still refuse: the
    fused-LN training rows 6 and 7 (the logsumexp forward and the backward
    of ``flash_attention_ln``, ``AICITY_TPU_FUSE_ATTN_LN=1``) take head dims
    96 and 72; head dims 64, 80 and 128, which no configuration has, raise
    in every attention plan and in the fused-LN rows' check before any
    launch; the rows LayerNorm backward past 1280 channels raises."""
    for d in tfa.FWD_HEAD_DIMS:
        tfa.require_ln_training_head_dim(d)
    assert set(tfa.FWD_HEAD_DIMS) == {96, D_L}
    for d in (64, 80, 128):
        for with_lse in (False, True):
            with pytest.raises(ValueError):
                tfa._attn_fwd_plan(16, 1568, 1568, d, with_lse)
        with pytest.raises(ValueError):
            tfa._attn_bwd_plan(16, 1568, 1568, d, H100_SMS)
        with pytest.raises(ValueError, match="flash_attention_ln"):
            tfa.require_ln_training_head_dim(d)
    with pytest.raises(ValueError):
        tln._ln_plan("rows_bwd", (12544, 1288, 1), H100_SMS)


@pytest.mark.parametrize("dg,lanes,vpl", [(72, 4, 3), (768, 32, 3),
                                          (776, 32, 5), (1152, 32, 5),
                                          (1280, 32, 5)])
def test_rows_layer_norm_plan_widens_past_768(dg, lanes, vpl):
    p = tln._ln_plan("rows", (100, dg, 1), H100_SMS)
    assert (p["lanes"], p["vpl"]) == (lanes, vpl)
    with pytest.raises(ValueError):
        tln._ln_plan("rows", (100, 1288, 1), H100_SMS)


@pytest.mark.parametrize("C,tn", [(144, 144), (288, 144), (96, 96),
                                  (768, 192)])
def test_qkv_plan_picks_a_tile_that_divides_c(C, tn):
    """C = 144 takes the 144-column tile (neither 96 nor 192 divides it);
    the B widths keep theirs."""
    for M, tokens in ((8 * 1568, 1568), (8 * 100352, 100352)):
        p = tfd._qkv_plan(M, C, C, tokens, H100_SMS)
        assert C % p["tn"] == 0
    assert tfd._qkv_plan(8 * 1568, C, C, 1568, H100_SMS)["tn"] == tn
