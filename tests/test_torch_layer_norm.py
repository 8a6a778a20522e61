"""The port's grouped LayerNorm instances on the CPU (rows 12-13).

- The channel-major pool norm's plain path (``pool_norm_rows``), forward and
  VJP, against the JAX package's ``fused_layer_norm`` with ``groups=h`` on
  the token-major transpose of the same numpy input, in f32, its Pallas
  kernels in interpret mode: 1e-5 absolute forward, rtol 1e-4 / atol 1e-5
  gradients (f32 sums over d channels and every token taken in other
  orders).
- The backward kernels' partition written out in plain torch (the plan's
  tiles or segments, blocks, per-block f32 slabs and their fixed-order
  sum) against the plain VJP in f32, at the same tolerance.
- The launch plans at every pool norm and final norm of the v2 448 (batch
  4 and 8) and v1 224 (batch 8) paths: pure arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicity_action_tpu.ops.pallas import flash_attention as jfa
from aicity_action_tpu.ops.pallas import layer_norm as jln
from aicity_action_tpu_torch.config import (mvit_b_16x4_224_cfg,
                                            mvitv2_b_16x4_448_cfg)
from aicity_action_tpu_torch.models.mvit import (attention_call_shapes,
                                                build_mvit_spec,
                                                pool_norm_call_shapes)
from aicity_action_tpu_torch.ops import kernels
from aicity_action_tpu_torch.ops import layer_norm as tln
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

H100_SMS = 132
EPS = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _inputs(B, h, d, L, seed=0):
    rng = np.random.default_rng(seed)
    t = (rng.standard_normal((B, h * d, L)) * 2.0 + 0.5).astype(np.float32)
    g = (rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32)
    b = (rng.standard_normal(d) * 0.1).astype(np.float32)
    dy = rng.standard_normal((B * h, L, d)).astype(np.float32)
    return t, g, b, dy


def _token_major(t):
    """``[B, h*d, L]`` -> the ``[B, L, h*d]`` the JAX grouped LN takes."""
    return np.ascontiguousarray(t.transpose(0, 2, 1))


def _rows_to_tokens(r, B, h):
    """Head-major rows ``[B*h, L, d]`` -> ``[B, L, h*d]``."""
    _, L, d = r.shape
    return np.ascontiguousarray(
        r.reshape(B, h, L, d).transpose(0, 2, 1, 3).reshape(B, L, h * d))


SHAPES = [(2, 1, 96, 24), (2, 2, 32, 16), (1, 4, 96, 8)]


@pytest.mark.parametrize("B,h,d,L", SHAPES)
def test_pool_norm_rows_matches_grouped_pallas(B, h, d, L):
    t, g, b, _ = _inputs(B, h, d, L)
    ref = jln.fused_layer_norm(jnp.asarray(_token_major(t)), jnp.asarray(g),
                               jnp.asarray(b), EPS, h)
    out = tln.pool_norm_rows(torch.from_numpy(t), torch.from_numpy(g),
                             torch.from_numpy(b), EPS, h)
    assert out.shape == (B * h, L, d)
    np.testing.assert_allclose(_rows_to_tokens(out.numpy(), B, h),
                               np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,h,d,L", SHAPES)
def test_pool_norm_rows_vjp_matches_grouped_pallas(B, h, d, L):
    t, g, b, dy = _inputs(B, h, d, L, seed=1)
    _, vjp = jax.vjp(lambda *a: jln.fused_layer_norm(*a, EPS, h),
                     *(jnp.asarray(a) for a in (_token_major(t), g, b)))
    rdx, rdg, rdb = vjp(jnp.asarray(_rows_to_tokens(dy, B, h)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (t, g, b)]
    out = tln.pool_norm_rows(*ts, EPS, h)
    dx, dg, db = torch.autograd.grad(out, ts, torch.from_numpy(dy))
    close = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx).transpose(0, 2, 1),
                               **close)
    np.testing.assert_allclose(dg.numpy(), np.asarray(rdg), **close)
    np.testing.assert_allclose(db.numpy(), np.asarray(rdb), **close)
    # the wrapper's backward entry point gives the same on the CPU
    for o, r in zip(tln.pool_norm_rows_bwd(*(torch.from_numpy(a) for a in
                                             (t, g)),
                                           torch.from_numpy(dy), EPS, h),
                    (dx, dg, db)):
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=0, atol=0)


def _ln_vjp_rows(x, gamma, dy):
    """dx of a LayerNorm over the last axis of f32 rows ``x`` for ``dy``,
    with the per-row terms (xhat, dy): the kernels' arithmetic."""
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + EPS)
    xh = xc * rstd
    e = dy * gamma
    dx = rstd * (e - e.mean(-1, keepdim=True)
                 - xh * (e * xh).mean(-1, keepdim=True))
    return dx, xh


def _sum_in_order(slabs):
    total = torch.zeros_like(slabs[0])
    for s in slabs:
        total = total + s
    return total


def _fixed_order_sum(slabs):
    """The backwards' slab tree: each group of SLAB_GROUP slabs summed in
    order, then the groups' sums in order."""
    g = tln.SLAB_GROUP
    return _sum_in_order([_sum_in_order(slabs[i:i + g])
                          for i in range(0, len(slabs), g)])


def _cols_bwd_staged(t, gamma, dy, heads, plan):
    """The channel-major backward as its launch runs it: block j takes
    tiles j, j + blocks, ... of the (group, tile-token run) queue, each an
    x box [d][tile] (tokens past L absent) and its dy rows; it writes the
    tile's dx columns and adds its tokens to its f32 slab; the slabs are
    then summed in order."""
    B, C, L = t.shape
    d = C // heads
    G, tile = B * heads, plan["tile"]
    per_group = -(-L // tile)
    xr = t.reshape(G, d, L)
    dx = torch.full_like(xr, float("nan"))
    slabs = torch.zeros(plan["slabs"], 2, d)
    for blk in range(plan["blocks"]):
        for k in range(blk, G * per_group, plan["blocks"]):
            g, l0 = k // per_group, (k % per_group) * tile
            xs = xr[g, :, l0:l0 + tile].t()
            dys = dy[g, l0:l0 + tile]
            dxs, xh = _ln_vjp_rows(xs, gamma, dys)
            dx[g, :, l0:l0 + tile] = dxs.t()
            slabs[blk, 0] += (dys * xh).sum(0)
            slabs[blk, 1] += dys.sum(0)
    dgb = _fixed_order_sum(slabs)
    return dx.reshape(B, C, L), dgb[0], dgb[1]


def _rows_bwd_staged(x, gamma, dy, groups, plan):
    """The rows backward as its launch runs it: segment s (row, group) goes
    to block (s mod (blocks * per block)) // per block, per block =
    LN_BWD_THREADS / lanes groups of lanes walking the segments with the
    grid's stride; one slab a block, summed in order."""
    M, C = x.shape
    dg = C // groups
    xs, dys = x.reshape(-1, dg), dy.reshape(-1, dg)
    per_block = tln.LN_BWD_THREADS // plan["lanes"]
    seg = torch.arange(xs.shape[0])
    owner = (seg % (plan["blocks"] * per_block)) // per_block
    dx, xh = _ln_vjp_rows(xs, gamma, dys)
    slabs = torch.stack([
        torch.stack([(dys * xh)[owner == b].sum(0), dys[owner == b].sum(0)])
        for b in range(plan["blocks"])])
    dgb = _fixed_order_sum(slabs)
    return dx.reshape(M, C), dgb[0], dgb[1]


@pytest.mark.parametrize("B,h,L,sms", [(1, 3, 200, 2), (2, 1, 64, 1),
                                       (2, 2, 136, 4), (3, 2, 520, 10)])
def test_pool_norm_backward_staged_matches_vjp(B, h, L, sms):
    """The channel-major backward's tiles and slabs, at plans of a small
    card so that blocks take several tiles, ragged ones (L % 64 != 0)
    among them."""
    t, g, b, dy = (torch.from_numpy(a) for a in _inputs(B, h, 96, L, 2))
    plan = tln._ln_plan("cols_bwd", (B * h, 96, L), sms)
    assert plan["blocks"] > 1 or B * h * -(-L // plan["tile"]) == 1
    out = _cols_bwd_staged(t, g, dy, h, plan)
    ref = tln.pool_norm_rows_bwd_plain(t, g, dy, EPS, h)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("M,C,groups,sms", [(70, 96, 1, 2), (33, 192, 2, 3),
                                            (9, 768, 1, 1), (50, 64, 1, 5),
                                            (2000, 96, 1, 20)])
def test_layer_norm_rows_backward_staged_matches_vjp(M, C, groups, sms):
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((M, C)) * 2 + 0.5)
                         .astype(np.float32))
    dg = C // groups
    g = torch.from_numpy((rng.standard_normal(dg) * 0.1 + 1)
                         .astype(np.float32))
    b = torch.zeros(dg)
    dy = torch.from_numpy(rng.standard_normal((M, C)).astype(np.float32))
    plan = tln._ln_plan("rows_bwd", (M, C, groups), sms)
    out = _rows_bwd_staged(x, g, dy, groups, plan)
    ts = [a.clone().requires_grad_() for a in (x, g, b)]
    ref = torch.autograd.grad(
        tln.layer_norm_plain(*ts, EPS, groups), ts, dy)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-5)


def _norm_cases():
    """Every distinct (instance, shape) of the pool norms and the final
    norm of the v2 448 batch-4 train step and batch-8 forward and the v1
    224 batch-8 step."""
    cases = {}
    for label, cfg_fn, batch in (("v2_448", mvitv2_b_16x4_448_cfg, 4),
                                 ("v2_448", mvitv2_b_16x4_448_cfg, 8),
                                 ("v1_224", mvit_b_16x4_224_cfg, 8)):
        cfg = cfg_fn()
        sp = build_mvit_spec(cfg)
        cls = bool(sp.cls_embed)
        for _, _, B, h, d, L in pool_norm_call_shapes(sp, batch):
            cases.setdefault((B, h, d, L, cls), f"{label}-b{batch}")
        _, tokens, _, _ = attention_call_shapes(cfg, batch)[-1]
        cases.setdefault(("final", batch * tokens, sp.blocks[-1].dim_out),
                         f"{label}-b{batch}")
    return [pytest.param(case, id=f"{name}-" + "-".join(map(str, case)))
            for case, name in cases.items()]


@pytest.mark.parametrize("case", _norm_cases())
def test_layer_norm_plans_fit_the_card(case):
    """The plans at every norm of the main paths: the channel-major
    instance exactly where L % 8 == 0 and there is no cls token, its TMA
    descriptor legal (16-byte row stride, a box of at most 256 rows and
    columns with whole 16-byte rows), the tiles covering every token once,
    shared memory within a block's 227 KB and the blocks an SM it plans;
    one f32 slab a backward block, none forward; the rows instance's lanes
    covering a group with three 16-byte vectors each."""
    if case[0] == "final":
        _, rows, C = case
        shapes = [("rows", (rows, C, 1)), ("rows_bwd", (rows, C, 1))]
    else:
        B, h, d, L, cls = case
        cm = tln.channel_major_applies(L, cls, d)
        assert cm == (d == 96 and not cls and L % 8 == 0)
        assert cm == (not cls)  # every v2 length is a multiple of 8
        shapes = ([("cols", (B * h, d, L)), ("cols_bwd", (B * h, d, L))]
                  if cm else [("rows", (B * h * L, d, 1)),
                              ("rows_bwd", (B * h * L, d, 1))])
    for kind, shape in shapes:
        p = tln._ln_plan(kind, shape, H100_SMS)
        bwd = kind.endswith("bwd")
        assert p["slabs"] == (p["blocks"] if bwd else 0)
        assert p["slab_groups"] == -(-p["slabs"] // tln.SLAB_GROUP)
        assert 1 + p["slab_groups"] <= tln.TICKETS
        assert p["smem"] <= kernels.MAX_SMEM_BYTES
        if kind.startswith("cols"):
            G, d, L = shape
            assert set(p["tma"]) == ({"x", "dy"} if bwd else {"x"})
            for tma in p["tma"].values():
                assert tma["stride_bytes"] % 16 == 0
                assert all(0 < n <= 256 for n in tma["box"])
                assert tma["box_row_bytes"] % 16 == 0
            if bwd:  # the 128-byte swizzle's rows
                assert p["tile"] * 2 == 128
                assert p["tma"]["dy"]["box_row_bytes"] == 128
            assert p["tiles"] == G * -(-L // p["tile"])
            assert (p["tile"] * tln.COL_LANES) % 32 == 0
            assert 0 < p["blocks"] <= min(p["tiles"],
                                          p["blocks_per_sm"] * H100_SMS)
            assert (p["blocks_per_sm"] * (p["smem"] + 1024)
                    <= kernels.SM_SMEM_BYTES)
            if bwd:
                assert p["blocks_per_sm"] <= tln.COL_BWD_BLOCKS_PER_SM
        else:
            rows, C, groups = shape
            dg = C // groups
            assert p["lanes"] in (4, 8, 16, 32)
            assert p["lanes"] * tln.LN_VPL * 8 >= dg
            assert p["lanes"] == 4 or p["lanes"] // 2 * tln.LN_VPL * 8 < dg
            per_block = p["threads"] // p["lanes"]
            if bwd:
                assert p["blocks"] <= H100_SMS
                assert p["blocks"] == min(H100_SMS,
                                          -(-rows * groups // per_block))
            else:
                assert p["blocks"] * per_block >= rows * groups


def test_layer_norm_plans_refuse_what_no_kernel_takes():
    for kind, shape in (("cols", (4, 64, 1568)), ("cols", (4, 96, 1569)),
                        ("cols_bwd", (4, 96, 1572)), ("rows", (8, 100, 1)),
                        ("rows_bwd", (8, 1536, 1)), ("rows", (8, 96, 5)),
                        ("rows", (0, 96, 1))):
        with pytest.raises(ValueError):
            tln._ln_plan(kind, shape, H100_SMS)


def test_pool_norm_wrappers_raise_instead_of_falling_back(monkeypatch):
    """Where the channel-major wrappers decide to launch their kernels, a
    tensor the kernels do not take raises before anything is built;
    nothing drops to the plain version or to the copy path."""
    monkeypatch.setattr(kernels, "use_kernel", lambda t: True)
    t, g, b = torch.ones(2, 192, 16), torch.ones(96), torch.zeros(96)
    with pytest.raises(ValueError, match="expected a tensor on cuda"):
        tln.pool_norm_rows(t, g, b, EPS, 2)
    with pytest.raises(ValueError, match="expected a tensor on cuda"):
        tln.pool_norm_rows_bwd(t, g, torch.ones(4, 16, 96), EPS, 2)
    with pytest.raises(ValueError, match="heads"):
        tln.pool_norm_rows(torch.ones(2, 100, 16), g, b, EPS, 3)


@pytest.mark.parametrize("d,L,cls,want", [
    (96, 3136, False, True), (96, 3137, True, False), (96, 100, False, False),
    (64, 3136, False, False), (64, 392, False, False), (32, 64, False, False),
    (128, 784, False, False)])
def test_channel_major_applies_only_at_head_dim_96(d, L, cls, want):
    """Only d == 96 takes the channel-major instance (its kernels are built
    for 96 channels a head); any other head dim takes the rows instance,
    whose plan accepts it, where the JAX package computes it through XLA."""
    assert tln.channel_major_applies(L, cls, d) is want
    if not want and d % 8 == 0:
        p = tln._ln_plan("rows", (2 * L, d, 1), H100_SMS)
        assert p["lanes"] * 8 * tln.LN_VPL >= d
