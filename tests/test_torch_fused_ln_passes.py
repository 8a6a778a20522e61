"""The passes around the fused-LN attention's cores (rows 5-7: the K/V
LayerNorm pass of the forwards and the backward, the backward's dk/dv
LayerNorm VJP and its dgamma / dbeta sums), on the CPU: their host-side
plan at every attention call of the MViT-v2-B and MViT-v2-L paths, and the
passes staged in torch as the kernels order their work (key tiles of
``KV_TILE``, two lanes a key, the query splits summed in order, the
per-block partials summed by the chunk tree of ``csrc/ln_bwd.cuh``) against
the JAX package's LayerNorm and its Pallas VJP in interpret mode.

Inputs are made with numpy from a seed and fed to both in f32. Tolerance:
2e-5 absolute, as ``test_torch_kernels.py`` holds the kernels' plain
versions (f32 arithmetic, sums in other orders); the tree's sums 1e-5
relative of the f64 sum (up to 12,544 f32 terms)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicity_action_tpu.ops.pallas import flash_attention as jfa
from aicity_action_tpu.ops.pallas import layer_norm as jln
from aicity_action_tpu_torch.config import (mvitv2_b_16x4_448_cfg,
                                            mvitv2_l_16x4_448_cfg)
from aicity_action_tpu_torch.models.mvit import attention_call_shapes
from aicity_action_tpu_torch.ops import flash_attention as tfa
from aicity_action_tpu_torch.ops import layer_norm as tln
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = 2e-5
EPS = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _arr(rng, shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


# ------------------------------------------------------------------ plans

def _calls():
    """Every distinct attention of the B and L paths: the b4 train steps
    and the b1 gradient gates (rows 6-7 under AICITY_TPU_FUSE_ATTN_LN=1)
    and the b8 eval forwards (row 5's K/V pass)."""
    cases = {}
    for name, cfg in (("B", mvitv2_b_16x4_448_cfg),
                      ("L", mvitv2_l_16x4_448_cfg)):
        for batch in (4, 1, 8):
            for call in attention_call_shapes(cfg(), batch):
                cases.setdefault(call, f"{name}-b{batch}")
    return [pytest.param(call, id=f"{name}-" + "-".join(map(str, call)))
            for call, name in cases.items()]


@pytest.mark.parametrize("call", _calls())
def test_ln_passes_plan_covers_every_call(call):
    """The K/V passes' grid covers the keys with whole tiles of KV_TILE
    (one ragged last tile), K and V in one launch; the partials' scratch
    holds one slab of (dgamma, dbeta) a dq block and a VJP block; the sums
    take the three jobs in one launch, a job past 16 splits over chunks of
    64 splits in whole 32-column blocks, one ticket a column block, within
    the counters a stream keeps."""
    G, Lq, Lk, d = call
    p = tfa._ln_bwd_plan(G, Lq, Lk, d)
    nkt, g, two = p["kv_grid"]
    assert (g, two) == (G, 2) and G <= 65535
    assert (nkt - 1) * tfa.KV_TILE < Lk <= nkt * tfa.KV_TILE
    nqt = -(-Lq // tfa.BWD_TILE)
    assert p["part_q"] == (G * nqt, 2, d)
    assert p["part_kv"] == (2, G * nkt, 2, d)
    assert [s for s, _ in p["sums"]] == [G * nqt, G * nkt, G * nkt]
    cols, tickets = -(-2 * d // 32), 0
    for splits, blocks in p["sums"]:
        if splits > tfa._FEW_SPLITS:
            chunks = -(-splits // tfa._TREE_CHUNK)
            assert blocks == cols * chunks
            assert (chunks - 1) * tfa._TREE_CHUNK < splits
            tickets += cols
        else:
            assert blocks == 1  # 2d <= 1024 columns, four a thread
    assert p["tickets"] == tickets <= tln.TICKETS
    assert p["sum_blocks"] == sum(b for _, b in p["sums"]) < 2 ** 31


def test_ln_passes_plan_at_the_l_first_blocks():
    """MViT-v2-L's blocks 0-1 at batch 4 (G 8, Lq 100352, Lk 1568): the
    dq kernel's 12,544 partials of q go to 196 chunks over 5 column blocks
    (980 blocks of the sums); K and V take 25 tiles of 64 keys a group."""
    p = tfa._ln_bwd_plan(8, 100352, 1568, 72)
    assert p["kv_grid"] == (25, 8, 2)
    assert p["sums"] == [(12544, 5 * 196), (200, 5 * 4), (200, 5 * 4)]
    assert p["tickets"] == 15


# ---------------------------------------------------- the passes, staged

def _seq_sum(rows):
    """f32 rows summed one after another, as a thread adds its terms."""
    acc = np.zeros(rows.shape[1:], np.float32)
    for r in rows:
        acc = acc + r
    return acc


def _cols(slabs):
    """``ln_bwd.cuh:sum_cols`` over slabs [count, cols]: warp y sums the
    slabs y, y + 8, ... in order, then the 8 warps' sums in order."""
    return _seq_sum(np.stack([_seq_sum(slabs[y::8]) for y in range(8)]))


def _tree_sum_staged(part, order):
    """``ln_bwd.cuh:sum_partials`` for a job of ``add_tree_sum``: block
    (column block cb, chunk ch) sums its chunk of 64 splits into the
    chunk's first slab, in place; the block that finishes a column block's
    chunks last sums their first slabs in chunk order. ``order``: the
    blocks' finishing order (a permutation)."""
    part = part.copy()
    nsplit, n = part.shape
    T = tfa._TREE_CHUNK
    chunks, ncb = -(-nsplit // T), -(-n // 32)
    out = np.zeros(n, np.float32)
    done = [0] * ncb
    for b in order:
        cb, ch = divmod(b, chunks)
        c = slice(32 * cb, min(n, 32 * cb + 32))
        part[ch * T, c] = _cols(part[ch * T:(ch + 1) * T, c])
        done[cb] += 1
        if done[cb] == chunks:
            out[c] = _cols(part[0::T][:chunks, c])
    return out


@pytest.mark.parametrize("nsplit", [17, 64, 65, 800, 12544])
def test_tree_sums_are_fixed_whatever_order_the_blocks_finish(nsplit):
    """The chunk tree's sum of nsplit f32 slabs of 144 columns (the q, k, v
    dgamma / dbeta of head dim 72) is the same, bit for bit, for any
    order in which the blocks finish (no atomics in the sums), and within
    1e-5 relative of the f64 sum."""
    rng = np.random.default_rng(nsplit)
    part = _arr(rng, (nsplit, 144))
    blocks = -(-144 // 32) * -(-nsplit // tfa._TREE_CHUNK)
    got = [_tree_sum_staged(part, order) for order in (
        range(blocks), range(blocks - 1, -1, -1), rng.permutation(blocks))]
    for g in got[1:]:
        assert np.array_equal(g.view(np.int32), got[0].view(np.int32))
    want = part.astype(np.float64).sum(0)
    scale = np.abs(part).astype(np.float64).sum(0)
    assert np.all(np.abs(got[0] - want) <= 1e-5 * scale)


def _stats(rows, eps):
    """The statistics of token rows [..., D] as two lanes a token take
    them (``flash_ln.cuh:col_stats``): each half of the channels summed,
    the two halves added; f32."""
    D = rows.shape[-1]
    halves = rows.reshape(*rows.shape[:-1], 2, D // 2)
    mean = halves.sum(-1).sum(-1, keepdim=True) / D
    q = ((halves - mean[..., None]) ** 2).sum(-1).sum(-1, keepdim=True)
    return mean, torch.rsqrt(q / D + eps)


def _kv_norm_staged(x, gamma, beta, eps):
    """``kv_norm_kernel``: the d-major group x [G, D, L] as LayerNormed
    token rows [G, L, D]."""
    rows = x.transpose(1, 2)
    mean, rstd = _stats(rows, eps)
    return (rows - mean) * rstd * gamma + beta


def _kv_vjp_staged(x, parts, gamma, eps):
    """``kv_vjp_kernel``: dy, the split partials [nsplit, G, L, D] summed
    in split order; the row-LN VJP of the d-major x [G, D, L] two lanes a
    key; dx d-major and each key tile's (dgamma, dbeta) column sums
    [G * nkt, 2, D] over its keys."""
    dy = parts[0]
    for p in parts[1:]:
        dy = dy + p
    rows = x.transpose(1, 2)
    G, L, D = rows.shape
    mean, rstd = _stats(rows, eps)
    xh = (rows - mean) * rstd
    yg = dy * gamma
    m1 = yg.sum(-1, keepdim=True) / D
    m2 = (yg * xh).sum(-1, keepdim=True) / D
    dx = (yg - m1 - xh * m2) * rstd
    nkt = -(-L // tfa.KV_TILE)
    slabs = torch.zeros(G, nkt, 2, D)
    for t in range(nkt):
        keys = slice(t * tfa.KV_TILE, (t + 1) * tfa.KV_TILE)
        slabs[:, t, 0] = (dy * xh)[:, keys].sum(1)
        slabs[:, t, 1] = dy[:, keys].sum(1)
    return dx.transpose(1, 2), slabs.reshape(G * nkt, 2, D)


@pytest.mark.parametrize("D", [72, 96])
@pytest.mark.parametrize("L", [96, 128])
def test_kv_passes_staged_match_the_jax_layer_norm(D, L):
    """The K/V pass and the dk/dv LN VJP as the kernels take them (key
    tiles of 64 with a ragged last one at L 96, two lanes a key, three
    query splits of d(LN k) summed in order, the tiles' partials through
    the chunk tree) against the JAX package's LayerNorm and its VJP (the
    Pallas kernels in interpret mode) on the same token rows: LN(k), dk,
    dgamma and dbeta."""
    rng = np.random.default_rng(D + L)
    G, nsplit = 9, 3  # 18 key tiles: the sums' tree
    x = _arr(rng, (G, D, L), 1.5, 0.3)
    gamma, beta = _arr(rng, (D,), 0.1, 1.0), _arr(rng, (D,), 0.1)
    parts = _arr(rng, (nsplit, G, L, D), 0.3)
    rows = np.ascontiguousarray(x.transpose(0, 2, 1)).reshape(G * L, D)
    ref, vjp = jax.vjp(lambda *a: jln.fused_layer_norm(*a, EPS),
                       *(jnp.asarray(a) for a in (rows, gamma, beta)))
    dx_ref, dg_ref, db_ref = vjp(jnp.asarray(parts.sum(0).reshape(G * L, D)))

    tx, tg, tb = (torch.from_numpy(a) for a in (x, gamma, beta))
    kn = _kv_norm_staged(tx, tg, tb, EPS)
    np.testing.assert_allclose(kn.reshape(G * L, D).numpy(), np.asarray(ref),
                               rtol=0, atol=TOL)
    dx, slabs = _kv_vjp_staged(tx, torch.from_numpy(parts), tg, EPS)
    np.testing.assert_allclose(
        dx.transpose(1, 2).reshape(G * L, D).numpy(), np.asarray(dx_ref),
        rtol=0, atol=TOL)
    flat = slabs.reshape(len(slabs), 2 * D).numpy()
    assert len(flat) > tfa._FEW_SPLITS  # the chunk tree's job
    sums = _tree_sum_staged(
        flat, range(-(-2 * D // 32) * -(-len(flat) // tfa._TREE_CHUNK)))
    np.testing.assert_allclose(sums[:D], np.asarray(dg_ref), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(sums[D:], np.asarray(db_ref), rtol=0,
                               atol=TOL)
