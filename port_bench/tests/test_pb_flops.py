"""The benchmark's arithmetic against a hand count of the first block of
each stage of MViT-v2-B and MViT-v2-L at 448 (16 frames: the stem leaves
8 x 112 x 112 = 100,352 tokens)."""

import json
import math
from pathlib import Path

import pytest

from port_bench import flops

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["cfg"]


def hand(L, dim, att, heads, Lq, Lk, expand):
    """One block by hand: qkv, the three depthwise 3x3x3 pools (27 taps),
    the attention's two products, proj, proj_max_pool, the MLP (ratio 4)."""
    d = att // heads
    return {"qkv": 2 * L * dim * 3 * att,
            "pool": 2 * 27 * att * (Lq + 2 * Lk),
            "attention": 4 * heads * Lq * Lk * d,
            "proj": 2 * Lq * att * att,
            "proj_max_pool": 2 * L * dim * att if expand else 0,
            "mlp": 2 * Lq * att * 4 * att * 2}


# (config, block, tokens in, dim, dim_att, heads, Lq, Lk, widens): stage 1
# keeps 8x112x112 with keys pooled to 8x14x14; each later stage halves H
# and W of q and, by the adaptive kv stride, keeps the keys' stride at 8
# until the last stage
BLOCKS = [
    ("mvitv2_b_16x4_448", 0, 100352, 96, 96, 1, 100352, 1568, False),
    ("mvitv2_b_16x4_448", 1, 100352, 96, 192, 2, 25088, 6272, True),
    ("mvitv2_b_16x4_448", 3, 25088, 192, 384, 4, 6272, 6272, True),
    ("mvitv2_b_16x4_448", 14, 6272, 384, 768, 8, 1568, 6272, True),
    ("mvitv2_l_16x4_448", 0, 100352, 144, 144, 2, 100352, 1568, False),
    ("mvitv2_l_16x4_448", 2, 100352, 144, 288, 4, 25088, 6272, True),
    ("mvitv2_l_16x4_448", 8, 25088, 288, 576, 8, 6272, 6272, True),
    ("mvitv2_l_16x4_448", 44, 6272, 576, 1152, 16, 1568, 6272, True),
]


@pytest.mark.parametrize("name,i,L,dim,att,heads,Lq,Lk,expand", BLOCKS)
def test_block_flops_by_hand(name, i, L, dim, att, heads, Lq, Lk, expand):
    c = cfg(name)
    assert flops.block_flops(c)[i] == hand(L, dim, att, heads, Lq, Lk,
                                           expand)
    assert flops.attention_calls(c)[i] == (heads, Lq, Lk, att // heads)


@pytest.mark.parametrize("name,head_dim", [("mvitv2_b_16x4_448", 96),
                                           ("mvitv2_l_16x4_448", 72)])
def test_head_dim_is_the_models(name, head_dim):
    assert {d for *_, d in flops.attention_calls(cfg(name))} == {head_dim}


@pytest.mark.parametrize("name", ["mvitv2_b_16x4_448", "mvitv2_l_16x4_448"])
def test_forward_flops_sums_the_blocks(name):
    c = cfg(name)
    m = c["MVIT"]
    stem = 2 * 100352 * m["EMBED_DIM"] * 3 * 3 * 7 * 7
    last = 768 if m["EMBED_DIM"] == 96 else 1152
    total = stem + 2 * last * 18 + sum(sum(b.values())
                                       for b in flops.block_flops(c))
    assert flops.forward_flops(c) == total


def test_attention_launch_by_hand():
    # B block 0 at batch 8: G 8, Lq 100352, Lk 1568, d 96
    G, Lq, Lk, d = 8, 100352, 1568, 96
    ops, nbytes = flops.attention_launch(G, Lq, Lk, d, "fwd")
    assert ops == 4 * G * Lq * Lk * d
    assert nbytes == 2 * (G * Lq * d * 2 + G * Lk * d * 2)
    ops, nb_lse = flops.attention_launch(G, Lq, Lk, d, "fwd_lse")
    assert nb_lse == nbytes + 4 * G * Lq
    ops, nbytes = flops.attention_launch(G, Lq, Lk, d, "bwd")
    assert ops == 10 * G * Lq * Lk * d
    assert nbytes == 2 * (3 * G * Lq * d + 2 * G * Lk * d) + 4 * G * Lq \
        + 2 * (G * Lq * d + 2 * G * Lk * d)
    # operations bound it: 0.489 ms at the bf16 peak
    assert math.isclose(flops.bound_s(*flops.attention_launch(
        G, Lq, Lk, d, "fwd")), 4 * G * Lq * Lk * d / 989e12)


def test_bound_grows_with_the_batch():
    for h, Lq, Lk, d in flops.attention_calls(cfg("mvitv2_l_16x4_448")):
        for kind in ("fwd", "fwd_lse", "bwd"):
            one = flops.bound_s(*flops.attention_launch(h, Lq, Lk, d, kind))
            eight = flops.bound_s(*flops.attention_launch(8 * h, Lq, Lk, d,
                                                          kind))
            assert math.isclose(eight, 8 * one)
