"""``attn_roofline.score``: the bound of every attention launch of the
window (one forward a block a batch, at the model's head dim:
:func:`port_bench.flops.attention_bound_s`) over the device time of the
attention's kernels (its forward and K/V LayerNorm pass), in percent."""

from port_bench import flops, trace


def read(rec):
    if rec.kind != "score" or not getattr(rec, "kernels", None):
        return None
    busy = sum(us for g, us in trace.by_group_us(rec.kernels).items()
               if g in trace.ATTENTION_GROUPS) / 1e6
    if busy <= 0:
        return None
    bound = rec.windows * flops.attention_bound_s(rec.cfg, "fwd")
    return 100.0 * bound / busy
