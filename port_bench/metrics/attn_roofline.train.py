"""``attn_roofline.train``: the bound of every attention launch of the
window's steps (a forward with its log-sum-exp a block, again in the
recompute under activation checkpointing, and a backward), at the model's
head dim, over the device time of the attention's kernels, in percent."""

from port_bench import flops, trace


def read(rec):
    if rec.kind != "train" or not getattr(rec, "kernels", None):
        return None
    busy = sum(us for g, us in trace.by_group_us(rec.kernels).items()
               if g in trace.ATTENTION_GROUPS) / 1e6
    if busy <= 0:
        return None
    forwards = 2 if rec.cfg["MODEL"]["ACT_CHECKPOINT"] else 1
    clip = (forwards * flops.attention_bound_s(rec.cfg, "fwd_lse")
            + flops.attention_bound_s(rec.cfg, "bwd"))
    return 100.0 * rec.clips * clip / busy
