"""``conv_ms_per_clip.train``: device milliseconds of the convolutions'
kernels (the depthwise pools and the stem, forward and backward) over the
window's clips."""

from port_bench import trace


def read(rec):
    if rec.kind != "train" or not getattr(rec, "kernels", None):
        return None
    us = sum(v for g, v in trace.by_group_us(rec.kernels).items()
             if g in trace.CONV_GROUPS)
    return us / 1e3 / rec.clips if us > 0 else None
