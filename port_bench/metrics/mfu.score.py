"""``mfu.score``: the model's forward FLOPs a window
(:func:`port_bench.flops.forward_flops`) times ``windows_per_s``, over the
bf16 peak, in percent."""

from port_bench import flops


def read(rec):
    if rec.kind != "score":
        return None
    rate = rec.windows / rec.window_s
    return 100.0 * flops.forward_flops(rec.cfg) * rate / flops.PEAK_BF16
