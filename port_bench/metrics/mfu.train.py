"""``mfu.train``: 3 x the model's forward FLOPs a clip (forward and the two
backward products; recompute not counted) times ``train_clips_per_s``,
over the bf16 peak, in percent."""

from port_bench import flops


def read(rec):
    if rec.kind != "train":
        return None
    rate = rec.clips / rec.window_s
    return 100.0 * 3 * flops.forward_flops(rec.cfg) * rate / flops.PEAK_BF16
