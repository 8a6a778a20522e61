"""Idle share of the device: the traced window less the union of its
kernels' intervals, over the window, in percent."""


def read(rec):
    if rec.kind != "score" or not getattr(rec, "kernels", None):
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.trace_window_s)
