"""``windows_per_s``: every window of the views scored in the window, over
the window's seconds (host clock, to the last view's scores on the
host)."""


def read(rec):
    return rec.windows / rec.window_s if rec.kind == "score" else None
