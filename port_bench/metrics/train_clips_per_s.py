"""``train_clips_per_s``: clips of every step of the window over its
seconds (host clock, to the synchronize after the last step)."""


def read(rec):
    return rec.clips / rec.window_s if rec.kind == "train" else None
