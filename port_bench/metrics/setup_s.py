"""``setup_s``: seconds from the process's start to the window's: imports,
the card, the kernel build (first run), weights, inputs, warm-up."""


def read(rec):
    return rec.setup_s
