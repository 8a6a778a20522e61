"""``scorer_host_share.score``: the scorer's upload seconds (its
``last_timers["upload"]``: pinning a decoded chunk, copying it to the card,
joining it to the last chunk's tail) over the window, in percent. Its
``dispatch`` seconds are left out: enqueueing blocks whenever the CUDA
queue is full, so they count the device's time too."""


def read(rec):
    if rec.kind != "score":
        return None
    return 100.0 * rec.timers["upload"] / rec.window_s
