"""``train_peak_gib``: ``torch.cuda.max_memory_allocated`` over the
window, in GiB: parameters, optimizer state, gradients and the batch's
activations."""


def read(rec):
    if rec.kind != "train" or not rec.window_peak_bytes:
        return None
    return rec.window_peak_bytes / 2 ** 30
