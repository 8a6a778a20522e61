"""The traced run's profiler: the window under ``torch.profiler`` with the
device's activity only (kernels, copies and the host's CUDA calls; the
host's operator events add a third to a scored view's time), bounded by
the host clock that the profiler's timestamps share."""

from __future__ import annotations

import contextlib
import time

from . import trace


@contextlib.contextmanager
def window_profile(on: bool, record):
    """Profiles the ``with`` body when ``on``; on leaving, sets ``record``'s
    ``busy_s``, ``trace_window_s``, ``kernels`` (clipped to the window) and
    ``breakdown``."""
    if not on:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    # the CPU tests' runs have no device: their host events only
    act = (ProfilerActivity.CUDA if torch.cuda.is_available()
           else ProfilerActivity.CPU)
    with profile(activities=[act]) as prof:
        start = time.time_ns() / 1e3
        yield
        end = time.time_ns() / 1e3
    kernels, host = trace.read_profile(prof)
    kernels = [(n, max(s, start), min(e, end)) for n, s, e in kernels
               if e > start and s < end]
    record.kernels = kernels
    record.busy_s = trace.busy_us(kernels) / 1e6
    record.trace_window_s = (end - start) / 1e6
    record.breakdown = {"device_ops": trace.top_ops(kernels),
                        "idle_gaps": trace.idle_gaps(kernels, host, start,
                                                     end)}
