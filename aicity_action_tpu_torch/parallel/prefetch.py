"""The host-to-card feed of one device (port of
``aicity_action_tpu/parallel/prefetch.py:prefetch_to_device`` and
``parallel/mesh.py:host_transfer_dtype`` / ``cast_for_transfer``).

- :func:`prefetch_to_device` stages ``lookahead`` items ahead of the
  consumer, as the JAX package's generator does.
- :class:`DeviceFeed` copies a batch's arrays to the card: each into a
  pinned host buffer (cast on the way where :func:`host_transfer_dtype`
  says so), then a ``non_blocking`` copy on a stream of its own, so that the
  copy of batch i+1 runs under the compute of batch i. :meth:`DeviceFeed.
  take` makes the compute stream wait for the copies before it reads them.
  On the CPU the arrays become tensors and nothing else happens.

Data parallelism over several cards (DDP) and the rest of
``parallel/mesh.py`` wait for ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


def host_transfer_dtype(cfg) -> torch.dtype | None:
    """The dtype float32 frames cross to the card in, or None for as-is.

    Under ``TPU.BF16_HOST_TRANSFER`` with ``TPU.COMPUTE_DTYPE`` bfloat16
    the frames are cast to bf16 on the host: the round-to-nearest-even the
    model's entry cast (``models/mvit.py:MViT.forward``) would apply on the
    card, so the model sees the same values and half the bytes cross PCIe.
    Not under ``MIXUP.ENABLE``: mixup mixes the frames before the model's
    cast, and mixing bf16 frames would round them earlier than the f32 path
    does."""
    if (cfg.TPU.BF16_HOST_TRANSFER and cfg.TPU.COMPUTE_DTYPE == "bfloat16"
            and not cfg.MIXUP.ENABLE):
        return torch.bfloat16
    return None


def cast_for_transfer(x: np.ndarray, in_dtype: torch.dtype | None,
                      pin: bool = False) -> torch.Tensor:
    """``x`` as a host tensor, float32 frames cast to ``in_dtype`` (where
    given); in pinned memory where ``pin``."""
    src = torch.from_numpy(np.ascontiguousarray(x))
    dtype = in_dtype if in_dtype is not None and src.dtype == torch.float32 \
        else src.dtype
    if not pin:
        return src.to(dtype)
    out = torch.empty(src.shape, dtype=dtype, pin_memory=True)
    out.copy_(src)
    return out


class DeviceFeed:
    """Copies batches of numpy arrays to ``device`` (see the module's
    docstring)."""

    def __init__(self, device: torch.device,
                 in_dtype: torch.dtype | None = None):
        self.device = device
        self.in_dtype = in_dtype
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def put(self, arrays: dict):
        """Starts the copies of ``arrays`` (numpy arrays, or lists of them
        under ``inputs``); returns what :meth:`take` takes."""
        host = {k: ([cast_for_transfer(x, self.in_dtype, self.cuda)
                     for x in v] if isinstance(v, list)
                    else cast_for_transfer(v, None, self.cuda))
                for k, v in arrays.items()}
        if not self.cuda:
            return host, None
        with torch.cuda.stream(self.stream):
            dev = {k: ([x.to(self.device, non_blocking=True) for x in v]
                       if isinstance(v, list)
                       else v.to(self.device, non_blocking=True))
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        return dev, done

    def take(self, staged) -> dict:
        """The device tensors of a :meth:`put`, ready for the current
        stream."""
        dev, done = staged
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for v in dev.values():
                for t in (v if isinstance(v, list) else [v]):
                    t.record_stream(stream)
        return dev


def prefetch_to_device(iterator: Iterable, put_fn: Callable,
                       lookahead: int = 2) -> Iterator:
    """Yields ``(host_item, put_fn(host_item))`` in order, with
    ``lookahead`` items put ahead of the one yielded."""
    queue = collections.deque()
    it = iter(iterator)
    for item in it:
        queue.append((item, put_fn(item)))
        if len(queue) >= lookahead:
            break
    while queue:
        host_item, dev_item = queue.popleft()
        for nxt in it:
            queue.append((nxt, put_fn(nxt)))
            break
        yield host_item, dev_item
