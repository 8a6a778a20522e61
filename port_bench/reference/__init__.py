"""The plain reference of the benchmark's correctness check: float32
PyTorch (TF32 off), importing nothing of the program under test."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact():
    """Float32 products and convolutions in float32, not TF32."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
