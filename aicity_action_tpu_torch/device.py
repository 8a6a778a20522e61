"""Device resolution and the dtype policy.

Policy (the JAX package's, ``models/mvit.py:388,472``): activations and
products in bf16, LayerNorm statistics, softmax and every accumulation in
f32, parameters kept in f32 and cast to the compute type where they are used.
"""

from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on. Asking for CUDA on a
    machine without a usable card raises; nothing falls back to the CPU
    unless the caller passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def compute_dtype(name: str) -> torch.dtype:
    """Config string (``TPU.COMPUTE_DTYPE``) -> torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported compute dtype {name!r}") from None
