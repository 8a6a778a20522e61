"""A configuration's weights, made on the device from the seed.

One ``torch.randn`` over every parameter, drawn by a generator on the
device, then shaped leaf by leaf (views, no copy): a linear weight or a
position embedding N(0, 0.02), a convolution weight N(0, 1 / fan_in), a
LayerNorm scale 1 + N(0, 0.1), a bias N(0, 0.02). Scales and biases are
not left at 1 and 0, so that a path that drops one shows. The program and
the reference load the same values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.mvit import param_shapes

# salts of the seed: one stream for the weights, one for the inputs
WEIGHTS, INPUTS = 1, 2


def seed_of(seed: int, salt: int) -> int:
    """A 63-bit generator seed from the run's ``--seed`` and a salt."""
    state = np.random.SeedSequence([int(seed), salt]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed, salt))


def make(cfg: dict, seed: int, device) -> dict:
    """``{name: float32 tensor}`` of every parameter of ``cfg``'s model."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(seed, WEIGHTS, device),
                       device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if name.endswith(".bias"):
            t.mul_(0.02)
        elif len(shape) == 1:
            t.mul_(0.1).add_(1.0)
        elif len(shape) == 5:
            t.mul_(math.prod(shape[1:]) ** -0.5)
        else:
            t.mul_(0.02)
        out[name] = t
    return out
