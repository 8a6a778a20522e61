"""The lower-precision control's rounding: float8 where the configuration
states bfloat16.

:func:`fp8` rounds a tensor to float8 e4m3 (the forward's format) with a
per-tensor scale that maps its largest magnitude onto the format's largest
finite value, and the gradient that flows back through it to float8 e5m2
(the backward's format), scaled the same way: what a float8 path of the
program would do at each product's inputs. The value stays in float32.
"""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, fmax: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = fmax / amax
    return ((x * scale).to(dtype).to(x.dtype) / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)
