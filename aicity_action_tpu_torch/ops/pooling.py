"""Token-space spatiotemporal pooling for pooled multi-head attention
(port of ``aicity_action_tpu/ops/pooling.py``).

Public functions keep the JAX package's channels-last layout (``[B, L, C]``
tokens, ``[B, T, H, W, C]`` volumes). ``F.conv3d`` and the pools want
NCDHW: the depthwise convolution copies its input to contiguous NCDHW
(the channels-last depthwise kernels are several times slower), the pools
take a permuted view, and both return a channels-last view that the
consumer copies once where it needs contiguous tokens. Semantics match
torch's ``Conv3d(groups=C)`` /
``MaxPool3d`` / ``AvgPool3d`` with ``ceil_mode=False`` and, for avg,
``count_include_pad=True``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _as3(x: Sequence[int]) -> tuple[int, int, int]:
    t = tuple(int(v) for v in x)
    if len(t) != 3:
        raise ValueError(f"expected 3 values, got {t}")
    return t  # type: ignore[return-value]


def depthwise_conv3d(x: torch.Tensor, weights: torch.Tensor,
                     stride: Sequence[int],
                     padding: Sequence[int]) -> torch.Tensor:
    """Depthwise 3-D convolution. ``x [B, T, H, W, C]``; ``weights``
    ``[C, 1, kT, kH, kW]`` (torch's grouped layout); returns
    ``[B, T', H', W', C]`` (a view of the NCDHW result).

    The input is copied to contiguous NCDHW first: on an H100, the depthwise
    convolution of a channels-last bf16 volume is several times slower than
    the copy and the NCDHW convolution together (``tools/bench_convs.py``,
    numbers in ``PERF.md``)."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).contiguous(), weights.to(x.dtype),
                 None, _as3(stride), _as3(padding), 1, x.shape[-1])
    return y.permute(0, 2, 3, 4, 1)


def pool3d(x: torch.Tensor, kind: str, kernel: Sequence[int],
           stride: Sequence[int], padding: Sequence[int]) -> torch.Tensor:
    """Max or average 3-D pooling of ``x [B, T, H, W, C]``."""
    xc = x.permute(0, 4, 1, 2, 3)
    k, s, p = _as3(kernel), _as3(stride), _as3(padding)
    if kind == "max":
        y = F.max_pool3d(xc, k, s, p)
    elif kind == "avg":
        y = F.avg_pool3d(xc, k, s, p, count_include_pad=True)
    else:
        raise ValueError(f"Unknown pooling kind: {kind}")
    return y.permute(0, 2, 3, 4, 1)


def pooled_hw(size: int, kernel: int, stride: int, padding: int) -> int:
    """Output size of a pooling/conv dim: floor((N + 2P - K)/S) + 1."""
    return (size + 2 * padding - kernel) // stride + 1


def attention_pool(tensor: torch.Tensor, thw: tuple[int, int, int], *,
                   mode: str, kernel: Sequence[int] | None,
                   stride: Sequence[int] | None,
                   conv_weights: torch.Tensor | None = None,
                   has_cls: bool = False):
    """Pool the token axis of an attention tensor.

    ``tensor`` is ``[B, N, L, d]`` (N = heads) or ``[B, L, d]``; ``thw`` the
    (T, H, W) with ``T*H*W == L`` (cls token excluded); ``mode`` "conv",
    "max" or "avg"; padding is ``kernel // 2``. ``conv_weights`` are the
    depthwise ``[d, 1, kT, kH, kW]`` weights for mode "conv". The cls token
    (``has_cls``) bypasses pooling and is re-attached in front. Returns the
    pooled tensor in the input's rank and the new (T, H, W).
    """
    if kernel is None or len(kernel) == 0:
        return tensor, thw
    squeeze = tensor.dim() == 3
    if squeeze:
        tensor = tensor[:, None]
    cls_tok = None
    if has_cls:
        cls_tok, tensor = tensor[:, :, :1], tensor[:, :, 1:]

    B, N, L, d = tensor.shape
    T, H, W = thw
    if L != T * H * W:
        raise ValueError(f"{L} tokens do not fill the volume {thw}")
    k = _as3(kernel)
    s = _as3(stride if stride is not None else (1, 1, 1))
    p = tuple(kk // 2 for kk in k)

    x = tensor.reshape(B * N, T, H, W, d)
    if mode == "conv":
        if conv_weights is None:
            raise ValueError("mode 'conv' needs conv_weights")
        x = depthwise_conv3d(x, conv_weights, s, p)
    else:
        x = pool3d(x, mode, k, s, p)
    nT, nH, nW = x.shape[1], x.shape[2], x.shape[3]
    out = x.reshape(B, N, nT * nH * nW, d)
    if cls_tok is not None:
        out = torch.cat([cls_tok, out], dim=2)
    if squeeze:
        out = out[:, 0]
    return out, (nT, nH, nW)
