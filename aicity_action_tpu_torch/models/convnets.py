"""3-D conv video backbones' building blocks (port of ``aicity_action_tpu/
models/convnets.py``; reference: slowfast/models/{resnet_helper,
stem_helper, nonlocal_helper, operators, batchnorm_helper}.py).

- Layout: PyTorch's ``[B, C, T, H, W]`` inside the backbone. The models
  (``resnet_models.py``) take the data pipeline's channels-last clips and
  view them as NCDHW, which in memory is ``channels_last_3d``, with their
  conv weights in the same format (``set_channels_last``; timed against
  contiguous NCDHW by ``tools/bench_convs.py --convnet``).
- Parameter and buffer names are PySlowFast's (``s1.pathway0_stem.conv.
  weight``, ``s2.pathway0_res0.branch2.a_bn.running_var``, ...), so the JAX
  package's ``utils/convert.py:convert_convnet_state_dict`` carries port
  weights and BatchNorm statistics to the JAX side.
- :class:`BatchNorm` keeps the JAX package's semantics: statistics of the
  global batch under data parallelism (per-channel sums and sums of
  squares all-reduced, differentiably), flax's biased running variance and
  fast variance (``E[x^2] - E[x]^2``), keep rate 0.9 (torch momentum 0.1),
  eps 1e-5. ``nn.BatchNorm3d`` / ``nn.SyncBatchNorm`` keep the unbiased
  variance, so neither serves.
- Drop-connect masks come from an explicit generator, drawn for the global
  batch (``parallel/mesh.py:dp_rand``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh
from .common import round_width

# number of residual blocks per stage (video_model_builder.py:34)
MODEL_STAGE_DEPTH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

# per-arch temporal kernel basis for [stem, res2..res5]
# (video_model_builder.py:37-94)
TEMPORAL_KERNEL_BASIS = {
    "2d": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "c2d": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "c2d_nopool": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "i3d": [[[5]], [[3]], [[3, 1]], [[3, 1]], [[1, 3]]],
    "i3d_nopool": [[[5]], [[3]], [[3, 1]], [[3, 1]], [[1, 3]]],
    "slow": [[[1]], [[1]], [[1]], [[3]], [[3]]],
    "slowfast": [[[1], [5]], [[1], [3]], [[1], [3]], [[3], [3]], [[3], [3]]],
    "x3d": [[[5]], [[3]], [[3]], [[3]], [[3]]],
}

# post-stem pooling per arch (video_model_builder.py:96-107)
POOL1 = {
    "2d": [[1, 1, 1]],
    "c2d": [[2, 1, 1]],
    "c2d_nopool": [[1, 1, 1]],
    "i3d": [[2, 1, 1]],
    "i3d_nopool": [[1, 1, 1]],
    "slow": [[1, 1, 1]],
    "slowfast": [[1, 1, 1], [1, 1, 1]],
    "x3d": [[1, 1, 1]],
}

# BatchNorm modules in training mode append their batch statistics here
# while :func:`collect_bn_stats` is active (precise BN)
_STATS_SINK: Optional[list] = None


class collect_bn_stats:
    """Within the block, every BatchNorm / SubBatchNorm that normalizes
    with batch statistics appends ``(module, mean, var)`` (detached, f32)
    to the list it yields."""

    def __enter__(self) -> list:
        global _STATS_SINK
        self.prev, _STATS_SINK = _STATS_SINK, []
        return _STATS_SINK

    def __exit__(self, *exc):
        global _STATS_SINK
        _STATS_SINK = self.prev


def _stat(x: torch.Tensor) -> torch.Tensor:
    """``x`` in at least f32, the statistics' type (flax's
    ``promote_types(dtype, float32)``)."""
    return x if x.dtype == torch.float64 else x.float()


def _bshape(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """``[C]`` -> ``[C, 1, ..., 1]`` against an NC... tensor of ``ndim``."""
    return v.reshape(-1, *([1] * (ndim - 2)))


def _normalize(x, mean, var, weight, bias, eps):
    """``(x - mean) * rsqrt(var + eps) * weight + bias`` in f32 (flax's
    order), cast back to ``x``'s type; statistics ``[C]`` or per-row
    ``[B, C]``."""
    nd = x.ndim
    if mean.dim() == 1:
        mean, var = _bshape(mean, nd), _bshape(var, nd)
    else:
        mean = mean.reshape(*mean.shape, *([1] * (nd - 2)))
        var = var.reshape(*var.shape, *([1] * (nd - 2)))
    mul = torch.rsqrt(var + eps) * _bshape(_stat(weight), nd)
    y = (_stat(x) - mean) * mul + _bshape(_stat(bias), nd)
    return y.to(x.dtype)


def _row_sums(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample, per-channel sums of x and x^2 in f32: ``[B, C]`` each."""
    xf = _stat(x).flatten(2)
    return xf.sum(-1), (xf * xf).sum(-1)


class BatchNorm(nn.Module):
    """BN over (B, T, H, W) of an NCDHW tensor with global-batch statistics
    (see the module's docstring). ``final_gamma_zero`` starts the scale at
    0 (``RESNET.ZERO_INIT_FINAL_BN``)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, final_gamma_zero: bool = False):
        super().__init__()
        self.momentum = momentum  # flax's keep rate
        self.eps = eps
        self.final_gamma_zero = final_gamma_zero
        self.weight = nn.Parameter(
            torch.zeros(num_features) if final_gamma_zero
            else torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return _normalize(x, self.running_mean, self.running_var,
                              self.weight, self.bias, self.eps)
        s1, s2 = _row_sums(x)
        sums = mesh.all_reduce_sum(torch.stack([s1.sum(0), s2.sum(0)]))
        n = x.numel() // x.shape[1] * mesh.get_world_size()
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_((1 - m) * mean.detach())
            self.running_var.mul_(m).add_((1 - m) * var.detach())
        if _STATS_SINK is not None:
            _STATS_SINK.append((self, mean.detach(), var.detach()))
        return _normalize(x, mean, var, self.weight, self.bias, self.eps)


class SubBatchNorm(nn.Module):
    """BN with statistics of each of ``num_splits`` splits of the batch
    (reference SubBatchNorm3d, in the JAX package's form): split ``j`` is
    rows ``[j*B/s, (j+1)*B/s)`` of the GLOBAL batch, whichever ranks hold
    them. Affine parameters are shared; the running statistics are kept
    per split (``[s, C]``) and aggregated at eval (mean of the means; mean
    of the variances plus the spread of the means)."""

    def __init__(self, num_features: int, num_splits: int,
                 momentum: float = 0.9, eps: float = 1e-5,
                 final_gamma_zero: bool = False):
        super().__init__()
        self.num_splits = num_splits
        self.momentum = momentum
        self.eps = eps
        self.final_gamma_zero = final_gamma_zero
        self.weight = nn.Parameter(
            torch.zeros(num_features) if final_gamma_zero
            else torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean",
                             torch.zeros(num_splits, num_features))
        self.register_buffer("running_var",
                             torch.ones(num_splits, num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mean = self.running_mean.mean(0)
            var = (self.running_var
                   + (self.running_mean - mean[None]) ** 2).mean(0)
            return _normalize(x, mean, var, self.weight, self.bias, self.eps)
        s = self.num_splits
        b, world = x.shape[0], mesh.get_world_size()
        B = b * world
        if B % s:
            raise ValueError(f"a global batch of {B} in {s} splits")
        rows = mesh.get_rank() * b + torch.arange(b, device=x.device)
        split = rows // (B // s)
        s1, s2 = _row_sums(x)
        C = x.shape[1]
        acc = torch.zeros((2, s, C), dtype=s1.dtype, device=x.device)
        acc = acc.index_add(1, split, torch.stack([s1, s2]))
        acc = mesh.all_reduce_sum(acc)
        n = (B // s) * (x.numel() // (b * C))
        mean = acc[0] / n
        var = torch.clamp(acc[1] / n - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_((1 - m) * mean.detach())
            self.running_var.mul_(m).add_((1 - m) * var.detach())
        if _STATS_SINK is not None:
            _STATS_SINK.append((self, mean.detach(), var.detach()))
        return _normalize(x, mean[split], var[split], self.weight,
                          self.bias, self.eps)


def make_norm(cfg, final_gamma_zero: bool = False):
    """Norm factory (reference batchnorm_helper.get_norm): ``norm(C)``.
    ``sync_batchnorm`` and ``sync_batchnorm_apex`` are plain
    :class:`BatchNorm`, whose statistics are global already."""
    kind = cfg.BN.NORM_TYPE
    if kind in ("batchnorm", "sync_batchnorm", "sync_batchnorm_apex"):
        return lambda c: BatchNorm(c, final_gamma_zero=final_gamma_zero)
    if kind == "sub_batchnorm":
        return lambda c: SubBatchNorm(c, cfg.BN.NUM_SPLITS,
                                      final_gamma_zero=final_gamma_zero)
    raise NotImplementedError(f"Norm type {kind} is not supported")


def is_bn(m: nn.Module) -> bool:
    return isinstance(m, (BatchNorm, SubBatchNorm))


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` whose f32 parameters are cast to the input's type
    where they are used (the port's dtype policy)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv3d(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding, self.dilation, self.groups)


def conv3d(dim_in, dim_out, kernel, stride, padding, *, groups=1,
           bias=False, dilation=(1, 1, 1)) -> Conv3d:
    return Conv3d(dim_in, dim_out, tuple(kernel), tuple(stride),
                  tuple(padding), tuple(dilation), groups, bias)


class Swish(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(x)


class SE(nn.Module):
    """Squeeze-excitation (reference: operators.py SE)."""

    def __init__(self, dim_in: int, ratio: float):
        super().__init__()
        dim_fc = round_width(dim_in, ratio, min_width=8, divisor=8)
        self.fc1 = conv3d(dim_in, dim_fc, (1, 1, 1), (1, 1, 1), (0, 0, 0),
                          bias=True)
        self.fc2 = conv3d(dim_fc, dim_in, (1, 1, 1), (1, 1, 1), (0, 0, 0),
                          bias=True)

    def forward(self, x):
        s = x.mean(dim=(2, 3, 4), keepdim=True)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * torch.sigmoid(s)


# ------------------------------------------------------------------ stems
class ResNetBasicStem(nn.Module):
    """conv(k=[t,7,7], s=[1,2,2]) -> BN -> ReLU -> maxpool [1,3,3]/[1,2,2]."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding, norm):
        super().__init__()
        self.conv = conv3d(dim_in, dim_out, kernel, stride, padding)
        self.bn = norm(dim_out)

    def forward(self, x):
        x = F.relu(self.bn(self.conv(x)))
        return F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class X3DStem(nn.Module):
    """spatial 1xkxk conv -> depthwise temporal kx1x1 conv -> BN -> ReLU."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding, norm):
        super().__init__()
        k, s, p = kernel, stride, padding
        self.conv_xy = conv3d(dim_in, dim_out, (1, k[1], k[2]),
                              (1, s[1], s[2]), (0, p[1], p[2]))
        self.conv = conv3d(dim_out, dim_out, (k[0], 1, 1), (s[0], 1, 1),
                           (p[0], 0, 0), groups=dim_out)
        self.bn = norm(dim_out)

    def forward(self, x):
        return F.relu(self.bn(self.conv(self.conv_xy(x))))


class VideoModelStem(nn.Module):
    """The stems of every pathway (``s1.pathway{p}_stem``)."""

    def __init__(self, stems: list):
        super().__init__()
        for p, stem in enumerate(stems):
            self.add_module(f"pathway{p}_stem", stem)
        self.num_pathways = len(stems)

    def forward(self, xs: list) -> list:
        return [getattr(self, f"pathway{p}_stem")(x)
                for p, x in enumerate(xs)]


# ------------------------------------------------------------- transforms
class BasicTransform(nn.Module):
    """Tx3x3 -> BN -> ReLU -> 1x3x3 -> BN(final)."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, norm,
                 final_norm, **_):
        super().__init__()
        t = temp_kernel_size
        self.a = conv3d(dim_in, dim_out, (t, 3, 3), (1, stride, stride),
                        (t // 2, 1, 1))
        self.a_bn = norm(dim_out)
        self.b = conv3d(dim_out, dim_out, (1, 3, 3), (1, 1, 1), (0, 1, 1))
        self.b_bn = final_norm(dim_out)

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        return self.b_bn(self.b(x))


class BottleneckTransform(nn.Module):
    """Tx1x1 -> 1x3x3 (groups) -> 1x1x1, BN / ReLU between, final BN."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, norm,
                 final_norm, dim_inner, num_groups, stride_1x1=False,
                 dilation=1, **_):
        super().__init__()
        str1, str3 = (stride, 1) if stride_1x1 else (1, stride)
        t = temp_kernel_size
        self.a = conv3d(dim_in, dim_inner, (t, 1, 1), (1, str1, str1),
                        (t // 2, 0, 0))
        self.a_bn = norm(dim_inner)
        self.b = conv3d(dim_inner, dim_inner, (1, 3, 3), (1, str3, str3),
                        (0, dilation, dilation), groups=num_groups,
                        dilation=(1, dilation, dilation))
        self.b_bn = norm(dim_inner)
        self.c = conv3d(dim_inner, dim_out, (1, 1, 1), (1, 1, 1), (0, 0, 0))
        self.c_bn = final_norm(dim_out)

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        x = F.relu(self.b_bn(self.b(x)))
        return self.c_bn(self.c(x))


class X3DTransform(nn.Module):
    """1x1x1 -> Tx3x3 channelwise (+SE every other block, Swish) -> 1x1x1."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, norm,
                 final_norm, dim_inner, num_groups, stride_1x1=False,
                 dilation=1, se_ratio=0.0625, swish_inner=True, block_idx=0,
                 **_):
        super().__init__()
        str1, str3 = (stride, 1) if stride_1x1 else (1, stride)
        t = temp_kernel_size
        self.a = conv3d(dim_in, dim_inner, (1, 1, 1), (1, str1, str1),
                        (0, 0, 0))
        self.a_bn = norm(dim_inner)
        self.b = conv3d(dim_inner, dim_inner, (t, 3, 3), (1, str3, str3),
                        (t // 2, dilation, dilation), groups=num_groups,
                        dilation=(1, dilation, dilation))
        self.b_bn = norm(dim_inner)
        if se_ratio > 0.0 and (block_idx + 1) % 2:
            self.se = SE(dim_inner, se_ratio)
        self.swish_inner = swish_inner
        self.c = conv3d(dim_inner, dim_out, (1, 1, 1), (1, 1, 1), (0, 0, 0))
        self.c_bn = final_norm(dim_out)

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        x = self.b_bn(self.b(x))
        if hasattr(self, "se"):
            x = self.se(x)
        x = x * torch.sigmoid(x) if self.swish_inner else F.relu(x)
        return self.c_bn(self.c(x))


_TRANS = {
    "bottleneck_transform": BottleneckTransform,
    "basic_transform": BasicTransform,
    "x3d_transform": X3DTransform,
}


class Nonlocal(nn.Module):
    """Non-local block (reference: nonlocal_helper.py)."""

    def __init__(self, dim, dim_inner, instantiation="softmax",
                 pool_size=None, norm=None):
        super().__init__()
        self.dim_inner = dim_inner
        self.instantiation = instantiation
        self.pool_size = (tuple(pool_size) if pool_size is not None
                          and any(p > 1 for p in pool_size) else None)
        one = ((1, 1, 1), (1, 1, 1), (0, 0, 0))
        self.conv_theta = conv3d(dim, dim_inner, *one, bias=True)
        self.conv_phi = conv3d(dim, dim_inner, *one, bias=True)
        self.conv_g = conv3d(dim, dim_inner, *one, bias=True)
        self.conv_out = conv3d(dim_inner, dim, *one, bias=True)
        self.bn = norm(dim)

    def forward(self, x):
        B, C, T, H, W = x.shape
        theta = self.conv_theta(x)
        xp = x
        if self.pool_size is not None:
            xp = F.max_pool3d(x, self.pool_size, self.pool_size)
        phi, g = self.conv_phi(xp), self.conv_g(xp)
        d = self.dim_inner
        theta = theta.reshape(B, d, -1).transpose(1, 2)  # [B, q, d]
        phi = phi.reshape(B, d, -1)  # [B, d, k]
        g = g.reshape(B, d, -1).transpose(1, 2)  # [B, k, d]
        attn = torch.bmm(theta.float(), phi.float())
        if self.instantiation == "softmax":
            attn = torch.softmax(attn * d ** -0.5, dim=-1)
        elif self.instantiation == "dot_product":
            attn = attn / attn.shape[-1]
        else:
            raise NotImplementedError(self.instantiation)
        out = torch.bmm(attn.to(x.dtype), g)  # [B, q, d]
        out = out.transpose(1, 2).reshape(B, d, T, H, W)
        return x + self.bn(self.conv_out(out))


class ResBlock(nn.Module):
    """Residual block with an optional 1x1 shortcut (``branch1``)."""

    def __init__(self, dim_in, dim_out, dim_inner, temp_kernel_size, stride,
                 trans_func_name, num_groups, norm, final_norm,
                 stride_1x1=False, dilation=1, block_idx=0,
                 drop_connect_rate=0.0):
        super().__init__()
        self.drop_connect_rate = drop_connect_rate
        self.branch2 = _TRANS[trans_func_name](
            dim_in=dim_in, dim_out=dim_out, temp_kernel_size=temp_kernel_size,
            stride=stride, norm=norm, final_norm=final_norm,
            dim_inner=dim_inner, num_groups=num_groups,
            stride_1x1=stride_1x1, dilation=dilation, block_idx=block_idx)
        if dim_in != dim_out or stride != 1:
            self.branch1 = conv3d(dim_in, dim_out, (1, 1, 1),
                                  (1, stride, stride), (0, 0, 0))
            self.branch1_bn = norm(dim_out)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        f_x = self.branch2(x)
        if self.training and self.drop_connect_rate > 0.0:
            if generator is None:
                raise ValueError("drop-connect in training needs a generator")
            keep = 1.0 - self.drop_connect_rate
            mask = (mesh.dp_rand((x.shape[0],), generator, x.device)
                    < keep).to(f_x.dtype)
            f_x = f_x / keep * mask.reshape(-1, 1, 1, 1, 1)
        if hasattr(self, "branch1"):
            x = self.branch1_bn(self.branch1(x))
        return F.relu(x + f_x)


class ResStage(nn.Module):
    """One multi-pathway residual stage (``sN``): blocks
    ``pathway{p}_res{i}`` and non-local blocks ``pathway{p}_nonlocal{i}``."""

    def __init__(self, dim_in, dim_out, dim_inner, temp_kernel_sizes, stride,
                 num_blocks, num_groups, num_block_temp_kernel,
                 nonlocal_inds, nonlocal_pool, instantiation,
                 trans_func_name, norm, final_norm, stride_1x1=False,
                 dilation=(1,), drop_connect_rate=0.0, **_):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        self.nonlocal_inds = [tuple(i) for i in nonlocal_inds]
        for p in range(len(num_blocks)):
            tks = (list(temp_kernel_sizes[p]) * num_blocks[p])[
                :num_block_temp_kernel[p]] + [1] * (
                    num_blocks[p] - num_block_temp_kernel[p])
            for i in range(num_blocks[p]):
                self.add_module(f"pathway{p}_res{i}", ResBlock(
                    dim_in[p] if i == 0 else dim_out[p], dim_out[p],
                    dim_inner[p], tks[i], stride[p] if i == 0 else 1,
                    trans_func_name, num_groups[p], norm, final_norm,
                    stride_1x1=stride_1x1, dilation=dilation[p],
                    block_idx=i, drop_connect_rate=drop_connect_rate))
                if i in self.nonlocal_inds[p]:
                    self.add_module(f"pathway{p}_nonlocal{i}", Nonlocal(
                        dim_out[p], dim_out[p] // 2, instantiation,
                        pool_size=nonlocal_pool[p], norm=norm))

    def forward(self, xs: list, generator=None) -> list:
        outs = []
        for p, x in enumerate(xs):
            for i in range(self.num_blocks[p]):
                x = getattr(self, f"pathway{p}_res{i}")(x, generator)
                if i in self.nonlocal_inds[p]:
                    x = getattr(self, f"pathway{p}_nonlocal{i}")(x)
            outs.append(x)
        return outs
