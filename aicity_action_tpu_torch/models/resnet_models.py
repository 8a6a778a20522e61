"""Top-level conv video models: ResNet (C2D / I3D / Slow), SlowFast, X3D
(port of ``aicity_action_tpu/models/resnet_models.py``; reference:
video_model_builder.py SlowFast 108-439, ResNet 440-647, X3D 648-793 and
head_helper.py ResNetBasicHead 139-228, X3DHead 229-368).

Each model takes a list of channels-last pathway clips ``[B, T, H, W, C]``
(a single-pathway model also a bare clip), casts them to the compute type
and views them as NCDHW: ``channels_last_3d`` in memory, its conv weights
in the same format, or, after ``set_channels_last(False)``, copies to
contiguous NCDHW with contiguous weights. It returns the head's
softmax / sigmoid scores in f32 at eval and the logits in training. A
training forward with dropout or drop-connect draws its masks from the
``generator`` the caller passes. Under ``DETECTION.ENABLE`` the head is the
RoI head (``models/roi_head.py``): ``forward(xs, bboxes)`` scores each
``[N, 5]`` box row (batch index, then x1, y1, x2, y2 in input pixels) from
the last stage's maps, and applies its activation in training too.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh
from .common import round_width
from .convnets import (MODEL_STAGE_DEPTH, POOL1, TEMPORAL_KERNEL_BASIS,
                       ResNetBasicStem, ResStage, VideoModelStem, X3DStem,
                       conv3d, make_norm)
from .roi_head import ResNetRoIHead

def _head_out(x: torch.Tensor, projection: nn.Linear, dropout_rate: float,
              act_func: str, training: bool, generator) -> torch.Tensor:
    """Shared tail of both heads: ``x [B, C, t, h, w]`` -> dropout ->
    linear on channels-last -> at eval the activation (f32) averaged over
    ``(t, h, w)``; in training the logits ``[B, -1]``."""
    x = x.permute(0, 2, 3, 4, 1)
    if training and dropout_rate > 0.0:
        if generator is None:
            raise ValueError("head dropout in training needs a generator")
        keep = 1.0 - dropout_rate
        mask = mesh.dp_rand(tuple(x.shape), generator, x.device) < keep
        x = torch.where(mask, x / keep, torch.zeros_like(x))
    x = F.linear(x, projection.weight.to(x.dtype),
                 projection.bias.to(x.dtype))
    if training:
        return x.reshape(x.shape[0], -1)
    x = x.float()
    x = torch.softmax(x, dim=-1) if act_func == "softmax" \
        else torch.sigmoid(x)
    return x.mean(dim=(1, 2, 3))


def _check_act(act_func: str) -> None:
    if act_func not in ("softmax", "sigmoid"):
        raise NotImplementedError(
            f"{act_func} is not supported as an activation")


class ResNetBasicHead(nn.Module):
    """AvgPool per pathway -> concat -> dropout -> linear ``projection``."""

    def __init__(self, dim_in: Sequence[int], num_classes: int,
                 pool_size: Sequence, dropout_rate: float = 0.0,
                 act_func: str = "softmax"):
        super().__init__()
        _check_act(act_func)
        self.pool_size = [None if p is None else tuple(p) for p in pool_size]
        self.dropout_rate = dropout_rate
        self.act_func = act_func
        self.projection = nn.Linear(sum(dim_in), num_classes)

    def forward(self, xs: list, generator=None) -> torch.Tensor:
        pooled = []
        for p, x in enumerate(xs):
            ps = self.pool_size[p]
            pooled.append(x.mean(dim=(2, 3, 4), keepdim=True) if ps is None
                          else F.avg_pool3d(x, ps, 1))
        x = torch.cat(pooled, dim=1)
        return _head_out(x, self.projection, self.dropout_rate,
                         self.act_func, self.training, generator)


class X3DHead(nn.Module):
    """conv5 -> BN -> ReLU -> avgpool -> lin5 -> (BN) -> ReLU -> dropout ->
    linear."""

    def __init__(self, dim_in, dim_inner, dim_out, num_classes, pool_size,
                 norm, dropout_rate=0.0, act_func="softmax",
                 bn_lin5_on=False):
        super().__init__()
        _check_act(act_func)
        self.pool_size = None if pool_size is None else tuple(pool_size)
        self.dropout_rate = dropout_rate
        self.act_func = act_func
        one = ((1, 1, 1), (1, 1, 1), (0, 0, 0))
        self.conv_5 = conv3d(dim_in, dim_inner, *one)
        self.conv_5_bn = norm(dim_inner)
        self.lin_5 = conv3d(dim_inner, dim_out, *one)
        if bn_lin5_on:
            self.lin_5_bn = norm(dim_out)
        self.projection = nn.Linear(dim_out, num_classes)

    def forward(self, xs: list, generator=None) -> torch.Tensor:
        x = F.relu(self.conv_5_bn(self.conv_5(xs[0])))
        x = (x.mean(dim=(2, 3, 4), keepdim=True) if self.pool_size is None
             else F.avg_pool3d(x, self.pool_size, 1))
        x = self.lin_5(x)
        if hasattr(self, "lin_5_bn"):
            x = self.lin_5_bn(x)
        x = F.relu(x)
        return _head_out(x, self.projection, self.dropout_rate,
                         self.act_func, self.training, generator)


class FuseFastToSlow(nn.Module):
    """Fast -> Slow lateral fusion (``sN_fuse``)."""

    def __init__(self, dim_in_fast, fusion_conv_channel_ratio, fusion_kernel,
                 alpha, norm):
        super().__init__()
        self.conv_f2s = conv3d(
            dim_in_fast, dim_in_fast * fusion_conv_channel_ratio,
            (fusion_kernel, 1, 1), (alpha, 1, 1), (fusion_kernel // 2, 0, 0))
        self.bn = norm(dim_in_fast * fusion_conv_channel_ratio)

    def forward(self, xs: list) -> list:
        x_s, x_f = xs
        fuse = F.relu(self.bn(self.conv_f2s(x_f)))
        return [torch.cat([x_s, fuse], dim=1), x_f]


def _stage_kwargs(cfg, idx, norm, final_norm, pathways=1):
    def per_path(v):
        v = list(v)
        return v * pathways if len(v) == 1 else v

    return dict(
        nonlocal_inds=per_path(cfg.NONLOCAL.LOCATION[idx]),
        nonlocal_pool=[tuple(p) for p in cfg.NONLOCAL.POOL[idx]],
        instantiation=cfg.NONLOCAL.INSTANTIATION,
        trans_func_name=cfg.RESNET.TRANS_FUNC,
        stride_1x1=cfg.RESNET.STRIDE_1X1,
        dilation=per_path(cfg.RESNET.SPATIAL_DILATIONS[idx])[:pathways],
        norm=norm,
        final_norm=final_norm,
    )


class _ConvNet(nn.Module):
    """The shared input handling of the conv models."""

    def __init__(self, cfg, compute_dtype: torch.dtype):
        super().__init__()
        self.detection = cfg.DETECTION.ENABLE
        self.compute_dtype = compute_dtype
        # channels-last clips viewed as NCDHW are channels_last_3d already;
        # on an H100 SlowFast R50 8x8's b8 forward runs 38.2 ms so against
        # 40.7 copied to NCDHW (tools/bench_convs.py --convnet, PERF.md)
        self.channels_last = True
        self.norm = make_norm(cfg)
        self.final_norm = make_norm(
            cfg, final_gamma_zero=cfg.RESNET.ZERO_INIT_FINAL_BN)

    def set_channels_last(self, on: bool) -> "_ConvNet":
        """The convs' memory format: the inputs' and the conv weights'
        (``channels_last_3d``, or contiguous NCDHW). Returns the model."""
        self.channels_last = on
        return self.to(memory_format=torch.channels_last_3d if on
                       else torch.contiguous_format)

    def _inputs(self, x) -> list:
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        out = []
        for t in xs:
            t = t.to(self.compute_dtype).permute(0, 4, 1, 2, 3)
            out.append(t if self.channels_last else t.contiguous())
        return out

    def _head(self, xs: list, bboxes, generator) -> torch.Tensor:
        if not self.detection:
            return self.head(xs, generator)
        if bboxes is None:
            raise ValueError("a detection model scores boxes: pass bboxes")
        # the RoI head reads channels-last [B, T, H, W, C] views
        return self.head([x.permute(0, 2, 3, 4, 1) for x in xs], bboxes,
                         generator)

    def _roi_head(self, cfg, dim_in: list) -> ResNetRoIHead:
        """The RoI head (reference video_model_builder.py:404-416, 595-606)
        over ``dim_in`` channels a pathway."""
        det = cfg.DETECTION
        n = len(dim_in)
        return ResNetRoIHead(
            dim_in, cfg.MODEL.NUM_CLASSES,
            resolution=[det.ROI_XFORM_RESOLUTION] * n,
            scale_factor=[det.SPATIAL_SCALE_FACTOR] * n,
            dropout_rate=cfg.MODEL.DROPOUT_RATE,
            act_func=cfg.MODEL.HEAD_ACT, aligned=det.ALIGNED)


class ResNet(_ConvNet):
    """Single-pathway 3-D ResNet (C2D / I3D / Slow and their ``_nopool``
    forms)."""

    def __init__(self, cfg, compute_dtype: torch.dtype = torch.float32):
        super().__init__(cfg, compute_dtype)
        arch = cfg.MODEL.ARCH
        self.pool_size = POOL1[arch]
        d2, d3, d4, d5 = MODEL_STAGE_DEPTH[cfg.RESNET.DEPTH]
        ng, wpg = cfg.RESNET.NUM_GROUPS, cfg.RESNET.WIDTH_PER_GROUP
        dim_inner = ng * wpg
        tk = TEMPORAL_KERNEL_BASIS[arch]
        c_in = cfg.DATA.INPUT_CHANNEL_NUM[0]
        self.s1 = VideoModelStem([ResNetBasicStem(
            c_in, wpg, (tk[0][0][0], 7, 7), (1, 2, 2),
            (tk[0][0][0] // 2, 3, 3), self.norm)])
        dims = [wpg, wpg * 4, wpg * 8, wpg * 16, wpg * 32]
        inners = [dim_inner, dim_inner * 2, dim_inner * 4, dim_inner * 8]
        depths = [d2, d3, d4, d5]
        for si in range(4):
            self.add_module(f"s{si + 2}", ResStage(
                dim_in=[dims[si]], dim_out=[dims[si + 1]],
                dim_inner=[inners[si]],
                temp_kernel_sizes=[tk[si + 1][0]],
                stride=[cfg.RESNET.SPATIAL_STRIDES[si][0]],
                num_blocks=[depths[si]], num_groups=[ng],
                num_block_temp_kernel=[
                    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL[si][0]],
                **_stage_kwargs(cfg, si, self.norm, self.final_norm)))
        ps = self.pool_size[0]
        crop = cfg.DATA.TRAIN_CROP_SIZE
        self.head = self._roi_head(cfg, [dims[4]]) if self.detection else \
            ResNetBasicHead(
                [dims[4]], cfg.MODEL.NUM_CLASSES,
                [(cfg.DATA.NUM_FRAMES // ps[0], crop // 32 // ps[1],
                  crop // 32 // ps[2])],
                cfg.MODEL.DROPOUT_RATE, cfg.MODEL.HEAD_ACT)

    def forward(self, x, bboxes=None, generator=None):
        xs = self.s1(self._inputs(x))
        xs = self.s2(xs, generator)
        ps = self.pool_size[0]
        xs = [F.max_pool3d(xs[0], ps, ps)]
        for name in ("s3", "s4", "s5"):
            xs = getattr(self, name)(xs, generator)
        return self._head(xs, bboxes, generator)


class SlowFast(_ConvNet):
    """Two-pathway SlowFast network: slow clip ``[B, T/alpha, ...]`` first,
    fast clip ``[B, T, ...]`` second."""

    def __init__(self, cfg, compute_dtype: torch.dtype = torch.float32):
        super().__init__(cfg, compute_dtype)
        self.pool_size = POOL1["slowfast"]
        d2, d3, d4, d5 = MODEL_STAGE_DEPTH[cfg.RESNET.DEPTH]
        ng, wpg = cfg.RESNET.NUM_GROUPS, cfg.RESNET.WIDTH_PER_GROUP
        dim_inner = ng * wpg
        beta = cfg.SLOWFAST.BETA_INV
        fcr = cfg.SLOWFAST.FUSION_CONV_CHANNEL_RATIO
        out_dim_ratio = beta // fcr
        alpha = cfg.SLOWFAST.ALPHA
        fk = cfg.SLOWFAST.FUSION_KERNEL_SZ
        tk = TEMPORAL_KERNEL_BASIS["slowfast"]
        chans = list(cfg.DATA.INPUT_CHANNEL_NUM)
        c_in = chans + chans[:1] if len(chans) == 1 else chans
        self.s1 = VideoModelStem([
            ResNetBasicStem(c_in[0], wpg, (tk[0][0][0], 7, 7), (1, 2, 2),
                            (tk[0][0][0] // 2, 3, 3), self.norm),
            ResNetBasicStem(c_in[1], wpg // beta, (tk[0][1][0], 7, 7),
                            (1, 2, 2), (tk[0][1][0] // 2, 3, 3), self.norm),
        ])
        self.s1_fuse = FuseFastToSlow(wpg // beta, fcr, fk, alpha, self.norm)
        dims = [wpg, wpg * 4, wpg * 8, wpg * 16, wpg * 32]
        inners = [dim_inner, dim_inner * 2, dim_inner * 4, dim_inner * 8]
        depths = [d2, d3, d4, d5]
        for si in range(4):
            nbtk = list(cfg.RESNET.NUM_BLOCK_TEMP_KERNEL[si])
            self.add_module(f"s{si + 2}", ResStage(
                dim_in=[dims[si] + dims[si] // out_dim_ratio,
                        dims[si] // beta],
                dim_out=[dims[si + 1], dims[si + 1] // beta],
                dim_inner=[inners[si], inners[si] // beta],
                temp_kernel_sizes=[tk[si + 1][0], tk[si + 1][1]],
                stride=[cfg.RESNET.SPATIAL_STRIDES[si][0]] * 2,
                num_blocks=[depths[si]] * 2, num_groups=[ng] * 2,
                num_block_temp_kernel=nbtk * 2 if len(nbtk) == 1 else nbtk,
                **{**_stage_kwargs(cfg, si, self.norm, self.final_norm, 2),
                   "dilation": [cfg.RESNET.SPATIAL_DILATIONS[si][0]] * 2}))
            if si < 3:
                self.add_module(f"s{si + 2}_fuse", FuseFastToSlow(
                    dims[si + 1] // beta, fcr, fk, alpha, self.norm))
        crop, T = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES
        p0, p1 = self.pool_size
        self.head = (
            self._roi_head(cfg, [dims[4], dims[4] // beta]) if self.detection
            else ResNetBasicHead(
                [dims[4], dims[4] // beta], cfg.MODEL.NUM_CLASSES,
                [(T // alpha // p0[0], crop // 32 // p0[1],
                  crop // 32 // p0[2]),
                 (T // p1[0], crop // 32 // p1[1], crop // 32 // p1[2])],
                cfg.MODEL.DROPOUT_RATE, cfg.MODEL.HEAD_ACT))

    def forward(self, x, bboxes=None, generator=None):
        xs = self.s1_fuse(self.s1(self._inputs(x)))
        for si in range(4):
            xs = getattr(self, f"s{si + 2}")(xs, generator)
            if si == 0:
                xs = [F.max_pool3d(t, ps, ps)
                      for t, ps in zip(xs, self.pool_size)]
            if si < 3:
                xs = getattr(self, f"s{si + 2}_fuse")(xs)
        return self._head(xs, bboxes, generator)


class X3D(_ConvNet):
    """X3D with width / depth expansion. It has no detection head, in the
    reference as in the JAX package."""

    def __init__(self, cfg, compute_dtype: torch.dtype = torch.float32):
        if cfg.DETECTION.ENABLE:
            raise ValueError("X3D has no RoI head (neither the reference nor "
                             "the JAX package builds one)")
        super().__init__(cfg, compute_dtype)
        tk = TEMPORAL_KERNEL_BASIS["x3d"]
        w_mul, d_mul = cfg.X3D.WIDTH_FACTOR, cfg.X3D.DEPTH_FACTOR
        dim_c1 = cfg.X3D.DIM_C1
        exp = 2.0
        dim_res2 = (round_width(dim_c1, exp, divisor=8)
                    if cfg.X3D.SCALE_RES2 else dim_c1)
        dim_res3 = round_width(dim_res2, exp, divisor=8)
        dim_res4 = round_width(dim_res3, exp, divisor=8)
        dim_res5 = round_width(dim_res4, exp, divisor=8)
        block_basis = [(1, dim_res2, 2), (2, dim_res3, 2),
                       (5, dim_res4, 2), (3, dim_res5, 2)]
        dim_res1 = round_width(dim_c1, w_mul)
        self.s1 = VideoModelStem([X3DStem(
            cfg.DATA.INPUT_CHANNEL_NUM[0], dim_res1, (tk[0][0][0], 3, 3),
            (1, 2, 2), (tk[0][0][0] // 2, 1, 1), self.norm)])
        dim_in = dim_res1
        dim_inner = dim_in
        for stage, (rep, w, s) in enumerate(block_basis):
            dim_out = round_width(w, w_mul)
            dim_inner = int(cfg.X3D.BOTTLENECK_FACTOR * dim_out)
            n_rep = int(math.ceil(d_mul * rep)) if d_mul else rep
            self.add_module(f"s{stage + 2}", ResStage(
                dim_in=[dim_in], dim_out=[dim_out], dim_inner=[dim_inner],
                temp_kernel_sizes=[tk[1][0]], stride=[s],
                num_blocks=[n_rep],
                num_groups=[dim_inner if cfg.X3D.CHANNELWISE_3x3x3
                            else cfg.RESNET.NUM_GROUPS],
                num_block_temp_kernel=[n_rep],
                drop_connect_rate=cfg.MODEL.DROPCONNECT_RATE
                * (stage + 2) / (len(block_basis) + 1),
                **_stage_kwargs(cfg, 0, self.norm, self.final_norm)))
            dim_in = dim_out
        spat = int(math.ceil(cfg.DATA.TRAIN_CROP_SIZE / 32.0))
        self.head = X3DHead(
            dim_in, dim_inner, cfg.X3D.DIM_C5, cfg.MODEL.NUM_CLASSES,
            (cfg.DATA.NUM_FRAMES, spat, spat), self.norm,
            cfg.MODEL.DROPOUT_RATE, cfg.MODEL.HEAD_ACT, cfg.X3D.BN_LIN5)

    def forward(self, x, generator=None):
        xs = self.s1(self._inputs(x))
        for name in ("s2", "s3", "s4", "s5"):
            xs = getattr(self, name)(xs, generator)
        return self.head(xs, generator)
