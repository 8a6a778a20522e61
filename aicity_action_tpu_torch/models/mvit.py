"""MViT-v1/v2 video backbone (port of ``aicity_action_tpu/models/mvit.py``;
reference: slowfast/models/video_model_builder.py:794-1335 and
slowfast/models/attention.py).

- The block schedule is the same pure derivation (:func:`build_mvit_spec`).
- Tokens are ``[B, L, C]``; the input clip is channels-last
  ``[B, T, H, W, 3]`` as in the JAX package.
- Parameter names follow the reference PySlowFast ``state_dict``, so a
  released ``.pyth`` ``model_state`` loads with ``load_state_dict``.
- Which attention a conv-pool block takes follows the JAX package's
  switch ``AICITY_TPU_FUSE_ATTN_LN`` (``mvit.py:335-354``, ported as
  :func:`_fuse_attn_ln_enabled`): ``auto`` (the default) fuses at eval
  only, ``1`` in training too, ``0`` nowhere; a cls-token model never fuses
  (``mvit.py:543-548``). Fused: norm1 + qkv in :func:`fused_ln_qkv`, the
  post-pool per-head LNs, attention and the v2 q-residual in
  :func:`flash_attention_ln` (with its backward kernel under autograd),
  norm2 + MLP in :func:`fused_ln_mlp`, and the final norm in
  :func:`fused_layer_norm`.
- Unfused (and for the max / avg pool modes): the pooled q, k, v become
  head-major token rows, each conv-pooled one through its own pool norm
  (eps 1e-5; :func:`pool_norm_rows`, which reads the pool convolution's
  layout, wherever the length is a multiple of 8 and there is no cls
  token, else a copy and :func:`fused_layer_norm`), then
  :func:`flash_attention` (or, with a cls token's odd lengths
  ``1 + T*H*W``, :func:`flash_attention_padded`) and ``+ q`` outside the
  kernel. Every kernel there has a backward kernel.
- MViT-v1 (``CHANNEL_EXPAND_FRONT False``): attention runs at the block's
  input width, the MLP changes the channels, and the residual of such a
  block is ``proj(norm2(x))``; the cls token bypasses pooling, rejoins
  before the pool norm, and its final-norm row feeds the head.
- ``MVIT.MOE.ENABLE``: the blocks of ``MVIT.MOE.LAYERS`` (every other one
  by default) take an expert bank in place of the LN+MLP kernel
  (``models/moe.py``); the forward leaves their load-balance losses in
  ``MViT.moe_aux`` for the train step.
- DropPath masks are drawn from the caller's generator before each block,
  so that the recompute of ``MODEL.ACT_CHECKPOINT`` (per-block
  ``torch.utils.checkpoint``) applies the same masks.
- Numerics: block norms use eps 1e-6, the pool norms torch's default 1e-5
  (``attention.py:338``); GELU is the exact erf form; parameters stay f32
  and are cast to the compute type where they are used.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..ops import kernels
from ..ops.flash_attention import (flash_attention, flash_attention_ln,
                                   flash_attention_padded,
                                   require_ln_training_head_dim)
from ..ops.fused_dense import exact_gelu, fused_ln_mlp, fused_ln_qkv
from ..ops.layer_norm import (channel_major_applies, fused_layer_norm,
                              pool_norm_rows)
from ..ops.pooling import attention_pool, pool3d_ncdhw
from .common import FusedLayerNorm, drop_path, drop_path_mask, round_width
from .moe import MoEMlp, MoESpec
from .heads import (ContrastiveProjectionHead, TransformerBasicHead,
                    TransformerMultiHead)
from .roi_head import ResNetRoIHead

Triple = tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Static description of one MultiScaleBlock."""

    dim: int  # input channel dim
    dim_out: int  # output channel dim
    num_heads: int
    kernel_q: Triple | tuple  # () = no q pooling
    kernel_kv: Triple | tuple
    stride_q: Triple | tuple
    stride_kv: Triple | tuple
    drop_path: float
    moe: bool = False


@dataclasses.dataclass(frozen=True)
class MViTSpec:
    """Static, hashable description of a full MViT model."""

    crop_size: int
    num_frames: int
    in_channels: int
    patch_kernel: Triple
    patch_stride: Triple
    patch_padding: Triple
    embed_dim: int
    depth: int
    cls_embed: bool
    sep_pos_embed: bool
    drop_rate: float
    mode: str  # conv | max | avg
    qkv_bias: bool
    mlp_ratio: float
    q_pool_residual: bool
    channel_expand_front: bool
    no_norm_before_avg: bool
    direct_input: bool
    blocks: tuple  # tuple[BlockSpec, ...]
    num_classes: int
    head_dropout: float
    head_act: str
    use_head_act_in_train: bool
    act_checkpoint: bool
    contra_enable: bool = False
    contra_embed_dim: int = 512
    contra_use_mlp: bool = False
    use_multi_head: bool = False
    multi_datasets: tuple = ()
    multi_num_classes: tuple = ()
    multi_head_act: tuple = ()
    multi_use_mlp: bool = False
    multi_add_cross_proj: bool = False
    detection_enable: bool = False
    roi_resolution: int = 7
    roi_scale_factor: int = 16
    roi_aligned: bool = True
    use_spatial_maxpool_before_proj: bool = False
    moe: MoESpec = MoESpec()

    @property
    def patch_dims(self) -> Triple:
        return (
            self.num_frames // self.patch_stride[0],
            self.crop_size // self.patch_stride[1],
            self.crop_size // self.patch_stride[2],
        )


def _t3(x) -> Triple:
    return tuple(int(v) for v in x)  # type: ignore[return-value]


def build_mvit_spec(cfg) -> MViTSpec:
    """Derive the static block schedule from a config (the reference
    constructor logic, ``video_model_builder.py:915-1040``): dim/head
    multipliers, the q-pool stride schedule (Q_POOL_ALL adds stride-1 conv
    pooling at every block) and the adaptive kv-stride decay."""
    m = cfg.MVIT
    depth = m.DEPTH

    dim_mul = np.ones(depth + 1)
    head_mul = np.ones(depth + 1)
    for i, mul in m.DIM_MUL:
        dim_mul[i] = mul
    for i, mul in m.HEAD_MUL:
        head_mul[i] = mul

    pool_q: list = [() for _ in range(depth)]
    pool_kv: list = [() for _ in range(depth)]
    stride_q: list = [() for _ in range(depth)]
    stride_kv: list = [() for _ in range(depth)]

    kvq_kernel = m.POOL_KVQ_KERNEL
    for entry in m.POOL_Q_STRIDE:
        i, s = entry[0], entry[1:]
        stride_q[i] = _t3(s)
        pool_q[i] = _t3(kvq_kernel) if kvq_kernel is not None else _t3(
            [v + 1 if v > 1 else v for v in s])

    if m.Q_POOL_ALL:
        if kvq_kernel is None:
            raise ValueError("MVIT.Q_POOL_ALL needs MVIT.POOL_KVQ_KERNEL")
        for i in range(depth):
            if not pool_q[i]:
                pool_q[i] = _t3(kvq_kernel)
                stride_q[i] = (1, 1, 1)

    kv_stride_schedule = m.POOL_KV_STRIDE
    if m.POOL_KV_STRIDE_ADAPTIVE is not None:
        _skv = list(m.POOL_KV_STRIDE_ADAPTIVE)
        kv_stride_schedule = []
        for i in range(depth):
            if len(stride_q[i]) > 0:
                _skv = [max(_skv[d] // stride_q[i][d], 1) for d in range(3)]
            kv_stride_schedule.append([i] + list(_skv))

    for entry in kv_stride_schedule or []:
        i, s = entry[0], entry[1:]
        stride_kv[i] = _t3(s)
        pool_kv[i] = _t3(kvq_kernel) if kvq_kernel is not None else _t3(
            [v + 1 if v > 1 else v for v in s])

    dpr = np.linspace(0, m.DROPPATH_RATE, depth)

    moe_spec = MoESpec()
    moe_layers: frozenset = frozenset()
    if m.MOE.ENABLE:
        layers = tuple(int(i) for i in m.MOE.LAYERS)
        if not layers:
            layers = tuple(range(1, depth, 2))
        moe_spec = MoESpec(
            num_experts=int(m.MOE.NUM_EXPERTS),
            top_k=int(m.MOE.TOP_K),
            capacity_factor=float(m.MOE.CAPACITY_FACTOR),
            layers=layers,
        )
        moe_layers = frozenset(layers)

    blocks = []
    num_heads = m.NUM_HEADS
    embed_dim = m.EMBED_DIM
    dim_out = m.EMBED_DIM
    for i in range(depth):
        num_heads = round_width(num_heads, head_mul[i])
        if m.CHANNEL_EXPAND_FRONT:
            embed_dim_mul = 1.0 if i == 0 else dim_mul[i - 1]
            embed_dim = round_width(embed_dim, embed_dim_mul,
                                    divisor=num_heads)
            dim_out = round_width(dim_out, dim_mul[i], divisor=num_heads)
        else:
            embed_dim = round_width(embed_dim, dim_mul[i], divisor=num_heads)
            dim_out = round_width(
                embed_dim, dim_mul[i + 1],
                divisor=round_width(num_heads, head_mul[i + 1]))
        moe_here = i in moe_layers
        if moe_here and not (m.CHANNEL_EXPAND_FRONT or embed_dim == dim_out):
            raise ValueError(
                f"MVIT.MOE.LAYERS includes block {i}, which changes "
                f"channels {embed_dim}->{dim_out}; MoE blocks must have "
                "dim == dim_out (pick non-transition blocks)")
        blocks.append(BlockSpec(
            dim=embed_dim, dim_out=dim_out, num_heads=num_heads,
            kernel_q=pool_q[i], kernel_kv=pool_kv[i],
            stride_q=stride_q[i], stride_kv=stride_kv[i],
            drop_path=float(dpr[i]), moe=moe_here,
        ))

    return MViTSpec(
        crop_size=cfg.DATA.TRAIN_CROP_SIZE,
        num_frames=cfg.DATA.NUM_FRAMES,
        in_channels=cfg.DATA.INPUT_CHANNEL_NUM[0],
        patch_kernel=_t3(m.PATCH_KERNEL),
        patch_stride=_t3(m.PATCH_STRIDE),
        patch_padding=_t3(m.PATCH_PADDING),
        embed_dim=m.EMBED_DIM,
        depth=depth,
        cls_embed=m.CLS_EMBED_ON,
        sep_pos_embed=m.SEP_POS_EMBED,
        drop_rate=m.DROPOUT_RATE,
        mode=m.MODE,
        qkv_bias=m.QKV_BIAS,
        mlp_ratio=m.MLP_RATIO,
        q_pool_residual=m.Q_POOL_RESIDUAL,
        channel_expand_front=m.CHANNEL_EXPAND_FRONT,
        no_norm_before_avg=m.NO_NORM_BEFORE_AVG,
        direct_input=m.DIRECT_INPUT,
        blocks=tuple(blocks),
        num_classes=cfg.MODEL.NUM_CLASSES,
        head_dropout=cfg.MODEL.DROPOUT_RATE,
        head_act=cfg.MODEL.HEAD_ACT,
        use_head_act_in_train=cfg.MODEL.USE_HEAD_ACT_IN_TRAIN,
        act_checkpoint=cfg.MODEL.ACT_CHECKPOINT,
        contra_enable=cfg.CONTRA.ENABLE,
        contra_embed_dim=cfg.CONTRA.embed_dim,
        contra_use_mlp=cfg.CONTRA.use_MLP,
        use_multi_head=cfg.MODEL.USE_MULTI_HEAD,
        multi_datasets=tuple(cfg.MODEL.MULTI_DATASETS),
        multi_num_classes=tuple(cfg.MODEL.MULTI_NUM_CLASSES),
        multi_head_act=tuple(cfg.MODEL.MULTI_HEAD_ACT),
        multi_use_mlp=cfg.MODEL.MULTI_USE_MLP,
        multi_add_cross_proj=cfg.MODEL.MULTI_ADD_CROSS_PROJ,
        detection_enable=cfg.DETECTION.ENABLE,
        roi_resolution=cfg.DETECTION.ROI_XFORM_RESOLUTION,
        roi_scale_factor=cfg.DETECTION.SPATIAL_SCALE_FACTOR,
        roi_aligned=cfg.DETECTION.ALIGNED,
        use_spatial_maxpool_before_proj=(
            cfg.DETECTION.USE_SPATIAL_MAXPOOL_BEFORE_PROJ),
        moe=moe_spec,
    )


def dense_call_shapes(cfg, batch: int) -> list:
    """The ``fused_ln_qkv`` and ``fused_ln_mlp`` calls of one forward at
    ``batch``, from the block schedule (no model is built): ``("qkv", M,
    tokens, D, C)`` per block (x ``[M, D]`` -> q, k, v of C channels) and
    ``("mlp", M, C, H)`` per block whose MLP keeps its channels (the others
    run a separate norm2 and plain products, an MoE block its expert bank).
    The kernels' plan tests and the profiling tools take their shapes from
    it."""
    sp = build_mvit_spec(cfg)
    thw, cls = list(sp.patch_dims), int(sp.cls_embed)
    calls = []
    for b in sp.blocks:
        att = (b.dim_out if sp.channel_expand_front and b.dim != b.dim_out
               else b.dim)
        tokens = int(np.prod(thw)) + cls
        calls.append(("qkv", batch * tokens, tokens, b.dim, att))
        if b.stride_q and b.kernel_q:  # the conv q pool, padding k // 2
            thw = [(n + 2 * (k // 2) - k) // s + 1
                   for n, k, s in zip(thw, b.kernel_q, b.stride_q)]
        if att == b.dim_out and not b.moe:  # an expert bank: no LN+MLP
            calls.append(("mlp", batch * (int(np.prod(thw)) + cls), att,
                          int(att * sp.mlp_ratio)))
    return calls


def attention_call_shapes(cfg, batch: int) -> list:
    """The attention of each block of one forward at ``batch``, from the
    block schedule (no model is built): ``(G, Lq, Lk, d)``, ``G = batch *
    heads`` groups of ``Lq`` pooled queries against ``Lk`` pooled keys
    (each ``+ 1`` with a cls token) of head dim ``d``. The attention
    backward's plan tests take their shapes from it."""
    sp = build_mvit_spec(cfg)
    thw, cls = list(sp.patch_dims), int(sp.cls_embed)

    def pooled(kernel, stride):
        if not _pool_active(kernel, stride):
            return thw
        return [(n + 2 * (k // 2) - k) // s + 1
                for n, k, s in zip(thw, kernel, stride)]

    calls = []
    for b in sp.blocks:
        att = (b.dim_out if sp.channel_expand_front and b.dim != b.dim_out
               else b.dim)
        tq = pooled(b.kernel_q, b.stride_q)
        tk = pooled(b.kernel_kv, b.stride_kv)
        calls.append((batch * b.num_heads, int(np.prod(tq)) + cls,
                      int(np.prod(tk)) + cls, att // b.num_heads))
        thw = tq
    return calls


def pool_norm_call_shapes(sp: MViTSpec, batch: int) -> list:
    """The pool norms of one unfused forward of the model ``sp`` at
    ``batch``, from the block schedule (no model is built): ``(block, name,
    batch, heads, d, L)`` for each conv-pooled q, k, v, ``L`` its pooled
    tokens (``+ 1`` with a cls token). The LayerNorm plan tests and
    ``chip_smoke.py``'s launch counts take them from it."""
    thw, cls = list(sp.patch_dims), int(sp.cls_embed)
    calls = []
    for i, b in enumerate(sp.blocks):
        att = (b.dim_out if sp.channel_expand_front and b.dim != b.dim_out
               else b.dim)
        out_q = thw
        for name, kernel, stride in (("q", b.kernel_q, b.stride_q),
                                     ("k", b.kernel_kv, b.stride_kv),
                                     ("v", b.kernel_kv, b.stride_kv)):
            if not _pool_active(kernel, stride):
                continue
            out = [(n + 2 * (k // 2) - k) // s + 1
                   for n, k, s in zip(thw, kernel, stride)]
            if name == "q":
                out_q = out
            if sp.mode == "conv":
                calls.append((i, name, batch, b.num_heads,
                              att // b.num_heads, int(np.prod(out)) + cls))
        thw = out_q
    return calls


def _cast(t: torch.Tensor | None, dtype: torch.dtype):
    return None if t is None else t.to(dtype)


def _pool_active(kernel, stride) -> bool:
    """Pooling is skipped for an empty kernel or a 1x1x1 unit-stride one."""
    return len(kernel) > 0 and not (
        np.prod(kernel) == 1 and np.prod(stride) == 1)


def _fuse_attn_ln_enabled(training: bool) -> bool:
    """The JAX package's switch for the fused post-pool-LN attention
    (``mvit.py:335-354``): ``AICITY_TPU_FUSE_ATTN_LN`` ``auto`` (default)
    fuses at eval only, ``1`` in training too, ``0`` nowhere."""
    v = os.environ.get("AICITY_TPU_FUSE_ATTN_LN", "auto")
    if v == "0":
        return False
    if v == "1":
        return True
    return not training


class MultiScaleAttention(nn.Module):
    """Pooled multi-head attention (reference: attention.py:86-284).
    ``qkv`` takes the un-normalized block input and norm1's parameters and
    writes q/k/v channel-major; they are pooled by depthwise 3-D convs
    (``pool_*``, one ``[d, 1, kT, kH, kW]`` weight shared by the heads) or
    by max / avg pooling; a cls token (column 0) bypasses the pooling. On
    the fused path (see :func:`_fuse_attn_ln_enabled`) the pool norms
    (``norm_*``, over head_dim; parameters only, applied inside the
    kernel), attention and the q-residual run in one kernel on d-major head
    views ``[B*h, L, d]``; otherwise see :meth:`_unfused`."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, kernel_q,
                 kernel_kv, stride_q, stride_kv, mode: str, qkv_bias: bool,
                 has_cls: bool, q_pool_residual: bool):
        super().__init__()
        if mode not in ("conv", "max", "avg"):
            raise ValueError(f"unknown pool mode {mode!r}")
        self.mode = mode
        self.has_cls = has_cls
        self.num_heads = num_heads
        self.head_dim = d = dim_out // num_heads
        self.scale = d ** -0.5
        self.norm_eps = 1e-5  # torch's nn.LayerNorm default, attention.py:338
        self.q_pool_residual = q_pool_residual
        self.qkv = nn.Linear(dim, 3 * dim_out, bias=qkv_bias)
        self.proj = nn.Linear(dim_out, dim_out)
        self.pooled = []
        for name, kernel, stride in (("q", kernel_q, stride_q),
                                     ("k", kernel_kv, stride_kv),
                                     ("v", kernel_kv, stride_kv)):
            if not _pool_active(kernel, stride):
                continue
            self.pooled.append(name)
            if mode != "conv":  # the JAX package norms conv pools only
                setattr(self, f"pool_{name}", (tuple(kernel), tuple(stride)))
                continue
            setattr(self, f"pool_{name}", nn.Conv3d(
                d, d, tuple(kernel), tuple(stride),
                tuple(k // 2 for k in kernel), groups=d, bias=False))
            setattr(self, f"norm_{name}",
                    FusedLayerNorm(d, eps=1e-5, groups=num_heads))

    def _pool(self, name: str, t: torch.Tensor, thw: Triple):
        """Pool one channel-major ``[B, C, (1 +) L]`` tensor; returns it
        flattened, ``[B, C, (1 +) L']``, and the pooled (T', H', W'). A cls
        column bypasses the pooling and is re-attached in front, before
        the pool norm (the JAX order, ``mvit.py:565-589``)."""
        cls_col = None
        if self.has_cls:
            cls_col, t = t[:, :, :1], t[:, :, 1:]
        B, C, _ = t.shape
        t = t.reshape(B, C, *thw)
        pool = getattr(self, f"pool_{name}")
        if self.mode == "conv":
            # one [d, 1, k, k, k] weight shared by the heads (mvit.py:567)
            y = F.conv3d(t, pool.weight.to(t.dtype).repeat(
                self.num_heads, 1, 1, 1, 1), None, pool.stride,
                pool.padding, 1, C)
        else:
            kernel, stride = pool
            y = pool3d_ncdhw(t, self.mode, kernel, stride,
                             tuple(k // 2 for k in kernel))
        out_thw = tuple(y.shape[2:])
        y = y.flatten(2)
        if cls_col is not None:
            y = torch.cat([cls_col, y], dim=2)
        return y, out_thw

    def forward(self, x: torch.Tensor, thw: Triple, norm1: FusedLayerNorm):
        B, L, D = x.shape
        dt = x.dtype
        fuse = (self.mode == "conv" and not self.has_cls and self.pooled
                and _fuse_attn_ln_enabled(self.training))
        if fuse and torch.is_grad_enabled() and kernels.use_kernel(x):
            # the fused-LN training kernels' head dim (96 or 72), checked
            # before this block launches anything
            require_ln_training_head_dim(self.head_dim)
        # q, k, v come channel-major, [B, C, L]: the NCDHW layout the pool
        # convolutions take and the d-major one the fused attention kernel
        # reads, so on the fused path none of the three is transposed in
        # device memory
        t3 = dict(zip("qkv", fused_ln_qkv(
            x.reshape(B * L, D).contiguous(), norm1.weight.to(dt),
            norm1.bias.to(dt), self.qkv.weight.to(dt),
            _cast(self.qkv.bias, dt), norm1.eps, tokens=L)))
        out_thw = thw
        for name in self.pooled:
            t3[name], pooled_thw = self._pool(name, t3[name], thw)
            if name == "q":
                out_thw = pooled_thw
        # the JAX package fuses where its switch says so, for conv pools
        # without a cls token and with at least one pool norm (mvit.py:
        # 543-548, 597)
        if fuse:
            out = self._fused(t3, B, dt, x.device)
        else:
            out = self._unfused(t3, B)
        out = F.linear(out, self.proj.weight.to(dt), self.proj.bias.to(dt))
        return out, out_thw

    def _unfused(self, t3: dict, B: int) -> torch.Tensor:
        """The JAX package's path when the fused-LN kernel is off
        (``mvit.py:643-682``): pooled q, k, v become head-major token rows
        ``[B*h, L, d]``, each conv-pooled one normalized by its pool norm
        (grouped per head: one row of d per head and token), then
        :func:`flash_attention` (:func:`flash_attention_padded` at a cls
        token's odd lengths) and the v2 residual ``+ q`` outside it. A pool
        norm of head dim 96 without a cls token over ``L % 8 == 0`` tokens
        reads the pool
        convolution's ``[B, h*d, L]`` and writes the rows itself
        (:func:`pool_norm_rows`); every other tensor is copied into
        contiguous rows (one transpose each; their gradients pay one back),
        and a conv-pooled one then takes :func:`fused_layer_norm`."""
        h, d = self.num_heads, self.head_dim
        rows = {}
        for name, t in t3.items():
            n = t.shape[-1]
            normed = self.mode == "conv" and name in self.pooled
            norm = getattr(self, f"norm_{name}") if normed else None
            if normed and channel_major_applies(n, self.has_cls, d):
                rows[name] = pool_norm_rows(
                    t.contiguous(), norm.weight.to(t.dtype),
                    norm.bias.to(t.dtype), norm.eps, h)
                continue
            # a copy even where reshape could view (one head): the kernels
            # take contiguous rows
            r = (t.reshape(B, h, d, n).transpose(2, 3).reshape(B * h, n, d)
                 .contiguous())
            if normed:
                r = fused_layer_norm(r, norm.weight.to(r.dtype),
                                     norm.bias.to(r.dtype), norm.eps)
            rows[name] = r
        attend = flash_attention_padded if self.has_cls else flash_attention
        out = attend(rows["q"], rows["k"], rows["v"], self.scale)
        if self.q_pool_residual:
            out = out + rows["q"]
        Lq = out.shape[1]
        return out.reshape(B, h, Lq, d).transpose(1, 2).reshape(B, Lq, h * d)

    def _fused(self, t3: dict, B: int, dt, device) -> torch.Tensor:
        h, d = self.num_heads, self.head_dim
        C = h * d
        ln = {}
        for name in self.pooled:
            norm = getattr(self, f"norm_{name}")
            ln[name] = (norm.weight.to(dt), norm.bias.to(dt))
        Lq = t3["q"].shape[-1]

        def head_major(t):  # [B, C, n] -> the d-major view [B*h, n, d]
            n = t.shape[-1]
            return (t.contiguous().reshape(B, h, d, n).transpose(2, 3)
                    .reshape(B * h, n, d))

        ones = torch.ones(d, dtype=dt, device=device)
        zeros = torch.zeros(d, dtype=dt, device=device)
        gq, bq = ln.get("q", (ones, zeros))
        gk, bk = ln.get("k", (ones, zeros))
        gv, bv = ln.get("v", (ones, zeros))
        flags = tuple(name in ln for name in ("q", "k", "v"))
        out = flash_attention_ln(
            head_major(t3["q"]), head_major(t3["k"]), head_major(t3["v"]),
            gq, bq, gk, bk, gv, bv, self.scale, self.norm_eps, flags,
            self.q_pool_residual)
        return out.reshape(B, h, Lq, d).transpose(1, 2).reshape(B, Lq, C)


class FusedMlp(nn.Module):
    """norm2 + ``fc1`` / exact GELU / ``fc2`` (reference: attention.py:
    436-445) in one :func:`fused_ln_mlp` call; the LN parameters live on
    the block as ``norm2``. :meth:`dense` is the MLP alone on normalized
    rows, for the blocks whose residual also reads them."""

    def __init__(self, dim: int, hidden: int, dim_out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim_out)

    def forward(self, x: torch.Tensor, norm: FusedLayerNorm) -> torch.Tensor:
        dt = x.dtype
        shape = x.shape
        out = fused_ln_mlp(
            x.reshape(-1, shape[-1]).contiguous(), norm.weight.to(dt),
            norm.bias.to(dt),
            self.fc1.weight.to(dt), self.fc1.bias.to(dt),
            self.fc2.weight.to(dt), self.fc2.bias.to(dt), norm.eps)
        return out.reshape(*shape[:-1], self.fc2.out_features)

    def dense(self, xn: torch.Tensor) -> torch.Tensor:
        """``fc2(gelu(fc1(xn)))``: two plain products and the exact GELU,
        as the JAX package computes this MLP outside any Pallas kernel
        (``mvit.py:405-415``)."""
        dt = xn.dtype
        h = F.linear(xn, self.fc1.weight.to(dt), self.fc1.bias.to(dt))
        h = exact_gelu(h.float()).to(dt)
        return F.linear(h, self.fc2.weight.to(dt), self.fc2.bias.to(dt))


class MultiScaleBlock(nn.Module):
    """Transformer block with pooled attention (reference: attention.py:
    287-446). MViT-v2 (``channel_expand_front``) expands the channels in
    front, ``proj_max_pool`` on the skip path; MViT-v1 changes them in the
    MLP, and the residual of such a block is ``proj(norm2(x))``. DropPath
    applies the per-sample masks the caller passes
    (:meth:`drop_path_masks`), in training only. A block of ``MVIT.MOE``'s
    layers takes an expert bank (:class:`~aicity_action_tpu_torch.models.
    moe.MoEMlp`, norm2 its pre-LN) in place of ``FusedMlp``; its forward
    leaves the bank's load-balance loss in :attr:`aux`."""

    def __init__(self, spec: BlockSpec, mode: str, qkv_bias: bool,
                 has_cls: bool, q_pool_residual: bool,
                 channel_expand_front: bool, mlp_ratio: float,
                 moe: MoESpec = MoESpec()):
        super().__init__()
        s = spec
        expand = channel_expand_front and s.dim != s.dim_out
        dim_att = s.dim_out if expand else s.dim
        self.has_cls = has_cls
        self.norm1 = FusedLayerNorm(s.dim, eps=1e-6)
        self.attn = MultiScaleAttention(
            s.dim, dim_att, s.num_heads, s.kernel_q, s.kernel_kv, s.stride_q,
            s.stride_kv, mode, qkv_bias, has_cls, q_pool_residual)
        self.norm2 = FusedLayerNorm(dim_att, eps=1e-6)
        self.moe = s.moe
        self.aux = None  # the bank's load-balance loss of the last forward
        hidden = int(dim_att * mlp_ratio)
        self.mlp = (MoEMlp(dim_att, hidden, s.dim_out, moe) if s.moe
                    else FusedMlp(dim_att, hidden, s.dim_out))
        self.proj_max_pool = nn.Linear(s.dim, s.dim_out) if expand else None
        self.proj = (nn.Linear(dim_att, s.dim_out) if dim_att != s.dim_out
                     else None)
        # skip-path pooling: max pool with kernel s+1 where the stride is >1
        self.kernel_skip = tuple(v + 1 if v > 1 else v for v in s.stride_q)
        self.stride_skip = tuple(s.stride_q)
        self.drop_rate = s.drop_path

    def drop_path_masks(self, batch: int, generator: torch.Generator | None,
                        device, dtype):
        """The block's two DropPath masks (attention and MLP branch) for a
        training step, or None where the rate is 0."""
        if self.drop_rate == 0.0:
            return None
        if generator is None:
            raise ValueError("DropPath in training needs a generator")
        return tuple(drop_path_mask(batch, self.drop_rate, generator, device,
                                    dtype) for _ in range(2))

    def forward(self, x: torch.Tensor, thw: Triple, masks=None):
        dt = x.dtype
        m_attn, m_mlp = masks if masks is not None else (None, None)
        x_block, thw_new = self.attn(x, thw, self.norm1)
        if self.proj_max_pool is not None:
            x = F.linear(x, self.proj_max_pool.weight.to(dt),
                         self.proj_max_pool.bias.to(dt))
        if len(self.kernel_skip) > 0 and np.prod(self.kernel_skip) > 1:
            x, _ = attention_pool(x, thw, mode="max", kernel=self.kernel_skip,
                                  stride=self.stride_skip,
                                  has_cls=self.has_cls)
        x = x + drop_path(x_block, m_attn, self.drop_rate)
        if self.moe:  # build_mvit_spec keeps the width here: no proj
            x_mlp, self.aux = self.mlp(x, self.norm2)
        elif self.proj is None:
            x_mlp = self.mlp(x, self.norm2)
        else:
            # the channel change of MViT-v1 (mvit.py:800-808): the MLP and
            # the residual projection both read norm2(x), so the norm runs
            # alone and the MLP without its fused LN
            xn = self.norm2(x)
            x_mlp = self.mlp.dense(xn)
            x = F.linear(xn, self.proj.weight.to(dt), self.proj.bias.to(dt))
        return x + drop_path(x_mlp, m_mlp, self.drop_rate), thw_new


class PatchEmbed(nn.Module):
    """Conv3d patch stem (reference: stem_helper.py:308-338). Takes the
    channels-last clip ``[B, T, H, W, C]`` and returns tokens ``[B, L, D]``
    and their (T, H, W)."""

    def __init__(self, dim_in: int, dim_out: int, kernel: Triple,
                 stride: Triple, padding: Triple):
        super().__init__()
        self.proj = nn.Conv3d(dim_in, dim_out, kernel, stride, padding)

    def forward(self, x: torch.Tensor):
        dt = x.dtype
        # a channels-last view, no copy: for this 3-channel stem cuDNN's
        # channels-last kernel beat a contiguous NCDHW copy on an H100
        # (tools/bench_convs.py), and its output is then token-major already
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.proj.weight.to(dt),
                     self.proj.bias.to(dt), self.proj.stride,
                     self.proj.padding)
        thw = tuple(y.shape[2:])
        return y.flatten(2).transpose(1, 2).contiguous(), thw


class MViT(nn.Module):
    """MViT-v1/v2 backbone + classification head.

    Input: a ``[B, T, H, W, C]`` clip or a one-pathway list of it; the clip
    is cast to ``compute_dtype`` (bf16 on the card). Returns the head's
    activation (softmax scores at eval) in f32, and the logits in the
    compute type in training. A training forward with DropPath or head
    dropout draws their masks from ``generator``. With a cls token
    (``MVIT.CLS_EMBED_ON``) the head reads its row of the final norm, else
    the mean over tokens, or under ``DETECTION.USE_SPATIAL_MAXPOOL_BEFORE_
    PROJ`` the spatial max of the map's temporal mean. Under
    ``DETECTION.ENABLE`` the final norm's tokens become a ``[B, T, H, W,
    C]`` map for the RoI head: ``forward(x, bboxes)`` returns the f32
    activation of each ``[N, 5]`` box row, in training too. Under
    ``CONTRA.ENABLE`` (ActionCLIP's video tower) the head is the contrastive
    projection, and the forward returns its features in the compute type.
    Under ``MODEL.USE_MULTI_HEAD`` the head is :class:`~aicity_action_tpu_
    torch.models.heads.TransformerMultiHead`: the forward returns its dict
    (``dataset_name``'s head only where given; the cross projections under
    ``run_cross_proj``), with ``return_emb`` as ``(dict, pooled features)``.
    """

    def __init__(self, spec: MViTSpec,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        sp = spec
        if sp.cls_embed and (sp.detection_enable
                             or sp.use_spatial_maxpool_before_proj):
            # the JAX package's reshape of the L + 1 final-norm rows into
            # [B, T, H, W, C] cannot succeed (mvit.py:1026, 1042); the
            # reference drops the cls row first
            # (video_model_builder.py:1258-1271)
            raise ValueError("a cls-token MViT (MVIT.CLS_EMBED_ON) takes "
                             "neither the RoI head nor the spatial-maxpool "
                             "head: the JAX package cannot reshape its L + 1 "
                             "tokens into their map")
        self.spec = sp
        self.compute_dtype = compute_dtype
        self.patch_embed = PatchEmbed(sp.in_channels, sp.embed_dim,
                                      sp.patch_kernel, sp.patch_stride,
                                      sp.patch_padding)
        pt, ph, pw = sp.patch_dims
        n_cls = int(sp.cls_embed)
        if sp.cls_embed:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, sp.embed_dim))
        if sp.sep_pos_embed:
            self.pos_embed_spatial = nn.Parameter(
                torch.zeros(1, ph * pw, sp.embed_dim))
            self.pos_embed_temporal = nn.Parameter(
                torch.zeros(1, pt, sp.embed_dim))
            if sp.cls_embed:
                self.pos_embed_class = nn.Parameter(
                    torch.zeros(1, 1, sp.embed_dim))
        else:
            self.pos_embed = nn.Parameter(
                torch.zeros(1, n_cls + pt * ph * pw, sp.embed_dim))
        self.blocks = nn.ModuleList(
            MultiScaleBlock(bs, sp.mode, sp.qkv_bias, sp.cls_embed,
                            sp.q_pool_residual, sp.channel_expand_front,
                            sp.mlp_ratio, sp.moe)
            for bs in sp.blocks)
        self.moe_aux: list = []  # the MoE blocks' losses of the last forward
        dim_out = sp.blocks[-1].dim_out
        self.norm = (None if sp.no_norm_before_avg
                     else FusedLayerNorm(dim_out, eps=1e-6))
        if sp.contra_enable and not sp.detection_enable:
            # ActionCLIP's video tower (mvit.py:1057-1065)
            self.head = ContrastiveProjectionHead(
                dim_out, sp.contra_embed_dim, use_mlp=sp.contra_use_mlp,
                dropout_rate=sp.head_dropout)
        elif sp.use_multi_head and not sp.detection_enable:
            # the multi-dataset heads (mvit.py:1067-1080)
            self.head = TransformerMultiHead(
                dim_out, sp.multi_datasets, sp.multi_num_classes,
                sp.multi_head_act, dropout_rate=sp.head_dropout,
                use_mlp=sp.multi_use_mlp,
                add_cross_proj=sp.multi_add_cross_proj)
        elif sp.detection_enable:
            self.head = ResNetRoIHead(
                [dim_out], sp.num_classes, resolution=[sp.roi_resolution],
                scale_factor=[sp.roi_scale_factor],
                dropout_rate=sp.head_dropout, act_func=sp.head_act,
                aligned=sp.roi_aligned)
        else:
            self.head = TransformerBasicHead(
                dim_out, sp.num_classes, dropout_rate=sp.head_dropout,
                act_func=sp.head_act,
                use_act_in_train=sp.use_head_act_in_train)

    def _pos_embed(self) -> torch.Tensor:
        if not self.spec.sep_pos_embed:
            return self.pos_embed
        pt, ph, pw = self.spec.patch_dims
        pos = (self.pos_embed_spatial.repeat(1, pt, 1)
               + self.pos_embed_temporal.repeat_interleave(ph * pw, dim=1))
        if self.spec.cls_embed:
            pos = torch.cat([self.pos_embed_class, pos], dim=1)
        return pos

    def embed(self, x) -> tuple:
        """The clip (or a one-pathway list of it) in the compute type
        through the patch stem, the cls token in front where the model has
        one, plus the position embeddings: ``(tokens [B, (1 +) L, D],
        (T, H, W))``."""
        if isinstance(x, (list, tuple)):
            x = x[0]
        x = x.to(self.compute_dtype)
        x, thw = self.patch_embed(x)
        if self.spec.cls_embed:
            cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
            x = torch.cat([cls, x], dim=1)
        return x + self._pos_embed().to(x.dtype), thw

    def forward(self, x, bboxes: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                dataset_name: str | None = None,
                run_cross_proj: bool = False, return_emb: bool = False):
        x, thw = self.embed(x)
        remat = (self.training and self.spec.act_checkpoint
                 and torch.is_grad_enabled())
        # each MoE block's loss as its first forward leaves it: a
        # checkpointed block's recompute in the backward replaces the
        # block's aux, not this list's, so the loss counts once, and its
        # graph (the recompute restores its saved tensors) reaches the router
        self.moe_aux = []
        for blk in self.blocks:
            masks = (blk.drop_path_masks(x.shape[0], generator, x.device,
                                         x.dtype) if self.training else None)
            if remat:
                x, thw = checkpoint(blk, x, thw, masks, use_reentrant=False)
            else:
                x, thw = blk(x, thw, masks)
            if blk.moe:
                self.moe_aux.append(blk.aux)
        if self.norm is not None:
            x = self.norm(x)
        sp = self.spec
        if sp.detection_enable:
            # the RoI path (video_model_builder.py:1258-1271): tokens back
            # to a [B, T, H, W, C] map for the RoI head
            if bboxes is None:
                raise ValueError("a detection model scores boxes: pass "
                                 "bboxes")
            return self.head([x.reshape(x.shape[0], *thw, x.shape[-1])],
                             bboxes, generator)
        if sp.use_spatial_maxpool_before_proj:
            feat = self._spatial_maxpool(x, thw)
        elif sp.cls_embed:
            feat = x[:, 0]
        else:
            feat = x.mean(dim=1)
        if isinstance(self.head, TransformerMultiHead):
            out = self.head(feat, dataset_name, run_cross_proj, generator)
            # (preds, pooled representation) for the VICReg regularizer
            # (video_model_builder.py:1325-1331)
            return (out, feat) if return_emb else out
        return self.head(feat, generator)

    def _spatial_maxpool(self, x: torch.Tensor, thw: Triple) -> torch.Tensor:
        """The whole-frame head's pooling (video_model_builder.py:1273-1303;
        JAX ``mvit.py:1040-1051``): the mean over time, a bilinear resize to
        the RoI resolution where the map's height differs from it, then the
        max over space. ``jax.image.resize`` antialiases when it shrinks a
        map, and so does this resize."""
        r = self.spec.roi_resolution
        fm = x.reshape(x.shape[0], *thw, x.shape[-1]).mean(dim=1)
        if thw[1] != r:
            fm = F.interpolate(fm.permute(0, 3, 1, 2), size=(r, r),
                               mode="bilinear", align_corners=False,
                               antialias=True).permute(0, 2, 3, 1)
        return fm.amax(dim=(1, 2))
