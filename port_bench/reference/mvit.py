"""Plain float32 MViT-v2 (Li et al., MViTv2, CVPR 2022, on PySlowFast's
MViT-B layout) for the benchmark's correctness check.

Plain PyTorch and nothing else: no kernel, no cache, no batching trick of
the program under test, and no import of it. It reads a configuration's
``cfg`` table (``port_bench/configs/<name>.json``) and a state dict under
PySlowFast's parameter names, and computes

- the patch stem: a Conv3d of the channels-last clip, then the separable
  position embedding (spatial repeated over time plus temporal repeated
  over space);
- each block: norm1 (eps 1e-6); one qkv product split as
  ``[3, heads, head_dim]``; q, k, v each pooled by a depthwise Conv3d whose
  ``[head_dim, 1, k, k, k]`` weight every head shares (padding k // 2),
  then normalised over the head dim (eps 1e-5); softmax attention at scale
  ``head_dim ** -0.5``; the pooled q added to the output
  (``Q_POOL_RESIDUAL``); ``proj``. The skip path takes ``proj_max_pool``
  where the block widens its channels and a max pool (kernel stride + 1)
  where it pools q; then norm2, fc1, exact GELU, fc2. DropPath scales a
  kept branch by ``1 / (1 - rate)``;
- the final norm, the mean over tokens, dropout and the linear head;
  softmax at eval.

One departure from upstream PySlowFast MViTv2: there ``proj`` of a
widening block reads ``norm1(x)``; in this repository's model (the recipe's
``CHANNEL_EXPAND_FRONT``) ``proj_max_pool`` reads the un-normalised ``x``,
and this file follows the repository's model.

``quant`` wraps every input of a product or a convolution (weights and
activations); ``None`` computes in float32 throughout. The lower-precision
control passes :func:`port_bench.reference.quant.fp8`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# query rows x keys of one block of the attention scores, in elements
_SCORE_BLOCK = 1 << 27


@dataclasses.dataclass(frozen=True)
class Block:
    dim: int
    dim_out: int
    heads: int
    kernel_q: tuple
    stride_q: tuple
    kernel_kv: tuple
    stride_kv: tuple
    drop_path: float

    @property
    def dim_att(self) -> int:
        return self.dim_out  # channels expand in front of the attention

    @property
    def head_dim(self) -> int:
        return self.dim_att // self.heads


def _round_width(width, multiplier, divisor=1):
    """PySlowFast's ``round_width``."""
    if not multiplier:
        return int(width)
    width *= multiplier
    out = max(divisor, int(width + divisor / 2) // divisor * divisor)
    if out < 0.9 * width:
        out += divisor
    return int(out)


def blocks(cfg: dict) -> list[Block]:
    """The block schedule of an MViT-v2 ``cfg`` table: channels and heads
    doubling at ``DIM_MUL`` / ``HEAD_MUL``, q pooled at ``POOL_Q_STRIDE``
    (and at stride 1 everywhere else under ``Q_POOL_ALL``), the key and
    value stride starting at ``POOL_KV_STRIDE_ADAPTIVE`` and divided by
    each q stride, DropPath rising linearly from 0 to ``DROPPATH_RATE``."""
    m = cfg["MVIT"]
    if not (m["CHANNEL_EXPAND_FRONT"] and m["Q_POOL_ALL"]
            and m["Q_POOL_RESIDUAL"] and m["MODE"] == "conv"
            and not m["CLS_EMBED_ON"] and m["SEP_POS_EMBED"]):
        raise ValueError("the reference is the MViT-v2 of the AI City "
                         "recipe: conv pooling everywhere, channels expanded "
                         "in front, the q residual, no cls token")
    depth = m["DEPTH"]
    dim_mul, head_mul = np.ones(depth + 1), np.ones(depth + 1)
    for i, v in m["DIM_MUL"]:
        dim_mul[i] = v
    for i, v in m["HEAD_MUL"]:
        head_mul[i] = v
    kernel = tuple(m["POOL_KVQ_KERNEL"])
    stride_q = [(1, 1, 1)] * depth
    for entry in m["POOL_Q_STRIDE"]:
        stride_q[entry[0]] = tuple(entry[1:])
    skv = list(m["POOL_KV_STRIDE_ADAPTIVE"])
    stride_kv = []
    for i in range(depth):
        skv = [max(skv[d] // stride_q[i][d], 1) for d in range(3)]
        stride_kv.append(tuple(skv))
    rates = np.linspace(0, m["DROPPATH_RATE"], depth)
    out = []
    heads, dim, dim_out = m["NUM_HEADS"], m["EMBED_DIM"], m["EMBED_DIM"]
    for i in range(depth):
        heads = _round_width(heads, head_mul[i])
        dim = _round_width(dim, dim_mul[i - 1] if i else 1.0, heads)
        dim_out = _round_width(dim_out, dim_mul[i], heads)
        out.append(Block(dim, dim_out, heads, kernel, stride_q[i], kernel,
                         stride_kv[i], float(rates[i])))
    return out


def patch_thw(cfg: dict) -> tuple:
    """(T, H, W) of the stem's output."""
    st = cfg["MVIT"]["PATCH_STRIDE"]
    crop = cfg["DATA"]["TEST_CROP_SIZE"]
    return (cfg["DATA"]["NUM_FRAMES"] // st[0], crop // st[1], crop // st[2])


def pooled(thw, kernel, stride) -> tuple:
    return tuple((n + 2 * (k // 2) - k) // s + 1
                 for n, k, s in zip(thw, kernel, stride))


def param_shapes(cfg: dict) -> dict:
    """``{name: shape}`` of every parameter, PySlowFast's names."""
    m = cfg["MVIT"]
    T, H, W = patch_thw(cfg)
    e = m["EMBED_DIM"]
    shapes = {"pos_embed_spatial": (1, H * W, e),
              "pos_embed_temporal": (1, T, e),
              "patch_embed.proj.weight": (e, cfg["DATA"]["INPUT_CHANNEL_NUM"][0],
                                          *m["PATCH_KERNEL"]),
              "patch_embed.proj.bias": (e,)}
    hidden_ratio = m["MLP_RATIO"]
    for i, b in enumerate(blocks(cfg)):
        p, a, d = f"blocks.{i}.", b.dim_att, b.head_dim
        shapes.update({
            p + "norm1.weight": (b.dim,), p + "norm1.bias": (b.dim,),
            p + "attn.qkv.weight": (3 * a, b.dim),
            p + "attn.qkv.bias": (3 * a,),
            p + "attn.proj.weight": (a, a), p + "attn.proj.bias": (a,)})
        for n in "qkv":
            shapes.update({
                p + f"attn.pool_{n}.weight": (d, 1, *b.kernel_q),
                p + f"attn.norm_{n}.weight": (d,),
                p + f"attn.norm_{n}.bias": (d,)})
        hidden = int(a * hidden_ratio)
        shapes.update({
            p + "norm2.weight": (a,), p + "norm2.bias": (a,),
            p + "mlp.fc1.weight": (hidden, a), p + "mlp.fc1.bias": (hidden,),
            p + "mlp.fc2.weight": (b.dim_out, hidden),
            p + "mlp.fc2.bias": (b.dim_out,)})
        if b.dim != b.dim_out:
            shapes.update({p + "proj_max_pool.weight": (b.dim_out, b.dim),
                           p + "proj_max_pool.bias": (b.dim_out,)})
    last = blocks(cfg)[-1].dim_out
    shapes.update({"norm.weight": (last,), "norm.bias": (last,),
                   "head.projection.weight": (cfg["MODEL"]["NUM_CLASSES"],
                                              last),
                   "head.projection.bias": (cfg["MODEL"]["NUM_CLASSES"],)})
    return shapes


def _ident(t):
    return t


def _linear(x, w, b, q):
    return F.linear(q(x), q(w), b)


def _ln(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def attention(q, k, v, scale, qz=_ident):
    """softmax(q k^T * scale) v over ``[G, L, d]``, in blocks of query
    rows so that the scores fit."""
    G, Lq, _ = q.shape
    rows = max(1, min(Lq, _SCORE_BLOCK // max(1, G * k.shape[1])))
    kq, vq = qz(k), qz(v)
    outs = []
    for r0 in range(0, Lq, rows):
        s = torch.matmul(qz(q[:, r0:r0 + rows] * scale), kq.transpose(1, 2))
        outs.append(torch.matmul(qz(torch.softmax(s, dim=-1)), vq))
    return torch.cat(outs, dim=1)


class MViTReference:
    """The forward of one MViT-v2 from ``params`` (float32 tensors on one
    device)."""

    def __init__(self, cfg: dict, params: dict, quant=None):
        shapes = param_shapes(cfg)
        if set(shapes) != set(params):
            raise ValueError("parameters differ from the configuration: "
                             f"{sorted(set(shapes) ^ set(params))[:8]}")
        for name, shape in shapes.items():
            if tuple(params[name].shape) != tuple(shape):
                raise ValueError(f"{name}: {tuple(params[name].shape)} is "
                                 f"not {shape}")
        self.cfg = cfg
        self.p = params
        self.blocks = blocks(cfg)
        self.q = quant or _ident
        m = cfg["MVIT"]
        self.patch = (tuple(m["PATCH_STRIDE"]), tuple(m["PATCH_PADDING"]))

    def embed(self, x):
        """``[B, T, H, W, 3]`` -> tokens ``[B, L, D]`` and (T, H, W)."""
        p, q = self.p, self.q
        y = F.conv3d(q(x.permute(0, 4, 1, 2, 3)), q(p["patch_embed.proj.weight"]),
                     p["patch_embed.proj.bias"], self.patch[0], self.patch[1])
        thw = tuple(y.shape[2:])
        y = y.flatten(2).transpose(1, 2)
        pos = (p["pos_embed_spatial"].repeat(1, thw[0], 1)
               + p["pos_embed_temporal"].repeat_interleave(
                   thw[1] * thw[2], dim=1))
        return y + pos, thw

    def _pool(self, t, i, name, thw, kernel, stride):
        """``[B, h, L, d]`` -> pooled and normalised ``[B, h, L', d]``."""
        p, q, pre = self.p, self.q, f"blocks.{i}.attn."
        B, h, L, d = t.shape
        x = t.reshape(B * h, *thw, d).permute(0, 4, 1, 2, 3)
        y = F.conv3d(q(x), q(p[pre + f"pool_{name}.weight"]), None, stride,
                     tuple(k // 2 for k in kernel), 1, d)
        out_thw = tuple(y.shape[2:])
        y = y.flatten(2).transpose(1, 2).reshape(B, h, -1, d)
        return _ln(y, p[pre + f"norm_{name}.weight"],
                   p[pre + f"norm_{name}.bias"], 1e-5), out_thw

    def block(self, i, x, thw, masks=None):
        b, p, q, pre = self.blocks[i], self.p, self.q, f"blocks.{i}."
        B, L, _ = x.shape
        h, d, a = b.heads, b.head_dim, b.dim_att
        xn = _ln(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"], 1e-6)
        qkv = _linear(xn, p[pre + "attn.qkv.weight"], p[pre + "attn.qkv.bias"],
                      q).reshape(B, L, 3, h, d).permute(2, 0, 3, 1, 4)
        tq, new_thw = self._pool(qkv[0], i, "q", thw, b.kernel_q, b.stride_q)
        tk, _ = self._pool(qkv[1], i, "k", thw, b.kernel_kv, b.stride_kv)
        tv, _ = self._pool(qkv[2], i, "v", thw, b.kernel_kv, b.stride_kv)
        Lq = tq.shape[2]
        o = attention(tq.reshape(B * h, Lq, d), tk.reshape(B * h, -1, d),
                      tv.reshape(B * h, -1, d), d ** -0.5, q)
        o = o.reshape(B, h, Lq, d) + tq
        o = o.transpose(1, 2).reshape(B, Lq, a)
        o = _linear(o, p[pre + "attn.proj.weight"], p[pre + "attn.proj.bias"], q)
        if b.dim != b.dim_out:
            x = _linear(x, p[pre + "proj_max_pool.weight"],
                        p[pre + "proj_max_pool.bias"], q)
        skip = tuple(s + 1 if s > 1 else s for s in b.stride_q)
        if math.prod(skip) > 1:
            c = x.shape[-1]
            g = x.transpose(1, 2).reshape(B, c, *thw)
            g = F.max_pool3d(g, skip, b.stride_q, tuple(k // 2 for k in skip))
            x = g.flatten(2).transpose(1, 2)
        m_attn, m_mlp = masks if masks is not None else (None, None)
        x = x + _drop(o, m_attn, b.drop_path)
        xn = _ln(x, p[pre + "norm2.weight"], p[pre + "norm2.bias"], 1e-6)
        hdn = F.gelu(_linear(xn, p[pre + "mlp.fc1.weight"],
                             p[pre + "mlp.fc1.bias"], q))
        y = _linear(hdn, p[pre + "mlp.fc2.weight"], p[pre + "mlp.fc2.bias"], q)
        return x + _drop(y, m_mlp, b.drop_path), new_thw

    def logits(self, x, masks=None, head_mask=None, remat=False):
        """Logits ``[B, classes]`` of clips ``[B, T, H, W, 3]``. In
        training, ``masks`` holds each block's (attention, MLP) DropPath
        keep masks ``[B]`` (None where its rate is 0) and ``head_mask`` the
        head dropout's keep mask ``[B, C]``; ``remat`` recomputes each
        block in the backward (same arithmetic, less memory)."""
        x, thw = self.embed(x)
        for i in range(len(self.blocks)):
            mk = None if masks is None else masks[i]
            if remat:
                x, thw = checkpoint(self.block, i, x, thw, mk,
                                    use_reentrant=False)
            else:
                x, thw = self.block(i, x, thw, mk)
        p = self.p
        feat = _ln(x, p["norm.weight"], p["norm.bias"], 1e-6).mean(dim=1)
        if head_mask is not None:
            rate = self.cfg["MODEL"]["DROPOUT_RATE"]
            feat = torch.where(head_mask, feat / (1.0 - rate),
                               torch.zeros_like(feat))
        return _linear(feat, p["head.projection.weight"],
                       p["head.projection.bias"], self.q)

    @torch.no_grad()
    def scores(self, x):
        """Softmax scores ``[B, classes]`` at eval."""
        return torch.softmax(self.logits(x), dim=-1)


def _drop(x, keep, rate):
    if keep is None:
        return x
    return x / (1.0 - rate) * keep.to(x.dtype).reshape(-1, 1, 1)
