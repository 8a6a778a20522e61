"""CLIP text encoder (port of ``aicity_action_tpu/models/text.py``;
reference: slowfast/models/text_models.py).

A causal transformer over BPE token ids, pooled at the end-of-text token
(``x[arange, text.argmax(-1)]``: ``<|endoftext|>`` has the largest id, and
the zero padding the smallest) and projected into the joint embedding space
by the ``text_projection`` matrix (or a 2048-wide MLP under
``CONTRA.use_MLP``). QuickGELU as in CLIP.

Parameter names are CLIP's (``token_embedding.weight``,
``positional_embedding``, ``resblocks.{i}.attn.in_proj_weight``,
``resblocks.{i}.ln_1``, ``resblocks.{i}.mlp.c_fc``, ``ln_final``,
``text_projection``, ...), with the attention in ``nn.MultiheadAttention``'s
layout (one fused ``in_proj``, then ``out_proj``), so that a CLIP checkpoint
loads by name.

The JAX package computes this tower with plain XLA ops, no Pallas kernel, so
plain PyTorch is its counterpart here, on the card too: ``torch.matmul``,
softmax and ``F.layer_norm``. Numerics follow the dtype policy: products in
the compute type, the attention logits, softmax and LayerNorm statistics in
f32, parameters f32 cast where they are used.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import dp_rand
from ..ops.fused_dense import exact_gelu


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x: torch.Tensor, norm: nn.Module, eps: float) -> torch.Tensor:
    """``norm``'s LayerNorm of ``x`` with f32 statistics, in ``x``'s type."""
    return F.layer_norm(x.float(), (x.shape[-1],), norm.weight, norm.bias,
                        eps).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """Inverted dropout whose mask comes from ``generator`` (for the global
    batch under data parallelism, ``parallel/mesh.py:dp_rand``)."""
    if generator is None:
        raise ValueError("dropout in training needs a generator")
    keep = 1.0 - rate
    mask = dp_rand(tuple(x.shape), generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class ProjectionMlp(nn.Module):
    """``fc1`` -> exact GELU -> dropout -> ``fc2`` -> dropout (the JAX
    package's ``models/common.py:Mlp``); dropout acts in training only."""

    def __init__(self, dim_in: int, hidden: int, dim_out: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim_in, hidden)
        self.fc2 = nn.Linear(hidden, dim_out)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        dt = x.dtype
        drop = self.training and self.dropout_rate > 0
        x = exact_gelu(F.linear(x, self.fc1.weight.to(dt),
                                self.fc1.bias.to(dt)))
        if drop:
            x = dropout(x, self.dropout_rate, generator)
        x = F.linear(x, self.fc2.weight.to(dt), self.fc2.bias.to(dt))
        if drop:
            x = dropout(x, self.dropout_rate, generator)
        return x


class CausalSelfAttention(nn.Module):
    """Multi-head self-attention under a causal mask, in the parameter
    layout of ``nn.MultiheadAttention``."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        dt, h = x.dtype, self.heads
        d = D // h
        qkv = F.linear(x, self.in_proj_weight.to(dt),
                       self.in_proj_bias.to(dt))
        q, k, v = (t.reshape(B, L, h, d).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        # f32 logits of the compute-type products (preferred_element_type)
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * d ** -0.5
        causal = torch.ones((L, L), dtype=torch.bool,
                            device=x.device).tril()
        attn = attn.masked_fill(~causal, float("-inf"))
        attn = torch.softmax(attn, dim=-1).to(dt)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, L, D)
        return F.linear(out, self.out_proj.weight.to(dt),
                        self.out_proj.bias.to(dt))


class TextMlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = quick_gelu(F.linear(x, self.c_fc.weight.to(dt),
                                self.c_fc.bias.to(dt)))
        return F.linear(x, self.c_proj.weight.to(dt), self.c_proj.bias.to(dt))


class ResidualAttentionBlock(nn.Module):
    """``x + attn(ln_1(x))``, then ``+ mlp(ln_2(x))``; LN eps 1e-5 (torch's
    default, as CLIP)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = CausalSelfAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = TextMlp(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.ln_1, 1e-5))
        return x + self.mlp(layer_norm(x, self.ln_2, 1e-5))


class TextTransformer(nn.Module):
    """Token embedding + positional embedding, ``layers`` causal blocks,
    ``ln_final``, EOT pooling and the projection. ``forward(text)`` takes
    int ids ``[B, context_length]`` and returns ``[B, embed_dim]`` in
    ``compute_dtype``; under ``act_checkpoint`` a training forward
    recomputes each block in the backward."""

    def __init__(self, width: int = 512, layers: int = 12, heads: int = 8,
                 context_length: int = 77, vocab_size: int = 49408,
                 embed_dim: int = 512, use_mlp: bool = False,
                 dropout_rate: float = 0.5, act_checkpoint: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.width, self.layers = width, layers
        self.compute_dtype = compute_dtype
        self.act_checkpoint = act_checkpoint
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width))
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads) for _ in range(layers))
        self.ln_final = nn.LayerNorm(width)
        if use_mlp:
            self.text_projection = ProjectionMlp(width, 2048, embed_dim,
                                                 dropout_rate)
        else:
            self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """CLIP's initialization (text_models.py ``initialize_parameters``)
        drawn from ``generator``: embeddings from normals of std 0.02 and
        0.01, the attention's in/out projections and the MLP's from normals
        of std ``width^-0.5``, ``width^-0.5 (2 layers)^-0.5``, ``(2
        width)^-0.5`` (c_fc) and the out projections' (c_proj), the text
        projection of std ``width^-0.5``; biases 0, LN scales 1."""
        w = self.width
        attn_std = w ** -0.5
        proj_std = attn_std * (2 * self.layers) ** -0.5
        fc_std = (2 * w) ** -0.5

        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        normal(self.token_embedding.weight, 0.02)
        normal(self.positional_embedding, 0.01)
        for blk in self.resblocks:
            normal(blk.attn.in_proj_weight, attn_std)
            normal(blk.attn.out_proj.weight, proj_std)
            normal(blk.mlp.c_fc.weight, fc_std)
            normal(blk.mlp.c_proj.weight, proj_std)
        if isinstance(self.text_projection, nn.Parameter):
            normal(self.text_projection, attn_std)
        else:
            for fc in (self.text_projection.fc1, self.text_projection.fc2):
                nn.init.trunc_normal_(fc.weight, std=0.02, a=-0.04, b=0.04,
                                      generator=generator)
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.endswith(("ln_1.weight", "ln_2.weight",
                                "ln_final.weight")):
                p.fill_(1.0)

    def forward(self, text: torch.Tensor, generator=None) -> torch.Tensor:
        dt = self.compute_dtype
        x = self.token_embedding(text).to(dt) \
            + self.positional_embedding.to(dt)
        remat = (self.training and self.act_checkpoint
                 and torch.is_grad_enabled())
        for blk in self.resblocks:
            x = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
        x = layer_norm(x, self.ln_final, 1e-5)
        # EOT pooling: <|endoftext|> holds the largest id of its row
        pooled = x[torch.arange(x.shape[0], device=x.device),
                   text.argmax(dim=-1)]
        if isinstance(self.text_projection, nn.Parameter):
            return pooled @ self.text_projection.to(dt)
        return self.text_projection(pooled, generator)
