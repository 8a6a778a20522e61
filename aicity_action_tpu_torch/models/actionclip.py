"""ActionCLIP: a video-text dual encoder trained contrastively (port of
``aicity_action_tpu/models/actionclip.py``; reference:
video_model_builder.py:1341-1441).

The video tower is MViT with its contrastive projection head
(``CONTRA.ENABLE``), which runs the port's CUDA kernels on the card; the
text tower is CLIP's transformer (``models/text.py``, plain PyTorch). Both
return L2-normalized features, normalized in f32; ``forward`` also returns
the temperature ``exp(logit_scale)``, with ``logit_scale`` initialized to
ln(1 / 0.07).

``MODEL.LOAD_VISUAL False`` builds the text tower alone (the text-query
CLI). The MoCo momentum encoders are a second copy of the model whose
weights the train step moves by EMA (``engine/contrastive.py``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .mvit import MViT, build_mvit_spec
from .text import TextTransformer


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / x.norm(dim=-1, keepdim=True)


class ActionCLIP(nn.Module):
    """``video_encoder`` (unless ``MODEL.LOAD_VISUAL`` is False),
    ``text_encoder`` and ``logit_scale``."""

    def __init__(self, cfg, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if not cfg.CONTRA.ENABLE:
            raise ValueError("ActionCLIP needs CONTRA.ENABLE True (the video "
                             "tower's contrastive head)")
        c = cfg.CONTRA
        self.video_encoder = (MViT(build_mvit_spec(cfg), compute_dtype)
                              if cfg.MODEL.LOAD_VISUAL else None)
        self.text_encoder = TextTransformer(
            width=c.transformer_width, layers=c.transformer_layers,
            heads=c.transformer_heads, context_length=c.CONTEXT_LENGTH,
            vocab_size=c.vocab_size, embed_dim=c.embed_dim,
            use_mlp=c.use_MLP, dropout_rate=cfg.MODEL.DROPOUT_RATE,
            act_checkpoint=cfg.MODEL.ACT_CHECKPOINT,
            compute_dtype=compute_dtype)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.text_encoder.compute_dtype

    @compute_dtype.setter
    def compute_dtype(self, dtype: torch.dtype) -> None:
        """Both towers' compute type (a check's f32 reference)."""
        self.text_encoder.compute_dtype = dtype
        if self.video_encoder is not None:
            self.video_encoder.compute_dtype = dtype

    def encode_video(self, frames, generator=None) -> torch.Tensor:
        """L2-normed f32 video features ``[B, embed_dim]`` of a ``[B, T, H,
        W, 3]`` clip (or its one-pathway list)."""
        if self.video_encoder is None:
            raise ValueError("this ActionCLIP was built without its video "
                             "tower (MODEL.LOAD_VISUAL False)")
        return _l2_normalize(self.video_encoder(frames, generator=generator))

    def encode_text(self, tokens: torch.Tensor,
                    generator=None) -> torch.Tensor:
        """L2-normed f32 text features ``[B, embed_dim]`` of int ids ``[B,
        CONTEXT_LENGTH]``."""
        return _l2_normalize(self.text_encoder(tokens, generator))

    def forward(self, frames, tokens: torch.Tensor, generator=None):
        """``(video features, text features, exp(logit_scale))``."""
        v = self.encode_video(frames, generator)
        t = self.encode_text(tokens, generator)
        return v, t, self.logit_scale.exp()
