"""Model builder (port of ``aicity_action_tpu/models/build.py`` for the one
model this port serves, ``MODEL_NAME == "MViT"``)."""

from __future__ import annotations

import torch
from torch import nn

from ..device import compute_dtype, resolve_device
from .mvit import MViT, build_mvit_spec


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The reference's initialization, drawn from ``generator``: linear
    weights and position embeddings from a normal of std 0.02 truncated at
    two deviations, conv weights LeCun-normal, biases 0, LN scales 1."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias":
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            elif p.dim() == 5:
                std = p[0].numel() ** -0.5
                nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
            else:
                nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04,
                                      generator=generator)


def build_model(cfg, device: str | torch.device = "cuda",
                seed: int | None = None) -> MViT:
    """MViT for ``cfg`` on ``device``, in eval mode, with weights drawn from
    ``seed`` (default ``cfg.RNG_SEED``). Raises if ``device`` is CUDA and
    there is no card."""
    if cfg.MODEL.MODEL_NAME != "MViT":
        raise NotImplementedError(
            f"MODEL_NAME {cfg.MODEL.MODEL_NAME!r} is not ported yet")
    dev = resolve_device(device)
    model = MViT(build_mvit_spec(cfg), compute_dtype(cfg.TPU.COMPUTE_DTYPE))
    gen = torch.Generator().manual_seed(
        cfg.RNG_SEED if seed is None else seed)
    init_weights(model, gen)
    return model.to(dev).eval()
