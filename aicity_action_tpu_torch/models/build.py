"""Model builder (port of ``aicity_action_tpu/models/{build,zoo}.py``):
``MODEL.MODEL_NAME`` ``MViT``, ``ActionCLIP`` (the video-text dual
encoder), and the BatchNorm conv nets ``ResNet``, ``SlowFast`` and
``X3D``; :func:`example_inputs` gives a model's positional arguments at
batch 1 (the zoo's example inputs)."""

from __future__ import annotations

import torch
from torch import nn

from ..device import compute_dtype, resolve_device
from .actionclip import ActionCLIP
from .convnets import is_bn
from .mvit import MViT, build_mvit_spec
from .resnet_models import X3D, ResNet, SlowFast

_CONV_NETS = {"ResNet": ResNet, "SlowFast": SlowFast, "X3D": X3D}


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The reference's initialization, drawn from ``generator``: linear
    weights (an MoE router and expert banks too) and position embeddings
    from a normal of std 0.02 truncated at two deviations, conv weights
    LeCun-normal, biases 0, LN and BN scales 1
    (0 for a BatchNorm made with ``final_gamma_zero``)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias" or leaf.endswith("_bias"):  # expert banks'
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
        for m in model.modules():
            if is_bn(m) and m.final_gamma_zero:
                m.weight.zero_()


def build_model(cfg, device: str | torch.device = "cuda",
                seed: int | None = None) -> nn.Module:
    """The ``MODEL.MODEL_NAME`` model for ``cfg`` on ``device``, in eval
    mode, with weights drawn from ``seed`` (default ``cfg.RNG_SEED``).
    Raises if ``device`` is CUDA and there is no card."""
    name = cfg.MODEL.MODEL_NAME
    if name not in ("MViT", "ActionCLIP") and name not in _CONV_NETS:
        raise NotImplementedError(f"MODEL_NAME {name!r} is not ported yet")
    dev = resolve_device(device)
    dtype = compute_dtype(cfg.TPU.COMPUTE_DTYPE)
    gen = torch.Generator().manual_seed(
        cfg.RNG_SEED if seed is None else seed)
    if name == "ActionCLIP":
        # the video tower by the reference's rules, the text tower by
        # CLIP's; logit_scale keeps its ln(1 / 0.07)
        model = ActionCLIP(cfg, dtype)
        if model.video_encoder is not None:
            init_weights(model.video_encoder, gen)
        model.text_encoder.init_weights(gen)
        return model.to(dev).eval()
    model = (MViT(build_mvit_spec(cfg), dtype) if name == "MViT"
             else _CONV_NETS[name](cfg, dtype))
    init_weights(model, gen)
    if name != "MViT":
        model.set_channels_last(model.channels_last)
    return model.to(dev).eval()


def example_inputs(cfg, device: str | torch.device = "cpu") -> tuple:
    """Zero positional arguments of the ``cfg`` model at batch 1 (the JAX
    package's ``models/zoo.py`` example inputs): the clip, or for a conv
    net the list of its pathways' clips (the slow one ``T // alpha``
    frames long), channels-last, in the compute dtype; and under
    ``DETECTION.ENABLE`` one all-zero ``[1, 5]`` box row, or for
    ActionCLIP one all-zero row of token ids."""
    dtype = compute_dtype(cfg.TPU.COMPUTE_DTYPE)
    T, C = cfg.DATA.NUM_FRAMES, cfg.DATA.INPUT_CHANNEL_NUM
    S = cfg.DATA.TRAIN_CROP_SIZE

    def clip(t, c):
        return torch.zeros((1, t, S, S, c), dtype=dtype, device=device)

    if cfg.MODEL.MODEL_NAME in ("MViT", "ActionCLIP"):
        xs = clip(T, C[0])
    elif cfg.MODEL.MODEL_NAME == "SlowFast":
        xs = [clip(T // cfg.SLOWFAST.ALPHA, C[0]),
              clip(T, C[1] if len(C) > 1 else C[0])]
    else:
        xs = [clip(T, C[0])]
    if cfg.DETECTION.ENABLE:
        return xs, torch.zeros((1, 5), dtype=torch.float32, device=device)
    if cfg.MODEL.MODEL_NAME == "ActionCLIP":
        return xs, torch.zeros((1, cfg.CONTRA.CONTEXT_LENGTH),
                               dtype=torch.long, device=device)
    return (xs,)
